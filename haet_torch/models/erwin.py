"""Erwin hierarchical ball-attention transformer, PyTorch.

Counterpart of ``haet_tpu/models/erwin.py`` (reference
``models/components/erwinflash/``): dense batched clouds ``[B, N, C]`` with
N a power of two, on-device median-split grouping
(:mod:`haet_torch.ops.ball_groups`), ball attention with the
``sigma * cdist`` distance bias, stride pooling with BatchNorm, and a UNet of
encoder levels, a bottleneck and decoder levels.

Module names follow the reference torch schema (``encoder.0.blocks.3.BMSA``,
``encoder.0.pool.norm``, ``decoder.0.unpool.proj``, ``bottleneck.blocks.1``)
so ``state_dict`` keys match ``haet_tpu.utils.torch_import``'s export.

``ErwinTransformerBlock(use_pallas=True)`` runs each block through the
fused CUDA kernels (:mod:`haet_torch.ops.kernels.erwin_block`, forward and
backward) when its shape passes the kernels' ``eligible`` gate, and the
plain block otherwise, as the JAX module routes to XLA
(``haet_tpu/models/erwin.py:157-158``). Each such fall-back adds one to
``erwin_block.PLAIN_ROUTES`` (and to ``BWD_PLAIN_ROUTES`` when autograd
records it), so a run can show that no block of its path left the kernels.

Pooling and unpooling normalise with :class:`FlaxBatchNorm1d`, which in
train mode updates its running variance as flax does; under a mesh
(:mod:`haet_torch.parallel`) ``forward(..., group=)`` takes its train-mode
statistics over the clouds of every rank of ``group``.

With ``mp_steps > 0`` the embedding runs :class:`MPNN` message passing over
capped-degree neighbours (:mod:`haet_torch.ops.neighbors`): the radius
graph when ``mp_radius`` is set, kNN otherwise. ``grouping="morton"`` orders
the balls by a Z-order sort (:func:`~haet_torch.ops.ball_groups.morton_perm`).

``dtype`` is the compute dtype (``haet_tpu/models/erwin.py``'s flax
``dtype``; None for float32, or ``torch.bfloat16``): the Linears compute in
it, the RMSNorms and BatchNorms normalise in float32 and return it
(:mod:`haet_torch.ops.dense`), and the ball attention takes its logits and
softmax in float32. The parameters and BatchNorm statistics stay float32.
The fused block computes in float32 whatever ``dtype``, and reads and
writes its activations in it, as the JAX kernel does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ball_groups import (GROUPERS, ErwinPerms, build_erwin_perms,
                               effective_ball_size)
from ..ops.dense import normalized
from ..ops.kernels.erwin_block import (BWD_PLAIN_ROUTES, PLAIN_ROUTES,
                                       ball_msa, eligible, fused_erwin_block)
from ..ops.neighbors import knn_edges, radius_edges
from ..parallel.collectives import group_moments, group_size, sync_batch_norm
from ..utils.env import grad_off
from .components.mlp import Linear, SwiGLU


@dataclass
class Node:
    """Coarse-to-fine state linked list (reference ``node.py:8-16``)."""

    x: torch.Tensor            # [B, N_level, C]
    pos: torch.Tensor          # [B, N_level, D]
    rot_perm: Optional[torch.Tensor] = None
    rot_inv_perm: Optional[torch.Tensor] = None
    children: Optional["Node"] = None


def _gather_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b]]`` for ``a: [B, N, C]``, ``idx: [B, M]``."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


class BallMSA(nn.Module):
    """Ball multi-head self-attention (reference ``attention.py:12-91``)."""

    def __init__(self, dim: int, num_heads: int, ball_size: int,
                 dimensionality: int = 3, use_dist_bias: bool = True,
                 dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.ball_size = ball_size
        self.dtype = dtype
        self.pe_proj = nn.Linear(dimensionality, dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.sigma_att = (nn.Parameter(torch.empty(1, num_heads, 1, 1))
                          if use_dist_bias else None)

    def forward(self, x, pos):
        return ball_msa(x, pos, self.pe_proj.weight, self.pe_proj.bias,
                        self.qkv.weight, self.qkv.bias, self.sigma_att,
                        self.proj.weight, self.proj.bias,
                        ball_size=self.ball_size, num_heads=self.num_heads,
                        dtype=self.dtype)


class ErwinTransformerBlock(nn.Module):
    """``x += BMSA(RMSNorm(x)); x += SwiGLU(RMSNorm(x))`` (``layers.py:14-32``),
    RMSNorm eps 1e-6."""

    def __init__(self, dim: int, num_heads: int, ball_size: int,
                 mlp_ratio: int, dimensionality: int = 3,
                 use_dist_bias: bool = True, use_pallas: bool = False,
                 dtype=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.ball_size = ball_size
        self.use_dist_bias = use_dist_bias
        self.use_pallas = use_pallas
        self.dtype = dtype
        self.norm1 = nn.RMSNorm(dim, eps=1e-6)
        self.BMSA = BallMSA(dim, num_heads, ball_size, dimensionality,
                            use_dist_bias, dtype)
        self.norm2 = nn.RMSNorm(dim, eps=1e-6)
        self.swiglu = SwiGLU(dim, dim * mlp_ratio, dtype)

    def fused_ok(self, x, pos) -> bool:
        return eligible(x.shape[1], x.shape[2], self.num_heads, self.dim,
                        self.swiglu.w1.out_features, pos.shape[-1])

    def forward(self, x, pos):
        if self.use_pallas:
            if self.fused_ok(x, pos):
                return fused_erwin_block(
                    x, pos, dict(self.named_parameters()),
                    ball_size=self.ball_size, num_heads=self.num_heads,
                    use_dist_bias=self.use_dist_bias)
            PLAIN_ROUTES.add()
            if torch.is_grad_enabled() and (
                    x.requires_grad or self.norm1.weight.requires_grad):
                BWD_PLAIN_ROUTES.add()
        x = x + self.BMSA(normalized(self.norm1, x, self.dtype), pos)
        return x + self.swiglu(normalized(self.norm2, x, self.dtype))


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over ``[rows, C]`` as flax's ``nn.BatchNorm(momentum=0.9)``
    (``haet_tpu/models/erwin.py:217-218,249-250``).

    Eval mode is torch's. Train mode normalises with the biased batch
    statistics, as torch does, but updates ``running_var`` with the
    **biased** batch variance, where torch uses the unbiased one:
    ``running = 0.9 running + 0.1 batch``. The state-dict keys are
    ``nn.BatchNorm1d``'s. With a compute ``dtype`` the statistics and the
    normalisation are float32 and the output is cast to it. While
    ``recomputing`` (a checkpointed block's forward run again in the
    backward, ``components.dropout.checkpoint_contexts``) train mode
    normalises as before and leaves the running statistics alone.

    ``group`` (a process group of more than one rank, whose ranks hold
    other rows of the batch: dp, and tp under a head split) makes the
    train-mode statistics the group's, as JAX's BatchNorm normalises the
    global batch under a mesh: each rank's ``(count, mean, biased var)``
    combined in float32 (``parallel.collectives.group_moments``), the
    running statistics updated from them, equal on every rank, and a
    backward that sums ``sum dy`` and ``sum dy * xhat`` over the group
    (``sync_batch_norm``). The recompute of a checkpointed block replays
    these collectives in the same order on every rank. A group of one rank,
    or None, takes the single-device route above, so a mesh of one rank is
    bit for bit the model without one.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, dtype=None):
        super().__init__(num_features, eps=eps, momentum=0.1)
        self.compute_dtype = dtype
        self.recomputing = False

    def forward(self, x, group=None):
        return normalized(lambda v: self._normalize(v, group), x,
                          self.compute_dtype)

    def _normalize(self, x, group):
        if not self.training:
            return super().forward(x)
        if group_size(group) == 1:
            if not self.recomputing:
                with torch.no_grad():
                    var, mean = torch.var_mean(x, dim=0, correction=0)
                    self._update(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, self.eps)
        with torch.no_grad():
            mean, var, count = group_moments(x.detach(), group)
            if not self.recomputing:
                self._update(mean, var)
        return sync_batch_norm(x, self.weight, self.bias, mean,
                               torch.rsqrt(var + self.eps), count, group)

    def _update(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)


class BallPooling(nn.Module):
    """Coarsen by ``stride`` (eq. 12; reference ``pooling.py:10-40``);
    BatchNorm eps 1e-5 over the flattened ``[B*N, C]`` rows."""

    def __init__(self, in_dim: int, out_dim: int, stride: int,
                 dimensionality: int = 3, dtype=None):
        super().__init__()
        self.stride = stride
        if stride > 1:
            self.proj = Linear(stride * (in_dim + dimensionality), out_dim,
                               dtype=dtype)
            self.norm = FlaxBatchNorm1d(out_dim, eps=1e-5, dtype=dtype)

    def forward(self, node: Node, group=None) -> Node:
        if self.stride == 1:
            return Node(x=node.x, pos=node.pos, children=node)
        B, N, C = node.x.shape
        D = node.pos.shape[-1]
        s = self.stride
        with grad_off():
            pos_g = node.pos.reshape(B, N // s, s, D)
            centers = pos_g.mean(dim=2)
            rel_pos = (pos_g - centers[:, :, None]).reshape(B, N // s, s * D)
        x = torch.cat([node.x.reshape(B, N // s, s * C),
                       rel_pos.to(node.x.dtype)], dim=-1)
        x = self.proj(x)
        x = self.norm(x.reshape(-1, x.shape[-1]), group).reshape(x.shape)
        return Node(x=x, pos=centers, children=node)


class BallUnpooling(nn.Module):
    """Refine back to the children's resolution (eq. 13;
    ``pooling.py:43-72``)."""

    def __init__(self, in_dim: int, out_dim: int, stride: int,
                 dimensionality: int = 3, dtype=None):
        super().__init__()
        self.stride = stride
        self.out_dim = out_dim
        self.proj = Linear(in_dim + stride * dimensionality,
                           stride * out_dim, dtype=dtype)
        self.norm = FlaxBatchNorm1d(out_dim, eps=1e-5, dtype=dtype)

    def forward(self, node: Node, group=None) -> Node:
        children = node.children
        B, Np, _ = node.x.shape
        D = node.pos.shape[-1]
        s = self.stride
        with grad_off():
            rel_pos = (children.pos.reshape(B, Np, s, D)
                       - node.pos[:, :, None]).reshape(B, Np, s * D)
        x = torch.cat([node.x, rel_pos.to(node.x.dtype)], dim=-1)
        up = self.proj(x).reshape(B, Np * s, self.out_dim)
        y = children.x + up
        x = self.norm(y.reshape(-1, self.out_dim), group).reshape(y.shape)
        return Node(x=x, pos=children.pos, rot_perm=children.rot_perm,
                    rot_inv_perm=children.rot_inv_perm,
                    children=children.children)


class BasicLayer(nn.Module):
    """``depth`` blocks with rotation on odd blocks, then pool/unpool
    (reference ``layers.py:35-92``)."""

    def __init__(self, direction: Optional[str], depth: int,
                 stride: Optional[int], in_dim: int, out_dim: int,
                 num_heads: int, ball_size: int, mlp_ratio: int, rotate: bool,
                 dimensionality: int = 3, use_dist_bias: bool = True,
                 use_pallas: bool = False, dtype=None):
        super().__init__()
        self.direction = direction
        self.ball_size = ball_size
        self.rotate = rotate
        hidden_dim = in_dim if direction == "down" else out_dim
        if direction == "up" and stride is not None:
            self.unpool = BallUnpooling(in_dim, hidden_dim, stride,
                                        dimensionality, dtype)
        self.blocks = nn.ModuleList([
            ErwinTransformerBlock(hidden_dim, num_heads, ball_size, mlp_ratio,
                                  dimensionality, use_dist_bias, use_pallas,
                                  dtype)
            for _ in range(depth)])
        if direction == "down" and stride is not None:
            self.pool = BallPooling(hidden_dim, out_dim, stride,
                                    dimensionality, dtype)

    def forward(self, node: Node, group=None) -> Node:
        if hasattr(self, "unpool"):
            node = self.unpool(node, group)
        n_level = node.x.shape[1]
        full_ball = effective_ball_size(self.ball_size, n_level) >= n_level
        for i, blk in enumerate(self.blocks):
            # A single-ball level skips rotation: it permutes inside the
            # ball, and full-ball attention is permutation-equivariant.
            rot = self.rotate and i % 2 == 1 and not full_ball
            if rot:
                if node.rot_perm is None:
                    raise ValueError("rot_perm must be provided for rotation "
                                     "(reference layers.py:78-80)")
                out = blk(_gather_rows(node.x, node.rot_perm),
                          _gather_rows(node.pos, node.rot_perm))
                node.x = _gather_rows(out, node.rot_inv_perm)
            else:
                node.x = blk(node.x, node.pos)
        if hasattr(self, "pool"):
            node = self.pool(node, group)
        return node


class MPNN(nn.Module):
    """Message passing over capped-degree dense neighbours
    (``haet_tpu/models/erwin.py:354-415``; reference
    ``components/mpnn.py:10-75``, a ragged edge list and ``scatter_mean``
    there). Each point carries ``K`` neighbour slots; a step is

    ``msg = LN(gelu(message_i([h_j, h_i, pos_j - pos_i])))``,
    ``agg = sum over valid slots of msg / max(#valid, 1)``,
    ``h += LN(update_i([h, agg]))``,

    with exact GELU and non-affine LayerNorms of eps 1e-5. The edge
    attributes carry no gradient. Module names are the reference's
    (``fused_message_update.i.0``, ``update_fns.i.0``), the keys
    ``haet_torch/utils/weights.py`` maps JAX's ``message_i``/``update_i``
    to."""

    def __init__(self, dim: int, mp_steps: int, dimensionality: int = 3,
                 dtype=None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.fused_message_update = nn.ModuleList([
            nn.Sequential(Linear(2 * dim + dimensionality, dim, dtype=dtype))
            for _ in range(mp_steps)])
        self.update_fns = nn.ModuleList([
            nn.Sequential(Linear(2 * dim, dim, dtype=dtype))
            for _ in range(mp_steps)])

    def _norm(self, x):
        return normalized(lambda v: F.layer_norm(v, (self.dim,), eps=1e-5),
                          x, self.dtype)

    def forward(self, h, pos, nbr_idx, nbr_valid):
        """``h [B, N, C]``, ``pos [B, N, D]``, ``nbr_idx``/``nbr_valid``
        ``[B, N, K]``."""
        if nbr_idx is None:
            raise ValueError("MPNN requires neighbour indices (mp_steps > 0)")
        B, N, K = nbr_idx.shape
        flat = nbr_idx.reshape(B, N * K)

        def nbr_gather(a):
            return _gather_rows(a, flat).reshape(B, N, K, a.shape[-1])

        edge_attr = (nbr_gather(pos) - pos[:, :, None]).detach()
        w = nbr_valid[..., None].to(h.dtype)
        denom = w.sum(dim=2).clamp_min(1.0)
        for message, update in zip(self.fused_message_update,
                                   self.update_fns):
            h_j = nbr_gather(h)
            h_i = h[:, :, None].expand_as(h_j)
            msg = message(torch.cat([h_j, h_i, edge_attr.to(h.dtype)], -1))
            msg = self._norm(F.gelu(msg, approximate="none"))
            agg = (msg * w).sum(dim=2) / denom
            h = h + self._norm(update(torch.cat([h, agg], dim=-1)))
        return h


class ErwinEmbedding(nn.Module):
    """Linear embedding, then :class:`MPNN` when ``mp_steps > 0``
    (reference ``embedding.py:12-20``)."""

    def __init__(self, c_in: int, c_hidden: int, mp_steps: int,
                 dimensionality: int = 3, dtype=None):
        super().__init__()
        self.embed_fn = Linear(c_in, c_hidden, dtype=dtype)
        if mp_steps > 0:
            self.mpnn = MPNN(c_hidden, mp_steps, dimensionality, dtype)

    def forward(self, x, pos, nbr_idx=None, nbr_valid=None):
        x = self.embed_fn(x)
        if hasattr(self, "mpnn"):
            x = self.mpnn(x, pos, nbr_idx, nbr_valid)
        return x


class ErwinTransformer(nn.Module):
    """UNet-shaped hierarchical ball-attention transformer
    (``haet_tpu/models/erwin.py:418-568``, reference
    ``erwin_flash.py:40-56``).

    ``forward(x [B, N, c_in], pos [B, N, D], mask=None)`` with N a power of
    two; returns the decoded ``[B, N, c_hidden[0]]`` in input order, with
    any masked points last. The JAX module's ``decode=False`` (the coarse
    ``(x, pos)``) is not ported: physics attention, its one caller here,
    needs the decoded states. With ``mp_steps > 0`` (and ``embed``) the
    message passing's neighbours are the radius graph of ``mp_radius``
    capped at ``mp_neighbors``, or the ``mp_neighbors`` nearest without a
    radius (``haet_tpu/models/erwin.py:483-496``). ``group``: the process
    group whose ranks hold the batch's other clouds, over which the
    BatchNorms take their train-mode statistics (:class:`FlaxBatchNorm1d`).
    """

    def __init__(self, c_in: int, c_hidden: Sequence[int],
                 ball_sizes: Sequence[int], enc_num_heads: Sequence[int],
                 enc_depths: Sequence[int], dec_num_heads: Sequence[int],
                 dec_depths: Sequence[int], strides: Sequence[int],
                 rotate: int = 45, mlp_ratio: int = 4,
                 dimensionality: int = 3, mp_steps: int = 3,
                 embed: bool = True, use_dist_bias: bool = True,
                 use_pallas_blocks: bool = False, grouping: str = "median",
                 mp_neighbors: int = 16, mp_radius: Optional[float] = None,
                 dtype=None):
        super().__init__()
        if not (len(enc_num_heads) == len(enc_depths) == len(ball_sizes)
                and len(dec_num_heads) == len(dec_depths) == len(strides)
                and len(strides) == len(ball_sizes) - 1):
            raise ValueError("inconsistent Erwin level configuration")
        if grouping not in GROUPERS:
            raise ValueError(f"unknown grouping {grouping!r}")
        self.ball_sizes = tuple(ball_sizes)
        self.strides = tuple(strides)
        self.rotate = rotate
        self.grouping = grouping
        self.mp_steps = mp_steps
        self.mp_neighbors = mp_neighbors
        self.mp_radius = mp_radius
        if embed:
            self.embed = ErwinEmbedding(c_in, c_hidden[0], mp_steps,
                                        dimensionality, dtype)
        common = dict(mlp_ratio=mlp_ratio, rotate=rotate > 0,
                      dimensionality=dimensionality,
                      use_dist_bias=use_dist_bias,
                      use_pallas=use_pallas_blocks, dtype=dtype)
        num_layers = len(enc_depths) - 1
        self.encoder = nn.ModuleList([
            BasicLayer("down", enc_depths[i], strides[i], c_hidden[i],
                       c_hidden[i + 1], enc_num_heads[i], ball_sizes[i],
                       **common)
            for i in range(num_layers)])
        self.bottleneck = BasicLayer(
            None, enc_depths[-1], None, c_hidden[-1], c_hidden[-1],
            enc_num_heads[-1], ball_sizes[-1], **common)
        self.decoder = nn.ModuleList([
            BasicLayer("up", dec_depths[i], strides[i], c_hidden[i + 1],
                       c_hidden[i], dec_num_heads[i], ball_sizes[i], **common)
            for i in range(num_layers - 1, -1, -1)])

    def forward(self, x, pos, *, perms: Optional[ErwinPerms] = None,
                mask=None, group=None):
        if perms is None:
            perms = build_erwin_perms(
                pos, ball_sizes=self.ball_sizes, strides=self.strides,
                rotate_angle=float(self.rotate), grouping=self.grouping,
                mask=mask)
        if hasattr(self, "embed"):
            nbr_idx = nbr_valid = None
            if self.mp_steps > 0:
                if self.mp_radius is not None:
                    nbr_idx, nbr_valid = radius_edges(
                        pos.detach(), self.mp_radius, self.mp_neighbors,
                        mask=mask)
                else:
                    nbr_idx, nbr_valid = knn_edges(
                        pos.detach(), self.mp_neighbors, mask=mask)
            x = self.embed(x, pos, nbr_idx, nbr_valid)
        node = Node(x=_gather_rows(x, perms.perm),
                    pos=_gather_rows(pos, perms.perm))
        num_layers = len(self.encoder)
        for i, layer in enumerate(self.encoder):
            node.rot_perm = perms.rot_perms[i]
            node.rot_inv_perm = perms.rot_inv_perms[i]
            node = layer(node, group)
        node.rot_perm = perms.rot_perms[num_layers]
        node.rot_inv_perm = perms.rot_inv_perms[num_layers]
        node = self.bottleneck(node, group)
        for layer in self.decoder:
            node = layer(node, group)
        return _gather_rows(node.x, perms.unperm)
