"""Physics attention — the Transolver++ rep-slice tokenizer, PyTorch.

Counterpart of ``haet_tpu/models/physics_attention.py``: three variants
sharing one core, slice -> Erwin transform -> deslice
(``_PhysicsAttentionBase``, ``StructuredMesh2D.py:157-262``), that differ
only in the input projection (the ``_project`` hook) and the Erwin
pseudo-positions' dimensionality:

* :class:`PhysicsAttentionIrregularMesh`: Linear (``IrregularMesh.py:95``),
  dimensionality 3;
* :class:`PhysicsAttentionStructuredMesh2D`: a 3x3 Conv2d over the ``H x W``
  grid (``StructuredMesh2D.py:109``), dimensionality 2;
* :class:`PhysicsAttentionStructuredMesh3D`: a 3x3x3 Conv3d over the ``H x W
  x D`` volume (``StructuredMesh3D.py:113``), dimensionality 3.

The convolutions are SAME-padded with torch's default initialisation, which
is the reference's (its ``_init_weights`` touches only Linear and norm
layers; JAX copies it with ``torch_conv_kernel_init``/``torch_conv_bias_init``,
``:45-63``), drawn from the model's generator. Points arrive grid-major
(``[B, H*W, C]``, channels last, as the JAX NHWC convolution reads them);
the convolution runs channels-first (NCHW) between two permutes, and the
``[B, H, N, C]`` layout the slice kernels take is unchanged.

``use_pallas=True`` routes the slice and deslice through the fused CUDA
kernels (:mod:`haet_torch.ops.kernels.slice_kernels`), which never
materialise the ``[B, H, N, G]`` weights, and through their autograd
functions, whose chunked backwards do not either; ``use_pallas_erwin=True``
runs each Erwin block through the fused block kernels. The flag names are
the JAX package's, so a config means the same thing in both.
``use_pallas="auto"`` picks the route per forward from the input's point
count and device (:func:`pallas_auto_enabled`, JAX ``:239-257``). The
pseudo-positions are computed without gradient, as JAX stops it
(``:347``).

The Erwin pseudo-positions are min-max normalised over the WHOLE flattened
``B*H*G`` token batch (``:344-351``, reference ``:228-234``), so a sample's
output depends on the samples batched with it; the port keeps this.

``dtype`` is the compute dtype (None or ``torch.bfloat16``), as the JAX
module's: ``in_project_x`` and ``to_out`` compute in it (a bf16 convolution
over float32 parameters, the bias added to the rounded product, as flax's
``nn.Conv`` does), so ``x_proj``, the states, the pseudo-positions and the
output are in it. The slice parameters are float32, so the plain path's
logits and softmax promote to float32 (``:320-335``), and its ``[B, H, N,
G]`` weights are stored in the compute dtype; the kernels take ``x_proj`` in
the compute dtype and upcast it inside
(:mod:`haet_torch.ops.kernels.slice_kernels`).

The output passes :class:`~haet_torch.models.components.dropout.Dropout`
(``to_out.1``, ``:415``), which draws from the model's generator.

On a mesh (:mod:`haet_torch.parallel`) each rank runs its part of a forward
(``forward(x, layout)``, the counterpart of JAX's ``shard_axes``,
``:105-114, 141-237, 264-282``):

* dp: the rank's batch rows; the pseudo-positions' min and max are
  all-reduced over the ranks that hold other clouds, and Erwin's BatchNorm
  takes their statistics (:class:`~haet_torch.models.erwin.FlaxBatchNorm1d`);
* head TP (``shard_axes=(batch_axis, head_axis)`` and a mesh whose head
  axis divides the heads): the rank projects its ``H / tp`` heads' columns
  and runs the slice -> Erwin -> deslice core, kernels included, on its
  ``[B, H / tp, N, Dh]`` shard, as JAX's ``shard_map`` does
  (``_pallas_shard_map``); the heads are all-gathered before ``to_out``.
  The projection's input sums its gradient over tp, and the core's
  parameters receive this rank's part of theirs
  (:meth:`head_sharded_parameters`), which the trainer sums over tp;
* cp (a ``(dp, cp)`` mesh): the rank's points. The plain path's softmax
  over N takes its max and its sum over the axis, and the eidetic states
  their sums; the deslice is local. The kernels take the points gathered
  over cp and run on the whole cloud, then keep the rank's rows, which is
  what XLA's replication of a ``pallas_call`` computes (``:188-191``).

The route (kernels or plain path) is ``use_pallas``'s alone, with a mesh
or without. JAX's ``shard_map`` needs a mesh that divides (batch, heads)
(``:264-282``); the port does not: a batch that dp does not divide stays
whole on every rank, heads that tp does not divide run unsplit on every
rank, and the kernels run on either as on one rank. A model with
``shard_axes`` and no mesh runs unsharded.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import slice_ops
from ..ops.ball_groups import pad_pow2
from ..ops.dense import linear
from ..ops.kernels import slice_kernels as sk
from ..parallel.collectives import (all_reduce_max, axis_part, gather,
                                    reduce_grad)
from ..utils.config import PALLAS_AUTO_G_SPAN, PALLAS_AUTO_THRESHOLD
from ..utils.env import grad_off
from .components.dropout import Dropout
from .components.mlp import Linear
from .erwin import ErwinTransformer


def pallas_auto_enabled(n_points: int, slice_num: int, threshold: int,
                        device_type: str) -> bool:
    """Whether ``use_pallas="auto"`` takes the slice kernels for a forward
    of ``n_points`` points per sample on a ``device_type`` tensor.

    The rule is the JAX package's (``_pallas_enabled``, ``:239-257``): a
    base threshold at G 32, scaled linearly in G and floored at a quarter,
    ``n_points >= int(threshold * max(0.25, 1 - (G - 32) / span))``. JAX
    takes the kernels only on a TPU backend; the port only for a CUDA
    input, and the plain path at every N on the CPU, as JAX does there.

    The constants (:data:`~haet_torch.utils.config.PALLAS_AUTO_THRESHOLD`,
    :data:`~haet_torch.utils.config.PALLAS_AUTO_G_SPAN`) are the card's,
    measured for it, where the JAX package's came from TPU memory (there
    the kernels were slower at small N). On one NVIDIA H100 80GB HBM3 at
    700 W (``PERF.md``, Findings, PR 13), the threshold at a G is the
    smallest N from which the kernel step is no slower than the plain
    one, capped at 0.75x the plain path's training boundary:

    * speed, G 32: ``python -m haet_torch.benchmarks.mfu_sweep --ns N``
      (the car step in bf16, CUDA graphs) took 0.966x the plain step's
      time with the kernels at N 256, 0.953x at 1024, 0.648x at 32768 and
      0.322x at 1048576; no N measured was slower, so the base is the
      smallest measured, 256 (below every preset: elasticity's 972 points
      is the fewest);
    * speed, G 128: ``python -m haet_torch.benchmarks.bench_flags
      --slice_num 128`` gave 0.977x at N 256 and 0.363x at 131072: the
      same threshold, 256, hence no G scaling (an infinite span);
    * memory: ``python -m haet_torch.benchmarks.mem_sweep --grad 1``
      (1-layer probe, bf16) held 4.5M points on the plain path at G 32
      and 2.0M at G 128 (the kernels 7.0M at both), caps of 3,375,000 and
      1,500,000 points that the speed thresholds lie far below.
    """
    if device_type != "cuda":
        return False
    scale = max(0.25, 1.0 - (slice_num - 32) / PALLAS_AUTO_G_SPAN)
    return n_points >= int(threshold * scale)


class _PhysicsAttentionBase(nn.Module):
    """The slice -> Erwin -> deslice core (``:66-415``). A variant sets
    :attr:`dimensionality` and builds ``in_project_x`` in
    :meth:`_make_project` and applies it in :meth:`_project`.

    Parameter names follow the reference schema: ``in_project_x``,
    ``in_project_slice`` (``[G, dim_head]``), ``ada_temp_linear``
    (``[1, dim_head]``), ``erwin``, ``to_out.0``.
    """

    dimensionality = 3

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, slice_num: int = 64,
                 base_temp: float = 0.5, epsilon: float = 1e-6,
                 c_hidden: Optional[Sequence[int]] = None,
                 ball_sizes: Optional[Sequence[int]] = None,
                 enc_num_heads: Optional[Sequence[int]] = None,
                 enc_depths: Optional[Sequence[int]] = None,
                 dec_num_heads: Optional[Sequence[int]] = None,
                 dec_depths: Optional[Sequence[int]] = None,
                 strides: Optional[Sequence[int]] = None, rotate: int = 1,
                 decode: bool = True, mlp_ratio: int = 4, mp_steps: int = 0,
                 embed: bool = False, use_dist_bias: bool = True,
                 grouping: str = "median", orthogonal_slice_init: bool = True,
                 use_pallas=False, use_pallas_erwin: bool = False,
                 pallas_auto_threshold: int = PALLAS_AUTO_THRESHOLD,
                 shard_axes=None, dtype=None):
        super().__init__()
        if not decode:
            raise ValueError(
                "decode=False is not valid inside physics attention: the "
                "slice->erwin->deslice core needs per-slice-token states")
        self.heads = heads
        self.dim_head = dim_head
        self.slice_num = slice_num
        self.base_temp = base_temp
        self.epsilon = epsilon
        #: False, True or "auto" (resolved per forward by
        #: :meth:`pallas_enabled`)
        self.use_pallas = use_pallas if use_pallas == "auto" else bool(
            use_pallas)
        self.pallas_auto_threshold = int(pallas_auto_threshold)
        #: set by :func:`haet_torch.utils.visualization.get_slice_weights`:
        #: the next forwards keep their ``[B, H, N, G]`` slice weights in
        #: :attr:`slice_weights` (the JAX module's ``sow``)
        self.capture_slice_weights = False
        self.slice_weights = None
        self.orthogonal_slice_init = orthogonal_slice_init
        #: ``(batch_axis, head_axis)`` mesh axis names, or None
        self.shard_axes = None if shard_axes is None else tuple(shard_axes)
        #: the bound mesh's head split (:meth:`bind_mesh`): the tp group,
        #: its size and this rank's index, or None
        self.head_split = None
        self.dtype = dtype
        g, h, dh = slice_num, heads, dim_head
        inner = dim_head * heads
        self.in_project_x = self._make_project(dim, inner)
        self.in_project_slice = nn.Linear(dh, g)
        self.ada_temp_linear = nn.Linear(dh, 1)
        self.erwin = ErwinTransformer(
            c_in=dh,
            c_hidden=tuple(c_hidden) if c_hidden else (dh, dh * 2),
            ball_sizes=tuple(ball_sizes) if ball_sizes
            else (min(32, g), min(16, g // 2)),
            enc_num_heads=tuple(enc_num_heads) if enc_num_heads
            else (h // 2, h),
            enc_depths=tuple(enc_depths) if enc_depths else (2, 2),
            dec_num_heads=tuple(dec_num_heads) if dec_num_heads
            else (h // 2,),
            dec_depths=tuple(dec_depths) if dec_depths else (2,),
            strides=tuple(strides) if strides else (2,),
            rotate=rotate, mlp_ratio=mlp_ratio,
            dimensionality=self.dimensionality, mp_steps=mp_steps,
            embed=embed, use_dist_bias=use_dist_bias,
            use_pallas_blocks=use_pallas_erwin, grouping=grouping,
            dtype=dtype)
        self.to_out = nn.Sequential(Linear(inner, dim, dtype=dtype),
                                    Dropout(dropout))

    def _make_project(self, dim: int, inner: int) -> nn.Module:
        raise NotImplementedError

    def _project(self, x, rows=None):
        """``[B, N, dim] -> [B, heads, N, dim_head]`` (a view); with
        ``rows``, a function of a parameter giving this rank's part of the
        projection's output features, only those heads."""
        raise NotImplementedError

    def _slice_params(self):
        """``(Ws [C, G], bs [G], Wa [C, 1], ba [1])`` in the JAX layout."""
        return (self.in_project_slice.weight.t().contiguous(),
                self.in_project_slice.bias,
                self.ada_temp_linear.weight.t().contiguous(),
                self.ada_temp_linear.bias)

    def pallas_enabled(self, n_points: int, device_type: str) -> bool:
        """The route of a forward of ``n_points`` points per sample on a
        ``device_type`` tensor: ``use_pallas``, or for ``"auto"``
        :func:`pallas_auto_enabled` with this module's G and threshold."""
        if self.use_pallas == "auto":
            return pallas_auto_enabled(n_points, self.slice_num,
                                       self.pallas_auto_threshold,
                                       device_type)
        return self.use_pallas

    def plain_slice_weights(self, x_proj, group=None):
        """The ``[B, H, N, G]`` rep-slice weights by the plain formula, in
        ``x_proj``'s dtype. The slice parameters are float32, so the
        logits and softmax promote to float32 (``x_proj @ w_ada + b_ada``
        in JAX). ``group``: the point axis's, over which the softmax's max
        and sum are taken."""
        xf = x_proj.float()
        tau = slice_ops.ada_temp(self.ada_temp_linear(xf), self.base_temp)
        logits = self.in_project_slice(xf)
        return slice_ops.rep_slice_weights(logits, tau, self.epsilon,
                                           group).to(x_proj.dtype)

    def _shard_axes_active(self) -> bool:
        return self.shard_axes is not None and any(
            a is not None for a in self.shard_axes)

    def bind_mesh(self, mesh) -> None:
        """Take ``mesh`` (None: none) for the forwards to come: with
        ``shard_axes`` whose head axis is a mesh axis of size > 1 that
        divides the heads, each rank runs ``heads / size`` of them
        (:attr:`head_split`)."""
        self.head_split = None
        if mesh is None or not self._shard_axes_active():
            return
        h_ax = self.shard_axes[1]
        n = mesh.size(h_ax) if h_ax is not None else 0
        if n > 1 and self.heads % n == 0:
            self.head_split = (mesh.group(h_ax), n, mesh.coords[h_ax])

    def head_sharded_parameters(self) -> list:
        """The parameters used inside the head-sharded core (the
        projection, whose columns of other heads get no gradient here, the
        slice and temperature heads and Erwin, which every head shares):
        each tp rank's gradient is a part, summed over tp by the trainer.
        Empty without a head split."""
        if self.head_split is None:
            return []
        return [p for mod in (self.in_project_x, self.in_project_slice,
                              self.ada_temp_linear, self.erwin)
                for p in mod.parameters()]

    def forward(self, x, layout=None):
        """``x: [B, N, dim] -> [B, N, dim]``: this rank's part of the batch
        under a mesh's ``layout`` (None: the whole forward)."""
        B, N, _ = x.shape
        G, Dh = self.slice_num, self.dim_head
        n_points = layout.points if layout is not None else N
        use_pallas = self.pallas_enabled(n_points, x.device.type)
        split = self.head_split if layout is not None else None
        H = self.heads // split[1] if split else self.heads
        cp = layout.mesh.group("cp") if layout and layout.cp else None
        rows = None
        if split:
            x = reduce_grad(x, split[0])
            rows = functools.partial(axis_part, group=split[0],
                                     index=split[2], n=split[1])

        # (1) Slice
        x_proj = self._project(x, rows).contiguous()
        ws, bs, wa, ba = self._slice_params()
        w = None
        if use_pallas:
            if cp is not None:  # the kernels see every point
                x_proj = gather(x_proj, cp, 2, reduce=True)
            states, m_res, s_res = sk.slice_states(
                x_proj, ws, bs, wa, ba, self.base_temp, self.epsilon)
            if self.capture_slice_weights:
                # the kernels never write the weights: the capturing
                # forward recomputes them by the plain formula (JAX
                # :316-340); other forwards skip this branch
                with grad_off():
                    self.slice_weights = self.plain_slice_weights(x_proj)
        else:
            w = self.plain_slice_weights(x_proj, cp)
            states = slice_ops.eidetic_states(x_proj, w, cp)  # [B, H, G, Dh]
            if self.capture_slice_weights:
                self.slice_weights = w.detach()

        # (2) Erwin over B*H clouds of G tokens; pseudo-positions are the
        # first d channels, min-max normalised over the GLOBAL flat batch:
        # over every rank that holds other clouds
        d = self.dimensionality
        flat = states.reshape(B * H * G, Dh)
        clouds = None
        if layout is not None:
            clouds = layout.mesh.group(*(("dp",) if layout.dp else ()),
                                       *(("tp",) if split else ()))
        with grad_off():
            feat = flat[:, :d]
            fmin = feat.amin(dim=0, keepdim=True)
            fmax = feat.amax(dim=0, keepdim=True)
            if clouds is not None:
                fmax, fmin = all_reduce_max(
                    torch.cat([fmax, -fmin]), clouds).chunk(2)
                fmin = -fmin
            pos = ((feat - fmin) / (fmax - fmin + 1e-8)).reshape(B * H, G, d)
        s_in = states.reshape(B * H, G, Dh)
        mask = None
        if G & (G - 1):  # pad non-power-of-two slice counts
            s_in, pos, mask = pad_pow2(s_in, pos)
        out_states = self.erwin(s_in, pos, mask=mask, group=clouds)
        if mask is not None:
            out_states = out_states[:, :G]
        out_states = out_states.reshape(B, H, G, Dh).contiguous()

        # (3) Deslice
        if use_pallas:
            out = sk.deslice(x_proj, ws, bs, wa, ba, out_states, m_res, s_res,
                             self.base_temp, self.epsilon)
            if cp is not None:
                out = out[:, :, layout.point_rows()]
        else:
            out = slice_ops.deslice(out_states, w)
        out = slice_ops.merge_heads(out)
        if split:
            out = gather(out, split[0], 2)
        out = self.to_out[0](out)
        return self.to_out[1](
            out, layout.dropout_part(out.shape) if layout else None)


class PhysicsAttentionIrregularMesh(_PhysicsAttentionBase):
    """Linear slice projection; dimensionality 3 (``IrregularMesh.py:91``)."""

    dimensionality = 3

    def _make_project(self, dim, inner):
        return Linear(dim, inner, dtype=self.dtype)

    def _project(self, x, rows=None):
        p = self.in_project_x
        if rows is None:
            return slice_ops.split_heads(p(x), self.heads)
        y = linear(x, rows(p.weight), rows(p.bias), self.dtype)
        return slice_ops.split_heads(y, y.shape[-1] // self.dim_head)


@torch.no_grad()
def init_conv(conv: nn.Module, generator: torch.Generator) -> None:
    """torch's default Conv initialisation from ``generator``: weight
    ``U(+-1/sqrt(fan_in))`` (kaiming-uniform with a = sqrt(5)) and bias
    ``U(+-1/sqrt(fan_in))``, ``fan_in = in_channels * prod(kernel)``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5),
                             generator=generator)
    bound = 1.0 / math.sqrt(conv.weight[0].numel())
    nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


def conv_same(x, conv: nn.Module, grid: tuple, dtype=None, rows=None):
    """``conv`` (a stride-1, SAME-padded Conv2d or Conv3d) over points laid
    out grid-major, channels last: ``[B, prod(grid), C] -> [B, prod(grid),
    C_out]``. In ``dtype`` (None: as given), the input and the parameters
    cast to it and the bias added to the rounded product, as flax's
    ``nn.Conv(dtype=...)``. ``rows``: a function giving the part of the
    output channels to keep from a parameter."""
    b, n, c = x.shape
    nd = len(grid)
    weight, bias = conv.weight, conv.bias
    if rows is not None:
        weight, bias = rows(weight), rows(bias)
    xg = x.reshape(b, *grid, c).movedim(-1, 1)          # channels first
    fn = F.conv2d if nd == 2 else F.conv3d
    if dtype is None:
        y = fn(xg, weight, bias, padding="same")
    else:
        y = fn(xg.to(dtype), weight.to(dtype), None, padding="same")
    y = y.movedim(1, -1).reshape(b, n, -1)
    return y if dtype is None else y + bias.to(dtype)


class _StructuredMeshBase(_PhysicsAttentionBase):
    """A SAME-padded ``kernel``-wide convolution over the grid
    :attr:`grid`; ``x`` is ``[B, prod(grid), dim]`` in row-major grid
    order."""

    kernel = 3
    grid: tuple = ()

    def _project(self, x, rows=None):
        y = conv_same(x, self.in_project_x, self.grid, self.dtype, rows)
        return slice_ops.split_heads(y, y.shape[-1] // self.dim_head)

    def forward(self, x, layout=None):
        if layout is not None and layout.cp:
            raise ValueError("the point axis (cp) splits an irregular "
                             "cloud only: a grid's convolution needs every "
                             "point's neighbours")
        return super().forward(x, layout)


class PhysicsAttentionStructuredMesh2D(_StructuredMeshBase):
    """Conv2d slice projection over the ``H x W`` grid
    (``StructuredMesh2D.py:109``); dimensionality 2."""

    dimensionality = 2

    def __init__(self, dim: int, H: int = 101, W: int = 31, **kwargs):
        super().__init__(dim, **kwargs)
        self.grid = (H, W)

    def _make_project(self, dim, inner):
        return nn.Conv2d(dim, inner, self.kernel, padding="same")


class PhysicsAttentionStructuredMesh3D(_StructuredMeshBase):
    """Conv3d slice projection over the ``H x W x D`` volume
    (``StructuredMesh3D.py:113``); dimensionality 3."""

    dimensionality = 3

    def __init__(self, dim: int, H: int = 32, W: int = 32, D: int = 32,
                 **kwargs):
        super().__init__(dim, **kwargs)
        self.grid = (H, W, D)

    def _make_project(self, dim, inner):
        return nn.Conv3d(dim, inner, self.kernel, padding="same")
