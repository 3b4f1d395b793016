"""HAET models, PyTorch: the three variants of ``haet_tpu/models/haet.py``.

* :class:`HAETransolverStructuredMesh2D` (reference
  ``HAETransolver_Structured_Mesh_2D.py:146``): Conv2d physics attention
  over an ``H x W`` grid;
* :class:`HAETransolverStructuredMesh3D` (``..._3D.py:152``): Conv3d over
  ``H x W x D``;
* :class:`HAETransolverIrregularMesh` (``..._Irregular_Mesh.py:137``):
  Linear over a point cloud.

Each is a stack of pre-LN residual blocks ``fx = Attn(LN(fx)) + fx; fx =
MLP(LN(fx)) + fx`` with ``LN + Linear(out_dim)`` on the last block, over
the physics-attention tokenizer; :class:`_HAETBase` holds what they share
(``haet.py:109-318``).

Call: ``model(x [B, N, space_dim], fx [B, N, fun_dim] or None, T [B, 1] or
None)`` -> ``[B, N, out_dim]``.

* ``unified_pos`` replaces ``x`` by distances to a ``ref^d`` reference
  grid: for the grids, from the unit grid of the model's shape, built once
  with numpy (``_grid_distances_nd``, ``:385-400``); for the irregular
  model, from each sample's first two coordinates.
* The placeholder is added when ``fx`` is None on the grids, and always on
  the irregular model (``:216-223``).
* ``Time_Input`` makes ``time_fc = Sequential(Linear, SiLU, Linear)`` (the
  reference's ``time_fc.0``/``time_fc.2``), which adds the embedding of
  ``T`` when it is given; ``T`` without ``Time_Input`` raises
  (``:224-251``).
* ``use_checkpoint`` runs each block under ``torch.utils.checkpoint``
  (non-reentrant), as ``nn.remat`` does (``:252-257``): its forward runs
  again in the backward, with the same dropout masks and without a second
  update of the BatchNorm statistics
  (:func:`~haet_torch.models.components.dropout.checkpoint_contexts`).
* ``dropout`` > 0 gives the model a ``torch.Generator`` on its device,
  seeded with ``seed`` (:attr:`_HAETBase.dropout_generator`), from which
  every block's dropout draws.
* ``shard_axes`` (``(batch_axis, head_axis)``, JAX ``haet.py:152-154,
  184-185``) lets a bound mesh split the attention heads.
  :meth:`_HAETBase.bind_mesh` makes the model an SPMD program over a
  :class:`~haet_torch.parallel.Mesh`: every rank calls it on the global
  batch, runs its part (its dp rows, its cp points, its tp heads in the
  attention) and returns the global output, all-gathered, whose backward
  keeps the rank's part of the gradient
  (:class:`~haet_torch.parallel.Layout`).

``dtype`` (None or ``torch.bfloat16``) is the JAX model's compute dtype
(``ModelConfig.bf16``): every Linear and convolution computes in it over
float32 parameters, the LayerNorms normalise in float32 and return it. A
float32 placeholder promotes the residual stream to float32, as in JAX,
and the output is in the compute dtype.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dense import normalized
from ..utils.config import PALLAS_AUTO_THRESHOLD
from ..utils.env import default_device
from .components.dropout import Dropout, checkpoint_contexts
from .components.embedding import timestep_embedding
from .components.mlp import MLP, Linear, init_linear
from .erwin import BallMSA
from .physics_attention import (PhysicsAttentionIrregularMesh,
                                PhysicsAttentionStructuredMesh2D,
                                PhysicsAttentionStructuredMesh3D,
                                _PhysicsAttentionBase, init_conv)


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """The reference ``_init_weights`` over every submodule of ``root``:
    trunc-normal(0.02) Linears with zero biases, unit/zero norms,
    ``sigma_att ~ -1 + 0.01 N(0,1)``, torch's default initialisation of the
    convolutions and an orthogonal slice head."""
    for mod in root.modules():
        if isinstance(mod, nn.Linear):
            init_linear(mod, generator)
        elif isinstance(mod, (nn.Conv2d, nn.Conv3d)):
            init_conv(mod, generator)
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.RMSNorm):
            nn.init.ones_(mod.weight)
        elif isinstance(mod, BallMSA) and mod.sigma_att is not None:
            mod.sigma_att.copy_(
                -1.0 + 0.01 * torch.randn(mod.sigma_att.shape,
                                          generator=generator))
    # after the Linear pass, which would overwrite it
    for mod in root.modules():
        if (isinstance(mod, _PhysicsAttentionBase)
                and mod.orthogonal_slice_init):
            nn.init.orthogonal_(mod.in_project_slice.weight,
                                generator=generator)


class TransolverErwinBlock(nn.Module):
    """Pre-LN residual block over the physics attention ``attn_cls``
    (LayerNorm eps 1e-5; ``ln_3``/``mlp2`` on the last layer)."""

    def __init__(self, num_heads: int, hidden_dim: int, dropout: float,
                 act: str = "gelu", mlp_ratio: int = 4,
                 last_layer: bool = False, out_dim: int = 1,
                 attn_cls: type = PhysicsAttentionIrregularMesh,
                 attn_kwargs: Optional[dict] = None, dtype=None):
        super().__init__()
        akw = dict(attn_kwargs or {})
        akw.setdefault("dim_head", hidden_dim // num_heads)
        akw.setdefault("mlp_ratio", mlp_ratio)
        self.last_layer = last_layer
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.Attn = attn_cls(
            dim=hidden_dim, heads=num_heads, dropout=dropout, dtype=dtype,
            **akw)
        self.ln_2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.mlp = MLP(hidden_dim, hidden_dim * mlp_ratio, hidden_dim,
                       n_layers=0, res=False, act=act, dtype=dtype)
        if last_layer:
            self.ln_3 = nn.LayerNorm(hidden_dim, eps=1e-5)
            self.mlp2 = Linear(hidden_dim, out_dim, dtype=dtype)

    def _ln(self, ln, fx):
        return normalized(ln, fx, self.dtype)

    def forward(self, fx, layout=None):
        fx = self.Attn(self._ln(self.ln_1, fx), layout) + fx
        fx = self.mlp(self._ln(self.ln_2, fx)) + fx
        if self.last_layer:
            return self.head(fx)
        return fx

    def head(self, fx):
        """The last layer's output head, ``mlp2(LN_3(fx))``."""
        return self.mlp2(self._ln(self.ln_3, fx))


class _HAETBase(nn.Module):
    """What the three variants share: ``unified_pos``, the preprocess MLP,
    the placeholder, ``Time_Input`` and the block stack.

    Constructor arguments are the JAX model's (``haet.py:112-156``),
    ``dtype`` (None or ``torch.bfloat16``) the compute dtype.
    ``device=None`` means CUDA (raises without a card); parameters are
    initialised on the CPU from ``torch.Generator().manual_seed(seed)`` and
    then moved, so a seed gives the same weights on every device. A variant
    sets :attr:`attn_cls`, adds its keyword arguments of the attention
    (:meth:`_attn_kwargs`) and its position features
    (:meth:`_pos_features`, :meth:`_n_pos_features`).
    """

    attn_cls: type = PhysicsAttentionIrregularMesh
    #: the irregular model adds the placeholder whatever ``fx`` is
    always_placeholder = False

    def __init__(self, space_dim: int = 1, n_layers: int = 5,
                 n_hidden: int = 256, dropout: float = 0.0, n_head: int = 8,
                 Time_Input: bool = False, act: str = "gelu",
                 mlp_ratio: int = 1, fun_dim: int = 1, out_dim: int = 1,
                 slice_num: int = 32, ref: int = 8, unified_pos: bool = False,
                 c_hidden: Optional[Sequence[int]] = None,
                 ball_sizes: Optional[Sequence[int]] = None,
                 enc_num_heads: Optional[Sequence[int]] = None,
                 enc_depths: Optional[Sequence[int]] = None,
                 dec_num_heads: Optional[Sequence[int]] = None,
                 dec_depths: Optional[Sequence[int]] = None,
                 strides: Optional[Sequence[int]] = None, rotate: int = 45,
                 decode: bool = True, mp_steps: int = 0, embed: bool = False,
                 dim_head: Optional[int] = None,
                 erwin_mlp_ratio: Optional[int] = None,
                 use_checkpoint: bool = False, use_dist_bias: bool = True,
                 grouping: str = "median", orthogonal_slice_init: bool = True,
                 use_pallas=False, use_pallas_erwin: bool = False,
                 pallas_auto_threshold: int = PALLAS_AUTO_THRESHOLD,
                 shard_axes=None, dtype=None, *, device=None,
                 seed: int = 0):
        super().__init__()
        device = default_device(device)
        #: the bound :class:`~haet_torch.parallel.Mesh` (:meth:`bind_mesh`)
        self.mesh = None
        self.mesh_split_batch = True
        self.n_hidden = n_hidden
        self.out_dim = out_dim
        self.unified_pos = unified_pos
        self.ref = ref
        self.use_checkpoint = use_checkpoint
        in_dim = (self._n_pos_features() if unified_pos
                  else space_dim) + fun_dim
        self.dtype = dtype
        self.preprocess = MLP(in_dim, n_hidden * 2, n_hidden, n_layers=0,
                              res=False, act=act, dtype=dtype)
        self.placeholder = nn.Parameter(torch.empty(n_hidden))
        # made whenever Time_Input is set (the reference makes it at
        # construction), applied when T is given
        self.time_fc = (nn.Sequential(Linear(n_hidden, n_hidden, dtype=dtype),
                                      nn.SiLU(),
                                      Linear(n_hidden, n_hidden, dtype=dtype))
                        if Time_Input else None)
        attn_kwargs = dict(
            slice_num=slice_num, c_hidden=c_hidden, ball_sizes=ball_sizes,
            enc_num_heads=enc_num_heads, enc_depths=enc_depths,
            dec_num_heads=dec_num_heads, dec_depths=dec_depths,
            strides=strides, rotate=rotate, decode=decode, mp_steps=mp_steps,
            embed=embed, use_dist_bias=use_dist_bias, grouping=grouping,
            orthogonal_slice_init=orthogonal_slice_init,
            use_pallas=use_pallas, use_pallas_erwin=use_pallas_erwin,
            pallas_auto_threshold=pallas_auto_threshold,
            shard_axes=shard_axes, **self._attn_kwargs())
        if dim_head is not None:
            attn_kwargs["dim_head"] = dim_head
        if erwin_mlp_ratio is not None:
            attn_kwargs["mlp_ratio"] = erwin_mlp_ratio
        self.n_layers = n_layers
        self.n_head = n_head
        self.dropout = dropout
        self._block_kwargs = dict(
            num_heads=n_head, hidden_dim=n_hidden, dropout=dropout, act=act,
            mlp_ratio=mlp_ratio, out_dim=out_dim, attn_cls=self.attn_cls,
            attn_kwargs=attn_kwargs, dtype=dtype)
        self.blocks = nn.ModuleList([
            TransolverErwinBlock(last_layer=(i == n_layers - 1),
                                 **self.block_kwargs())
            for i in range(n_layers)])
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)
        #: the generator every dropout of the model draws from (None
        #: without dropout), on the model's device
        self.dropout_generator = None
        if dropout > 0:
            self.dropout_generator = torch.Generator(
                device=device).manual_seed(seed)
            for mod in self.modules():
                if isinstance(mod, Dropout):
                    mod.generator = self.dropout_generator

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference ``_init_weights`` (:func:`init_weights`), then the
        placeholder ``U[0,1)/n_hidden``."""
        init_weights(self, generator)
        self.placeholder.copy_(
            torch.rand(self.n_hidden, generator=generator) / self.n_hidden)

    def _attn_kwargs(self) -> dict:
        return {}

    def block_kwargs(self) -> dict:
        """The constructor arguments every :class:`TransolverErwinBlock` of
        the stack shares (``last_layer`` excepted), ``haet.py:174``:
        :mod:`haet_torch.parallel.pipeline` builds its stage block from
        them, with this model's parameter names."""
        kw = dict(self._block_kwargs)
        kw["attn_kwargs"] = dict(kw["attn_kwargs"])
        return kw

    def bind_mesh(self, mesh, split_batch: bool = True) -> None:
        """Run the forwards to come over ``mesh`` (None: on this rank
        alone), the counterpart of tracing under ``with mesh:``: each call
        takes the global batch, runs this rank's part and returns the
        global output. Every rank calls it with the same batch.
        ``split_batch`` False keeps the batch whole on every rank (an
        export's ``data_axis=None``: the parallelism is the heads')."""
        self.mesh = mesh
        self.mesh_split_batch = split_batch
        for block in self.blocks:
            block.Attn.bind_mesh(mesh)

    def _n_pos_features(self) -> int:
        raise NotImplementedError

    def _pos_features(self, x):
        raise NotImplementedError

    def apply_pre(self, x, fx=None, T=None):
        """The embedding before the block stack (``haet.py:271``): the
        ``unified_pos`` features, the preprocess MLP, the placeholder and
        the time embedding, ``[B, N, *] -> [B, N, n_hidden]``. The pipeline
        runs it apart from the blocks."""
        if T is not None and self.time_fc is None:
            raise ValueError(
                "T was passed but Time_Input=False: the reference model "
                "has no time_fc in this configuration (..._2D.py:257)")
        if self.unified_pos:
            x = self._pos_features(x)
        fx_was_none = fx is None
        fx = x if fx is None else torch.cat([x, fx], dim=-1)
        fx = self.preprocess(fx)
        if self.always_placeholder or fx_was_none:
            fx = fx + self.placeholder[None, None, :]
        if T is not None:
            emb = timestep_embedding(T, self.n_hidden)[:, None, :]
            fx = fx + self.time_fc(emb)
        return fx

    def apply_head(self, h):
        """The last block's output head on the block stack's output
        (``haet.py:308``), ``[B, N, n_hidden] -> [B, N, out_dim]``."""
        return self.blocks[-1].head(h)

    def forward(self, x, fx=None, T=None):
        layout = None
        if self.mesh is not None:
            layout = self.mesh.layout(x.shape[0], x.shape[1],
                                      self.mesh_split_batch)
            x, fx = layout.shard(x), layout.shard(fx)
            T = layout.shard(T, points=False)
        fx = self.apply_pre(x, fx, T)
        remat = self.use_checkpoint and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                fx = checkpoint(block, fx, layout, use_reentrant=False,
                                preserve_rng_state=False,
                                context_fn=functools.partial(
                                    checkpoint_contexts, block))
            else:
                fx = block(fx, layout)
        return fx if layout is None else layout.gather(fx)


class HAETransolverIrregularMesh(_HAETBase):
    """Irregular point-cloud HAET."""

    attn_cls = PhysicsAttentionIrregularMesh
    always_placeholder = True

    def _n_pos_features(self) -> int:
        return self.ref * self.ref

    def _pos_features(self, x):
        """Distances from each point's first two coordinates to a
        ``ref x ref`` unit grid (reference ``..._Irregular_Mesh.py:297-336``)."""
        g = np.linspace(0, 1, self.ref, dtype=np.float32)
        gx, gy = np.meshgrid(g, g, indexing="ij")
        grid_ref = torch.from_numpy(
            np.stack([gx.ravel(), gy.ravel()], axis=-1)).to(x.device, x.dtype)
        diff = x[:, :, None, :2] - grid_ref[None, None]
        return torch.sqrt((diff * diff).sum(-1))


class _StructuredBase(_HAETBase):
    """A model over a fixed grid :attr:`grid` (row-major points)."""

    grid: tuple = ()

    def __init__(self, *args, grid: tuple, **kwargs):
        # before the base's __init__, whose input width reads it
        self.grid = tuple(grid)
        super().__init__(*args, **kwargs)
        if self.unified_pos:
            self.register_buffer(
                "grid_distances",
                torch.from_numpy(_grid_distances_nd(self.grid, self.ref)).to(
                    self.placeholder.device),
                persistent=False)

    def _attn_kwargs(self) -> dict:
        return dict(zip(("H", "W", "D"), self.grid))

    def _n_pos_features(self) -> int:
        return self.ref ** len(self.grid)

    def _pos_features(self, x):
        """Distances from the unit grid to the ``ref^d`` reference grid
        (reference ``..._2D.py:318-372``, ``..._3D.py:334-411``), the same
        for every sample."""
        d = self.grid_distances
        return d[None].expand(x.shape[0], *d.shape).to(x.dtype)


class HAETransolverStructuredMesh2D(_StructuredBase):
    """2D structured-mesh HAET over an ``H x W`` grid."""

    attn_cls = PhysicsAttentionStructuredMesh2D

    def __init__(self, *args, H: int = 85, W: int = 85, **kwargs):
        super().__init__(*args, grid=(H, W), **kwargs)


class HAETransolverStructuredMesh3D(_StructuredBase):
    """3D structured-mesh HAET over an ``H x W x D`` volume."""

    attn_cls = PhysicsAttentionStructuredMesh3D

    def __init__(self, *args, H: int = 32, W: int = 32, D: int = 32,
                 **kwargs):
        super().__init__(*args, grid=(H, W, D), **kwargs)


def _grid_distances_nd(shape, ref: int) -> np.ndarray:
    """``[prod(shape), ref^d]`` float32 distances from a unit grid of
    ``shape`` to a ``ref^d`` reference grid (``haet.py:385-400``)."""
    axes = [np.linspace(0, 1, s, dtype=np.float32) for s in shape]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    r_axes = [np.linspace(0, 1, ref, dtype=np.float32)] * len(shape)
    grid_ref = np.stack(np.meshgrid(*r_axes, indexing="ij"), axis=-1)
    grid_flat = grid.reshape(-1, len(shape))
    ref_flat = grid_ref.reshape(-1, len(shape))
    return np.sqrt(
        ((grid_flat[:, None, :] - ref_flat[None, :, :]) ** 2).sum(-1)
    ).astype(np.float32)
