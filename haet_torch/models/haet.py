"""HAET model, PyTorch: the irregular point-cloud variant.

Counterpart of ``haet_tpu/models/haet.py`` (reference
``HAETransolver_Irregular_Mesh.py:137``): a stack of pre-LN residual blocks
``fx = Attn(LN(fx)) + fx; fx = MLP(LN(fx)) + fx`` with ``LN + Linear(out_dim)``
on the last block, over the physics-attention tokenizer.

Call: ``model(x [B, N, space_dim], fx [B, N, fun_dim] or None)`` ->
``[B, N, out_dim]``. The 2D/3D variants, ``Time_Input`` and
``use_checkpoint`` are queued in ``ROADMAP.md`` and raise here.

``dtype`` (None or ``torch.bfloat16``) is the JAX model's compute dtype
(``ModelConfig.bf16``): every Linear computes in it over float32
parameters, the LayerNorms normalise in float32 and return it. The float32
placeholder promotes the residual stream to float32, as in JAX, and the
output is in the compute dtype.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.dense import normalized
from ..utils.env import default_device
from .components.mlp import MLP, Linear, init_linear
from .erwin import BallMSA
from .physics_attention import PhysicsAttentionIrregularMesh

TIME_INPUT_TODO = ("Time_Input is not ported yet (ROADMAP.md, queue 1: "
                   "2D/3D variants, unified_pos and Time_Input)")
CHECKPOINT_TODO = ("use_checkpoint is not ported yet (ROADMAP.md, queue 1: "
                   "use_checkpoint and dropout parity)")


@torch.no_grad()
def init_weights(root: nn.Module, generator: torch.Generator) -> None:
    """The reference ``_init_weights`` over every submodule of ``root``:
    trunc-normal(0.02) Linears with zero biases, unit/zero norms,
    ``sigma_att ~ -1 + 0.01 N(0,1)`` and an orthogonal slice head."""
    for mod in root.modules():
        if isinstance(mod, nn.Linear):
            init_linear(mod, generator)
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
        if (isinstance(mod, PhysicsAttentionIrregularMesh)
                and mod.orthogonal_slice_init):
            nn.init.orthogonal_(mod.in_project_slice.weight,
                                generator=generator)


class TransolverErwinBlock(nn.Module):
    """Pre-LN residual block (LayerNorm eps 1e-5; ``ln_3``/``mlp2`` on the
    last layer)."""

    def __init__(self, num_heads: int, hidden_dim: int, dropout: float,
                 act: str = "gelu", mlp_ratio: int = 4,
                 last_layer: bool = False, out_dim: int = 1,
                 attn_kwargs: Optional[dict] = None, dtype=None):
        super().__init__()
        akw = dict(attn_kwargs or {})
        akw.setdefault("dim_head", hidden_dim // num_heads)
        akw.setdefault("mlp_ratio", mlp_ratio)
        self.last_layer = last_layer
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.Attn = PhysicsAttentionIrregularMesh(
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

    def forward(self, fx):
        fx = self.Attn(self._ln(self.ln_1, fx)) + fx
        fx = self.mlp(self._ln(self.ln_2, fx)) + fx
        if self.last_layer:
            return self.mlp2(self._ln(self.ln_3, fx))
        return fx


class HAETransolverIrregularMesh(nn.Module):
    """Irregular point-cloud HAET.

    Constructor arguments are the JAX model's (``haet.py:112-156``),
    ``dtype`` (None or ``torch.bfloat16``) the compute dtype.
    ``device=None`` means CUDA (raises without a card); parameters are
    initialised on the CPU from ``torch.Generator().manual_seed(seed)`` and
    then moved, so a seed gives the same weights on every device.
    """

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
                 dtype=None, *, device=None, seed: int = 0):
        super().__init__()
        if Time_Input:
            raise NotImplementedError(TIME_INPUT_TODO)
        if use_checkpoint:
            raise NotImplementedError(CHECKPOINT_TODO)
        device = default_device(device)
        self.n_hidden = n_hidden
        self.unified_pos = unified_pos
        self.ref = ref
        in_dim = (ref * ref if unified_pos else space_dim) + fun_dim
        self.dtype = dtype
        self.preprocess = MLP(in_dim, n_hidden * 2, n_hidden, n_layers=0,
                              res=False, act=act, dtype=dtype)
        self.placeholder = nn.Parameter(torch.empty(n_hidden))
        attn_kwargs = dict(
            slice_num=slice_num, c_hidden=c_hidden, ball_sizes=ball_sizes,
            enc_num_heads=enc_num_heads, enc_depths=enc_depths,
            dec_num_heads=dec_num_heads, dec_depths=dec_depths,
            strides=strides, rotate=rotate, decode=decode, mp_steps=mp_steps,
            embed=embed, use_dist_bias=use_dist_bias, grouping=grouping,
            orthogonal_slice_init=orthogonal_slice_init,
            use_pallas=use_pallas, use_pallas_erwin=use_pallas_erwin)
        if dim_head is not None:
            attn_kwargs["dim_head"] = dim_head
        if erwin_mlp_ratio is not None:
            attn_kwargs["mlp_ratio"] = erwin_mlp_ratio
        self.blocks = nn.ModuleList([
            TransolverErwinBlock(n_head, n_hidden, dropout, act=act,
                                 mlp_ratio=mlp_ratio,
                                 last_layer=(i == n_layers - 1),
                                 out_dim=out_dim, attn_kwargs=attn_kwargs,
                                 dtype=dtype)
            for i in range(n_layers)])
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The reference ``_init_weights`` (:func:`init_weights`), then the
        placeholder ``U[0,1)/n_hidden``."""
        init_weights(self, generator)
        self.placeholder.copy_(
            torch.rand(self.n_hidden, generator=generator) / self.n_hidden)

    def _pos_features(self, x):
        """Distances from each point's first two coordinates to a
        ``ref x ref`` unit grid (reference ``..._Irregular_Mesh.py:297-336``)."""
        g = np.linspace(0, 1, self.ref, dtype=np.float32)
        gx, gy = np.meshgrid(g, g, indexing="ij")
        grid_ref = torch.from_numpy(
            np.stack([gx.ravel(), gy.ravel()], axis=-1)).to(x.device, x.dtype)
        diff = x[:, :, None, :2] - grid_ref[None, None]
        return torch.sqrt((diff * diff).sum(-1))

    def forward(self, x, fx=None, T=None):
        if T is not None:
            raise ValueError("T was passed but Time_Input=False")
        if self.unified_pos:
            x = self._pos_features(x)
        fx = x if fx is None else torch.cat([x, fx], dim=-1)
        # the irregular model always adds the placeholder
        # (reference HAETransolver_Irregular_Mesh.py:364)
        fx = self.preprocess(fx) + self.placeholder[None, None, :]
        for block in self.blocks:
            fx = block(fx)
        return fx
