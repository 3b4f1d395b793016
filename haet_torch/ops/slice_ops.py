"""Transolver++ rep-slice tokenizer ops, plain PyTorch.

Counterpart of ``haet_tpu/ops/slice_ops.py:32-110``, with the same numerics
(reference ``models/PhysicsAttention/StructuredMesh2D.py:180-262``):

1. Ada-Temp:   ``tau = tau0 + clamp(Linear(x), -0.4, 0.4)``
2. Rep-Slice:  ``w = softmax((Linear(x) - log(-log(eps))) / tau)`` with the
   softmax over the **points** axis (dim 2)
3. Eidetic:    ``s = einsum('bhnc,bhng->bhgc', x, w) / (sum_n w + 1e-5)``
4. Deslice:    ``x' = einsum('bhgc,bhng->bhnc', s, w)``

All functions take the multi-head layout ``x: [B, H, N, C]``,
``w: [B, H, N, G]``. These are the plain versions behind the slice kernels
(:mod:`haet_torch.ops.kernels.slice_kernels`), which never materialise
``w``. ``group`` is the process group of a point axis over which N is split
(:mod:`haet_torch.parallel`): the reductions over N are then taken over
its ranks (the softmax's max and sum, the states' sums); None is the
single-device formula.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import all_reduce_max, all_reduce_sum

#: the reference's slice-norm regulariser (StructuredMesh2D.py:211-213)
SLICE_NORM_EPS = 1e-5


def ada_temp(temp_raw: torch.Tensor, base_temp: float = 0.5,
             clamp: float = 0.4) -> torch.Tensor:
    """Adaptive temperature ``tau = tau0 + clamp(raw, +-clamp)``;
    ``temp_raw`` is the ``[..., 1]`` output of the Ada-Temp head."""
    return base_temp + temp_raw.clamp(-clamp, clamp)


def rep_slice_weights(slice_logits: torch.Tensor, temperature: torch.Tensor,
                      epsilon: float = 1e-6, group=None) -> torch.Tensor:
    """Rep-Slice softmax over the points axis.

    ``slice_logits: [B, H, N, G]``, ``temperature: [B, H, N, 1]``. Logits are
    shifted by ``-log(-log(eps))`` before the temperature divide; the softmax
    runs over axis 2 (N), max-stabilised (over ``group``'s points too: the
    max, a shift the softmax does not see, without gradient).
    """
    shift = math.log(-math.log(epsilon))
    logits = (slice_logits - shift) / temperature
    m = logits.amax(dim=2, keepdim=True)
    if group is not None:
        m = all_reduce_max(m, group)
    e = torch.exp(logits - m)
    s = e.sum(dim=2, keepdim=True)
    return e / (s if group is None else all_reduce_sum(s, group))


def eidetic_states(x_proj: torch.Tensor, slice_weights: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Weighted centre-of-mass slice states ``[B, H, G, C]``, accumulated in
    float32 and returned in ``x_proj``'s dtype."""
    w = slice_weights.float()
    states = torch.einsum("bhnc,bhng->bhgc", x_proj.float(), w)
    norm = w.sum(dim=2)  # [B, H, G]
    if group is not None:
        states = all_reduce_sum(states, group)
        norm = all_reduce_sum(norm, group)
    return (states / (norm + SLICE_NORM_EPS)[..., None]).to(x_proj.dtype)


def deslice(states: torch.Tensor, slice_weights: torch.Tensor) -> torch.Tensor:
    """Project slice states ``[B, H, G, C]`` back onto the points with the
    same weights: ``[B, H, N, C]``."""
    return torch.einsum("bhgc,bhng->bhnc", states.float(),
                        slice_weights.float()).to(states.dtype)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, N, C] -> [B, N, H*C]``."""
    b, h, n, c = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * c)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, N, H*C] -> [B, H, N, C]`` (a view; call ``.contiguous()``
    before handing it to a kernel)."""
    b, n, hc = x.shape
    return x.reshape(b, n, heads, hc // heads).permute(0, 2, 1, 3)
