"""MLP building blocks: the shared MLP and Erwin's SwiGLU.

Counterparts of ``haet_tpu/models/components/mlp.py`` (reference
``models/components/mlp.py:23-96`` and erwinflash ``mlp.py:8-18``), with the
reference's torch module names, so the state_dict keys are the reference
schema: ``linear_pre.0`` (Linear inside a Sequential with the activation),
``linear_{i}``, ``linear_post``; SwiGLU ``w1``/``w2``/``w3``.

``dtype`` is the compute dtype of flax's ``nn.Dense(dtype=...)``
(:mod:`haet_torch.ops.dense`): None for the float32 model, or
``torch.bfloat16``, where each Linear and activation computes in bf16 over
float32 parameters.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.dense import linear
from ...ops.kernels.erwin_block import swiglu

# Activation registry (reference models/components/mlp.py:11-20), plain
# callables; gelu is the exact (erf) form, torch's nn.GELU default.
ACTIVATION: dict[str, Callable] = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.1),
    "softplus": F.softplus,
    "ELU": F.elu,
    "silu": F.silu,
}


def get_activation(act: str) -> Callable:
    if act not in ACTIVATION:
        raise NotImplementedError(f"activation {act!r} not supported")
    return ACTIVATION[act]


class Activation(nn.Module):
    """A registry activation as a module (sits in ``linear_pre``'s
    Sequential, as in the reference)."""

    def __init__(self, act: str):
        super().__init__()
        self.act = act
        self.fn = get_activation(act)

    def forward(self, x):
        return self.fn(x)


def trunc_normal_(w: torch.Tensor, generator: Optional[torch.Generator],
                  std: float = 0.02) -> torch.Tensor:
    """timm-style truncated normal: std 0.02 with ABSOLUTE bounds ±2
    (±100 sigma, so effectively untruncated), as ``haet_tpu``'s
    ``trunc_normal_init`` (``mlp.py:43-52``)."""
    return nn.init.trunc_normal_(w, std=std, a=-2.0, b=2.0,
                                 generator=generator)


def init_linear(layer: nn.Linear, generator: Optional[torch.Generator]):
    """The reference ``_init_weights`` for a Linear: trunc-normal weight,
    zero bias."""
    trunc_normal_(layer.weight, generator)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class Linear(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``
    (flax's ``nn.Dense(dtype=...)``; None: float32). Its state-dict keys
    are ``nn.Linear``'s."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        return linear(x, self.weight, self.bias, self.compute_dtype)


class MLP(nn.Module):
    """Pre-Linear + act, ``n_layers`` hidden layers (optional residual),
    post-Linear, each Linear in ``dtype``."""

    def __init__(self, n_input: int, n_hidden: int, n_output: int,
                 n_layers: int = 1, act: str = "gelu", res: bool = True,
                 dtype=None):
        super().__init__()
        self.n_layers = n_layers
        self.res = res
        self.act = get_activation(act)
        self.linear_pre = nn.Sequential(Linear(n_input, n_hidden,
                                               dtype=dtype),
                                        Activation(act))
        for i in range(n_layers):
            setattr(self, f"linear_{i}", Linear(n_hidden, n_hidden,
                                                dtype=dtype))
        self.linear_post = Linear(n_hidden, n_output, dtype=dtype)

    def forward(self, x):
        x = self.linear_pre(x)
        for i in range(self.n_layers):
            h = self.act(getattr(self, f"linear_{i}")(x))
            x = h + x if self.res else h
        return self.linear_post(x)


class SwiGLU(nn.Module):
    """``w3(w2(x) * silu(w1(x)))`` in ``dtype``."""

    def __init__(self, dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.w1 = nn.Linear(dim, hidden_dim)
        self.w2 = nn.Linear(dim, hidden_dim)
        self.w3 = nn.Linear(hidden_dim, dim)

    def forward(self, x):
        return swiglu(x, self.w1.weight, self.w1.bias, self.w2.weight,
                      self.w2.bias, self.w3.weight, self.w3.bias,
                      dtype=self.dtype)
