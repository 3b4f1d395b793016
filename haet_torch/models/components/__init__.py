"""Reusable model components of the PyTorch port."""

from .mlp import MLP, SwiGLU, get_activation, trunc_normal_  # noqa: F401
