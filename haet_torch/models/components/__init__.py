"""Reusable model components of the PyTorch port."""

from .mlp import (MLP, Linear, SwiGLU, get_activation,  # noqa: F401
                  trunc_normal_)
