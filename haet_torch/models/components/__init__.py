"""Reusable model components of the PyTorch port."""

from .dropout import Dropout  # noqa: F401
from .embedding import (  # noqa: F401
    PositionalEncoding,
    apply_2d_rotary_pos_emb,
    apply_rotary_pos_emb,
    rotary_frequencies,
    timestep_embedding,
)
from .mlp import (MLP, Linear, SwiGLU, get_activation,  # noqa: F401
                  trunc_normal_)
