"""Positional and temporal embeddings, PyTorch.

Counterpart of ``haet_tpu/models/components/embedding.py`` (reference
``models/components/embedding.py``): :func:`timestep_embedding` feeds the
``Time_Input`` models; the rotary helpers and :class:`PositionalEncoding`
are the package's API surface, unused by the HAET models, as in JAX.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """Sinusoidal timestep embeddings (reference ``embedding.py:69-99``).

    Args:
        timesteps: ``[N]`` or ``[N, 1]`` (possibly fractional) times.
        dim: embedding dimension.

    Returns:
        ``[N, dim]`` float32: cos in the first half, sin in the second, and
        a zero column appended when ``dim`` is odd.
    """
    timesteps = torch.as_tensor(timesteps)
    if timesteps.ndim == 2:
        timesteps = timesteps[:, 0]
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps[:, None].float() * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat(
            [embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def rotary_frequencies(coordinates, dim: int, min_freq: float = 1 / 2,
                       scale: float = 1.0):
    """``RotaryEmbedding.forward`` (reference ``embedding.py:8-21``):
    ``[B, N]`` coordinates -> ``[B, N, dim]`` frequencies (the halves
    duplicated)."""
    inv_freq = 1.0 / (10000 ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=coordinates.device) / dim))
    t = coordinates * (scale / min_freq)
    freqs = torch.einsum("...i,j->...ij", t, inv_freq)
    return torch.cat([freqs, freqs], dim=-1)


def _rotate_half(x):
    x = x.reshape(*x.shape[:-1], 2, x.shape[-1] // 2)
    x1, x2 = x[..., 0, :], x[..., 1, :]
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(t, freqs):
    return (t * torch.cos(freqs)) + (_rotate_half(t) * torch.sin(freqs))


def apply_2d_rotary_pos_emb(t, freqs_x, freqs_y):
    """Rotary embedding of the first half of the features by ``freqs_x``
    and of the second by ``freqs_y`` (reference ``embedding.py:34-43``)."""
    d = t.shape[-1]
    t_x, t_y = t[..., : d // 2], t[..., d // 2:]
    return torch.cat([apply_rotary_pos_emb(t_x, freqs_x),
                      apply_rotary_pos_emb(t_y, freqs_y)], dim=-1)


class PositionalEncoding(nn.Module):
    """The classic sinusoidal table added to ``x [B, N, d_model]``
    (reference ``embedding.py:46-66``), then dropout in train mode."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 max_len: int = 421 * 421):
        super().__init__()
        self.d_model = d_model
        self.max_len = max_len
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        n = x.shape[1]
        position = torch.arange(min(n, self.max_len), dtype=torch.float32,
                                device=x.device)[:, None]
        div_term = torch.exp(
            torch.arange(0, self.d_model, 2, dtype=torch.float32,
                         device=x.device)
            * -(math.log(10000.0) / self.d_model))
        pe = torch.zeros(position.shape[0], self.d_model, device=x.device)
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        return self.dropout(x + pe[None])
