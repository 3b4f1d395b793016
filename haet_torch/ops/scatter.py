"""Segment reductions, the ``torch_scatter`` equivalents.

Counterpart of ``haet_tpu/ops/scatter.py`` (the reference's
``erwinflash/components/utils/scatter_ops.py:5-18``): ``data [N, ...]``
reduced into ``num_segments`` rows by ``segment_ids [N]``, each an
``index_add_`` or ``scatter_reduce_`` over the leading axis.
"""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data[i]`` into ``out[segment_ids[i]]``: ``[N, ...] -> [S,
    ...]``; empty segments give 0."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The mean of each segment (the reference's ``scatter_mean``); empty
    segments give 0. Sums and counts accumulate in float32 whatever
    ``data.dtype`` (in bf16 a count sticks at 256), and the mean is cast
    back."""
    s = segment_sum(data.float(), segment_ids, num_segments)
    cnt = segment_sum(torch.ones(data.shape[0], device=data.device),
                      segment_ids, num_segments)
    mean = s / cnt.clamp_min(1.0).reshape((-1,) + (1,) * (data.ndim - 1))
    return mean.to(data.dtype)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The max of each segment; an empty segment gives the dtype's lowest
    value, as ``jax.ops.segment_max`` does (``-inf`` for floats)."""
    lowest = (float("-inf") if data.dtype.is_floating_point
              else torch.iinfo(data.dtype).min)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), lowest)
    ids = segment_ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce_(0, ids, data, "amax", include_self=True)
