"""Data normalizers of the port (``haet_tpu/train/normalizer.py:9-94``).

The statistics are computed on the host with numpy, as in the reference
(torch's ``std`` is the unbiased estimator, ``ddof=1``). ``encode`` and
``decode`` take numpy arrays or tensors; a tensor gets the statistics on
its own device, in its own dtype or float32 if wider (a bf16 tensor meets
float32 statistics and promotes, as a bf16 JAX array meets the numpy
float32 ones). A bf16 tensor reaches the host as the exact float32
widening of its values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.env import host_numpy


def _like(stat, x):
    """``stat`` as ``x``'s kind: a tensor of ``x``'s dtype and device for a
    tensor, the numpy array otherwise."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(
            np.asarray(stat), dtype=torch.promote_types(x.dtype,
                                                        torch.float32),
            device=x.device)
    return stat


def _host(x):
    return host_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class IdentityTransformer:
    """Statistics kept, ``encode``/``decode`` the identity."""

    def __init__(self, x):
        x = _host(x)
        self.mean = x.mean(axis=0, keepdims=True)
        self.std = x.std(axis=0, keepdims=True, ddof=1) + 1e-8

    def encode(self, x):
        return x

    def decode(self, x):
        return x


class UnitTransformer:
    """Pointwise standardization over the (batch, points) axes."""

    def __init__(self, x):
        x = _host(x)
        self.mean = x.mean(axis=(0, 1), keepdims=True)
        self.std = x.std(axis=(0, 1), keepdims=True, ddof=1) + 1e-8

    def encode(self, x):
        return (x - _like(self.mean, x)) / _like(self.std, x)

    def decode(self, x):
        return x * _like(self.std, x) + _like(self.mean, x)


class UnitGaussianNormalizer:
    """Per-location standardization over the batch axis."""

    def __init__(self, x, eps: float = 1e-5):
        x = _host(x)
        self.mean = x.mean(axis=0)
        self.std = x.std(axis=0, ddof=1)
        self.eps = eps

    def encode(self, x):
        return (x - _like(self.mean, x)) / _like(self.std + self.eps, x)

    def decode(self, x, sample_idx=None):
        std = self.std + self.eps
        mean = self.mean
        if sample_idx is not None:
            std = std[sample_idx]
            mean = mean[sample_idx]
        return x * _like(std, x) + _like(mean, x)


class StreamingNormalizer:
    """Streaming per-feature mean/std over a sample iterator (Chan et al.'s
    parallel merge in float64), the ShapeNet-Car pipeline's normalization
    without the whole dataset in memory."""

    def __init__(self, n_features: int):
        self.n = 0
        self.mean = np.zeros(n_features, dtype=np.float64)
        self.m2 = np.zeros(n_features, dtype=np.float64)

    def update(self, x):
        """x: ``[num_points, n_features]``."""
        x = _host(x).astype(np.float64)
        cnt = x.shape[0]
        row_mean = x.mean(0)
        row_m2 = ((x - row_mean) ** 2).sum(0)
        delta = row_mean - self.mean
        tot = self.n + cnt
        self.mean += delta * cnt / tot
        self.m2 += row_m2 + delta ** 2 * self.n * cnt / tot
        self.n = tot

    @property
    def std(self):
        return np.sqrt(self.m2 / max(self.n - 1, 1)) + 1e-8

    def encode(self, x):
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return (x - _like(self.mean, x)) / _like(self.std, x)

    def decode(self, x):
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return x * _like(self.std, x) + _like(self.mean, x)
