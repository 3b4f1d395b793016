"""Losses of the port, on tensors (``haet_tpu/train/losses.py:21-91``).

* :class:`RelLpLoss` -- the reference's ``TestLoss``: per-sample relative
  Lp norm over the flattened non-batch axes;
* :func:`central_diff` -- the Darcy gradient regularizer's PBC-padded
  central differences;
* :func:`zero_boundary` -- a square-grid field with its outer ring zeroed;
* :func:`mse_press_velo` -- the ShapeNet-Car loss ``MSE(velocity) + reg *
  MSE(surface pressure)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class RelLpLoss:
    d: int = 2
    p: int = 2
    size_average: bool = True
    reduction: bool = True

    def _norm(self, x, dim):
        return (x.abs() ** self.p).sum(dim=dim) ** (1.0 / self.p)

    def abs(self, x, y):
        n = x.shape[0]
        h = 1.0 / (x.shape[1] - 1.0)
        all_norms = (h ** (self.d / self.p)) * self._norm(
            x.reshape(n, -1) - y.reshape(n, -1), dim=1)
        return self._reduce(all_norms)

    def rel(self, x, y):
        n = x.shape[0]
        diff = self._norm(x.reshape(n, -1) - y.reshape(n, -1), dim=1)
        ynorm = self._norm(y.reshape(n, -1), dim=1)
        return self._reduce(diff / ynorm)

    def _reduce(self, v):
        if not self.reduction:
            return v
        return v.mean() if self.size_average else v.sum()

    def __call__(self, x, y):
        return self.rel(x, y)


def central_diff(x, h: float, resolution: int):
    """PBC-padded central differences on a square grid.

    Args:
        x: ``[B, H*W, C]``.
    Returns:
        ``(grad_x, grad_y)`` each ``[B, H, W, C]``.
    """
    b, _, c = x.shape
    x = x.reshape(b, resolution, resolution, c)
    x = F.pad(x, (0, 0, 1, 1, 1, 1))
    grad_x = (x[:, 1:-1, 2:, :] - x[:, 1:-1, :-2, :]) / (2 * h)
    grad_y = (x[:, 2:, 1:-1, :] - x[:, :-2, 1:-1, :]) / (2 * h)
    return grad_x, grad_y


def zero_boundary(x, resolution: int):
    """Zero out the outer ring of a square-grid field ``[B, H*W, C]``."""
    b, n, c = x.shape
    mask = torch.zeros(resolution, resolution, dtype=x.dtype,
                       device=x.device)
    mask[1:-1, 1:-1] = 1.0
    xg = x.reshape(b, resolution, resolution, c)
    return (xg * mask[None, :, :, None]).reshape(b, n, c)


def mse_press_velo(pred, target, surf_mask, reg: float = 0.5):
    """ShapeNet-Car loss: velocity MSE + ``reg`` x surface-pressure MSE.

    Args:
        pred/target: ``[N, 4]`` (3 velocity + 1 pressure).
        surf_mask: ``[N]`` bool, True on surface points.
    Returns:
        ``(loss, (loss_velo, loss_press))``.
    """
    loss_velo = ((pred[..., :3] - target[..., :3]) ** 2).mean()
    press_err = (pred[..., 3] - target[..., 3]) ** 2
    w = surf_mask.to(pred.dtype)
    loss_press = (press_err * w).sum() / w.sum().clamp_min(1.0)
    return loss_velo + reg * loss_press, (loss_velo, loss_press)
