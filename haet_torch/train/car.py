"""ShapeNet-Car training batches and loss (``benchmarks/car_train.py``).

Ragged car meshes are padded to 2048-point buckets by repeating the last
point, with a validity mask, so that a point count repeats across samples;
copies of ``benchmarks/car_train.py:41-69`` and
``haet_tpu/data/shapenet_car.py:270-288`` on numpy arrays. The port's car
data layer is queued (``ROADMAP.md``, queue 1: Trainer and drivers).
"""

from __future__ import annotations

import numpy as np

BUCKET = 2048


def bucket_size(n: int) -> int:
    """``n`` rounded up to a multiple of :data:`BUCKET`."""
    return ((n + BUCKET - 1) // BUCKET) * BUCKET


def pad_sample(pos, x, y, surf, n_pad: int):
    """Pad a sample's arrays to ``n_pad`` points by repeating the last one.

    Returns ``(pos, x, y, surf & mask, mask)``. Raises if the sample is
    larger than ``n_pad``: truncating would drop its tail, which holds the
    surface points.
    """
    n = len(pos)
    if n > n_pad:
        raise ValueError(
            f"pad_sample: sample has {n} points > n_pad={n_pad}; "
            "truncating would drop the surface points (round n_pad up)")
    if n == n_pad:
        return pos, x, y, surf, np.ones(n_pad, bool)
    idx = np.concatenate([np.arange(n), np.full(n_pad - n, n - 1)])
    mask = np.concatenate([np.ones(n, bool), np.zeros(n_pad - n, bool)])
    return pos[idx], x[idx], y[idx], surf[idx] & mask, mask


def make_batch(pos, x, y, surf, n_pad=None) -> dict:
    """A batch of one sample padded to ``n_pad`` (default: its bucket):
    ``{"x" [1, n_pad, 7], "y" [1, n_pad, 4], "surf", "mask" [1, n_pad]}``,
    float32 numpy."""
    n_pad = bucket_size(len(pos)) if n_pad is None else n_pad
    _, x, y, surf, mask = pad_sample(pos, x, y, surf, n_pad)
    return {"x": x[None].astype(np.float32), "y": y[None].astype(np.float32),
            "surf": surf[None].astype(np.float32),
            "mask": mask[None].astype(np.float32)}


def loss_fn_builder(reg: float):
    """Masked velocity MSE plus ``reg`` times the surface-pressure MSE
    (``benchmarks/car_train.py:57-69``)."""
    def loss_fn(out, batch):
        mask = batch["mask"][..., None]
        surf = batch["surf"]
        y = batch["y"]
        v_err = ((out[..., :3] - y[..., :3]) ** 2) * mask
        loss_velo = v_err.sum() / (mask * 3).sum().clamp_min(1.0)
        p_err = ((out[..., 3] - y[..., 3]) ** 2) * surf
        loss_press = p_err.sum() / surf.sum().clamp_min(1.0)
        return loss_velo + reg * loss_press, {
            "loss_velo": loss_velo, "loss_press": loss_press}
    return loss_fn

