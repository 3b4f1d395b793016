"""ShapeNet-Car batches, loss and evaluation (``benchmarks/car_train.py``).

Ragged car meshes are padded to 2048-point buckets by repeating the last
point, with a validity mask, so that a point count repeats across samples
(``benchmarks/car_train.py:41-69``, padding by
:func:`haet_torch.data.shapenet_car.pad_sample`). :func:`evaluate` is the
driver's per-sample rel-L2 and drag metrics (``:72-126``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..data.shapenet_car import CarSample, pad_sample
from ..utils.env import host_numpy

BUCKET = 2048


def bucket_size(n: int) -> int:
    """``n`` rounded up to a multiple of :data:`BUCKET`."""
    return ((n + BUCKET - 1) // BUCKET) * BUCKET


def make_batch(sample: CarSample, n_pad=None) -> dict:
    """A batch of one sample padded to ``n_pad`` (default: its bucket):
    ``{"x" [1, n_pad, 7], "y" [1, n_pad, 4], "surf", "mask" [1, n_pad]}``,
    float32 numpy."""
    n_pad = bucket_size(len(sample.pos)) if n_pad is None else n_pad
    _, x, y, surf, mask = pad_sample(sample, n_pad)
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


def predict(model, batch: dict) -> np.ndarray:
    """The model's eval-mode output for a batch, on the host:
    ``[B, n_pad, 4]``; a bf16 model's as the exact float32 widening of its
    values (:func:`~haet_torch.utils.env.host_numpy`)."""
    x = torch.from_numpy(batch["x"]).to(next(model.parameters()).device)
    model.eval()
    with torch.inference_mode():
        return host_numpy(model(x, None))


def evaluate(model, samples, coef, logger=None) -> dict:
    """Per-sample rel-L2 of surface pressure and exterior velocity, the
    denormalised RMSEs, and over the fold the drag coefficient's relative
    error and Spearman rho (``main_evaluation.py:275-357``).
    ``time_per_sample`` is the wall from the batch to the output on the
    host, so it includes the device's work."""
    from ..data.car_metrics import drag_coefficient, spearman_rho

    rel_p, rel_v, times = [], [], []
    mses_p, mses_v = [], []
    cd_pred, cd_gt = [], []
    for s in samples:
        batch = make_batch(s)
        t0 = time.perf_counter()
        out = predict(model, batch)[0]
        times.append(time.perf_counter() - t0)
        out = out[:len(s.pos)]
        yd = coef.decode_y(s.y)
        od = coef.decode_y(out)
        surf = s.surf
        ext = ~surf
        rel_p.append(np.linalg.norm(od[surf, 3] - yd[surf, 3])
                     / (np.linalg.norm(yd[surf, 3]) + 1e-12))
        rel_v.append(np.linalg.norm(od[ext, :3] - yd[ext, :3])
                     / (np.linalg.norm(yd[ext, :3]) + 1e-12))
        # normalised-scale MSEs, denormalised to RMSEs at the end
        # (main_evaluation.py:314-315, 346-350)
        mses_p.append(np.mean((out[surf, 3] - s.y[surf, 3]) ** 2))
        mses_v.append(np.mean((out[ext, :3] - s.y[ext, :3]) ** 2, axis=0))
        if s.quads is not None and s.surf_slice is not None:
            pts = s.pos[s.surf_slice]
            cd_pred.append(drag_coefficient(
                pts, s.quads, od[s.surf_slice, 3], od[s.surf_slice, :3]))
            cd_gt.append(drag_coefficient(
                pts, s.quads, yd[s.surf_slice, 3], yd[s.surf_slice, :3]))
    std_out = np.asarray(coef.std_out).reshape(-1)
    rmse_velo_var = np.sqrt(np.mean(mses_v, axis=0)) * std_out[:3]
    metrics = {
        "rel_l2_press": float(np.mean(rel_p)),
        "rel_l2_velo": float(np.mean(rel_v)),
        "rmse_press": float(np.sqrt(np.mean(mses_p)) * std_out[3]),
        "rmse_velo": float(np.sqrt(np.mean(rmse_velo_var ** 2))),
        "time_per_sample": float(np.mean(times)),
    }
    if cd_gt:
        cd_pred, cd_gt = np.asarray(cd_pred), np.asarray(cd_gt)
        metrics["cd_rel_err"] = float(
            np.mean(np.abs(cd_pred - cd_gt) / (np.abs(cd_gt) + 1e-12)))
        metrics["rho_d"] = spearman_rho(cd_pred, cd_gt)
    if logger:
        logger.log({f"eval/{k}": v for k, v in metrics.items()})
    return metrics
