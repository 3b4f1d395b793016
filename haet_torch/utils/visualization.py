"""Visualization utilities: slice-weight heatmaps and field renders.

Counterpart of ``haet_tpu/utils/visualization.py``, mirroring the
reference's artifacts:

* slice-weight visualization over car meshes / point clouds
  (reference ``benchmarks/02-.../utils/visualization.py:20-60``, fed by
  ``get_last_block_slice_weights``, ``Transolver.py:319-321``): the
  weights are captured by :func:`get_slice_weights`;
* prediction / ground-truth / error image triptychs for grid benchmarks
  (reference ``exp_darcy.py:166-200``).

:func:`get_slice_weights` runs the model wherever it lies; the plotting
functions are host-side and import matplotlib when called, so that the
module imports where matplotlib is absent (the card's machine).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.physics_attention import _PhysicsAttentionBase
from .env import host_numpy


def get_slice_weights(model, *args, block: int = -1, **kwargs):
    """Run an eval-mode forward of ``model(*args, **kwargs)`` capturing
    every block's rep-slice weights; returns the ``[B, heads, N, G]``
    weights of ``block`` (default: the last) as a numpy array, the analogue
    of the reference's ``get_last_block_slice_weights``.

    The capture is a switch on each physics-attention module
    (``capture_slice_weights``), on only for this forward, so other
    forwards and exported programs do no extra work. On the plain path a
    module keeps the weights it computed; on the kernel path, which never
    writes them, it recomputes them by the plain formula (JAX's capture
    does the same, ``physics_attention.py:316-340``). Blocks are in the
    model's order. bf16 weights come back as their exact float32 widening.
    """
    attns = [m for m in model.modules()
             if isinstance(m, _PhysicsAttentionBase)]
    if not attns:
        raise ValueError("no physics-attention module to capture from")
    training = model.training
    model.eval()
    try:
        for a in attns:
            a.capture_slice_weights = True
        with torch.no_grad():
            model(*args, **kwargs)
        found = [a.slice_weights for a in attns]
    finally:
        for a in attns:
            a.capture_slice_weights = False
            a.slice_weights = None
        model.train(training)
    if any(w is None for w in found):
        raise ValueError("no slice_weights captured")
    return host_numpy(found[block])


def plot_field_grid(field, h, w, path, title=None, cmap="coolwarm",
                    clim=None):
    """Save one grid field image (reference exp_darcy.py:166-200)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    plt.axis("off")
    plt.imshow(np.asarray(field).reshape(h, w), cmap=cmap)
    plt.colorbar()
    if clim:
        plt.clim(*clim)
    if title:
        plt.title(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def plot_prediction_triptych(pred, gt, h, w, out_dir, case_id,
                             err_clim=(-0.0005, 0.0005)):
    """pred / gt / error renders for one grid sample."""
    plot_field_grid(pred, h, w,
                    os.path.join(out_dir, f"case_{case_id}_pred.png"))
    plot_field_grid(gt, h, w, os.path.join(out_dir, f"case_{case_id}_gt.png"))
    plot_field_grid(np.asarray(gt) - np.asarray(pred), h, w,
                    os.path.join(out_dir, f"case_{case_id}_error.png"),
                    clim=err_clim)


def _set_axes_equal(ax):
    """Equal scaling on all 3D axes (reference visualization.py:64-86)."""
    limits = [ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()]
    ranges = [abs(hi - lo) for lo, hi in limits]
    centers = [(hi + lo) / 2 for lo, hi in limits]
    r = max(ranges) / 2
    ax.set_xlim3d([centers[0] - r, centers[0] + r])
    ax.set_ylim3d([centers[1] - r, centers[1] + r])
    ax.set_zlim3d([centers[2] - r, centers[2] + r])


def visualize_car_and_slices(sample, slice_weights, out_dir,
                             sample_idx: int = 0, top_k: int = 5,
                             max_slice_figs: int | None = None,
                             dpi: int = 120):
    """The reference's full car slice-render artifact set
    (``visualization.py:20-260``): on the car's *surface* points,

    1. ``car_slices_{i}.png`` — full mesh (top) + top-k slice weight
       overlays (bottom);
    2. ``slice_{g}_sample_{i}.png`` — per-slice dominance masks (1 where
       that slice has the max weight at the point);
    3. ``slice_heatmap_{i}.png`` — total weight across all slices;
    4. ``projection_{xy,xz,yz}_{i}.png`` — 2D plane projections colored by
       total weight.

    Args:
        sample: a :class:`haet_torch.data.shapenet_car.CarSample` (uses
            ``pos``/``surf``).
        slice_weights: ``[B, heads, N, G]`` from :func:`get_slice_weights`
            (N may exceed len(sample.pos) due to padding — extra rows are
            ignored).
        top_k: how many top slices in the overlay figure.
        max_slice_figs: cap on per-slice dominance figures (None = all G,
            like the reference).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    os.makedirs(out_dir, exist_ok=True)
    w = np.asarray(slice_weights)
    if w.ndim == 4:
        w = w[0].sum(axis=0)  # heads summed -> [N, G] (reference :109)
    n = len(sample.pos)
    w = w[:n]
    surf = np.asarray(sample.surf, bool)
    pos = np.asarray(sample.pos)[surf]
    pos = pos[:, [0, 2, 1]]  # swap Y/Z for the standard view (:60)
    sw = w[surf] * 1000.0    # reference's visibility scaling (:104)

    def new3d(fig, sub):
        ax = fig.add_subplot(sub, projection="3d")
        ax.view_init(elev=20, azim=300)
        ax.grid(False)
        return ax

    # 1. full mesh + top-k overlay
    importance = sw.sum(axis=0)
    top = np.argsort(importance)[::-1][:top_k]
    fig = plt.figure(figsize=(12, 10))
    ax1 = new3d(fig, 211)
    ax1.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=5, c="gray", alpha=0.8)
    ax1.set_title(f"Full Car Mesh - Sample {sample_idx}")
    _set_axes_equal(ax1)
    ax2 = new3d(fig, 212)
    cmaps = [cm.viridis, cm.plasma, cm.inferno, cm.magma, cm.cividis]
    for i, g in enumerate(top):
        sc = ax2.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=10,
                         c=sw[:, g], cmap=cmaps[i % len(cmaps)],
                         alpha=0.7, label=f"Slice {g}")
        fig.colorbar(sc, ax=ax2, shrink=0.7, pad=0.1)
    ax2.set_title("Top Slice Weights")
    _set_axes_equal(ax2)
    ax2.legend()
    fig.savefig(os.path.join(out_dir, f"car_slices_{sample_idx}.png"),
                dpi=dpi, bbox_inches="tight")
    plt.close(fig)

    # 2. per-slice dominance masks
    G = sw.shape[1]
    max_per_point = sw.max(axis=1)
    n_figs = G if max_slice_figs is None else min(G, max_slice_figs)
    for g in range(n_figs):
        mask = (sw[:, g] >= max_per_point).astype(float)
        fig = plt.figure(figsize=(10, 8))
        ax = new3d(fig, 111)
        sc = ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], s=10, c=mask,
                        cmap=cm.viridis, alpha=0.7)
        fig.colorbar(sc, ax=ax, shrink=0.7)
        ax.set_title(f"Slice {g} Weights - Sample {sample_idx}")
        _set_axes_equal(ax)
        fig.savefig(
            os.path.join(out_dir, f"slice_{g}_sample_{sample_idx}.png"),
            dpi=dpi, bbox_inches="tight")
        plt.close(fig)

    # 3. total-weight heatmap
    total = sw.sum(axis=1)
    fig = plt.figure(figsize=(10, 8))
    ax = new3d(fig, 111)
    sc = ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=total,
                    cmap=cm.viridis, s=5, alpha=0.7)
    fig.colorbar(sc, ax=ax, shrink=0.7)
    ax.set_title(f"Combined Slice Weights - Sample {sample_idx}")
    _set_axes_equal(ax)
    fig.savefig(os.path.join(out_dir, f"slice_heatmap_{sample_idx}.png"),
                dpi=dpi, bbox_inches="tight")
    plt.close(fig)

    # 4. 2D projections
    for name, (a, b) in (("xy", (0, 1)), ("xz", (0, 2)), ("yz", (1, 2))):
        fig, ax = plt.subplots(figsize=(8, 6))
        sc = ax.scatter(pos[:, a], pos[:, b], c=total, cmap=cm.viridis,
                        s=4, alpha=0.8)
        fig.colorbar(sc, ax=ax)
        ax.set_title(f"{name.upper()} projection - Sample {sample_idx}")
        ax.set_aspect("equal")
        fig.savefig(
            os.path.join(out_dir, f"projection_{name}_{sample_idx}.png"),
            dpi=dpi, bbox_inches="tight")
        plt.close(fig)


def plot_slice_weights_cloud(pos, slice_weights, out_dir, head: int = 0,
                             top_k: int = 6, batch: int = 0):
    """Scatter the top-k slices' weight heatmaps over a point cloud
    (reference visualization.py:20-60).

    Args:
        pos: ``[N, 3]`` or ``[N, 2]`` point positions.
        slice_weights: ``[B, heads, N, G]``.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    w = np.asarray(slice_weights)[batch, head]       # [N, G]
    pos = np.asarray(pos)
    mass = w.sum(axis=0)
    top = np.argsort(-mass)[:top_k]
    os.makedirs(out_dir, exist_ok=True)
    for rank, g in enumerate(top):
        fig = plt.figure(figsize=(6, 5))
        if pos.shape[1] >= 3:
            ax = fig.add_subplot(111, projection="3d")
            sc = ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=w[:, g],
                            s=1, cmap="viridis")
        else:
            ax = fig.add_subplot(111)
            sc = ax.scatter(pos[:, 0], pos[:, 1], c=w[:, g], s=1,
                            cmap="viridis")
        fig.colorbar(sc)
        ax.set_title(f"slice {g} (head {head})")
        fig.savefig(os.path.join(out_dir, f"slice_{rank}_g{g}.png"),
                    bbox_inches="tight", dpi=120)
        plt.close(fig)
