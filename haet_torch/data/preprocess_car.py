"""Alternative ShapeNet-Car preprocessor of the port (grid SDF sampling),
a copy of ``haet_tpu/data/preprocess_car.py:16-85`` with the nearest
surface point from a scipy ``cKDTree`` (the JAX package asks
scikit-learn).

The reference ships an Open3D-based preprocessor
(``benchmarks/02-.../data/shapenet_car/preprocess.py:33-60``): quads ->
triangles, then a raycast SDF sampled on a regular grid. This is the
dependency-free equivalent: triangle soup + nearest-point distance with the
sign from the surface normal (valid for the closed, oriented car surfaces
this dataset contains).
"""

from __future__ import annotations

import numpy as np


def quads_to_tris(quads: np.ndarray) -> np.ndarray:
    """[nq, 4] -> [2*nq, 3] (split along the 0-2 diagonal)."""
    a, b, c, d = quads[:, 0], quads[:, 1], quads[:, 2], quads[:, 3]
    return np.concatenate(
        [np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0
    )


def sample_sdf_grid(points: np.ndarray, quads: np.ndarray,
                    resolution: int = 32, bounds=None):
    """Signed distance field on a regular grid.

    Args:
        points: ``[n, 3]`` surface points.
        quads: ``[nq, 4]`` connectivity (used for normals/orientation).
        resolution: grid side.
        bounds: optional ``(lo[3], hi[3])``; default = bbox + 10% margin.

    Returns:
        ``(grid_pts [r^3, 3], sdf [r^3])`` — negative inside.
    """
    from scipy.spatial import cKDTree

    from .shapenet_car import point_normals

    if bounds is None:
        lo = points.min(0)
        hi = points.max(0)
        pad = 0.1 * (hi - lo)
        lo, hi = lo - pad, hi + pad
    else:
        lo, hi = bounds

    axes = [np.linspace(lo[i], hi[i], resolution) for i in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1).astype(
        np.float32
    )

    normals = point_normals(points, quads)
    dist, idx = cKDTree(points).query(grid, k=1)
    nearest = points[idx]
    n_near = normals[idx]
    # sign: positive when the query sits on the outward-normal side
    sign = np.sign(np.sum((grid - nearest) * n_near, axis=-1))
    sign = np.where(sign == 0, 1.0, sign)
    return grid, (dist * sign).astype(np.float32)


def preprocess_sample(sample_dir: str, resolution: int = 32):
    """Load one car and produce the grid-SDF representation
    (the open3d path's output: reference preprocess.py:33-60)."""
    import os

    from .vtk_io import read_vtk_legacy

    press_grid = read_vtk_legacy(
        os.path.join(sample_dir, "quadpress_smpl.vtk")
    )
    pts = press_grid.points
    quads = press_grid.quads
    tris = quads_to_tris(quads)
    grid, sdf = sample_sdf_grid(pts, quads, resolution)
    return {
        "points": pts,
        "triangles": tris,
        "grid": grid,
        "sdf": sdf.reshape(resolution, resolution, resolution),
    }
