"""Synthetic ShapeNet-Car stand-in of the port
(``haet_tpu/data/synthetic.py:127-206``): an ellipsoid quad surface and
car-like samples over it, bit for bit the JAX package's at the same seed.
The loaders fall back to it when no dataset directory is present. The PDE
generators come with the PDE presets (``ROADMAP.md``, queue 1: 2D/3D
variants, unified_pos and Time_Input).
"""

from __future__ import annotations

import numpy as np


def quad_sphere(nu: int = 24, nv: int = 12, radius: float = 0.5,
                scale=(1.0, 0.6, 1.8)):
    """Ellipsoid ("car body") surface as a quad mesh: (points, quads)."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0.12 * np.pi, 0.88 * np.pi, nv)
    uu, vv = np.meshgrid(us, vs, indexing="ij")
    pts = np.stack([
        scale[0] * radius * np.sin(vv) * np.cos(uu),
        scale[1] * radius * np.sin(vv) * np.sin(uu),
        scale[2] * radius * np.cos(vv),
    ], -1).reshape(-1, 3).astype(np.float32)
    quads = []
    for i in range(nu):
        for j in range(nv - 1):
            a = i * nv + j
            b = ((i + 1) % nu) * nv + j
            quads.append([a, b, b + 1, a + 1])
    return pts, np.asarray(quads, dtype=np.int64)


def car_like(n: int = 4, npts: int = 4096, seed: int = 0):
    """ShapeNet-Car-like sample dicts with a real quad surface, so the full
    drag-coefficient pipeline runs on synthetic data.

    Layout follows the reference (``dataset.py:216-225``): exterior points
    first, then surface points; x=[pos(3), sdf(1), normal(3)],
    y=[velo(3), press(1)]. Pressure/velocity are smooth functions of
    geometry (stagnation-like pressure at the nose, shadowed wake), so both
    the field regression and the Cd ranking are learnable.
    """
    rng = np.random.RandomState(seed)
    samples = []
    for i in range(n):
        scale = (1.0 + 0.2 * rng.rand(), 0.5 + 0.2 * rng.rand(),
                 1.6 + 0.5 * rng.rand())
        surf_pts, quads = quad_sphere(scale=scale)
        n_surf = len(surf_pts)
        n_ext = max(npts - n_surf, n_surf)
        ext = rng.randn(n_ext, 3).astype(np.float32)
        ext *= np.asarray([1.5, 1.0, 4.0], np.float32) / np.abs(ext).max(0)
        # push exterior points outside the body
        r = np.linalg.norm(ext / np.asarray(scale, np.float32), axis=-1)
        ext = ext[r > 0.55]

        from .shapenet_car import point_normals
        normal = point_normals(surf_pts, quads)

        sdf_ext = (np.linalg.norm(
            ext / np.asarray(scale, np.float32), axis=-1, keepdims=True
        ) - 0.5).astype(np.float32)

        pos = np.concatenate([ext, surf_pts]).astype(np.float32)
        x = np.concatenate([
            np.concatenate([ext, sdf_ext, np.zeros_like(ext)], -1),
            np.concatenate([surf_pts, np.zeros((n_surf, 1), np.float32),
                            normal], -1),
        ]).astype(np.float32)

        # flow along +z: stagnation pressure at the nose (n_z < 0 face),
        # suction over the sides; exterior velocity shadows behind the body
        press = (normal[:, 2] ** 2 * np.sign(-normal[:, 2])
                 + 0.3 * normal[:, 0] ** 2).astype(np.float32)
        velo_ext = np.stack([
            0.1 * np.sin(ext[:, 0]),
            0.1 * np.cos(ext[:, 1]),
            1.0 - 0.8 * np.exp(-np.abs(ext[:, 0]) - np.abs(ext[:, 1]))
            * (ext[:, 2] > 0),
        ], -1).astype(np.float32)
        y = np.concatenate([
            np.concatenate([velo_ext, np.zeros((len(ext), 1), np.float32)], -1),
            np.concatenate([np.zeros((n_surf, 3), np.float32),
                            press[:, None]], -1),
        ]).astype(np.float32)
        surf = np.concatenate(
            [np.zeros(len(ext)), np.ones(n_surf)]).astype(bool)
        samples.append({
            "x": x, "y": y, "surf": surf, "pos": pos, "quads": quads,
            "surf_slice": slice(len(ext), len(pos)),
        })
    return samples
