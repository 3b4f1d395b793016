"""Synthetic stand-ins of the port (``haet_tpu/data/synthetic.py``), bit
for bit the JAX package's at the same seed: the PDE fields (random smooth
Fourier mixtures with each task's tensor layout: ``darcy_like``,
``ns_like``, ``airfoil_like``, ``elasticity_like``, ``plasticity_like``),
an ellipsoid quad surface and car-like samples over it, and
:func:`batch_iter`, the drivers' shuffled batches. The loaders fall back to
them when no dataset file is present. numpy only.
"""

from __future__ import annotations

import numpy as np


def _smooth_field(rng, n, h, w, modes: int = 8, channels: int = 1):
    """Random low-frequency Fourier field on an h x w grid: [n, h, w, C]."""
    ky = rng.randn(n, modes, modes, channels)
    kx = rng.randn(n, modes, modes, channels)
    y = np.linspace(0, np.pi, h)
    x = np.linspace(0, np.pi, w)
    basis_y = np.cos(np.outer(np.arange(modes), y))  # [m, h]
    basis_x = np.cos(np.outer(np.arange(modes), x))  # [m, w]
    decay = np.exp(-0.5 * (np.arange(modes)[:, None] + np.arange(modes)[None, :]))
    coef = (ky + kx) * decay[None, :, :, None]
    field = np.einsum("nabc,ah,bw->nhwc", coef, basis_y, basis_x)
    field /= np.abs(field).max(axis=(1, 2, 3), keepdims=True) + 1e-8
    return field.astype(np.float32)


def _jacobi_darcy(coeff, iters: int = 60):
    """A few Jacobi sweeps of ``-div(a grad u) = 1`` with u=0 boundary:
    a cheap but *learnable* coeff -> sol mapping (the real datasets solve
    this PDE exactly; the synthetic stand-in keeps the functional
    dependence so training curves are meaningful)."""
    n, h, w = coeff.shape
    u = np.zeros_like(coeff)
    f = 1.0
    for _ in range(iters):
        a = coeff
        ae = 0.5 * (a[:, 1:-1, 2:] + a[:, 1:-1, 1:-1])
        aw = 0.5 * (a[:, 1:-1, :-2] + a[:, 1:-1, 1:-1])
        an = 0.5 * (a[:, 2:, 1:-1] + a[:, 1:-1, 1:-1])
        as_ = 0.5 * (a[:, :-2, 1:-1] + a[:, 1:-1, 1:-1])
        num = (ae * u[:, 1:-1, 2:] + aw * u[:, 1:-1, :-2]
               + an * u[:, 2:, 1:-1] + as_ * u[:, :-2, 1:-1]
               + f / (h * w))
        u[:, 1:-1, 1:-1] = num / (ae + aw + an + as_ + 1e-8)
    return u


def darcy_like(n: int = 8, s: int = 85, seed: int = 0):
    """(pos [n,s*s,2], coeff [n,s*s], sol [n,s*s]) mimicking piececonst_r421;
    sol solves (approximately) the Darcy equation for coeff, so the mapping
    is learnable."""
    rng = np.random.RandomState(seed)
    raw = _smooth_field(rng, n, s, s)[..., 0]
    coeff = np.where(raw > 0, 12.0, 3.0).astype(np.float32)  # piecewise const
    sol = _jacobi_darcy(coeff).astype(np.float32)
    g = np.linspace(0, 1, s, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel()], -1)[None].repeat(n, 0)
    return pos, coeff.reshape(n, -1), sol.reshape(n, -1)


def ns_like(n: int = 4, s: int = 64, t_in: int = 10, t_out: int = 10,
            seed: int = 0):
    """(pos, u_in [n,s*s,t_in], u_out [n,s*s,t_out]) mimicking NS V1e-5:
    frames evolve by periodic advection + diffusion, so each next frame is a
    learnable function of the history."""
    rng = np.random.RandomState(seed)
    u0 = _smooth_field(rng, n, s, s)[..., 0]
    frames = [u0]
    for _ in range(t_in + t_out - 1):
        u = frames[-1]
        adv = np.roll(u, 1, axis=1) * 0.6 + np.roll(u, 1, axis=2) * 0.4
        diff = 0.25 * (np.roll(u, 1, 1) + np.roll(u, -1, 1)
                       + np.roll(u, 1, 2) + np.roll(u, -1, 2))
        frames.append(0.7 * adv + 0.3 * diff)
    u = np.stack(frames, axis=-1).astype(np.float32)  # [n, s, s, T]
    g = np.linspace(0, 1, s, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel()], -1)[None].repeat(n, 0)
    u = u.reshape(n, s * s, t_in + t_out)
    return pos, u[..., :t_in], u[..., t_in:]


def airfoil_like(n: int = 4, h: int = 221, w: int = 51, seed: int = 0):
    """(pos [n,h*w,2], y [n,h*w]) — structured mesh coords + pressure field."""
    rng = np.random.RandomState(seed)
    base = _smooth_field(rng, n, h, w, channels=2)
    g1 = np.linspace(0, 1, h, dtype=np.float32)
    g2 = np.linspace(0, 1, w, dtype=np.float32)
    gx, gy = np.meshgrid(g1, g2, indexing="ij")
    grid = np.stack([gx, gy], -1)[None]
    pos = (grid + 0.05 * base).reshape(n, h * w, 2).astype(np.float32)
    # target is a smooth function of the (deformed) mesh coordinates, so the
    # geometry -> field mapping is learnable
    y = (np.sin(3 * np.pi * pos[..., 0]) * np.cos(2 * np.pi * pos[..., 1])
         + 0.5 * pos[..., 0] * pos[..., 1]).astype(np.float32)
    return pos, y


def elasticity_like(n: int = 8, npts: int = 972, seed: int = 0):
    """(pos [n,npts,2], y [n,npts]) — unit-cell point clouds + stress."""
    rng = np.random.RandomState(seed)
    pos = rng.rand(n, npts, 2).astype(np.float32)
    y = (
        np.sin(3 * pos[..., 0]) * np.cos(2 * pos[..., 1])
        + 0.1 * rng.randn(n, npts)
    ).astype(np.float32)
    return pos, y


def plasticity_like(n: int = 4, h: int = 101, w: int = 31, t: int = 20,
                    seed: int = 0):
    """(pos [n,h*w,2], y [n,h*w,t,4]) — time-conditioned deformation."""
    rng = np.random.RandomState(seed)
    g1 = np.linspace(0, 1, h, dtype=np.float32)
    g2 = np.linspace(0, 1, w, dtype=np.float32)
    gx, gy = np.meshgrid(g1, g2, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel()], -1)[None].repeat(n, 0)
    # one base field drives all frames/channels -> deterministic function of
    # the fx input (frame 0), so time-conditioned training can converge
    base = _smooth_field(rng, n, h, w)[..., 0].reshape(n, h * w, 1, 1)
    tt = (np.arange(t, dtype=np.float32) + 1)[None, None, :, None] / t
    cc = (np.arange(4, dtype=np.float32) + 1)[None, None, None, :] / 4
    y = (base * tt * cc).astype(np.float32)  # [n, h*w, t, 4]
    return pos.astype(np.float32), y


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


def batch_iter(arrays, batch_size: int, shuffle: bool = True, seed: int = 0,
               drop_last: bool = False):
    """Yield dict batches from a dict of equal-leading-dim arrays.

    ``drop_last=False`` (default) keeps the trailing partial batch like the
    reference's ``DataLoader`` default — dropping it would silently exclude
    test samples from metrics whenever ``n % batch_size != 0``. The partial
    batch has a different leading dim, costing one extra jit trace.
    """
    n = len(next(iter(arrays.values())))
    rng = np.random.RandomState(seed)
    stop = n - batch_size + 1 if drop_last else n

    def gen():
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, stop, batch_size):
            sel = idx[i:i + batch_size]
            yield {k: v[sel] for k, v in arrays.items()}

    return gen
