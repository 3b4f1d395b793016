"""ShapeNet-Car CFD dataset pipeline of the port (VTK-free), a copy of
``haet_tpu/data/shapenet_car.py`` on numpy and scipy.

Re-implementation of the reference's pipeline
(``benchmarks/02-.../dataset/dataset.py`` + ``load_dataset.py``) with the
legacy-VTK reader :mod:`haet_torch.data.vtk_io` instead of the VTK
library:

* per-sample features ``x = [pos(3), sdf(1), normal(3)]``, targets
  ``y = [velo(3), press(1)]``, surface flags (``dataset.py:216-225``);
* surface = ``quadpress_smpl.vtk`` points, exterior = ``hexvelo_smpl.vtk``
  points not on the surface (:194-199);
* SDF via 1-NN distance to the surface (:30-35), from a scipy
  ``cKDTree`` where the JAX package asks scikit-learn (absent on the
  card's machine): on a tie the nearest index may differ, the distance
  does not;
* point normals from consistently-oriented quad cell normals (:38-84);
* streaming mean/std normalization across the train split with the
  reference's exact running-average recurrences (:243-288);
* ``.npy`` cache per sample (x/y/pos/surf) (:227-235);
* 9 folds ``param0..8``, held-out fold = validation (``load_dataset.py``).

Synthetic car-like clouds stand in when the dataset directory is absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from . import synthetic
from .vtk_io import read_vtk_legacy


@dataclass
class CarSample:
    pos: np.ndarray     # [N, 3]
    x: np.ndarray       # [N, 7]
    y: np.ndarray       # [N, 4]
    surf: np.ndarray    # [N] bool
    name: str = ""
    quads: np.ndarray | None = None       # surface connectivity (for Cd)
    surf_slice: slice | None = None       # where surface points sit in pos


def get_sdf(target: np.ndarray, boundary: np.ndarray):
    """1-NN distance + direction to the surface (reference dataset.py:30-35)."""
    from scipy.spatial import cKDTree

    dists, indices = cKDTree(boundary).query(target, k=1)
    neis = boundary[indices]
    dirs = (target - neis) / (dists[:, None] + 1e-8)
    return dists, dirs


def point_normals(points: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Cell normals averaged to points, then normalized
    (reference dataset.py:38-84: vtkPolyDataNormals + CellDataToPointData)."""
    from .car_metrics import quad_cell_normals

    cn = quad_cell_normals(points, quads)
    acc = np.zeros_like(points)
    cnt = np.zeros((len(points), 1))
    for i in range(4):
        np.add.at(acc, quads[:, i], cn)
        np.add.at(cnt, quads[:, i], 1.0)
    normal = acc / np.maximum(cnt, 1.0)
    normal /= np.max(np.abs(normal), axis=1, keepdims=True) + 1e-8
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-8
    return normal


def load_sample(sample_dir: str, name: str = "") -> CarSample:
    """Assemble one car sample from its two VTK files
    (reference dataset.py:161-225)."""
    press_file = os.path.join(sample_dir, "quadpress_smpl.vtk")
    velo_file = os.path.join(sample_dir, "hexvelo_smpl.vtk")
    press_grid = read_vtk_legacy(press_file)
    velo_grid = read_vtk_legacy(velo_file)

    points_press = press_grid.points
    points_velo = velo_grid.points
    press = _first_field(press_grid.point_data, 1)
    velo = _first_field(velo_grid.point_data, 3)
    quads = press_grid.quads

    sdf_velo, _ = get_sdf(points_velo, points_press)
    normal_press = point_normals(points_press, quads)

    surface = {tuple(p) for p in points_press}
    ext_idx = np.array(
        [i for i, p in enumerate(points_velo) if tuple(p) not in surface],
        dtype=np.int64,
    )
    velo_dict = {tuple(p): velo[i] for i, p in enumerate(points_velo)}
    velo_surf = np.array(
        [velo_dict.get(tuple(p), np.zeros(3)) for p in points_press]
    )

    pos_ext, pos_surf = points_velo[ext_idx], points_press
    init_ext = np.c_[pos_ext, sdf_velo[ext_idx], np.zeros_like(pos_ext)]
    init_surf = np.c_[pos_surf, np.zeros(len(pos_surf)), normal_press]
    target_ext = np.c_[velo[ext_idx], np.zeros((len(ext_idx), 1))]
    target_surf = np.c_[velo_surf, press.reshape(-1, 1)]

    pos = np.concatenate([pos_ext, pos_surf]).astype(np.float32)
    x = np.concatenate([init_ext, init_surf]).astype(np.float32)
    y = np.concatenate([target_ext, target_surf]).astype(np.float32)
    surf = np.concatenate(
        [np.zeros(len(pos_ext)), np.ones(len(pos_surf))]
    ).astype(bool)
    return CarSample(
        pos=pos, x=x, y=y, surf=surf, name=name, quads=quads,
        surf_slice=slice(len(pos_ext), len(pos)),
    )


def _first_field(data: dict, ncomp: int) -> np.ndarray:
    for v in data.values():
        if v.shape[1] == ncomp:
            return v
    raise ValueError(f"no {ncomp}-component field in {list(data)}")


def get_samples(root: str):
    """9 folds param0..param8 (reference load_dataset.py:5-17)."""
    folds = [f"param{i}" for i in range(9)]
    samples = []
    for fold in folds:
        fold_dir = os.path.join(root, fold)
        entries = sorted(os.listdir(fold_dir)) if os.path.isdir(fold_dir) else []
        samples.append(
            [os.path.join(fold, e) for e in entries
             if os.path.isdir(os.path.join(fold_dir, e))]
        )
    return samples


class CoefNorm:
    """(mean_in, std_in, mean_out, std_out) container."""

    def __init__(self, mean_in, std_in, mean_out, std_out):
        self.mean_in, self.std_in = mean_in, std_in
        self.mean_out, self.std_out = mean_out, std_out

    def encode(self, sample: CarSample) -> CarSample:
        sample.x = ((sample.x - self.mean_in) / (self.std_in + 1e-8)).astype(
            np.float32
        )
        sample.y = ((sample.y - self.mean_out) / (self.std_out + 1e-8)).astype(
            np.float32
        )
        return sample

    def decode_y(self, y):
        return y * (self.std_out + 1e-8) + self.mean_out

    def as_tuple(self):
        return (self.mean_in, self.std_in, self.mean_out, self.std_out)


def compute_coef_norm(samples: list[CarSample]) -> CoefNorm:
    """Streaming mean/std with the reference's exact recurrences
    (dataset.py:243-288, including its use of x-length for the y update)."""
    if not samples:
        raise ValueError(
            "compute_coef_norm: no samples (empty dataset, or every "
            "preprocessed cache dir was missing) — a zero-std CoefNorm "
            "would silently scale all data by 1e8")
    mean_in = mean_out = 0.0
    old_length = 0
    for k, s in enumerate(samples):
        if k == 0:
            old_length = s.x.shape[0]
            mean_in = s.x.mean(axis=0)
            mean_out = s.y.mean(axis=0)
        else:
            new_length = old_length + s.x.shape[0]
            mean_in = mean_in + (s.x.sum(axis=0) - s.x.shape[0] * mean_in) / new_length
            mean_out = mean_out + (s.y.sum(axis=0) - s.x.shape[0] * mean_out) / new_length
            old_length = new_length
    std_in = std_out = 0.0
    old_length = 0
    for k, s in enumerate(samples):
        if k == 0:
            old_length = s.x.shape[0]
            std_in = ((s.x - mean_in) ** 2).sum(axis=0) / old_length
            std_out = ((s.y - mean_out) ** 2).sum(axis=0) / old_length
        else:
            new_length = old_length + s.x.shape[0]
            std_in = std_in + (((s.x - mean_in) ** 2).sum(axis=0)
                               - s.x.shape[0] * std_in) / new_length
            std_out = std_out + (((s.y - mean_out) ** 2).sum(axis=0)
                                 - s.x.shape[0] * std_out) / new_length
            old_length = new_length
    return CoefNorm(mean_in, np.sqrt(std_in), mean_out, np.sqrt(std_out))


def get_datalist(root: str, names: list[str], coef_norm: CoefNorm | None = None,
                 norm: bool = False, savedir: str | None = None,
                 preprocessed: bool = False):
    """Load samples (with .npy cache), optionally computing/applying
    normalization (reference dataset.py:144-290)."""
    samples = []
    for name in names:
        if preprocessed and savedir is not None:
            sp = os.path.join(savedir, name)
            if not os.path.exists(sp):
                continue
            s = CarSample(
                pos=np.load(os.path.join(sp, "pos.npy")),
                x=np.load(os.path.join(sp, "x.npy")),
                y=np.load(os.path.join(sp, "y.npy")),
                surf=np.load(os.path.join(sp, "surf.npy")).astype(bool),
                name=name,
            )
        else:
            sample_dir = os.path.join(root, name)
            if not os.path.exists(os.path.join(sample_dir, "quadpress_smpl.vtk")):
                continue
            s = load_sample(sample_dir, name)
            if savedir is not None:
                sp = os.path.join(savedir, name)
                os.makedirs(sp, exist_ok=True)
                np.save(os.path.join(sp, "pos.npy"), s.pos)
                np.save(os.path.join(sp, "x.npy"), s.x)
                np.save(os.path.join(sp, "y.npy"), s.y)
                np.save(os.path.join(sp, "surf.npy"), s.surf)
        samples.append(s)

    if norm and coef_norm is None:
        coef_norm = compute_coef_norm(samples)
        samples = [coef_norm.encode(s) for s in samples]
        return samples, coef_norm
    if coef_norm is not None:
        samples = [coef_norm.encode(s) for s in samples]
    return samples


def load_train_val_fold(data_dir: str, fold_id: int = 0,
                        savedir: str | None = None,
                        preprocessed: bool = False):
    """reference load_dataset.py:19-46; synthetic fallback when absent."""
    if not os.path.isdir(data_dir) or not any(
        os.path.isdir(os.path.join(data_dir, f"param{i}")) for i in range(9)
    ):
        raw = synthetic.car_like(n=8, npts=4096, seed=0)
        samples = [
            CarSample(pos=d["pos"], x=d["x"], y=d["y"], surf=d["surf"],
                      name=f"synthetic/{i}", quads=d.get("quads"),
                      surf_slice=d.get("surf_slice"))
            for i, d in enumerate(raw)
        ]
        train, val = samples[:6], samples[6:]
        coef = compute_coef_norm(train)
        train = [coef.encode(s) for s in train]
        val = [coef.encode(s) for s in val]
        return train, val, coef, True

    folds = get_samples(data_dir)
    trainlst, vallst = [], []
    for i, fold in enumerate(folds):
        (vallst if i == fold_id else trainlst).extend(fold)
    train, coef = get_datalist(data_dir, trainlst, norm=True,
                               savedir=savedir, preprocessed=preprocessed)
    val = get_datalist(data_dir, vallst, coef_norm=coef,
                       savedir=savedir, preprocessed=preprocessed)
    return train, val, coef, False


def pad_sample(s: CarSample, n_pad: int):
    """Pad point count to ``n_pad`` (repeat-last) with a validity mask —
    keeps jit shapes bucketed across ragged car meshes.

    ``n_pad`` must be >= the sample size: truncation would drop the TAIL
    of the arrays, which is exactly the surface points (``pos`` is
    ``concat([exterior, surface])``) — i.e. silently delete the
    pressure-carrying mesh while reporting an all-valid mask."""
    n = len(s.pos)
    if n > n_pad:
        raise ValueError(
            f"pad_sample: sample has {n} points > n_pad={n_pad}; "
            "truncating would drop the surface points (round n_pad up)")
    if n == n_pad:
        return s.pos, s.x, s.y, s.surf, np.ones(n_pad, bool)
    reps = np.full(n_pad - n, n - 1)
    idx = np.concatenate([np.arange(n), reps])
    mask = np.concatenate([np.ones(n, bool), np.zeros(n_pad - n, bool)])
    return s.pos[idx], s.x[idx], s.y[idx], s.surf[idx] & mask, mask
