"""Loaders of the PDE standard benchmarks (FNO-suite data formats), the
port's copy of ``haet_tpu/data/pde_datasets.py:25-274`` (numpy and scipy;
``h5py`` only for a MATLAB v7.3 file):

* Darcy: ``piececonst_r421_N1024_smooth{1,2}.mat``, 421^2 grids downsampled
  (reference ``exp_darcy.py:77-91``);
* NS: ``NavierStokes_V1e-5_N1200_T20.mat``, 64^2, 10 frames in, 10 out;
* Airfoil / Pipe: ``NACA_Cylinder_{X,Y,Q}.npy`` / ``Pipe_{X,Y,Q}.npy``;
* Elasticity: ``Random_UnitCell_{XY,sigma}_10.npy``;
* Plasticity: ``plas_N987_T20.mat``.

A file is found as ``data_path/<file>`` or ``data_path/<task>/<file>``.
Every loader falls back to the stand-in of :mod:`haet_torch.data.synthetic`
when its files are absent, so the drivers run anywhere; a file that is
present and cannot be read raises.
"""

from __future__ import annotations

import os

import numpy as np

from . import synthetic


def _find(data_path: str, task: str, filename: str) -> str:
    """Resolve a dataset file: ``data_path/filename`` directly, or the
    per-task subdirectory layout ``data_path/<task>/filename`` written by
    ``benchmarks/scripts/fetch_datasets.py``. Returns the first existing
    path (or the direct join, for the caller's exists() fallback check)."""
    direct = os.path.join(data_path, filename)
    if os.path.exists(direct):
        return direct
    sub = os.path.join(data_path, task, filename)
    if os.path.exists(sub):
        return sub
    return direct



def _loadmat(path: str):
    """A ``.mat`` file's arrays: scipy for MATLAB v5 files, ``h5py`` for
    v7.3 (HDF5), which scipy refuses. Without ``h5py`` a v7.3 file raises,
    naming it; there is no quiet fallback to the stand-in for a file that
    exists."""
    import scipy.io as scio
    try:
        return scio.loadmat(path)
    except NotImplementedError as e:  # v7.3 files
        try:
            import h5py
        except ImportError:
            raise ImportError(
                f"{path} is a MATLAB v7.3 (HDF5) file, which scipy cannot "
                "read; reading it needs the h5py package, which is not "
                "installed") from e
        with h5py.File(path, "r") as f:
            return {k: np.array(f[k]).T for k in f.keys()}


def _warn_overlap(task: str, n: int, ntrain: int, ntest: int) -> None:
    """The reference slices train=[:ntrain] / test from the tail with no
    size check; on a file smaller than ntrain+ntest the sets silently
    overlap (up to train==test). Same slicing here — but say so."""
    if n < ntrain + ntest:
        print(f"[{task}] WARNING: {n} samples < ntrain+ntest "
              f"({ntrain}+{ntest}) — train/test sets overlap")


def load_darcy(data_path: str, ntrain: int = 1000, ntest: int = 200,
               downsample: int = 5):
    """Returns dict with pos/x/y train+test arrays, grid side s.

    reference exp_darcy.py:71-111.
    """
    s = int((421 - 1) / downsample) + 1
    train_file = _find(data_path, "darcy", "piececonst_r421_N1024_smooth1.mat")
    test_file = _find(data_path, "darcy", "piececonst_r421_N1024_smooth2.mat")
    if os.path.exists(train_file) and os.path.exists(test_file):
        r = downsample
        tr = _loadmat(train_file)
        te = _loadmat(test_file)
        # Grid side derived from the data (421 for the real FNO files; the
        # committed tests/fixtures use the same format at a smaller size).
        full = tr["coeff"].shape[1]
        s = int((full - 1) / r) + 1
        ntrain = min(ntrain, tr["coeff"].shape[0])
        ntest = min(ntest, te["coeff"].shape[0])
        x_train = tr["coeff"][:ntrain, ::r, ::r][:, :s, :s].reshape(ntrain, -1)
        y_train = tr["sol"][:ntrain, ::r, ::r][:, :s, :s].reshape(ntrain, -1)
        x_test = te["coeff"][:ntest, ::r, ::r][:, :s, :s].reshape(ntest, -1)
        y_test = te["sol"][:ntest, ::r, ::r][:, :s, :s].reshape(ntest, -1)
        g = np.linspace(0, 1, s, dtype=np.float32)
        gx, gy = np.meshgrid(g, g, indexing="ij")
        pos = np.stack([gx.ravel(), gy.ravel()], -1)[None]
        pos_train = pos.repeat(ntrain, 0)
        pos_test = pos.repeat(ntest, 0)
        synthetic_data = False
    else:
        pos_train, x_train, y_train = synthetic.darcy_like(
            max(8, min(ntrain, 32)), s, seed=0
        )
        pos_test, x_test, y_test = synthetic.darcy_like(
            max(4, min(ntest, 16)), s, seed=1
        )
        synthetic_data = True
    return {
        "s": s,
        "train": {"pos": np.float32(pos_train), "x": np.float32(x_train),
                  "y": np.float32(y_train)},
        "test": {"pos": np.float32(pos_test), "x": np.float32(x_test),
                 "y": np.float32(y_test)},
        "synthetic": synthetic_data,
    }


def load_ns(data_path: str, ntrain: int = 1000, ntest: int = 200,
            t_in: int = 10, t_out: int = 10):
    """reference exp_ns.py: 64x64 vorticity, autoregressive 10->10."""
    f = _find(data_path, "ns", "NavierStokes_V1e-5_N1200_T20.mat")
    s = 64
    if os.path.exists(f):
        d = _loadmat(f)
        u = d["u"].astype(np.float32)  # [N, s, s, T]
        s = u.shape[1]  # 64 for the real FNO file; smaller in fixtures
        ntrain = min(ntrain, u.shape[0])
        ntest = min(ntest, u.shape[0])
        _warn_overlap("ns", u.shape[0], ntrain, ntest)
        train = u[:ntrain]
        test = u[-ntest:]
        g = np.linspace(0, 1, s, dtype=np.float32)
        gx, gy = np.meshgrid(g, g, indexing="ij")
        pos = np.stack([gx.ravel(), gy.ravel()], -1)[None]
        return {
            "s": s,
            "train": {"pos": pos.repeat(len(train), 0),
                      "x": train[..., :t_in].reshape(len(train), s * s, t_in),
                      "y": train[..., t_in:t_in + t_out].reshape(len(train), s * s, t_out)},
            "test": {"pos": pos.repeat(len(test), 0),
                     "x": test[..., :t_in].reshape(len(test), s * s, t_in),
                     "y": test[..., t_in:t_in + t_out].reshape(len(test), s * s, t_out)},
            "synthetic": False,
        }
    pos_tr, x_tr, y_tr = synthetic.ns_like(8, s, t_in, t_out, seed=0)
    pos_te, x_te, y_te = synthetic.ns_like(4, s, t_in, t_out, seed=1)
    return {
        "s": s,
        "train": {"pos": pos_tr, "x": x_tr, "y": y_tr},
        "test": {"pos": pos_te, "x": x_te, "y": y_te},
        "synthetic": True,
    }


def load_structured_mesh(data_path: str, prefix: str, ntrain: int,
                         ntest: int, h: int, w: int,
                         downsample=(1, 1), crop=None):
    """Airfoil (`NACA_Cylinder_*`) / Pipe (`Pipe_*`) loaders: mesh coords
    X,Y + field Q (reference exp_airfoil.py:83-101, exp_pipe.py:83-100).

    ``crop`` trims the downsampled grids to ``(s1, s2)`` exactly like the
    reference's ``[:, ::r1, ::r2][:, :s1, :s2]`` — the downsample of a raw
    grid can leave an extra row/column that the reference cuts off.
    Defaults to ``(h, w)``, the driver's target grid.

    Reference-exact per-task details:

    * Q channel — pipe selects ``Q[:, 0]`` (exp_pipe.py:90), airfoil
      ``Q[:, 4]`` (exp_airfoil.py:90); a 3-D Q is a pre-selected field.
    * sample slicing — pipe caps the file at N=1200 FIRST and takes the
      test set from the tail of that window (``input[:N][-ntest:]``,
      exp_pipe.py:92-95); airfoil takes ``[ntrain:ntrain+ntest]``
      (exp_airfoil.py:96-97).
    """
    task = "pipe" if prefix.lower().startswith("pipe") else "airfoil"
    fx = _find(data_path, task, f"{prefix}_X.npy")
    fy = _find(data_path, task, f"{prefix}_Y.npy")
    fq = _find(data_path, task, f"{prefix}_Q.npy")
    if all(os.path.exists(p) for p in (fx, fy, fq)):
        X = np.load(fx).astype(np.float32)
        Y = np.load(fy).astype(np.float32)
        Q = np.load(fq).astype(np.float32)
        if Q.ndim == 4:  # [N, C, H, W]: the task's reference channel
            q_channel = 0 if task == "pipe" else 4
            y = Q[:, q_channel]
        else:  # already a single field [N, H, W]
            y = Q
        if task == "pipe":
            # reference exp_pipe.py:92: input[:N] with N=1200 before any
            # train/test slicing
            X, Y, y = X[:1200], Y[:1200], y[:1200]
        r1, r2 = downsample
        s1, s2 = crop if crop is not None else (h, w)
        X = X[:, ::r1, ::r2][:, :s1, :s2]
        Y = Y[:, ::r1, ::r2][:, :s1, :s2]
        y = y[:, ::r1, ::r2][:, :s1, :s2]
        pos = np.stack([X, Y], axis=-1)
        n, hh, ww = y.shape
        _warn_overlap(task, n, ntrain, ntest)
        pos = pos.reshape(n, hh * ww, 2)
        y = y.reshape(n, hh * ww)
        if task == "pipe":
            test_sl = slice(n - ntest, n)       # [:1200][-ntest:]
        else:
            test_sl = slice(ntrain, ntrain + ntest)  # airfoil
        return {
            "h": hh, "w": ww,
            "train": {"pos": pos[:ntrain], "y": y[:ntrain]},
            "test": {"pos": pos[test_sl], "y": y[test_sl]},
            "synthetic": False,
        }
    pos_tr, y_tr = synthetic.airfoil_like(8, h, w, seed=0)
    pos_te, y_te = synthetic.airfoil_like(4, h, w, seed=1)
    return {
        "h": h, "w": w,
        "train": {"pos": pos_tr, "y": y_tr},
        "test": {"pos": pos_te, "y": y_te},
        "synthetic": True,
    }


def load_elasticity(data_path: str, ntrain: int = 1000, ntest: int = 200):
    """reference exp_elas.py:73-85: Random_UnitCell point clouds."""
    fxy = _find(data_path, "elasticity", "Random_UnitCell_XY_10.npy")
    fs = _find(data_path, "elasticity", "Random_UnitCell_sigma_10.npy")
    if os.path.exists(fxy) and os.path.exists(fs):
        xy = np.load(fxy).astype(np.float32)      # [npts, 2, N]
        sigma = np.load(fs).astype(np.float32)    # [npts, N]
        xy = np.transpose(xy, (2, 0, 1))
        sigma = np.transpose(sigma, (1, 0))
        _warn_overlap("elasticity", len(xy), ntrain, ntest)
        return {
            "train": {"pos": xy[:ntrain], "y": sigma[:ntrain]},
            "test": {"pos": xy[-ntest:], "y": sigma[-ntest:]},
            "synthetic": False,
        }
    pos_tr, y_tr = synthetic.elasticity_like(8, seed=0)
    pos_te, y_te = synthetic.elasticity_like(4, seed=1)
    return {
        "train": {"pos": pos_tr, "y": y_tr},
        "test": {"pos": pos_te, "y": y_te},
        "synthetic": True,
    }


def load_plasticity(data_path: str, ntrain: int = 900, ntest: int = 80):
    """reference exp_plas.py: 101x31 grid, T=20 frames, out_dim=4."""
    f = _find(data_path, "plasticity", "plas_N987_T20.mat")
    h, w, t = 101, 31, 20
    if os.path.exists(f):
        d = _loadmat(f)
        inp = d["input"].astype(np.float32)       # [N, h] (real file: 2-D)
        out = d["output"].astype(np.float32)      # [N, h, w, t, 4]
        n = inp.shape[0]
        h, w, t = out.shape[1], out.shape[2], out.shape[3]
        ntrain = min(ntrain, n)
        ntest = min(ntest, n)
        _warn_overlap("plasticity", n, ntrain, ntest)
        g1 = np.linspace(0, 1, h, dtype=np.float32)
        g2 = np.linspace(0, 1, w, dtype=np.float32)
        gx, gy = np.meshgrid(g1, g2, indexing="ij")
        pos = np.stack([gx.ravel(), gy.ravel()], -1)[None].repeat(n, 0)
        if inp.ndim == 2:
            # the real plas_N987_T20.mat input is a 2-D [N, s1] boundary
            # profile; the reference broadcasts it across s2
            # (exp_plas.py:127: reshape(n, s1, 1).repeat(1, 1, s2))
            fx = np.repeat(inp[:, :h, None], w, axis=2).reshape(n, h * w, 1)
        else:  # already gridded [N, h, w]
            fx = inp.reshape(n, h * w, 1)
        y = out.reshape(n, h * w, t, 4)
        return {
            "h": h, "w": w, "t": t,
            "train": {"pos": pos[:ntrain], "fx": fx[:ntrain], "y": y[:ntrain]},
            "test": {"pos": pos[-ntest:], "fx": fx[-ntest:], "y": y[-ntest:]},
            "synthetic": False,
        }
    pos_tr, y_tr = synthetic.plasticity_like(6, h, w, t, seed=0)
    pos_te, y_te = synthetic.plasticity_like(3, h, w, t, seed=1)
    fx_tr = y_tr[:, :, 0, :1]
    fx_te = y_te[:, :, 0, :1]
    return {
        "h": h, "w": w, "t": t,
        "train": {"pos": pos_tr, "fx": fx_tr, "y": y_tr},
        "test": {"pos": pos_te, "fx": fx_te, "y": y_te},
        "synthetic": True,
    }
