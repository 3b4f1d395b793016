"""PyTorch port, the car data layer vs the JAX package's.

Each case feeds the same files or numpy arrays to ``haet_tpu.data`` and to
``haet_torch.data`` (the port's copies) and compares:

* the legacy VTK reader's numpy parser (``use_native=False`` on both
  sides; the native readers are held to each other in
  ``tests/test_torch_native.py``) on the committed fixture pair, and on
  ASCII and big-endian binary round trips: equal arrays;
* ``point_normals``, ``load_sample``, ``compute_coef_norm``/``CoefNorm``,
  ``load_train_val_fold`` on the fixture fold layout (with the ``.npy``
  cache and its ``--preprocessed`` read) and on the synthetic stand-in,
  ``car_like``, ``pad_sample`` and the driver's ``make_batch``: equal, bit
  for bit, where no nearest neighbour is involved;
* ``get_sdf`` and ``sample_sdf_grid``: the port's scipy ``cKDTree`` against
  JAX's scikit-learn ``NearestNeighbors``: distances at rtol 1e-6 (both in
  float64 over float32 points; measured equal), directions and signs
  where the nearest surface point is unique (ties may pick another index);
* ``drag_coefficient``, ``frontal_area``, ``spearman_rho``: the same numpy
  and scipy arithmetic, equal;
* ``Prefetcher`` against plain iteration, a producer's exception, and a
  pass abandoned mid-way.
"""

import os
import shutil
import sys
import threading

import numpy as np
import pytest
from scipy.spatial import cKDTree

from haet_torch.data import car_metrics as tm
from haet_torch.data import preprocess_car as tpre
from haet_torch.data import shapenet_car as tcar
from haet_torch.data import synthetic as tsyn
from haet_torch.data import vtk_io as tvtk
from haet_torch.data.prefetch import Prefetcher
from haet_torch.train import car as tdrv
from haet_tpu.data import car_metrics as jm
from haet_tpu.data import preprocess_car as jpre
from haet_tpu.data import shapenet_car as jcar
from haet_tpu.data import synthetic as jsyn
from haet_tpu.data import vtk_io as jvtk

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "data", "car", "param0",
                       "fixturecar000")
BENCH = os.path.join(os.path.dirname(HERE), "benchmarks")


def build_car_dataset(root):
    """A 2-fold miniature of the reference's layout
    (``param{K}/<sample>/{quadpress,hexvelo}_smpl.vtk``) from the fixture
    pair, as ``tests/test_drivers_real_branch.py:70-77`` builds it."""
    for fold, names in [("param0", ["car_a"]), ("param1", ["car_b", "car_c"])]:
        for n in names:
            shutil.copytree(FIXTURE, os.path.join(root, fold, n))


def assert_vtk_equal(got, want):
    for k in ("points", "cell_sizes", "cell_flat", "cell_types"):
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, k
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
            assert a.dtype == b.dtype, k
    np.testing.assert_array_equal(got.quads, want.quads)
    for side in ("point_data", "cell_data"):
        g, w = getattr(got, side), getattr(want, side)
        assert sorted(g) == sorted(w), side
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_samples_equal(got, want):
    for k in ("pos", "x", "y", "surf"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.name == want.name
    assert got.surf_slice == want.surf_slice
    if want.quads is None:
        assert got.quads is None
    else:
        np.testing.assert_array_equal(got.quads, want.quads)


@pytest.mark.parametrize("name", ["quadpress_smpl.vtk", "hexvelo_smpl.vtk"])
def test_read_vtk_fixture_matches_jax(name):
    path = os.path.join(FIXTURE, name)
    assert_vtk_equal(tvtk.read_vtk_legacy(path, use_native=False),
                     jvtk.read_vtk_legacy(path, use_native=False))


def _box():
    pts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    quads = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [0, 1, 5, 4],
                      [2, 3, 7, 6], [0, 3, 7, 4], [1, 2, 6, 5]], np.int64)
    return pts, quads


def test_vtk_ascii_roundtrip_matches_jax(tmp_path):
    """The port's writer: both readers parse it alike, and it writes what
    the JAX writer writes but for the title line."""
    pts, quads = _box()
    rng = np.random.RandomState(0)
    data = {"press": rng.randn(8).astype(np.float32),
            "velo": rng.randn(8, 3).astype(np.float32)}
    tpath, jpath = str(tmp_path / "t.vtk"), str(tmp_path / "j.vtk")
    tvtk.write_vtk_ascii_polydata(tpath, pts, quads, data)
    jvtk.write_vtk_ascii_polydata(jpath, pts, quads, data)
    tlines, jlines = open(tpath).readlines(), open(jpath).readlines()
    assert tlines[1] == "haet_torch\n"
    assert tlines[:1] + tlines[2:] == jlines[:1] + jlines[2:]
    got = tvtk.read_vtk_legacy(tpath, use_native=False)
    assert_vtk_equal(got, jvtk.read_vtk_legacy(tpath, use_native=False))
    np.testing.assert_array_equal(got.quads, quads)
    np.testing.assert_allclose(got.point_data["velo"], data["velo"],
                               rtol=1e-6)


def test_vtk_binary_roundtrip_matches_jax(tmp_path):
    """Big-endian binary with a title that says "binary", mixed cell sizes
    (the general connectivity decoder), CELL_TYPES, point and cell data."""
    pts, quads = _box()
    rng = np.random.RandomState(1)
    press = rng.randn(8).astype(np.float32)
    velo = rng.randn(8, 3).astype(np.float32)
    cell_val = rng.randn(7).astype(np.float32)
    cells = [np.r_[4, q] for q in quads] + [np.array([3, 0, 1, 2])]
    flat = np.concatenate(cells).astype(">i4")
    path = tmp_path / "box_bin.vtk"
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nnot binary, a title\nBINARY\n")
        f.write(b"DATASET UNSTRUCTURED_GRID\nPOINTS 8 float\n")
        f.write(pts.astype(">f4").tobytes() + b"\n")
        f.write(f"CELLS 7 {len(flat)}\n".encode() + flat.tobytes() + b"\n")
        f.write(b"CELL_TYPES 7\n"
                + np.r_[np.full(6, 9), 5].astype(">i4").tobytes() + b"\n")
        f.write(b"POINT_DATA 8\nSCALARS press float 1\nLOOKUP_TABLE default\n")
        f.write(press.astype(">f4").tobytes() + b"\n")
        f.write(b"VECTORS velo float\n" + velo.astype(">f4").tobytes()
                + b"\n")
        f.write(b"CELL_DATA 7\nSCALARS c double 1\nLOOKUP_TABLE default\n")
        f.write(cell_val.astype(">f8").tobytes() + b"\n")
    got = tvtk.read_vtk_legacy(str(path), use_native=False)
    assert_vtk_equal(got, jvtk.read_vtk_legacy(str(path), use_native=False))
    np.testing.assert_array_equal(got.quads, quads)
    assert [len(c) for c in got.cells] == [4] * 6 + [3]
    np.testing.assert_array_equal(got.point_data["press"][:, 0], press)
    np.testing.assert_array_equal(got.cell_data["c"][:, 0], cell_val)


def test_point_normals_matches_jax():
    pts, quads = tsyn.quad_sphere(scale=(1.1, 0.6, 1.9))
    np.testing.assert_array_equal(tcar.point_normals(pts, quads),
                                  jcar.point_normals(pts, quads))
    fx = tvtk.read_vtk_legacy(os.path.join(FIXTURE, "quadpress_smpl.vtk"))
    np.testing.assert_array_equal(tcar.point_normals(fx.points, fx.quads),
                                  jcar.point_normals(fx.points, fx.quads))


def _unique_nearest(query, boundary):
    """Rows of ``query`` whose nearest boundary point is unique (the two
    nearest distances differ by more than float32 rounding)."""
    d, _ = cKDTree(boundary).query(query, k=2)
    return d[:, 1] - d[:, 0] > 1e-5 * np.maximum(d[:, 1], 1e-6)


@pytest.mark.parametrize("grid", [False, True], ids=["random", "ties"])
def test_get_sdf_matches_sklearn(grid):
    """On a lattice boundary many queries tie (the lattice centres)."""
    rng = np.random.RandomState(2)
    if grid:
        g = np.arange(5, dtype=np.float32)
        boundary = np.stack(np.meshgrid(g, g, [0.0], indexing="ij"),
                            -1).reshape(-1, 3).astype(np.float32)
        target = np.concatenate([
            boundary[:10] + np.float32(0.5),
            rng.rand(50, 3).astype(np.float32) * 4]).astype(np.float32)
    else:
        boundary = rng.randn(300, 3).astype(np.float32)
        target = rng.randn(500, 3).astype(np.float32)
    td, tdir = tcar.get_sdf(target, boundary)
    jd, jdir = jcar.get_sdf(target, boundary)
    assert td.shape == jd.shape and tdir.shape == jdir.shape
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-7)
    uniq = _unique_nearest(target, boundary)
    if grid:
        assert (~uniq).sum() >= 10
    np.testing.assert_allclose(tdir[uniq], jdir[uniq], rtol=1e-5, atol=1e-6)


def test_sample_sdf_grid_matches_jax():
    pts, quads = tsyn.quad_sphere()
    tg, tsdf = tpre.sample_sdf_grid(pts, quads, resolution=8)
    jg, jsdf = jpre.sample_sdf_grid(pts, quads, resolution=8)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_allclose(np.abs(tsdf), np.abs(jsdf), rtol=1e-6)
    uniq = _unique_nearest(tg, pts)
    np.testing.assert_array_equal(np.sign(tsdf[uniq]), np.sign(jsdf[uniq]))
    np.testing.assert_array_equal(tpre.quads_to_tris(quads),
                                  jpre.quads_to_tris(quads))


def test_preprocess_sample_matches_jax():
    got, want = (tpre.preprocess_sample(FIXTURE, resolution=4),
                 jpre.preprocess_sample(FIXTURE, resolution=4))
    for k in ("points", "triangles", "grid"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(np.abs(got["sdf"]), np.abs(want["sdf"]),
                               rtol=1e-6)


def test_load_sample_matches_jax():
    """The fixture car: ``x`` carries the exterior SDF from the nearest
    surface point (distances, so equal up to the float32 cast)."""
    got = tcar.load_sample(FIXTURE, "param0/fixturecar000")
    want = jcar.load_sample(FIXTURE, "param0/fixturecar000")
    np.testing.assert_allclose(got.x, want.x, rtol=1e-6, atol=1e-7)
    got.x = want.x
    assert_samples_equal(got, want)


@pytest.mark.parametrize("seed", [0, 3])
def test_car_like_matches_jax_bit_for_bit(seed):
    got = tsyn.car_like(n=3, npts=1500, seed=seed)
    want = jsyn.car_like(n=3, npts=1500, seed=seed)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k == "surf_slice":
                assert g[k] == w[k]
            else:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_coef_norm_matches_jax():
    """The reference's streaming recurrences, ``encode`` and ``decode_y``;
    an empty list raises."""
    raw = jsyn.car_like(n=3, npts=1200, seed=5)
    tsamples = [tcar.CarSample(pos=d["pos"], x=d["x"], y=d["y"],
                               surf=d["surf"]) for d in raw]
    jsamples = [jcar.CarSample(pos=d["pos"], x=d["x"], y=d["y"],
                               surf=d["surf"]) for d in raw]
    tc, jc = tcar.compute_coef_norm(tsamples), jcar.compute_coef_norm(jsamples)
    for a, b in zip(tc.as_tuple(), jc.as_tuple()):
        np.testing.assert_array_equal(a, b)
    te, je = tc.encode(tsamples[1]), jc.encode(jsamples[1])
    np.testing.assert_array_equal(te.x, je.x)
    np.testing.assert_array_equal(tc.decode_y(te.y), jc.decode_y(je.y))
    with pytest.raises(ValueError, match="no samples"):
        tcar.compute_coef_norm([])


def _fold_equal(got, want):
    (tt, tv, tc, ts), (jt, jv, jc, js) = got, want
    assert ts == js
    assert len(tt) == len(jt) and len(tv) == len(jv)
    for a, b in zip(tc.as_tuple(), jc.as_tuple()):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for g, w in zip(tt + tv, jt + jv):
        np.testing.assert_allclose(g.x, w.x, rtol=1e-5, atol=1e-6)
        g.x = w.x
        np.testing.assert_allclose(g.y, w.y, rtol=1e-6, atol=1e-7)
        g.y = w.y
        assert_samples_equal(g, w)


def test_load_train_val_fold_on_fixture_layout(tmp_path):
    """Fold 0 held out: 2 train / 1 val. Features hold SDFs from the
    nearest neighbours, and the normalisation amplifies their float32
    rounding: rtol 1e-5 there. The port's cache then feeds the
    ``preprocessed`` branch of both loaders alike."""
    data_dir = str(tmp_path / "training_data")
    build_car_dataset(data_dir)
    tcache, jcache = str(tmp_path / "tcache"), str(tmp_path / "jcache")
    got = tcar.load_train_val_fold(data_dir, 0, savedir=tcache)
    want = jcar.load_train_val_fold(data_dir, 0, savedir=jcache)
    assert (len(got[0]), len(got[1]), got[3]) == (2, 1, False)
    _fold_equal(got, want)
    for fold, names in [("param0", ["car_a"]), ("param1", ["car_b", "car_c"])]:
        for n in names:
            for f in ("pos.npy", "x.npy", "y.npy", "surf.npy"):
                assert os.path.exists(os.path.join(tcache, fold, n, f))
    got = tcar.load_train_val_fold(data_dir, 0, savedir=tcache,
                                   preprocessed=True)
    want = jcar.load_train_val_fold(data_dir, 0, savedir=tcache,
                                    preprocessed=True)
    _fold_equal(got, want)
    assert got[0][0].quads is None   # the cache keeps no connectivity


def test_load_train_val_fold_synthetic_bit_for_bit(tmp_path):
    got = tcar.load_train_val_fold(str(tmp_path / "absent"), 0)
    want = jcar.load_train_val_fold(str(tmp_path / "absent"), 0)
    assert got[3] is True and (len(got[0]), len(got[1])) == (6, 2)
    for a, b in zip(got[2].as_tuple(), want[2].as_tuple()):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert_samples_equal(g, w)


@pytest.fixture(scope="module")
def car_train():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import car_train

    return car_train


def test_pad_and_make_batch_match_jax(car_train):
    """On a synthetic car, its bucket and a larger one."""
    d = jsyn.car_like(n=1, npts=2500, seed=7)[0]
    ts = tcar.CarSample(pos=d["pos"], x=d["x"], y=d["y"], surf=d["surf"])
    js = jcar.CarSample(pos=d["pos"], x=d["x"], y=d["y"], surf=d["surf"])
    for n_pad in (tdrv.bucket_size(len(ts.pos)), 6144):
        for g, w in zip(tcar.pad_sample(ts, n_pad),
                        jcar.pad_sample(js, n_pad)):
            np.testing.assert_array_equal(g, w)
    got, want = tdrv.make_batch(ts), car_train.make_batch(js)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_car_metrics_match_jax():
    """Cd of two synthetic cars from their fields and from perturbed ones,
    the frontal area, and the rank correlation over them."""
    rng = np.random.RandomState(8)
    cds = {"t": [], "j": []}
    for d in jsyn.car_like(n=2, npts=1200, seed=9):
        pts = d["pos"][d["surf_slice"]]
        for scale in (1.0, 1.3):
            press = d["y"][d["surf_slice"], 3] * scale
            velo = rng.randn(len(pts), 3).astype(np.float32)
            cds["t"].append(tm.drag_coefficient(pts, d["quads"], press, velo))
            cds["j"].append(jm.drag_coefficient(pts, d["quads"], press, velo))
        assert tm.frontal_area(pts) == jm.frontal_area(pts)
        np.testing.assert_array_equal(tm.quad_cell_areas(pts, d["quads"]),
                                      jm.quad_cell_areas(pts, d["quads"]))
    assert cds["t"] == cds["j"]
    assert all(np.isfinite(cds["t"]))
    gt = np.asarray(cds["t"]) + rng.randn(4) * 0.1
    assert (tm.spearman_rho(cds["t"], gt)
            == jm.spearman_rho(cds["j"], gt))


def test_prefetcher_matches_plain_iteration():
    """Order and content over two passes, the producer's exception in the
    consumer, and a pass left mid-way ends its thread."""
    rng = np.random.RandomState(3)
    items = [rng.randn(4) for _ in range(7)]
    pre = Prefetcher(lambda: iter(items), depth=2)
    for _ in range(2):
        got = list(pre())
        assert len(got) == len(items)
        for a, b in zip(got, items):
            np.testing.assert_array_equal(a, b)

    def boom():
        yield 1
        raise RuntimeError("producer died")

    with pytest.raises(RuntimeError, match="producer died"):
        list(Prefetcher(boom)())
    before = threading.active_count()
    it = Prefetcher(lambda: iter(range(1000)), depth=1)()
    assert next(it) == 0
    it.close()
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(lambda: iter(()), depth=0)
