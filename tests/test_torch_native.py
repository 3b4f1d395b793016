"""PyTorch port, the native readers (``haet_torch/native/``) against the
JAX package's (``haet_tpu/native/``).

* ``vtk_parse`` on every VTK fixture and on a big-endian binary file equals
  JAX's native parse exactly (arrays, dtypes, field names);
  ``read_vtk_legacy(use_native=False)`` (the numpy parser) equals it within
  float32 (bit for bit here), but for the cell arrays of a file without
  cells, which the numpy parser leaves None;
* ``use_native=True`` raises when the library cannot build, ``"auto"``
  falls back to numpy;
* each library is built by ``g++`` into ``haet_torch/_build/`` under a
  hashed name, nothing beside the sources;
* the ball tree is integer-equal to JAX's on the inputs of
  ``tests/test_native_balltree.py`` (tree slots, single and batched
  builds, a non-power-of-two cloud, partitions, the rotations pipeline, the
  validation errors), and its memberships at every level match the port's
  on-device ``median_split_perm``.
"""

import glob
import math
import os

import numpy as np
import pytest
import torch

from haet_torch import native as tn
from haet_torch.data import vtk_io as tvtk
from haet_torch.ops.ball_groups import median_split_perm
from haet_tpu import native as jn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(glob.glob(os.path.join(ROOT, "tests", "fixtures", "data",
                                         "car", "**", "*.vtk"),
                            recursive=True))


def _binary_vtk(path):
    pts = np.arange(24, dtype=np.float32).reshape(8, 3) / 7
    flat = np.concatenate([np.r_[4, 0, 1, 2, 3], np.r_[4, 4, 5, 6, 7],
                           np.r_[3, 0, 1, 5]]).astype(">i4")
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nbox\nBINARY\n")
        f.write(b"DATASET UNSTRUCTURED_GRID\nPOINTS 8 float\n")
        f.write(pts.astype(">f4").tobytes() + b"\n")
        f.write(f"CELLS 3 {len(flat)}\n".encode() + flat.tobytes() + b"\n")
        f.write(b"CELL_TYPES 3\n" + np.r_[9, 9, 5].astype(">i4").tobytes()
                + b"\n")
        f.write(b"POINT_DATA 8\nSCALARS p float 1\nLOOKUP_TABLE default\n")
        f.write((pts[:, 0] * 3).astype(">f4").tobytes() + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def vtk_files(tmp_path_factory):
    return FIXTURES + [_binary_vtk(tmp_path_factory.mktemp("vtk")
                                   / "box.vtk")]


def test_fixtures_are_found():
    assert len(FIXTURES) >= 2


@pytest.mark.parametrize("i", range(3), ids=["fixture0", "fixture1",
                                             "binary"])
def test_vtk_parse_matches_jax(vtk_files, i):
    raw = open(vtk_files[i], "rb").read()
    got, want = tn.vtk_parse(raw), jn.vtk_parse(raw)
    assert sorted(got) == sorted(want)
    for k in ("points", "cell_sizes", "cell_flat", "cell_types"):
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for side in ("point_data", "cell_data"):
        assert list(got[side]) == list(want[side]), side
        for k in want[side]:
            assert got[side][k].dtype == want[side][k].dtype
            np.testing.assert_array_equal(got[side][k], want[side][k])
    # the numpy parser: the same content
    nat = tvtk.read_vtk_legacy(vtk_files[i], use_native=True)
    npy = tvtk.read_vtk_legacy(vtk_files[i], use_native=False)
    np.testing.assert_allclose(npy.points, nat.points, rtol=1e-7)
    for k in ("cell_sizes", "cell_flat", "cell_types"):
        a = getattr(npy, k)
        if a is None:
            assert not len(getattr(nat, k) if getattr(nat, k) is not None
                           else []), k
        else:
            np.testing.assert_array_equal(a, getattr(nat, k), err_msg=k)
    np.testing.assert_array_equal(npy.quads, nat.quads)
    for side in ("point_data", "cell_data"):
        assert sorted(getattr(npy, side)) == sorted(getattr(nat, side))
        for k, v in getattr(npy, side).items():
            np.testing.assert_allclose(v, getattr(nat, side)[k], rtol=1e-7)


def test_build_lands_in_build_dir():
    for name in tn.LIBS:
        path = tn.build(name)
        assert path == tn.library_path(name) and path.exists()
        assert path.parent == tn.BUILD_DIR
        assert path.parent.name == "_build"
    beside = [p for p in os.listdir(os.path.dirname(tn.__file__))
              if p.endswith(".so")]
    assert beside == []


def test_use_native_true_raises_when_the_build_fails(monkeypatch):
    def fail(*a, **k):
        raise RuntimeError("g++ failed to build vtkread.cpp")

    monkeypatch.setattr(tn, "_libs", {})
    monkeypatch.setattr(tn, "build", fail)
    path = FIXTURES[0]
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tvtk.read_vtk_legacy(path, use_native=True)
    auto = tvtk.read_vtk_legacy(path)
    want = tvtk.read_vtk_legacy(path, use_native=False)
    np.testing.assert_array_equal(auto.points, want.points)
    assert auto.cell_sizes is want.cell_sizes is None or np.array_equal(
        auto.cell_sizes, want.cell_sizes)


def test_tree_slots():
    lib, jlib = tn.get_lib(), jn.get_lib()
    for n in (1, 2, 3, 8, 9, 1000):
        assert lib.haet_tree_slots(n) == jlib.haet_tree_slots(n)
    assert lib.haet_num_threads() >= 1


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


CASES = {
    "pow2": lambda m, rng: m.build_balltree(
        rng.rand(64, 3), np.zeros(64, np.int64)),
    "non_pow2": lambda m, rng: m.build_balltree(
        rng.rand(37, 2), np.zeros(37, np.int64)),
    "batched": lambda m, rng: m.build_balltree(
        rng.rand(48, 3), np.r_[np.zeros(32), np.ones(16)].astype(np.int64)),
    "partition": lambda m, rng: m.partition_balltree(
        rng.rand(64, 3), np.zeros(64, np.int64), 2),
    "rotations": lambda m, rng: m.build_balltree_with_rotations(
        rng.rand(64, 3), np.zeros(64, np.int64), strides=[2],
        ball_sizes=[16, 8], angle=45.0),
    "rotations_2d": lambda m, rng: m.build_balltree_with_rotations(
        rng.rand(128, 2), np.zeros(128, np.int64), strides=[2],
        ball_sizes=[32, 16], angle=45.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_balltree_matches_jax(case):
    got = CASES[case](tn, np.random.RandomState(7))
    want = CASES[case](jn, np.random.RandomState(7))
    _equal(got, want)


@pytest.mark.parametrize("data,batch_idx", [
    (np.random.RandomState(0).rand(4, 2), np.array([1, 1, 1, 1])),
    (np.random.RandomState(0).rand(4), np.zeros(4, np.int64)),
    (np.random.RandomState(0).rand(4, 2), np.zeros(3, np.int64)),
], ids=["bad_start", "not_2d", "length"])
def test_validation_errors_match_jax(data, batch_idx):
    with pytest.raises(ValueError):
        jn.build_balltree(data, batch_idx)
    with pytest.raises(ValueError):
        tn.build_balltree(data, batch_idx)


def test_memberships_match_ball_groups():
    """Same median-split semantics: the native tree and the port's
    on-device permutation hold the same balls at every level."""
    n = 128
    pts = np.random.RandomState(3).rand(n, 3)
    idx, _ = tn.build_balltree(pts, np.zeros(n, np.int64))
    levels = int(math.log2(n)) - 1
    perm = median_split_perm(torch.from_numpy(pts[None].astype(np.float32)),
                             levels)[0].numpy()
    for lvl in range(levels + 1):
        seg = n >> lvl
        a = {frozenset(idx[i:i + seg].tolist()) for i in range(0, n, seg)}
        b = {frozenset(perm[i:i + seg].tolist()) for i in range(0, n, seg)}
        assert a == b, f"membership mismatch at segment size {seg}"
