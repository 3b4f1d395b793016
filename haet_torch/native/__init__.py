"""Native (C++/OpenMP) host-side components of the port, loaded via ctypes.

Counterpart of ``haet_tpu/native/__init__.py``, over copies of its sources
beside this file:

* ``balltree.cpp``, the exact median-split ball tree (:func:`build_balltree`,
  :func:`partition_balltree`, :func:`build_balltree_with_rotations`): the
  host oracle of the on-device grouping in :mod:`haet_torch.ops.ball_groups`
  and a preprocessing option for static point sets; no forward calls it;
* ``vtkread.cpp``, the legacy-VTK reader of the ShapeNet-Car data
  (:func:`vtk_parse`), behind
  :func:`haet_torch.data.vtk_io.read_vtk_legacy`.

Each library is compiled with ``g++`` at first use into
``haet_torch/_build/`` (listed in ``.gitignore``), under a name that carries
a hash of its source and flags, so an edited source is rebuilt and a stale
library never loaded; nothing is written beside the sources. A build lands
under a temporary name and is renamed into place, so processes that build
at once do not read a half-written library. A failed build raises with
``g++``'s stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
#: name -> (source, g++ flags)
LIBS = {
    "balltree": ("balltree.cpp", ("-O3", "-std=c++17", "-fopenmp", "-shared",
                                  "-fPIC")),
    "vtkread": ("vtkread.cpp", ("-O3", "-std=c++17", "-shared", "-fPIC")),
}
_lock = threading.Lock()
_libs: dict = {}


def library_path(name: str) -> Path:
    """Where ``name``'s library is built: ``_build/lib{name}-{hash}.so``."""
    src, flags = LIBS[name]
    h = hashlib.sha256((_HERE / src).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def compile_command(name: str, out: Path) -> list:
    """The ``g++`` command that builds ``name``'s library as ``out``."""
    src, flags = LIBS[name]
    return ["g++", *flags, str(_HERE / src), "-o", str(out)]


def build(name: str) -> Path:
    """Compile ``name``'s library unless it is built; returns its path."""
    target = library_path(name)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(compile_command(name, tmp), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {LIBS[name][0]}:\n{proc.stderr}")
    os.replace(tmp, target)
    return target


def _load(name: str, declare) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            declare(lib)
            _libs[name] = lib
        return _libs[name]


def _declare_balltree(lib) -> None:
    i64, i64p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.haet_tree_slots.restype = i64
    lib.haet_tree_slots.argtypes = [i64]
    lib.haet_build_balltree.restype = i64
    lib.haet_build_balltree.argtypes = [f64p, i64, i64p, i64p, i64, i64p,
                                        ctypes.POINTER(ctypes.c_uint8)]
    lib.haet_partition_balltree.restype = i64
    lib.haet_partition_balltree.argtypes = [f64p, i64, i64p, i64, i64, i64p]
    lib.haet_num_threads.restype = i64
    lib.haet_num_threads.argtypes = []


def get_lib() -> ctypes.CDLL:
    """The ball-tree library, built if needed."""
    return _load("balltree", _declare_balltree)


def _offsets_from_batch_idx(batch_idx: np.ndarray) -> np.ndarray:
    """A sorted batch-index vector as offsets (``balltree.pyx:462-471``,
    with its validation)."""
    batch_idx = np.asarray(batch_idx, dtype=np.int64)
    if batch_idx.ndim != 1 or len(batch_idx) == 0:
        raise ValueError("batch_idx must be a non-empty 1D array")
    if batch_idx[0] != 0:
        raise ValueError("Batch indices must start from 0")
    if np.any(np.diff(batch_idx) < 0):
        raise ValueError("batch_idx must be sorted")
    n = len(batch_idx)
    change = np.flatnonzero(batch_idx[1:] != batch_idx[:-1]) + 1
    num_batches = int(batch_idx[-1]) + 1
    offsets = np.zeros(num_batches + 1, dtype=np.int64)
    offsets[1:num_batches] = change
    offsets[num_batches] = n
    return offsets


def _cptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def build_balltree(data: np.ndarray, batch_idx: np.ndarray):
    """Exact batched ball tree.

    Args:
        data: ``[N, dim]`` points (computed in float64, as the reference's
            bridge, ``balltree.pyx:542``).
        batch_idx: ``[N]`` sorted batch assignment.

    Returns ``(tree_idx, tree_mask)``, flat arrays in tree order with one
    entry per leaf slot (2 per leaf; a duplicate masked False): the
    reference ``build_balltree`` contract (``balltree.pyx:525-550``).
    """
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"data must be 2D, got {data.shape}")
    if data.shape[0] != len(batch_idx):
        raise ValueError("batch_idx length must match number of points")
    offsets = _offsets_from_batch_idx(batch_idx)
    nb = len(offsets) - 1
    slots = np.array([lib.haet_tree_slots(int(offsets[i + 1] - offsets[i]))
                      for i in range(nb)], dtype=np.int64)
    out_offsets = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(slots, out=out_offsets[1:])
    total = int(out_offsets[-1])
    out_idx = np.empty(total, dtype=np.int64)
    out_mask = np.empty(total, dtype=np.uint8)
    rc = lib.haet_build_balltree(
        _cptr(data, ctypes.c_double), data.shape[1],
        _cptr(offsets, ctypes.c_int64), _cptr(out_offsets, ctypes.c_int64),
        nb, _cptr(out_idx, ctypes.c_int64), _cptr(out_mask, ctypes.c_uint8))
    if rc != 0:
        raise RuntimeError(f"native build_balltree failed rc={rc}")
    return out_idx, out_mask.astype(bool)


def partition_balltree(data: np.ndarray, batch_idx: np.ndarray,
                       target_level: int) -> np.ndarray:
    """Partition-only tree over existing orderings (reference
    ``balltree.pyx:552-574``)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, dtype=np.float64)
    if data.ndim != 2:
        raise ValueError(f"data must be 2D, got {data.shape}")
    offsets = _offsets_from_batch_idx(batch_idx)
    if offsets[-1] != data.shape[0]:
        raise ValueError("batch_idx length must match number of points")
    out_idx = np.empty(data.shape[0], dtype=np.int64)
    rc = lib.haet_partition_balltree(
        _cptr(data, ctypes.c_double), data.shape[1],
        _cptr(offsets, ctypes.c_int64), len(offsets) - 1, int(target_level),
        _cptr(out_idx, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native partition_balltree failed rc={rc}")
    return out_idx


def build_balltree_with_rotations(data: np.ndarray, batch_idx: np.ndarray,
                                  strides, ball_sizes, angle: float = 45.0):
    """The host analogue of ``build_balltree_with_rotations``
    (``balltree.pyx:598-662``): the main tree, then per level a rotated
    partition, with stride-mean coarsening between levels."""
    from ..ops.ball_groups import rotation_matrix

    if len(strides) != len(ball_sizes) - 1:
        raise ValueError("need one stride between each pair of levels")
    data = np.asarray(data, dtype=np.float64)
    dim = data.shape[1]
    num_layers = len(ball_sizes)

    tree_idx, tree_mask = build_balltree(data, batch_idx)
    if angle <= 0:
        return tree_idx, tree_mask, [None] * num_layers

    leaves = data[tree_idx]
    cur_batch = np.asarray(batch_idx, dtype=np.int64)[tree_idx]
    targets = [max(0, int(math.log2(leaves.shape[0] / bs)))
               for bs in ball_sizes]
    rotated = leaves @ rotation_matrix(angle, dim).numpy().astype(np.float64)
    rot_indices = []
    for i in range(num_layers):
        rot_indices.append(partition_balltree(rotated, cur_batch, targets[i]))
        if i < num_layers - 1:
            s = strides[i]
            rotated = rotated.reshape(-1, s, dim).mean(axis=1)
            cur_batch = cur_batch[::s]
    return tree_idx, tree_mask, rot_indices


# -- the legacy-VTK reader (vtkread.cpp) ------------------------------------

def _declare_vtk(lib) -> None:
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.haet_vtk_parse.restype = vp
    lib.haet_vtk_parse.argtypes = [ctypes.c_char_p, i64]
    lib.haet_vtk_free.restype = None
    lib.haet_vtk_free.argtypes = [vp]
    for name in ("num_points", "num_cells", "cells_flat_size",
                 "num_cell_types"):
        fn = getattr(lib, f"haet_vtk_{name}")
        fn.restype = i64
        fn.argtypes = [vp]
    lib.haet_vtk_num_fields.restype = i64
    lib.haet_vtk_num_fields.argtypes = [vp, ctypes.c_int]
    lib.haet_vtk_field_name.restype = ctypes.c_char_p
    lib.haet_vtk_field_name.argtypes = [vp, ctypes.c_int, i64]
    for name in ("field_size", "field_ncomp"):
        fn = getattr(lib, f"haet_vtk_{name}")
        fn.restype = i64
        fn.argtypes = [vp, ctypes.c_int, i64]
    for name, ptr in (("get_points", f32p), ("get_cell_sizes", i64p),
                      ("get_cell_index", i64p), ("get_cell_types", i64p)):
        fn = getattr(lib, f"haet_vtk_{name}")
        fn.restype = None
        fn.argtypes = [vp, ptr]
    lib.haet_vtk_get_field.restype = None
    lib.haet_vtk_get_field.argtypes = [vp, ctypes.c_int, i64, f32p]


def get_vtk_lib() -> ctypes.CDLL:
    """The VTK reader library, built if needed."""
    return _load("vtkread", _declare_vtk)


def vtk_parse(raw: bytes) -> dict:
    """Parse a legacy .vtk buffer natively.

    Returns ``points [n, 3] f32``, ``cell_sizes`` and ``cell_flat`` (the
    compact connectivity), ``cell_types [m] i64`` (or None), and
    ``point_data`` / ``cell_data`` (name -> ``[n, ncomp] f32``): the
    content of :func:`haet_torch.data.vtk_io.read_vtk_legacy`.
    """
    lib = get_vtk_lib()
    h = lib.haet_vtk_parse(raw, len(raw))
    if not h:
        raise ValueError("native VTK parse failed")
    try:
        n = lib.haet_vtk_num_points(h)
        points = np.empty((n, 3), np.float32)
        if n:
            lib.haet_vtk_get_points(h, _cptr(points, ctypes.c_float))
        m = lib.haet_vtk_num_cells(h)
        sizes = np.empty(m, np.int64)
        flat = np.empty(lib.haet_vtk_cells_flat_size(h), np.int64)
        if m:
            lib.haet_vtk_get_cell_sizes(h, _cptr(sizes, ctypes.c_int64))
            lib.haet_vtk_get_cell_index(h, _cptr(flat, ctypes.c_int64))
        nt = lib.haet_vtk_num_cell_types(h)
        cell_types = None
        if nt:
            cell_types = np.empty(nt, np.int64)
            lib.haet_vtk_get_cell_types(h, _cptr(cell_types, ctypes.c_int64))

        def fields(point_data: int) -> dict:
            out = {}
            for i in range(lib.haet_vtk_num_fields(h, point_data)):
                name = lib.haet_vtk_field_name(h, point_data, i).decode()
                size = lib.haet_vtk_field_size(h, point_data, i)
                ncomp = lib.haet_vtk_field_ncomp(h, point_data, i)
                arr = np.empty(size, np.float32)
                if size:
                    lib.haet_vtk_get_field(h, point_data, i,
                                           _cptr(arr, ctypes.c_float))
                out[name] = arr.reshape(-1, ncomp)
            return out

        return {"points": points, "cell_sizes": sizes, "cell_flat": flat,
                "cell_types": cell_types, "point_data": fields(1),
                "cell_data": fields(0)}
    finally:
        lib.haet_vtk_free(h)
