"""Minimal legacy-VTK reader of the port, numpy only
(``haet_tpu/data/vtk_io.py``, the numpy parser and the writer).

Reads the subset of the legacy .vtk format that the ShapeNet-Car CFD data
uses (reference loads it with the VTK library,
``benchmarks/02-.../dataset/dataset.py:161-181``): ASCII or big-endian
binary, ``UNSTRUCTURED_GRID`` / ``POLYDATA`` datasets with POINTS,
CELLS/POLYGONS (+CELL_TYPES), and POINT_DATA / CELL_DATA sections with
SCALARS or VECTORS arrays. :func:`read_vtk_legacy` reads through the
native C++ reader (:func:`haet_torch.native.vtk_parse`, a copy of the JAX
package's ``native/vtkread.cpp``) or this module's numpy parser, which the
reader falls back to unless told otherwise (JAX ``data/vtk_io.py:91-117``).
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": (">f4", float, 4),
    "double": (">f8", float, 8),
    "int": (">i4", int, 4),
    "long": (">i8", int, 8),
    "unsigned_int": (">u4", int, 4),
    "char": (">i1", int, 1),
    "unsigned_char": (">u1", int, 1),
    "short": (">i2", int, 2),
    "unsigned_short": (">u2", int, 2),
    "unsigned_long": (">u8", int, 8),
    "vtktypeint64": (">i8", int, 8),
}


class VTKData:
    """Connectivity is stored compactly as ``cell_sizes`` + ``cell_flat``
    (flat vertex ids); the ``cells`` list-of-arrays view materializes
    lazily — splitting 30k+ cells into separate arrays dominated parse
    time for the car meshes."""

    def __init__(self):
        self.points: np.ndarray | None = None
        self.cell_sizes: np.ndarray | None = None  # [num_cells] int64
        self.cell_flat: np.ndarray | None = None   # flat vertex ids
        self.cell_types: np.ndarray | None = None
        self.point_data: dict[str, np.ndarray] = {}
        self.cell_data: dict[str, np.ndarray] = {}
        self._cells: list[np.ndarray] | None = None

    @property
    def cells(self) -> list[np.ndarray]:
        if self._cells is None:
            if self.cell_sizes is None or not len(self.cell_sizes):
                self._cells = []
            else:
                self._cells = np.split(
                    self.cell_flat, np.cumsum(self.cell_sizes)[:-1]
                )
        return self._cells

    @cells.setter
    def cells(self, value):
        value = list(value)
        self._cells = value
        if value:
            self.cell_sizes = np.asarray([len(c) for c in value], np.int64)
            self.cell_flat = np.concatenate(
                [np.asarray(c, np.int64) for c in value])
        else:
            self.cell_sizes = np.zeros(0, np.int64)
            self.cell_flat = np.zeros(0, np.int64)

    @property
    def quads(self) -> np.ndarray:
        """[num_quads, 4] connectivity (cells with exactly 4 vertices)."""
        if self.cell_sizes is None or not len(self.cell_sizes):
            return np.zeros((0, 4), np.int64)
        mask = self.cell_sizes == 4
        if not mask.any():
            return np.zeros((0, 4), np.int64)
        offs = np.concatenate(
            [[0], np.cumsum(self.cell_sizes[:-1])]).astype(np.int64)
        idx = offs[mask][:, None] + np.arange(4)[None, :]
        return self.cell_flat[idx].astype(np.int64)


def _read_ascii_numbers(lines, start, count, cast=float):
    vals: list = []
    i = start
    while len(vals) < count and i < len(lines):
        vals.extend(cast(t) for t in lines[i].split())
        i += 1
    return np.asarray(vals[:count]), i


def read_vtk_legacy(path: str, use_native: str | bool = "auto") -> VTKData:
    """Parse a legacy .vtk file (ASCII or big-endian binary).

    ``use_native``: ``"auto"`` (default) tries the C++ reader
    (:func:`haet_torch.native.vtk_parse`, built with ``g++`` at first use)
    and falls back to the numpy parser if it cannot build or parse, as the
    reference's users expect; ``True`` requires it (a failed build or
    parse raises); ``False`` takes the numpy parser. The two give the same
    arrays, but a file without cells: the native reader gives empty
    connectivity arrays where the numpy parser leaves None.
    """
    with open(path, "rb") as f:
        raw = f.read()

    if use_native:
        try:
            from ..native import vtk_parse

            d = vtk_parse(raw)
        except (OSError, RuntimeError, ValueError):
            if use_native is True:
                raise
        else:
            out = VTKData()
            out.points = d["points"]
            out.cell_sizes = d["cell_sizes"]
            out.cell_flat = d["cell_flat"]
            out.cell_types = d["cell_types"]
            out.point_data = d["point_data"]
            out.cell_data = d["cell_data"]
            return out

    # Header: 4 lines (version, title, format, DATASET ...)
    head_end = 0
    lines_found = 0
    while lines_found < 3 and head_end < len(raw):
        if raw[head_end:head_end + 1] == b"\n":
            lines_found += 1
        head_end += 1
    head_lines = raw[:head_end].decode("ascii", "replace").split("\n")
    # Only line 3 is the format line (VTK legacy spec); line 2 is a
    # free-text title that may legitimately contain the word "binary".
    is_binary = (len(head_lines) >= 3
                 and head_lines[2].strip().upper() == "BINARY")

    out = VTKData()

    if is_binary:
        _parse_binary(raw, head_end, out)
    else:
        text = raw.decode("ascii", "replace")
        _parse_ascii(text.split("\n"), out)
    return out


def _parse_ascii(lines, out: VTKData):
    i = 0
    n_points_data = 0
    section = None  # POINT_DATA | CELL_DATA
    while i < len(lines):
        parts = lines[i].split()
        if not parts:
            i += 1
            continue
        key = parts[0].upper()
        if key == "POINTS":
            n = int(parts[1])
            flat, i = _read_ascii_numbers(lines, i + 1, n * 3)
            out.points = flat.reshape(n, 3).astype(np.float32)
            continue
        if key in ("CELLS", "POLYGONS"):
            n, sz = int(parts[1]), int(parts[2])
            flat, i = _read_ascii_numbers(lines, i + 1, sz, int)
            _set_prefixed_cells(out, flat.astype(np.int64), n)
            continue
        if key == "CELL_TYPES":
            n = int(parts[1])
            flat, i = _read_ascii_numbers(lines, i + 1, n, int)
            out.cell_types = flat.astype(np.int64)
            continue
        if key == "POINT_DATA":
            section = "point"
            n_points_data = int(parts[1])
            i += 1
            continue
        if key == "CELL_DATA":
            section = "cell"
            n_points_data = int(parts[1])
            i += 1
            continue
        if key in ("SCALARS", "VECTORS", "NORMALS"):
            name = parts[1]
            ncomp = 3 if key in ("VECTORS", "NORMALS") else (
                int(parts[3]) if len(parts) > 3 else 1
            )
            i += 1
            if key == "SCALARS" and i < len(lines) and \
                    lines[i].upper().startswith("LOOKUP_TABLE"):
                i += 1
            flat, i = _read_ascii_numbers(lines, i, n_points_data * ncomp)
            arr = flat.reshape(n_points_data, ncomp).astype(np.float32)
            (out.point_data if section == "point" else out.cell_data)[name] = arr
            continue
        i += 1


def _parse_binary(raw: bytes, pos: int, out: VTKData):
    n_data = 0
    section = None

    def next_line():
        nonlocal pos
        end = raw.index(b"\n", pos)
        line = raw[pos:end].decode("ascii", "replace")
        pos = end + 1
        return line

    def read_block(count, vtk_type):
        nonlocal pos
        dt, _, size = _DTYPES[vtk_type.lower()]
        arr = np.frombuffer(raw, dtype=dt, count=count, offset=pos)
        pos += count * size
        if raw[pos:pos + 1] == b"\n":
            pos += 1
        return arr

    while pos < len(raw):
        try:
            line = next_line()
        except ValueError:
            break
        parts = line.split()
        if not parts:
            continue
        key = parts[0].upper()
        if key == "POINTS":
            n = int(parts[1])
            out.points = read_block(n * 3, parts[2]).reshape(n, 3).astype(np.float32)
        elif key in ("CELLS", "POLYGONS"):
            n, sz = int(parts[1]), int(parts[2])
            flat = read_block(sz, "int").astype(np.int64)
            _set_prefixed_cells(out, flat, n)
        elif key == "CELL_TYPES":
            n = int(parts[1])
            out.cell_types = read_block(n, "int").astype(np.int64)
        elif key == "POINT_DATA":
            section, n_data = "point", int(parts[1])
        elif key == "CELL_DATA":
            section, n_data = "cell", int(parts[1])
        elif key in ("SCALARS", "VECTORS", "NORMALS"):
            name = parts[1]
            vtk_type = parts[2] if len(parts) > 2 else "float"
            ncomp = 3 if key in ("VECTORS", "NORMALS") else (
                int(parts[3]) if len(parts) > 3 else 1
            )
            if key == "SCALARS":
                peek = raw[pos:pos + 32].decode("ascii", "replace")
                if peek.upper().startswith("LOOKUP_TABLE"):
                    next_line()
            arr = read_block(n_data * ncomp, vtk_type)
            arr = arr.reshape(n_data, ncomp).astype(np.float32)
            (out.point_data if section == "point" else out.cell_data)[name] = arr
        elif key == "LOOKUP_TABLE":
            continue


def _set_prefixed_cells(out: VTKData, flat: np.ndarray, n_cells: int):
    """Decode the count-prefixed connectivity stream into sizes + flat ids.

    Fast path for homogeneous cell sizes (the common case: all-quad /
    all-hex car meshes) — a single reshape instead of a python loop."""
    if n_cells == 0:
        out.cell_sizes = np.zeros(0, np.int64)
        out.cell_flat = np.zeros(0, np.int64)
        return
    c0 = int(flat[0])
    if len(flat) == n_cells * (c0 + 1):
        grid = flat.reshape(n_cells, c0 + 1)
        if (grid[:, 0] == c0).all():
            out.cell_sizes = np.full(n_cells, c0, np.int64)
            out.cell_flat = np.ascontiguousarray(grid[:, 1:]).reshape(-1)
            return
    sizes, ids = [], []
    i = 0
    for _ in range(n_cells):
        cnt = int(flat[i])
        sizes.append(cnt)
        ids.append(flat[i + 1:i + 1 + cnt])
        i += 1 + cnt
    out.cell_sizes = np.asarray(sizes, np.int64)
    out.cell_flat = (np.concatenate(ids) if ids
                     else np.zeros(0, np.int64))


def write_vtk_ascii_polydata(path: str, points: np.ndarray,
                             polys: np.ndarray,
                             point_data: dict | None = None):
    """Tiny writer (round-trip tests / exporting predictions)."""
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\nhaet_torch\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {len(points)} float\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
        n, k = polys.shape
        f.write(f"POLYGONS {n} {n * (k + 1)}\n")
        for c in polys:
            f.write(str(k) + " " + " ".join(str(int(v)) for v in c) + "\n")
        if point_data:
            f.write(f"POINT_DATA {len(points)}\n")
            for name, arr in point_data.items():
                arr = np.asarray(arr)
                if arr.ndim == 1 or arr.shape[1] == 1:
                    f.write(f"SCALARS {name} float 1\nLOOKUP_TABLE default\n")
                    for v in arr.reshape(-1):
                        f.write(f"{v}\n")
                else:
                    f.write(f"VECTORS {name} float\n")
                    for v in arr:
                        f.write(" ".join(str(x) for x in v) + "\n")
