"""Build ``haet_torch/csrc/*.cu`` with ``nvcc`` at first use; load with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes). The library lands in
``haet_torch/_build/`` (listed in ``.gitignore``) under a name that carries
a hash of the source, the headers beside it and the flags, so an edited
source is rebuilt and a stale one never loaded. A failed build raises with
``nvcc``'s stderr.

:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("slice_kernels", "erwin_block", "copy_kernel")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, ``PATH``, or the CUDA
    toolkit's default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library is already built;
    returns ``(proc, tmp, out)`` or ``None``."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for a build started by :func:`_start`; returns nvcc's report."""
    if started is None:
        return ""
    proc, tmp, out = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{stderr}{stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return stderr + stdout


def build_all() -> dict:
    """Build every kernel source in parallel (one ``nvcc`` each); returns
    ``{name: nvcc output}`` (ptxas register/shared-memory report), empty
    for a source that was already built."""
    with _lock:
        started = {name: _start(name) for name in SOURCES}
        reports, errors = {}, []
        for name, st in started.items():
            try:
                reports[name] = _finish(name, st)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            lib.haet_error_string.argtypes = [ctypes.c_int]
            lib.haet_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch: "
                           f"{lib.haet_error_string(status).decode()}")
