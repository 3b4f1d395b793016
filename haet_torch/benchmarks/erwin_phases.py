"""Per-phase cycle counts of the fused Erwin block kernels on the card.

    python -m haet_torch.benchmarks.erwin_phases [--reps 50]

The card has no ``ncu`` or ``nsys``, so this driver reads the phases of
``csrc/erwin_block.cu`` from inside: it builds a copy of the source in
which thread 0 of every CTA reads ``clock64()`` at kernel entry and on
both sides of every cluster barrier (``Ctx::sync``), runs the forward and
the backward at the car's two block shapes (8 clouds, 8 heads, SwiGLU 4C),
and prints, per kernel, the median over the CTAs of each segment in SM
cycles: ``[entry .. first barrier, barrier, phase, barrier, ...]``, beside
the kernel's device time per call from the profiler (of the instrumented
build, which costs a few cycles per barrier). The instrumented library goes
to ``haet_torch/_build/`` and is used by this process only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch

from ..ops.kernels import _build
from ..ops.kernels import erwin_block as eb
from .erwin_kernels import SHAPES, _inputs, card_line, kernel_us

#: records per CTA: entry, and two per cluster barrier (9 in the backward)
SLOTS = 32
MAX_CTAS = 512


def instrumented_source() -> str:
    """``erwin_block.cu`` with the clock reads and ``haet_trace_read``."""
    src = (_build.CSRC / "erwin_block.cu").read_text()
    edits = [
        ("namespace cg = cooperative_groups;\n",
         "namespace cg = cooperative_groups;\n"
         f"__device__ unsigned long long g_trace[2][{MAX_CTAS}][{SLOTS}];\n"),
        ("  bool spilled_shared;   // an exchanged buffer lives in the global"
         " scratch\n",
         "  bool spilled_shared;\n  unsigned long long* tr;\n  int* tc;\n"),
        ("    if (spilled_shared) __threadfence();\n"
         "    cg::this_cluster().sync();\n"
         "    if (spilled_shared) __threadfence();\n",
         "    if (threadIdx.x == 0) tr[(*tc)++] = clock64();\n"
         "    if (spilled_shared) __threadfence();\n"
         "    cg::this_cluster().sync();\n"
         "    if (spilled_shared) __threadfence();\n"
         "    if (threadIdx.x == 0) tr[(*tc)++] = clock64();\n"),
        ("  for (int b = 0; b < nshared; ++b) x.spilled_shared |= "
         "!L.in_smem[b];\n",
         "  for (int b = 0; b < nshared; ++b) x.spilled_shared |= "
         "!L.in_smem[b];\n"
         "  __shared__ int s_tc;\n  x.tc = &s_tc;\n"
         f"  x.tr = g_trace[nshared - 3][blockIdx.x % {MAX_CTAS}];\n"
         "  if (threadIdx.x == 0) { s_tc = 0; x.tr[s_tc++] = clock64(); }\n"),
        ('extern "C" {\n',
         'extern "C" {\nint haet_trace_read(unsigned long long* dst) {\n'
         "  return static_cast<int>(\n"
         "      cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));\n}\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"erwin_block.cu changed: cannot instrument "
                               f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def build() -> ctypes.CDLL:
    """Build and load the instrumented library."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "erwin_block_phases.cu"
    so = _build.BUILD_DIR / "liberwin_block_phases.so"
    cu.write_text(instrumented_source())
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.haet_error_string.argtypes = [ctypes.c_int]
    lib.haet_error_string.restype = ctypes.c_char_p
    lib.haet_trace_read.argtypes = [ctypes.c_void_p]
    return lib


def segments(buf, kind: int, ctas: int) -> list:
    """Median over the CTAs of each segment between consecutive reads."""
    rows = []
    for b in range(ctas):
        base = (kind * MAX_CTAS + b) * SLOTS
        t = [buf[base + j] for j in range(SLOTS)]
        end = next((j for j in range(1, SLOTS) if t[j] == 0), SLOTS)
        rows.append([t[j] - t[j - 1] for j in range(1, end)])
    return [statistics.median(r[j] for r in rows)
            for j in range(min(len(r) for r in rows))]


def run(reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("erwin_phases: no CUDA device")
    lib = build()
    _build._libs["erwin_block"] = lib   # the wrappers launch the copy
    buf = (ctypes.c_ulonglong * (2 * MAX_CTAS * SLOTS))()
    dev = torch.device("cuda")
    out = {}
    for i, tag in enumerate(("car_n32_c32", "car_n16_c64")):
        x, pos, dout, params, kw = _inputs(eb, dev, SHAPES[tag], i)
        calls = {
            "fwd": (lambda: eb.fused_erwin_block(x, pos, params, **kw),
                    ("erwin_block_fwd",)),
            "bwd": (lambda: eb.fused_erwin_block_bwd(x, pos, dout, params,
                                                     **kw),
                    ("erwin_block_bwd",)),
        }
        for kind, (name, (fn, names)) in enumerate(calls.items()):
            us = kernel_us(fn, reps, names)[0]
            fn()
            torch.cuda.synchronize()
            lib.haet_trace_read(ctypes.addressof(buf))
            seg = segments(buf, kind, SHAPES[tag][0] * eb.CLUSTER)
            out[f"{tag}_{name}"] = {"device_us": us, "cycles": seg,
                                    "total_cycles": sum(seg)}
            print(f"{tag} {name}: device {us:.2f} us per call; cycles "
                  f"{sum(seg):.0f}: {seg}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    res = run(args.reps)
    print(card_line())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
