"""Where the slice kernels' time goes, from inside, on the card.

    python -m haet_torch.benchmarks.slice_phases [--reps 30]

The card has no ``ncu`` or ``nsys``, so this driver builds
``csrc/slice_kernels.cu`` twice more, with the source's own switches, and
runs the fast ``slice_states`` and ``deslice`` at serve batch 1 (``[1, 8,
32186, 32]``, G 32):

* ``clock`` (``-DHAET_SLICE_TRACE``): lane 0 of every warp reads
  ``clock64()`` and records, in SM cycles, its start (entry to the main
  loop: staging the weights and building the fragments), its waits for the
  x ring (``cp.async``), its compute (everything else in the loop, the
  issue of the next tile's loads included) and its tail: for slice_states
  its block's log-sum-exp merge up to the partial's write (the last
  block's merge of the cloud is not in it), for deslice its last wait;
  printed as medians over the warps;
* ``no_mma`` (``-DHAET_SLICE_NO_MMA``): every ``mma.sync`` replaced by one
  integer and one float operation on the same registers, so that the data
  flow stays: the time without the tensor-core passes.

Both are timed beside the regular build, device us per call from the
profiler with the L2 flushed before each call
(:func:`haet_torch.benchmarks.slice_kernels.flushed_us`), and so are the
backward kernels (``slice_states_bwd``, ``deslice_bwd``: every kernel of
the call) at the padded training batch ``[1, 8, 32768, 32]``. The extra
libraries go to ``haet_torch/_build/``; the slice wrappers use them only
inside :func:`routed`.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess

import torch

from ..ops.kernels import _build
from ..ops.kernels import slice_kernels as sk
from .slice_kernels import SHAPES, card_line, flushed_us, grads, inputs

#: blocks and warps per block the trace build records (``TRACE_CTAS``,
#: ``WARPS`` in the CUDA source)
TRACE_CTAS = 512
TRACE_WARPS = 8
SEGMENTS = ("start", "wait", "compute", "tail")
#: the builds beside the regular one: name -> nvcc defines
VARIANTS = {"no_mma": ("HAET_SLICE_NO_MMA",),
            "clock": ("HAET_SLICE_TRACE",)}


def build(name: str) -> ctypes.CDLL:
    """Build and load ``slice_kernels.cu`` with the defines of variant
    ``name``, its argument types set."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"libslice_kernels_{name}.so"
    defines = [f"-D{d}" for d in VARIANTS[name]]
    src = _build.CSRC / "slice_kernels.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
                          "-o", str(so), str(src)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on slice_kernels.cu {defines}:\n"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.haet_error_string.argtypes = [ctypes.c_int]
    lib.haet_error_string.restype = ctypes.c_char_p
    return sk.typed(lib)


@contextlib.contextmanager
def routed(lib):
    """The slice wrappers launch from ``lib`` (None: the regular build)
    inside the block."""
    regular = sk._lib
    if lib is not None:
        sk._lib = lambda: lib
    try:
        yield
    finally:
        sk._lib = regular


def run(reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("slice_phases: no CUDA device")
    dev = torch.device("cuda")
    libs = {"kernels": None, **{name: build(name) for name in VARIANTS}}
    shape = SHAPES["serve_b1"]
    x, ws, bs, wa, ba, st = inputs(shape, dev)
    b, h, n, c, g = shape
    ctas = {k: min(TRACE_CTAS, sk.launch_geometry(k, b * h, n, c, g,
                                                  sk.sm_count(dev)).per_cloud
                   * b * h) for k in ("slice_states", "deslice")}
    res = {"card": card_line(), "us": {}}
    with torch.inference_mode():
        _, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        fns = {"slice_states": lambda: sk.slice_states(x, ws, bs, wa, ba),
               "deslice": lambda: sk.deslice(x, ws, bs, wa, ba, st, m, s)}
        xb, wsb, bsb, wab, bab, stb = inputs(SHAPES["train_b1"], dev)
        g_st, g_out = grads(SHAPES["train_b1"], dev)
        states_b, m_b, s_b = sk.slice_states_plain(xb, wsb, bsb, wab, bab)
        bwd = {"slice_states_bwd": lambda: sk.slice_states_bwd(
                   xb, wsb, bsb, wab, bab, states_b, m_b, s_b, g_st),
               "deslice_bwd": lambda: sk.deslice_bwd(
                   xb, wsb, bsb, wab, bab, stb, m_b, s_b, g_out)}
        for name, lib in libs.items():
            with routed(lib):
                res["us"][name] = {k: flushed_us(fn, reps)[0]
                                   for k, fn in fns.items()}
                res["us"][name].update({k: flushed_us(fn, reps, None)[0]
                                        for k, fn in bwd.items()})
        buf = (ctypes.c_ulonglong * (2 * TRACE_CTAS * TRACE_WARPS * 4))()
        with routed(libs["clock"]):
            for fn in fns.values():  # one more call each: the records read
                fn()
            torch.cuda.synchronize()
        if libs["clock"].haet_trace_read(buf) != 0:
            raise RuntimeError("haet_trace_read failed")
    res["cycles"] = {}
    for k, kernel in enumerate(fns):
        recs = [[buf[((k * TRACE_CTAS + cta) * TRACE_WARPS + w) * 4 + i]
                 for i in range(4)]
                for cta in range(ctas[kernel]) for w in range(TRACE_WARPS)]
        res["cycles"][kernel] = {
            seg: statistics.median(r[i] for r in recs)
            for i, seg in enumerate(SEGMENTS)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    res = run(args.reps)
    for name, us in res["us"].items():
        print(f"{name:8s} device us/call  " + "  ".join(
            f"{k} {v:7.2f}" for k, v in us.items()), flush=True)
    for kernel, seg in res["cycles"].items():
        print(f"{kernel:12s} median cycles per warp: " + "  ".join(
            f"{k} {v:.0f}" for k, v in seg.items()), flush=True)
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
