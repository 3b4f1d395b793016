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
(:func:`haet_torch.benchmarks.slice_kernels.flushed_us`).

The backwards (``slice_states_bwd``, ``deslice_bwd``) are broken down at
:data:`BWD_SHAPES` (the padded training batch ``[1, 8, 32768, 32]`` G 32,
the Darcy preset's ``[4, 8, 7225, 16]`` G 64 and the NS preset's ``[2, 8,
4096, 32]`` G 64) in float32 (``slice_bwd_f32``, a launch per pass, or per
window of the NS chain, and a sum after each pass) and bf16
(``slice_bwd_fused``, one launch): for each build, every CUDA launch of one
call with its device us and the idle gap before the next launch of the call
(:func:`launch_trace`); and from the ``clock`` build, per pass (the first
pass's sums, then the chain; of a chain launched per window, the last
window's), the median cycles per warp of :data:`BWD_SEGMENTS`: its start
(staging the operand tables), its waits for the ring, ``load`` (the
temperatures, and in bf16 the tile's widening and the fragments),
``products`` (the logits and the dw product; in bf16 also the softmax
arithmetic and the dx products, slice block by slice block), ``chain``
(float32: the softmax arithmetic; both: sum_g dlogit * logit and draw),
``dpre`` (float32: the dx products; both: dpre or w through shared memory
and the row-contracted products), ``store`` (dx out) and the tail (the
block's partial sums and, where the pass has one, its merge). It prints
the registers and spill bytes of every backward instantiation from the
regular build's ``ptxas -v`` report (:func:`register_report`). The extra
libraries go to ``haet_torch/_build/``; the slice wrappers use them only
inside :func:`routed`.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops.kernels import _build
from ..ops.kernels import slice_kernels as sk
from .slice_kernels import (FLUSH_BYTES, SHAPES, card_line, flushed_us,
                            grads, inputs)

#: blocks and warps per block the trace build records (``TRACE_CTAS``,
#: ``WARPS`` in the CUDA source)
TRACE_CTAS = 512
TRACE_WARPS = 8
#: warps per block of the backward records (``FW`` in the source: the
#: float32 backward's; the fused kernel's 8 fill the first of them)
BWD_TRACE_WARPS = 16
SEGMENTS = ("start", "wait", "compute", "tail")
#: the backward's segments per warp and pass (``BWD_SEGS`` in the source)
BWD_SEGMENTS = ("start", "wait", "load", "products", "chain", "dpre",
                "store", "tail")
#: the backwards' passes by their trace index (the kernel's mode)
BWD_PASSES = {"slice_states_bwd": (("sums", 3), ("chain", 0)),
              "deslice_bwd": (("sums", 1), ("chain", 2))}
#: the backward breakdown's shapes (``slice_kernels.SHAPES``) and dtypes
BWD_SHAPES = ("train_b1", "darcy_b4", "ns_b2")
BWD_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
#: the builds beside the regular one: name -> nvcc defines
VARIANTS = {"no_mma": ("HAET_SLICE_NO_MMA",),
            "clock": ("HAET_SLICE_TRACE",)}


def register_report(ptxas: str, pattern: str = "slice_bwd") -> list:
    """``[(kernel, registers, spill stores, spill loads)]`` of every entry
    point whose (demangled) name contains ``pattern``, from ``ptxas -v``'s
    report of a build."""
    rows, name, spills = [], None, (0, 0)
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _demangle(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            if pattern in name:
                rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


def _demangle(symbol: str) -> str:
    """``symbol`` demangled by the toolkit's ``cu++filt``, where there is
    one."""
    try:
        tool = Path(_build.nvcc_path()).with_name("cu++filt")
    except RuntimeError:
        return symbol
    if not tool.exists():
        return symbol
    out = subprocess.run([str(tool), symbol], capture_output=True, text=True)
    return out.stdout.strip() or symbol


def _short(name: str) -> str:
    """A profiler kernel name without its return type, namespace and
    arguments: ``slice_bwd_f32<32, 1, 0>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def compile_variant(name: str) -> tuple:
    """``slice_kernels.cu`` compiled with the defines of variant ``name``
    (none for "regular"): ``(library path, ptxas report)``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / f"libslice_kernels_{name}.so"
    defines = [f"-D{d}" for d in VARIANTS.get(name, ())]
    src = _build.CSRC / "slice_kernels.cu"
    out = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *defines,
                          "-o", str(so), str(src)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on slice_kernels.cu {defines}:\n"
                           f"{out.stderr}")
    return so, out.stderr + out.stdout


def build(name: str) -> ctypes.CDLL:
    """Build and load ``slice_kernels.cu`` with the defines of variant
    ``name``, its argument types set."""
    so, _ = compile_variant(name)
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


def launch_trace(fn, reps: int) -> dict:
    """Every CUDA launch of one call of ``fn()``, from a device trace of
    ``reps`` calls, each after the L2 flush: ``{"names": [...], "us": [...]
    (median device us per launch, in launch order), "gaps_us": [...]
    (median idle us from one launch's end to the next one's start within
    the call), "span_us": median first start to last end, "total_us": the
    launches' sum}``."""
    from ..utils.profiling import device_trace

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda", dtype=torch.int32)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with device_trace(host=False) as prof:
        for _ in range(reps):
            torch.bitwise_not(flush, out=flush)
            fn()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    calls, cur = [], None
    for e in kernels:
        if "bitwise_not" in e.name:
            cur = []
            calls.append(cur)
        elif cur is not None:
            cur.append(e)
    k = len(calls[-1])
    calls = [c for c in calls if len(c) == k]
    med = statistics.median
    us = [med(c[i].time_range.elapsed_us() for c in calls) for i in range(k)]
    return {"names": [e.name[:64] for e in calls[-1]], "us": us,
            "gaps_us": [med(c[i + 1].time_range.start - c[i].time_range.end
                            for c in calls) for i in range(k - 1)],
            "span_us": med(c[-1].time_range.end - c[0].time_range.start
                           for c in calls),
            "total_us": sum(us)}


def bwd_calls(tag: str, dtype, dev) -> dict:
    """``{kind: fn}``: one call of each backward at ``SHAPES[tag]`` with
    ``x_proj`` (and the states and gradients) in ``dtype``."""
    shape = SHAPES[tag]
    x, ws, bs, wa, ba, st = inputs(shape, dev)
    g_st, g_out = grads(shape, dev)
    x, st, g_st, g_out = (t.to(dtype) for t in (x, st, g_st, g_out))
    states, m, s = sk.slice_states_plain_f32(x, ws, bs, wa, ba)
    return {"slice_states_bwd": lambda: sk.slice_states_bwd(
                x, ws, bs, wa, ba, states, m, s, g_st),
            "deslice_bwd": lambda: sk.deslice_bwd(
                x, ws, bs, wa, ba, st, m, s, g_out)}


def bwd_cycles(lib, fns: dict) -> dict:
    """One call of each backward from the ``clock`` build ``lib``: per
    pass, the median over the recorded warps of each of
    :data:`BWD_SEGMENTS` (cycles)."""
    n = 4 * TRACE_CTAS * BWD_TRACE_WARPS * len(BWD_SEGMENTS)
    buf = (ctypes.c_ulonglong * n)()
    out = {}
    with routed(lib):
        for kind, fn in fns.items():
            if lib.haet_trace_reset_bwd() != 0:
                raise RuntimeError("haet_trace_reset_bwd failed")
            fn()
            torch.cuda.synchronize()
            if lib.haet_trace_read_bwd(buf) != 0:
                raise RuntimeError("haet_trace_read_bwd failed")
            for label, mode in BWD_PASSES[kind]:
                nseg = len(BWD_SEGMENTS)
                base = mode * TRACE_CTAS * BWD_TRACE_WARPS * nseg
                recs = [buf[base + r * nseg:base + (r + 1) * nseg]
                        for r in range(TRACE_CTAS * BWD_TRACE_WARPS)]
                recs = [r for r in recs if any(r)]
                out[f"{kind} {label}"] = {
                    seg: statistics.median(r[i] for r in recs)
                    for i, seg in enumerate(BWD_SEGMENTS)}
                out[f"{kind} {label}"]["warps"] = len(recs)
    return out


def run(reps: int) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("slice_phases: no CUDA device")
    dev = torch.device("cuda")
    with ThreadPoolExecutor(len(VARIANTS) + 2) as pool:  # nvcc in parallel
        regular = pool.submit(_build.build_all)
        # the regular flags once more, for the ptxas report that a cached
        # build of the wrapper's library does not give
        report = pool.submit(compile_variant, "regular")
        built = {name: pool.submit(build, name) for name in VARIANTS}
        regular.result()
        report = report.result()[1]
        libs = {"kernels": None, **{k: f.result() for k, f in built.items()}}
    libs["clock"].haet_trace_read_bwd.argtypes = [ctypes.c_void_p]
    shape = SHAPES["serve_b1"]
    x, ws, bs, wa, ba, st = inputs(shape, dev)
    b, h, n, c, g = shape
    ctas = {k: min(TRACE_CTAS, sk.launch_geometry(k, b * h, n, c, g,
                                                  sk.sm_count(dev)).per_cloud
                   * b * h) for k in ("slice_states", "deslice")}
    res = {"card": card_line(), "us": {}, "bwd": {}, "bwd_cycles": {},
           "registers": register_report(report)}
    with torch.inference_mode():
        _, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        fns = {"slice_states": lambda: sk.slice_states(x, ws, bs, wa, ba),
               "deslice": lambda: sk.deslice(x, ws, bs, wa, ba, st, m, s)}
        for name, lib in libs.items():
            with routed(lib):
                res["us"][name] = {k: flushed_us(fn, reps)[0]
                                   for k, fn in fns.items()}
        buf = (ctypes.c_ulonglong * (2 * TRACE_CTAS * TRACE_WARPS * 4))()
        with routed(libs["clock"]):
            for fn in fns.values():  # one more call each: the records read
                fn()
            torch.cuda.synchronize()
        if libs["clock"].haet_trace_read(buf) != 0:
            raise RuntimeError("haet_trace_read failed")
        for tag in BWD_SHAPES:
            for short, dtype in BWD_DTYPES.items():
                key = f"{tag} {short}"
                calls = bwd_calls(tag, dtype, dev)
                res["bwd"][key] = {}
                for name, lib in libs.items():
                    with routed(lib):
                        res["bwd"][key][name] = {
                            k: launch_trace(fn, reps)
                            for k, fn in calls.items()}
                res["bwd_cycles"][key] = bwd_cycles(libs["clock"], calls)
                del calls
                torch.cuda.empty_cache()
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
    for kernel, regs, stores, loads in res["registers"]:
        print(f"registers {regs:3d}, spill stores {stores} B, loads {loads} "
              f"B: {kernel}", flush=True)
    for name, us in res["us"].items():
        print(f"{name:8s} device us/call  " + "  ".join(
            f"{k} {v:7.2f}" for k, v in us.items()), flush=True)
    for kernel, seg in res["cycles"].items():
        print(f"{kernel:12s} median cycles per warp: " + "  ".join(
            f"{k} {v:.0f}" for k, v in seg.items()), flush=True)
    for key, builds in res["bwd"].items():
        for name, kinds in builds.items():
            for kind, t in kinds.items():
                print(f"{key:13s} {name:8s} {kind:16s} span "
                      f"{t['span_us']:7.2f} us, launches {len(t['us'])}: " + " | ".join(
                          f"{_short(nm)} {u:.2f}"
                          for nm, u in zip(t["names"], t["us"]))
                      + "; gaps " + " ".join(f"{v:.2f}" for v in t["gaps_us"]),
                      flush=True)
        for pas, seg in res["bwd_cycles"][key].items():
            print(f"{key:13s} {pas:22s} median cycles per warp: " + "  ".join(
                f"{k} {v:.0f}" for k, v in seg.items()), flush=True)
    print(res["card"])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
