"""Device time per call of the slice kernels; an A/B of two trees.

    python -m haet_torch.benchmarks.slice_kernels
    python -m haet_torch.benchmarks.slice_kernels --ab PARENT_DIR [--rounds 2]

Times ``slice_states`` and ``deslice`` and their backwards
(``slice_states_bwd``, ``deslice_bwd``: :data:`KINDS`) on one card at the
shapes of :data:`SHAPES` (serve batch 1, the serve burst's batch of 4, the
padded training batch, and the NS preset's G 64 at C 32, the widest slices
of the presets), from a ``torch.profiler`` trace of ``--reps`` calls with
the 50 MB L2 cache flushed before each (a 64 MB pass of ``bitwise_not``,
which the sum leaves out): the device time of every kernel whose name
contains "slice" (the forwards) or of every kernel the call launches (the
backwards, whose parent versions are chunked PyTorch), divided by the
calls, with the kernels' names. The CUDA-event time of back-to-back calls
(no flush) is printed beside it. The bound of each call is computed from
its shape (:func:`bound_us`).

``--ab PARENT_DIR`` times the ``haet_torch`` under ``PARENT_DIR`` (for
example a ``git archive`` of the parent commit) and this one in turns, each
in a process of its own (parent, this, this, parent per round), and prints
every run and the medians beside the card's name and power limit. Inputs
are seeded; the kernels are not compared with anything here
(``chip_smoke.py`` does that).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

#: ``tag: (B, H, N, C, G)``: the car model's (G 32, C 32) and the NS
#: preset's training batch (``ns_config``: 64 x 64 points, batch 2, n_hidden
#: 256 over 8 heads, 64 slices)
SHAPES = {
    "serve_b1": (1, 8, 32186, 32, 32),
    "burst_b4": (4, 8, 32186, 32, 32),
    "train_b1": (1, 8, 32768, 32, 32),
    "ns_b2": (2, 8, 4096, 32, 64),
}
THIS_ROOT = Path(__file__).resolve().parents[2]
#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s outside
#: the tensor cores, dense TF32 FLOP/s of the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
#: tensor-core passes per float32 product in 3xTF32
TF32_PASSES = 3
#: bytes written before each timed call, more than the card's 50 MB L2
FLUSH_BYTES = 64 << 20


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: the timed functions: the two forwards and their backwards
KINDS = ("slice_states", "deslice", "slice_states_bwd", "deslice_bwd")


#: the products of each call: ``(width, operands)``, ``width`` the
#: multiply-adds per point (``"cg"`` C·G, ``"c"`` C) and ``operands`` how
#: many of its two operands take ``x_proj``'s dtype (``x_proj``, the
#: states, the gradients ``g_out`` and ``g_states``; the rest are float32).
#: Forwards: the logits (``x Ws``), the weighted sum ``E^T x`` or the output
#: ``W states``, and ``tau`` (``x Wa``). slice_states_bwd: the logits,
#: ``x G^T``, ``w G^``, ``dpre Ws^T``, ``x^T dpre``, and ``tau``, ``draw
#: Wa^T``, ``x^T draw``. deslice_bwd, two passes: the logits and ``g_out
#: states^T`` in both, ``w^T g_out`` in the first, ``dpre Ws^T`` and ``x^T
#: dpre`` in the second, ``tau`` twice, ``draw Wa^T`` and ``x^T draw``.
PRODUCTS = {
    "slice_states": (("cg", 1), ("cg", 1), ("c", 1)),
    "deslice": (("cg", 1), ("cg", 1), ("c", 1)),
    "slice_states_bwd": (("cg", 1), ("cg", 2), ("cg", 1), ("cg", 0),
                         ("cg", 1), ("c", 1), ("c", 0), ("c", 1)),
    "deslice_bwd": (("cg", 1), ("cg", 1), ("cg", 2), ("cg", 2), ("cg", 1),
                    ("cg", 0), ("cg", 1), ("c", 1), ("c", 1), ("c", 0),
                    ("c", 1)),
}


def tf32_passes(operands: int, isz: int) -> float:
    """Tensor-core time of one product in TF32 passes, exact for its
    operand types: 3xTF32 for float32 operands (three passes); a bf16
    operand is exact in TF32, so the low part of its split is zero and two
    passes remain; two bf16 operands take one bf16 pass, at twice the TF32
    rate."""
    if isz == 4:
        return TF32_PASSES
    return (TF32_PASSES, 2, 0.5)[operands]


def work(kind: str, b: int, h: int, n: int, c: int, g: int, isz: int = 4):
    """``(bytes, FLOP, TF32 FLOP)`` of one call: each input read once,
    each output written once, ``x_proj`` and the tensors in its dtype (the
    states, ``out``, the gradients ``g_out``, ``dx``, ``dstates`` and the
    states' gradient) ``isz`` bytes an element (4 float32, 2 bf16), the
    rest float32 (slice_states writes its float32 states, the residual, and
    with bf16 their bf16 copy); 2 FLOP per multiply-add of the call's
    :data:`PRODUCTS`, and those FLOP weighted by their :func:`tf32_passes`.
    slice_states_bwd reads x, the parameters, the states, their gradient
    and ``(m, s)`` and writes dx and the parameters' gradients; deslice_bwd
    reads x and g_out and writes dx and dstates as well."""
    bh = b * h
    params = 4 * (c * g + g + c + 1)
    rows = isz * bh * n * c      # one [B, H, N, C] tensor
    st = bh * g * c              # the states' elements
    ms = 4 * 2 * bh * g          # m and s
    width = {"cg": c * g, "c": c}
    flops = sum(2 * bh * n * width[w] for w, _ in PRODUCTS[kind])
    tf32 = sum(2 * bh * n * width[w] * tf32_passes(k, isz)
               for w, k in PRODUCTS[kind])
    if kind == "slice_states":
        nbytes = rows + params + 4 * st + (isz if isz != 4 else 0) * st + ms
    elif kind == "deslice":
        nbytes = 2 * rows + params + isz * st + ms
    elif kind == "slice_states_bwd":   # x, dx; the float32 states, g_states
        nbytes = 2 * rows + 2 * params + 4 * st + ms + isz * st
    else:
        nbytes = 3 * rows + 2 * params + 2 * isz * st + ms
    return nbytes, flops, tf32


def bound_us(kind: str, shape, float32_only: bool = False,
             isz: int = 4) -> tuple:
    """``(us, "bytes" or "operations")``: the least time the card could
    take for one call, the larger of the bytes' time and the operations'
    at the fastest rate of a precision the port accepts for them: on the
    tensor cores, each product in the passes its operand types need
    (:func:`tf32_passes`), or float32 FMA, whichever is faster.
    ``float32_only``: the bound at the float32 FMA rate alone, printed as
    context."""
    nbytes, flops, tf32 = work(kind, *shape, isz=isz)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e6
    t_ops = flops / F32_FLOP_PER_S * 1e6
    if not float32_only:
        t_ops = min(t_ops, tf32 / TF32_FLOP_PER_S * 1e6)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def inputs(shape, dev, seed: int = 0, scaled: bool = True):
    """Seeded ``(x, ws, bs, wa, ba, states)`` of one shape, as
    ``chip_smoke.py`` draws them: at C = 32, ``ws`` 0.3 N(0, 1) and ``wa``
    0.1 N(0, 1); at other widths, if ``scaled``, both times ``sqrt(32 /
    C)``, so that the logits and the temperature keep the car's spread
    (unscaled, C = 128 clamps most temperatures to 0.1 and pushes logits
    past 100, where float32 itself loses digits: ``chip_smoke.py`` holds
    that case to a float64 reference)."""
    b, h, n, c, g = shape
    gen = torch.Generator().manual_seed(seed)
    k = math.sqrt(32 / c) if scaled else 1.0
    x = torch.randn(b, h, n, c, generator=gen).to(dev)
    ws = (0.3 * k * torch.randn(c, g, generator=gen)).to(dev)
    bs = (0.1 * torch.randn(g, generator=gen)).to(dev)
    wa = (0.1 * k * torch.randn(c, 1, generator=gen)).to(dev)
    ba = torch.zeros(1).to(dev)
    st = torch.randn(b, h, g, c, generator=gen).to(dev)
    return x, ws, bs, wa, ba, st


def grads(shape, dev, seed: int = 0):
    """Seeded ``(dL/dstates, dL/dout)`` of one shape."""
    b, h, n, c, g = shape
    gen = torch.Generator().manual_seed(seed + 1000)
    return (torch.randn(b, h, g, c, generator=gen).to(dev),
            torch.randn(b, h, n, c, generator=gen).to(dev))


def flushed_us(fn, reps: int, names=("slice",)) -> tuple:
    """``(device us per call, kernel names)`` of ``fn()`` from a profiler
    trace of ``reps`` calls, each after a pass of ``bitwise_not`` over
    :data:`FLUSH_BYTES`: the kernels whose names contain one of ``names``,
    or every kernel but the flush's when ``names`` is None."""
    from ..utils.profiling import device_trace

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda", dtype=torch.int32)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with device_trace() as prof:
        for _ in range(reps):
            torch.bitwise_not(flush, out=flush)
            fn()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)
              and "bitwise_not" not in e.key
              and (names is None or any(nm in e.key for nm in names))]
    total = sum(e.self_device_time_total for e in events)
    return total / reps, sorted({e.key[:72] for e in events})


def event_us(fn, reps: int) -> float:
    """CUDA-event us per call of ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / reps


def measure(root: Path, reps: int) -> dict:
    """``{tag: {kernel: {us, event_us, names}}}`` for the ``haet_torch``
    under ``root``."""
    if not torch.cuda.is_available():
        raise SystemExit("slice_kernels: no CUDA device")
    sys.path.insert(0, str(root))
    from haet_torch.ops.kernels import _build
    from haet_torch.ops.kernels import slice_kernels as sk

    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for i, (tag, shape) in enumerate(SHAPES.items()):
        x, ws, bs, wa, ba, st = inputs(shape, dev, i)
        g_st, g_out = grads(shape, dev, i)
        with torch.inference_mode():
            states, m, s = sk.slice_states(x, ws, bs, wa, ba)
            fns = {"slice_states": lambda: sk.slice_states(x, ws, bs, wa, ba),
                   "deslice": lambda: sk.deslice(x, ws, bs, wa, ba, st, m, s),
                   "slice_states_bwd": lambda: sk.slice_states_bwd(
                       x, ws, bs, wa, ba, states, m, s, g_st),
                   "deslice_bwd": lambda: sk.deslice_bwd(
                       x, ws, bs, wa, ba, st, m, s, g_out)}
            out[tag] = {}
            for kind, fn in fns.items():
                us, names = flushed_us(
                    fn, reps, None if kind.endswith("_bwd") else ("slice",))
                out[tag][kind] = {"us": us, "event_us": event_us(fn, reps),
                                  "names": names}
        del x, st, g_out
        torch.cuda.empty_cache()
    return out


def run_tree(root: Path, reps: int) -> dict:
    """:func:`measure` in a fresh process, so that two trees' packages of
    the same name never meet."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--root", str(root),
         "--reps", str(reps)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"slice_kernels on {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def medians(runs: list) -> dict:
    return {tag: {kind: statistics.median(r[tag][kind]["us"] for r in runs)
                  for kind in runs[0][tag]} for tag in runs[0]}


def ab(parent: Path, rounds: int, reps: int) -> dict:
    runs = {"parent": [], "this": []}
    for r in range(rounds):
        for side in ("parent", "this", "this", "parent"):
            res = run_tree(parent if side == "parent" else THIS_ROOT, reps)
            runs[side].append(res)
            print(f"round {r + 1} {side}: {json.dumps(res)}", flush=True)
    med = {side: medians(rs) for side, rs in runs.items()}
    for tag, shape in SHAPES.items():
        for kind in KINDS:
            p, t = med["parent"][tag][kind], med["this"][tag][kind]
            bound, by = bound_us(kind, shape)
            f32, f32_by = bound_us(kind, shape, float32_only=True)
            print(f"{tag:9s} {kind:16s} device us/call {p:8.2f} -> {t:8.2f}"
                  f"  ({p / t:.2f}x)   bound {bound:.2f} ({by}; "
                  f"{bound / t:.0%} of it; float32 FMA alone {f32:.2f}, "
                  f"{f32_by})",
                  flush=True)
    return {"card": card_line(), "runs": runs, "medians": med}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=THIS_ROOT,
                    help="directory holding the haet_torch to time")
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR",
                    help="time PARENT_DIR's haet_torch and this one in turns")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if args.ab is not None:
        res = ab(args.ab.resolve(), args.rounds, args.reps)
        print(res["card"])
        print(json.dumps(res["medians"]))
    else:
        print(json.dumps(measure(args.root.resolve(), args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
