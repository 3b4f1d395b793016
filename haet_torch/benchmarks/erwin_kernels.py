"""Device time per call of the fused Erwin block kernels; an A/B of two trees.

    python -m haet_torch.benchmarks.erwin_kernels
    python -m haet_torch.benchmarks.erwin_kernels --ab PARENT_DIR [--rounds 2]

Times ``fused_erwin_block`` and ``fused_erwin_block_bwd`` on one card at the
block shapes of :data:`SHAPES` (the car's two, the micro driver's, the two
of ``bench_flags`` and the serve burst's 32 clouds), from a
``torch.profiler`` trace of ``--reps`` back-to-back calls: the kernels' own
device time by name (``erwin_block_fwd``; ``erwin_block_bwd`` plus
``erwin_block_sum_partials``), divided by the calls. Back-to-back calls
are host-bound at these sizes, so the CUDA-event time of the same window
(printed beside it) is the host's launch rate, not the kernel's.

``--ab PARENT_DIR`` times the ``haet_torch`` under ``PARENT_DIR`` (for
example a ``git archive`` of the parent commit) and this one in turns, each
in a process of its own (parent, this, this, parent per round), and prints
every run and the medians beside the card's name and power limit. Each
process builds its tree's kernels first. Inputs are seeded random weights
and points; the kernels are not compared with anything here
(``chip_smoke.py`` does that).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

#: ``tag: (clouds, n, C, ball, heads, SwiGLU hidden)``
SHAPES = {
    "car_n32_c32": (8, 32, 32, 32, 8, 128),
    "car_n16_c64": (8, 16, 64, 16, 8, 256),
    "burst_n32_c32": (32, 32, 32, 32, 8, 128),
    "micro": (8, 32, 32, 32, 4, 128),
    "flags_n32_c32": (8, 32, 32, 32, 4, 64),
    "flags_n16_c64": (8, 16, 64, 16, 8, 128),
}
THIS_ROOT = Path(__file__).resolve().parents[2]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _inputs(eb, dev, shape, seed):
    clouds, n, c, ball, heads, hidden = shape
    g = torch.Generator().manual_seed(seed)
    params = {k: (0.2 * torch.randn(s, generator=g)).to(dev)
              for k, s in eb.param_shapes(c, 3, heads, hidden).items()}
    params["BMSA.sigma_att"].fill_(-1.0)
    x = torch.randn(clouds, n, c, generator=g).to(dev)
    pos = torch.rand(clouds, n, 3, generator=g).to(dev)
    dout = torch.randn(clouds, n, c, generator=g).to(dev)
    return x, pos, dout, params, dict(ball_size=ball, num_heads=heads,
                                      use_dist_bias=True)


def kernel_us(fn, reps: int, names=None):
    """``(device us, CUDA-event us)`` per call of ``fn()`` over ``reps``
    back-to-back calls after 3 warm-ups: the device time of the kernels
    whose names contain one of ``names`` (every kernel when None) from a
    ``torch.profiler`` trace, and the events' time of a second window."""
    from ..utils.profiling import device_trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with device_trace() as prof:
        for _ in range(reps):
            fn()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)
                and (names is None or any(nm in e.key for nm in names)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return total / reps, 1e3 * start.elapsed_time(end) / reps


def measure(root: Path, reps: int) -> dict:
    """``{tag: {fwd_us, fwd_event_us, bwd_us, bwd_event_us}}`` for the
    ``haet_torch`` under ``root``."""
    sys.path.insert(0, str(root))
    from haet_torch.ops.kernels import _build
    from haet_torch.ops.kernels import erwin_block as eb

    if not torch.cuda.is_available():
        raise SystemExit("erwin_kernels: no CUDA device")
    _build.build_all()
    dev = torch.device("cuda")
    out = {}
    for i, (tag, shape) in enumerate(SHAPES.items()):
        x, pos, dout, params, kw = _inputs(eb, dev, shape, i)
        with torch.inference_mode():
            fwd = kernel_us(lambda: eb.fused_erwin_block(
                x, pos, params, **kw), reps, ("erwin_block_fwd",))
        bwd = kernel_us(lambda: eb.fused_erwin_block_bwd(
            x, pos, dout, params, **kw), reps,
            ("erwin_block_bwd", "erwin_block_sum_partials"))
        out[tag] = {"fwd_us": fwd[0], "fwd_event_us": fwd[1],
                    "bwd_us": bwd[0], "bwd_event_us": bwd[1]}
    return out


def run_tree(root: Path, reps: int) -> dict:
    """:func:`measure` in a fresh process, so that two trees' packages of
    the same name never meet."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--root", str(root),
         "--reps", str(reps)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"erwin_kernels on {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ab(parent: Path, rounds: int, reps: int) -> dict:
    runs = {"parent": [], "this": []}
    for r in range(rounds):
        for side in ("parent", "this", "this", "parent"):
            res = run_tree(parent if side == "parent" else THIS_ROOT, reps)
            runs[side].append(res)
            print(f"round {r + 1} {side}: {json.dumps(res)}", flush=True)
    medians = {side: {tag: {k: statistics.median(run[tag][k] for run in rs)
                            for k in rs[0][tag]} for tag in SHAPES}
               for side, rs in runs.items()}
    for tag in SHAPES:
        p, t = medians["parent"][tag], medians["this"][tag]
        print(f"{tag:14s} device us/call fwd {p['fwd_us']:8.2f} -> "
              f"{t['fwd_us']:8.2f}   bwd {p['bwd_us']:8.2f} -> "
              f"{t['bwd_us']:8.2f}   (events fwd {p['fwd_event_us']:.1f} -> "
              f"{t['fwd_event_us']:.1f}, bwd {p['bwd_event_us']:.1f} -> "
              f"{t['bwd_event_us']:.1f})", flush=True)
    return {"card": card_line(), "runs": runs, "medians": medians}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=THIS_ROOT,
                    help="directory holding the haet_torch to time")
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR",
                    help="time PARENT_DIR's haet_torch and this one in turns")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=200)
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
