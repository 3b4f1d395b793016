"""Time per call of the copy kernel against ``torch.mul``; an A/B of two trees.

    python -m haet_torch.benchmarks.copy_scale
    python -m haet_torch.benchmarks.copy_scale --ab PARENT_DIR [--rounds 2]

Times ``copy_kernel.copy_scale`` and ``torch.mul(x, 1.000001)`` on one card
at the micro driver's ``[256, 32]`` and at ``[4096, 4096]`` (64 MiB each
way, past the 50 MB L2): the device time per call from a
``torch.profiler`` trace of back-to-back calls, the time per call of a
CUDA graph of 100 calls (no host in the way), and the CUDA-event time of
a window of back-to-back calls, which at the small shape is the host's
rate of issuing calls. The small shape is read again after the large one. At the small shape it also times, on the host clock, the pieces of
a wrapper call (the output's allocation, the two ways of asking for the
current stream, the launch counter) so that the wrapper's host cost can
be read against ``torch.mul``'s.

``--ab PARENT_DIR`` times the ``haet_torch`` under ``PARENT_DIR`` (for
example a ``git archive`` of the parent commit) and this one in turns, each
in a process of its own (parent, this, this, parent per round), and prints
the medians beside the card's name and power limit. Each process runs this
file by its path and imports the ``haet_torch`` of the tree it times.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

#: ``tag: (shape, profiled calls)``
SHAPES = {"micro": ((256, 32), 500), "large": ((4096, 4096), 100)}
THIS_ROOT = Path(__file__).resolve().parents[2]
HBM_BYTES_PER_S = 3.35e12


def bound_us(shape) -> float:
    """Bytes bound of one call: the input read once, the output written
    once (float32), over the card's memory rate."""
    n = shape[0] * shape[1]
    return 2 * 4 * n / HBM_BYTES_PER_S * 1e6


def host_us(fn, reps: int = 2000) -> float:
    """Host-clock microseconds per call of ``fn()`` (no synchronise)."""
    for _ in range(20):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def graph_us(fn, calls: int = 100, replays: int = 20) -> float:
    """Microseconds per call of ``fn()`` from a CUDA graph of ``calls``
    calls, replayed ``replays`` times between CUDA events: the card's time
    per call without the host in the way (graph launch gaps included)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (replays * calls)


def measure(root: Path) -> dict:
    """``{tag: {copy_us, copy_event_us, mul_us, mul_event_us, bound_us}}``
    for the ``haet_torch`` under ``root``, and ``host`` pieces."""
    sys.path.insert(0, str(root))
    from haet_torch.benchmarks.erwin_kernels import kernel_us
    from haet_torch.ops.kernels import LaunchCounter
    from haet_torch.ops.kernels import copy_kernel as ck

    if not torch.cuda.is_available():
        raise SystemExit("copy_scale: no CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    # the micro shape again after the large one: a second reading of the
    # same kernel in a process whose card has been busy
    for tag, (shape, reps) in (*SHAPES.items(), ("micro_again",
                                                 SHAPES["micro"])):
        x = torch.randn(shape, generator=g, device=dev)
        copy = kernel_us(lambda: ck.copy_scale(x), reps)
        mul = kernel_us(lambda: torch.mul(x, ck.SCALE), reps)
        out[tag] = {"copy_us": copy[0], "copy_event_us": copy[1],
                    "mul_us": mul[0], "mul_event_us": mul[1],
                    "copy_graph_us": graph_us(lambda: ck.copy_scale(x)),
                    "mul_graph_us": graph_us(lambda: torch.mul(x, ck.SCALE)),
                    "bound_us": bound_us(shape)}
        del x
    x = torch.randn(SHAPES["micro"][0], generator=g, device=dev)
    counter = LaunchCounter()
    out["host"] = {
        "copy_scale": host_us(lambda: ck.copy_scale(x)),
        "torch.mul": host_us(lambda: torch.mul(x, ck.SCALE)),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "raw_stream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(x.get_device())),
        "counter": host_us(counter.add),
    }
    torch.cuda.synchronize()
    return out


def run_tree(root: Path) -> dict:
    """:func:`measure` in a fresh process."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--root", str(root)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"copy_scale on {root} failed:\n"
                           f"{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def ab(parent: Path, rounds: int) -> dict:
    sys.path.insert(0, str(THIS_ROOT))
    from haet_torch.benchmarks.erwin_kernels import card_line

    runs = {"parent": [], "this": []}
    for r in range(rounds):
        for side in ("parent", "this", "this", "parent"):
            res = run_tree(parent if side == "parent" else THIS_ROOT)
            runs[side].append(res)
            print(f"round {r + 1} {side}: {json.dumps(res)}", flush=True)
    medians = {side: {tag: {k: statistics.median(run[tag][k] for run in rs)
                            for k in rs[0][tag]} for tag in rs[0]}
               for side, rs in runs.items()}
    for tag in (*SHAPES, "micro_again"):
        p, t = medians["parent"][tag], medians["this"][tag]
        print(f"{tag:11s} device us/call copy_scale {p['copy_us']:8.3f} -> "
              f"{t['copy_us']:8.3f}  torch.mul {p['mul_us']:8.3f} / "
              f"{t['mul_us']:8.3f}  bound {t['bound_us']:.3f}  (graph "
              f"copy {p['copy_graph_us']:.3f} -> {t['copy_graph_us']:.3f}, "
              f"mul {t['mul_graph_us']:.3f}; events copy "
              f"{p['copy_event_us']:.2f} -> {t['copy_event_us']:.2f}, mul "
              f"{t['mul_event_us']:.2f})", flush=True)
    return {"card": card_line(), "medians": medians}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=THIS_ROOT,
                    help="directory holding the haet_torch to time")
    ap.add_argument("--ab", type=Path, default=None, metavar="PARENT_DIR",
                    help="time PARENT_DIR's haet_torch and this one in turns")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if args.ab is not None:
        res = ab(args.ab.resolve(), args.rounds)
        print(res["card"])
        print(json.dumps(res["medians"]))
    else:
        print(json.dumps(measure(args.root.resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
