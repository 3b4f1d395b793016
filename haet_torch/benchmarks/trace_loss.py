"""Which device records a ``torch.profiler`` trace loses, against the age of
its process, and whether :func:`haet_torch.utils.profiling.device_trace`'s
sentinels take the whole loss.

    python -m haet_torch.benchmarks.trace_loss [--seconds 210] [--every 15]

Every ``--every`` seconds, until the process is ``--seconds`` old, it
traces ``CALLS`` launches of ``x * 1.0001`` on a 4 MiB tensor four ways:
eager and as one CUDA graph replay, each under a bare
``torch.profiler.profile`` (no margin, no sentinels) and under
``device_trace``. It prints one JSON line per round: the process's age;
for the bare traces, how many of the work's records are missing, at
which launch positions (eager, by correlation id), and how far the first
kernel's timestamp lies from its launch's (a negative time is the card's
clock running early); for ``device_trace``, the work's records missing (0
if the margin and the sentinels took the loss) and the sentinels lost.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..utils.env import default_device
from ..utils.profiling import SENTINELS, device_trace

#: kernel launches traced per trace
CALLS = 60


def work(x):
    for _ in range(CALLS):
        x = x * 1.0001
    return x


def is_work(e) -> bool:
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and "Mul" in e.name)


def bare_trace(fn) -> tuple:
    """``(missing, offset_us)`` of a bare trace of ``fn()``: the launch
    positions (in launch order) of the work's kernels that it lost, for a
    graph replay, which is one launch, ``[-1]`` for each lost kernel; and
    the first kept kernel's start less its launch's start, in µs."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    launches = sorted((e for e in events if e.device_type() != cuda
                       and "Launch" in e.name()), key=lambda e: e.start_ns())
    kernels = sorted((e for e in events if e.device_type() == cuda
                      and "Mul" in e.name()), key=lambda e: e.start_ns())
    by_id = {e.correlation_id(): e for e in launches}
    offset = next(((k.start_ns() - by_id[k.correlation_id()].start_ns())
                   / 1e3 for k in kernels if k.correlation_id() in by_id),
                  None)
    if len(launches) == 1:                 # a graph replay
        return [-1] * (CALLS - len(kernels)), offset
    have = {k.correlation_id() for k in kernels}
    return ([i for i, e in enumerate(launches)
             if e.correlation_id() not in have], offset)


def sentinel_missing(fn) -> tuple:
    """``(work records missing, sentinels lost)`` of ``fn()`` under
    ``device_trace``; ``(None, SENTINELS)`` when it lost every sentinel."""
    try:
        with device_trace() as trace:
            fn()
    except RuntimeError:
        return None, SENTINELS
    return CALLS - sum(is_work(e) for e in trace.events()), trace.lost


def run(seconds: float = 210.0, every: float = 15.0, device=None) -> list:
    dev = default_device(device)
    if dev.type != "cuda":
        raise RuntimeError("trace_loss measures the card's profiler; it "
                           "has no CPU form")
    t0 = time.monotonic()
    x = torch.randn(1 << 20, device=dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            work(x)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        work(x)
    torch.cuda.synchronize()
    rows = []
    while True:
        age = time.monotonic() - t0
        eager, eager_us = bare_trace(lambda: work(x))
        replay, replay_us = bare_trace(graph.replay)
        row = {"age_s": round(age, 1),
               "bare_eager_lost": len(eager),
               "bare_eager_positions": eager[:8],
               "bare_eager_offset_us": eager_us,
               "bare_graph_lost": len(replay),
               "bare_graph_offset_us": replay_us}
        row["sentinel_eager_lost"], row["sentinels_lost_eager"] = \
            sentinel_missing(lambda: work(x))
        row["sentinel_graph_lost"], row["sentinels_lost_graph"] = \
            sentinel_missing(graph.replay)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if age >= seconds:
            return rows
        time.sleep(every)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=210.0)
    ap.add_argument("--every", type=float, default=15.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    rows = run(args.seconds, args.every, args.device)
    bad = [r for r in rows
           if r["sentinel_eager_lost"] != 0 or r["sentinel_graph_lost"] != 0]
    print(json.dumps({"rounds": len(rows), "rounds_sentinels_short": len(bad),
                      "most_bare_lost": max(max(r["bare_eager_lost"],
                                                r["bare_graph_lost"])
                                            for r in rows)}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
