"""Differential timing of the benchmark drivers.

Counterpart of ``benchmarks/micro_erwin_fused.py:36-60`` and
``benchmarks/profile_step.py:29-66``. A window runs ``reps`` chained calls
and ends with a host fetch of a scalar that depends on every call
(:func:`fetch`), so it cannot end before the card does. Windows of ``lo``
and ``hi`` calls are interleaved, the minimum of each is taken, and
``(t_hi - t_lo) / (hi - lo)`` cancels the fixed cost of a window (the
fetch, the first launch's latency).

The JAX drivers chained the calls inside one jit (a ``fori_loop``), so
their difference was the device's time per call. Dispatched from eager
PyTorch (:func:`loop`), the host launches every kernel of every call, so
the difference is the time per call of whichever is slower, the host
issuing kernels or the card running them. :func:`graph_loop` is the
counterpart of the jitted loop: one call captured as a CUDA graph and
replayed ``reps`` times, one host fetch at the end, so the host issues one
launch per call. :func:`device_us_per_call` gives the card's side from a
``torch.profiler`` trace of one window; the drivers print each strategy's
wall beside it.
"""

from __future__ import annotations

import gc
from time import perf_counter

import torch


def fetch(out) -> float:
    """A host float that depends on every tensor in ``out`` (a tensor or a
    nest of tuples, lists and dicts): waits for the work that made them."""
    if isinstance(out, torch.Tensor):
        return float(out.detach().float().sum())
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return sum(fetch(o) for o in out)
    raise TypeError(f"cannot fetch a {type(out).__name__}")


def window(fn, *args) -> float:
    """Seconds from the call of ``fn(*args)`` to the fetch of its result."""
    t0 = perf_counter()
    fetch(fn(*args))
    return perf_counter() - t0


def interleaved_minima(fns: dict, *args, rounds: int, budget_s: float = 0.0,
                       max_rounds: int = 0):
    """``({key: least window time}, rounds run)``: after one warm-up call of
    each ``fns`` entry, rounds that run every entry once in order;
    ``rounds`` of them, then more while fewer than ``budget_s`` seconds of
    rounds have passed, up to ``max_rounds`` in all."""
    for fn in fns.values():
        window(fn, *args)
    best = {k: float("inf") for k in fns}
    t0, n = perf_counter(), 0
    while n < max(rounds, max_rounds):
        if n >= rounds and perf_counter() - t0 > budget_s:
            break
        for k, fn in fns.items():
            best[k] = min(best[k], window(fn, *args))
        n += 1
    return best, n


def timed(make_fn, *args, lo: int, hi: int, rounds: int = 5) -> float:
    """Differential seconds per call: ``make_fn(reps)`` returns a function
    of ``*args`` that makes ``reps`` chained calls; the lo and hi windows
    are interleaved and ``(min t_hi - min t_lo) / (hi - lo)`` returned. It
    is negative when the windows drifted more than the calls cost (see
    :func:`fmt`)."""
    best, _ = interleaved_minima({lo: make_fn(lo), hi: make_fn(hi)}, *args,
                                 rounds=rounds)
    return (best[hi] - best[lo]) / (hi - lo)


def per_call(t_lo: float, t_hi: float, lo: int, hi: int):
    """``(seconds per call, is_upper_bound)`` from the lo/hi minima with
    the fallback of ``bench.py:214-217``: a non-positive difference falls
    back to ``t_hi / hi``, which never reports faster than the raw hi
    window allows."""
    diff = t_hi - t_lo
    if diff > 0:
        return diff / (hi - lo), False
    return t_hi / hi, True


def fmt(t: float) -> str:
    """A differential time in ms, or "below drift noise" when it is not
    positive (``profile_step.py:55-58``)."""
    return f"{t * 1e3:8.3f} ms" if t > 0 else "  below drift noise"


def loop(body):
    """``make_fn`` for :func:`timed` that chains ``body``:
    ``x -> body(body(... body(x)))``, ``reps`` times."""
    def mk(reps):
        def run(x):
            for _ in range(reps):
                x = body(x)
            return x
        return run
    return mk


def graph_loop(body, example: torch.Tensor, warmup: int = 3):
    """``make_fn`` for :func:`timed` that chains ``body`` through a CUDA
    graph: ``v <- body(v)`` on a static copy of the window's argument is
    captured once, after ``warmup`` eager calls on the capturing stream,
    and a window of ``reps`` calls copies its argument in and replays the
    graph ``reps`` times (``bench.py:139-149``: the jitted ``fori_loop``).
    ``example`` gives the argument's shape, dtype and device (CUDA). Each
    call's input is the last call's output: for a train step whose input is
    tied to the last loss (``bench.py:143-146``), ``body`` is ``lambda
    loss: step(x + 1e-12 * loss)``. The windows hold ``body`` (and so the
    tensors the graph reads: a model's parameters, its optimizer's state)
    for as long as they live."""
    if example.device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA tensor, got one on "
                         f"{example.device}")
    static = example.detach().clone()
    stream = torch.cuda.Stream(static.device)
    stream.wait_stream(torch.cuda.current_stream(static.device))

    def call():
        out = body(static)
        with torch.no_grad():
            static.copy_(out)

    with torch.cuda.stream(stream):
        for _ in range(warmup):
            call()
    torch.cuda.current_stream(static.device).wait_stream(stream)
    gc.collect()   # a dead graph freed during the capture would end it
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        call()

    def mk(reps):
        def run(x, _body=call):     # the graph reads body's tensors: keep
            with torch.no_grad():   # them (a model, its optimizer) alive
                static.copy_(x)
            for _ in range(reps):
                graph.replay()
            return static
        return run
    return mk


def device_us_per_call(make_fn, *args, reps: int, device) -> float | None:
    """The card's kernel time per call, in microseconds, over one window of
    ``reps`` chained calls (``make_fn`` as for :func:`timed`), from a
    ``torch.profiler`` trace; None on the CPU, which has no such time."""
    from ..utils.profiling import device_trace, kernel_events

    if torch.device(device).type != "cuda":
        return None
    fn = make_fn(reps)
    fetch(fn(*args))                       # warm-up outside the trace
    with device_trace() as prof:
        fetch(fn(*args))
    total_us = sum(e.self_device_time_total for e in kernel_events(prof))
    return total_us / reps
