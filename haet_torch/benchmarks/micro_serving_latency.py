"""Batch-1 serving latency of the ShapeNet-Car model through an artifact.

    python -m haet_torch.benchmarks.micro_serving_latency [--n 32186]
        [--rounds 6] [--samples 50] [--device cpu]

Counterpart of ``benchmarks/micro_serving_latency.py``. The car preset at
full width (both kernel flags; bf16 on the card and float32 on the CPU, as
the JAX driver builds it on its chip and on the CPU), seeded weights, is
exported as a batch-1 artifact (:mod:`haet_torch.export`), written, loaded
back and run three ways, interleaved: ``aot`` (the weights passed with each
call), ``aot_bound`` (bound once, as ``BatchingServer`` serves) and
``eager`` (the model itself, a cross-check). Each call's input depends on
the previous call's output, so a window of calls cannot end before the card
has run them all.

* ``e2e_latency_s``: one call and the fetch of its result to the host,
  ``--samples`` times: min, p50 and p95.
* ``device_latency_s``: the time per call in steady state, as the JAX
  driver defines it (``benchmarks/micro_serving_latency.py:19-25``): from
  windows of 4 and 24 chained calls (the least of ``--rounds`` each),
  their difference over 20, which cancels the window's fixed cost.
  Dispatched eagerly, a call takes the slower of the host issuing its
  kernels and the card running them. ``samples_per_sec`` is its inverse,
  and ``vs_baseline_device`` is the A100's latency over the bound
  program's.
* ``kernel_time_s``: the card's kernel time per call, from a
  ``torch.profiler`` trace of :data:`TRACED` calls
  (``utils.profiling.device_trace``); None on the CPU, which has no card.
  ``vs_baseline_kernel`` is the A100's latency over the bound program's.

Also the artifact's export (with its write), load and bind times. Prints one
JSON
line with the card's name and power limit (``nvidia-smi``). ``--tp`` (a
head-TP program over several cards) is not ported (``ROADMAP.md``, queue 1:
parallel).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..export import ServingBundle, load_artifact, save_artifact
from ..utils.config import shapenet_car_config
from ..utils.env import default_device
from .car_train import build_model

BASELINE_LATENCY_S = 0.1342  # A100, the reference's eval log (BASELINE.md)
LO, HI = 4, 24
TRACED = 5
TP_TODO = ("--tp is not ported yet (ROADMAP.md, queue 1, item 10b: the "
           "parallel pipeline, multi-chip exports and serving)")

__all__ = ["run", "main", "card"]


def card(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the CPU."""
    if dev.type != "cuda":
        return None
    from .slice_kernels import card_line

    return card_line()


def car_model(dev, seed: int = 0):
    """The car preset at full width, both kernel flags, bf16 on the card."""
    cfg = shapenet_car_config()
    cfg.bf16 = dev.type == "cuda"
    return build_model(cfg, dev, seed=seed).eval()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def measure(calls: dict, x, rounds: int, samples: int, dev) -> dict:
    """``{name: {e2e: [seconds], steady_s: seconds per call in steady
    state, kernel_s: kernel seconds per call}}`` of 1-argument chained
    callables;
    every variant's windows interleaved in each round, then each traced."""

    def window(call, k):
        t0 = time.perf_counter()
        v = x
        for _ in range(k):
            v = call(v)
        float(v.float().mean())  # the host fetch waits for the chain
        return time.perf_counter() - t0

    best = {}
    for name, call in calls.items():
        window(call, 1)  # warm
        best[name] = {"e2e": [], LO: float("inf"), HI: float("inf")}
    for _ in range(samples):
        for name, call in calls.items():
            best[name]["e2e"].append(window(call, 1))
    for _ in range(rounds):
        for name, call in calls.items():
            best[name][LO] = min(best[name][LO], window(call, LO))
            best[name][HI] = min(best[name][HI], window(call, HI))
    out = {}
    for name, b in best.items():
        diff = b[HI] - b[LO]
        out[name] = {"e2e": b["e2e"],
                     "steady_s": diff / (HI - LO) if diff > 0
                     else b[HI] / HI,
                     "kernel_s": kernel_time(calls[name], x, dev)}
    return out


def kernel_time(call, x, dev) -> float | None:
    """Seconds of kernel time per call on the card, from a device trace of
    :data:`TRACED` calls; None on the CPU."""
    if dev.type != "cuda":
        return None
    from ..utils.profiling import device_trace, kernel_events

    with device_trace() as prof:
        v = x
        for _ in range(TRACED):
            v = call(v)
    us = sum(e.self_device_time_total for e in kernel_events(prof))
    return us / 1e6 / TRACED


def _summary(m: dict) -> dict:
    e2e = m["e2e"]
    return {"e2e_latency_s": min(e2e), "e2e_p50_s": _pct(e2e, 0.5),
            "e2e_p95_s": _pct(e2e, 0.95), "device_latency_s": m["steady_s"],
            "samples_per_sec": 1.0 / m["steady_s"],
            "kernel_time_s": m["kernel_s"]}


def run(n: int = 32186, rounds: int = 6, samples: int = 50,
        device=None) -> dict:
    dev = default_device(device)
    model = car_model(dev)
    variables = model.state_dict()
    rng = np.random.RandomState(0)
    x_host = rng.randn(1, n, 7).astype(np.float32)
    x = torch.from_numpy(x_host).to(dev)
    with tempfile.TemporaryDirectory() as td:
        art = os.path.join(td, "artifact")
        t0 = time.perf_counter()
        save_artifact(art, model, variables, (x_host, None))
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_artifact(art, device=dev)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        bound = ServingBundle([served]).bind(variables)
        bound.predict(x)
        _sync(dev)
        t_bind = time.perf_counter() - t0

        def chained(out, v):
            return v + (1e-12 * out.float().mean()).to(v.dtype)

        def eager(v):
            with torch.inference_mode():
                return chained(model(v, None), v)

        calls = {"aot": lambda v: chained(served(variables, v), v),
                 "aot_bound": lambda v: chained(bound.predict(v), v),
                 "eager": eager}
        res = measure(calls, x, rounds, samples, dev)
    out = {"metric": "serving_latency_batch1", "n_points": n,
           "dtype": "bfloat16" if dev.type == "cuda" else "float32",
           "export_and_save_s": t_export, "load_s": t_load,
           "bind_and_first_call_s": t_bind,
           **{k: _summary(v) for k, v in res.items()}}
    out["baseline_a100_s"] = BASELINE_LATENCY_S
    bound_out = out["aot_bound"]
    out["vs_baseline_device"] = (BASELINE_LATENCY_S
                                 / bound_out["device_latency_s"])
    kernel_s = bound_out["kernel_time_s"]
    out["vs_baseline_kernel"] = (None if kernel_s is None
                                 else BASELINE_LATENCY_S / kernel_s)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    out["card"] = card(dev)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32186,
                    help="points per sample (car meshes ~32k)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--samples", type=int, default=50,
                    help="single calls timed for the e2e percentiles")
    ap.add_argument("--tp", type=int, default=0,
                    help="head-TP program over this many cards (not "
                         "ported)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tp:
        raise NotImplementedError(TP_TODO)
    out = run(args.n, args.rounds, args.samples, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
