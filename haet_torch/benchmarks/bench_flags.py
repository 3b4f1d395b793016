"""A/B of the kernel flags on a train step, with interleaved timing.

    python -m haet_torch.benchmarks.bench_flags [--device cpu]

Counterpart of ``benchmarks/bench_flags.py:29-119``. Variants:
``baseline`` (plain path), ``pallas-tokenizer`` (``use_pallas=True``: the
slice kernels) and ``pallas-erwin`` (``use_pallas_erwin=True``: the Erwin
block kernels). Model: ``HAETransolverIrregularMesh(space_dim=7, fun_dim=0,
out_dim=4, n_layers, n_hidden, n_head=8, slice_num, mlp_ratio=2,
rotate=45)``; its Erwin stage keeps the constructor defaults (depths
2/2/2, so 6 blocks per layer, and Erwin mlp_ratio 2). Step: train mode,
``torch.optim.Adam(lr=1e-3)`` and plain MSE on ``x, y`` from
``RandomState(0)``, float32.

Every variant is built first, then the windows of ``k_lo`` and ``k_hi``
chained steps (each step's input is tied to the last loss) of all variants
are interleaved for ``rounds`` rounds, in two strategies: dispatched from
Python, and (on the card) a CUDA graph of one step replayed k times
(:func:`.timing.graph_loop`, the counterpart of the JAX driver's jitted
``fori_loop`` windows, ``bench_flags.py:49-76``). A variant's time per step
in a strategy is the difference of its minima over ``k_hi - k_lo`` (or,
where the windows drifted more than the steps cost, the upper bound
``t_hi / k_hi`` of :func:`.timing.per_call`, flagged ``is_upper_bound``,
where the JAX driver clamped the difference to 1e-9 s). :func:`run` also
returns each variant's kernel launches and plain routes per dispatched
step, from the launch counters, and per replayed step, from the profiler
(:func:`~haet_torch.ops.kernels.profile_launches`).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import make_train_step
from ..models import ErwinTransformerBlock, HAETransolverIrregularMesh
from ..ops.kernels import launch_counts, plain_route_counts, profile_launches
from ..utils.env import default_device
from .timing import (device_us_per_call, graph_loop, interleaved_minima,
                     per_call)

VARIANTS = {
    "baseline": {},
    "pallas-tokenizer": {"use_pallas": True},
    "pallas-erwin": {"use_pallas_erwin": True},
}


def build_model(variant: str, n_layers: int = 2, n_hidden: int = 256,
                slice_num: int = 32, device=None, seed: int = 0):
    """The driver's model for ``variant`` (``bench_flags.py:104-108``)."""
    return HAETransolverIrregularMesh(
        space_dim=7, fun_dim=0, out_dim=4, n_layers=n_layers,
        n_hidden=n_hidden, n_head=8, slice_num=slice_num, mlp_ratio=2,
        rotate=45, **VARIANTS[variant], device=device, seed=seed)


def k_steps(step, x):
    """``make_fn`` of ``k`` chained steps: each step's input is ``x + 1e-12
    * loss`` of the step before (``bench_flags.py:50-59``)."""
    def mk(k):
        def run(loss0):
            loss = loss0
            for _ in range(k):
                loss = step(x + 1e-12 * loss)
            return loss
        return run
    return mk


def _snapshot() -> dict:
    return {"launches": launch_counts(), "plain_routes": plain_route_counts()}


class _Counted:
    """A window function that adds the steps it runs and the launch and
    plain-route counter deltas they cause to its variant's ``tally``."""

    def __init__(self, fn, k, tally):
        self.fn, self.k, self.tally = fn, k, tally

    def __call__(self, *args):
        before = _snapshot()
        out = self.fn(*args)
        after = _snapshot()
        self.tally["steps"] += self.k
        for kind, counts in after.items():
            acc = self.tally[kind]
            for name, v in counts.items():
                acc[name] = acc.get(name, 0) + v - before[kind][name]
        return out


def run(device=None, points: int = 32768, n_layers: int = 2,
        n_hidden: int = 256, slice_num: int = 32, variants=None,
        k_lo: int = 5, k_hi: int = 25, rounds: int = 8) -> dict:
    """Time each variant; returns ``{variant: {"ms_per_step", "mpts_per_s",
    "is_upper_bound", "device_ms_per_step", "graph_ms_per_step",
    "graph_is_upper_bound", "graph_device_ms_per_step",
    "graph_calls_per_step", "erwin_blocks", "steps", "launches_per_step",
    "plain_routes_per_step"}}``: the first four of the dispatched steps,
    the ``graph_*`` of the replayed ones (None on the CPU), with ``steps``
    every dispatched step the variant ran, and ``device_ms_per_step`` None
    on the CPU."""
    dev = default_device(device)
    on_gpu = dev.type == "cuda"
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, points, 7).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(1, points, 4).astype(np.float32)).to(dev)
    names = list(VARIANTS) if variants is None else list(variants)
    built, tallies, fns = {}, {}, {}
    for name in names:
        model = build_model(name, n_layers, n_hidden, slice_num, dev)
        step = make_train_step(model, y)     # bench_flags.py:36-48
        tally = tallies[name] = {"steps": 0, "launches": {},
                                 "plain_routes": {}}
        loss = _Counted(lambda: step(x), 1, tally)()     # the first step
        float(loss)
        mk = k_steps(step, x)
        gk = (graph_loop(lambda v, step=step: step(x + 1e-12 * v), loss)
              if on_gpu else None)
        built[name] = (model, loss, mk, gk)
        for k in (k_lo, k_hi):
            # every window starts from the variant's first loss
            fns[(name, k)] = _Counted(lambda k=k, mk=mk, loss=loss:
                                      mk(k)(loss), k, tally)
            if gk is not None:
                fns[(name, "graph", k)] = (lambda k=k, gk=gk, loss=loss:
                                           gk(k)(loss))
        print(f"built {name}", flush=True)
    # one warm-up of each window, then every variant's windows interleaved
    best, _ = interleaved_minima(fns, rounds=rounds)

    out = {}
    for name, (model, loss, mk, gk) in built.items():
        dt, upper = per_call(best[(name, k_lo)], best[(name, k_hi)], k_lo,
                             k_hi)
        dev_us = device_us_per_call(
            lambda k: _Counted(mk(k), k, tallies[name]), loss, reps=k_lo,
            device=dev)
        graph = {"graph_ms_per_step": None, "graph_is_upper_bound": None,
                 "graph_device_ms_per_step": None,
                 "graph_calls_per_step": None}
        if gk is not None:
            gdt, gupper = per_call(best[(name, "graph", k_lo)],
                                   best[(name, "graph", k_hi)], k_lo, k_hi)
            _, prof = profile_launches(gk(k_lo), loss)
            graph = {"graph_ms_per_step": gdt * 1e3,
                     "graph_is_upper_bound": gupper,
                     "graph_device_ms_per_step": prof["device_ms"] / k_lo,
                     "graph_calls_per_step": {
                         k: v / k_lo for k, v in prof["calls"].items()}}
        t = tallies[name]
        out[name] = {
            "ms_per_step": dt * 1e3,
            "mpts_per_s": points / dt / 1e6,
            "is_upper_bound": upper,
            "device_ms_per_step": None if dev_us is None else dev_us / 1e3,
            **graph,
            "erwin_blocks": sum(isinstance(m, ErwinTransformerBlock)
                                for m in model.modules()),
            "steps": t["steps"],
            **{f"{kind}_per_step": {k: v / t["steps"]
                                    for k, v in t[kind].items()}
               for kind in ("launches", "plain_routes")},
        }
        shown = ("not measured" if dev_us is None
                 else f"{dev_us / 1e3:8.3f} ms/step")
        gshown = ("no graph on the CPU" if gk is None else
                  f"graph {graph['graph_ms_per_step']:8.3f} ms/step, device "
                  f"{graph['graph_device_ms_per_step']:8.3f} ms/step")
        print(f"{name:18s} {dt * 1e3:8.3f} ms/step "
              f"{points / dt / 1e6:8.2f} Mpts/s  device {shown}; {gshown}",
              flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--slice_num", type=int, default=32)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_hidden", type=int, default=256)
    ap.add_argument("--variants", type=str, default="all",
                    help="comma list: baseline,pallas-tokenizer,pallas-erwin")
    ap.add_argument("--k_lo", type=int, default=5)
    ap.add_argument("--k_hi", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args(argv)
    variants = (None if args.variants == "all"
                else [v for v in args.variants.split(",") if v in VARIANTS])
    res = run(args.device, args.points, args.n_layers, args.n_hidden,
              args.slice_num, variants, args.k_lo, args.k_hi, args.rounds)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
