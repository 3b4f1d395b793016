"""Diagnose the two timing strategies of the train step: k steps
dispatched from Python against a CUDA graph of the step replayed k times.

    python -m haet_torch.benchmarks.bench_loop_diag [--ks 5,45] [--rounds 4]
        [--device cpu --variants dispatched]

Counterpart of ``benchmarks/bench_loop_diag.py``, which asked why the JAX
step ran slower per step in a jitted ``fori_loop`` than dispatched. Three
variants, each in windows of k steps ending in one fetch of the last loss:

* ``dispatched`` (A): k chained steps launched from Python;
* ``graph-tied`` (B): a CUDA graph of one step whose input is ``x + 1e-12
  * loss`` of the step before (:func:`.timing.graph_loop`), replayed k
  times;
* ``graph-const`` (C): the same with the constant input ``x``. In JAX this
  let XLA hoist the x-only work out of the loop; a CUDA graph replays every
  kernel either way, so B and C should agree.

Model and step as the JAX script: the car-width HAET (``space_dim=7``, 2
layers, n_hidden 256, 8 heads, G 32, ``mlp_ratio=2``, ``rotate=45``,
kernel flags off), in bf16 on the card and float32 on the CPU
(``bench_loop_diag.py:40``), MSE against ``y`` and Adam(1e-3), one sample of
``--points`` points from ``RandomState(0)``. After one warm-up window of
each, the windows are interleaved for ``--rounds`` rounds; the driver
prints each window's least ms and, per variant, the seconds per step from
the slope between the smallest and largest k. A CUDA graph needs the card:
on the CPU only ``--variants dispatched`` runs.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import make_train_step
from ..models import HAETransolverIrregularMesh
from ..utils.env import default_device
from .timing import graph_loop, interleaved_minima

VARIANTS = ("dispatched", "graph-tied", "graph-const")


def windows(step, x, variant: str, device):
    """``make_fn(k)``: a window of k steps of ``variant`` that returns the
    last loss."""
    if variant == "dispatched":
        def mk(k):
            def run():
                for _ in range(k):
                    loss = step(x)
                return loss
            return run
        return mk
    loss0 = torch.zeros((), device=device)
    tied = variant == "graph-tied"
    graph = graph_loop((lambda loss: step(x + 1e-12 * loss)) if tied
                       else (lambda loss: step(x)), loss0)
    return lambda k: (lambda: graph(k)(loss0))


def run(device=None, points: int = 32768, ks=(5, 45), rounds: int = 4,
        variants=VARIANTS) -> dict:
    """Returns ``{variant: {"ms_per_window": {k: ms}, "sec_per_step"}}``
    (the slope between the smallest and largest k)."""
    dev = default_device(device)
    variants = list(variants)
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown variants {sorted(unknown)}; choose from "
                         f"{VARIANTS}")
    if dev.type != "cuda" and variants != ["dispatched"]:
        raise ValueError(f"the graph variants need a CUDA device, not the "
                         f"{dev.type}: on the CPU run --variants dispatched")
    ks = sorted(ks)
    model = HAETransolverIrregularMesh(
        space_dim=7, fun_dim=0, out_dim=4, n_layers=2, n_hidden=256,
        n_head=8, slice_num=32, mlp_ratio=2, rotate=45,
        dtype=torch.bfloat16 if dev.type == "cuda" else None, device=dev,
        seed=0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, points, 7).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(1, points, 4).astype(np.float32)).to(dev)
    step = make_train_step(model, y)
    fns = {}
    for v in variants:
        mk = windows(step, x, v, dev)
        fns.update({(v, k): mk(k) for k in ks})
    best, _ = interleaved_minima(fns, rounds=rounds)
    out = {}
    for v in variants:
        ms = {k: best[(v, k)] * 1e3 for k in ks}
        slope = (best[(v, ks[-1])] - best[(v, ks[0])]) / (ks[-1] - ks[0])
        out[v] = {"ms_per_window": ms, "sec_per_step": slope}
        for k in ks:
            print(f"{v:12s} k={k:3d}: {ms[k]:10.3f} ms window", flush=True)
        print(f"{v:12s} slope: {slope * 1e3:8.3f} ms per step", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--ks", default="5,45",
                    help="comma list of window lengths (steps)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma list: " + ",".join(VARIANTS))
    args = ap.parse_args(argv)
    res = run(args.device, args.points,
              tuple(int(k) for k in args.ks.split(",")), args.rounds,
              [v for v in args.variants.split(",") if v])
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
