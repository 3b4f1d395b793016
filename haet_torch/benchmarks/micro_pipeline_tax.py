"""The pipeline's tax on one card: the plain model against
:class:`~haet_torch.parallel.pipeline.PipelinedModel` on a world-of-one
``(dp 1, pp 1)`` mesh.

    python -m haet_torch.benchmarks.micro_pipeline_tax [--points 32768]
        [--micro 1] [--rounds 8] [--device cpu]

Counterpart of ``benchmarks/micro_pipeline_tax.py``: the flagship bench
config (``HAETransolverIrregularMesh(space_dim=7, fun_dim=0, out_dim=4,
n_layers=2, n_hidden=256, n_head=8, slice_num=32, mlp_ratio=2,
rotate=45)``, bf16 on the card, float32 on the CPU), here with both kernel
flags set, the port's main path. Four variants of its train step
(:func:`.bench_flags.make_runs`: MSE, Adam): ``plain``, ``plain-remat``
(``use_checkpoint``, the fair baseline of the recomputing pipeline),
``pp1-remat=True`` and ``pp1-remat=False``. With one stage and no peer the
pipeline sends nothing: its tax is the structure alone, the stacked layers
run through ``torch.func.functional_call``, the microbatch loop and the
per-block recompute. The windows of ``k_lo`` and ``k_hi`` chained steps of
every variant are interleaved for ``--rounds`` rounds
(:func:`.timing.interleaved_minima`), and a step's time is their
difference over ``k_hi - k_lo`` (:func:`.timing.per_call`). On the card
the steps are also replays of one CUDA graph per variant, the counterpart
of JAX's jitted windows, and the JAX lines (ms/step, Mpts/s, x vs plain)
are printed for both strategies.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import parallel
from ..models import HAETransolverIrregularMesh
from ..utils.env import default_device
from .bench_flags import make_runs
from .timing import interleaved_minima, per_call

__all__ = ["run", "main", "VARIANTS"]

VARIANTS = ("plain", "plain-remat", "pp1-remat=True", "pp1-remat=False")


def build(dev, n_layers: int, n_hidden: int, remat: bool, seed: int = 0):
    """The flagship model, both kernel flags, bf16 on the card."""
    return HAETransolverIrregularMesh(
        space_dim=7, fun_dim=0, out_dim=4, n_layers=n_layers,
        n_hidden=n_hidden, n_head=8, slice_num=32, mlp_ratio=2, rotate=45,
        use_pallas=True, use_pallas_erwin=True, use_checkpoint=remat,
        dtype=torch.bfloat16 if dev.type == "cuda" else None, device=dev,
        seed=seed)


def run(device=None, points: int = 32768, n_layers: int = 2,
        n_hidden: int = 256, micro: int = 1, k_lo: int = 2, k_hi: int = 6,
        rounds: int = 8) -> dict:
    """``{variant: {"ms_per_step", "mpts_per_s", "vs_plain",
    "is_upper_bound", "graph_ms_per_step", "graph_vs_plain"}}`` (the
    ``graph_*`` None on the CPU). Joins a world of one when no process
    group exists."""
    dev = default_device(device)
    parallel.init_distributed(device=dev)
    mesh = parallel.make_pp_mesh(1, 1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, points, 7).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(1, points, 4).astype(np.float32)).to(dev)
    models = {
        "plain": build(dev, n_layers, n_hidden, False),
        "plain-remat": build(dev, n_layers, n_hidden, True),
        **{f"pp1-remat={r}": parallel.PipelinedModel(
            build(dev, n_layers, n_hidden, False), mesh,
            num_microbatches=micro, dp_axis="dp", remat=r)
           for r in (True, False)}}
    fns, firsts = {}, {}
    for name, model in models.items():
        loss, mk, gk = make_runs(model, x, y)
        firsts[name] = loss
        for k in (k_lo, k_hi):
            fns[(name, k)] = lambda k=k, mk=mk, loss=loss: mk(k)(loss)
            if gk is not None:
                fns[(name, "graph", k)] = (lambda k=k, gk=gk, loss=loss:
                                           gk(k)(loss))
        print(f"built {name}", flush=True)
    best, _ = interleaved_minima(fns, rounds=rounds)
    out, base, gbase = {}, None, None
    for name in models:
        dt, upper = per_call(best[(name, k_lo)], best[(name, k_hi)], k_lo,
                             k_hi)
        base = base or dt
        rec = {"ms_per_step": dt * 1e3, "mpts_per_s": points / dt / 1e6,
               "vs_plain": dt / base, "is_upper_bound": upper,
               "graph_ms_per_step": None, "graph_vs_plain": None}
        lines = [("dispatched", dt)]
        if (name, "graph", k_lo) in best:
            gdt, _ = per_call(best[(name, "graph", k_lo)],
                              best[(name, "graph", k_hi)], k_lo, k_hi)
            gbase = gbase or gdt
            rec.update(graph_ms_per_step=gdt * 1e3,
                       graph_vs_plain=gdt / gbase)
            lines.append(("graph", gdt))
        for strategy, t in lines:
            b = base if strategy == "dispatched" else gbase
            print(f"{name:18s} {t * 1e3:8.3f} ms/step "
                  f"{points / t / 1e6:8.2f} Mpts/s (x{t / b:.3f} vs plain) "
                  f"[{strategy}]", flush=True)
        out[name] = rec
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--n_layers", type=int, default=2)
    ap.add_argument("--n_hidden", type=int, default=256)
    ap.add_argument("--micro", type=int, default=1,
                    help="microbatches (at batch 1, 1 is the only choice "
                         "without padding)")
    ap.add_argument("--k_lo", type=int, default=2)
    ap.add_argument("--k_hi", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.device, args.points, args.n_layers, args.n_hidden,
              args.micro, args.k_lo, args.k_hi, args.rounds)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
