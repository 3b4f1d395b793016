"""MFU against point count, with a chip-share probe per N.

    python -m haet_torch.benchmarks.mfu_sweep [--ns 32768 65536 ...]
        [--rounds 5] [--out rows.jsonl] [--pallas_ab 1] [--device cpu]

Counterpart of ``benchmarks/mfu_sweep.py:58-262``. For each N of ``--ns``
(default 32768 to 1048576) the car preset's training step at batch 1 (``x
[1, N, 7]``, ``y [1, N, 4]`` from ``RandomState(0)``, train mode, MSE,
Adam 1e-3: :func:`haet_torch.bench.make_train_step`, the step
``haet_torch.bench`` times), in bf16 on the card and float32 on the CPU,
the preset's kernel flags off as it sets them. Windows of 3 and 13 chained
steps (the JAX driver's) are interleaved with the bf16 matmul probe of
``haet_torch.bench`` (:func:`haet_torch.bench.make_probe`) round by round
(:func:`.timing.interleaved_minima`), so that every row carries its own
``chip_share_est``. On the card a window replays one CUDA graph of the step
(:func:`.timing.graph_loop`, the strategy ``haet_torch.bench`` reports
there, so the 32768 row compares with its ``graph_sec_per_step``); on the
CPU the steps are dispatched. Seconds per step are the windows' difference
(:func:`.timing.per_call`).

``step_tflops`` are ``FlopCounterMode``'s count of one plain step (as
``haet_torch.bench`` counts them), ``mfu`` against the card's dense bf16
peak (989 TFLOP/s), ``mfu_adjusted`` that over ``chip_share_est``.

With ``--pallas_ab 1`` a last row, at the largest N, times the plain step
(``sec_per_step_xla``: the JAX driver's key for its plain path) against
the one with the slice kernels (``use_pallas=True``), their windows
interleaved, and records what ``use_pallas="auto"`` resolves to at that N
on this device, asked of the model's own attention module
(:meth:`~haet_torch.models.physics_attention._PhysicsAttentionBase.pallas_enabled`),
not a copy of its rule. The row has no MFU: the counter does not see the
kernels' operations.

Rows are the JAX driver's keys (``platform`` is ``"gpu"`` on the card),
one JSON line each, echoed and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time

import numpy as np
import torch

from ..bench import (PEAK_BF16_FLOPS, PROBE_FLOPS, make_probe,
                     make_train_step, step_flops)
from ..utils.config import shapenet_car_config
from ..utils.env import default_device
from .timing import graph_loop, interleaved_minima, per_call

#: steps in the short and long windows (``mfu_sweep.py:101``)
K_LO, K_HI = 3, 13
#: the probe's rate on a quiet card: 0.8 x the dense bf16 peak, as
#: ``haet_torch.bench`` calibrates it
QUIET_TFLOPS = 0.8 * PEAK_BF16_FLOPS / 1e12
DEFAULT_NS = (32768, 65536, 131072, 262144, 524288, 1048576)


def make_windows(model, n: int, dev):
    """``make_fn(k)`` of ``k`` chained training steps of ``model`` at ``n``
    points: each step's input tied to the last loss, as in
    ``haet_torch.bench``; a replayed CUDA graph of one step on the card,
    dispatched steps on the CPU. Returns ``(make_fn, step, x)``."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, n, 7).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(1, n, 4).astype(np.float32)).to(dev)
    step = make_train_step(model, y)
    loss0 = torch.zeros((), device=dev)
    if dev.type == "cuda":
        mk = graph_loop(lambda loss: step(x + 1e-12 * loss), loss0)
    else:
        def mk(k):
            def run(loss):
                for _ in range(k):
                    loss = step(x + 1e-12 * loss)
                return loss
            return run
    return (lambda k: (lambda: mk(k)(loss0))), step, x


def measure_steps(variants: dict, rounds: int, probe):
    """``({name: seconds per step}, best probe seconds)`` for ``{name:
    make_fn}``: every variant's lo and hi windows and the probe
    interleaved in each round (``mfu_sweep.py:86-123``)."""
    fns = {} if probe is None else {"probe": probe}
    for name, mk in variants.items():
        fns[(name, K_LO)] = mk(K_LO)
        fns[(name, K_HI)] = mk(K_HI)
    best, _ = interleaved_minima(fns, rounds=rounds)
    out = {name: per_call(best[(name, K_LO)], best[(name, K_HI)], K_LO,
                          K_HI)[0] for name in variants}
    return out, best.get("probe", float("inf"))


def share_of(probe_s: float):
    """``(probe TFLOP/s, chip share)``, both None without a probe."""
    if not np.isfinite(probe_s):
        return None, None
    tflops = PROBE_FLOPS / probe_s / 1e12
    return tflops, min(1.0, tflops / QUIET_TFLOPS)


def release() -> None:
    """Free the last N's graph pool and tensors before the next N."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ns=DEFAULT_NS, rounds: int = 5, pallas_ab: bool = True, device=None,
        emit=print) -> list:
    """Measure; ``emit`` gets each row (a dict) as it is made. Returns the
    rows."""
    dev = default_device(device)
    on_gpu = dev.type == "cuda"
    platform = "gpu" if on_gpu else dev.type
    cfg = dataclasses.replace(shapenet_car_config(), bf16=on_gpu)
    probe = make_probe(dev) if on_gpu else None
    rows = []

    def add(row):
        rows.append(row)
        emit(row)

    for n in ns:
        mk, step, x = make_windows(cfg.build(device=dev, seed=0), n, dev)
        res, probe_s = measure_steps({"xla": mk}, rounds, probe)
        dt = res["xla"]
        fl = step_flops(lambda: step(x))
        probe_tflops, share = share_of(probe_s)
        mfu = fl / dt / PEAK_BF16_FLOPS if (fl and on_gpu) else None
        add({
            "kind": "mfu_vs_n", "n_points": n,
            "sec_per_step": round(dt, 6),
            "points_per_sec": round(n / dt, 1),
            "step_tflops": round(fl / 1e12, 4) if fl else None,
            "mfu": round(mfu, 4) if mfu else None,
            "probe_tflops": (round(probe_tflops, 2)
                             if probe_tflops else None),
            "chip_share_est": round(share, 4) if share else None,
            "mfu_adjusted": (round(mfu / share, 4)
                             if (mfu and share) else None),
            "platform": platform,
            "ts": time.time(),
        })
        del mk, step, x
        release()

    if pallas_ab and ns:
        n = max(ns)
        # what "auto" resolves to, asked of the model's own attention
        # module (its threshold and G scaling), not a copy of the rule
        attn = dataclasses.replace(cfg, use_pallas="auto").build(
            device=dev, seed=0).blocks[0].Attn
        auto_pallas = bool(attn.pallas_enabled(n, dev.type))
        mk_x, _, _ = make_windows(cfg.build(device=dev, seed=0), n, dev)
        mk_p, _, _ = make_windows(
            dataclasses.replace(cfg, use_pallas=True).build(device=dev,
                                                            seed=0), n, dev)
        res, probe_s = measure_steps({"xla": mk_x, "pallas": mk_p}, rounds,
                                     probe)
        dt_x, dt_p = res["xla"], res["pallas"]
        _, share = share_of(probe_s)
        add({
            "kind": "pallas_ab_at_max_n", "n_points": n,
            "slice_num": cfg.slice_num,
            "sec_per_step_xla": round(dt_x, 6),
            "sec_per_step_pallas_fused": round(dt_p, 6),
            "pallas_over_xla": round(dt_p / dt_x, 3),
            "auto_threshold_base_points": attn.pallas_auto_threshold,
            "auto_resolves_to": "pallas" if auto_pallas else "xla",
            "chip_share_est": round(share, 4) if share else None,
            "platform": platform,
            "ts": time.time(),
        })
        del mk_x, mk_p
        release()
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ns", type=int, nargs="*", default=list(DEFAULT_NS))
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="JSONL path to append rows to")
    ap.add_argument("--pallas_ab", type=int, default=1,
                    help="1: at the largest N, interleave an A/B of the "
                         "slice kernels against the plain path and record "
                         "the use_pallas='auto' resolution")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    args = ap.parse_args(argv)

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")

    return run(args.ns, args.rounds, bool(args.pallas_ab), args.device,
               emit)


if __name__ == "__main__":
    main()
