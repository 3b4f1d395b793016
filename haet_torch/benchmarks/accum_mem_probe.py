"""Most points before OOM for a real training step at batch B: plain
against gradient accumulation (``TrainConfig.accum_steps``).

    python -m haet_torch.benchmarks.accum_mem_probe              # sweep
    python -m haet_torch.benchmarks.accum_mem_probe --probe N --accum A \\
        --batch B                                                # one probe

Counterpart of ``benchmarks/accum_mem_probe.py:37-170``. Per
``accum_steps`` value (1 and ``--batch``), N per sample doubles from
``--start`` until a probe fails, then is bisected to 12.5 %, as
:mod:`.mem_sweep` does for the slice kernels. A probe is one
``Trainer.train_step`` (forward, backward, clip, Adam: on the card a CUDA
graph of the step, the trainer's default) at ``[batch, N]`` of the JAX
driver's 1-layer model (n_hidden 256, 8 heads, G 32, mlp_ratio 2, rotate
45, bf16; constant schedule, weight decay 0), in a fresh process
(:func:`.mem_sweep.run_classified_subprocess`), so that an OOM cannot
leave a fragmented caching allocator to the next probe. Only a
``torch.OutOfMemoryError`` counts as a memory boundary
(:func:`.mem_sweep.classify_failure`).

The model is built with ``use_pallas="auto"``: past the card's threshold
(:func:`~haet_torch.models.physics_attention.pallas_auto_enabled`) the step
runs the slice kernels, as a user's auto model would. With a mean-reduced
loss, ``accum_steps=B`` runs B microbatches of one sample each, so the
step's activations approach batch 1's while the optimizer still sees the
whole batch's gradient.

A probe prints one JSON line with the JAX driver's keys; ``peak_memory_mb``
is ``torch.cuda.max_memory_allocated`` (None on the CPU). The sweep prints
every probe's line and a summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..train import Trainer
from ..utils.config import ModelConfig, TrainConfig
from ..utils.env import default_device
from ..utils.profiling import device_memory_mb
from .mem_sweep import run_classified_subprocess


def probe_config(bf16: bool = True) -> ModelConfig:
    """The probe's model (``accum_mem_probe.py:51-53``), with
    ``use_pallas="auto"``."""
    return ModelConfig(variant="irregular", space_dim=3, fun_dim=1,
                       out_dim=1, n_layers=1, n_hidden=256, n_head=8,
                       slice_num=32, mlp_ratio=2, rotate=45, bf16=bf16,
                       use_pallas="auto")


def run_probe(num_points: int, batch: int, accum: int, bf16: bool = True,
              device=None) -> dict:
    """One ``Trainer.train_step`` at ``[batch, num_points]``; prints and
    returns the probe's record."""
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = Trainer(
        probe_config(bf16).build(device=dev, seed=0),
        lambda out, b: (torch.mean((out.float() - b["y"]) ** 2), {}),
        TrainConfig(lr=1e-3, epochs=1, batch_size=batch,
                    schedule="constant", weight_decay=0.0,
                    accum_steps=accum),
        total_steps=4, batch_args=lambda b: (b["x"], b["fx"]))
    rng = np.random.RandomState(0)
    data = {k: rng.rand(batch, num_points, c).astype(np.float32)
            for k, c in (("x", 3), ("fx", 1), ("y", 1))}
    t0 = time.perf_counter()
    metrics = trainer.train_step(data)
    ok = bool(np.isfinite(float(metrics["loss"])))
    dt = time.perf_counter() - t0
    rec = {"num_points": num_points, "batch": batch, "accum": accum,
           "ok": ok, "first_call_seconds": round(dt, 2),
           "peak_memory_mb": device_memory_mb(dev)}
    print(json.dumps(rec), flush=True)
    return rec


def accum_probe_subprocess(num_points: int, batch: int, accum: int,
                           device=None, infra_retries: int = 2) -> dict:
    """A fresh-process run of this module's ``--probe`` mode."""
    cmd = [sys.executable, "-m", "haet_torch.benchmarks.accum_mem_probe",
           "--probe", str(num_points), "--batch", str(batch),
           "--accum", str(accum)]
    if device is not None:
        cmd += ["--device", str(device)]
    return run_classified_subprocess(
        cmd, {"num_points": num_points, "batch": batch, "accum": accum},
        infra_retries)


def find_max_n(batch: int, accum: int, start: int, limit: int, log,
               device=None):
    """Double until a probe fails, then bisect to 12.5 %
    (``accum_mem_probe.py:97-133``). Returns ``(max_ok_n, hit_boundary,
    boundary_failure_kind)``; ``max_ok_n`` is only ever a probed N (0 when
    the first probe fails)."""
    n = start
    last_ok, first_bad, bad_kind = None, None, None
    while n <= limit:
        rec = accum_probe_subprocess(n, batch, accum, device)
        log(rec)
        if rec.get("ok"):
            last_ok = n
            n *= 2
        else:
            first_bad = n
            bad_kind = rec.get("failure")
            break
    if first_bad is None:
        return last_ok, False, None
    lo, hi = (last_ok or 0), first_bad
    while hi - lo > max(lo // 8, 16384):
        mid = (lo + hi) // 2
        if mid == 0:
            break
        rec = accum_probe_subprocess(mid, batch, accum, device)
        log(rec)
        if rec.get("ok"):
            lo = mid
        else:
            hi = mid
            bad_kind = rec.get("failure")
    return lo, True, bad_kind


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probe", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--accum", type=int, default=1)
    p.add_argument("--start", type=int, default=65536)
    p.add_argument("--limit", type=int, default=4_000_000)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--only", type=int, default=None,
                   help="sweep only this accum value (resume support)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)

    if args.probe is not None:
        rec = run_probe(args.probe, args.batch, args.accum,
                        device=args.device)
        return 0 if rec["ok"] else 1

    out = open(args.out, "a") if args.out else None
    try:
        def log(rec):
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()

        summary = {}
        accums = (args.only,) if args.only else (1, args.batch)
        for accum in accums:
            max_n, bounded, kind = find_max_n(
                args.batch, accum, args.start, args.limit, log, args.device)
            summary[f"accum{accum}"] = {
                "max_n": max_n, "hit_boundary": bounded,
                "boundary_failure": kind,
            }
        log({"summary": summary, "batch": args.batch})
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
