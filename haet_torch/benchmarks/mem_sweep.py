"""Most points before OOM: the plain slice path against the slice kernels.

    python -m haet_torch.benchmarks.mem_sweep                      # sweep
    python -m haet_torch.benchmarks.mem_sweep --probe N --pallas 1  # probe

Counterpart of ``benchmarks/pallas_mem_sweep.py:34-287``. The slice kernels
(:mod:`haet_torch.ops.kernels.slice_kernels`) never write the ``[B, H, N,
G]`` slice weights to device memory; the plain path does. For each path the
sweep doubles N from ``--start`` until a probe fails, then bisects, where a
probe is a 1-layer forward (or forward+backward with ``--grad 1``) of the
reference's velocity-mem-checker model (space_dim 3, fun_dim 1, n_hidden
256, 8 heads, G 32), in bf16 as ``pallas_mem_sweep.run_probe`` builds it
(``:34,51``), in a fresh process, so that an OOM cannot leave a fragmented
caching allocator to the next probe.

A probe prints one JSON line with ``peak_memory_mb``
(``torch.cuda.max_memory_allocated``) and the slice-kernel launches it made;
the sweep prints every probe's line and a summary, whose
``auto_threshold`` (0.75x the plain path's boundary: the cap on
``use_pallas="auto"``'s threshold) names the boundary it comes from in
``auto_threshold_from``: ``"forward"``, or ``"grad"`` under ``--grad 1``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..models import HAETransolverIrregularMesh
from ..ops.kernels import launch_counts, reset_launch_counts
from ..utils.env import default_device
from ..utils.profiling import device_memory_mb

ROOT = Path(__file__).resolve().parents[2]
PROBE_TIMEOUT_S = 1800


def build_model(use_pallas: bool, slice_num: int = 32, device=None,
                seed: int = 0, bf16: bool = True):
    """The probe's model (``pallas_mem_sweep.py:47-52``)."""
    return HAETransolverIrregularMesh(
        space_dim=3, fun_dim=1, out_dim=1, n_layers=1, n_hidden=256,
        n_head=8, slice_num=slice_num, mlp_ratio=2, rotate=45,
        use_pallas=use_pallas, dtype=torch.bfloat16 if bf16 else None,
        device=device, seed=seed)


def run_probe(num_points: int, use_pallas: bool, bf16: bool = True,
              grad: bool = False, slice_num: int = 32, device=None) -> dict:
    """One forward (or forward+backward when ``grad``) at ``num_points``;
    prints and returns the probe's record."""
    dev = default_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    model = build_model(use_pallas, slice_num, dev, bf16=bf16).eval()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.rand(1, num_points, 3).astype(np.float32)).to(dev)
    fx = torch.from_numpy(
        rng.rand(1, num_points, 1).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    if grad:
        loss = torch.mean(model(x, fx).float() ** 2)
        loss.backward()
        total = sum(p.grad.abs().sum() for p in model.parameters()
                    if p.grad is not None)
        ok = bool(torch.isfinite(total))
    else:
        with torch.inference_mode():
            ok = bool(torch.isfinite(model(x, fx).float().sum()))
    counts = launch_counts()
    rec = {
        "num_points": num_points,
        "pallas": use_pallas,
        "grad": grad,
        "slice_num": slice_num,
        "dtype": "bfloat16" if bf16 else "float32",
        "ok": ok,
        "first_call_seconds": time.perf_counter() - t0,
        "peak_memory_mb": device_memory_mb(dev),
        "slice_launches": {k: counts[k] for k in ("slice_states", "deslice")},
    }
    print(json.dumps(rec), flush=True)
    return rec


def classify_failure(err: str) -> str:
    """``'oom'`` or ``'other'`` from a failing probe's stderr: a CUDA OOM
    raises ``torch.OutOfMemoryError`` ("CUDA out of memory. Tried to
    allocate ...")."""
    if "OutOfMemoryError" in err or "CUDA out of memory" in err:
        return "oom"
    return "other"


def run_classified_subprocess(cmd: list, tag: dict, retries: int = 2,
                              timeout_s: float = PROBE_TIMEOUT_S) -> dict:
    """Run a probe command in a fresh process; its JSON record, or a
    failure record with the failure's class. A timeout is re-probed up to
    ``retries`` times: it says nothing about memory."""
    attempts = 0
    while True:
        attempts += 1
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout_s, cwd=ROOT)
        except subprocess.TimeoutExpired:
            if attempts <= retries:
                print(json.dumps({**tag, "retrying_timeout": attempts}),
                      flush=True)
                continue
            return {**tag, "ok": False, "failure": "timeout",
                    "timeout": True}
        for line in proc.stdout.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "num_points" in rec:
                return rec
        err = proc.stderr or ""
        kind = classify_failure(err)
        lines = err.strip().splitlines()
        named = [ln for ln in lines if classify_failure(ln) == "oom"]
        tail = (named or lines or [f"rc={proc.returncode}"])[-1][:240]
        return {**tag, "ok": False, "failure": kind, "oom": kind == "oom",
                "error_tail": tail}


def probe_subprocess(num_points: int, use_pallas: bool, grad: bool = False,
                     slice_num: int = 32, device=None) -> dict:
    """A fresh-process run of this module's ``--probe`` mode."""
    cmd = [sys.executable, "-m", "haet_torch.benchmarks.mem_sweep",
           "--probe", str(num_points), "--pallas", str(int(use_pallas)),
           "--grad", str(int(grad)), "--slice_num", str(slice_num)]
    if device is not None:
        cmd += ["--device", str(device)]
    return run_classified_subprocess(
        cmd, {"num_points": num_points, "pallas": use_pallas})


def find_max_n(use_pallas: bool, start: int, limit: int, log, grad=False,
               slice_num=32, device=None):
    """Double until a probe fails, then bisect (``pallas_mem_sweep.py:
    190-222``). Returns ``(max_ok_n, hit_boundary, boundary_failure_kind)``;
    the boundary means memory only when its kind is ``'oom'``."""
    n = start
    last_ok, first_bad, bad_kind = None, None, None
    while n <= limit:
        rec = probe_subprocess(n, use_pallas, grad, slice_num, device)
        log(rec)
        if rec.get("ok"):
            last_ok = n
            n *= 2
        else:
            first_bad = n
            bad_kind = rec.get("failure", "unknown")
            break
    if first_bad is None:
        return last_ok, False, None
    if last_ok is None:
        return 0, True, bad_kind
    lo, hi = last_ok, first_bad
    while hi - lo > max(lo // 5, 1 << 16):
        mid = (lo + hi) // 2
        rec = probe_subprocess(mid, use_pallas, grad, slice_num, device)
        log(rec)
        if rec.get("ok"):
            lo = mid
        else:
            hi = mid
            bad_kind = rec.get("failure", "unknown")
    return lo, True, bad_kind


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probe", type=int, default=None)
    p.add_argument("--pallas", type=int, default=0)
    p.add_argument("--slice_num", type=int, default=32)
    p.add_argument("--grad", type=int, default=0,
                   help="probe forward+backward instead of forward only")
    p.add_argument("--start", type=int, default=1_000_000)
    p.add_argument("--limit", type=int, default=128_000_000)
    p.add_argument("--only", type=str, default=None,
                   choices=["plain", "kernel"],
                   help="probe just one path")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)
    if args.probe is not None:
        rec = run_probe(args.probe, bool(args.pallas), grad=bool(args.grad),
                        slice_num=args.slice_num, device=args.device)
        return 0 if rec["ok"] else 1

    records = []

    def log(rec):
        records.append(rec)
        print(json.dumps(rec), flush=True)

    found = {}
    for name, pallas in (("plain", False), ("kernel", True)):
        if args.only in (None, name):
            found[name] = find_max_n(pallas, args.start, args.limit, log,
                                     grad=bool(args.grad),
                                     slice_num=args.slice_num,
                                     device=args.device)
    max_plain = found.get("plain", (None,))[0]
    max_kernel = found.get("kernel", (None,))[0]
    summary = {
        "summary": True,
        "grad": bool(args.grad),
        "slice_num": args.slice_num,
        **{f"max_points_{k}": v[0] for k, v in found.items()},
        **{f"{k}_hit_oom": v[1] for k, v in found.items()},
        # 'oom' = the boundary was set by an out-of-memory error; anything
        # else means it is not a memory boundary
        **{f"{k}_boundary_failure": v[2] for k, v in found.items()},
        "kernel_headroom_x": (max_kernel / max_plain
                              if max_plain and max_kernel else None),
        # the cap on use_pallas='auto''s threshold: 0.75x what the plain
        # path holds, from this sweep's boundary (a forward's, or with
        # --grad 1 a training step's, as JAX sets its threshold)
        "auto_threshold": int(max_plain * 0.75) if max_plain else None,
        "auto_threshold_from": "grad" if args.grad else "forward",
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for rec in records + [summary]:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
