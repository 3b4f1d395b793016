"""Scale probe: forward latency and peak device memory against N.

    python -m haet_torch.benchmarks.velocity_mem_checker [--device cpu]

Counterpart of ``benchmarks/velocity_mem_checker.py:28-107`` (the
reference's ``velocity-mem-checker.py``): a 1-layer irregular model
(n_hidden 256, 8 heads, G 32), float32, at N in {1e3, 1e4, 1e5, 1e6, 2e6,
3e6}. Per N, windows of 2 and ``max(16, min(256, 4e6 // N))``
forwards, each fed the last one's output (``fx + 0 * out``), are
interleaved for ``rounds`` rounds, and seconds per forward is the
difference of the minima (or the hi window's mean where that is not
positive, flagged ``is_upper_bound``). Peak memory is
``torch.cuda.max_memory_allocated`` since the run began.

The sweep stops at the first N that runs out of device memory
(``torch.OutOfMemoryError``); any other error propagates.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models import HAETransolverIrregularMesh
from ..utils.env import default_device
from ..utils.profiling import device_memory_mb
from .timing import interleaved_minima, per_call

SWEEP = (1_000, 10_000, 100_000, 1_000_000, 2_000_000, 3_000_000)
BF16_TODO = "bf16 is not ported yet (ROADMAP.md, queue 1: bf16)"


def benchmark_model(num_points: int, device=None, rounds: int = 4) -> dict:
    """One N: seconds per forward, points per second, peak memory."""
    dev = default_device(device)
    model = HAETransolverIrregularMesh(
        space_dim=3, fun_dim=1, out_dim=1, n_layers=1, n_hidden=256,
        n_head=8, slice_num=32, mlp_ratio=2, rotate=45, device=dev).eval()
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.rand(1, num_points, 3).astype(np.float32)).to(dev)
    fx = torch.from_numpy(
        rng.rand(1, num_points, 1).astype(np.float32)).to(dev)
    n_lo = 2
    n_hi = max(16, min(256, 4_000_000 // num_points))

    def chain(n_iters):
        def run():
            cur = fx
            with torch.inference_mode():
                for _ in range(n_iters):
                    cur = cur + 0.0 * model(x, cur)
            return cur
        return run

    best, _ = interleaved_minima({n: chain(n) for n in (n_lo, n_hi)},
                                 rounds=rounds)
    dt, upper = per_call(best[n_lo], best[n_hi], n_lo, n_hi)
    return {
        "num_points": num_points,
        "forward_seconds": dt,
        "points_per_sec": num_points / dt,
        "peak_memory_mb": device_memory_mb(dev),
        **({"is_upper_bound": True} if upper else {}),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--max_points", type=int, default=3_000_000)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA card")
    args = p.parse_args(argv)
    if args.bf16:
        raise NotImplementedError(BF16_TODO)
    results = []
    for n in SWEEP:
        if n > args.max_points:
            break
        try:
            r = benchmark_model(n, args.device, args.rounds)
        except torch.OutOfMemoryError as e:
            print(json.dumps({"num_points": n, "error": str(e)[:200]}))
            break
        results.append(r)
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
