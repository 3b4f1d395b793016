"""Microbench: the per-call cost of the copy kernel and of the Erwin block.

    python -m haet_torch.benchmarks.micro_erwin_fused [--device cpu]

Counterpart of ``benchmarks/micro_erwin_fused.py:63-113``, at its shapes:
rows 256 (8 clouds of 32), C 32, D 3, 4 heads, ball 32, mlp_ratio 4, the
distance bias on; ``x [8, 32, 32]`` and ``pos`` from
``np.random.RandomState(0)``. Each line chains calls through their data
(:mod:`.timing`, lo/hi windows of 50/1050 calls):

* the copy kernel (:func:`~haet_torch.ops.kernels.copy_kernel.chain_copy`);
* the Erwin block, plain (``use_pallas=False``) and fused, with the same
  weights: the forward under ``torch.no_grad()`` (autograd would keep every
  chained block alive), and forward+backward
  ``v + 1e-6 * d/dv sum(block(v, pos)**2)``.

Each line gives the wall time per call and the card's kernel time per call
from a profiled window; where they differ the wall number is the host's
launch rate, not the kernel.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.erwin import ErwinTransformerBlock
from ..models.haet import init_weights
from ..ops.kernels.copy_kernel import chain_copy
from ..utils.env import default_device
from .timing import device_us_per_call, loop, timed

ROWS, C, D, HEADS, BALL, MLP_RATIO = 256, 32, 3, 4, 32, 4


def inputs(device):
    """``(x [8, 32, 32], pos [8, 32, 3])`` from ``RandomState(0)``, as the
    JAX driver draws them."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, ROWS // 8, C).astype(np.float32)
    pos = rng.rand(8, ROWS // 8, D).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(pos).to(device)


def blocks(device, seed: int = 0):
    """``(plain block, fused block)`` with the same weights (the reference
    init drawn from ``seed``)."""
    kw = dict(dim=C, num_heads=HEADS, ball_size=BALL, mlp_ratio=MLP_RATIO,
              dimensionality=D, use_dist_bias=True)
    plain = ErwinTransformerBlock(**kw, use_pallas=False)
    init_weights(plain, torch.Generator().manual_seed(seed))
    fused = ErwinTransformerBlock(**kw, use_pallas=True)
    fused.load_state_dict(plain.state_dict())
    return plain.to(device), fused.to(device)


def fwd_step(blk, pos):
    """One chained forward call (``micro_erwin_fused.py:92-98``)."""
    def body(v):
        with torch.no_grad():
            return blk(v, pos)
    return body


def sq_grad(blk, v, pos):
    """``grad_v sum(blk(v, pos)**2)``, a forward and a backward."""
    v = v.detach().requires_grad_()
    g, = torch.autograd.grad((blk(v, pos) ** 2).sum(), v)
    return g


def fwd_bwd_step(blk, pos):
    """One chained forward+backward call: ``v + 1e-6 * grad_v sum(out**2)``
    (``micro_erwin_fused.py:100-108``)."""
    def body(v):
        return (v + 1e-6 * sq_grad(blk, v, pos)).detach()
    return body


def run(device=None, reps_lo: int = 50, reps_hi: int = 1050,
        rounds: int = 5) -> dict:
    """Time every line; returns ``{line: {"wall_us", "device_us"}}`` and
    ``copy_calls``, the copy-kernel calls made (for a launch-count check).
    ``device_us`` is None on the CPU."""
    dev = default_device(device)
    x, pos = inputs(dev)
    calls = {"copy": 0}

    def copy_chain(reps):
        def go(x2d):
            calls["copy"] += reps
            return chain_copy(x2d, reps)
        return go

    plain, fused = blocks(dev)
    lines = {"copy_scale": (copy_chain, x.reshape(ROWS, C))}
    for name, blk in (("plain", plain), ("fused", fused)):
        lines[f"{name} block fwd"] = (loop(fwd_step(blk, pos)), x)
    for name, blk in (("plain", plain), ("fused", fused)):
        lines[f"{name} block fwd+bwd"] = (loop(fwd_bwd_step(blk, pos)), x)

    out = {}
    for name, (mk, arg) in lines.items():
        wall = timed(mk, arg, lo=reps_lo, hi=reps_hi, rounds=rounds)
        dev_us = device_us_per_call(mk, arg, reps=reps_lo, device=dev)
        out[name] = {"wall_us": wall * 1e6, "device_us": dev_us}
        shown = ("not measured" if dev_us is None
                 else f"{dev_us:9.2f} us/call")
        print(f"{name:20s}: wall {wall * 1e6:9.2f} us/call  device {shown}",
              flush=True)
    out["copy_calls"] = calls["copy"]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--reps_lo", type=int, default=50)
    ap.add_argument("--reps_hi", type=int, default=1050)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(args.device, args.reps_lo, args.reps_hi, args.rounds)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
