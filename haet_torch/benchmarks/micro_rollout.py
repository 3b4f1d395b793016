"""Autoregressive rollout serving: one exported rollout program against
the per-frame loop of the single-step program.

    python -m haet_torch.benchmarks.micro_rollout [--rounds 6] [--steps 10]
        [--smoke] [--device cpu]

Counterpart of ``benchmarks/micro_rollout.py``, on the NS preset (64 x 64
grid, 8 layers, n_hidden 256, ``T_in`` 10, 10 frames; both kernel flags;
bf16 on the card, as the JAX driver runs it on its accelerator, float32 on
the CPU; seeded weights). Two programs are exported, written, loaded back
and bound: ``rollout_artifact``, all ``--steps`` frames in one program
(:func:`haet_torch.export.save_rollout_artifact`), and ``per_frame_loop``,
``--steps`` chained calls of the single-step program, each prediction fed
back into the window without a fetch to the host. Before timing, the
rollout is held against the loop: within 2e-2 in bf16 (rounding over 10
frames), 1e-5 in float32, as in JAX.

Also the rollout program's export (with its write) and its load and bind
times. Two numbers per variant, interleaved within each of ``--rounds`` rounds,
the least of each kept, as the JAX driver measures them: ``e2e_latency_s``,
one request's wall with its fetch to the host; ``device_latency_s``, the
time per call in steady state, the difference of windows of ``HI`` and
``LO`` chained calls over ``HI - LO`` (each call's input depends on the
previous call's output). ``--smoke`` is a 1-layer, 32-wide model on an 8 x
8 grid; :func:`run`'s ``n_layers`` cuts the depth (an exported rollout
unrolls layers x frames, and its export and load take ~0.5-1 s per
layer-frame on the host). Prints one JSON line with the card's name and power limit
(``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch

from ..export import load_artifact, save_artifact, save_rollout_artifact
from ..utils.config import ns_config
from ..utils.env import default_device
from .car_train import build_model
from .micro_serving_latency import card

LO, HI = 3, 13

__all__ = ["run", "main", "measure"]


def measure(calls: dict, x, rounds: int) -> dict:
    """``{name: (e2e seconds, device seconds per call)}`` of 1-argument
    chained callables, every variant's windows interleaved in each round
    (``benchmarks/micro_rollout.py:57-83``)."""

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
        best[name] = {"e2e": float("inf"), LO: float("inf"),
                      HI: float("inf")}
    for _ in range(rounds):
        for name, call in calls.items():
            best[name]["e2e"] = min(best[name]["e2e"], window(call, 1))
            best[name][LO] = min(best[name][LO], window(call, LO))
            best[name][HI] = min(best[name][HI], window(call, HI))
    out = {}
    for name, b in best.items():
        diff = b[HI] - b[LO]
        out[name] = (b["e2e"], diff / (HI - LO) if diff > 0 else b[HI] / HI)
    return out


def run(rounds: int = 6, steps: int = 10, smoke: bool = False,
        device=None, n_layers: int | None = None) -> dict:
    dev = default_device(device)
    mc = ns_config().model
    if n_layers is not None:
        mc = dataclasses.replace(mc, n_layers=n_layers)
    if smoke:
        mc = dataclasses.replace(mc, n_layers=1, n_hidden=32, n_head=2,
                                 slice_num=8, H=8, W=8, unified_pos=False)
    mc = dataclasses.replace(mc, bf16=dev.type == "cuda")
    model = build_model(mc, dev, seed=0).eval()
    variables = model.state_dict()
    n = mc.H * mc.W
    rng = np.random.RandomState(0)
    pos_host = rng.rand(1, n, 2).astype(np.float32)
    fx_host = rng.randn(1, n, mc.fun_dim).astype(np.float32)
    pos = torch.from_numpy(pos_host).to(dev)
    fx0 = torch.from_numpy(fx_host).to(dev)
    w = model.out_dim

    with tempfile.TemporaryDirectory() as td:
        roll_dir = os.path.join(td, "rollout")
        step_dir = os.path.join(td, "step")
        t0 = time.perf_counter()
        save_rollout_artifact(roll_dir, model, variables,
                              (pos_host, fx_host), steps=steps)
        t_export = time.perf_counter() - t0
        save_artifact(step_dir, model, variables, (pos_host, fx_host))
        t0 = time.perf_counter()
        roll = load_artifact(roll_dir, device=dev).bind(variables)
        t_load = time.perf_counter() - t0
        step = load_artifact(step_dir, device=dev).bind(variables)

    def loop(fx):
        outs = []
        for _ in range(steps):
            im = step(pos, fx)
            outs.append(im)
            fx = torch.cat([fx[..., w:], im.to(fx.dtype)], dim=-1)
        return torch.cat(outs, dim=-1)

    def chained(out, v):
        return v + (1e-12 * out.float().mean()).to(v.dtype)

    # value parity first: the program IS the loop
    with torch.inference_mode():
        err = float((roll(pos, fx0).float() - loop(fx0).float()).abs().max())
    tol = 2e-2 if mc.bf16 else 1e-5  # bf16 rounds over 10 frames
    if not err <= tol:
        raise AssertionError(f"rollout != per-frame loop: max abs {err}")

    with torch.inference_mode():
        res = measure({"rollout_artifact": lambda v: chained(roll(pos, v),
                                                             v),
                       "per_frame_loop": lambda v: chained(loop(v), v)},
                      fx0, rounds)
    (e2e_r, dev_r), (e2e_f, dev_f) = (res["rollout_artifact"],
                                      res["per_frame_loop"])
    return {"metric": "rollout_latency", "grid": [mc.H, mc.W],
            "steps": steps, "n_layers": mc.n_layers,
            "dtype": "bfloat16" if mc.bf16 else "float32",
            "value_parity_max_abs": err,
            "rollout_export_and_save_s": t_export,
            "rollout_load_and_bind_s": t_load,
            "rollout_artifact": {"e2e_latency_s": e2e_r,
                                 "device_latency_s": dev_r},
            "per_frame_loop": {"e2e_latency_s": e2e_f,
                               "device_latency_s": dev_f},
            "e2e_speedup": e2e_f / e2e_r, "device_speedup": dev_f / dev_r,
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "card": card(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny model and grid (a plumbing check)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.rounds, args.steps, args.smoke, args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
