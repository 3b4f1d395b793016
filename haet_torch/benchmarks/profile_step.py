"""Per-component ablation of the car train step, with differential timing.

    python -m haet_torch.benchmarks.profile_step [--device cpu]

Counterpart of ``benchmarks/profile_step.py:69-190``, with the same
components at the same shapes (N = 32768 points, float32, kernel flags
off as there):

* the car train step (forward in train mode, MSE, backward, Adam) of the
  car configuration (1,757,190 params);
* the car forward alone, in train mode;
* physics attention (dim 256, 8 heads of 32, G 32) forward, and
  forward+backward;
* the Erwin stage alone (8 clouds of 32 states; c_hidden (32, 64), balls
  (32, 16), heads 4/8/4, depths 2/2/2, mlp_ratio 2, no embedding);
* ``build_erwin_perms`` on the Erwin stage's positions;
* slice + eidetic + deslice through :mod:`haet_torch.ops.slice_ops`.

Each line chains ``lo``/``hi`` = 5/25 calls through their data and prints
the wall time per call (:func:`.timing.fmt`) of two strategies, the calls
dispatched from Python and (on the card) a CUDA graph of one call replayed
``reps`` times (:func:`.timing.graph_loop`, the counterpart of the JAX
driver's jitted ``fori_loop``, ``profile_step.py:61-66``), and the card's
kernel time per call from a profiled window of ``lo`` dispatched calls.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..bench import make_train_step
from ..models import (ErwinTransformer, HAETransolverIrregularMesh,
                      PhysicsAttentionIrregularMesh)
from ..models.haet import init_weights
from ..ops import slice_ops
from ..ops.ball_groups import build_erwin_perms
from ..utils.env import default_device
from .timing import device_us_per_call, fmt, graph_loop, loop, timed

N_POINTS = 32768


def build_car_model(device, seed: int = 0):
    """The car configuration as ``profile_step.py:83-87`` spells it."""
    return HAETransolverIrregularMesh(
        space_dim=7, fun_dim=0, out_dim=4, n_layers=2, n_hidden=256,
        n_head=8, slice_num=32, mlp_ratio=2, rotate=45,
        enc_num_heads=(8, 8), enc_depths=(4, 4), dec_num_heads=(8,),
        dec_depths=(4,), erwin_mlp_ratio=4, embed=True, device=device,
        seed=seed)


def build_physics_attention(device, seed: int = 0):
    """``profile_step.py:123-125``, with the reference init."""
    pa = PhysicsAttentionIrregularMesh(dim=256, heads=8, dim_head=32,
                                       slice_num=32, mlp_ratio=2, rotate=45)
    init_weights(pa, torch.Generator().manual_seed(seed))
    return pa.to(device)


def build_erwin_stage(device, seed: int = 0):
    """``profile_step.py:147-151``, with the reference init."""
    er = ErwinTransformer(
        c_in=32, c_hidden=(32, 64), ball_sizes=(32, 16),
        enc_num_heads=(4, 8), enc_depths=(2, 2), dec_num_heads=(4,),
        dec_depths=(2,), strides=(2,), rotate=45, mp_steps=0, embed=False,
        mlp_ratio=2, dimensionality=3)
    init_weights(er, torch.Generator().manual_seed(seed))
    return er.to(device)


def components(dev, points: int) -> dict:
    """``{line: (make_fn, arg, body)}``: ``make_fn`` for
    :func:`.timing.timed` chains ``body`` from ``arg``."""
    rng = np.random.RandomState(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    lines = {}
    model = build_car_model(dev)
    x, y = t(rng.randn(1, points, 7)), t(rng.randn(1, points, 4))
    step = make_train_step(model, y)
    # the step does not read the carried loss: like the JAX chain
    # (``:95-107``), each step's dependence is on the parameters
    lines["train step (fwd+bwd+adam)"] = (lambda loss: step(x),
                                          torch.zeros((), device=dev))

    def fwd_chain(v):
        model.train()
        with torch.no_grad():
            return v + 1e-12 * model(v, None).mean()

    lines["model fwd only"] = (fwd_chain, x)

    pa = build_physics_attention(dev).eval()
    fx = t(rng.randn(1, points, 256))

    def pa_chain(v):
        with torch.no_grad():
            return v + 1e-12 * pa(v).mean()

    def pa_grad_chain(v):
        u = v.detach().requires_grad_()
        g, = torch.autograd.grad(pa(u).mean(), u)
        return (v + 1e-12 * g).detach()

    lines["physics attention fwd"] = (pa_chain, fx)
    lines["physics attention fwd+bwd"] = (pa_grad_chain, fx)

    er = build_erwin_stage(dev).eval()
    s = t(rng.randn(8, 32, 32))
    pos = t(rng.rand(8, 32, 3))

    def er_chain(v):
        with torch.no_grad():
            return v + 1e-12 * er(v, pos).mean()

    def perm_chain(v):
        perms = build_erwin_perms(v, ball_sizes=(32, 16), strides=(2,),
                                  rotate_angle=45.0, grouping="median")
        return v + 1e-12 * perms.perm[..., :1, None].to(v.dtype)

    lines["erwin stage fwd"] = (er_chain, s)
    lines["build_erwin_perms"] = (perm_chain, pos)

    xp = t(rng.randn(1, 8, points, 32))
    wsl = t(rng.randn(32, 32))

    def tok_chain(v):
        w = slice_ops.rep_slice_weights(
            v @ wsl, torch.full(v.shape[:-1] + (1,), 0.5, device=dev),
            1e-6)
        st = slice_ops.eidetic_states(v, w)
        return v + 1e-12 * slice_ops.deslice(st, w).mean()

    lines["slice+eidetic+deslice fwd"] = (tok_chain, xp)
    return {name: (loop(body), arg, body)
            for name, (body, arg) in lines.items()}


def run(device=None, points: int = N_POINTS, lo: int = 5, hi: int = 25,
        rounds: int = 5) -> dict:
    """Time every component; returns ``{line: {"wall_ms",
    "graph_wall_ms", "device_ms"}}`` (``graph_wall_ms`` and ``device_ms``
    None on the CPU; a wall not positive where the windows drifted more
    than the component costs)."""
    dev = default_device(device)
    out = {}
    for name, (mk, arg, body) in components(dev, points).items():
        wall = timed(mk, arg, lo=lo, hi=hi, rounds=rounds)
        graph = (timed(graph_loop(body, arg), arg, lo=lo, hi=hi,
                       rounds=rounds) if dev.type == "cuda" else None)
        dev_us = device_us_per_call(mk, arg, reps=lo, device=dev)
        out[name] = {"wall_ms": wall * 1e3,
                     "graph_wall_ms": None if graph is None else graph * 1e3,
                     "device_ms": None if dev_us is None else dev_us / 1e3}
        shown = ("not measured" if dev_us is None
                 else f"{dev_us / 1e3:8.3f} ms")
        gshown = "no graph on the CPU" if graph is None else fmt(graph)
        print(f"{name:26s}: wall {fmt(wall)}  graph {gshown}  device "
              f"{shown}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--points", type=int, default=N_POINTS)
    ap.add_argument("--lo", type=int, default=5)
    ap.add_argument("--hi", type=int, default=25)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    res = run(args.device, args.points, args.lo, args.hi, args.rounds)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
