"""Batch-1 serving latency of the ShapeNet-Car model through an artifact.

    python -m haet_torch.benchmarks.micro_serving_latency [--n 32186]
        [--rounds 6] [--samples 50] [--device cpu]

Counterpart of ``benchmarks/micro_serving_latency.py``. The car preset at
full width (both kernel flags; bf16 on the card and float32 on the CPU, as
the JAX driver builds it on its chip and on the CPU), seeded weights, is
exported as a batch-1 artifact (:mod:`haet_torch.export`), written, loaded
back and run three ways, interleaved: ``aot`` (the weights passed with each
call), ``aot_bound`` (bound once, as ``BatchingServer`` serves) and
``eager`` (the model itself, a cross-check). Each call's input depends on
the previous call's output, so a window of calls cannot end before the card
has run them all.

* ``e2e_latency_s``: one call and the fetch of its result to the host,
  ``--samples`` times: min, p50 and p95.
* ``device_latency_s``: the time per call in steady state, as the JAX
  driver defines it (``benchmarks/micro_serving_latency.py:19-25``): from
  windows of 4 and 24 chained calls (the least of ``--rounds`` each),
  their difference over 20, which cancels the window's fixed cost.
  Dispatched eagerly, a call takes the slower of the host issuing its
  kernels and the card running them. ``samples_per_sec`` is its inverse,
  and ``vs_baseline_device`` is the A100's latency over the bound
  program's.
* ``kernel_time_s``: the card's kernel time per call, from a
  ``torch.profiler`` trace of :data:`TRACED` calls
  (``utils.profiling.device_trace``); None on the CPU, which has no card.
  ``vs_baseline_kernel`` is the A100's latency over the bound program's.

Also the artifact's export (with its write), load and bind times. Prints one
JSON
line with the card's name and power limit (``nvidia-smi``).

``--tp K`` adds ``aot_tp_bound`` (JAX ``:30-39, 107-178``): the same b1
program exported over a K-rank ``tp`` mesh (the model built with
``shard_axes=(None, "tp")``, exported with ``data_axis=None``: one sample
over K ranks, each running H / K heads), loaded by every rank and checked
against the unsharded program (within 1e-3 of its max |output|) before any
timing. It needs K ranks: under a process group of K (torchrun, or the
``HAET_*`` variables) each rank runs the driver; without one it starts K
local processes itself, over gloo (on the card, when the ranks share it, as
NCCL refuses two ranks on one device). Every rank times every variant in
the same order, so that the tp program's collectives meet; rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..export import ServingBundle, load_artifact, save_artifact
from ..utils.config import shapenet_car_config
from ..utils.env import default_device
from .car_train import build_model

BASELINE_LATENCY_S = 0.1342  # A100, the reference's eval log (BASELINE.md)
LO, HI = 4, 24
TRACED = 5

__all__ = ["run", "main", "card", "parse_args"]


def card(dev) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, None on the CPU."""
    if dev.type != "cuda":
        return None
    from .slice_kernels import card_line

    return card_line()


def car_model(dev, seed: int = 0, shard_axes=None):
    """The car preset at full width, both kernel flags, bf16 on the card
    (``shard_axes``: the head split of a tp program)."""
    cfg = shapenet_car_config()
    cfg.bf16 = dev.type == "cuda"
    cfg.shard_axes = shard_axes
    return build_model(cfg, dev, seed=seed).eval()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def measure(calls: dict, x, rounds: int, samples: int, dev) -> dict:
    """``{name: {e2e: [seconds], steady_s: seconds per call in steady
    state, kernel_s: kernel seconds per call}}`` of 1-argument chained
    callables;
    every variant's windows interleaved in each round, then each traced."""

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
        best[name] = {"e2e": [], LO: float("inf"), HI: float("inf")}
    for _ in range(samples):
        for name, call in calls.items():
            best[name]["e2e"].append(window(call, 1))
    for _ in range(rounds):
        for name, call in calls.items():
            best[name][LO] = min(best[name][LO], window(call, LO))
            best[name][HI] = min(best[name][HI], window(call, HI))
    out = {}
    for name, b in best.items():
        diff = b[HI] - b[LO]
        out[name] = {"e2e": b["e2e"],
                     "steady_s": diff / (HI - LO) if diff > 0
                     else b[HI] / HI,
                     "kernel_s": kernel_time(calls[name], x, dev)}
    return out


def kernel_time(call, x, dev) -> float | None:
    """Seconds of kernel time per call on the card, from a device trace of
    :data:`TRACED` calls; None on the CPU."""
    if dev.type != "cuda":
        return None
    from ..utils.profiling import device_trace, kernel_events

    with device_trace() as prof:
        v = x
        for _ in range(TRACED):
            v = call(v)
    us = sum(e.self_device_time_total for e in kernel_events(prof))
    return us / 1e6 / TRACED


def _summary(m: dict) -> dict:
    e2e = m["e2e"]
    return {"e2e_latency_s": min(e2e), "e2e_p50_s": _pct(e2e, 0.5),
            "e2e_p95_s": _pct(e2e, 0.95), "device_latency_s": m["steady_s"],
            "samples_per_sec": 1.0 / m["steady_s"],
            "kernel_time_s": m["kernel_s"]}


def _shared_dir(root: str) -> str:
    """Rank 0's directory ``root``, the same path on every rank."""
    import torch.distributed as dist

    box = [root]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def run(n: int = 32186, rounds: int = 6, samples: int = 50,
        device=None, tp: int = 0) -> dict:
    dev = default_device(device)
    model = car_model(dev)
    variables = model.state_dict()
    rng = np.random.RandomState(0)
    x_host = rng.randn(1, n, 7).astype(np.float32)
    x = torch.from_numpy(x_host).to(dev)
    tp_info = None
    with tempfile.TemporaryDirectory() as td:
        art = os.path.join(td, "artifact")
        t0 = time.perf_counter()
        save_artifact(art, model, variables, (x_host, None))
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = load_artifact(art, device=dev)
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        bound = ServingBundle([served]).bind(variables)
        bound.predict(x)
        _sync(dev)
        t_bind = time.perf_counter() - t0

        def chained(out, v):
            return v + (1e-12 * out.float().mean()).to(v.dtype)

        def eager(v):
            with torch.inference_mode():
                return chained(model(v, None), v)

        calls = {"aot": lambda v: chained(served(variables, v), v),
                 "aot_bound": lambda v: chained(bound.predict(v), v),
                 "eager": eager}
        if tp:
            bound_tp, tp_info = tp_program(tp, td, variables, x_host, x,
                                           bound, dev)
            calls["aot_tp_bound"] = lambda v: chained(bound_tp(v), v)
        res = measure(calls, x, rounds, samples, dev)
    out = {"metric": "serving_latency_batch1", "n_points": n,
           "dtype": "bfloat16" if dev.type == "cuda" else "float32",
           "export_and_save_s": t_export, "load_s": t_load,
           "bind_and_first_call_s": t_bind,
           **{k: _summary(v) for k, v in res.items()}}
    if tp_info is not None:
        out["aot_tp_bound"].update(tp_info)
    out["baseline_a100_s"] = BASELINE_LATENCY_S
    bound_out = out["aot_bound"]
    out["vs_baseline_device"] = (BASELINE_LATENCY_S
                                 / bound_out["device_latency_s"])
    kernel_s = bound_out["kernel_time_s"]
    out["vs_baseline_kernel"] = (None if kernel_s is None
                                 else BASELINE_LATENCY_S / kernel_s)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    out["card"] = card(dev)
    return out


def tp_program(tp: int, td: str, variables, x_host, x, bound, dev):
    """``(call, info)``: the b1 program exported over a ``tp``-rank tp mesh
    and bound on every rank, checked against the unsharded ``bound``."""
    from .. import parallel

    if parallel.world()[1] != tp:
        raise SystemExit(f"--tp {tp} needs a process group of {tp} ranks, "
                         f"have {parallel.world()[1]}")
    model = car_model(dev, shard_axes=(None, "tp"))
    if model.n_head % tp:
        raise SystemExit(f"--tp {tp} must divide n_head={model.n_head}")
    mesh = parallel.make_mesh(1, tp)
    tp_dir = os.path.join(_shared_dir(td), "artifact_tp")
    save_artifact(tp_dir, model, variables, (x_host, None), mesh=mesh,
                  data_axis=None)
    bound_tp = ServingBundle([load_artifact(tp_dir, mesh=mesh, device=dev)]
                             ).bind(variables)
    # the gate before any timing: the tp program is the unsharded one
    o_tp = bound_tp.predict(x).float()
    o_one = bound.predict(x).float()
    max_dev = float((o_tp - o_one).abs().max())
    scale = float(o_one.abs().max())
    if max_dev > 1e-3 * max(scale, 1.0):
        raise AssertionError(f"tp-sharded artifact deviates: {max_dev} vs "
                             f"scale {scale}")
    return bound_tp.predict, {"devices": tp, "max_abs_dev_vs_1chip": max_dev}


def _tp_rank(rank: int, tp: int, port: int, argv: list, queue) -> None:
    """One of the ``--tp`` ranks this driver starts itself."""
    from .. import parallel

    dev = default_device(_device_arg(argv))
    backend = ("gloo" if dev.type != "cuda"
               or tp > torch.cuda.device_count() else "nccl")
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or tp) // tp))
    try:
        parallel.init_distributed(f"127.0.0.1:{port}", tp, rank,
                                  device=dev, backend=backend)
        args = parse_args(argv)
        queue.put((rank, run(args.n, args.rounds, args.samples, args.device,
                             args.tp)))
    except BaseException as e:  # noqa: BLE001 - reported by the parent
        queue.put((rank, {"error": repr(e)}))
        raise


def _device_arg(argv: list):
    return argv[argv.index("--device") + 1] if "--device" in argv else None


def _spawn_tp(tp: int, argv: list) -> dict:
    """Run the driver on ``tp`` local ranks; rank 0's result."""
    import multiprocessing
    import socket

    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_tp_rank, args=(r, tp, port, argv, queue))
             for r in range(tp)]
    for p in procs:
        p.start()
    try:
        res = dict(queue.get(timeout=3600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [v["error"] for v in res.values() if "error" in v]
    if errors:
        raise RuntimeError(f"a --tp rank failed: {errors[0]}")
    return res[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32186,
                    help="points per sample (car meshes ~32k)")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--samples", type=int, default=50,
                    help="single calls timed for the e2e percentiles")
    ap.add_argument("--tp", type=int, default=0,
                    help="also export and time the b1 program over a tp "
                         "mesh of this many ranks (head TP)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .. import parallel

    if args.tp > 1:
        n_head = shapenet_car_config().n_head
        if n_head % args.tp:
            raise SystemExit(f"--tp {args.tp} must divide n_head={n_head}")
    if args.tp > 1 and parallel.world()[1] == 1 and not (
            parallel.cluster_configured()):
        out = _spawn_tp(args.tp, list(argv if argv is not None
                                      else sys.argv[1:]))
        print(json.dumps(out), flush=True)
        return out
    if args.tp > 1:
        parallel.init_distributed(device=args.device)
    out = run(args.n, args.rounds, args.samples, args.device, args.tp)
    if parallel.is_writer():
        print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
