"""Headline benchmark: training-step throughput of the ShapeNet-Car model.

    python -m haet_torch.bench [--device cpu] [--budget_s 150] [--rounds 6]

Counterpart of ``bench.py:76-264``. The model is the car configuration
(:func:`~haet_torch.utils.config.shapenet_car_config`, 1,757,190 params,
kernel flags off as the preset sets them), float32, batch 1 of 32768
points from ``RandomState(0)``; the step is a train-mode forward, MSE,
backward and ``torch.optim.Adam(lr=1e-3)`` (capturable on the card).

Timing has ``bench.py``'s two strategies, each in windows of
``K_LO``/``K_HI`` = 5/45 chained steps ending in a fetch of the last loss:
dispatch (``:130-137``: the steps launched from Python) and loop
(``:139-149``: there one jit with a ``fori_loop``, here a CUDA graph of
one step whose input is tied to the last loss, replayed k times,
:func:`.benchmarks.timing.graph_loop`). After one warm-up window of each,
the four kinds of window are interleaved
(:func:`.benchmarks.timing.interleaved_minima`, ``:203-212``); at least
``--rounds`` rounds, then more until ``--budget_s`` seconds of sampling or
16 rounds. A strategy's seconds per step is the difference of its minima
over ``k_hi - k_lo``, or ``t_hi / k_hi`` where that difference is not
positive; the record reports the better strategy (``:214-218``) and each
one's seconds per step. On the CPU there is no CUDA graph: the graph
fields are null and ``graph_note`` says why.

Prints one JSON line: points per second, ``vs_baseline`` against the
reference's A100 log (0.430 s per batch of 32768 points, ``bench.py:42``),
the step's FLOPs from ``torch.utils.flop_counter.FlopCounterMode`` (the
products it sees, on the plain path this step runs), MFU against the card's
float32 peak outside the tensor cores (67 TFLOP/s: TF32 is off by policy,
:mod:`haet_torch.utils.env`), and a chip-share probe: a chain of 128 bf16
2048x2048 products through ``torch.matmul``, interleaved with the rounds,
against 0.8 x 989 TFLOP/s (H100 SXM dense bf16, data sheet). The MFU and
probe fields are null on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .benchmarks.timing import graph_loop, interleaved_minima, per_call
from .utils.config import shapenet_car_config
from .utils.env import default_device

N_POINTS = 32768
BATCH = 1
BASELINE_SEC_PER_BATCH = 0.430  # A100, the reference's training log
BASELINE_PPS = N_POINTS * BATCH / BASELINE_SEC_PER_BATCH
#: H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12
PROBE_DIM = 2048
PROBE_ITERS = 128
PROBE_FLOPS = 2 * PROBE_DIM ** 3 * PROBE_ITERS  # 2.2 TFLOP
MAX_ROUNDS = 16
#: steps in the short and long windows (``bench.py:130-137``)
K_LO, K_HI = 5, 45
GRAPH_NOTE_CPU = "no CUDA graph on the CPU: dispatch strategy only"


def make_train_step(model, y, lr: float = 1e-3):
    """``step(x) -> loss``: forward in train mode, MSE against ``y``,
    backward, Adam (``bench.py:107-119``); each call moves the model's
    parameters, so chained calls run one after another on the card. Adam
    is capturable on CUDA parameters, so that a CUDA graph may hold the
    step (:func:`.benchmarks.timing.graph_loop`)."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, capturable=y.is_cuda)

    def step(x):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x, None).float() - y) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def step_flops(step) -> int:
    """FLOPs of one call of ``step`` as ``FlopCounterMode`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        step()
    return counter.get_total_flops()


def run(device=None, budget_s: float = 150.0, rounds: int = 6) -> dict:
    """Measure; returns the JSON record."""
    dev = default_device(device)
    on_gpu = dev.type == "cuda"
    model = shapenet_car_config().build(device=dev, seed=0)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(
        rng.randn(BATCH, N_POINTS, 7).astype(np.float32)).to(dev)
    y = torch.from_numpy(
        rng.randn(BATCH, N_POINTS, 4).astype(np.float32)).to(dev)
    step = make_train_step(model, y)

    def disp(n_steps):
        def go():
            for _ in range(n_steps):
                out = step(x)
            return out
        return go

    fns = {("dispatch", k): disp(k) for k in (K_LO, K_HI)}
    if on_gpu:
        loss0 = torch.zeros((), device=dev)
        mk = graph_loop(lambda loss: step(x + 1e-12 * loss), loss0)
        fns.update({("graph", k): (lambda k=k: mk(k)(loss0))
                    for k in (K_LO, K_HI)})
    if on_gpu:    # ~2.2 TFLOP a window: minutes on a CPU, for nothing
        g = torch.Generator(device=dev).manual_seed(7)
        pa = (torch.randn(PROBE_DIM, PROBE_DIM, generator=g, device=dev)
              / PROBE_DIM ** 0.5).to(torch.bfloat16)
        px = torch.randn(PROBE_DIM, PROBE_DIM, generator=g,
                         device=dev).to(torch.bfloat16)

        def probe():
            c = px
            for _ in range(PROBE_ITERS):
                c = torch.matmul(pa, c)
            return c[0, 0]
        fns = {"probe": probe, **fns}
    best, n_rounds = interleaved_minima(fns, rounds=rounds, budget_s=budget_s,
                                        max_rounds=MAX_ROUNDS)
    per_step = {s: per_call(best[(s, K_LO)], best[(s, K_HI)], K_LO, K_HI)
                for s in ("dispatch", "graph") if (s, K_LO) in best}
    strategy = min(per_step, key=lambda s: per_step[s][0])
    dt, upper = per_step[strategy]
    pps = N_POINTS * BATCH / dt
    graph = per_step.get("graph", (None, None))

    flops = step_flops(lambda: step(x))
    mfu = flops / dt / PEAK_F32_FLOPS if on_gpu else None
    probe_tflops = PROBE_FLOPS / best["probe"] / 1e12 if on_gpu else None
    quiet = 0.8 * PEAK_BF16_FLOPS / 1e12
    share = min(1.0, probe_tflops / quiet) if on_gpu else None
    return {
        "metric": "points_per_sec_fwd_bwd_step",
        "value": pps,
        "unit": "points/sec/chip",
        "vs_baseline": pps / BASELINE_PPS,
        "sec_per_step": dt,
        "is_upper_bound": upper,
        "strategy": strategy,
        "dispatch_sec_per_step": per_step["dispatch"][0],
        "dispatch_is_upper_bound": per_step["dispatch"][1],
        "graph_sec_per_step": graph[0],
        "graph_is_upper_bound": graph[1],
        "graph_note": None if on_gpu else GRAPH_NOTE_CPU,
        "rounds": n_rounds,
        "dtype": "float32",
        "device": (torch.cuda.get_device_name(dev) if on_gpu
                   else str(dev)),
        "mfu": mfu,
        "step_tflops": flops / 1e12,
        "flops_source": "flop_counter",
        "probe_tflops": probe_tflops,
        "chip_share_est": share,
        "mfu_adjusted": mfu / share if (mfu and share) else None,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card")
    ap.add_argument("--budget_s", type=float, default=150.0,
                    help="sampling seconds after the first --rounds rounds")
    ap.add_argument("--rounds", type=int, default=6,
                    help="rounds that always run (at most 16 in all)")
    args = ap.parse_args(argv)
    rec = run(args.device, args.budget_s, args.rounds)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
