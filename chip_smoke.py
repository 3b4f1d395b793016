#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``haet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build every CUDA kernel from ``haet_torch/csrc/`` (one ``nvcc`` per
   source, in parallel) and print the build time and ``ptxas``' register,
   stack and spill report for every kernel.
3. Each kernel at the ShapeNet-Car serving shapes against its plain PyTorch
   version on the card: max abs/rel error against the stated tolerance, the
   kernel's time (CUDA events over back-to-back launches, and the
   profiler's device time per call), the plain version's time and the bound
   (least time the card could take for the same bytes and float32
   operations; for the slice kernels, whose products run in 3xTF32 on the
   tensor cores, the operations at the faster of that rate and float32's).
   The slice kernels run at serve batch 1, the burst's batch of 4 and the
   training batch (``SLICE_TIMED``: device time with the L2 flushed before
   each call, beside the bound and, as context, the float32-FMA bound)
   and, untimed, at ``SLICE_EDGES`` (G 64 at C 16 and 32, ragged N 1, 255,
   257, G 128 and 600 at C <= 32, and widths of the generic kernels up to
   G*C = 16384 and C = 2048); every slice line prints each kernel's grid
   and shared memory per block, and two calls must give bit-identical
   states, m, s and out. One generic edge with the weights
   unscaled (``SLICE_UNSCALED``: logits past 100, where float32 itself
   loses digits) is held to a float64 reference instead, beside the plain
   version's own distance from it. Each Erwin line prints its launch
   shape (a cluster of K CTAs per cloud, shared memory per CTA). The Erwin
   forward is also checked at the serve burst's 32 clouds (timed on the
   device) and, untimed, at the gate's edges (``ERWIN_EDGES``).
3b. The backwards against their plain versions on the card: the Erwin
   block's backward kernel at both car block shapes (dx, dpos and all 14
   parameter gradients, timed, with its bound) and, untimed, at the gate's
   edges, each shape twice to show the results bit-identical; the slice
   backward kernels (``slice_states_bwd``: dx, dWs, dbs, dWa, dba;
   ``deslice_bwd``: those and dstates; the fast kernels at C <= 32, the
   generic ones wider) against ``*_bwd_plain``, each gradient within
   ``KERNEL_RTOL`` of its max but the cancelling biases (dbs, dba:
   ``SLICE_BWD_RTOL``), at the padded car shape ``train_b1`` (timed:
   device us per call with the L2 flushed, the bound, the plain version's
   time; and a one-pass TF32 control, the plain version with TF32 matrix
   products, whose distance the tolerances must tell apart) and, untimed,
   at every ``SLICE_EDGES`` entry, two calls bit-identical (at N = 1 the
   gradients through the softmax's derivative are zero in exact arithmetic
   and are printed, not compared); both against float64 at a
   low-temperature C 32 edge (``SLICE_BWD_UNSCALED``); and the slice
   autograd functions (``SliceStatesFn``, ``DesliceFn``) against autograd
   of the plain versions at ``train_b1``.
4. Serve: the car preset (2 layers, n_hidden 256, G 32, 1,757,190 params,
   seeded random weights) on the card with both kernel flags set, behind a
   ``BatchingServer`` with signature ``x [32186, 7] f32, fx None`` and batch
   sizes (1, 2, 4). Sequential requests (``max_delay_s=0``) and a concurrent
   burst that forms a batch of 4. Checks shapes, finiteness, agreement with
   the plain path on the same weights and inputs, that the kernel launch
   counters rose by exactly 2 + 2 + 24 per forward, and that nothing was
   routed to a plain version.
5. Profile one batch-1 forward: device time by kernel against wall time.
6. Train: the car preset at full width with both flags set takes 5
   ``Trainer.train_step``s (Adam + OneCycle + clip 1.0, the masked car
   loss, train-mode BatchNorm) on a seeded synthetic sample of 32186 points
   padded to the 32768 bucket: replays of one CUDA graph, the trainer's
   default on the card. Checks that the loss and every parameter stay
   finite, that after step 1 every parameter but ``sigma_att`` has a finite
   gradient, that step 1's gradients match the plain path's (both flags off,
   same weights and batch, stepped op by op) leaf by leaf, that the launch
   counters rose by exactly 2 + 2 (slice forwards) + 2 + 2 (their
   backwards) + 24 + 24 (Erwin) per step of the graph's warm-up and
   capture, with no plain route, and that one replay ran exactly those
   kernel calls on the device (``profile_launches``). Prints the step wall
   time, peak device memory and, from one profiled step, the device time
   by kernel and the busy share.
7. Benchmarks: the drivers of ``haet_torch.bench`` and
   ``haet_torch/benchmarks/``, and the copy kernel they time.
   a. ``copy_scale`` (the fifth kernel) at ``[256, 32]`` against
      ``x * 1.000001``: bit-exact after 1 call and after 1050 chained calls,
      and on an unaligned and a tailed view of 8191 elements (its scalar
      route and its float4 route's tail); its time, the plain version's,
      ``torch.mul``'s (``library_ms``) and its bound. Then at
      ``[4096, 4096]`` (64 MiB each way, its wide route): bit-exact, and
      its device time per call beside ``torch.mul``'s and the bound
      (record keys ``large_*``).
   b. The Erwin forward and backward kernels against the plain block (out,
      dx, dpos, every parameter gradient), timed, at the drivers' block
      shapes: the micro driver's (8 clouds of 32, C 32, 4 heads, SwiGLU
      128) and bench_flags' two (C 32, 4 heads, ball 32, SwiGLU 64; n 16,
      C 64, 8 heads, ball 16, SwiGLU 128), with their device time per call.
      The car uses 8 heads and SwiGLU 4C throughout. Records gain
      ``micro_*``, ``flags_n32_c32_*`` and ``flags_n16_c64_*``.
   c. ``slice_states``/``deslice`` against their plain versions, untimed,
      at ``[1, 8, 2**20, 32]``, the memory probes' size, two calls
      bit-identical.
   d. ``micro_erwin_fused`` with reduced windows: the copy counter rises by
      exactly the chained calls the driver made, the Erwin counters by
      exactly the fused lines' calls, and no block takes the plain route.
   e. ``bench_flags`` with 2 rounds of 1/3 steps, dispatched and as CUDA
      graphs: per step, exactly 2 + 2 slice launches and 2 + 2 of their
      backwards for ``pallas-tokenizer``, one forward and one backward
      launch per Erwin block (12) for ``pallas-erwin``, none for
      ``baseline``, and no plain route, from the launch counters for the
      dispatched steps and from the profiler for the replayed ones; then
      ``pallas-tokenizer`` alone at ``--slice_num 128`` (G*C 4096), with
      the same counts.
   f. ``haet_torch.bench``, 2 rounds: a finite throughput and MFU, both
      strategies' seconds per step, the better one reported.
   g. One ``mem_sweep`` probe per path at N = 2**20, forward only, each in
      a fresh process: the slice-kernel path's peak memory must be below
      the plain path's, and its probe must count 1 + 1 slice launches.
   h. ``bench_loop_diag`` (dispatched, graph with the input tied to the
      loss, graph with a constant input) at windows of 1 and 3 steps, and
      ``profile_step`` at 1/2 calls: finite windows, a graph wall per line.

8. The car preset's training run.
   a. ``Trainer.fit`` at full width (1,757,190 params, both kernel flags,
      ``shapenet_car_train_config()`` with early stopping armed) over
      ``car_like(n=4, npts=32186, seed=0)``, each sample padded to its
      2048 bucket: 3 for training, 1 held out; 3 epochs, eval every epoch,
      a ``Checkpointer`` in a temporary directory; the steps replay one
      CUDA graph per bucket. Checks finite losses, ``best`` and ``last``
      written, the launch counters risen by exactly 2 + 2 + 2 + 2 + 24 +
      24 per step of each graph's warm-up and capture and 2 + 2 + 24 per
      eval forward, no plain route; ``last`` restored on the CPU equal to
      the card's model; a run stopped by ``stop_event`` after epoch 1 and
      resumed through a fresh ``Trainer`` (its epoch profiled: exactly 2 +
      2 + 2 + 2 + 24 + 24 kernel calls on the device per step and warm-up
      step, 2 + 2 + 24 per eval forward) ends within 1e-5 of each leaf's
      max of the unbroken run (printed: whether bit-identical). Prints the
      per-epoch wall, ``fit``'s wall per step against bare ``train_step``s
      on the same batches (graphs captured before the timed region), and
      the peak device memory.
   b. ``python -m haet_torch.benchmarks.car_train --epochs 2`` at full
      width on the synthetic stand-in, in a subprocess, then
      ``car_eval --which last`` on its checkpoints (2 + 2 + 24 launches
      per forward): every metric finite, ``car_eval`` equal to
      ``car_train``'s final metrics at rtol 1e-5; ``time_per_sample``.

9. The car train step as CUDA graphs against the eager step
   (``Trainer(..., eager=True)``), the car preset at full width with both
   kernel flags, ``cycle_momentum`` on.
   a. Two trainers from the same weights take 6 steps over two buckets in
      turns (30720 and 32768 points, so the graphs switch): at every step
      the metrics, and the lr and beta1 that the step applied, within
      ``GRAPH_RTOL`` = 1e-6 (printed: whether bit-identical); after them
      every parameter, BatchNorm statistic and counter, Adam state, lr and
      beta1 within 1e-6 of its max.
   b. One replay's kernel calls from the profiler: exactly 2 + 2 + 2 + 2
      + 24 + 24, no plain route; the same replay twice from one state
      (restored in place) bit-identical.
   d. The eager trainer's checkpoint of step 3 restored into both (the
      training state keeps its storage), then 3 more steps: equal again,
      and no new graph captured.
   e. Each trainer's step wall (median of 12), device time, kernels per
      step, busy share, and memory: the resident state, the graphs' pool
      and the eager step's temporaries.
   c. ``train_steps`` of 5 batches (one graph of 5 steps) against 5
      graphed ``train_step``s from the same weights: equal metrics and
      state.

Then one JSON line of kernel records, seven of them (``launches`` from
phase 6's counters, for ``copy_scale`` from the counter after phase 7d's
run, ``replay_launches`` from the profiler's count of one replay) and
phase 8's and 9's numbers, the card line, and as the last line ``{"ok":
true, "device": {...}}``. Imports nothing of JAX or
``haet_tpu``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_POINTS = 32186          # a ShapeNet-Car sample's point count
N_PADDED = 32768          # its 2048-point training bucket
N_SURFACE = 3586          # surface points of a ShapeNet-Car sample
TRAIN_STEPS = 5
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 FLOP/s outside
# the tensor cores (the kernels compute in float32 FMA, no TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Tolerances, relative to the plain result's max |value|: float32 with sums
# taken in another order (chunked log-sum-exp merge, per-thread loops).
KERNEL_RTOL = 1e-4
SERVE_RTOL = 1e-4  # a whole 2-layer model, as the CPU parity test holds it
# The slice backwards' bias gradients sum 262,144 points' terms that cancel
# (for b_slice, sum_n dL/dlogit is 0 at a constant temperature), so float32
# sums in two orders differ by more than 1e-4 of the small result (3.6e-4
# on b_slice, H100 run of this script); every other gradient of theirs is
# held to KERNEL_RTOL.
SLICE_BWD_RTOL = 1e-3
# Step 1's gradients, kernels against the plain path: each leaf within
# GRAD_RTOL of its own max |grad|, or GRAD_ATOL of the largest |grad| of the
# model. float32 through a forward and backward of 2 layers and 24 Erwin
# blocks with sums in other orders (a CPU run of the same comparison at
# N = 4096 measured 2.3e-5); the absolute floor is for leaves whose
# gradient is zero up to round-off (biases in front of a train-mode
# BatchNorm: ~1e-8 of the largest |grad|, all noise).
GRAD_RTOL = 1e-3
GRAD_ATOL = 1e-6


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` launches, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, names=None, reps: int = 50) -> float:
    """The card's time per call of ``fn()``, in microseconds, from a
    ``torch.profiler`` trace of ``reps`` back-to-back calls: the kernels
    whose names contain one of ``names`` (every kernel when None)."""
    from haet_torch.benchmarks.erwin_kernels import kernel_us

    return kernel_us(fn, reps, names)[0]


ERWIN_FWD_KERNELS = ("erwin_block_fwd",)
ERWIN_BWD_KERNELS = ("erwin_block_bwd", "erwin_block_sum_partials")


def erwin_launch_line(n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8):
    """The Erwin kernels' launch shape at one block shape: the grid of
    ``clouds`` clusters of ``CLUSTER`` CTAs, and each kernel's dynamic
    shared memory and global scratch per CTA."""
    from haet_torch.ops.kernels import erwin_block as eb

    args = (n_e, c_e, 3, mlp_ratio * c_e, heads, min(ball, n_e))
    fwd, bwd = eb.fwd_layout(*args), eb.bwd_layout(*args)
    return (f"grid {clouds * eb.CLUSTER} CTAs = {clouds} clouds x cluster "
            f"K {eb.CLUSTER}, 256 threads; shared memory per CTA fwd "
            f"{fwd.smem} B, bwd {bwd.smem} B; scratch per CTA fwd "
            f"{4 * fwd.scratch} B, bwd {4 * bwd.scratch} B")


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, rtol):
    """Max abs error of ``got`` vs ``want`` against ``rtol * max|want|``."""
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    check(bool(got.isfinite().all()), f"{name}: non-finite values")
    tol = rtol * max(scale, 1e-30)
    print(f"  {name}: max_abs_err {err:.3e}  max|plain| {scale:.3e}  "
          f"rel {err / max(scale, 1e-30):.3e}  tol {tol:.3e}", flush=True)
    check(err <= tol, f"{name}: max abs error {err} > tolerance {tol}")
    return err


def print_times(ms, plain_ms, bound):
    print(f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]})", flush=True)


def kernel_record(name, source, replaces, err, ms, plain_ms, bound, **extra):
    """One entry of the ``kernels`` JSON line; ``launches`` is filled in
    from the serve phase's counters."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None, **extra}


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version at the car shapes.
# ---------------------------------------------------------------------------

#: the Erwin kernels' gate edges, ``(n, C, ball)`` at 8 heads and SwiGLU
#: 4C: the largest clouds the one-CTA gate admitted at the car's widths,
#: and the edges of the cluster kernels' gate (the JAX gate, n <= 512 and
#: C <= 512), where buffers and weight slices spill to global memory
ERWIN_EDGES = ((128, 32, 32), (64, 64, 16), (512, 32, 32), (512, 64, 16),
               (16, 512, 16))


def erwin_inputs(dev, g, n_e, c_e, ball, heads=8, mlp_ratio=4, clouds=8):
    """Seeded inputs and weights of one Erwin block shape (``clouds``
    clouds, ``heads`` heads, SwiGLU ``mlp_ratio`` * C), drawn from ``g``."""
    import torch

    from haet_torch.models.erwin import ErwinTransformerBlock
    from haet_torch.ops.kernels import erwin_block as eb

    torch.manual_seed(SEED)
    blk = ErwinTransformerBlock(c_e, heads, ball, mlp_ratio).to(dev)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(0.2 * torch.randn(p.shape, generator=g).to(dev))
        blk.BMSA.sigma_att.copy_(
            -1.0 + 0.01 * torch.randn(1, heads, 1, 1, generator=g).to(dev))
    params = dict(blk.named_parameters())
    xe = torch.randn(clouds, n_e, c_e, generator=g).to(dev)
    pe = torch.rand(clouds, n_e, 3, generator=g).to(dev)
    check(eb.eligible(n_e, c_e, heads, c_e, mlp_ratio * c_e),
          f"n {n_e} / C {c_e} / {heads} heads is outside the kernel's gate")
    return xe, pe, params, dict(ball_size=ball, num_heads=heads,
                                use_dist_bias=True)


def erwin_work(n_e, c_e, ball, heads=8, mlp_ratio=4):
    """``(weight elements, forward FLOP)`` of one Erwin block call on 8
    clouds of ``n_e`` points (``heads`` heads, SwiGLU ``mlp_ratio`` * C)."""
    hid = mlp_ratio * c_e
    hd = c_e // heads
    w_elems = (c_e + c_e * 3 + c_e + 3 * c_e * c_e + 3 * c_e + heads
               + c_e * c_e + c_e + c_e + 2 * (hid * c_e + hid)
               + c_e * hid + c_e)
    flops = 2 * 8 * n_e * (3 * c_e + 3 * c_e * c_e
                           + heads * ball * hd * 2
                           + c_e * c_e + 3 * hid * c_e)
    return w_elems, flops


def erwin_bwd_bound(n_e, c_e, ball, heads=8, mlp_ratio=4):
    """Bound of one backward call: reads x, pos, dout and the weights;
    writes dx, dpos and the gradients of every weight but sigma;
    recomputes the forward and does its two backward products per forward
    product."""
    w_elems, fwd_flops = erwin_work(n_e, c_e, ball, heads, mlp_ratio)
    nbytes = 4 * (3 * 8 * n_e * c_e + 2 * 8 * n_e * 3 + 2 * w_elems - heads)
    return bound_ms(nbytes, 3 * fwd_flops)


#: the slice kernels' timed shapes ``tag: (B, H, N, C, G)``: serve batch
#: 1, the serve burst's batch of 4, the padded training batch
#: (``benchmarks/slice_kernels.py:SHAPES``)
SLICE_TIMED = {"serve_b1": (1, 8, N_POINTS, 32, 32),
               "burst_b4": (4, 8, N_POINTS, 32, 32),
               "train_b1": (1, 8, N_PADDED, 32, 32)}
#: untimed: the presets' widest slices (G 64 at C 16 and 32), ragged N
#: around the kernels' 256-row block unit, wide slices at C <= 32 (G 128,
#: ``bench_flags --slice_num 128``; G 600, past what deslice stages at
#: once, and 19 windows of the backwards), and heads wider than 32 (the
#: generic kernels; ``--n_hidden 1024`` over 8 heads is C 128), up to G*C
#: 16384 and to the widest head, C 2048
SLICE_EDGES = {"g64_c16": (1, 8, N_POINTS, 16, 64),
               "g64_c32": (1, 8, N_POINTS, 32, 64),
               "n1": (1, 8, 1, 32, 32), "n255": (1, 8, 255, 32, 32),
               "n257": (1, 8, 257, 32, 32),
               "c13_g20": (1, 8, 3001, 13, 20),
               "generic_c128_g16": (1, 8, 3001, 128, 16),
               "g128_c16": (1, 8, 3001, 16, 128),
               "g128_c32": (1, 8, 3001, 32, 128),
               "g600_c32": (1, 8, 1001, 32, 600),
               "generic_c128_g32": (1, 8, 3001, 128, 32),
               "generic_c128_g128": (1, 8, 1001, 128, 128),
               "generic_c2048_g3": (1, 8, 301, 2048, 3)}
#: the edge ``generic_c128_g16`` with its seed, but ``ws`` 0.3 N(0, 1) and
#: ``wa`` 0.1 N(0, 1) unscaled: most temperatures clamp to 0.1 and logits
#: reach ~120, so two float32 computations differ by ~1e-4 of max |out|
#: (the plain version alone is ~4e-5 from float64 there, on the CPU)
SLICE_UNSCALED = ("generic_c128_g16", SLICE_EDGES["generic_c128_g16"],
                  list(SLICE_EDGES).index("generic_c128_g16"))


def slice_phase(dev, shapes, timed: bool, label: str = "phase 3"):
    """Both slice kernels against their plain versions at ``shapes``
    (``tag: (B, H, N, C, G)``), within ``KERNEL_RTOL`` of each output's
    max, and two calls bit-identical (states, m, s, out). Prints each
    launch's grid and shared memory per block. When ``timed``: the
    profiler's device us per call with the L2 flushed before each call
    (every kernel of the op, named), CUDA-event ms of back-to-back calls,
    the plain version's ms and the bound; returns the two kernel records
    (event and plain times and the bound at the first shape)."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    rec = {k: {"err": 0.0, "us": {}, "bound_us": {}, "f32_bound_us": {},
               "names": set(), "ms": None}
           for k in ("slice_states", "deslice")}
    for i, (tag, shape) in enumerate(shapes.items()):
        b, h, n, c, gs = shape
        print(f"{label}: slice_states / deslice ({tag})  x [{b}, {h}, {n}, "
              f"{c}], G {gs}; {slice_launches(dev, shape)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + i)
        with torch.inference_mode():
            got = sk.slice_states(x, ws, bs, wa, ba)
            again = sk.slice_states(x, ws, bs, wa, ba)
            want = sk.slice_states_plain(x, ws, bs, wa, ba)
            torch.cuda.synchronize()
            rec["slice_states"]["err"] = max(
                rec["slice_states"]["err"],
                *(compare(nm, a, w, KERNEL_RTOL)
                  for nm, a, w in zip(("states", "m", "s"), got, want)))
            same = all(torch.equal(a, w) for a, w in zip(got, again))
            m_p, s_p = want[1], want[2]
            del got, again, want
            out_k = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
            out_2 = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
            out_p = sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p)
            torch.cuda.synchronize()
            rec["deslice"]["err"] = max(rec["deslice"]["err"],
                                        compare("out", out_k, out_p,
                                                KERNEL_RTOL))
            same = same and torch.equal(out_k, out_2)
            del out_k, out_2, out_p
            print(f"  two calls bit-identical (states, m, s, out): {same}",
                  flush=True)
            check(same, f"slice kernels at {tag} are not deterministic")
            if not timed:
                continue
            fns = {"slice_states": (
                       lambda: sk.slice_states(x, ws, bs, wa, ba),
                       lambda: sk.slice_states_plain(x, ws, bs, wa, ba)),
                   "deslice": (
                       lambda: sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p),
                       lambda: sk.deslice_plain(x, ws, bs, wa, ba, st, m_p,
                                                s_p))}
            for kind, (fn, plain_fn) in fns.items():
                r = rec[kind]
                us, names = sb.flushed_us(fn, 30)
                bound = sb.bound_us(kind, shape)
                f32 = sb.bound_us(kind, shape, float32_only=True)
                r["us"][tag], r["bound_us"][tag] = us, bound[0]
                r["f32_bound_us"][tag] = f32[0]
                r["names"].update(names)
                if r["ms"] is None:
                    r["ms"], r["plain_ms"] = cuda_ms(fn), cuda_ms(plain_fn)
                    r["bound"] = (bound[0] / 1e3, bound[1])
                    print_times(r["ms"], r["plain_ms"], r["bound"])
                print(f"  {kind}: device {us:.2f} us per call (profiler, L2 "
                      f"flushed; {names}); bound {bound[0]:.2f} us "
                      f"({bound[1]}; 3xTF32 tensor cores), {bound[0] / us:.0%}"
                      f" of it; float32-FMA bound {f32[0]:.2f} us ({f32[1]}),"
                      f" context", flush=True)
        del x, st
        torch.cuda.empty_cache()
    if not timed:
        return None
    replaces = {"slice_states": "haet_tpu/ops/pallas/slice_kernels.py:73",
                "deslice": "haet_tpu/ops/pallas/slice_kernels.py:125"}
    return [kernel_record(k, "haet_torch/csrc/slice_kernels.cu", replaces[k],
                          r["err"], r["ms"], r["plain_ms"], r["bound"],
                          device_us_per_call=r["us"],
                          bound_us=r["bound_us"],
                          float32_bound_us=r["f32_bound_us"],
                          kernel_names=sorted(r["names"]))
            for k, r in rec.items()]


def slice_launches(dev, shape, kinds=("slice_states", "deslice")) -> str:
    """The slice kernels' route, grid and shared memory per block."""
    from haet_torch.ops.kernels import slice_kernels as sk

    b, h, n, c, gs = shape
    parts = []
    for kind in kinds:
        geom = sk.launch_geometry(kind, b * h, n, c, gs, sk.sm_count(dev))
        parts.append(f"{kind} {geom.route}, grid ({geom.per_cloud}, {b * h}, "
                     f"{geom.groups}) x 256 threads, {geom.span} rows per "
                     f"block, {geom.smem} B dynamic shared memory")
    return "; ".join(parts)


def slice_f64(x, ws, bs, wa, ba, st, m, s, base_temp=0.5, epsilon=1e-6):
    """slice_states ``(states, m, s)`` and deslice's ``out`` (from the
    given ``m``, ``s``) computed in float64 from the float32 inputs."""
    import math

    import torch

    x, ws, bs, wa, ba, st = (t.double() for t in (x, ws, bs, wa, ba, st))
    tau = base_temp + (x @ wa + ba).clamp(-0.4, 0.4)
    z = (x @ ws + bs - math.log(-math.log(epsilon))) / tau
    m64 = z.amax(dim=2)
    e = torch.exp(z - m64[:, :, None])
    s64 = e.sum(dim=2)
    states = torch.einsum("bhng,bhnc->bhgc", e, x) / s64[..., None]
    states = states / (1 + 1e-5)
    w = torch.exp(z - m.double()[:, :, None]) / s.double()[:, :, None]
    return (states, m64, s64), torch.einsum("bhng,bhgc->bhnc", w, st)


def slice_unscaled_phase(dev):
    """``SLICE_UNSCALED``: the generic kernels and the plain version both
    against float64; the kernels within ``KERNEL_RTOL`` of each output's
    max of the float64 value. Prints the plain version's distance from
    float64 (the witness that float32 loses those digits) and the kernels'
    from the plain version."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    tag, shape, index = SLICE_UNSCALED
    b, h, n, c, gs = shape
    print(f"phase 3: slice_states / deslice ({tag}, weights unscaled)  x "
          f"[{b}, {h}, {n}, {c}], G {gs}; {slice_launches(dev, shape)}",
          flush=True)
    x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + index,
                                      scaled=False)
    with torch.inference_mode():
        got = sk.slice_states(x, ws, bs, wa, ba)
        plain = sk.slice_states_plain(x, ws, bs, wa, ba)
        m_p, s_p = plain[1], plain[2]
        out_k = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
        out_p = sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p)
        ref, out_ref = slice_f64(x, ws, bs, wa, ba, st, m_p, s_p)
        torch.cuda.synchronize()
    for name, k, p, r in zip(("states", "m", "s", "out"), (*got, out_k),
                             (*plain, out_p), (*ref, out_ref)):
        scale = float(r.abs().max())
        plain_rel = float((p.double() - r).abs().max()) / scale
        kp_rel = float((k.double() - p.double()).abs().max()) / scale
        print(f"  {name}: plain float32 vs float64 rel {plain_rel:.3e}; "
              f"kernel vs plain rel {kp_rel:.3e}", flush=True)
        compare(f"{name} vs float64", k, r, KERNEL_RTOL)


def kernel_phase(dev):
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    g = torch.Generator().manual_seed(SEED)
    records = slice_phase(dev, SLICE_TIMED, timed=True)
    slice_phase(dev, SLICE_EDGES, timed=False)
    slice_unscaled_phase(dev)

    def erwin_case(n_e, c_e, ball, clouds=8):
        """One block shape's inputs, and the kernel's error against its
        plain version."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball,
                                          clouds=clouds)
        with torch.inference_mode():
            o_k = eb.fused_erwin_block(xe, pe, params, **kw)
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err = compare("out", o_k, o_p, KERNEL_RTOL)
        return xe, pe, params, kw, err

    # The Erwin stage's two block shapes: encoder0/decoder0 (n 32, C 32,
    # ball 32, SwiGLU 128; 16 launches per forward) and the bottleneck
    # (n 16, C 64, ball 16, SwiGLU 256; 8 launches per forward). The event
    # time of back-to-back launches is the host's launch rate at these
    # sizes; the profiler's device time per call is the kernel's.
    errs, times, plain_times, bounds, dev_us = [], [], [], [], {}
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3: fused_erwin_block  x [8, {n_e}, {c_e}], 8 heads, "
              f"ball {ball}; {erwin_launch_line(n_e, c_e, ball)}", flush=True)
        xe, pe, params, kw, err = erwin_case(n_e, c_e, ball)
        errs.append(err)
        with torch.inference_mode():
            def fn():
                return eb.fused_erwin_block(xe, pe, params, **kw)
            times.append((cuda_ms(fn), weight))
            dev_us[f"n{n_e}_c{c_e}"] = device_us(fn, ERWIN_FWD_KERNELS)
            plain_times.append((cuda_ms(
                lambda: eb.erwin_block_plain(xe, pe, params, **kw)), weight))
        w_elems, flops = erwin_work(n_e, c_e, ball)
        nbytes = 4 * (2 * 8 * n_e * c_e + 8 * n_e * 3 + w_elems)
        bounds.append((bound_ms(nbytes, flops), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
        print(f"  device {dev_us[f'n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler)", flush=True)
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    bound = (mix([(bd[0], w) for bd, w in bounds]),
             "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
             else "operations")

    # The serve burst's batch of 4: 32 clouds, 256 CTAs.
    for n_e, c_e, ball in ((32, 32, 32), (16, 64, 16)):
        print(f"phase 3: fused_erwin_block, serve burst  x [32, {n_e}, "
              f"{c_e}], 8 heads, ball {ball}; "
              f"{erwin_launch_line(n_e, c_e, ball, clouds=32)}", flush=True)
        xe, pe, params, kw, err = erwin_case(n_e, c_e, ball, clouds=32)
        errs.append(err)
        with torch.inference_mode():
            dev_us[f"burst_n{n_e}_c{c_e}"] = device_us(
                lambda: eb.fused_erwin_block(xe, pe, params, **kw),
                ERWIN_FWD_KERNELS)
        print(f"  device {dev_us[f'burst_n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler)", flush=True)
    records.append(kernel_record(
        "fused_erwin_block", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:163", max(errs), mix(times),
        mix(plain_times), bound,
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]},
        device_us_per_call=dev_us))

    # The gate's edges: they must launch and agree too. Checked only, not
    # timed and not part of the record.
    for n_e, c_e, ball in ERWIN_EDGES:
        print(f"phase 3: fused_erwin_block at a gate edge  x [8, {n_e}, "
              f"{c_e}], 8 heads, ball {ball}, SwiGLU {4 * c_e}; "
              f"{erwin_launch_line(n_e, c_e, ball)}", flush=True)
        erwin_case(n_e, c_e, ball)
    print("  none of the three has a single PyTorch call computing the same "
          "function: library_ms is null", flush=True)
    return records


# ---------------------------------------------------------------------------
# Phase 3b: the backwards against autograd of their plain versions.
# ---------------------------------------------------------------------------

#: the gradients each slice backward returns, in order
SLICE_BWD_GRADS = {"slice_states_bwd": ("dx", "dWs", "dbs", "dWa", "dba"),
                   "deslice_bwd": ("dx", "dWs", "dbs", "dWa", "dba",
                                   "dstates")}
#: zero in exact arithmetic at N = 1: one point's softmax weight is 1
#: whatever its logit, so dL/dlogit is 0 and so is every gradient through
#: it; both versions return rounding noise of the logits' size (up to ~1e-3
#: of the largest gradient), which no relative tolerance can hold
SLICE_BWD_ZERO_AT_N1 = {"slice_states_bwd": ("dWs", "dbs", "dWa", "dba"),
                        "deslice_bwd": ("dx", "dWs", "dbs", "dWa", "dba")}
#: the slice backwards' launch shapes: slice_states' first and second
#: pass, deslice's first and second
SLICE_BWD_KINDS = ("slice_states_bwd_sums", "slice_states_bwd",
                   "deslice_bwd_sums", "deslice_bwd")
#: the cancelling bias gradients, held to ``SLICE_BWD_RTOL``; the others to
#: ``KERNEL_RTOL``
SLICE_BWD_BIASES = ("dbs", "dba")
#: the backwards' low-temperature edge, held to float64: ``tag: (shape,
#: weight factor)``, ``ws`` and ``wa`` of ``slice_kernels.inputs`` times
#: the factor: at C 32 twice the car's spread, logits to ~140 and ~40 % of
#: the rows at the clamp's temperature 0.1, where the residuals' rounding
#: broke the backwards before they normalised their weights by their own
#: sum. (At C 128 unscaled, ``SLICE_UNSCALED``'s spread, float32 itself
#: misses ``d b_slice`` by more than 1e-3 of its max: the plain version
#: by 5.6e-3 in a CPU run.)
SLICE_BWD_UNSCALED = {"c32_g32_x2": ((1, 8, 3001, 32, 32), 2.0)}


def slice_bwd_rtol(name: str) -> float:
    return SLICE_BWD_RTOL if name in SLICE_BWD_BIASES else KERNEL_RTOL


def f64_rel(got, ref) -> float:
    """Max abs distance of ``got`` from the float64 ``ref``, relative to
    max |ref|."""
    return (float((got.double() - ref).abs().max())
            / max(float(ref.abs().max()), 1e-30))


def tf32_control(plain_fn, args, want, kind):
    """The plain version with TF32 matrix products (one tensor-core pass,
    as a kernel without the 3xTF32 split would compute) against the float32
    plain version: each gradient's distance relative to its max, the
    reading that the tolerances must tell apart from the kernels'."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = plain_fn(*args)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    rel = {name: float((a.double() - w.double()).abs().max()
                       / w.double().abs().max())
           for name, a, w in zip(SLICE_BWD_GRADS[kind], got, want)}
    print(f"  {kind} one-pass TF32 control vs float32 plain, rel: "
          + "  ".join(f"{k} {v:.3e}" for k, v in rel.items()), flush=True)
    return rel


def slice_bwd_phase(dev, shapes, timed: bool, label: str = "phase 3b"):
    """Both slice backwards on CUDA tensors (their kernels: the fast ones
    at C <= 32, the generic ones wider) against their plain versions at
    ``shapes``, each gradient within ``slice_bwd_rtol`` of its max, and two
    calls bit-identical. When ``timed``: the one-pass TF32 control, device
    us per call with the L2 flushed (every kernel of the call), CUDA-event
    ms, the plain version's ms and device us, and the bound; returns the
    two kernel records."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    rec = {k: {"err": 0.0, "us": {}, "plain_us": {}, "bound_us": {},
               "f32_bound_us": {}, "names": set(), "ms": None, "rel": {}}
           for k in SLICE_BWD_GRADS}
    fns = {"slice_states_bwd": (sk.slice_states_bwd,
                                sk.slice_states_bwd_plain),
           "deslice_bwd": (sk.deslice_bwd, sk.deslice_bwd_plain)}
    for i, (tag, shape) in enumerate(shapes.items()):
        b, h, n, c, gs = shape
        print(f"{label}: slice_states_bwd / deslice_bwd ({tag})  x [{b}, {h}, "
              f"{n}, {c}], G {gs}; "
              f"{slice_launches(dev, shape, SLICE_BWD_KINDS)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 10 + i)
        g_st, g_out = sb.grads(shape, dev, SEED + 10 + i)
        with torch.inference_mode():
            states, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        args = {"slice_states_bwd": (x, ws, bs, wa, ba, states, m, s, g_st),
                "deslice_bwd": (x, ws, bs, wa, ba, st, m, s, g_out)}
        for kind, (fn, plain_fn) in fns.items():
            a_k = args[kind]
            ref = slice_bwd_f64(kind, x, ws, bs, wa, ba, st, a_k[-1])
            with torch.inference_mode():
                got, again, want = fn(*a_k), fn(*a_k), plain_fn(*a_k)
                torch.cuda.synchronize()
                print(f"  {kind} vs float64, rel (kernel / plain): "
                      + "  ".join(f"{nm} {f64_rel(a, r):.2e} / "
                                  f"{f64_rel(w, r):.2e}" for nm, a, w, r in
                                  zip(SLICE_BWD_GRADS[kind], got, want, ref)),
                      flush=True)
                for name, a, w in zip(SLICE_BWD_GRADS[kind], got, want):
                    if n == 1 and name in SLICE_BWD_ZERO_AT_N1[kind]:
                        check(bool(a.isfinite().all()),
                              f"{kind} {name}: non-finite values")
                        print(f"  {kind} {name}: zero in exact arithmetic "
                              f"at N = 1; max |kernel| "
                              f"{float(a.abs().max()):.3e}, max |plain| "
                              f"{float(w.abs().max()):.3e}", flush=True)
                        continue
                    err = compare(f"{kind} {name}", a, w,
                                  slice_bwd_rtol(name))
                    rec[kind]["err"] = max(rec[kind]["err"], err)
                    rec[kind]["rel"][name] = max(
                        rec[kind]["rel"].get(name, 0.0),
                        err / float(w.double().abs().max()))
                same = all(torch.equal(a, w) for a, w in zip(got, again))
                print(f"  {kind}: two calls bit-identical: {same}",
                      flush=True)
                check(same, f"{kind} at {tag} is not deterministic")
                if timed:
                    rec[kind]["tf32_control_rel"] = tf32_control(
                        plain_fn, a_k, want, kind)
                del got, again, want
                if not timed:
                    continue
                r = rec[kind]
                us, names = sb.flushed_us(lambda: fn(*a_k), 30, None)
                plain_us, _ = sb.flushed_us(lambda: plain_fn(*a_k), 10, None)
                bound = sb.bound_us(kind, shape)
                f32 = sb.bound_us(kind, shape, float32_only=True)
                r["us"][tag], r["plain_us"][tag] = us, plain_us
                r["bound_us"][tag], r["f32_bound_us"][tag] = bound[0], f32[0]
                r["names"].update(names)
                if r["ms"] is None:
                    r["ms"] = cuda_ms(lambda: fn(*a_k))
                    r["plain_ms"] = cuda_ms(lambda: plain_fn(*a_k), reps=5)
                    r["bound"] = (bound[0] / 1e3, bound[1])
                    print_times(r["ms"], r["plain_ms"], r["bound"])
                print(f"  {kind}: device {us:.2f} us per call (profiler, L2 "
                      f"flushed; {names}); plain version {plain_us:.2f} us; "
                      f"bound {bound[0]:.2f} us ({bound[1]}; 3xTF32 tensor "
                      f"cores), {bound[0] / us:.0%} of it; float32-FMA "
                      f"bound {f32[0]:.2f} us ({f32[1]}), context",
                      flush=True)
        del x, st, g_out
        torch.cuda.empty_cache()
    for kind, r in rec.items():
        print(f"  {label} {kind}: largest rel error per gradient over these "
              f"shapes: " + "  ".join(f"{k} {v:.3e}"
                                      for k, v in r["rel"].items()),
              flush=True)
    if not timed:
        return None
    replaces = {"slice_states_bwd": "haet_tpu/ops/pallas/slice_kernels.py:327",
                "deslice_bwd": "haet_tpu/ops/pallas/slice_kernels.py:448"}
    return [kernel_record(k, "haet_torch/csrc/slice_kernels.cu", replaces[k],
                          r["err"], r["ms"], r["plain_ms"], r["bound"],
                          device_us_per_call=r["us"],
                          plain_device_us_per_call=r["plain_us"],
                          bound_us=r["bound_us"],
                          float32_bound_us=r["f32_bound_us"],
                          max_rel_err=r["rel"],
                          tf32_control_rel=r["tf32_control_rel"],
                          kernel_names=sorted(r["names"]))
            for k, r in rec.items()]


def slice_bwd_f64(kind, x, ws, bs, wa, ba, st, grad, base_temp=0.5,
                  epsilon=1e-6):
    """The backward ``kind`` in float64: autograd of the softmax over the
    points (the function whose derivative the backwards compute; their
    ``(m, s)`` residuals only make its weights cheap) from the float32
    inputs."""
    import math

    import torch

    leaves = [t.double().requires_grad_() for t in (x, ws, bs, wa, ba, st)]
    xd, wsd, bsd, wad, bad, std = leaves
    tau = base_temp + (xd @ wad + bad).clamp(-0.4, 0.4)
    z = (xd @ wsd + bsd - math.log(-math.log(epsilon))) / tau
    w = torch.softmax(z, dim=2)
    if kind == "slice_states_bwd":
        out = (torch.einsum("bhng,bhnc->bhgc", w, xd)
               / (w.sum(dim=2)[..., None] + 1e-5))
        return torch.autograd.grad(out, leaves[:5], grad.double())
    out = torch.einsum("bhng,bhgc->bhnc", w, std)
    return torch.autograd.grad(out, leaves, grad.double())


def slice_bwd_unscaled_phase(dev):
    """``SLICE_BWD_UNSCALED``: both backwards' kernels and their plain
    versions against float64, the kernels within ``slice_bwd_rtol`` of
    each gradient's float64 max; prints the plain version's distance (what
    float32 itself loses there) beside the kernel's."""
    import torch

    from haet_torch.benchmarks import slice_kernels as sb
    from haet_torch.ops.kernels import slice_kernels as sk

    for i, (tag, (shape, factor)) in enumerate(SLICE_BWD_UNSCALED.items()):
        b, h, n, c, gs = shape
        print(f"phase 3b: slice_states_bwd / deslice_bwd ({tag}, weights x "
              f"{factor} against float64)  x [{b}, {h}, {n}, {c}], G {gs}; "
              f"{slice_launches(dev, shape, SLICE_BWD_KINDS)}", flush=True)
        x, ws, bs, wa, ba, st = sb.inputs(shape, dev, SEED + 40 + i)
        ws, wa = ws * factor, wa * factor
        g_st, g_out = sb.grads(shape, dev, SEED + 40 + i)
        tau = 0.5 + (x @ wa + ba).clamp(-0.4, 0.4)
        print(f"  rows at temperature 0.1: "
              f"{float((tau < 0.1 + 1e-6).float().mean()):.1%}", flush=True)
        with torch.inference_mode():
            states, m, s = sk.slice_states_plain(x, ws, bs, wa, ba)
        cases = {"slice_states_bwd": (sk.slice_states_bwd,
                                      sk.slice_states_bwd_plain,
                                      (x, ws, bs, wa, ba, states, m, s, g_st),
                                      st, g_st),
                 "deslice_bwd": (sk.deslice_bwd, sk.deslice_bwd_plain,
                                 (x, ws, bs, wa, ba, st, m, s, g_out), st,
                                 g_out)}
        for kind, (fn, plain_fn, args, st_in, grad) in cases.items():
            ref = slice_bwd_f64(kind, x, ws, bs, wa, ba, st_in, grad)
            with torch.inference_mode():
                got, plain = fn(*args), plain_fn(*args)
                torch.cuda.synchronize()
            for name, k, p, r in zip(SLICE_BWD_GRADS[kind], got, plain, ref):
                print(f"  {kind} {name}: plain float32 vs float64 rel "
                      f"{f64_rel(p, r):.3e}", flush=True)
                compare(f"{kind} {name} vs float64", k, r,
                        slice_bwd_rtol(name))
        del x, st, g_out
        torch.cuda.empty_cache()


def plain_bwd_ms(xe, pe, dout, params, kw):
    """ms of the plain block's backward alone: autograd of a recorded plain
    forward."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    leaves = [t.detach().requires_grad_()
              for t in (xe, pe, *(params[k] for k in eb.GRAD_NAMES))]
    lp = dict(zip(eb.GRAD_NAMES, leaves[2:]),
              **{"BMSA.sigma_att": params["BMSA.sigma_att"]})
    out = eb.erwin_block_plain(leaves[0], leaves[1], lp, **kw)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                               retain_graph=True))


def backward_phase(dev, records):
    """Checks and times the backwards; adds the backward kernel's record to
    ``records`` and the slice backwards' times to their forwards' records."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb
    from haet_torch.ops.kernels import slice_kernels as sk

    g = torch.Generator().manual_seed(SEED + 2)
    check(len(eb.GRAD_NAMES) == 14, f"{len(eb.GRAD_NAMES)} parameter grads")

    def erwin_bwd_case(n_e, c_e, ball):
        """The backward kernel's largest error against autograd of the plain
        block over dx, dpos and every parameter gradient; a second call on
        the same inputs must give bit-identical results (no atomics: the
        ranks' and the clouds' partials are summed in a fixed order)."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball)
        dout = torch.randn(8, n_e, c_e, generator=g).to(dev)
        dx_k, dpos_k, gr_k = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_2, dpos_2, gr_2 = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_p, dpos_p, gr_p = eb.erwin_block_bwd_plain(xe, pe, dout, params,
                                                      **kw)
        torch.cuda.synchronize()
        errs = [compare("dx", dx_k, dx_p, KERNEL_RTOL),
                compare("dpos", dpos_k, dpos_p, KERNEL_RTOL)]
        errs += [compare(f"d {k}", gr_k[k], gr_p[k], KERNEL_RTOL)
                 for k in eb.GRAD_NAMES]
        same = (torch.equal(dx_k, dx_2) and torch.equal(dpos_k, dpos_2)
                and all(torch.equal(gr_k[k], gr_2[k]) for k in eb.GRAD_NAMES))
        print(f"  two calls bit-identical (dx, dpos, 14 gradients): {same}",
              flush=True)
        check(same, f"backward at n {n_e} / C {c_e} is not deterministic")
        return xe, pe, params, kw, dout, max(errs)

    errs, times, plain_times, bounds, dev_us = [], [], [], [], {}
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3b: fused_erwin_block_bwd  x [8, {n_e}, {c_e}], 8 "
              f"heads, ball {ball}; {erwin_launch_line(n_e, c_e, ball)}",
              flush=True)
        xe, pe, params, kw, dout, err = erwin_bwd_case(n_e, c_e, ball)
        errs.append(err)
        def fn():
            return eb.fused_erwin_block_bwd(xe, pe, dout, params, **kw)
        times.append((cuda_ms(fn), weight))
        dev_us[f"n{n_e}_c{c_e}"] = device_us(fn, ERWIN_BWD_KERNELS)
        plain_times.append((plain_bwd_ms(xe, pe, dout, params, kw), weight))
        bounds.append((erwin_bwd_bound(n_e, c_e, ball), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
        print(f"  device {dev_us[f'n{n_e}_c{c_e}']:.2f} us per call "
              f"(profiler, erwin_block_bwd + erwin_block_sum_partials)",
              flush=True)
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    records.append(kernel_record(
        "fused_erwin_block_bwd", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:187", max(errs), mix(times),
        mix(plain_times),
        (mix([(bd[0], w) for bd, w in bounds]),
         "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
         else "operations"),
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]},
        device_us_per_call=dev_us))
    for n_e, c_e, ball in ERWIN_EDGES:
        layout = eb.bwd_layout(n_e, c_e, 3, 4 * c_e, 8, min(ball, n_e))
        nbuf = len(eb.BWD_BUFFERS)
        spills = [name for (name, _), in_smem in
                  zip(eb.BWD_BUFFERS, layout.ints[nbuf:2 * nbuf])
                  if not in_smem]
        print(f"phase 3b: fused_erwin_block_bwd at a gate edge  x [8, "
              f"{n_e}, {c_e}], ball {ball}; "
              f"{erwin_launch_line(n_e, c_e, ball)}; in global memory "
              f"{spills}", flush=True)
        erwin_bwd_case(n_e, c_e, ball)

    records.extend(slice_bwd_phase(dev, {"train_b1": SLICE_TIMED["train_b1"]},
                                   timed=True))
    slice_bwd_phase(dev, SLICE_EDGES, timed=False)
    slice_bwd_unscaled_phase(dev)

    print(f"phase 3b: SliceStatesFn / DesliceFn backward  x [1, 8, "
          f"{N_PADDED}, 32], G 32, against autograd of the plain versions",
          flush=True)
    b, h, n, c, gs = 1, 8, N_PADDED, 32, 32
    x = torch.randn(b, h, n, c, generator=g).to(dev)
    ws = (0.3 * torch.randn(c, gs, generator=g)).to(dev)
    bs = (0.1 * torch.randn(gs, generator=g)).to(dev)
    wa = (0.1 * torch.randn(c, 1, generator=g)).to(dev)
    ba = torch.zeros(1).to(dev)
    st_in = torch.randn(b, h, gs, c, generator=g).to(dev)
    g_st = torch.randn(b, h, gs, c, generator=g).to(dev)
    g_out = torch.randn(b, h, n, c, generator=g).to(dev)

    def grads(f_states, f_deslice):
        leaves = [t.detach().requires_grad_()
                  for t in (x, ws, bs, wa, ba, st_in)]
        st, m, s = f_states(*leaves[:5])
        out = f_deslice(*leaves[:5], leaves[5], m, s)
        return torch.autograd.grad([st, out], leaves, [g_st, g_out])

    got = grads(sk.slice_states, sk.deslice)
    want = grads(sk.slice_states_plain, sk.deslice_plain)
    torch.cuda.synchronize()
    err = max(compare(f"d {k}", a, w, SLICE_BWD_RTOL if k.startswith("b_")
                      else KERNEL_RTOL)
              for k, a, w in zip(("x", "w_slice", "b_slice", "w_ada", "b_ada",
                                  "states"), got, want))
    for r in records:
        if r["name"] in SLICE_BWD_GRADS:
            r["autograd_max_abs_err"] = err
    print("  no single PyTorch call computes the block's backward or the "
          "slice backwards: library_ms is null", flush=True)


# ---------------------------------------------------------------------------
# Phase 4: serve the car preset through the kernels.
# ---------------------------------------------------------------------------

def serve_phase(dev):
    import torch

    from haet_torch.models import HAETransolverIrregularMesh
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)
    from haet_torch.serve import BatchingServer, SampleSignature
    from haet_torch.utils.config import shapenet_car_config

    kwargs = shapenet_car_config().model_kwargs()
    kwargs.update(use_pallas=True)
    model = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=True,
                                       device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 1_757_190, f"car preset has {n_params} params")
    # Perturb the init weights so the Erwin stage moves the output (at init
    # the slice path dominates and would hide a wrong Erwin block).
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
    kwargs.update(use_pallas=False)
    plain = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=False,
                                       device=dev, seed=SEED)
    plain.load_state_dict(model.state_dict())
    plain.eval()
    model.eval()

    rng = np.random.RandomState(SEED)
    samples = [rng.randn(N_POINTS, 7).astype(np.float32) for _ in range(11)]
    sig = SampleSignature(((N_POINTS, 7), None), ("float32", None))
    with torch.inference_mode():  # warm-up: library loads, allocator
        model(torch.from_numpy(samples[0][None]).to(dev))
        torch.cuda.synchronize()

    reset_launch_counts()
    outs = {}
    lat_seq = []
    with BatchingServer(model, {sig: (1, 2, 4)}, max_delay_s=0.0,
                        device=dev) as srv:
        for i in range(4):
            t0 = time.perf_counter()
            outs[i] = srv.predict(samples[i], None, timeout=300)
            lat_seq.append(time.perf_counter() - t0)
        stats_seq = srv.stats.snapshot()
    t_burst = time.perf_counter()
    with BatchingServer(model, {sig: (1, 2, 4)}, max_delay_s=2.0,
                        device=dev) as srv:
        futs = {i: srv.submit(samples[i], None) for i in range(4, 11)}
        for i, f in futs.items():
            outs[i] = f.result(timeout=300)
        stats_burst = srv.stats.snapshot()
    t_burst = time.perf_counter() - t_burst
    counts = launch_counts()
    plain_routes = plain_route_counts()

    forwards = stats_seq["dispatches"] + stats_burst["dispatches"]
    print(f"  sequential batch histogram {stats_seq['batch_histogram']}; "
          f"burst batch histogram {stats_burst['batch_histogram']}",
          flush=True)
    check(stats_burst["batch_histogram"].get(4, 0) >= 1,
          "no batch of 4 formed")
    check(len(outs) == 11, "not every request was answered")
    for i, o in outs.items():
        check(o.shape == (N_POINTS, 4), f"request {i}: shape {o.shape}")
        check(bool(np.isfinite(o).all()), f"request {i}: non-finite output")
    want = {"slice_states": 2 * forwards, "deslice": 2 * forwards,
            "slice_states_bwd": 0, "deslice_bwd": 0,
            "fused_erwin_block": 24 * forwards, "fused_erwin_block_bwd": 0,
            "copy_scale": 0}
    print(f"  forwards {forwards}; launches {counts}; expected {want}",
          flush=True)
    check(counts == want, f"launch counts {counts} != {want}")
    print(f"  calls routed to a plain version {plain_routes}", flush=True)
    check(all(v == 0 for v in plain_routes.values()),
          f"some calls left the kernels: {plain_routes}")

    # Agreement with the plain path on the same weights and inputs (the
    # burst's batch of 4 is compared as that same batch: outputs depend on
    # the co-batched samples through the global min-max positions).
    with torch.inference_mode():
        ref1 = plain(torch.from_numpy(samples[0][None]).to(dev))[0]
        got1 = torch.from_numpy(outs[0]).to(dev)
        compare("serve batch-1 vs plain path", got1, ref1, SERVE_RTOL)
        batch4 = np.stack([samples[i] for i in range(4, 8)])
        ref4 = plain(torch.from_numpy(batch4).to(dev))
        got4 = torch.from_numpy(np.stack([outs[i] for i in range(4, 8)])
                                ).to(dev)
        compare("serve batch-4 vs plain path", got4, ref4, SERVE_RTOL)

    lat_all = stats_seq["latency_p50_s"], stats_burst["latency_p50_s"]
    print(f"  sequential latency per request (s): "
          f"{[round(t, 6) for t in lat_seq]}; p50 {lat_all[0]:.6f}",
          flush=True)
    print(f"  burst: 7 requests in {t_burst:.4f} s (includes the 2 s "
          f"max_delay of the remainder), p50 latency {lat_all[1]:.6f} s",
          flush=True)
    print(f"  sequential throughput {4 / sum(lat_seq):.3f} samples/s",
          flush=True)
    return counts, forwards, model, samples[0]


def profile_phase(model, sample, dev):
    """Where one batch-1 forward's time goes: device time by kernel
    (torch.profiler) against the forward's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from haet_torch.utils.profiling import kernel_events

    x = torch.from_numpy(sample[None]).to(dev)
    with torch.inference_mode():
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    wall_ms = 1e3 * min(walls)
    events = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  forward wall {wall_ms:.3f} ms (min of 5); device time "
          f"{device_ms:.3f} ms in {sum(e.count for e in events)} kernels; "
          f"device busy share {device_ms / wall_ms:.3f}", flush=True)
    for e in events[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: train the car preset through the kernels.
# ---------------------------------------------------------------------------

def train_phase(dev):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from haet_torch.models import HAETransolverIrregularMesh
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.train import Trainer
    from haet_torch.train.graphs import WARMUP
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.train.car import loss_fn_builder, make_batch
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)
    from haet_torch.utils.profiling import kernel_events

    kwargs = shapenet_car_config().model_kwargs()
    cfg = shapenet_car_train_config()
    rng = np.random.RandomState(SEED + 4)
    x = rng.randn(N_POINTS, 7).astype(np.float32)
    y = rng.randn(N_POINTS, 4).astype(np.float32)
    surf = np.zeros(N_POINTS, bool)
    surf[-N_SURFACE:] = True   # surface points come last in a car sample
    batch = make_batch(CarSample(x[:, :3], x, y, surf))
    check(batch["x"].shape == (1, N_PADDED, 7),
          f"padded batch {batch['x'].shape}")

    def build(flags, eager=False):
        kwargs.update(use_pallas=flags)
        model = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=flags,
                                           device=dev, seed=SEED)
        g = torch.Generator().manual_seed(SEED + 3)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
        return model, Trainer(model, loss_fn_builder(0.5), cfg,
                              total_steps=TRAIN_STEPS + 1,
                              batch_args=lambda bt: (bt["x"], None),
                              eager=eager)

    # The plain path (both flags off, step by step) first: step 1's
    # gradients are kept, two more steps are timed, and the plain model is
    # dropped before the kernel run's memory peak.
    plain, trainer = build(False, eager=True)
    torch.cuda.reset_peak_memory_stats()
    m_plain = {k: float(v) for k, v in trainer.train_step(batch).items()}
    want = {k: None if p.grad is None else p.grad.detach().clone()
            for k, p in plain.named_parameters()}
    plain_walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        plain_walls.append(time.perf_counter() - t0)
    plain_peak_mb = torch.cuda.max_memory_allocated() / 2**20
    del plain, trainer
    torch.cuda.empty_cache()

    model, trainer = build(True)
    check(sum(p.numel() for p in model.parameters()) == 1_757_190,
          "car preset size")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    walls, losses = [], []
    for step in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        check(all(np.isfinite(v) for v in m.values()),
              f"step {step + 1}: non-finite metrics {m}")
        if step == 0:
            check(abs(m["loss"] - m_plain["loss"])
                  <= GRAD_RTOL * abs(m_plain["loss"]),
                  f"step 1 loss {m['loss']} vs plain {m_plain['loss']}")
            print(f"  step 1: kernels {m}; plain path {m_plain}",
                  flush=True)
            gmax = max(float(g.abs().max()) for g in want.values()
                       if g is not None)
            worst, noise = (0.0, ""), 0
            for name, p in model.named_parameters():
                if name.endswith("sigma_att"):
                    check(p.grad is None and want[name] is None,
                          f"{name} has a gradient")
                    continue
                check(p.grad is not None, f"{name} has no gradient")
                check(bool(p.grad.isfinite().all()),
                      f"{name}: non-finite gradient")
                err = float((p.grad - want[name]).abs().max())
                scale = float(want[name].abs().max())
                tol = max(GRAD_RTOL * scale, GRAD_ATOL * gmax)
                check(err <= tol, f"{name}: gradient error {err} > {tol} "
                                  f"(max |plain grad| {scale})")
                if scale >= GRAD_ATOL * gmax:
                    worst = max(worst, (err / scale, name))
                else:
                    noise += 1
            print(f"  step 1 gradients: every leaf within tolerance; largest "
                  f"error relative to its leaf's max |grad| {worst[0]:.3e} "
                  f"({worst[1]}) over the leaves above {GRAD_ATOL:g} of the "
                  f"largest |grad| {gmax:.3e}; {noise} leaves below it (zero "
                  f"up to round-off)", flush=True)
    counts = launch_counts()
    plain_routes = plain_route_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # the steps are replays of one CUDA graph: the counters rose during its
    # warm-up and capture, and not on a replay
    captured = len(trainer.graphs) * (WARMUP + 1)
    want_counts = {k: v * captured for k, v in PER_STEP.items()}
    print(f"  {TRAIN_STEPS} steps, replays of {len(trainer.graphs)} graph "
          f"(captured in {trainer.graphs.capture_s[0]:.3f} s, {WARMUP} "
          f"warm-up steps thrown away); host launch counters {counts}; "
          f"expected {want_counts}", flush=True)
    check(counts == want_counts, f"launch counts {counts} != {want_counts}")
    print(f"  calls routed to a plain version {plain_routes}", flush=True)
    check(all(v == 0 for v in plain_routes.values()),
          f"some calls left the kernels: {plain_routes}")
    for name, p in model.named_parameters():
        check(bool(p.isfinite().all()), f"{name}: non-finite after training")
    print(f"  losses {losses}", flush=True)
    print(f"  step wall (s) {[round(t, 6) for t in walls]}; min "
          f"{min(walls[1:]):.6f} median {float(np.median(walls[1:])):.6f} "
          f"(steps 2-{TRAIN_STEPS}); peak device memory allocated "
          f"{peak_mb:.1f} MiB", flush=True)
    print(f"  plain path (both flags off): step wall (s) "
          f"{[round(t, 6) for t in plain_walls]} (steps 2-3); peak device "
          f"memory allocated {plain_peak_mb:.1f} MiB", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    events = kernel_events(prof)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    wall_ms = 1e3 * min(walls[1:])
    print(f"  profiled step (a replay): device time {device_ms:.3f} ms in "
          f"{sum(e.count for e in events)} kernels; busy share "
          f"{device_ms / wall_ms:.3f} of the min step wall {wall_ms:.3f} ms",
          flush=True)
    for e in events[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    _, replay = profile_launches(trainer.train_step, batch)
    expect_counts("kernel calls in one replay, from the profiler",
                  replay["calls"], PER_STEP)
    return counts, replay["calls"]


# ---------------------------------------------------------------------------
# Phase 7: the benchmark drivers and the copy kernel.
# ---------------------------------------------------------------------------

COPY_CHAIN = 1050            # the micro driver's hi window
#: the copy kernel's large timed shape: 64 MiB each way, past the 50 MB L2
COPY_LARGE = (4096, 4096)
#: the micro driver's reduced lo/hi windows and rounds
MICRO_REPS = dict(reps_lo=20, reps_hi=220, rounds=3)
#: bench_flags' reduced windows: k_lo/k_hi steps and rounds
FLAGS_STEPS = dict(k_lo=1, k_hi=3, rounds=2)
#: bench_loop_diag's and profile_step's windows, at the car's 32768 points
LOOP_DIAG = dict(ks=(1, 3), rounds=1)
PROFILE_STEP = dict(lo=1, hi=2, rounds=1)
#: bench_flags' --slice_num past the old G*C gate of the slice kernels
FLAGS_WIDE_G = 128
#: the slice kernels' check and the memory probes: ~30x the car's points
N_LARGE = 1 << 20


def copy_phase(dev):
    """7a: ``copy_scale`` bit-exact against its plain version after one
    call and after ``COPY_CHAIN`` chained calls; its record, with the time
    of ``torch.mul`` as the library time."""
    import torch

    from haet_torch.benchmarks.copy_scale import graph_us
    from haet_torch.ops.kernels import copy_kernel as ck

    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn(256, 32, generator=g).to(dev)
    print("phase 7a: copy_scale  x [256, 32] f32", flush=True)
    got, want = ck.copy_scale(x), ck.copy_scale_plain(x)
    chained, want_chain = ck.chain_copy(x, COPY_CHAIN), x
    for _ in range(COPY_CHAIN):
        want_chain = ck.copy_scale_plain(want_chain)
    torch.cuda.synchronize()
    err = max(float((got - want).abs().max()),
              float((chained - want_chain).abs().max()))
    print(f"  1 call: bit-exact {torch.equal(got, want)}; {COPY_CHAIN} "
          f"chained calls: bit-exact {torch.equal(chained, want_chain)}",
          flush=True)
    check(torch.equal(got, want), "copy_scale differs from x * 1.000001")
    check(torch.equal(chained, want_chain),
          f"chain_copy differs after {COPY_CHAIN} calls")
    # The kernel's other two routes: an input 4 bytes past a 16-byte
    # boundary (the scalar kernel), and an aligned one of 8191 elements
    # (float4 loads and a scalar tail of 3).
    flat = x.view(-1)
    for what, xs in (("unaligned [8191]", flat[1:]),
                     ("aligned [8191], tail 3", flat[:-1])):
        got_s, want_s = ck.copy_scale(xs), ck.copy_scale_plain(xs)
        torch.cuda.synchronize()
        print(f"  {what}: bit-exact {torch.equal(got_s, want_s)}",
              flush=True)
        check(torch.equal(got_s, want_s),
              f"copy_scale differs from x * 1.000001 on the {what} input")
        err = max(err, float((got_s - want_s).abs().max()))
    ms = cuda_ms(lambda: ck.copy_scale(x), reps=200)
    plain_ms = cuda_ms(lambda: ck.copy_scale_plain(x), reps=200)
    library_ms = cuda_ms(lambda: torch.mul(x, ck.SCALE), reps=200)
    # On the card's own clock: the event times above are the host's launch
    # rate at this size (the ctypes wrapper against torch.mul's dispatch).
    dev = {"copy_scale": device_us(lambda: ck.copy_scale(x), reps=200),
           "torch.mul": device_us(lambda: torch.mul(x, ck.SCALE), reps=200)}
    # and from a CUDA graph of 100 calls: the card's time per call with
    # no host in the way
    graph = {"copy_scale": graph_us(lambda: ck.copy_scale(x)),
             "torch.mul": graph_us(lambda: torch.mul(x, ck.SCALE))}
    bound = bound_ms(2 * 4 * x.numel(), x.numel())
    print_times(ms, plain_ms, bound)
    print(f"  library torch.mul {library_ms:.4f} ms; device us per call "
          f"(profiler): copy_scale {dev['copy_scale']:.3f}, torch.mul "
          f"{dev['torch.mul']:.3f}; in a CUDA graph: copy_scale "
          f"{graph['copy_scale']:.3f}, torch.mul {graph['torch.mul']:.3f}",
          flush=True)
    large = copy_large(ck)
    rec = kernel_record("copy_scale", "haet_torch/csrc/copy_kernel.cu",
                        "benchmarks/micro_erwin_fused.py:70", err, ms,
                        plain_ms, bound,
                        device_us_per_call=dev["copy_scale"],
                        library_device_us_per_call=dev["torch.mul"],
                        graph_us_per_call=graph["copy_scale"],
                        library_graph_us_per_call=graph["torch.mul"],
                        **large)
    rec["library_ms"] = library_ms
    return rec


def copy_large(ck):
    """7a at ``COPY_LARGE`` (64 MiB each way, past the L2): bit-exact,
    then the kernel's and ``torch.mul``'s device time per call (profiler)
    and events time, and the bytes bound."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.randn(COPY_LARGE, generator=g, device="cuda")
    print(f"phase 7a: copy_scale  x {list(COPY_LARGE)} f32", flush=True)
    got, want = ck.copy_scale(x), ck.copy_scale_plain(x)
    torch.cuda.synchronize()
    print(f"  bit-exact {torch.equal(got, want)}", flush=True)
    check(torch.equal(got, want),
          f"copy_scale differs from x * 1.000001 at {list(COPY_LARGE)}")
    del got, want
    bound = bound_ms(2 * 4 * x.numel(), x.numel())
    ms = cuda_ms(lambda: ck.copy_scale(x), reps=50)
    library_ms = cuda_ms(lambda: torch.mul(x, ck.SCALE), reps=50)
    us = device_us(lambda: ck.copy_scale(x), reps=50)
    library_us = device_us(lambda: torch.mul(x, ck.SCALE), reps=50)
    print(f"  device us per call (profiler): copy_scale {us:.3f}, torch.mul "
          f"{library_us:.3f} (ratio {us / library_us:.4f}); bound "
          f"{bound[0] * 1e3:.3f} us ({bound[1]}), {bound[0] * 1e3 / us:.3f} "
          f"of it; events ms copy_scale {ms:.5f}, torch.mul "
          f"{library_ms:.5f}", flush=True)
    return {"large_shape": list(COPY_LARGE), "large_ms": ms,
            "large_library_ms": library_ms,
            "large_device_us_per_call": us,
            "large_library_device_us_per_call": library_us,
            "large_bound_ms": bound[0]}


#: 7b's Erwin block shapes, ``tag: (n, C, ball, heads, mlp_ratio)``: the
#: micro driver's block, and the two that bench_flags' ``pallas-erwin``
#: model runs (constructor defaults: Erwin mlp_ratio 2, heads 4/8/4)
DRIVER_SHAPES = {"micro": (32, 32, 32, 4, 4),
                 "flags_n32_c32": (32, 32, 32, 4, 2),
                 "flags_n16_c64": (16, 64, 16, 8, 2)}


def driver_shape_phase(dev, records):
    """7b: the Erwin forward and backward kernels at the drivers' block
    shapes (``DRIVER_SHAPES``; 4 heads and SwiGLU 2C are shapes the car
    never uses) against the plain block at phase 3/3b's tolerance: out,
    dx, dpos and every parameter gradient. Their times, bounds and errors
    go into the forward and backward records as ``<tag>_*``."""
    import torch

    from haet_torch.ops.kernels import erwin_block as eb

    g = torch.Generator().manual_seed(SEED + 6)
    for tag, (n_e, c_e, ball, heads, ratio) in DRIVER_SHAPES.items():
        print(f"phase 7b: fused_erwin_block fwd/bwd ({tag})  x [8, {n_e}, "
              f"{c_e}], {heads} heads, ball {ball}, SwiGLU {ratio * c_e}; "
              f"{erwin_launch_line(n_e, c_e, ball, heads, ratio)}",
              flush=True)
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball, heads,
                                          ratio)
        dout = torch.randn(8, n_e, c_e, generator=g).to(dev)
        with torch.inference_mode():
            o_k = eb.fused_erwin_block(xe, pe, params, **kw)
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err_f = compare("out", o_k, o_p, KERNEL_RTOL)
        dx_k, dpos_k, gr_k = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_p, dpos_p, gr_p = eb.erwin_block_bwd_plain(xe, pe, dout, params,
                                                      **kw)
        torch.cuda.synchronize()
        err_b = max([compare("dx", dx_k, dx_p, KERNEL_RTOL),
                     compare("dpos", dpos_k, dpos_p, KERNEL_RTOL)]
                    + [compare(f"d {k}", gr_k[k], gr_p[k], KERNEL_RTOL)
                       for k in eb.GRAD_NAMES])
        with torch.inference_mode():
            fwd = (cuda_ms(lambda: eb.fused_erwin_block(xe, pe, params,
                                                        **kw)),
                   cuda_ms(lambda: eb.erwin_block_plain(xe, pe, params,
                                                        **kw)))
            fwd_us = device_us(lambda: eb.fused_erwin_block(
                xe, pe, params, **kw), ERWIN_FWD_KERNELS)
        bwd = (cuda_ms(lambda: eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                        **kw)),
               plain_bwd_ms(xe, pe, dout, params, kw))
        bwd_us = device_us(lambda: eb.fused_erwin_block_bwd(
            xe, pe, dout, params, **kw), ERWIN_BWD_KERNELS)
        w_elems, flops = erwin_work(n_e, c_e, ball, heads, ratio)
        bounds = {"fused_erwin_block": bound_ms(
                      4 * (2 * 8 * n_e * c_e + 8 * n_e * 3 + w_elems), flops),
                  "fused_erwin_block_bwd": erwin_bwd_bound(n_e, c_e, ball,
                                                           heads, ratio)}
        times = {"fused_erwin_block": (fwd, err_f, fwd_us),
                 "fused_erwin_block_bwd": (bwd, err_b, bwd_us)}
        for r in records:
            if r["name"] in times:
                (ms, plain_ms), err, us = times[r["name"]]
                r.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                          f"{tag}_bound_ms": bounds[r["name"]][0],
                          f"{tag}_max_abs_err": err})
                r["device_us_per_call"][tag] = us
                print(f"  {r['name']}:", flush=True)
                print_times(ms, plain_ms, bounds[r["name"]])
                print(f"  device {us:.2f} us per call (profiler)",
                      flush=True)


def large_slice_phase(dev):
    """7c: the slice kernels, untimed, at ``N_LARGE`` points, the memory
    probes' size."""
    slice_phase(dev, {"large": (1, 8, N_LARGE, 32, 32)}, timed=False,
                label="phase 7c")


def expect_counts(what, counts, want):
    print(f"  {what}: {counts}; expected {want}", flush=True)
    check(counts == want, f"{what}: {counts} != {want}")


def drivers_phase(dev):
    """7d-7g: run each benchmark driver briefly on the card and check from
    the launch counters that its kernel paths went through the kernels.
    Returns the copy kernel's launch count after the micro driver's run."""
    import torch

    from haet_torch import bench
    from haet_torch.benchmarks import (bench_flags, bench_loop_diag,
                                       mem_sweep, profile_step)
    from haet_torch.benchmarks import micro_erwin_fused as micro
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        reset_launch_counts)

    no_routes = {k: 0 for k in plain_route_counts()}
    print(f"phase 7d: micro_erwin_fused {MICRO_REPS}", flush=True)
    reset_launch_counts()
    res = micro.run(dev, **MICRO_REPS)
    counts, routes = launch_counts(), plain_route_counts()
    calls = res["copy_calls"]   # the driver's chained calls per line
    expect_counts("launches", counts, {
        "slice_states": 0, "deslice": 0, "slice_states_bwd": 0,
        "deslice_bwd": 0, "fused_erwin_block": 2 * calls,
        "fused_erwin_block_bwd": calls, "copy_scale": calls})
    expect_counts("plain routes", routes, no_routes)
    for name in ("copy_scale", "fused block fwd", "fused block fwd+bwd"):
        check(res[name]["device_us"] is not None
              and res[name]["device_us"] > 0, f"{name}: no device time")
    copy_launches = counts["copy_scale"]

    print(f"phase 7e: bench_flags {FLAGS_STEPS}", flush=True)
    reset_launch_counts()
    res = bench_flags.run(dev, **FLAGS_STEPS)
    print(f"phase 7e: bench_flags {FLAGS_STEPS}, pallas-tokenizer at "
          f"--slice_num {FLAGS_WIDE_G} (G*C {32 * FLAGS_WIDE_G})", flush=True)
    wide = bench_flags.run(dev, slice_num=FLAGS_WIDE_G,
                           variants=["pallas-tokenizer"], **FLAGS_STEPS)
    res[f"pallas-tokenizer G {FLAGS_WIDE_G}"] = wide["pallas-tokenizer"]
    for name, r in res.items():
        blocks = r["erwin_blocks"]
        check(blocks == 12, f"{name}: {blocks} Erwin blocks, expected 12 "
                            "(2 layers of depths 2/2/2)")
        check(np.isfinite(r["ms_per_step"]), f"{name}: step time")
        want = {"slice_states": 0, "deslice": 0, "slice_states_bwd": 0,
                "deslice_bwd": 0, "fused_erwin_block": 0,
                "fused_erwin_block_bwd": 0, "copy_scale": 0}
        if name.startswith("pallas-tokenizer"):
            want.update(slice_states=2, deslice=2, slice_states_bwd=2,
                        deslice_bwd=2)
        elif name == "pallas-erwin":
            want.update(fused_erwin_block=blocks,
                        fused_erwin_block_bwd=blocks)
        expect_counts(f"{name} launches per step ({r['steps']} steps)",
                      r["launches_per_step"], want)
        expect_counts(f"{name} plain routes per step",
                      r["plain_routes_per_step"], no_routes)
        check(r["graph_ms_per_step"] is not None
              and np.isfinite(r["graph_ms_per_step"]),
              f"{name}: graph step time {r['graph_ms_per_step']}")
        expect_counts(f"{name} kernel calls per replayed step (profiler)",
                      r["graph_calls_per_step"], want)
        print(f"  {name}: ms per step dispatched {r['ms_per_step']:.3f}, "
              f"graph {r['graph_ms_per_step']:.3f}; device "
              f"{r['device_ms_per_step']:.3f} and "
              f"{r['graph_device_ms_per_step']:.3f}", flush=True)

    print("phase 7f: haet_torch.bench, 2 rounds", flush=True)
    rec = bench.run(dev, budget_s=0.0, rounds=2)
    print(f"  {json.dumps(rec)}", flush=True)
    check(np.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench value {rec['value']}")
    check(rec["mfu"] is not None and 0 < rec["mfu"] < 1,
          f"bench mfu {rec['mfu']}")
    for s in ("dispatch", "graph"):
        check(np.isfinite(rec[f"{s}_sec_per_step"])
              and rec[f"{s}_sec_per_step"] > 0,
              f"bench {s} seconds per step {rec[f'{s}_sec_per_step']}")
    check(rec["sec_per_step"] == min(rec["dispatch_sec_per_step"],
                                     rec["graph_sec_per_step"]),
          "bench does not report the better strategy")
    del rec
    torch.cuda.empty_cache()

    print(f"phase 7h: bench_loop_diag {LOOP_DIAG}, then profile_step "
          f"{PROFILE_STEP}", flush=True)
    diag = bench_loop_diag.run(dev, points=N_PADDED, **LOOP_DIAG)
    for v, r in diag.items():
        check(all(np.isfinite(t) and t > 0
                  for t in r["ms_per_window"].values()),
              f"bench_loop_diag {v}: windows {r['ms_per_window']}")
    prof = profile_step.run(dev, points=N_PADDED, **PROFILE_STEP)
    for name, r in prof.items():
        check(r["graph_wall_ms"] is not None
              and np.isfinite(r["graph_wall_ms"]),
              f"profile_step {name}: graph wall {r['graph_wall_ms']}")
    torch.cuda.empty_cache()

    print(f"phase 7g: mem_sweep probes at N = {N_LARGE}, forward only, "
          f"each in a fresh process", flush=True)
    probes = {}
    for pallas in (False, True):
        probes[pallas] = p = mem_sweep.probe_subprocess(N_LARGE, pallas)
        print(f"  {json.dumps(p)}", flush=True)
        check(p.get("ok") is True, f"probe pallas={pallas} failed: {p}")
        n = int(pallas)
        check(p["slice_launches"] == {"slice_states": n, "deslice": n},
              f"probe pallas={pallas}: slice launches {p['slice_launches']}")
    plain_mb, kernel_mb = (probes[False]["peak_memory_mb"],
                           probes[True]["peak_memory_mb"])
    print(f"  peak device memory: plain path {plain_mb:.1f} MiB, slice "
          f"kernels {kernel_mb:.1f} MiB", flush=True)
    check(kernel_mb < plain_mb,
          f"kernel path peak {kernel_mb} MiB is not below plain {plain_mb}")
    return copy_launches


# ---------------------------------------------------------------------------
# Phase 8: the car preset's training run (Trainer.fit) and its drivers.
# ---------------------------------------------------------------------------

FIT_EPOCHS = 3
#: car_like samples of a ShapeNet-Car size: 3 for training, 1 held out
FIT_SAMPLES = 4
#: kernel launches per train step and per eval forward of the car preset
PER_STEP = {"slice_states": 2, "deslice": 2, "slice_states_bwd": 2,
            "deslice_bwd": 2, "fused_erwin_block": 24,
            "fused_erwin_block_bwd": 24, "copy_scale": 0}
PER_FORWARD = {"slice_states": 2, "deslice": 2, "slice_states_bwd": 0,
               "deslice_bwd": 0, "fused_erwin_block": 24,
               "fused_erwin_block_bwd": 0, "copy_scale": 0}
RESUME_RTOL = 1e-5
#: rounds of (bare, fit, fit, bare) for fit's overhead per step
WALL_ROUNDS = 3
DRIVER_EPOCHS = 2


def expected_launches(steps: int, forwards: int) -> dict:
    return {k: PER_STEP[k] * steps + PER_FORWARD[k] * forwards
            for k in PER_STEP}


def car_fold():
    """``car_like(n=4, npts=32186, seed=0)`` as normalised ``CarSample``s
    (statistics of the 3 training samples), split 3 / 1."""
    from haet_torch.data import synthetic
    from haet_torch.data.shapenet_car import CarSample, compute_coef_norm
    from haet_torch.train.car import bucket_size

    raw = synthetic.car_like(n=FIT_SAMPLES, npts=N_POINTS, seed=0)
    samples = [CarSample(pos=d["pos"], x=d["x"], y=d["y"], surf=d["surf"],
                         name=f"synthetic/{i}", quads=d["quads"],
                         surf_slice=d["surf_slice"])
               for i, d in enumerate(raw)]
    coef = compute_coef_norm(samples[:3])
    samples = [coef.encode(s) for s in samples]
    print("  samples (points -> bucket): " + ", ".join(
        f"{len(s.pos)} -> {bucket_size(len(s.pos))}" for s in samples),
        flush=True)
    return samples[:3], samples[3:], coef


def state_on_cpu(trainer) -> dict:
    """The trainer's model and Adam tensors, and the rest of its state,
    copied to the host."""
    import torch

    def host(v):
        return v.detach().cpu().clone() if isinstance(v, torch.Tensor) else v
    sd = trainer.state_dict()
    return {"model": {k: host(v) for k, v in sd["model"].items()},
            "adam": {(i, k): host(v)
                     for i, st in sd["optimizer"]["state"].items()
                     for k, v in st.items()},
            "groups": sd["optimizer"]["param_groups"],
            "scheduler": sd["scheduler"], "step": sd["step"]}


def compare_states(got: dict, want: dict) -> bool:
    """Every model and Adam tensor within ``RESUME_RTOL`` of its max, the
    rest equal; returns whether every tensor is bit-identical."""
    import torch

    check(got["step"] == want["step"], f"step {got['step']} != "
                                       f"{want['step']}")
    check(got["scheduler"] == want["scheduler"], "OneCycleLR state differs")
    check(got["groups"] == want["groups"], "Adam's param groups differ")
    identical, worst = True, (0.0, "")
    for part in ("model", "adam"):
        check(sorted(map(str, got[part])) == sorted(map(str, want[part])),
              f"{part} keys differ")
        for k, w in want[part].items():
            g = got[part][k]
            if w.is_floating_point():
                err = float((g.double() - w.double()).abs().max())
                tol = RESUME_RTOL * max(float(w.double().abs().max()), 1e-30)
                check(err <= tol, f"resume: {part} {k} differs by {err} > "
                                  f"{tol}")
                worst = max(worst, (err / max(tol / RESUME_RTOL, 1e-30),
                                    f"{part} {k}"))
            identical = identical and torch.equal(g, w)
    print(f"  resumed run against the unbroken one: largest error "
          f"relative to its leaf's max {worst[0]:.3e} ({worst[1]}); "
          f"bit-identical {identical}", flush=True)
    return identical


def fit_phase(dev):
    """8a: ``Trainer.fit`` of the car preset on the card: 3 epochs over 3
    car-sized samples, eval on the fourth every epoch, ``best``/``last``
    checkpoints; exact launch counts, no plain route; a stopped and resumed
    run against the unbroken one; ``last`` restored on the CPU; walls
    beside bare ``train_step``s on the same batches; peak memory."""
    import tempfile
    import threading

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import (launch_counts, plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.train import Checkpointer, MetricsLogger, Trainer
    from haet_torch.train.car import loss_fn_builder, make_batch
    from haet_torch.train.graphs import WARMUP, signature
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)

    quiet = MetricsLogger(echo=False)   # fit returns its epoch records
    train, val, _ = car_fold()
    batches = [make_batch(s) for s in train]
    evals = [make_batch(s) for s in val]
    cfg = shapenet_car_train_config()
    cfg.epochs = FIT_EPOCHS
    check(cfg.early_stop_patience == 7, "early stopping not armed")
    steps = FIT_EPOCHS * len(train)

    def trainer(dev=dev, seed=SEED):
        model = build_model(shapenet_car_config(), dev, seed=seed)
        return Trainer(model, loss_fn_builder(0.5), cfg, total_steps=steps,
                       batch_args=lambda b: (b["x"], None))

    tmp = tempfile.mkdtemp(prefix="haet_fit_")
    whole = trainer()
    check(whole.num_params() == 1_757_190, "car preset size")
    ck = Checkpointer(f"{tmp}/whole")
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = whole.fit(lambda: iter(batches), lambda: iter(evals),
                     checkpointer=ck, logger=quiet)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts, routes = launch_counts(), plain_route_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # fit's steps replay one CUDA graph per training bucket: the host
    # counters rose in each graph's warm-up and capture, and in the eval
    # forwards; the launches of the replays are read from the profiler on
    # the resumed run below
    graphs = len({signature(b) for b in batches})
    check(len(whole.graphs) == graphs,
          f"{len(whole.graphs)} graphs for {graphs} training buckets")
    want = expected_launches(graphs * (WARMUP + 1), FIT_EPOCHS * len(val))
    expect_counts(f"host launch counters over {steps} steps ({graphs} "
                  f"graphs captured) and {FIT_EPOCHS * len(val)} eval "
                  f"forwards", counts, want)
    expect_counts("plain routes", routes, {k: 0 for k in routes})
    check([r["epoch"] for r in recs] == list(range(FIT_EPOCHS)),
          f"epochs {[r['epoch'] for r in recs]}")
    for r in recs:
        for k in ("train/loss", "val/loss", "train/grad_norm"):
            check(np.isfinite(r[k]), f"epoch {r['epoch']}: {k} {r[k]}")
        print(f"  epoch {r['epoch']}: train/loss {r['train/loss']:.6f} "
              f"val/loss {r['val/loss']:.6f} lr "
              f"{r['train/learning_rate']:.3e} wall "
              f"{r['epoch/time_seconds']:.4f} s (host per step "
              f"{r['train/avg_batch_time']:.4f} s)", flush=True)
    for name in ("best", "last"):
        check(ck.restore(name, map_location="cpu") is not None,
              f"no '{name}' checkpoint")
    print(f"  fit: {FIT_EPOCHS} epochs in {fit_s:.3f} s; best (epoch "
          f"{ck.best_epoch}) and last written; peak device memory "
          f"{peak_mb:.1f} MiB", flush=True)
    want_state = state_on_cpu(whole)

    # `last`, written on the card, restored on the CPU
    cpu = trainer(dev="cpu", seed=SEED + 1)
    check(cpu.maybe_restore(Checkpointer(f"{tmp}/whole")), "no last")
    for k, v in cpu.model.state_dict().items():
        check(torch.equal(v, want_state["model"][k]),
              f"{k} differs after a restore on the CPU")
    print("  'last' restored on the CPU: every model tensor equal", flush=True)
    del cpu

    # stopped after epoch 1 (the event set as epoch 2's batches are asked
    # for), then resumed through a fresh Trainer and Checkpointer
    ev = threading.Event()
    passes = []

    def stopping():
        passes.append(1)
        if len(passes) == FIT_EPOCHS:
            ev.set()
        return iter(batches)

    first = trainer()
    first.fit(stopping, lambda: iter(evals), stop_event=ev,
              checkpointer=Checkpointer(f"{tmp}/stopped"), logger=quiet)
    check(first.step == (FIT_EPOCHS - 1) * len(train),
          f"stopped at step {first.step}")
    del first
    resumed = trainer(seed=SEED + 2)
    check(resumed.maybe_restore(Checkpointer(f"{tmp}/stopped")),
          "nothing to resume")
    reset_launch_counts()
    recs2, device = profile_launches(
        lambda: resumed.fit(lambda: iter(batches), lambda: iter(evals),
                            checkpointer=Checkpointer(f"{tmp}/stopped"),
                            logger=quiet))
    # the device ran each graph's warm-up steps and then every step as a
    # replay; the eval forwards are eager
    expect_counts(f"kernel calls on the device over the resumed epoch's "
                  f"{len(batches)} steps and {len(val)} eval forward "
                  f"(profiler)", device["calls"],
                  expected_launches(len(batches) + WARMUP * graphs,
                                    len(val)))
    expect_counts("plain routes", plain_route_counts(),
                  {k: 0 for k in routes})
    check([r["epoch"] for r in recs2] == [FIT_EPOCHS - 1],
          f"resumed epochs {[r['epoch'] for r in recs2]}")
    identical = compare_states(state_on_cpu(resumed), want_state)
    del resumed

    # fit's wall per step against bare train_step's, same batches: a fit
    # with no eval and no checkpoints, and the bare loop, in turns
    walls = {"bare": [], "fit": []}
    for side in ("bare", "fit", "fit", "bare") * WALL_ROUNDS:
        t = trainer()
        for b in batches:   # the captures, outside the timed region
            t.graphs.prepare([b])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "bare":
            for _ in range(FIT_EPOCHS):
                for b in batches:
                    t.train_step(b)
        else:
            t.fit(lambda: iter(batches), logger=quiet)
        torch.cuda.synchronize()
        walls[side].append((time.perf_counter() - t0) / steps)
        del t
    bare, fitted = (float(np.median(walls[k])) for k in ("bare", "fit"))
    print(f"  wall per step (s), median of {2 * WALL_ROUNDS} runs of {steps} "
          f"steps: bare train_step {bare:.5f}, fit {fitted:.5f} (overhead "
          f"{1e3 * (fitted - bare):.3f} ms per step); mins "
          f"{min(walls['bare']):.5f}, {min(walls['fit']):.5f}; runs "
          f"{ {k: [round(v, 5) for v in w] for k, w in walls.items()} }",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"epoch_s": [r["epoch/time_seconds"] for r in recs],
            "bare_step_s": bare, "fit_step_s": fitted, "peak_mb": peak_mb,
            "resume_bit_identical": identical}


def drivers_car_phase(dev):
    """8b: ``car_train --epochs 2`` at full width on the synthetic
    stand-in, in a subprocess, then ``car_eval --which last`` on its
    checkpoints; every metric finite, and ``car_eval`` reproduces
    ``car_train``'s final metrics at rtol 1e-5."""
    import tempfile

    from haet_torch.benchmarks import car_eval
    from haet_torch.ops.kernels import launch_counts, reset_launch_counts

    tmp = tempfile.mkdtemp(prefix="haet_drivers_")
    common = ["--data_dir", f"{tmp}/absent"]
    cmd = [sys.executable, "-m", "haet_torch.benchmarks.car_train",
           "--epochs", str(DRIVER_EPOCHS), "--out_dir", tmp, *common]
    print(f"  {' '.join(cmd[1:])}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    for ln in proc.stdout.splitlines():
        if ln.startswith(("train ", "nb_parameters", "epoch=", "time:")):
            print(f"    {ln[:240]}", flush=True)
    check(proc.returncode == 0, f"car_train failed:\n{proc.stderr[-3000:]}")
    check("nb_parameters 1757190" in proc.stdout, "car_train model size")
    with open(f"{tmp}/car_metrics.jsonl") as f:
        rec = [json.loads(ln) for ln in f if '"eval/' in ln][-1]
    trained = {k[len("eval/"):]: v for k, v in rec.items()
               if k.startswith("eval/")}
    print(f"  car_train ({wall:.1f} s): {trained}", flush=True)
    reset_launch_counts()
    got = car_eval.main(common + ["--which", "last", "--checkpoint_dir",
                                  f"{tmp}/checkpoints/car"])
    n_val = 2   # the stand-in's validation samples
    expect_counts("car_eval launches", launch_counts(),
                  expected_launches(0, n_val))
    print(f"  car_eval: {got}", flush=True)
    check(sorted(got) == sorted(trained), "metric keys differ")
    for k, v in got.items():
        check(np.isfinite(v) and np.isfinite(trained[k]),
              f"non-finite metric {k}")
        if k != "time_per_sample":
            check(abs(v - trained[k]) <= 1e-5 * abs(trained[k]),
                  f"car_eval {k} {v} != car_train's {trained[k]}")
    print(f"  time_per_sample: car_train {trained['time_per_sample']:.5f} "
          f"s, car_eval {got['time_per_sample']:.5f} s", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"train_time_per_sample": trained["time_per_sample"],
            "eval_time_per_sample": got["time_per_sample"]}


# ---------------------------------------------------------------------------
# Phase 9: the train step as CUDA graphs, against the eager step.
# ---------------------------------------------------------------------------

#: two training buckets, so that the graphs switch from step to step
GRAPH_POINTS = (30000, N_POINTS)     # buckets 30720 and 32768
GRAPH_STEPS = 6
#: graphed against eager: each leaf within this of its max
GRAPH_RTOL = 1e-6
SCAN_STEPS = 5
#: replays (and eager steps) timed for the walls
WALL_STEPS = 12


def graph_batches(n, seeds):
    """Car-like batches of ``n`` points (surface last), one per seed."""
    from haet_torch.data.shapenet_car import CarSample
    from haet_torch.train.car import make_batch

    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        x = rng.randn(n, 7).astype(np.float32)
        y = rng.randn(n, 4).astype(np.float32)
        surf = np.zeros(n, bool)
        surf[-N_SURFACE:] = True
        out.append(make_batch(CarSample(x[:, :3], x, y, surf)))
    return out


def train_state(trainer, rates: bool = True) -> dict:
    """Every tensor of the training state, by name: parameters, BatchNorm
    buffers (``num_batches_tracked`` too), Adam's state and, with
    ``rates``, the lr and beta1 of the last step."""
    st = {f"model {k}": v for k, v in trainer.model.state_dict().items()}
    for i, p in enumerate(trainer.params):
        for k, v in trainer.optimizer.state[p].items():
            st[f"adam {i} {k}"] = v
    if rates:
        st["lr, beta1"] = trainer.optimizer.hparams
    return st


def hold_states(what, got, want, rates: bool = True) -> bool:
    """Each of ``got``'s tensors within ``GRAPH_RTOL`` of the max of
    ``want``'s; returns whether all are bit-identical."""
    import torch

    got, want = train_state(got, rates), train_state(want, rates)
    check(sorted(got) == sorted(want), f"{what}: state keys differ")
    identical, worst = True, (0.0, "")
    for k, w in want.items():
        g = got[k]
        err = float((g.double() - w.double()).abs().max())
        scale = max(float(w.double().abs().max()), 1e-30)
        check(err <= GRAPH_RTOL * scale,
              f"{what}: {k} differs by {err} > {GRAPH_RTOL} x {scale}")
        worst = max(worst, (err / scale, k))
        identical = identical and torch.equal(g, w)
    print(f"  {what}: {len(want)} tensors, largest error relative to its "
          f"max {worst[0]:.3e} ({worst[1]}); bit-identical {identical}",
          flush=True)
    return identical


def hold_step(what, got, want, rates) -> bool:
    """One step's metrics (and the lr and beta1 it applied: ``rates``, the
    two trainers' ``hparams`` after it) within ``GRAPH_RTOL``."""
    import torch

    identical = True
    for k, w in want.items():
        g, w = float(got[k]), float(w)
        check(abs(g - w) <= GRAPH_RTOL * abs(w), f"{what}: {k} {g} != {w}")
        identical = identical and g == w
    check(torch.equal(*rates), f"{what}: lr, beta1 {rates[0].tolist()} != "
                               f"{rates[1].tolist()}")
    return identical


def graph_phase(dev):
    """9a-9e: the car train step as CUDA graphs (``Trainer.train_step``'s
    default on the card) against the eager step (``eager=True``)."""
    import copy
    import gc
    import tempfile

    import torch

    from haet_torch.benchmarks.car_train import build_model
    from haet_torch.ops.kernels import (plain_route_counts,
                                        profile_launches,
                                        reset_launch_counts)
    from haet_torch.train import Checkpointer, Trainer
    from haet_torch.train.car import bucket_size, loss_fn_builder
    from haet_torch.utils.config import (shapenet_car_config,
                                         shapenet_car_train_config)

    cfg = shapenet_car_train_config()
    check(cfg.cycle_momentum, "cycle_momentum is off")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    pair = [graph_batches(n, [SEED + 20 + i])[0]
            for i, n in enumerate(GRAPH_POINTS)]
    check([b["x"].shape[1] for b in pair]
          == [bucket_size(n) for n in GRAPH_POINTS], "buckets")

    def trainer(eager, seed=SEED, steps=2 * GRAPH_STEPS):
        model = build_model(shapenet_car_config(), dev, seed=seed)
        return Trainer(model, loss_fn_builder(0.5), cfg, total_steps=steps,
                       batch_args=lambda b: (b["x"], None), eager=eager)

    print(f"phase 9a: {GRAPH_STEPS} steps, graphed against eager, "
          f"alternating buckets {[b['x'].shape[1] for b in pair]}",
          flush=True)
    graphed, eager = trainer(False), trainer(True)
    check(graphed.graphs is not None and eager.graphs is None, "modes")
    hold_states("9a: the two trainers' initial state", graphed, eager)
    tmp = tempfile.mkdtemp(prefix="haet_graphs_")
    ck = Checkpointer(tmp)
    reset_launch_counts()
    same = True
    for i in range(GRAPH_STEPS):
        b = pair[i % 2]
        mg, me = graphed.train_step(b), eager.train_step(b)
        rates = (graphed.optimizer.hparams.cpu(),
                 eager.optimizer.hparams.cpu())
        same = hold_step(f"9a step {i + 1}", mg, me, rates) and same
        print(f"  step {i + 1} ({b['x'].shape[1]} points): loss graphed "
              f"{float(mg['loss']):.8f} eager {float(me['loss']):.8f}; lr, "
              f"beta1 {rates[0].tolist()}", flush=True)
        if i == GRAPH_STEPS // 2 - 1:   # for 9d: a checkpoint mid-run
            ck.save_last(eager.state_dict(), 0)
    print(f"  every step's metrics bit-identical: {same}; "
          f"{len(graphed.graphs)} graphs, captured in "
          f"{[round(t, 3) for t in graphed.graphs.capture_s]} s", flush=True)
    check(len(graphed.graphs) == 2, f"{len(graphed.graphs)} graphs")
    hold_states(f"9a: state after {GRAPH_STEPS} steps", graphed, eager)
    check(all(v == 0 for v in plain_route_counts().values()),
          f"plain routes {plain_route_counts()}")

    print("phase 9b: one replay's kernels, from the profiler", flush=True)
    reset_launch_counts()
    _, replay = profile_launches(graphed.train_step, pair[1])
    expect_counts("kernel calls in one replay", replay["calls"], PER_STEP)
    expect_counts("plain routes", plain_route_counts(),
                  {k: 0 for k in plain_route_counts()})
    print(f"  CUDA kernels per replay {replay['kernels']} (the port's "
          f"{sum(replay['launches'].values())}: {replay['launches']}) and "
          f"{replay['copies']} copies; device {replay['device_ms']:.3f} ms",
          flush=True)
    # the same replay twice, from the same state: the slice kernels'
    # arrival counters, captured once, are back at zero after each replay
    snapshot = copy.deepcopy(graphed.state_dict())
    first = graphed.train_step(pair[1])
    after = {k: v.clone() for k, v in train_state(graphed).items()}
    graphed.load_state_dict(snapshot)
    second = graphed.train_step(pair[1])
    check(all(torch.equal(first[k], second[k]) for k in first)
          and all(torch.equal(v, after[k])
                  for k, v in train_state(graphed).items()),
          "two replays from one state differ")
    print("  two replays from one state and batch: bit-identical", flush=True)

    print(f"phase 9d: restore step {GRAPH_STEPS // 2}'s eager checkpoint "
          f"into both trainers, then {GRAPH_STEPS // 2} more steps",
          flush=True)
    for t in (graphed, eager):
        ptrs = [v.data_ptr() for v in train_state(t).values()]
        check(t.maybe_restore(ck), "no checkpoint")
        check(ptrs == [v.data_ptr() for v in train_state(t).values()],
              "a restore moved the training state")
    # the rates of the last step are no checkpoint's: the graphed trainer
    # took one more step (9b)
    hold_states("9d: restored", graphed, eager, rates=False)
    for i in range(GRAPH_STEPS // 2):
        b = pair[i % 2]
        mg, me = graphed.train_step(b), eager.train_step(b)
        hold_step(f"9d step {i + 1}", mg, me,
                  (graphed.optimizer.hparams.cpu(),
                   eager.optimizer.hparams.cpu()))
    check(len(graphed.graphs) == 2, "a restore captured new graphs")
    hold_states("9d: after the restore and the steps", graphed, eager)
    shutil.rmtree(tmp, ignore_errors=True)

    print(f"phase 9e: walls, device time and peak memory ({WALL_STEPS} "
          f"steps each)", flush=True)
    # Memory, from this phase's start: a replay allocates nothing (its
    # temporaries live in the graphs' pool, reserved since the capture), so
    # the graphed step's footprint is the trainers' resident state plus the
    # pool; the eager step's is that state plus its peak of temporaries.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mib = 2**20
    resident = (torch.cuda.memory_allocated() - base[0]) / mib
    pool = (torch.cuda.memory_reserved() - base[1]) / mib - resident
    walls = {}
    for name, t in (("graphed", graphed), ("eager", eager)):
        w = []
        start = torch.cuda.memory_allocated() / mib
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WALL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t.train_step(pair[1])
            torch.cuda.synchronize()
            w.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / mib
        _, prof = profile_launches(t.train_step, pair[1])
        wall = float(np.median(w)) * 1e3
        nodes = prof["kernels"] + prof["copies"]
        gaps = prof["span_ms"] - prof["device_ms"]
        walls[name] = {"wall_ms": wall, "min_ms": min(w) * 1e3,
                       "walls_ms": [x * 1e3 for x in w],
                       "device_ms": prof["device_ms"],
                       "span_ms": prof["span_ms"], "gaps_ms": gaps,
                       "busy": prof["device_ms"] / wall,
                       "kernels": prof["kernels"],
                       "copies": prof["copies"],
                       "step_mb": (pool if name == "graphed"
                                   else peak - start)}
        print(f"  {name}: wall median {wall:.3f} ms (min {min(w) * 1e3:.3f}) "
              f"of {WALL_STEPS}; device {prof['device_ms']:.3f} ms in "
              f"{prof['kernels']} kernels and {prof['copies']} copies over a "
              f"span of {prof['span_ms']:.3f} ms (gaps {gaps:.3f} ms, "
              f"{1e3 * gaps / nodes:.2f} us per node); busy "
              f"{prof['device_ms'] / wall:.3f}", flush=True)
    print(f"  memory since phase 9 began: resident (both trainers' state, "
          f"the graphs' static buffers) {resident:.1f} MiB; the graphs' "
          f"pool {pool:.1f} MiB; the eager step's temporaries at peak "
          f"{walls['eager']['step_mb']:.1f} MiB", flush=True)
    del graphed, eager

    print(f"phase 9c: train_steps of {SCAN_STEPS} against {SCAN_STEPS} "
          f"graphed train_steps", flush=True)
    batches = graph_batches(N_POINTS, range(SEED + 30, SEED + 30 + SCAN_STEPS))
    scan, single = trainer(False), trainer(False)
    t0 = time.perf_counter()
    ms = scan.train_steps(batches)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    singles = [single.train_step(b) for b in batches]
    check(scan.step == single.step == SCAN_STEPS, "steps")
    for i, m in enumerate(singles):
        hold_step(f"9c step {i + 1}", {k: v[i] for k, v in ms.items()}, m,
                  (scan.optimizer.hparams.cpu(),
                   single.optimizer.hparams.cpu()))
    print(f"  losses {ms['loss'].tolist()}; one graph of {SCAN_STEPS} steps "
          f"(capture and first replay {scan_s:.3f} s)", flush=True)
    hold_states(f"9c: state after {SCAN_STEPS} steps", scan, single)
    del scan, single
    torch.cuda.empty_cache()
    return walls


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "haet_torch" / "__init__.py").exists():
        print(f"FAIL: haet_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from haet_torch.ops.kernels import _build
    from haet_torch.utils.env import default_device

    dev = default_device(None)
    try:
        line = card_line()
        print(f"phase 1: card {line}; torch {torch.__version__}; "
              f"CUDA {torch.version.cuda}; {torch.cuda.get_device_name(0)}",
              flush=True)
        t0 = time.perf_counter()
        reports = _build.build_all()
        nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                              capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()[-1]
        print(f"phase 2: built {sorted(reports)} in "
              f"{time.perf_counter() - t0:.1f} s ({nvcc})", flush=True)
        for name, rep in reports.items():
            for ln in rep.splitlines():
                if any(w in ln for w in ("Compiling entry", "registers",
                                         "spill", "smem")):
                    print(f"  {name}: {ln.strip()}", flush=True)
        records = kernel_phase(dev)
        backward_phase(dev, records)
        print("phase 4: serve the ShapeNet-Car preset", flush=True)
        serve_counts, forwards, model, sample = serve_phase(dev)
        print("phase 5: profile one batch-1 forward", flush=True)
        profile_phase(model, sample, dev)
        del model
        print(f"phase 6: train the ShapeNet-Car preset, {TRAIN_STEPS} steps",
              flush=True)
        counts, replay_calls = train_phase(dev)
        t7 = time.perf_counter()
        records.append(copy_phase(dev))
        driver_shape_phase(dev, records)
        large_slice_phase(dev)
        copy_launches = drivers_phase(dev)
        print(f"phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
        t8 = time.perf_counter()
        print(f"phase 8a: Trainer.fit of the ShapeNet-Car preset, "
              f"{FIT_EPOCHS} epochs", flush=True)
        fit = fit_phase(dev)
        print(f"phase 8b: car_train --epochs {DRIVER_EPOCHS}, then car_eval "
              f"--which last", flush=True)
        fit.update(drivers_car_phase(dev))
        print(f"phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
        t9 = time.perf_counter()
        graphs = graph_phase(dev)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s", flush=True)
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    counts["copy_scale"] = copy_launches
    for r in records:
        r["launches"] = counts[r["name"]]
        r["replay_launches"] = replay_calls[r["name"]]
        r["serve_launches"] = serve_counts[r["name"]]
    print(json.dumps({"kernels": records, "train_steps": TRAIN_STEPS,
                      "serve_forwards": forwards, "fit": fit,
                      "graphs": graphs}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
