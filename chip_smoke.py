#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``haet_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check exits non-zero before the final line):

1. The card: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. Build every CUDA kernel from ``haet_torch/csrc/`` (one ``nvcc`` per
   source, in parallel) and print the build time.
3. Each kernel at the ShapeNet-Car serving shapes against its plain PyTorch
   version on the card: max abs/rel error against the stated tolerance, the
   kernel's time, the plain version's time and the bound (least time the card
   could take for the same bytes and float32 operations). The Erwin block is
   also checked, untimed, at the largest clouds its shape gate admits.
3b. The backwards against autograd of their plain versions on the card:
   the Erwin block's backward kernel at both car block shapes (dx, dpos and
   all 14 parameter gradients, timed, with its bound) and, untimed, at the
   two gate-edge shapes; the slice autograd functions (``SliceStatesFn``,
   ``DesliceFn``) at the padded car shape ``[1, 8, 32768, 32]``, timed.
4. Serve: the car preset (2 layers, n_hidden 256, G 32, 1,757,190 params,
   seeded random weights) on the card with both kernel flags set, behind a
   ``BatchingServer`` with signature ``x [32186, 7] f32, fx None`` and batch
   sizes (1, 2, 4). Sequential requests (``max_delay_s=0``) and a concurrent
   burst that forms a batch of 4. Checks shapes, finiteness, agreement with
   the plain path on the same weights and inputs, that the kernel launch
   counters rose by exactly 2 + 2 + 24 per forward, and that no Erwin block
   was routed to the plain version.
5. Profile one batch-1 forward: device time by kernel against wall time.
6. Train: the car preset at full width with both flags set takes 5
   ``Trainer.train_step``s (Adam + OneCycle + clip 1.0, the masked car
   loss, train-mode BatchNorm) on a seeded synthetic sample of 32186 points
   padded to the 32768 bucket. Checks that the loss and every parameter stay
   finite, that after step 1 every parameter but ``sigma_att`` has a finite
   gradient, that step 1's gradients match the plain path's (both flags off,
   same weights and batch) leaf by leaf, and that the launch counters rose
   by exactly 2 + 2 + 24 + 24 per step with no plain route. Prints the step
   wall time, peak device memory and, from one profiled step, the device
   time by kernel and the busy share.
7. Benchmarks: the drivers of ``haet_torch.bench`` and
   ``haet_torch/benchmarks/``, and the copy kernel they time.
   a. ``copy_scale`` (the fifth kernel) at ``[256, 32]`` against
      ``x * 1.000001``: bit-exact after 1 call and after 1050 chained calls,
      and on an unaligned and a tailed view of 8191 elements (its scalar
      kernel and its float4 kernel's tail); its time, the plain version's,
      ``torch.mul``'s (``library_ms``) and its bound.
   b. The Erwin forward and backward kernels against the plain block (out,
      dx, dpos, every parameter gradient), timed, at the drivers' block
      shapes: the micro driver's (8 clouds of 32, C 32, 4 heads, SwiGLU
      128) and bench_flags' two (C 32, 4 heads, ball 32, SwiGLU 64; n 16,
      C 64, 8 heads, ball 16, SwiGLU 128). The car uses 8 heads and SwiGLU
      4C throughout. Records gain ``micro_*``, ``flags_n32_c32_*`` and
      ``flags_n16_c64_*``.
   c. ``slice_states``/``deslice`` against their plain versions, untimed,
      at ``[1, 8, 2**20, 32]``, the memory probes' size.
   d. ``micro_erwin_fused`` with reduced windows: the copy counter rises by
      exactly the chained calls the driver made, the Erwin counters by
      exactly the fused lines' calls, and no block takes the plain route.
   e. ``bench_flags`` with 2 rounds of 1/3 steps: per step, exactly 2 + 2
      slice launches for ``pallas-tokenizer``, one forward and one backward
      launch per Erwin block (12) for ``pallas-erwin``, none for
      ``baseline``, and no plain route.
   f. ``haet_torch.bench``, 2 rounds: a finite throughput and MFU.
   g. One ``mem_sweep`` probe per path at N = 2**20, forward only, each in
      a fresh process: the slice-kernel path's peak memory must be below
      the plain path's, and its probe must count 1 + 1 slice launches.

Then one JSON line of kernel records, five of them (``launches`` from
phase 6's counters, and for ``copy_scale`` from the counter after phase
7d's run), the card line, and as the
last line ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
``haet_tpu``.
"""

from __future__ import annotations

import json
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
# The slice backwards' parameter gradients sum 262,144 points' terms that
# cancel (for b_slice, sum_n dL/dlogit is 0 at a constant temperature), so
# float32 sums in two orders differ by more than 1e-4 of the small result
# (1.2e-4 on b_slice, H100 run of this script).
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

def erwin_inputs(dev, g, n_e, c_e, ball, heads=8, mlp_ratio=4):
    """Seeded inputs and weights of one Erwin block shape (8 clouds,
    ``heads`` heads, SwiGLU ``mlp_ratio`` * C), drawn from ``g``."""
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
    xe = torch.randn(8, n_e, c_e, generator=g).to(dev)
    pe = torch.rand(8, n_e, 3, generator=g).to(dev)
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


def kernel_phase(dev):
    import torch

    from haet_torch.ops.kernels import erwin_block as eb
    from haet_torch.ops.kernels import slice_kernels as sk

    g = torch.Generator().manual_seed(SEED)
    b, h, n, c, gs = 1, 8, N_POINTS, 32, 32
    x = torch.randn(b, h, n, c, generator=g).to(dev)
    ws = (0.3 * torch.randn(c, gs, generator=g)).to(dev)
    bs = (0.1 * torch.randn(gs, generator=g)).to(dev)
    wa = (0.1 * torch.randn(c, 1, generator=g)).to(dev)
    ba = torch.zeros(1).to(dev)
    records = []

    print(f"phase 3: slice_states  x [1, 8, {n}, 32], G 32", flush=True)
    st_k, m_k, s_k = sk.slice_states(x, ws, bs, wa, ba)
    st_p, m_p, s_p = sk.slice_states_plain(x, ws, bs, wa, ba)
    torch.cuda.synchronize()
    err = max(compare("states", st_k, st_p, KERNEL_RTOL),
              compare("m", m_k, m_p, KERNEL_RTOL),
              compare("s", s_k, s_p, KERNEL_RTOL))
    ms = cuda_ms(lambda: sk.slice_states(x, ws, bs, wa, ba))
    plain_ms = cuda_ms(lambda: sk.slice_states_plain(x, ws, bs, wa, ba))
    bh = b * h
    nbytes = 4 * (bh * n * c + c * gs + gs + c + 1 + bh * gs * c + 2 * bh * gs)
    flops = 2 * bh * n * (2 * c * gs + c)
    bound = bound_ms(nbytes, flops)
    print_times(ms, plain_ms, bound)
    records.append(kernel_record(
        "slice_states", "haet_torch/csrc/slice_kernels.cu",
        "haet_tpu/ops/pallas/slice_kernels.py:73", err, ms, plain_ms, bound))

    print(f"phase 3: deslice  x [1, 8, {n}, 32], G 32", flush=True)
    st = torch.randn(b, h, gs, c, generator=g).to(dev)
    out_k = sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p)
    out_p = sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p)
    torch.cuda.synchronize()
    err = compare("out", out_k, out_p, KERNEL_RTOL)
    ms = cuda_ms(lambda: sk.deslice(x, ws, bs, wa, ba, st, m_p, s_p))
    plain_ms = cuda_ms(
        lambda: sk.deslice_plain(x, ws, bs, wa, ba, st, m_p, s_p))
    nbytes = 4 * (2 * bh * n * c + c * gs + gs + c + 1 + bh * gs * c
                  + 2 * bh * gs)
    flops = 2 * bh * n * (2 * c * gs + c)
    bound = bound_ms(nbytes, flops)
    print_times(ms, plain_ms, bound)
    records.append(kernel_record(
        "deslice", "haet_torch/csrc/slice_kernels.cu",
        "haet_tpu/ops/pallas/slice_kernels.py:125", err, ms, plain_ms, bound))

    def erwin_case(n_e, c_e, ball):
        """One block shape's inputs, and the kernel's error against its
        plain version."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball)
        with torch.inference_mode():
            o_k = eb.fused_erwin_block(xe, pe, params, **kw)
            o_p = eb.erwin_block_plain(xe, pe, params, **kw)
            torch.cuda.synchronize()
            err = compare("out", o_k, o_p, KERNEL_RTOL)
        return xe, pe, params, kw, err

    # The Erwin stage's two block shapes: encoder0/decoder0 (n 32, C 32,
    # ball 32, SwiGLU 128; 16 launches per forward) and the bottleneck
    # (n 16, C 64, ball 16, SwiGLU 256; 8 launches per forward).
    errs, times, plain_times, bounds = [], [], [], []
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3: fused_erwin_block  x [8, {n_e}, {c_e}], 8 heads, "
              f"ball {ball}", flush=True)
        xe, pe, params, kw, err = erwin_case(n_e, c_e, ball)
        errs.append(err)
        with torch.inference_mode():
            times.append((cuda_ms(
                lambda: eb.fused_erwin_block(xe, pe, params, **kw)), weight))
            plain_times.append((cuda_ms(
                lambda: eb.erwin_block_plain(xe, pe, params, **kw)), weight))
        w_elems, flops = erwin_work(n_e, c_e, ball)
        nbytes = 4 * (2 * 8 * n_e * c_e + 8 * n_e * 3 + w_elems)
        bounds.append((bound_ms(nbytes, flops), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    bound = (mix([(bd[0], w) for bd, w in bounds]),
             "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
             else "operations")
    records.append(kernel_record(
        "fused_erwin_block", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:163", max(errs), mix(times),
        mix(plain_times), bound,
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]}))

    # The largest clouds the eligible() gate admits (~166-170 KB of shared
    # memory, past the 48 KB default): they must launch and agree too.
    # Checked only, not timed and not part of the record.
    for n_e, c_e, ball in ((128, 32, 32), (64, 64, 16)):
        print(f"phase 3: fused_erwin_block at the gate's edge  x [8, {n_e}, "
              f"{c_e}], 8 heads, ball {ball}, SwiGLU {4 * c_e}, shared "
              f"memory {eb.smem_bytes(n_e, c_e, 3, 4 * c_e)} B", flush=True)
        erwin_case(n_e, c_e, ball)
    print("  none of the three has a single PyTorch call computing the same "
          "function: library_ms is null", flush=True)
    return records


# ---------------------------------------------------------------------------
# Phase 3b: the backwards against autograd of their plain versions.
# ---------------------------------------------------------------------------

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
        block over dx, dpos and every parameter gradient."""
        xe, pe, params, kw = erwin_inputs(dev, g, n_e, c_e, ball)
        dout = torch.randn(8, n_e, c_e, generator=g).to(dev)
        dx_k, dpos_k, gr_k = eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                      **kw)
        dx_p, dpos_p, gr_p = eb.erwin_block_bwd_plain(xe, pe, dout, params,
                                                      **kw)
        torch.cuda.synchronize()
        errs = [compare("dx", dx_k, dx_p, KERNEL_RTOL),
                compare("dpos", dpos_k, dpos_p, KERNEL_RTOL)]
        errs += [compare(f"d {k}", gr_k[k], gr_p[k], KERNEL_RTOL)
                 for k in eb.GRAD_NAMES]
        return xe, pe, params, kw, dout, max(errs)

    errs, times, plain_times, bounds = [], [], [], []
    for n_e, c_e, ball, weight in ((32, 32, 32, 16), (16, 64, 16, 8)):
        print(f"phase 3b: fused_erwin_block_bwd  x [8, {n_e}, {c_e}], 8 "
              f"heads, ball {ball}, shared memory "
              f"{eb.bwd_smem_bytes(n_e, c_e, 3, 4 * c_e, 8, ball)} B",
              flush=True)
        xe, pe, params, kw, dout, err = erwin_bwd_case(n_e, c_e, ball)
        errs.append(err)
        times.append((cuda_ms(lambda: eb.fused_erwin_block_bwd(
            xe, pe, dout, params, **kw)), weight))
        plain_times.append((plain_bwd_ms(xe, pe, dout, params, kw), weight))
        bounds.append((erwin_bwd_bound(n_e, c_e, ball), weight))
        print_times(times[-1][0], plain_times[-1][0], bounds[-1][0])
    total = sum(w for _, w in times)
    mix = lambda xs: sum(t * w for t, w in xs) / total  # noqa: E731
    records.append(kernel_record(
        "fused_erwin_block_bwd", "haet_torch/csrc/erwin_block.cu",
        "haet_tpu/ops/pallas/erwin_block.py:187", max(errs), mix(times),
        mix(plain_times),
        (mix([(bd[0], w) for bd, w in bounds]),
         "bytes" if all(bd[1] == "bytes" for bd, _ in bounds)
         else "operations"),
        per_shape_ms={"n32_c32": times[0][0], "n16_c64": times[1][0]}))
    for n_e, c_e, ball in ((128, 32, 32), (64, 64, 16)):
        layout, smem, spilled = eb.bwd_layout(n_e, c_e, 3, 4 * c_e, 8, ball)
        nbuf = len(eb.BWD_BUFFERS)
        spills = [name for name, in_smem in
                  zip(eb.BWD_BUFFERS, layout[nbuf:2 * nbuf]) if not in_smem]
        print(f"phase 3b: fused_erwin_block_bwd at the gate's edge  x [8, "
              f"{n_e}, {c_e}], ball {ball}: {smem} B of shared memory, "
              f"{4 * spilled} B per cloud in the global scratch {spills}",
              flush=True)
        erwin_bwd_case(n_e, c_e, ball)

    print(f"phase 3b: SliceStatesFn / DesliceFn backward  x [1, 8, "
          f"{N_PADDED}, 32], G 32", flush=True)
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
        return leaves, st, out, torch.autograd.grad(
            [st, out], leaves, [g_st, g_out], retain_graph=True)

    _, _, _, got = grads(sk.slice_states, sk.deslice)
    leaves, st_p, out_p, want = grads(sk.slice_states_plain, sk.deslice_plain)
    torch.cuda.synchronize()
    err = max(compare(f"d {k}", a, w, SLICE_BWD_RTOL) for k, a, w in zip(
        ("x", "w_slice", "b_slice", "w_ada", "b_ada", "states"), got, want))
    with torch.no_grad():
        st_k, m_k, s_k = sk.slice_states(x, ws, bs, wa, ba)
        ms = {
            "slice_states": cuda_ms(lambda: sk.slice_states_bwd(
                x, ws, bs, wa, ba, st_k, m_k, s_k, g_st)),
            "deslice": cuda_ms(lambda: sk.deslice_bwd(
                x, ws, bs, wa, ba, st_in, m_k, s_k, g_out)),
        }
    plain_ms = {
        "slice_states": cuda_ms(lambda: torch.autograd.grad(
            st_p, leaves[:5], g_st, retain_graph=True)),
        "deslice": cuda_ms(lambda: torch.autograd.grad(
            out_p, leaves, g_out, retain_graph=True)),
    }
    for r in records:
        if r["name"] in ms:
            r.update(bwd_ms=ms[r["name"]], bwd_plain_ms=plain_ms[r["name"]],
                     bwd_max_abs_err=err)
            print(f"  {r['name']} backward (PyTorch, chunked) "
                  f"{ms[r['name']]:.4f} ms  plain autograd "
                  f"{plain_ms[r['name']]:.4f} ms", flush=True)
    print("  no single PyTorch call computes the block's backward: "
          "library_ms is null", flush=True)


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
            "fused_erwin_block": 24 * forwards, "fused_erwin_block_bwd": 0,
            "copy_scale": 0}
    print(f"  forwards {forwards}; launches {counts}; expected {want}",
          flush=True)
    check(counts == want, f"launch counts {counts} != {want}")
    print(f"  blocks routed to the plain version {plain_routes}", flush=True)
    check(all(v == 0 for v in plain_routes.values()),
          f"some Erwin blocks left the kernel: {plain_routes}")

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
                                        reset_launch_counts)
    from haet_torch.train import Trainer
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
    batch = make_batch(x[:, :3], x, y, surf)
    check(batch["x"].shape == (1, N_PADDED, 7),
          f"padded batch {batch['x'].shape}")

    def build(flags):
        kwargs.update(use_pallas=flags)
        model = HAETransolverIrregularMesh(**kwargs, use_pallas_erwin=flags,
                                           device=dev, seed=SEED)
        g = torch.Generator().manual_seed(SEED + 3)
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=g).to(dev))
        return model, Trainer(model, loss_fn_builder(0.5), cfg,
                              total_steps=TRAIN_STEPS + 1,
                              batch_args=lambda bt: (bt["x"], None))

    # The plain path (both flags off) first: step 1's gradients are kept,
    # two more steps are timed, and the plain model is dropped before the
    # kernel run's memory peak.
    plain, trainer = build(False)
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
    per_step = {"slice_states": 2, "deslice": 2, "fused_erwin_block": 24,
                "fused_erwin_block_bwd": 24, "copy_scale": 0}
    want_counts = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    print(f"  {TRAIN_STEPS} steps; launches {counts}; expected {want_counts}",
          flush=True)
    check(counts == want_counts, f"launch counts {counts} != {want_counts}")
    check(all(v == 0 for v in plain_routes.values()),
          f"some Erwin blocks left the kernels: {plain_routes}")
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
    print(f"  profiled step: device time {device_ms:.3f} ms in "
          f"{sum(e.count for e in events)} kernels; busy share "
          f"{device_ms / wall_ms:.3f} of the min step wall {wall_ms:.3f} ms",
          flush=True)
    for e in events[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.4f} ms  x{e.count:<4d} "
              f"{e.key[:90]}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 7: the benchmark drivers and the copy kernel.
# ---------------------------------------------------------------------------

COPY_CHAIN = 1050            # the micro driver's hi window
#: the micro driver's reduced lo/hi windows and rounds
MICRO_REPS = dict(reps_lo=20, reps_hi=220, rounds=3)
#: bench_flags' reduced windows: k_lo/k_hi steps and rounds
FLAGS_STEPS = dict(k_lo=1, k_hi=3, rounds=2)
#: the slice kernels' check and the memory probes: ~30x the car's points
N_LARGE = 1 << 20


def copy_phase(dev):
    """7a: ``copy_scale`` bit-exact against its plain version after one
    call and after ``COPY_CHAIN`` chained calls; its record, with the time
    of ``torch.mul`` as the library time."""
    import torch

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
    bound = bound_ms(2 * 4 * x.numel(), x.numel())
    print_times(ms, plain_ms, bound)
    print(f"  library torch.mul {library_ms:.4f} ms", flush=True)
    rec = kernel_record("copy_scale", "haet_torch/csrc/copy_kernel.cu",
                        "benchmarks/micro_erwin_fused.py:70", err, ms,
                        plain_ms, bound)
    rec["library_ms"] = library_ms
    return rec


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
              f"{c_e}], {heads} heads, ball {ball}, SwiGLU {ratio * c_e}",
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
        bwd = (cuda_ms(lambda: eb.fused_erwin_block_bwd(xe, pe, dout, params,
                                                        **kw)),
               plain_bwd_ms(xe, pe, dout, params, kw))
        w_elems, flops = erwin_work(n_e, c_e, ball, heads, ratio)
        bounds = {"fused_erwin_block": bound_ms(
                      4 * (2 * 8 * n_e * c_e + 8 * n_e * 3 + w_elems), flops),
                  "fused_erwin_block_bwd": erwin_bwd_bound(n_e, c_e, ball,
                                                           heads, ratio)}
        times = {"fused_erwin_block": (fwd, err_f),
                 "fused_erwin_block_bwd": (bwd, err_b)}
        for r in records:
            if r["name"] in times:
                (ms, plain_ms), err = times[r["name"]]
                r.update({f"{tag}_ms": ms, f"{tag}_plain_ms": plain_ms,
                          f"{tag}_bound_ms": bounds[r["name"]][0],
                          f"{tag}_max_abs_err": err})
                print(f"  {r['name']}:", flush=True)
                print_times(ms, plain_ms, bounds[r["name"]])


def large_slice_phase(dev):
    """7c: the slice kernels, untimed, at ``N_LARGE`` points, the memory
    probes' size."""
    import torch

    from haet_torch.ops.kernels import slice_kernels as sk

    g = torch.Generator().manual_seed(SEED + 7)
    b, h, n, c, gs = 1, 8, N_LARGE, 32, 32
    print(f"phase 7c: slice_states / deslice  x [1, 8, {n}, 32], G 32",
          flush=True)
    x = torch.randn(b, h, n, c, generator=g).to(dev)
    ws = (0.3 * torch.randn(c, gs, generator=g)).to(dev)
    bs = (0.1 * torch.randn(gs, generator=g)).to(dev)
    wa = (0.1 * torch.randn(c, 1, generator=g)).to(dev)
    ba = torch.zeros(1).to(dev)
    st_in = torch.randn(b, h, gs, c, generator=g).to(dev)
    with torch.inference_mode():
        st_k, m_k, s_k = sk.slice_states(x, ws, bs, wa, ba)
        st_p, m_p, s_p = sk.slice_states_plain(x, ws, bs, wa, ba)
        torch.cuda.synchronize()
        compare("states", st_k, st_p, KERNEL_RTOL)
        compare("m", m_k, m_p, KERNEL_RTOL)
        compare("s", s_k, s_p, KERNEL_RTOL)
        del st_k, st_p
        out_k = sk.deslice(x, ws, bs, wa, ba, st_in, m_p, s_p)
        out_p = sk.deslice_plain(x, ws, bs, wa, ba, st_in, m_p, s_p)
        torch.cuda.synchronize()
        compare("out", out_k, out_p, KERNEL_RTOL)
    torch.cuda.empty_cache()


def expect_counts(what, counts, want):
    print(f"  {what}: {counts}; expected {want}", flush=True)
    check(counts == want, f"{what}: {counts} != {want}")


def drivers_phase(dev):
    """7d-7g: run each benchmark driver briefly on the card and check from
    the launch counters that its kernel paths went through the kernels.
    Returns the copy kernel's launch count after the micro driver's run."""
    import torch

    from haet_torch import bench
    from haet_torch.benchmarks import bench_flags, mem_sweep
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
        "slice_states": 0, "deslice": 0, "fused_erwin_block": 2 * calls,
        "fused_erwin_block_bwd": calls, "copy_scale": calls})
    expect_counts("plain routes", routes, no_routes)
    for name in ("copy_scale", "fused block fwd", "fused block fwd+bwd"):
        check(res[name]["device_us"] is not None
              and res[name]["device_us"] > 0, f"{name}: no device time")
    copy_launches = counts["copy_scale"]

    print(f"phase 7e: bench_flags {FLAGS_STEPS}", flush=True)
    reset_launch_counts()
    res = bench_flags.run(dev, **FLAGS_STEPS)
    for name, r in res.items():
        blocks = r["erwin_blocks"]
        check(blocks == 12, f"{name}: {blocks} Erwin blocks, expected 12 "
                            "(2 layers of depths 2/2/2)")
        want = {"slice_states": 0, "deslice": 0, "fused_erwin_block": 0,
                "fused_erwin_block_bwd": 0, "copy_scale": 0}
        if name == "pallas-tokenizer":
            want.update(slice_states=2, deslice=2)
        elif name == "pallas-erwin":
            want.update(fused_erwin_block=blocks,
                        fused_erwin_block_bwd=blocks)
        expect_counts(f"{name} launches per step ({r['steps']} steps)",
                      r["launches_per_step"], want)
        expect_counts(f"{name} plain routes per step",
                      r["plain_routes_per_step"], no_routes)

    print("phase 7f: haet_torch.bench, 2 rounds", flush=True)
    rec = bench.run(dev, budget_s=0.0, rounds=2)
    print(f"  {json.dumps(rec)}", flush=True)
    check(np.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench value {rec['value']}")
    check(rec["mfu"] is not None and 0 < rec["mfu"] < 1,
          f"bench mfu {rec['mfu']}")
    del rec
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
                if "registers" in ln or "smem" in ln:
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
        counts = train_phase(dev)
        t7 = time.perf_counter()
        records.append(copy_phase(dev))
        driver_shape_phase(dev, records)
        large_slice_phase(dev)
        copy_launches = drivers_phase(dev)
        print(f"phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    counts["copy_scale"] = copy_launches
    for r in records:
        r["launches"] = counts[r["name"]]
        r["serve_launches"] = serve_counts[r["name"]]
    print(json.dumps({"kernels": records, "train_steps": TRAIN_STEPS,
                      "serve_forwards": forwards}))
    print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
