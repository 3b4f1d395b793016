"""Fused rep-slice tokenizer: ``slice_states`` and ``deslice``, and their
backwards.

Counterparts of the Pallas TPU kernels in
``haet_tpu/ops/pallas/slice_kernels.py`` (``slice_states`` and ``deslice``),
with the same arguments and layouts:

* :func:`slice_states` -> ``(states [B,H,G,C], m [B,H,G], s [B,H,G])``: the
  eidetic states from an online column softmax over the points axis, plus
  its running max ``m`` and max-shifted denominator ``s``;
* :func:`deslice` -> ``out [B,H,N,C] = w @ states`` with the weights
  ``w = exp(z - m) / s`` recomputed from those residuals.

The kernels (``haet_torch/csrc/slice_kernels.cu``) never materialise the
``[B, H, N, G]`` weights. On CPU tensors the wrappers run the plain versions
below, which do materialise them; on CUDA tensors they launch the kernel or
raise. :func:`launch_geometry` is the kernels' cut of the points axis, in
Python so that it can be tested without a card: each cloud's N goes to
``per_cloud`` blocks of ``span`` rows (for slice_states, per group of
:func:`register_slices` slices), and a block's :data:`WARPS` warps take its
tiles of :data:`TILE_ROWS` rows in turn (:func:`warp_tiles`). The fast
kernels take C <= 32 and any G (:func:`fast_widths`), every preset's
widths; wider heads (C up to :data:`MAX_GENERIC_C`) take the generic
kernels, which split N into :data:`CHUNK`-point blocks (slice_states) or
``generic_plan`` rows (deslice) and the slices into groups.

Dtypes (the JAX kernels' contract, ``slice_kernels.py:187-200,316-323``):
``x_proj`` is float32 or bfloat16, the model's compute dtype, and the
kernels widen it as it arrives in shared memory. slice_states returns the
states in ``x_proj``'s dtype and float32 ``m`` and ``s``, and keeps the
float32 states as the backward's residual; deslice takes ``states`` in
``x_proj``'s dtype and returns ``out`` in it; the backwards return ``dx``
and ``dstates`` in their inputs' dtypes and float32 parameter gradients.
All arithmetic is float32. The fast kernels read and write bf16
themselves; for heads wider than 32 the wrapper widens a bf16 input to
float32 before the generic kernels and rounds their outputs after.

Gradients: :class:`SliceStatesFn` and :class:`DesliceFn` wrap the forwards,
and their backwards are :func:`slice_states_bwd` and :func:`deslice_bwd`,
the hand-derived passes over N of the JAX ``custom_vjp``
(``slice_kernels.py:327-383`` and ``:448-526``). On CUDA tensors they
launch the backward kernels, two passes over N each (the first sums the
softmax coupling ``t`` and ``sum_n w``, the second applies the chain with
the weights normalised by that sum), their partial sums added in a fixed
order. At C <= 32 a bf16 call takes ``slice_bwd_fused``, both passes in one
cooperative launch of a persistent grid (:func:`fused_blocks`, a grid
barrier between them), and a float32 call ``slice_bwd_f32``, one launch per
pass and a sum of its partials after each (16 warps per SM; windows of
:data:`BWD_WINDOW` slices, two in one sweep of the rows where
:func:`bwd_sweep` says so, the chain once per sweep): each is the faster
there, as measured on an H100 (``benchmarks/slice_kernels.py --ab``). Wider heads take
``slice_bwd_generic`` in float32 (groups of slices sized by
:func:`generic_bwd_plan`). On CPU tensors they run
:func:`slice_states_bwd_plain` / :func:`deslice_bwd_plain`, chunked PyTorch
that never holds more than one ``[B*H, BWD_CHUNK, G]`` weight tile. Only
``states`` and ``out`` carry a gradient; ``m`` and ``s`` are marked
non-differentiable.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import torch

from . import LaunchCounter, _build, define_op

#: warps per block of the fast kernels, rows per warp tile, ring slots per
#: warp (``WARPS``, ``TR``, ``STAGES`` in the CUDA source)
WARPS = 8
TILE_ROWS = 32
STAGES = 2
#: points per block of the generic slice_states partial pass
CHUNK = 256
#: the generic kernels: points per inner tile of slice_states (at most),
#: its accumulators and deslice's outputs per thread, threads per block,
#: and the widest head they take, one slice's accumulators per block
#: (``TILE``, ``MAX_ACC``, ``MAX_OUT``, ``NT``, ``MAX_GENERIC_C``)
GENERIC_TILE = 32
MAX_ACC = 8
MAX_OUT = 32
NT = 256
MAX_GENERIC_C = NT * MAX_ACC
#: dynamic shared memory a block can use on the card (``MAX_SMEM``)
MAX_SMEM = 232448
#: slices per window of the backward kernels (``BW``)
BWD_WINDOW = 32
#: warps per block and rows per warp tile of the float32 backward kernel
#: (``FW``, ``FTR``): 16 warps of at most 128 registers on each SM
BWD_WARPS = 16
BWD_TILE_ROWS = 16
#: the row stride of a fused backward warp's 16-row buffer (``BUF_STRIDE``)
BUF_STRIDE = BWD_WINDOW + 4
#: points per chunk of the plain backward passes (``_BWD_CHUNK`` of the JAX
#: code); a module constant so that tests can make the chunk loop run
#: several times
BWD_CHUNK = 64 * 1024
#: the per-pass backward kernels' modes (``BWD_STATES``, ``BWD_SUMS``,
#: ``BWD_CHAIN``, ``BWD_STATES_SUMS``) by launch name: slice_states' second
#: and first pass, deslice's first and second (the fused kernel runs a
#: backward's two passes in one launch)
BWD_MODES = {"slice_states_bwd": 0, "deslice_bwd_sums": 1, "deslice_bwd": 2,
             "slice_states_bwd_sums": 3}

#: the slice norm of the states: ``sum_n w + 1e-5`` with ``sum_n w == 1``
_NORM = 1.0 + 1e-5

SLICE_STATES_LAUNCHES = LaunchCounter()
DESLICE_LAUNCHES = LaunchCounter()
SLICE_STATES_BWD_LAUNCHES = LaunchCounter()
DESLICE_BWD_LAUNCHES = LaunchCounter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Geometry(NamedTuple):
    """One kernel's launch: ``route`` "fast", "generic" or "fused"; the
    grid is ``(per_cloud, bh, groups)`` blocks of 256 threads, block ``b``
    covering rows ``[b * span, min(n, (b + 1) * span))`` of its cloud, and
    one group of ``slices`` slices. For deslice and the backwards' second
    passes, ``groups`` counts the groups of ``slices`` slices that one block
    (the generic chain, fast deslice) or one launch each (the fast chain)
    takes in turn, instead of grid z. The fused backward is a
    one-dimensional grid of ``blocks``, each taking the units (cloud, range
    of ``span`` rows) ``b, b + blocks, ...`` of the ``bh * per_cloud``, and
    ``groups`` windows of ``slices`` slices in turn. ``smem`` is the
    dynamic shared memory per block in bytes. The float32 backward
    (``slice_bwd_f32``) takes ``sweep`` windows in one sweep of its rows:
    a first pass's grid z holds ``ceil(groups / sweep)`` sweeps, a chain
    launches once per sweep. ``warps`` and ``tile_rows``: a block's warps
    and their tiles' rows (:func:`warp_tiles`)."""

    route: str
    per_cloud: int
    span: int
    groups: int
    smem: int
    slices: int
    blocks: int = 0
    sweep: int = 1
    warps: int = WARPS
    tile_rows: int = TILE_ROWS


def fast_widths(c: int, g: int):
    """``(CM, GL)`` of the fast kernels for C channels and G slices, or
    None: C padded to ``CM`` in {8, 16, 32}, G to ``32 * GL`` (any G >= 1)
    (``fast_cm`` in the CUDA source)."""
    cm = next((w for w in (8, 16, 32) if c <= w), None)
    if cm is None or g < 1:
        return None
    return cm, _cdiv(g, 32)


def register_slices(cm: int, gl: int) -> int:
    """Slices whose tensor-core fragments of Ws (and the states) a lane
    holds at once: 64 at ``CM <= 16`` with more than 32 slices, else 32
    (``held_slices`` in the CUDA source). slice_states gives each group of
    them its own blocks; deslice rebuilds the fragments group by group."""
    return 64 if cm <= 16 and gl >= 2 else 32


def states_smem(cm: int, gp: int, per_cloud: int) -> int:
    """Dynamic shared memory of a fast slice_states block of ``gp`` slices
    (``states_smem`` in the CUDA source): the larger of the warps' x rings
    (rows padded to CM + 4 floats) with the staged Ws, bs and Wa, and its
    two merges."""
    ring = WARPS * STAGES * TILE_ROWS * (cm + 4)
    floats = max(ring + cm * (gp + 1) + gp + cm,
                 WARPS * gp * (2 + cm + 8) + gp, (2 * per_cloud + 2) * gp)
    return 4 * floats


def deslice_smem(cm: int, gp: int) -> int:
    """Dynamic shared memory of a fast deslice launch staging ``gp`` slices
    (``deslice_smem``): the x rings, Ws, bs, Wa, states / s and m."""
    ring = WARPS * STAGES * TILE_ROWS * (cm + 4)
    return 4 * (ring + cm * (gp + 1) + gp * (cm + 4) + 2 * gp + cm)


def deslice_slices(cm: int, g: int) -> int:
    """Slices a fast deslice block stages at once: G padded to a multiple
    of the held slices, at most as many as fit its shared memory (past
    that, it stages them in ranges, one after the other)."""
    gh = register_slices(cm, _cdiv(g, 32))
    gp = _cdiv(g, gh) * gh
    while deslice_smem(cm, gp) > MAX_SMEM:
        gp -= gh
    return gp


def _is_first_pass(kernel: str) -> bool:
    return kernel.endswith("_sums")


def bwd_smem(cm: int, kernel: str, sweep: int = 1) -> int:
    """Dynamic shared memory of a float32 backward block
    (``bwd_smem_floats`` in the CUDA source) sweeping ``sweep`` windows:
    the x ring (and deslice's g_out ring) of :data:`BWD_WARPS` warps'
    slots; per window the wgmma B tables, hi and lo parts of ``32 * CM``
    floats each (Ws and the G-side matrix for the logits and dw; in the
    chains Ws^T, and slice_states' G^, for dx), and four floats per slice;
    Wa; the warps' 16-row dpre (or w) buffers and draw."""
    mode = BWD_MODES[kernel]
    ring = BWD_WARPS * STAGES * BWD_TILE_ROWS * (cm + 4)
    tables = 2 + (2, 0, 1, 0)[mode]
    floats = ((2 if kernel.startswith("deslice") else 1) * ring
              + sweep * (2 * tables * 32 * cm + 4 * BWD_WINDOW)
              + cm + BWD_WARPS * BWD_TILE_ROWS * (BUF_STRIDE + 1))
    return 4 * floats


def bwd_sweep(cm: int, kernel: str, g: int) -> int:
    """Windows of :data:`BWD_WINDOW` slices the float32 backward ``kernel``
    takes in one sweep of its rows at ``CM`` and G (the CUDA source's
    ``HAET_BWD_F32_CASES``): two past G 32 at CM <= 16 (the Darcy preset's
    G 64: x read once for both windows, and the chain's dx and its rows'
    ``sum_g dlogit * logit`` kept in registers), except in deslice's first
    pass, whose dstates accumulators for two windows spill past the 128
    registers a thread has at 16 warps per SM; one at CM 32, where the
    sweep's accumulators spill (slower on an H100: ``PERF.md``)."""
    if g <= BWD_WINDOW or cm > 16 or kernel == "deslice_bwd_sums":
        return 1
    return 2


def bwd_row(cm: int, kernel: str) -> int:
    """Row stride of a block's partial sums (``bwd_row``): the channels,
    then dbs (a chain), or t and ``sum_n w`` (a first pass)."""
    return cm + (2 if _is_first_pass(kernel) else 1)


def bwd_part_floats(cm: int, kernel: str) -> int:
    """Floats of one fast block's partial sums (``bwd_part_floats``):
    ``[BW][bwd_row]`` (dWs^T and dbs, or dstates, t and ``sum_n w``), then
    dWa and dba for a chain."""
    extra = 0 if _is_first_pass(kernel) else cm + 1
    return BWD_WINDOW * bwd_row(cm, kernel) + extra


def fused_smem(cm: int, kernel: str) -> int:
    """Dynamic shared memory of a fused backward block (``bwd_fused_smem``
    in the CUDA source, bf16 I/O): the x ring (and deslice's g_out ring) in
    bf16, rows padded by 16 bytes, where the block merges also go; the
    fragment tables of Ws as B and A (16-byte hi/lo pairs) and of the
    G-side matrix as B (and slice_states' G^ as A), high parts alone; four
    floats per slice of the window, Wa, and the warps' 16-row buffers and
    draw."""
    deslice = kernel.startswith("deslice")
    ring = WARPS * STAGES * TILE_ROWS * (cm + 8) * 2
    merge = 4 * WARPS * (BWD_WINDOW * (cm + 2) + cm + 1)
    lanes = (BWD_WINDOW // 8) * 32
    tables = ((cm // 8) * lanes * (4 + 2)
              + max(1, cm // 16) * lanes * (8 + (0 if deslice else 4)))
    return (max((2 if deslice else 1) * ring, merge)
            + 4 * (tables + 4 * BWD_WINDOW + cm
                   + WARPS * 16 * (BUF_STRIDE + 1)))


def bwd_partials(cm: int, bh: int, per_cloud: int, windows: int):
    """Floats of a fused backward's partial sums: ``(part1, tsum, part2,
    cpart, pw2)``, the first pass's ``[windows][units][BW][CM + 2]``
    (dstates, t and ``sum_n w`` per slice) and their merge per cloud
    ``[bh][windows][BW][2]`` (t, ``sum_n w``), the chain's ``[units][pw2]``
    and the clouds' ``[bh][pw2]``, ``pw2 = windows * BW * (CM + 1) + CM +
    1`` (dWs^T and dbs per window, then dWa and dba)."""
    units = bh * per_cloud
    pw2 = windows * BWD_WINDOW * (cm + 1) + cm + 1
    return (windows * units * BWD_WINDOW * (cm + 2),
            bh * windows * BWD_WINDOW * 2, units * pw2, bh * pw2, pw2)


def generic_bwd_plan(c: int, g: int):
    """``(slices per group, rows per tile)`` of ``slice_bwd_generic``
    (``generic_bwd_gsz``, ``generic_bwd_tile``): a group's ``gsz * C <=
    NT * MAX_ACC`` accumulators in registers, its Ws and G-side matrix and
    the tile's rows in shared memory."""
    gsz = min(g, max(1, NT * MAX_ACC // c))
    fixed = 2 * c * gsz + 4 * gsz + c
    tile = min(GENERIC_TILE, (MAX_SMEM // 4 - fixed) // (2 * c + 3 * gsz + 4))
    return gsz, tile


def generic_bwd_smem(c: int, g: int) -> int:
    """Dynamic shared memory of a ``slice_bwd_generic`` block
    (``generic_bwd_smem``)."""
    gsz, tile = generic_bwd_plan(c, g)
    return 4 * (2 * c * gsz + 4 * gsz + c + tile * (2 * c + 3 * gsz + 4))


def generic_plan(c: int, g: int):
    """``(slice_states' slices per block, deslice's rows per block,
    deslice's slices per group)`` of the generic kernels
    (``generic_states_gsz``, ``generic_dtile``, ``generic_deslice_gsz``):
    slice_states keeps ``gsz * C <= NT * MAX_ACC`` accumulators in
    registers, deslice ``dtile * C <= NT * MAX_OUT`` outputs, its groups'
    Ws and states in the rest of the shared memory."""
    gs = min(g, max(1, NT * MAX_ACC // c))
    dtile = min(64, NT * MAX_OUT // c)
    gd = min(g, (MAX_SMEM // 4 - c - dtile * (c + 1)) // (2 * c + 3 + dtile))
    return gs, dtile, gd


def generic_tile(c: int, gs: int) -> int:
    """Points per inner tile of the generic slice_states
    (``generic_states_tile``): 32, fewer where its rows would not fit the
    shared memory beside ``gs`` slices' weights."""
    fixed = c * gs + 5 * gs + c
    return min(GENERIC_TILE, (MAX_SMEM // 4 - fixed) // (c + gs + 1))


def _generic_smem(c: int, g: int, kernel: str) -> int:
    gs, dtile, gd = generic_plan(c, g)
    if kernel == "slice_states":
        tile = generic_tile(c, gs)
        return 4 * (c * gs + 5 * gs + c + tile * (c + gs + 1))
    return 4 * (2 * c * gd + 3 * gd + c + dtile * (c + gd + 1))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split_rows(bh: int, n: int, groups: int, sms: int,
                warps: int = WARPS, tile_rows: int = TILE_ROWS):
    """``(per_cloud, span)``: one wave of blocks, one per SM, shared among
    the clouds and grid-z groups; each block's range a whole number of its
    ``warps`` warps' tiles of ``tile_rows`` rows."""
    per_cloud = max(1, min(sms // (bh * groups), _cdiv(n, tile_rows)))
    block_rows = warps * tile_rows
    span = _cdiv(_cdiv(n, per_cloud), block_rows) * block_rows
    return _cdiv(n, span), span


def launch_geometry(kernel: str, bh: int, n: int, c: int, g: int,
                    sms: int) -> Geometry:
    """The launch of ``kernel`` for ``bh`` clouds of ``n`` points on a card
    of ``sms`` multiprocessors: "slice_states" or "deslice"; or a backward
    pass, "slice_states_bwd_sums" / "deslice_bwd_sums" (the first passes)
    or "slice_states_bwd" / "deslice_bwd" (the chains). A fast kernel, or a
    generic backward, fills one wave, one block per SM, shared among the
    clouds and its grid-z groups (a first pass's sweeps of windows); each
    block's range is a whole number of the fast warps' tiles. Heads wider
    than 32 take the generic kernels."""
    widths = fast_widths(c, g)
    if kernel in BWD_MODES:
        if widths is None:  # C <= MAX_GENERIC_C (``_check_inputs``)
            gsz = generic_bwd_plan(c, g)[0]
            groups = _cdiv(g, gsz)
            per_cloud, span = _split_rows(
                bh, n, groups if _is_first_pass(kernel) else 1, sms)
            return Geometry("generic", per_cloud, span, groups,
                            generic_bwd_smem(c, g), gsz)
        cm = widths[0]
        windows = _cdiv(g, BWD_WINDOW)
        sweep = bwd_sweep(cm, kernel, g)
        per_cloud, span = _split_rows(
            bh, n, _cdiv(windows, sweep) if _is_first_pass(kernel) else 1,
            sms, BWD_WARPS, BWD_TILE_ROWS)
        return Geometry("fast", per_cloud, span, windows,
                        bwd_smem(cm, kernel, sweep), BWD_WINDOW, sweep=sweep,
                        warps=BWD_WARPS, tile_rows=BWD_TILE_ROWS)
    if widths is None:  # C <= MAX_GENERIC_C (``_check_inputs``)
        gs, dtile, gd = generic_plan(c, g)
        if kernel == "slice_states":
            return Geometry("generic", _cdiv(n, CHUNK), CHUNK, _cdiv(g, gs),
                            _generic_smem(c, g, kernel), gs)
        return Geometry("generic", _cdiv(n, dtile), dtile, 1,
                        _generic_smem(c, g, kernel), gd)
    cm, gl = widths
    if kernel == "slice_states":
        gp = register_slices(cm, gl)
        groups = _cdiv(g, gp)
        per_cloud, span = _split_rows(bh, n, groups, sms)
        return Geometry("fast", per_cloud, span, groups,
                        states_smem(cm, gp, per_cloud), gp)
    gp = deslice_slices(cm, g)
    per_cloud, span = _split_rows(bh, n, 1, sms)
    return Geometry("fast", per_cloud, span, _cdiv(g, gp),
                    deslice_smem(cm, gp), gp)


def fused_geometry(kernel: str, bh: int, n: int, c: int, g: int, sms: int,
                   per_sm: int) -> Geometry:
    """The launch of the fused backward ``kernel``, "slice_states_bwd" or
    "deslice_bwd" (bf16, C <= 32), for ``bh`` clouds of ``n`` points on a
    card of ``sms`` multiprocessors that keeps ``per_sm`` of its blocks
    resident on each (:func:`fused_blocks`): a persistent grid of at most
    ``per_sm * sms`` blocks; each cloud's N is cut into ``per_cloud``
    ranges as for the forwards, each a unit."""
    cm = fast_widths(c, g)[0]
    capacity = per_sm * sms
    per_cloud, span = _split_rows(bh, n, 1, capacity)
    return Geometry("fused", per_cloud, span, _cdiv(g, BWD_WINDOW),
                    fused_smem(cm, kernel), BWD_WINDOW,
                    min(bh * per_cloud, capacity))


def warp_tiles(geom: Geometry, n: int, reverse: bool = False):
    """``(block, warp, row0, rows)`` of every tile a fast-kernel launch
    reads from one cloud, in the order each warp takes them (``block`` the
    cloud's range of ``span`` rows, ``geom.warps`` warps of tiles of
    ``geom.tile_rows`` rows; ``reverse``: last first, as the fused
    backward's chain takes them)."""
    tr = geom.tile_rows
    for blk in range(geom.per_cloud):
        begin = blk * geom.span
        end = min(n, begin + geom.span)
        for warp in range(geom.warps):
            rows = range(begin + warp * tr, end, geom.warps * tr)
            for row0 in (reversed(rows) if reverse else rows):
                yield blk, warp, row0, min(tr, end - row0)


def sm_count(device) -> int:
    """The card's multiprocessors."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_COUNTERS: dict = {}
#: counters outgrown by a wider launch, kept: a CUDA graph may hold them
_RETIRED: list = []
_COUNTERS_LOCK = threading.Lock()


def _counter(device, stream_ptr: int, count: int,
             user: str = "slice_states") -> torch.Tensor:
    """``count`` int32 counters of one kernel (``user``: the fast
    slice_states' arrival counters, one per cloud and slice group; the
    fused backward's grid barrier and merge counters) for one stream:
    zeros, which the kernel leaves at zero, so a CUDA graph that captured
    them stays right replay after replay. They are allocated outside any
    capture: a capture that would need a new one raises (warm the kernel
    up on the capturing stream first)."""
    key = (device.index, stream_ptr, user)
    with _COUNTERS_LOCK:
        buf = _COUNTERS.get(key)
        if buf is None or buf.numel() < count:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{user}: no counters for this stream and width outside "
                    f"the capture; run the step once on the capturing "
                    f"stream before capturing it")
            if buf is not None:
                _RETIRED.append(buf)
            buf = torch.zeros(max(count, 64), device=device,
                              dtype=torch.int32)
            _COUNTERS[key] = buf
        return buf


def _shift(epsilon: float) -> float:
    return math.log(-math.log(epsilon))


def _logits(x, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon):
    """``z = (x @ Ws + bs - log(-log eps)) / tau`` in float32."""
    x = x.float()
    raw = x @ w_ada.float() + b_ada.float()
    tau = base_temp + raw.clamp(-0.4, 0.4)
    return (x @ w_slice.float() + b_slice.float() - _shift(epsilon)) / tau


# The residual guards of the Pallas kernels (``slice_kernels.py:99-104,
# :115, :139-140``): an all ``-inf`` column keeps ``m`` finite, and an empty
# one divides by 1.
def _m_safe(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _denom(s):
    return torch.where(s > 0, s, torch.ones_like(s))


def slice_states_plain(x_proj, w_slice, b_slice, w_ada, b_ada,
                       base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`slice_states` (materialises ``[B,H,N,G]``):
    the states in ``x_proj``'s dtype, ``m`` and ``s`` float32."""
    states, m, s = slice_states_plain_f32(x_proj, w_slice, b_slice, w_ada,
                                          b_ada, base_temp, epsilon)
    return states.to(x_proj.dtype), m, s


def slice_states_plain_f32(x_proj, w_slice, b_slice, w_ada, b_ada,
                           base_temp: float = 0.5, epsilon: float = 1e-6):
    """:func:`slice_states_plain` with the states in the float32 they are
    accumulated in: the backward's residual (``_slice_states_impl_f32`` of
    the JAX code)."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    m = z.amax(dim=2)                                           # [B,H,G]
    e = torch.exp(z - _m_safe(m)[:, :, None, :])
    s = e.sum(dim=2)
    acc = torch.einsum("bhng,bhnc->bhgc", e, x_proj.float())
    return acc / _denom(s)[..., None] / _NORM, m, s


def deslice_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                  base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`deslice`."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    w = (torch.exp(z - _m_safe(m)[:, :, None, :])
         / _denom(s)[:, :, None, :])
    out = torch.einsum("bhng,bhgc->bhnc", w, states.float())
    return out.to(x_proj.dtype)


#: element types of ``x_proj`` (and of the states, ``out``, ``g_out`` and
#: the gradients that go with it)
IO_DTYPES = (torch.float32, torch.bfloat16)


def _check(name, t, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada):
    if x_proj.dim() != 4:
        raise ValueError(f"x_proj must be [B, H, N, C], got {x_proj.shape}")
    b, h, n, c = x_proj.shape
    g = w_slice.shape[-1]
    dev = x_proj.device
    if x_proj.dtype not in IO_DTYPES:
        raise TypeError(f"x_proj must be float32 or bfloat16, got "
                        f"{x_proj.dtype}")
    _check("x_proj", x_proj, (b, h, n, c), dev, x_proj.dtype)
    _check("w_slice", w_slice, (c, g), dev)
    _check("b_slice", b_slice, (g,), dev)
    _check("w_ada", w_ada, (c, 1), dev)
    _check("b_ada", b_ada, (1,), dev)
    if n < 1:
        raise ValueError("slice kernels need at least one point")
    if c > MAX_GENERIC_C:
        raise ValueError(f"the slice kernels take C <= {MAX_GENERIC_C}, "
                         f"got {c}")
    return b, h, n, c, g


def _on_card(x_proj, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain version); raises on any other device."""
    if x_proj.device.type == "cpu":
        return False
    if x_proj.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x_proj.device}")
    return True


def _stream(device) -> ctypes.c_void_p:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _needs_grad(*tensors) -> bool:
    """True when autograd records this call: the autograd functions then
    run the ops, otherwise the ops run alone (eval, inference and
    ``torch.export``, which must see the ops, not the functions' bodies)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def slice_states(x_proj, w_slice, b_slice, w_ada, b_ada,
                 base_temp: float = 0.5, epsilon: float = 1e-6):
    """Fused eidetic states, differentiable in ``states``
    (:class:`SliceStatesFn`) when autograd records the call; otherwise the
    operator ``haet::slice_states`` alone.

    Args:
        x_proj: ``[B, H, N, C]`` float32 or bfloat16, contiguous.
        w_slice/b_slice: ``[C, G]``, ``[G]``; w_ada/b_ada: ``[C, 1]``, ``[1]``
            (float32).

    Returns ``(states [B,H,G,C], m [B,H,G], s [B,H,G])``: the states in
    ``x_proj``'s dtype, ``m`` and ``s`` float32.
    """
    _on_card(x_proj, "slice_states")  # raises off cuda and cpu
    if _needs_grad(x_proj, w_slice, b_slice, w_ada, b_ada):
        return SliceStatesFn.apply(x_proj, w_slice, b_slice, w_ada, b_ada,
                                   base_temp, epsilon)
    states, m, s, _ = slice_states_op(x_proj, w_slice, b_slice, w_ada, b_ada,
                                      base_temp, epsilon)
    return states, m, s


def deslice(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
            base_temp: float = 0.5, epsilon: float = 1e-6):
    """Fused deslice: ``out[b,h,n,:] = sum_g w[b,h,n,g] states[b,h,g,:]``
    with ``w`` recomputed from the ``(m, s)`` residuals of
    :func:`slice_states`. ``states`` in ``x_proj``'s dtype. Returns ``[B, H,
    N, C]`` in it, differentiable in every input but ``m`` and ``s``
    (:class:`DesliceFn`) when autograd records the call; otherwise the
    operator ``haet::deslice`` alone."""
    _on_card(x_proj, "deslice")  # raises off cuda and cpu
    if _needs_grad(x_proj, w_slice, b_slice, w_ada, b_ada, states):
        return DesliceFn.apply(x_proj, w_slice, b_slice, w_ada, b_ada,
                               states, m, s, base_temp, epsilon)
    return deslice_op(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                      base_temp, epsilon)


def slice_states_with_residual(x_proj, w_slice, b_slice, w_ada, b_ada,
                               base_temp: float = 0.5,
                               epsilon: float = 1e-6):
    """:func:`slice_states`' forward without autograd, the kernel on a CUDA
    tensor and the plain version on a CPU tensor: ``(states in x_proj's
    dtype, the float32 states, m, s)``; the float32 states are the
    backward's residual, and for a bf16 ``x_proj`` the public states are
    their rounding."""
    states, m, s, residual = slice_states_op(
        x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    return states, (residual if residual.numel() else states), m, s


# The forwards as the operators ``haet::slice_states`` and ``haet::deslice``
# (:func:`~haet_torch.ops.kernels.define_op`), so that one entry serves
# training (the autograd functions call them), eval and ``torch.export``;
# the fakes give the kernels' exact outputs. An operator's outputs may not
# alias one another, so slice_states returns its float32 residual only
# where it differs from the public states (bf16 ``x_proj``) and an empty
# tensor otherwise.

def _slice_states_impl(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                       epsilon):
    """``(states in x_proj's dtype, m, s, residual)``: the kernel on a CUDA
    tensor, the plain version on a CPU tensor; ``residual`` is the float32
    states for a bf16 ``x_proj`` and empty for a float32 one."""
    args = (x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    if _on_card(x_proj, "slice_states"):
        states, states_f32, m, s = _slice_states_kernel(*args)
    else:
        states_f32, m, s = slice_states_plain_f32(*args)
        states = states_f32.to(x_proj.dtype)
    if states is states_f32:
        states_f32 = states_f32.new_empty(0)
    return states, m, s, states_f32


def _slice_states_fake(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                       epsilon):
    b, h, _, c = x_proj.shape
    g = w_slice.shape[-1]
    states = x_proj.new_empty((b, h, g, c))
    m = x_proj.new_empty((b, h, g), dtype=torch.float32)
    residual = x_proj.new_empty(
        (0,) if x_proj.dtype == torch.float32 else (b, h, g, c),
        dtype=torch.float32)
    return states, m, torch.empty_like(m), residual


def _deslice_impl(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                  base_temp, epsilon):
    """``out [B, H, N, C]`` in ``x_proj``'s dtype: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    args = (x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, base_temp,
            epsilon)
    if _on_card(x_proj, "deslice"):
        return _deslice_kernel(*args)
    return deslice_plain(*args)


def _deslice_fake(x_proj, *args):
    return torch.empty_like(x_proj)


_HEAD = ("(Tensor x_proj, Tensor w_slice, Tensor b_slice, Tensor w_ada, "
         "Tensor b_ada, ")
slice_states_op = define_op(
    "slice_states", _HEAD + "float base_temp, float epsilon) -> "
    "(Tensor, Tensor, Tensor, Tensor)", _slice_states_impl,
    _slice_states_fake)
deslice_op = define_op(
    "deslice", _HEAD + "Tensor states, Tensor m, Tensor s, float base_temp, "
    "float epsilon) -> Tensor", _deslice_impl, _deslice_fake)


def _slice_states_kernel(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                         epsilon):
    b, h, n, c, g = _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada)
    bh = b * h
    dev = x_proj.device
    low = x_proj.dtype == torch.bfloat16
    geom = launch_geometry("slice_states", bh, n, c, g, sm_count(dev))
    states = torch.empty((b, h, g, c), device=dev, dtype=torch.float32)
    # the public bf16 copy, written by the fast kernel beside the float32
    # states (the residual)
    states_lo = (torch.empty_like(states, dtype=torch.bfloat16)
                 if low and geom.route == "fast" else None)
    m = torch.empty((b, h, g), device=dev, dtype=torch.float32)
    s = torch.empty_like(m)
    lib = _lib()
    stream = _stream(dev)
    # partial softmax states per block: fast, [BH, groups, blocks, GP, CM]
    # (a block's slices and channels, padded); generic, [BH, blocks, G, C]
    if geom.route == "fast":
        rows, pg, pc = bh * geom.groups, geom.slices, fast_widths(c, g)[0]
    else:
        rows, pg, pc = bh, g, c
    part_m = torch.empty((rows, geom.per_cloud, pg), device=dev,
                         dtype=torch.float32)
    part_s = torch.empty_like(part_m)
    part_acc = torch.empty((rows, geom.per_cloud, pg, pc), device=dev,
                           dtype=torch.float32)
    x_in = x_proj if geom.route == "fast" else x_proj.float()
    head = (x_in.data_ptr(), w_slice.data_ptr(), b_slice.data_ptr(),
            w_ada.data_ptr(), b_ada.data_ptr(), part_m.data_ptr(),
            part_s.data_ptr(), part_acc.data_ptr())
    if geom.route == "fast":
        status = lib.haet_slice_states(
            *head, _counter(dev, stream.value, bh * geom.groups).data_ptr(),
            states.data_ptr(), _ptr(states_lo), m.data_ptr(), s.data_ptr(),
            bh, n, c, g, geom.per_cloud, geom.span, base_temp,
            _shift(epsilon), geom.smem, int(low), stream)
    else:
        status = lib.haet_slice_states_generic_f32(
            *head, states.data_ptr(), m.data_ptr(), s.data_ptr(), bh, n, c,
            g, CHUNK, base_temp, _shift(epsilon), stream)
        if low:
            states_lo = states.to(torch.bfloat16)
    _build.check(lib, status, "slice_states")
    SLICE_STATES_LAUNCHES.add()
    return (states if states_lo is None else states_lo), states, m, s


def _deslice_kernel(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                    base_temp, epsilon):
    b, h, n, c, g = _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada)
    dev = x_proj.device
    _check("states", states, (b, h, g, c), dev, x_proj.dtype)
    _check("m", m, (b, h, g), dev)
    _check("s", s, (b, h, g), dev)
    low = x_proj.dtype == torch.bfloat16
    out = torch.empty_like(x_proj)
    lib = _lib()
    geom = launch_geometry("deslice", b * h, n, c, g, sm_count(dev))
    if geom.route == "fast":
        # the staged ranges' sums meet in float32: out itself, or a scratch
        # for a bf16 out staged in more than one range
        acc = out
        if low:
            acc = (torch.empty_like(out, dtype=torch.float32)
                   if geom.groups > 1 else None)
        status = lib.haet_deslice(
            x_proj.data_ptr(), w_slice.data_ptr(), b_slice.data_ptr(),
            w_ada.data_ptr(), b_ada.data_ptr(), states.data_ptr(),
            m.data_ptr(), s.data_ptr(), out.data_ptr(), _ptr(acc), b * h, n,
            c, g, geom.slices, geom.per_cloud, geom.span, base_temp,
            _shift(epsilon), geom.smem, int(low), _stream(dev))
    else:
        x_in, st_in, wide = x_proj.float(), states.float(), out.float()
        status = lib.haet_deslice_generic_f32(
            x_in.data_ptr(), w_slice.data_ptr(), b_slice.data_ptr(),
            w_ada.data_ptr(), b_ada.data_ptr(), st_in.data_ptr(),
            m.data_ptr(), s.data_ptr(), wide.data_ptr(), b * h, n, c, g,
            base_temp, _shift(epsilon), _stream(dev))
        if low:
            out = wide.to(torch.bfloat16)
    _build.check(lib, status, "deslice")
    DESLICE_LAUNCHES.add()
    return out


class SliceStatesFn(torch.autograd.Function):
    """:func:`slice_states` with :func:`slice_states_bwd` as its backward
    (the JAX ``custom_vjp``, ``slice_kernels.py:316-383``): the backward
    kernel on CUDA tensors. The float32 states are the residual, whatever
    the dtype of the states it returns (a bf16 round trip there would put
    bf16 error into every point's gradient, ADVICE r2); a gradient arriving
    on ``m`` or ``s`` is dropped, as the JAX backward drops it."""

    @staticmethod
    def forward(ctx, x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                epsilon):
        states, states_f32, m, s = slice_states_with_residual(
            x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
        ctx.save_for_backward(x_proj, w_slice, b_slice, w_ada, b_ada,
                              states_f32, m, s)
        ctx.consts = (base_temp, epsilon)
        ctx.mark_non_differentiable(m, s)
        return states, m, s

    @staticmethod
    def backward(ctx, g_states, _g_m, _g_s):
        grads = slice_states_bwd(*ctx.saved_tensors, g_states.contiguous(),
                                 *ctx.consts)
        return (*grads, None, None)


class DesliceFn(torch.autograd.Function):
    """:func:`deslice` with :func:`deslice_bwd` as its backward (the JAX
    ``custom_vjp``, ``slice_kernels.py:441-526``): the backward kernels on
    CUDA tensors; no gradient for ``m``, ``s``."""

    @staticmethod
    def forward(ctx, x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                base_temp, epsilon):
        ctx.save_for_backward(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                              m, s)
        ctx.consts = (base_temp, epsilon)
        return deslice_op(x_proj, w_slice, b_slice, w_ada, b_ada, states, m,
                          s, base_temp, epsilon)

    @staticmethod
    def backward(ctx, g_out):
        grads = deslice_bwd(*ctx.saved_tensors, g_out.contiguous(),
                            *ctx.consts)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# The plain backwards: chunked PyTorch (the CPU path, the ground truth the
# kernels are held against on the card, and the route of heads wider than
# the backward kernels take).
#
# Per (b, h), with the softmax over the points axis n:
#   raw[n] = x[n] @ Wa + ba;  tau[n] = base + clip(raw[n], +-0.4)
#   logit[n, g] = (x[n] @ Ws + bs - log(-log eps)) / tau[n]
#   w[n, g] = exp(logit - m[g]) / s[g]                (m, s: the residuals)
# Given dL/dw, the softmax jacobian gives dL/dlogit = w (dL/dw - t[g]) with
# t[g] = sum_n w dL/dw; then the Ada-Temp chain to x, Ws, bs, Wa, ba. Every
# term decomposes over chunks of n once (m, s) are known.
# ---------------------------------------------------------------------------

def _w_chunk(xc, ws, bs, wa, ba, base_temp, shift, m_safe, denom):
    """``(w, logit, tau, raw)`` of one ``[BH, T, C]`` chunk, float32."""
    raw = xc @ wa + ba                                   # [BH, T, 1]
    tau = base_temp + raw.clamp(-0.4, 0.4)
    logit = (xc @ ws + bs - shift) / tau                 # [BH, T, G]
    w = torch.exp(logit - m_safe[:, None, :]) / denom[:, None, :]
    return w, logit, tau, raw


def _chain_to_inputs(xc, w, dw, t, logit, tau, raw, ws, wa):
    """``dL/dw`` of one chunk -> ``(dx, dWs, dbs, dWa, dba)``
    (``slice_kernels.py:293-305``; the clip passes a gradient only strictly
    inside ``(-0.4, 0.4)``)."""
    dlogit = w * (dw - t[:, None, :])
    dpre = dlogit / tau
    dtau = -(dlogit * logit).sum(dim=-1, keepdim=True) / tau
    draw = torch.where((raw > -0.4) & (raw < 0.4), dtau,
                       torch.zeros_like(dtau))
    dx = dpre @ ws.t() + draw @ wa.t()
    return (dx, torch.einsum("btc,btg->cg", xc, dpre), dpre.sum(dim=(0, 1)),
            torch.einsum("btc,bto->co", xc, draw), draw.sum(dim=(0, 1)))


def _flat_f32(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s):
    b, h, n, c = x_proj.shape
    g = w_slice.shape[1]
    bh = b * h
    m_safe = _m_safe(m.reshape(bh, g).float())
    denom = _denom(s.reshape(bh, g).float())
    return ((b, h, n, c, g), x_proj.reshape(bh, n, c).float(),
            (w_slice.float(), b_slice.float(), w_ada.float(), b_ada.float()),
            states.reshape(bh, g, c).float(), m_safe, denom)


def _chunks(n: int):
    return [slice(i, min(i + BWD_CHUNK, n)) for i in range(0, n, BWD_CHUNK)]


def slice_states_bwd_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                           m, s, g_states, base_temp: float = 0.5,
                           epsilon: float = 1e-6):
    """Plain version of :func:`slice_states_bwd`: ``(dx_proj, dWs, dbs,
    dWa, dba)`` from the residuals and ``dL/dstates``
    (``slice_kernels.py:327-383``).

    One pass over N in chunks of :data:`BWD_CHUNK`: with ``states = A /
    (1 + 1e-5)`` and ``sum_n w == 1``, the softmax coupling has the closed
    form ``t[g] = sum_c G^[g, c] A[g, c] + dnorm[g]``, where ``G^`` is the
    states' gradient over the norm and ``dnorm = -sum_c G^ states`` is the
    norm's own gradient.
    """
    (b, h, n, c, g), xf, (ws, bs, wa, ba), st, m_safe, denom = _flat_f32(
        x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s)
    shift = _shift(epsilon)
    ghat = g_states.reshape(b * h, g, c).float() / _NORM     # [BH, G, C]
    dnorm = -(ghat * st).sum(dim=-1)                         # [BH, G]
    t = (ghat * (st * _NORM)).sum(dim=-1) + dnorm
    dx = torch.empty_like(xf)
    dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
    dwa, dba = torch.zeros_like(wa), torch.zeros_like(ba)
    for sl in _chunks(n):
        xc = xf[:, sl]
        w, logit, tau, raw = _w_chunk(xc, ws, bs, wa, ba, base_temp, shift,
                                      m_safe, denom)
        dw = xc @ ghat.transpose(1, 2) + dnorm[:, None, :]
        dxc, dws_c, dbs_c, dwa_c, dba_c = _chain_to_inputs(
            xc, w, dw, t, logit, tau, raw, ws, wa)
        dx[:, sl] = w @ ghat + dxc                     # the A path, then z
        dws += dws_c
        dbs += dbs_c
        dwa += dwa_c
        dba += dba_c
    return (dx.reshape(b, h, n, c).to(x_proj.dtype), dws.to(w_slice.dtype),
            dbs.to(b_slice.dtype), dwa.to(w_ada.dtype), dba.to(b_ada.dtype))


def deslice_bwd_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                      g_out, base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`deslice_bwd`: ``(dx_proj, dWs, dbs, dWa,
    dba, dstates)`` from the residuals and ``dL/dout``
    (``slice_kernels.py:448-526``).

    The coupling ``t[g] = sum_n w (dL/dout @ states^T)`` has no closed form,
    so two passes run over N: the first sums ``t`` and ``dL/dstates``, the
    second applies the softmax and Ada-Temp chain.
    """
    (b, h, n, c, g), xf, (ws, bs, wa, ba), st, m_safe, denom = _flat_f32(
        x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s)
    shift = _shift(epsilon)
    go = g_out.reshape(b * h, n, c).float()
    st_t = st.transpose(1, 2)                                # [BH, C, G]
    t = torch.zeros_like(m_safe)
    dst = torch.zeros_like(st)
    for sl in _chunks(n):
        w, *_ = _w_chunk(xf[:, sl], ws, bs, wa, ba, base_temp, shift, m_safe,
                         denom)
        goc = go[:, sl]
        t += (w * (goc @ st_t)).sum(dim=1)
        dst += w.transpose(1, 2) @ goc
    dx = torch.empty_like(xf)
    dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
    dwa, dba = torch.zeros_like(wa), torch.zeros_like(ba)
    for sl in _chunks(n):
        xc = xf[:, sl]
        w, logit, tau, raw = _w_chunk(xc, ws, bs, wa, ba, base_temp, shift,
                                      m_safe, denom)
        dx[:, sl], dws_c, dbs_c, dwa_c, dba_c = _chain_to_inputs(
            xc, w, go[:, sl] @ st_t, t, logit, tau, raw, ws, wa)
        dws += dws_c
        dbs += dbs_c
        dwa += dwa_c
        dba += dba_c
    return (dx.reshape(b, h, n, c).to(x_proj.dtype), dws.to(w_slice.dtype),
            dbs.to(b_slice.dtype), dwa.to(w_ada.dtype), dba.to(b_ada.dtype),
            dst.reshape(b, h, g, c).to(states.dtype))


def slice_states_bwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                     g_states, base_temp: float = 0.5,
                     epsilon: float = 1e-6):
    """Backward of :func:`slice_states` from its residuals and ``dL/dstates``:
    ``(dx_proj, dWs, dbs, dWa, dba)`` (``slice_kernels.py:327-383``).

    On CUDA tensors the backward kernels: a first pass sums ``t[g] = sum_n
    w (x G^[g])`` and ``S[g] = sum_n w`` (``G^`` the states' gradient over
    the norm), the second applies the chain with ``w / S`` and ``t / S``,
    the exact softmax of the kernels' own logits (the residuals' ``sum_n w
    = 1`` holds only up to the forward's rounding of the logits); on CPU
    tensors :func:`slice_states_bwd_plain`.
    """
    args = (x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, g_states,
            base_temp, epsilon)
    if not _on_card(x_proj, "slice_states_bwd"):
        return slice_states_bwd_plain(*args)
    return _slice_states_bwd_kernel(*args)


def deslice_bwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, g_out,
                base_temp: float = 0.5, epsilon: float = 1e-6):
    """Backward of :func:`deslice` from its residuals and ``dL/dout``:
    ``(dx_proj, dWs, dbs, dWa, dba, dstates)`` (``slice_kernels.py:448-526``).

    The coupling ``t[g] = sum_n w (dL/dout @ states^T)`` has no closed form,
    so two passes run over N: the first sums ``t``, ``sum_n w`` and
    ``dL/dstates``, the second applies the softmax and Ada-Temp chain. On
    CUDA tensors the backward kernels, which normalise by their own ``S =
    sum_n w`` as :func:`slice_states_bwd` says, dstates included (``sum_n
    w g_out / S``, on every route); on CPU tensors
    :func:`deslice_bwd_plain`.
    """
    args = (x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, g_out,
            base_temp, epsilon)
    if not _on_card(x_proj, "deslice_bwd"):
        return deslice_bwd_plain(*args)
    return _deslice_bwd_kernel(*args)


def _ptr(t) -> int:
    return None if t is None else t.data_ptr()


def _check_bwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, grad,
               grad_name, grad_shape, states_dtype):
    b, h, n, c, g = _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada)
    dev = x_proj.device
    _check("states", states, (b, h, g, c), dev, states_dtype)
    _check("m", m, (b, h, g), dev)
    _check("s", s, (b, h, g), dev)
    _check(grad_name, grad, grad_shape(b, h, n, c, g), dev, x_proj.dtype)
    return b, h, n, c, g


def _bwd_launch(lib, kernel, geom, tensors, shape, win0, wend, flags,
                base_temp, epsilon, stream):
    """One launch of a float32 backward kernel in ``kernel``'s mode (the
    fast one over the windows ``[win0, wend)``, ``geom.sweep`` in a sweep,
    with the chain's launch ``flags``, or the generic one); ``tensors`` are
    ``(x, g_out, Ws, bs, Wa, ba, bmat, tsum, m, s, part, dx, q)``, None
    where the mode reads none."""
    bh, n, c, g = shape
    ptrs = [_ptr(t) for t in tensors]
    tail = (base_temp, _shift(epsilon), geom.smem)
    if geom.route == "fast":
        status = lib.haet_slice_bwd(
            BWD_MODES[kernel], geom.sweep, *ptrs, bh, n, c, g,
            geom.per_cloud, geom.span, win0, wend, flags, *tail, stream)
    else:
        status = lib.haet_slice_bwd_generic_f32(
            BWD_MODES[kernel], *ptrs, bh, n, c, g, geom.per_cloud, geom.span,
            *tail, stream)
    _build.check(lib, status, kernel)


#: where ``sum_partials`` puts its sums (``SUM_PARAMS``, ``SUM_STATES`` in
#: the CUDA source): a chain's parameter gradients, or a first pass's sums
#: (and dstates)
SUM_MODES = {"params": 1, "states": 2}


def _sum_partials(lib, part, batches: int, parts: int, stream, mode, outs,
                  shape):
    """``part [batches, parts, len]`` summed over ``parts`` in a fixed
    order into ``outs`` (see ``SumOut`` in the CUDA source: the second a
    dstates, if not None); ``shape`` is ``(c, g, dbs column, row stride,
    bh, slices per window)``."""
    length = part.numel() // (batches * parts)
    status = lib.haet_sum_partials(
        part.data_ptr(), *(_ptr(o) for o in outs), batches, parts, length,
        SUM_MODES[mode], *shape, stream)
    _build.check(lib, status, "sum_partials")


def _part_layout(kernel, geom, c, g):
    """``(windows, row stride, slices per window, dbs column)`` of a
    launch's partial sums: per window of :data:`BWD_WINDOW` slices and CM
    channels (fast), or one window of all ``g`` slices (generic)."""
    if geom.route == "fast":
        cm = fast_widths(c, g)[0]
        return geom.groups, bwd_row(cm, kernel), BWD_WINDOW, cm
    return 1, c + (2 if _is_first_pass(kernel) else 1), g, c


def _first_pass_sums(lib, kernel, tensors, shape, base_temp, epsilon, stream,
                     dstates=None):
    """A first pass (its windows or groups as grid z) and the sum of its
    partials: ``tsum [windows * bh, slices * row stride]``, each slice's
    row holding dstates (or unused columns), t and ``sum_n w``; dstates
    also in its own layout if given, divided by its slice's ``sum_n w``
    (the chains' normalisation). ``tensors``: ``(x, g_out, Ws, bs, Wa,
    ba, bmat, m, s)``, float32, ``g_out`` None for slice_states."""
    bh, n, c, g = shape
    dev = tensors[0].device
    geom = launch_geometry(kernel, bh, n, c, g, sm_count(dev))
    windows, rw, wr, col = _part_layout(kernel, geom, c, g)
    f32 = dict(device=dev, dtype=torch.float32)
    part = torch.empty((windows * bh, geom.per_cloud, wr * rw), **f32)
    _bwd_launch(lib, kernel, geom,
                (*tensors[:7], None, *tensors[7:], part, None, None),
                shape, 0, windows, 0, base_temp, epsilon, stream)
    tsum = torch.empty((windows * bh, wr * rw), **f32)
    _sum_partials(lib, part, windows * bh, geom.per_cloud, stream, "states",
                  (tsum, dstates, None, None), (c, g, col, rw, bh, wr))
    return tsum


def _chain_grads(lib, kernel, tensors, tsum, shape, base_temp, epsilon,
                 stream):
    """A chain pass (``tensors`` as for :func:`_first_pass_sums`, ``tsum``
    its sums) and the sum of its partials: ``(dx, dWs, dbs, dWa, dba)``.
    The fast kernel runs one launch per sweep of windows of slices, the
    generic one a loop over its groups in each block; both add each
    sweep's or group's dx and its rows' ``sum_g dlogit * logit`` to the
    earlier ones'."""
    bh, n, c, g = shape
    x_proj = tensors[0]
    dev = x_proj.device
    geom = launch_geometry(kernel, bh, n, c, g, sm_count(dev))
    windows, rw, wr, col = _part_layout(kernel, geom, c, g)
    f32 = dict(device=dev, dtype=torch.float32)
    part = torch.empty((windows, bh * geom.per_cloud, wr * rw + col + 1),
                       **f32)
    dx = torch.empty_like(x_proj)
    sweeps = [(w, min(windows, w + geom.sweep))
              for w in range(0, windows, geom.sweep)]
    q = (torch.empty(bh * n, **f32)
         if len(sweeps) > 1 or (geom.route != "fast" and geom.groups > 1)
         else None)
    # the sweeps' dx sums meet in dx itself
    ptrs = (*tensors[:7], tsum, *tensors[7:], part, dx, q)
    for i, (w0, w1) in enumerate(sweeps):
        flags = (1 if i == 0 else 0) | (2 if i == len(sweeps) - 1 else 0)
        _bwd_launch(lib, kernel, geom, ptrs, shape, w0, w1, flags, base_temp,
                    epsilon, stream)
    dws, dbs = torch.empty((c, g), **f32), torch.empty(g, **f32)
    dwa, dba = torch.empty((c, 1), **f32), torch.empty(1, **f32)
    _sum_partials(lib, part, windows, bh * geom.per_cloud, stream, "params",
                  (dws, dbs, dwa, dba), (c, g, col, rw, bh, wr))
    return dx, dws, dbs, dwa, dba


#: resident blocks per SM of each fused backward instantiation, by
#: ``(device index, kernel, CM)``
_PER_SM: dict = {}


def fused_blocks(lib, device, kernel: str, c: int) -> int:
    """Blocks per SM of the fused backward ``kernel`` that the card keeps
    resident at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at
    its shared memory, from ``haet_slice_bwd_per_sm``), cached: the
    persistent grid holds at most this times the SMs."""
    cm = fast_widths(c, 1)[0]
    key = (device.index, kernel, cm)
    per_sm = _PER_SM.get(key)
    if per_sm is None:
        out = ctypes.c_int(0)
        status = lib.haet_slice_bwd_per_sm(
            int(kernel == "deslice_bwd"), c, fused_smem(cm, kernel),
            ctypes.byref(out))
        _build.check(lib, status, f"{kernel} occupancy")
        if out.value < 1:
            raise RuntimeError(f"{kernel}: no block of the fused kernel fits "
                               f"an SM")
        per_sm = _PER_SM[key] = out.value
    return per_sm


def _fused_bwd(lib, kernel, tensors, shape, base_temp, epsilon, stream,
               dstates=None):
    """A backward on ``slice_bwd_fused`` (bf16, C <= 32, any G): one
    launch. ``tensors``: ``(x, g_out, Ws, bs, Wa, ba, bmat, m, s)``,
    ``g_out`` None for slice_states; x, g_out, bmat and dstates bf16.
    Returns ``(dx, dWs, dbs, dWa, dba)``."""
    bh, n, c, g = shape
    x_proj = tensors[0]
    dev = x_proj.device
    geom = fused_geometry(kernel, bh, n, c, g, sm_count(dev),
                          fused_blocks(lib, dev, kernel, c))
    cm = fast_widths(c, g)[0]
    windows = geom.groups
    sizes = bwd_partials(cm, bh, geom.per_cloud, windows)[:4]
    nq = bh * n if windows > 1 else 0
    f32 = dict(device=dev, dtype=torch.float32)
    # one scratch: part1, tsum, part2, cpart, then q (windows > 1)
    parts = list(torch.empty(sum(sizes) + nq, **f32).split([*sizes, nq]))
    q = parts.pop() if nq else None
    dx = torch.empty_like(x_proj)
    # the windows' dx sums meet in float32, past one window
    dacc = (torch.empty_like(dx, dtype=torch.float32) if windows > 1
            else None)
    dws, dbs = torch.empty((c, g), **f32), torch.empty(g, **f32)
    dwa, dba = torch.empty((c, 1), **f32), torch.empty(1, **f32)
    stream_ptr = stream.value
    bar = _counter(dev, stream_ptr, 3 + 2 * bh, "slice_bwd_fused")
    ptrs = (*tensors, *parts[:4], dstates, dx, dacc, q, dws, dbs, dwa, dba,
            bar)
    status = lib.haet_slice_bwd_fused(
        int(kernel == "deslice_bwd"), *(_ptr(t) for t in ptrs), bh, n, c, g,
        geom.per_cloud, geom.span, geom.blocks, base_temp, _shift(epsilon),
        geom.smem, stream)
    _build.check(lib, status, kernel)
    return dx, dws, dbs, dwa, dba


def _fused_route(x_proj, c: int, g: int) -> bool:
    """Whether a backward takes ``slice_bwd_fused`` (bf16 at C <= 32) or the
    per-pass kernels (float32 ``slice_bwd_f32``, or ``slice_bwd_generic``
    for wider heads, bf16 widened)."""
    return x_proj.dtype == torch.bfloat16 and fast_widths(c, g) is not None


def _slice_states_bwd_kernel(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                             m, s, g_states, base_temp, epsilon):
    """:func:`slice_states_bwd` on the card: one fused launch (bf16, C <=
    32), or the first pass (``t = sum_n w (x G^)`` and ``sum_n w``) and the
    sum of its partials, then the chain and the sum of its partials."""
    b, h, n, c, g = _check_bwd(x_proj, w_slice, b_slice, w_ada, b_ada,
                               states, m, s, g_states, "g_states",
                               lambda b, h, n, c, g: (b, h, g, c),
                               torch.float32)
    lib, stream, shape = _lib(), _stream(x_proj.device), (b * h, n, c, g)
    kind = "slice_states_bwd"
    if _fused_route(x_proj, c, g):
        tensors = (x_proj, None, w_slice, b_slice, w_ada, b_ada, g_states,
                   m, s)
        dx, *grads = _fused_bwd(lib, kind, tensors, shape, base_temp,
                                epsilon, stream)
    else:
        tensors = (x_proj.float(), None, w_slice, b_slice, w_ada, b_ada,
                   g_states.float(), m, s)
        tsum = _first_pass_sums(lib, kind + "_sums", tensors, shape,
                                base_temp, epsilon, stream)
        dx, *grads = _chain_grads(lib, kind, tensors, tsum, shape, base_temp,
                                  epsilon, stream)
    SLICE_STATES_BWD_LAUNCHES.add()
    return (dx.to(x_proj.dtype), *grads)


def _deslice_bwd_kernel(x_proj, w_slice, b_slice, w_ada, b_ada, states, m,
                        s, g_out, base_temp, epsilon):
    """:func:`deslice_bwd` on the card: one fused launch (bf16, C <= 32),
    or the first pass (``t``, ``sum_n w`` and ``dL/dstates``) and the sum
    of its partials, then the chain and the sum of its partials."""
    b, h, n, c, g = _check_bwd(x_proj, w_slice, b_slice, w_ada, b_ada,
                               states, m, s, g_out, "g_out",
                               lambda b, h, n, c, g: (b, h, n, c),
                               x_proj.dtype)
    lib, stream, shape = _lib(), _stream(x_proj.device), (b * h, n, c, g)
    kind = "deslice_bwd"
    if _fused_route(x_proj, c, g):
        dstates = torch.empty_like(states)
        tensors = (x_proj, g_out, w_slice, b_slice, w_ada, b_ada, states, m,
                   s)
        dx, *grads = _fused_bwd(lib, kind, tensors, shape, base_temp,
                                epsilon, stream, dstates)
    else:
        dstates = torch.empty(states.shape, device=states.device,
                              dtype=torch.float32)
        tensors = (x_proj.float(), g_out.float(), w_slice, b_slice, w_ada,
                   b_ada, states.float(), m, s)
        tsum = _first_pass_sums(lib, kind + "_sums", tensors, shape,
                                base_temp, epsilon, stream, dstates)
        dx, *grads = _chain_grads(lib, kind, tensors, tsum, shape, base_temp,
                                  epsilon, stream)
    DESLICE_BWD_LAUNCHES.add()
    return (dx.to(x_proj.dtype), *grads, dstates.to(states.dtype))


def _lib() -> ctypes.CDLL:
    return typed(_build.load("slice_kernels"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the nine entry points
    set (once)."""
    if not getattr(lib, "_haet_typed", False):
        lib.haet_slice_states.argtypes = (
            [_P] * 13 + [_I] * 6 + [_F, _F, _I, _I, _P])
        lib.haet_deslice.argtypes = (
            [_P] * 10 + [_I] * 7 + [_F, _F, _I, _I, _P])
        lib.haet_slice_states_generic_f32.argtypes = (
            [_P] * 11 + [_I] * 5 + [_F, _F, _P])
        lib.haet_deslice_generic_f32.argtypes = (
            [_P] * 9 + [_I] * 4 + [_F, _F, _P])
        lib.haet_slice_bwd_fused.argtypes = (
            [_I] + [_P] * 22 + [_I] * 7 + [_F, _F, _I, _P])
        lib.haet_slice_bwd_per_sm.argtypes = (
            [_I] * 3 + [ctypes.POINTER(ctypes.c_int)])
        lib.haet_slice_bwd.argtypes = (
            [_I, _I] + [_P] * 13 + [_I] * 9 + [_F, _F, _I, _P])
        lib.haet_slice_bwd_generic_f32.argtypes = (
            [_I] + [_P] * 13 + [_I] * 6 + [_F, _F, _I, _P])
        lib.haet_sum_partials.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        for fn in (lib.haet_slice_states, lib.haet_deslice,
                   lib.haet_slice_states_generic_f32,
                   lib.haet_deslice_generic_f32, lib.haet_slice_bwd_fused,
                   lib.haet_slice_bwd_per_sm, lib.haet_slice_bwd,
                   lib.haet_slice_bwd_generic_f32, lib.haet_sum_partials):
            fn.restype = _I
        lib._haet_typed = True
    return lib
