"""PyTorch port, the slice backward kernels' partition, merge order and
routes.

The backward kernels (``slice_bwd_fused``, ``slice_bwd_f32``,
``slice_bwd_generic`` and ``sum_partials`` in
``haet_torch/csrc/slice_kernels.cu``) run only on the card; what surrounds
them is Python and is checked here:

* their launch geometry covers every row of every cloud once, at ragged N
  and several blocks per cloud, and their shared memory fits the SM: the
  per-pass kinds (:func:`launch_geometry`: "slice_states_bwd_sums",
  "slice_states_bwd", "deslice_bwd_sums" and "deslice_bwd", fast at C <=
  32, generic wider) in one wave of blocks (the float32 fast kernel's
  16 warps of 16-row tiles, two windows of slices a sweep where
  :func:`bwd_sweep` says so), and the fused kernel's
  "slice_states_bwd" and "deslice_bwd" (:func:`fused_geometry`, bf16 at C
  <= 32: one launch of a persistent grid) with no more blocks than the card
  keeps resident (the occupancy rule of :func:`fused_blocks`);
* a CUDA backward takes the fused kernel in bf16 at C <= 32 and the
  per-pass kernels otherwise (bf16 widened for the generic ones);
* a torch model of the kernels' arithmetic in their partition and order
  (each backward's first pass sums ``t`` and ``S = sum_n w``, its chain
  takes ``w / S`` and ``t / S``, and every route's dstates is divided
  by ``S``; the slices in windows of 32 (fast, fused)
  or groups of ``generic_bwd_plan`` (generic), the fast chain's windows in
  sweeps of :func:`bwd_sweep`; a block's or unit's partial
  over its rows, per warp in warp order (fused: each unit's first-pass sums
  merged per cloud in unit order, its chain partials, over the warps'
  tiles in reverse order, per cloud in unit order, then the clouds in
  cloud order; fast and generic: ``sum_partials`` adding the partials as 8
  warps each take a contiguous eighth, then the warps in order); the
  windows' dx and ``sum_g dlogit * logit`` added in window order within a
  sweep, draw applied by the last sweep before it adds the earlier sweeps'
  dx) equals ``*_bwd_plain`` and
  ``jax.vjp`` of ``haet_tpu``'s ``slice_states``/``deslice`` (Pallas in
  interpret mode) within 1e-4 of each gradient's max (float32 with sums
  in another order; the bias gradients against their weight's max, as
  ``test_torch_grads.py`` holds them: their per-point terms cancel), at
  G 32 / C 32, G 64 / C 16 (one sweep of both windows) and C 32 (a chain
  launch per window; the fused kernel's in one launch), G 96 / C 16 (a
  sweep of two windows, then one of one), G 128 / C 32 in both fast orders
  and, generic, G 20 / C 160;
* bf16 operands, exact in TF32, take the passes the fused kernel gives
  them (their 3xTF32 low parts are zero), emulated in numpy against
  float64;
* a CUDA backward takes its kernel at every width, and none routes to
  the plain version; the forwards' wrappers take every G*C the JAX
  kernels take;
* the constants and formulas the wrapper mirrors agree with the CUDA
  source, and the benchmark's bounds of the backwards are the ones
  ``PERF.md`` states.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.benchmarks import slice_kernels as slice_bench
from haet_torch.ops.kernels import plain_route_counts, reset_launch_counts
from haet_torch.ops.kernels import slice_kernels as tsk
from haet_tpu.ops.pallas import slice_kernels as jsk

SRC = Path(tsk.__file__).resolve().parents[2] / "csrc" / "slice_kernels.cu"
H100_SMS = 132
SM_SMEM = 233472
RTOL = 1e-4
NAMES = ("dx", "dWs", "dbs", "dWa", "dba", "dstates")
#: a bias gradient is held against its weight gradient's scale
SCALE_OF = {"dbs": "dWs", "dba": "dWa"}
BWD_KINDS = ("slice_states_bwd_sums", "slice_states_bwd", "deslice_bwd_sums",
             "deslice_bwd")
#: the fused kernel's kinds: a whole backward per launch
FUSED_KINDS = ("slice_states_bwd", "deslice_bwd")
#: (B, H, N, C, G, SMs): the presets' widths (G 64 at C 16, both windows
#: in one float32 sweep, and at C 32, a float32 chain launch per window;
#: the fused kernel's in one launch), G 96 at C 16 (a sweep of two windows
#: and one of one), G 128 and a generic width of two groups, small N, a
#: card of few SMs so that each cloud takes several blocks and ragged last
#: tiles
CASES = [(1, 2, 600, 32, 32, 8), (1, 2, 500, 16, 64, 8),
         (1, 2, 400, 32, 64, 8), (1, 2, 300, 16, 96, 8),
         (1, 2, 300, 32, 128, 8), (1, 2, 300, 160, 20, 8)]
#: warps of ``sum_partials``, each adding a contiguous range of partials
SUM_WARPS = 8


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    jsk.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET = False
    torch.set_num_threads(threads)


def _fused_units(geom, bh):
    """``{block: [(cloud, range), ...]}``: the units each block of a fused
    backward launch takes, in its order (unit ``u`` by block ``u %
    blocks``, as ``slice_bwd_fused`` loops)."""
    units = {}
    for u in range(bh * geom.per_cloud):
        units.setdefault(u % geom.blocks, []).append(
            divmod(u, geom.per_cloud))
    return units


def _coverage(geom, n, reverse=False):
    hits = np.zeros(n, np.int64)
    for _, _, row0, rows in tsk.warp_tiles(geom, n, reverse):
        assert 0 < rows <= geom.tile_rows
        hits[row0:row0 + rows] += 1
    return hits


@pytest.mark.parametrize("bh,n,c,g", [
    (8, 32768, 32, 32), (8, 32186, 16, 64), (16, 4096, 32, 64),
    (8, 3001, 32, 128), (8, 1, 32, 32), (8, 257, 13, 20),
    (2, 600, 32, 32), (8, 1001, 32, 600), (8, 3001, 128, 32),
    (8, 1001, 128, 128), (8, 301, 2048, 3), (4, 300, 700, 40)])
def test_bwd_geometry_covers_every_row_once(bh, n, c, g):
    """Every backward launch covers each row of a cloud once. The per-pass
    kinds: one wave of blocks (grid z: the first passes' sweeps of windows
    or groups of slices), the fast kernels in whole warp tiles per block,
    the sweeps as :func:`bwd_sweep` sets them; the generic
    kernel's groups keep their accumulators in registers and take at least
    one row per tile. The fused kernel (bf16, C <= 32): whole warp tiles
    per range, in the first pass's order and the chain's reverse one; every
    unit (cloud, range) taken by one block; at most the blocks the card
    keeps resident (``per_sm`` times the SMs, at one and two per SM), so
    every block is resident. Each one's shared memory fits the SM."""
    for kind in BWD_KINDS:
        geom = tsk.launch_geometry(kind, bh, n, c, g, H100_SMS)
        assert ((geom.per_cloud - 1) * geom.span < n
                <= geom.per_cloud * geom.span)
        z = (-(-geom.groups // geom.sweep) if kind.endswith("_sums")
             else 1)
        assert geom.per_cloud * bh * z <= max(H100_SMS, bh * z)
        assert geom.smem + 1024 <= SM_SMEM
        assert geom.groups == -(-g // geom.slices)
        if c <= 32:
            cm = tsk.fast_widths(c, g)[0]
            assert geom.route == "fast" and geom.slices == tsk.BWD_WINDOW
            assert geom.sweep == tsk.bwd_sweep(cm, kind, g)
            assert geom.sweep == 1 or (g > tsk.BWD_WINDOW and cm <= 16)
            assert geom.smem == tsk.bwd_smem(cm, kind, geom.sweep)
            assert (geom.warps, geom.tile_rows) == (tsk.BWD_WARPS,
                                                    tsk.BWD_TILE_ROWS)
            assert (_coverage(geom, n) == 1).all()
            assert geom.span % (geom.warps * geom.tile_rows) == 0
            continue
        gsz, tile = tsk.generic_bwd_plan(c, g)
        assert geom.route == "generic" and geom.slices == gsz
        assert gsz * c <= tsk.NT * tsk.MAX_ACC and c <= tsk.NT * tsk.MAX_ACC
        assert 1 <= tile <= tsk.GENERIC_TILE
    if c > 32:
        return
    for kind in FUSED_KINDS:
        for per_sm in (1, 2):
            geom = tsk.fused_geometry(kind, bh, n, c, g, H100_SMS, per_sm)
            assert ((geom.per_cloud - 1) * geom.span < n
                    <= geom.per_cloud * geom.span)
            assert geom.route == "fused" and geom.slices == tsk.BWD_WINDOW
            assert geom.groups == -(-g // geom.slices)
            assert geom.smem + 1024 <= SM_SMEM
            assert geom.smem == tsk.fused_smem(tsk.fast_widths(c, g)[0],
                                               kind)
            assert 1 <= geom.blocks <= per_sm * H100_SMS
            assert geom.blocks == min(bh * geom.per_cloud, per_sm * H100_SMS)
            units = _fused_units(geom, bh)
            assert sorted(units) == list(range(geom.blocks))
            taken = sorted(u for us in units.values() for u in us)
            assert taken == [(cl, r) for cl in range(bh)
                             for r in range(geom.per_cloud)]
            assert geom.span % (tsk.WARPS * tsk.TILE_ROWS) == 0
            for reverse in (False, True):
                assert (_coverage(geom, n, reverse) == 1).all()


def test_car_step_backward_shape():
    """At the car's training batch each per-pass launch gives each of the 8
    clouds 16 blocks of 2048 rows, one window of slices (float32: each
    backward's first pass and chain, each followed by one sum), and the
    fused backward (bf16) is one launch of 128 blocks (one per SM at one
    block per SM) over the same ranges. At the NS and Darcy presets' G 64,
    one fused launch takes both windows; in float32 the Darcy preset's (C
    16) slice_states first pass and both chains sweep both windows in one
    read of their rows, deslice's first pass takes them as grid z, and the
    NS preset's (C 32) take them as grid z and a chain launch per window."""
    for kind in BWD_KINDS:
        geom = tsk.launch_geometry(kind, 8, 32768, 32, 32, H100_SMS)
        assert (geom.per_cloud, geom.span, geom.groups) == (16, 2048, 1)
        assert (geom.sweep, geom.warps, geom.tile_rows) == (1, 16, 16)
    darcy = {k: tsk.launch_geometry(k, 32, 7225, 16, 64, H100_SMS)
             for k in BWD_KINDS}
    assert {k: (v.per_cloud, v.span, v.groups, v.sweep)
            for k, v in darcy.items()} == {
        "slice_states_bwd_sums": (4, 2048, 2, 2),
        "slice_states_bwd": (4, 2048, 2, 2),
        "deslice_bwd_sums": (2, 3840, 2, 1), "deslice_bwd": (4, 2048, 2, 2)}
    for kind in BWD_KINDS:
        geom = tsk.launch_geometry(kind, 16, 4096, 32, 64, H100_SMS)
        assert (geom.groups, geom.sweep) == (2, 1)
    for kind in FUSED_KINDS:
        geom = tsk.fused_geometry(kind, 8, 32768, 32, 32, H100_SMS, 1)
        assert (geom.per_cloud, geom.span, geom.groups, geom.blocks) == (
            16, 2048, 1, 128)
        geom = tsk.fused_geometry(kind, 16, 4096, 32, 64, H100_SMS, 1)
        assert (geom.per_cloud, geom.span, geom.groups, geom.blocks) == (
            8, 512, 2, 128)
        geom = tsk.fused_geometry(kind, 32, 7225, 16, 64, H100_SMS, 1)
        assert (geom.per_cloud, geom.span, geom.groups, geom.blocks) == (
            4, 2048, 2, 128)
        # more clouds than resident blocks: each block takes several units
        geom = tsk.fused_geometry(kind, 300, 700, 32, 32, H100_SMS, 1)
        assert (geom.per_cloud, geom.blocks) == (1, H100_SMS)
        assert max(len(u) for u in _fused_units(geom, 300).values()) == 3


def _rows_by_warp(geom, n, reverse=False):
    """``{(block, warp): row indices}`` of one cloud, in the warp's order
    (``block`` a range of ``span`` rows)."""
    rows = {}
    for blk, warp, row0, count in tsk.warp_tiles(geom, n, reverse):
        rows.setdefault((blk, warp), []).extend(range(row0, row0 + count))
    return rows


def _in_order(terms):
    """The sum of ``terms`` taken left to right."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _partial_sums(geom, n, per_row, reverse=False):
    """``per_row [BH, N, ...]`` summed into the ranges' partials as the
    kernels sum it -> ``[BH, per_cloud, ...]``: fast and fused, each warp
    over its rows (the fused chain takes them last first), a range's warps
    (``geom.warps``) in warp order; generic, a block over its rows."""
    if geom.route == "generic":
        return torch.stack([per_row[:, b * geom.span:(b + 1) * geom.span]
                            .sum(dim=1) for b in range(geom.per_cloud)],
                           dim=1)
    rows = _rows_by_warp(geom, n, reverse)
    blocks = []
    for blk in range(geom.per_cloud):
        warps = [per_row[:, rows[(blk, w)]].sum(dim=1)
                 for w in range(geom.warps) if (blk, w) in rows]
        blocks.append(_in_order(warps))
    return torch.stack(blocks, dim=1)


def _merge(parts):
    """The partials summed as ``sum_partials`` sums them: each of its
    :data:`SUM_WARPS` warps adds a contiguous range of ``ceil(P / 8)``
    partials in order, then the warps' sums are added in warp order."""
    per = -(-len(parts) // SUM_WARPS)
    ranges = [_in_order(parts[w * per:(w + 1) * per])
              for w in range(SUM_WARPS) if w * per < len(parts)]
    return _in_order(ranges)


def _over_blocks(part, fused):
    """A first pass's ``[BH, per_cloud, ...]`` partials merged per cloud:
    in unit order (fused, each block after the grid barrier) or as
    ``sum_partials`` merges them (generic)."""
    return torch.stack([_in_order(list(cloud)) if fused
                        else _merge(list(cloud)) for cloud in part])


def _over_all(part, fused):
    """A chain's ``[BH, per_cloud, ...]`` partials merged over every cloud:
    per cloud in unit order, then the clouds in cloud order (fused: the
    last unit of each cloud, then the last cloud), or as ``sum_partials``
    merges the flattened partials (generic)."""
    if fused:
        return _in_order([_in_order(list(cloud)) for cloud in part])
    return _merge(list(part.reshape(-1, *part.shape[2:])))


def _model_bwd(kind, x, ws, bs, wa, ba, states, m, s, grad, sms, fused):
    """``slice_states_bwd`` or ``deslice_bwd`` computed in the kernels'
    partition and order (per-row terms in float32, then the sums as
    :func:`_partial_sums`, :func:`_over_blocks` and :func:`_over_all`, and
    the windows or groups as the chain takes them: the fast chain's dx and
    ``sum_g dlogit * logit`` summed over the windows of a sweep, draw added
    by the last sweep, then the earlier sweeps' dx): the fused kernel's, or
    the per-pass kernels' (fast at C <= 32, else generic)."""
    b, h, n, c = x.shape
    g = ws.shape[1]
    bh = b * h
    xf = x.reshape(bh, n, c)
    st = states.reshape(bh, g, c)
    raw = xf @ wa + ba                                      # [BH, N, 1]
    it = 1.0 / (0.5 + raw.clamp(-0.4, 0.4))
    lg = (xf @ ws + bs - tsk._shift(1e-6)) * it             # [BH, N, G]
    w = (torch.exp(lg - tsk._m_safe(m.reshape(bh, g))[:, None])
         / tsk._denom(s.reshape(bh, g))[:, None])
    out = {}
    if kind == "slice_states_bwd":
        side = grad.reshape(bh, g, c) / tsk._NORM           # G^
        dwo = xf @ side.transpose(1, 2)
    else:
        go = grad.reshape(bh, n, c)
        dwo = go @ st.transpose(1, 2)
        side = None
    # the first pass: per window or group, per range; a cloud's ranges
    # merged; the chain takes w / S and t / S, S = sum_n w (1 up to the
    # logits' rounding)
    if fused:
        geom = geom1 = tsk.fused_geometry(kind, bh, n, c, g, sms, 1)
    else:
        geom = tsk.launch_geometry(kind, bh, n, c, g, sms)
        geom1 = tsk.launch_geometry(kind + "_sums", bh, n, c, g, sms)
    norm = _over_blocks(_partial_sums(geom1, n, w), fused)
    t = _over_blocks(_partial_sums(geom1, n, w * dwo), fused) / norm
    if side is None:  # dstates divided by S too, on every route
        ds = _over_blocks(_partial_sums(
            geom1, n, w[..., None] * go[:, :, None]), fused)
        out["dstates"] = ds / norm[..., None]
    w = w / norm[:, None]
    dwt = dwo - t[:, None]
    dl = w * dwt
    dpre = dl * it
    dx = torch.zeros_like(xf)
    q = torch.zeros(bh, n, 1)
    dws, dbs = [], []
    span = geom.slices * (1 if fused else geom.sweep)
    for s0 in range(0, g, span):  # sweeps (or windows, groups), in order
        dxs = torch.zeros_like(xf)
        for w0 in range(s0, min(g, s0 + span), geom.slices):
            win = slice(w0, w0 + geom.slices)
            dxs = dxs + dpre[..., win] @ ws[:, win].t()
            if side is not None:
                dxs = dxs + w[..., win] @ side[:, win]
            q = q + (dl[..., win] * lg[..., win]).sum(dim=-1, keepdim=True)
            dws.append(_over_all(_partial_sums(
                geom, n, xf[..., None] * dpre[:, :, None, win], fused),
                fused))
            dbs.append(_over_all(_partial_sums(geom, n, dpre[..., win],
                                               fused), fused))
        if s0 + span >= g:  # the last sweep applies draw
            inside = (raw > -0.4) & (raw < 0.4)
            draw = torch.where(inside, -q * it, torch.zeros_like(q))
            dxs = dxs + draw @ wa.t()
        dx = dxs + dx
    dwa = _over_all(_partial_sums(geom, n, xf * draw, fused), fused)
    dba = _over_all(_partial_sums(geom, n, draw, fused), fused)
    out.update(dx=dx.reshape(b, h, n, c), dWs=torch.cat(dws, dim=1),
               dbs=torch.cat(dbs), dWa=dwa[:, None], dba=dba)
    if "dstates" in out:
        out["dstates"] = out["dstates"].reshape(b, h, g, c)
    return out


def _inputs(b, h, n, c, g):
    rng = np.random.RandomState(n + c + g)
    return dict(
        x=rng.randn(b, h, n, c).astype(np.float32),
        ws=(0.3 * math.sqrt(32 / c) * rng.randn(c, g)).astype(np.float32),
        bs=(0.1 * rng.randn(g)).astype(np.float32),
        # raw Ada-Temp values on both sides of the +-0.4 clip
        wa=(0.3 * rng.randn(c, 1)).astype(np.float32),
        ba=(0.1 * rng.randn(1)).astype(np.float32),
        st=rng.randn(b, h, g, c).astype(np.float32),
        g_states=rng.randn(b, h, g, c).astype(np.float32),
        g_out=rng.randn(b, h, n, c).astype(np.float32))


def _jax_vjps(d):
    """``jax.vjp`` of the Pallas ``slice_states`` (cotangent on the states)
    and ``deslice`` (on its output, with the residuals of that forward),
    tile 128."""
    @jax.jit
    def vjps(args, g_states, st, g_out):
        (_, m, s), vjp = jax.vjp(lambda *a: jsk.slice_states(*a, 0.5, 1e-6,
                                                             128), *args)
        ss = vjp((g_states, jnp.zeros_like(m), jnp.zeros_like(s)))
        _, vjp = jax.vjp(lambda *a: jsk.deslice(*a, m, s, 0.5, 1e-6, 128),
                         *args, st)
        return ss, vjp(g_out)

    ss, ds = vjps([jnp.asarray(d[k]) for k in ("x", "ws", "bs", "wa", "ba")],
                  *(jnp.asarray(d[k]) for k in ("g_states", "st", "g_out")))
    return [np.asarray(v) for v in ss], [np.asarray(v) for v in ds]


def _close(tag, got, refs):
    for name, a in got.items():
        for label, ref in refs.items():
            want = np.asarray(ref[name], np.float64)
            scale = np.abs(np.asarray(ref[SCALE_OF.get(name, name)])).max()
            err = np.abs(np.asarray(a, np.float64) - want).max()
            print(f"PARITY {tag} {name} vs {label}: max_abs_err {err:.3e} "
                  f"scale {scale:.3e}")
            assert err <= RTOL * scale, (tag, name, label, err, scale)


@pytest.mark.parametrize("b,h,n,c,g,sms", CASES)
def test_partition_and_merge_match_plain_and_jax(b, h, n, c, g, sms):
    """Each side from its own forward's residuals: the backward of a
    softmax over N is ill-conditioned in residuals ``(m, s)`` computed with
    another rounding of the logits (at temperatures of 0.1 and logits near
    100, the plain float32 backward given JAX's residuals is 8.6e-4 of max
    |dx| from float64, given its own 8e-6)."""
    d = _inputs(b, h, n, c, g)
    jax_ss, jax_ds = _jax_vjps(d)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    fwd = (t["x"], t["ws"], t["bs"], t["wa"], t["ba"])
    states, m, s = tsk.slice_states_plain(*fwd)
    geom = tsk.launch_geometry("deslice_bwd", b * h, n, c, g, sms)
    assert geom.per_cloud > 1 and n % tsk.TILE_ROWS  # ragged, several
    assert geom.route == ("fast" if c <= 32 else "generic")
    assert c <= 32 or geom.groups > 1
    # the fused kernel: one launch, every unit its own block here
    assert c > 32 or tsk.fused_geometry("deslice_bwd", b * h, n, c, g, sms,
                                        1).blocks == b * h * geom.per_cloud
    for kind, grad, plain_fn, jax_grads in (
            ("slice_states_bwd", t["g_states"], tsk.slice_states_bwd_plain,
             jax_ss),
            ("deslice_bwd", t["g_out"], tsk.deslice_bwd_plain, jax_ds)):
        st_arg = states if kind == "slice_states_bwd" else t["st"]
        plain = dict(zip(NAMES, plain_fn(*fwd, st_arg, m, s, grad)))
        jax_ref = dict(zip(NAMES, jax_grads))
        for fused in ((False, True) if c <= 32 else (False,)):
            got = _model_bwd(kind, *fwd, st_arg, m, s, grad, sms, fused)
            _close(f"{kind} G {g} C {c} {'fused' if fused else geom.route}",
                   got, {"plain": plain, "jax": jax_ref})


def _tf32(a, round_half=True):
    """float32 as the tensor core reads a TF32 operand: the top 19 bits of
    the register, after the kernels' half-ulp add (0x1000), or truncated
    (a low part)."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    if round_half:
        u = u + 0x1000
    return (u & 0xffffe000).astype(np.uint32).view(np.float32)


def _passes_mm(a, b, a_lo, b_lo):
    """``a @ b`` as ``mma_p`` computes it: hi*hi, plus lo*hi where ``a``
    keeps a low part and hi*lo where ``b`` does; products and sums in
    float64, the result rounded to the float32 accumulator."""
    f64 = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = f64(a_hi, b_hi)
    if a_lo:
        out += f64(_tf32(a - a_hi, False), b_hi)
    if b_lo:
        out += f64(a_hi, _tf32(b - b_hi, False))
    return out.astype(np.float32)


def _bf16_chain(kind, x, side, go, ws, bs, wa, ba, mm):
    """dx and dWs of one cloud's backward, the fused kernel's two passes
    (the weights normalised by their own sum), each product through
    ``mm(a, b, name)``; float32 between the products."""
    f32 = np.float32
    raw = x @ wa + ba
    it = (1.0 / (0.5 + np.clip(raw, -0.4, 0.4))).astype(f32)
    lg = (mm(x, ws, "z") + bs - f32(tsk._shift(1e-6))) * it
    m = lg.max(axis=0)
    e = np.exp(lg - m)
    w = (e / e.sum(axis=0)).astype(f32)
    if kind == "slice_states_bwd":
        d = mm(x, side.T, "dw") / f32(tsk._NORM)
    else:
        d = mm(go, side.T, "dw")
    norm = w.sum(axis=0)
    t = (w * d).sum(axis=0) / norm
    w = w / norm
    dl = w * (d - t)
    dpre = (dl * it).astype(f32)
    q = (dl * lg).sum(axis=1, keepdims=True)
    draw = np.where((raw > -0.4) & (raw < 0.4), -q * it, 0).astype(f32)
    dx = mm(dpre, ws.T, "dx") + draw @ wa.T
    if kind == "slice_states_bwd":
        dx = dx + mm((w / f32(tsk._NORM)).astype(f32), side, "dxw")
    return dx, mm(x.T, dpre, "dws")


#: the passes the fused kernel gives each product of a bf16 call: (A keeps
#: a low part, B keeps one); x, g_out and the G-side matrix are exact
BF16_PASSES = {"z": (False, True), "dw": (False, False), "dx": (True, True),
               "dxw": (True, False), "dws": (False, True)}


@pytest.mark.parametrize("kind", ["slice_states_bwd", "deslice_bwd"])
def test_bf16_operands_take_fewer_passes(kind):
    """A bf16 ``x``, ``g_out`` and G-side matrix (the states, or their
    gradient) are exact in TF32: their 3xTF32 low parts are zero, so the
    passes the fused kernel drops for them (``BF16_PASSES``: the logits
    two, dw one, G^ w^T two, dWs two, of nine) change no bit of a product,
    and the bf16 chain through the tensor cores, emulated in numpy, gives
    dx and dWs within 1e-4 of their max of float64; dropping the low part
    of a float32 operand too (one pass each) misses that."""
    rng = np.random.RandomState(16)
    n, c, g = 2048, 32, 32
    def bf(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    x, side, go = (bf(rng.randn(*sh).astype(np.float32))
                   for sh in ((n, c), (g, c), (n, c)))
    ws = (0.3 * rng.randn(c, g)).astype(np.float32)
    bs = (0.1 * rng.randn(g)).astype(np.float32)
    wa = (0.1 * rng.randn(c, 1)).astype(np.float32)
    ba = np.zeros(1, np.float32)
    for v in (x, side, go):
        assert (_tf32(v) == v).all() and not (v.view(np.uint32) & 0x1fff).any()
    for a, b in ((x, ws), (x, side.T), (ws.T, x.T)):
        assert np.array_equal(_passes_mm(a, b, True, True),
                              _passes_mm(a, b, not (a is x), b is ws))
    args = (kind, x, side, go, ws, bs, wa, ba)
    want = _bf16_chain(*args, lambda a, b, _: (a.astype(np.float64)
                                               @ b.astype(np.float64)))
    got = _bf16_chain(*args, lambda a, b, k: _passes_mm(a, b,
                                                        *BF16_PASSES[k]))
    one = _bf16_chain(*args, lambda a, b, k: _passes_mm(a, b, False, False))
    for name, w64, g32, g1 in zip(("dx", "dWs"), want, got, one):
        scale = np.abs(w64).max()
        err = np.abs(g32 - w64).max()
        print(f"PARITY bf16 passes {kind} {name}: {err / scale:.3e} of max; "
              f"one pass {np.abs(g1 - w64).max() / scale:.3e}")
        assert err <= RTOL * scale
        assert np.abs(g1 - w64).max() > RTOL * scale


@pytest.mark.parametrize("dtype,c,route", [
    (torch.float32, 32, "fast"), (torch.bfloat16, 32, "fused"),
    (torch.bfloat16, 40, "generic"), (torch.float32, 16, "fast")])
def test_backward_route_by_dtype(monkeypatch, dtype, c, route):
    """On the card a backward at C <= 32 takes ``slice_bwd_fused`` in bf16
    and the per-pass kernels in float32 (each where it is the faster); wider
    heads take the per-pass generic kernels, bf16 widened to float32. The
    per-pass kernels get float32 tensors, the fused one bf16."""
    calls = []

    def fused(lib, kind, tensors, shape, *rest):
        calls.append(("fused", kind, tensors[0].dtype))
        return tensors[0], None, None, None, None

    def first(lib, kind, tensors, shape, *rest):
        calls.append(("first", kind, tensors[0].dtype))

    def chain(lib, kind, tensors, *rest):
        calls.append(("chain", kind, tensors[0].dtype))
        return tensors[0], None, None, None, None

    monkeypatch.setattr(tsk, "_lib", lambda: None)
    monkeypatch.setattr(tsk, "_stream", lambda dev: None)
    monkeypatch.setattr(tsk, "_fused_bwd", fused)
    monkeypatch.setattr(tsk, "_first_pass_sums", first)
    monkeypatch.setattr(tsk, "_chain_grads", chain)
    d = _inputs(1, 2, 40, c, 8)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    fwd = (t["x"].to(dtype), t["ws"], t["bs"], t["wa"], t["ba"])
    _, m, s = tsk.slice_states_plain(*fwd)
    dx, *_ = tsk._slice_states_bwd_kernel(
        *fwd, t["st"], m, s, t["g_states"].to(dtype), 0.5, 1e-6)
    out = tsk._deslice_bwd_kernel(*fwd, t["st"].to(dtype), m, s,
                                  t["g_out"].to(dtype), 0.5, 1e-6)
    assert dx.dtype == dtype and out[0].dtype == dtype
    assert out[-1].dtype == dtype  # dstates in the states' dtype
    if route == "fused":
        assert calls == [("fused", "slice_states_bwd", torch.bfloat16),
                         ("fused", "deslice_bwd", torch.bfloat16)]
    else:
        assert calls == [(p, k + sfx, torch.float32)
                         for k in ("slice_states_bwd", "deslice_bwd")
                         for p, sfx in (("first", "_sums"), ("chain", ""))]
    assert (tsk.fast_widths(c, 8) is None) == (route == "generic")


def test_routes_and_their_counts(monkeypatch):
    """On a CUDA tensor (stood in for by patching the device test) a
    backward launches its kernels at C 32 (fast) and at C 40 and 2048
    (generic), never the plain version, and no plain route is counted."""
    launched = []
    monkeypatch.setattr(tsk, "_on_card", lambda x, what: True)
    monkeypatch.setattr(tsk, "_slice_states_bwd_kernel",
                        lambda *a: launched.append("slice_states_bwd"))
    monkeypatch.setattr(tsk, "_deslice_bwd_kernel",
                        lambda *a: launched.append("deslice_bwd"))
    monkeypatch.setattr(tsk, "slice_states_bwd_plain", None)
    monkeypatch.setattr(tsk, "deslice_bwd_plain", None)
    reset_launch_counts()
    for c in (32, 40, 2048):
        d = _inputs(1, 1, 40, c, 8)
        t = {k: torch.from_numpy(v) for k, v in d.items()}
        fwd = (t["x"], t["ws"], t["bs"], t["wa"], t["ba"])
        st, m, s = tsk.slice_states_plain(*fwd)
        tsk.slice_states_bwd(*fwd, st, m, s, t["g_states"])
        tsk.deslice_bwd(*fwd, t["st"], m, s, t["g_out"])
    assert launched == ["slice_states_bwd", "deslice_bwd"] * 3
    assert not any(plain_route_counts().values())
    assert set(plain_route_counts()) == {"fused_erwin_block",
                                         "fused_erwin_block_bwd"}


@pytest.mark.parametrize("b,h,n,c,g", [
    (1, 8, 3001, 32, 128), (1, 8, 3001, 128, 32), (1, 8, 1001, 128, 128),
    (1, 8, 1001, 32, 600), (2, 8, 300, 1024, 16), (1, 8, 500, 2048, 1),
    (1, 4, 300, 700, 40)])
def test_forwards_take_every_width(b, h, n, c, g):
    """Past the old G*C gate (2048) the forwards' wrapper checks pass and
    each launch covers every row once: the fast kernels at C <= 32 (any G,
    deslice in one launch that stages its slices in ranges that fit its
    shared memory), the generic ones up to C 2048 (groups of slices sized
    to registers and shared memory; wide heads in fewer rows per tile)."""
    meta = [torch.empty(sh, device="meta") for sh in
            ((b, h, n, c), (c, g), (g,), (c, 1), (1,))]
    assert tsk._check_inputs(*meta) == (b, h, n, c, g)
    for kind in ("slice_states", "deslice"):
        geom = tsk.launch_geometry(kind, b * h, n, c, g, H100_SMS)
        assert geom.smem + 1024 <= SM_SMEM
        if geom.route == "fast":
            assert (_coverage(geom, n) == 1).all()
            assert geom.groups * geom.slices >= g
            continue
        gs, dtile, gd = tsk.generic_plan(c, g)
        assert geom.per_cloud * geom.span >= n > (geom.per_cloud - 1) * \
            geom.span
        assert gs * c <= tsk.NT * tsk.MAX_ACC
        assert 1 <= tsk.generic_tile(c, gs) <= tsk.GENERIC_TILE
        assert dtile * c <= tsk.NT * tsk.MAX_OUT and 1 <= gd <= g
    ranges = tsk.launch_geometry("deslice", b * h, n, c, g, H100_SMS).groups
    assert ranges == (1 if c > 32 else -(-g // tsk.deslice_slices(c, g)))
    assert (ranges > 1) == (g == 600)  # 544 slices fit at once at C 32


def test_constants_and_formulas_match_the_cuda_source():
    """The wrapper's mirrors of the backward kernels' window, buffer,
    shared-memory and partial sizes, the float32 kernel's warps, tiles and
    instantiations (a sweep of two windows where :func:`bwd_sweep` takes
    one) and the fused kernel's launch, and the generic kernels' limits are
    the source's."""
    src = SRC.read_text()
    for name, value in (("BW", tsk.BWD_WINDOW), ("MAX_ACC", tsk.MAX_ACC),
                        ("MAX_OUT", tsk.MAX_OUT), ("NT", tsk.NT),
                        ("TILE", tsk.GENERIC_TILE), ("FW", tsk.BWD_WARPS),
                        ("FTR", tsk.BWD_TILE_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int MAX_GENERIC_C = NT * MAX_ACC;" in src
    assert tsk.MAX_GENERIC_C == tsk.NT * tsk.MAX_ACC == 2048
    assert re.search(rf"constexpr size_t MAX_SMEM = {tsk.MAX_SMEM};", src)
    assert "constexpr int BUF_STRIDE = BW + 4;" in src
    assert tsk.BUF_STRIDE == tsk.BWD_WINDOW + 4
    modes = {k: int(v) for k, v in re.findall(r"(BWD_\w+) = (\d)", src)}
    assert {k: modes[k] for k in ("BWD_STATES", "BWD_SUMS", "BWD_CHAIN",
                                  "BWD_STATES_SUMS")} == {
        "BWD_STATES": 0, "BWD_SUMS": 1, "BWD_CHAIN": 2, "BWD_STATES_SUMS": 3}
    assert tsk.BWD_MODES == {"slice_states_bwd": 0, "deslice_bwd_sums": 1,
                             "deslice_bwd": 2, "slice_states_bwd_sums": 3}
    # bwd_fused_smem's terms, as bwd_smem mirrors them: the rings in T
    # (rows padded by 16 bytes), the merge over them, the tables (an exact
    # operand's high parts alone), four floats per slice, Wa, the buffers
    for line in (
            "return CM + 16 / static_cast<int>(sizeof(T));",
            "return BW * (CM + 2) + CM + 1;",
            "return exact ? 2 : 4;", "return exact ? 4 : 8;",
            "(CM / 8) * (BW / 8) * 32 * (tab_b_lane(false) + tab_b_lane(EX))",
            "(tab_a_lane(false) + (DESLICE ? 0 : tab_a_lane(EX)));",
            "constexpr int rings = (DESLICE ? 2 : 1) * "
            "bwd_ring_bytes<T, CM>();",
            "constexpr int merge = 4 * WARPS * bwd_merge_floats<CM>();",
            "WARPS * 16 * (BUF_STRIDE + 1));"):
        assert line in src, line
    # the car's launches: float32 per pass, 128,640 / 145,024 / 202,368 /
    # 210,560 B (bwd_smem_floats: rings of 16 warps' two 16-row slots, two
    # to four tables of hi and lo parts), the Darcy preset's sweeps of two
    # windows (C 16), and bf16 fused (slice_states_bwd, deslice_bwd)
    assert [tsk.bwd_smem(32, k) for k in BWD_KINDS] == [128640, 145024,
                                                        202368, 210560]
    assert [tsk.bwd_smem(16, k, 2) for k in BWD_KINDS] == [96320, 112704,
                                                           137280, 145472]
    assert all(tsk.bwd_smem(cm, k, tsk.bwd_sweep(cm, k, 64)) + 1024
               <= SM_SMEM for cm in (8, 16, 32) for k in BWD_KINDS)
    for kind in ("slice_states_bwd_sums", "deslice_bwd_sums"):
        assert tsk.bwd_part_floats(32, kind) == 32 * 34
    for kind in ("slice_states_bwd", "deslice_bwd"):
        assert tsk.bwd_part_floats(32, kind) == 32 * 33 + 33
    for line in ("return CM + (bwd_sums(MODE) ? 2 : 1);",
                 "return BW * bwd_row<CM, MODE>() + (bwd_sums(MODE) ? 0 : "
                 "CM + 1);",
                 "return FW * STAGES * FTR * row_stride<CM>();",
                 "return 2 + (MODE == BWD_STATES ? 2 : MODE == BWD_CHAIN ? "
                 "1 : 0);",
                 "return 32 * CM;",
                 "SW * (2 * bwd_tables<MODE>() * wg_table_floats<CM>() + 4 "
                 "* BW) +",
                 "CM + FW * FTR * (BUF_STRIDE + 1);"):
        assert line in src, line
    assert [tsk.fused_smem(32, k) for k in FUSED_KINDS] == [85120, 121984]
    assert [tsk.fused_smem(16, k) for k in FUSED_KINDS] == [56384, 78912]
    # the partial sums at the car's training batch and the NS preset's
    assert tsk.bwd_partials(32, 8, 16, 1) == (139264, 512, 139392, 8712,
                                             1089)
    assert tsk.bwd_partials(32, 16, 8, 2)[4] == 2 * 32 * 33 + 33
    # the fused kernel: one bf16 instantiation per fast width and kind
    cases = re.search(r"#define HAET_BWD_CASES\(X\)(.*?)\n\n", src, re.S)
    got = set(re.findall(r"X\((\d+), (\w+)\)", cases.group(1)))
    assert got == {(cm, d) for cm in ("8", "16", "32")
                   for d in ("false", "true")}
    assert "launch_bwd_fused<bf16, CM, D>" in src
    # the per-pass kernel: float32, every mode at every fast width in one
    # window a sweep, and in two wherever bwd_sweep takes two
    cases = re.search(r"#define HAET_BWD_F32_CASES\(X\)(.*?)\n\n", src, re.S)
    got = set(re.findall(r"X\((BWD_\w+), (\d+), (\d)\)", cases.group(1)))
    want = {(mode, str(cm), str(sw)) for kind, k in tsk.BWD_MODES.items()
            for mode in [m for m in ("BWD_STATES", "BWD_SUMS", "BWD_CHAIN",
                                     "BWD_STATES_SUMS") if modes[m] == k]
            for cm in (8, 16, 32)
            for sw in {1, tsk.bwd_sweep(cm, kind, 64),
                       tsk.bwd_sweep(cm, kind, 600)}}
    assert got == want
    assert "launch_bwd<CM, SW, MODE>(" in src
    assert "switch ((mode * 100 + cm) * 10 + sweep)" in src
    # the grid is sized from the resident blocks, and launched as a
    # cooperative grid, which the runtime refuses unless all are resident
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in src
    assert "attr[0].id = cudaLaunchAttributeCooperative;" in src
    assert "cudaLaunchKernelEx(&cfg, slice_bwd_fused<T, CM, DESLICE>, a)" \
        in src
    # slice_bwd_generic's shared memory, fixed and per row of a tile
    assert "return 2 * c * gsz + 4 * gsz + c;" in src
    assert "return 2 * c + 3 * gsz + 4;" in src
    assert tsk.generic_bwd_plan(128, 32) == (16, 32)
    assert tsk.generic_bwd_plan(2048, 3) == (1, 12)


def test_benchmark_bounds_of_the_backwards():
    """At the car's training batch the backwards are bound by bytes: 67.1
    MB (x, dx; the rest is 0.04 MB) in 20.0 us and 100.7 MB (x, g_out, dx)
    in 30.0 us; their
    products take 16.6 and 23.2 us in 3xTF32, 40.8 and 57.1 us in float32
    FMA."""
    shape = slice_bench.SHAPES["train_b1"]
    for kind, mb, bound, tf32, f32 in (
            ("slice_states_bwd", 67.1, 20.0, 16.6, 40.8),
            ("deslice_bwd", 100.7, 30.0, 23.2, 57.1)):
        nbytes, flops, tf32_flops = slice_bench.work(kind, *shape)
        assert abs(nbytes / 1e6 - mb) < 0.1  # the [B, H, N, C] tensors
        us, by = slice_bench.bound_us(kind, shape)
        assert by == "bytes" and abs(us - bound) < 0.1
        assert tf32_flops == 3 * flops
        assert round(tf32_flops / slice_bench.TF32_FLOP_PER_S * 1e6, 1) == tf32
        us, by = slice_bench.bound_us(kind, shape, float32_only=True)
        assert by == "operations" and round(us, 1) == f32
    assert set(slice_bench.KINDS) == {"slice_states", "deslice",
                                      "slice_states_bwd", "deslice_bwd"}
