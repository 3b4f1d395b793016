"""PyTorch port, the slice backward kernels' partition, merge order and
routes.

The backward kernels (``slice_bwd_fast``, ``slice_bwd_generic`` and
``sum_partials`` in ``haet_torch/csrc/slice_kernels.cu``) run only on the
card; what surrounds them is Python and is checked here:

* their launch geometry (:func:`launch_geometry` with the kinds
  "slice_states_bwd_sums", "slice_states_bwd", "deslice_bwd_sums" and
  "deslice_bwd") covers every row of every cloud once, at ragged N and
  several blocks per cloud, and their shared memory fits the SM;
* a torch model of the kernels' arithmetic in their partition and order
  (each backward's first pass sums ``t`` and ``S = sum_n w``, its chain
  takes ``w / S`` and ``t / S``; the slices in windows of 32 (fast) or
  groups of ``generic_bwd_plan`` (generic); a block's partial over its
  rows, per warp in warp order (fast); ``sum_partials`` adding the
  partials as 8 warps each take a contiguous eighth, then the warps in
  order; the windows' dx and ``sum_g dlogit * logit`` added in window
  order, draw applied by the last) equals ``*_bwd_plain`` and
  ``jax.vjp`` of ``haet_tpu``'s ``slice_states``/``deslice`` (Pallas in
  interpret mode) within 1e-4 of each gradient's max (float32 with sums
  in another order; the bias gradients against their weight's max, as
  ``test_torch_grads.py`` holds them: their per-point terms cancel), at
  G 32 / C 32, G 64 / C 16, G 128 / C 32 and, generic, G 20 / C 160;
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
#: (B, H, N, C, G, SMs): the presets' widths, G 128 and a generic width
#: of two groups, small N, a card of few SMs so that each cloud takes
#: several blocks and ragged last tiles
CASES = [(1, 2, 600, 32, 32, 8), (1, 2, 500, 16, 64, 8),
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


def _coverage(geom, n):
    hits = np.zeros(n, np.int64)
    for _, _, row0, rows in tsk.warp_tiles(geom, n):
        assert 0 < rows <= tsk.TILE_ROWS
        hits[row0:row0 + rows] += 1
    return hits


@pytest.mark.parametrize("bh,n,c,g", [
    (8, 32768, 32, 32), (8, 32186, 16, 64), (16, 4096, 32, 64),
    (8, 3001, 32, 128), (8, 1, 32, 32), (8, 257, 13, 20),
    (2, 600, 32, 32), (8, 1001, 32, 600), (8, 3001, 128, 32),
    (8, 1001, 128, 128), (8, 301, 2048, 3), (4, 300, 700, 40)])
def test_bwd_geometry_covers_every_row_once(bh, n, c, g):
    """Every backward launch covers each row of a cloud once (the fast
    kernels in whole warp tiles per block), one wave of blocks (grid z:
    the first passes' windows or groups of slices), with shared memory
    that fits the SM; the generic kernel's groups keep their accumulators
    in registers and take at least one row per tile."""
    for kind in BWD_KINDS:
        geom = tsk.launch_geometry(kind, bh, n, c, g, H100_SMS)
        assert ((geom.per_cloud - 1) * geom.span < n
                <= geom.per_cloud * geom.span)
        z = geom.groups if kind.endswith("_sums") else 1
        assert geom.per_cloud * bh * z <= max(H100_SMS, bh * z)
        assert geom.smem + 1024 <= SM_SMEM
        assert geom.groups == -(-g // geom.slices)
        if c <= 32:
            assert geom.route == "fast" and geom.slices == tsk.BWD_WINDOW
            assert (_coverage(geom, n) == 1).all()
            assert geom.span % (tsk.WARPS * tsk.TILE_ROWS) == 0
            continue
        gsz, tile = tsk.generic_bwd_plan(c, g)
        assert geom.route == "generic" and geom.slices == gsz
        assert gsz * c <= tsk.NT * tsk.MAX_ACC and c <= tsk.NT * tsk.MAX_ACC
        assert 1 <= tile <= tsk.GENERIC_TILE


def test_car_step_backward_shape():
    """At the car's training batch each backward launch gives each of the
    8 clouds 16 blocks of 2048 rows, one window of slices: each backward's
    first pass and chain, each followed by one sum."""
    for kind in BWD_KINDS:
        geom = tsk.launch_geometry(kind, 8, 32768, 32, 32, H100_SMS)
        assert (geom.per_cloud, geom.span, geom.groups) == (16, 2048, 1)


def _rows_by_warp(geom, n):
    """``{(block, warp): row indices}`` of one cloud, in the warp's order."""
    rows = {}
    for blk, warp, row0, count in tsk.warp_tiles(geom, n):
        rows.setdefault((blk, warp), []).extend(range(row0, row0 + count))
    return rows


def _in_order(terms):
    """The sum of ``terms`` taken left to right."""
    acc = torch.zeros_like(terms[0])
    for t in terms:
        acc = acc + t
    return acc


def _partial_sums(geom, n, per_row):
    """``per_row [BH, N, ...]`` summed into the blocks' partials as the
    kernels sum it -> ``[BH, per_cloud, ...]``: fast, each warp over its
    rows, a block's warps in warp order; generic, a block over its rows."""
    if geom.route == "generic":
        return torch.stack([per_row[:, b * geom.span:(b + 1) * geom.span]
                            .sum(dim=1) for b in range(geom.per_cloud)],
                           dim=1)
    rows = _rows_by_warp(geom, n)
    blocks = []
    for blk in range(geom.per_cloud):
        warps = [per_row[:, rows[(blk, w)]].sum(dim=1)
                 for w in range(tsk.WARPS) if (blk, w) in rows]
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


def _over_blocks(part):
    """A first pass's ``[BH, per_cloud, ...]`` partials merged per cloud."""
    return torch.stack([_merge(list(cloud)) for cloud in part])


def _model_bwd(kind, x, ws, bs, wa, ba, states, m, s, grad, sms):
    """``slice_states_bwd`` or ``deslice_bwd`` computed in the kernels'
    partition and order (per-row terms in float32, then the sums as
    :func:`_partial_sums` and :func:`_merge`, and the windows or groups as
    the chain takes them)."""
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
    # the first pass: per window or group (grid z), per block; sum_partials
    # merges a cloud's blocks; the chain takes w / S and t / S, S = sum_n w
    # (1 up to the logits' rounding)
    geom1 = tsk.launch_geometry(kind + "_sums", bh, n, c, g, sms)
    norm = _over_blocks(_partial_sums(geom1, n, w))
    t = _over_blocks(_partial_sums(geom1, n, w * dwo)) / norm
    if side is None:
        out["dstates"] = _over_blocks(_partial_sums(
            geom1, n, w[..., None] * go[:, :, None]))
    w = w / norm[:, None]
    dwt = dwo - t[:, None]
    geom = tsk.launch_geometry(kind, bh, n, c, g, sms)
    dl = w * dwt
    dpre = dl * it
    dx = torch.zeros_like(xf)
    q = torch.zeros(bh, n, 1)
    dws, dbs = [], []
    for w0 in range(0, g, geom.slices):  # windows or groups, in order
        win = slice(w0, w0 + geom.slices)
        dx = dx + dpre[..., win] @ ws[:, win].t()
        if side is not None:
            dx = dx + w[..., win] @ side[:, win]
        q = q + (dl[..., win] * lg[..., win]).sum(dim=-1, keepdim=True)
        part = _partial_sums(geom, n, xf[..., None] * dpre[:, :, None, win])
        dws.append(_merge(list(part.reshape(bh * geom.per_cloud, c, -1))))
        dbs.append(_merge(list(_partial_sums(
            geom, n, dpre[..., win]).reshape(bh * geom.per_cloud, -1))))
    inside = (raw > -0.4) & (raw < 0.4)
    draw = torch.where(inside, -q * it, torch.zeros_like(q))
    dx = dx + draw @ wa.t()
    dwa = _merge(list(_partial_sums(geom, n, xf * draw).reshape(
        bh * geom.per_cloud, c)))
    dba = _merge(list(_partial_sums(geom, n, draw).reshape(
        bh * geom.per_cloud, 1)))
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
    args = [jnp.asarray(d[k]) for k in ("x", "ws", "bs", "wa", "ba")]
    (_, m, s), vjp = jax.vjp(lambda *a: jsk.slice_states(*a, 0.5, 1e-6,
                                                         128), *args)
    ss = vjp((jnp.asarray(d["g_states"]), jnp.zeros_like(m),
              jnp.zeros_like(s)))
    _, vjp = jax.vjp(lambda *a: jsk.deslice(*a, m, s, 0.5, 1e-6, 128),
                     *args, jnp.asarray(d["st"]))
    ds = vjp(jnp.asarray(d["g_out"]))
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
    for kind, grad, plain_fn, jax_grads in (
            ("slice_states_bwd", t["g_states"], tsk.slice_states_bwd_plain,
             jax_ss),
            ("deslice_bwd", t["g_out"], tsk.deslice_bwd_plain, jax_ds)):
        st_arg = states if kind == "slice_states_bwd" else t["st"]
        got = _model_bwd(kind, *fwd, st_arg, m, s, grad, sms)
        plain = dict(zip(NAMES, plain_fn(*fwd, st_arg, m, s, grad)))
        jax_ref = dict(zip(NAMES, jax_grads))
        _close(f"{kind} G {g} C {c}", got, {"plain": plain, "jax": jax_ref})


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
    """The wrapper's mirrors of the backward kernels' window, buffer and
    partial sizes and of the generic kernels' limits are the source's."""
    src = SRC.read_text()
    for name, value in (("BW", tsk.BWD_WINDOW), ("MAX_ACC", tsk.MAX_ACC),
                        ("MAX_OUT", tsk.MAX_OUT), ("NT", tsk.NT),
                        ("TILE", tsk.GENERIC_TILE)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int MAX_GENERIC_C = NT * MAX_ACC;" in src
    assert tsk.MAX_GENERIC_C == tsk.NT * tsk.MAX_ACC == 2048
    assert re.search(rf"constexpr size_t MAX_SMEM = {tsk.MAX_SMEM};", src)
    assert "constexpr int BUF_STRIDE = BW + 4;" in src
    modes = {k: int(v) for k, v in re.findall(r"(BWD_\w+) = (\d)", src)}
    assert {k: modes[k] for k in ("BWD_STATES", "BWD_SUMS", "BWD_CHAIN",
                                  "BWD_STATES_SUMS")} == {
        "BWD_STATES": 0, "BWD_SUMS": 1, "BWD_CHAIN": 2, "BWD_STATES_SUMS": 3}
    assert tsk.BWD_MODES == {"slice_states_bwd": 0, "deslice_bwd_sums": 1,
                             "deslice_bwd": 2, "slice_states_bwd_sums": 3}
    # the car's launches: 109,696 / 126,080 / 183,424 / 191,616 B of
    # shared memory
    assert [tsk.bwd_smem(32, k) for k in BWD_KINDS] == [109696, 126080,
                                                        183424, 191616]
    for kind in ("slice_states_bwd_sums", "deslice_bwd_sums"):
        assert tsk.bwd_part_floats(32, kind) == 32 * 34
    for kind in ("slice_states_bwd", "deslice_bwd"):
        assert tsk.bwd_part_floats(32, kind) == 32 * 33 + 33
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
        nbytes, flops = slice_bench.work(kind, *shape)
        assert abs(nbytes / 1e6 - mb) < 0.1  # the [B, H, N, C] tensors
        us, by = slice_bench.bound_us(kind, shape)
        assert by == "bytes" and abs(us - bound) < 0.1
        assert round(3 * flops / slice_bench.TF32_FLOP_PER_S * 1e6, 1) == tf32
        us, by = slice_bench.bound_us(kind, shape, float32_only=True)
        assert by == "operations" and round(us, 1) == f32
    assert set(slice_bench.KINDS) == {"slice_states", "deslice",
                                      "slice_states_bwd", "deslice_bwd"}
