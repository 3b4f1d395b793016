"""PyTorch port, the slice kernels' launch geometry and merge order.

The CUDA kernels (``haet_torch/csrc/slice_kernels.cu``) run only on the
card; what surrounds them is Python and is checked here:

* :func:`launch_geometry` covers every point of a cloud exactly once, at
  ragged N, and fills at most one wave of the card with each kernel;
* the fast and generic routes together take every shape the old gate
  took (``G*C <= 2048``), the fast one every width with C <= 32, and the
  kernels' shared memory fits the SM; the wrapper refuses only heads wider
  than the generic kernels take;
* a plain model of the fast slice_states' partition and merge (each warp's
  online softmax over its own tiles, the block's warps merged by
  log-sum-exp in warp order, the cloud's blocks in block order) matches
  ``slice_states_plain`` and the JAX kernel in interpret mode within 1e-5
  of each output's max (float32 sums taken in another order);
* the constants the wrapper mirrors agree with the CUDA source;
* the phases driver's builds are switches of the CUDA source, and the
  benchmark's bounds and medians are what it prints;
* the kernels' 3xTF32 tensor-core products, emulated in numpy (operands
  read as the tensor core reads TF32, products exact), meet the 1e-4
  tolerance at car-like logits, and one-pass TF32 does not;
* the generic deslice's float32 dot products, emulated in numpy, meet the
  float64 check of ``chip_smoke.py`` at logits past 100 with the kernel's
  four FMA chains, and one chain does not.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.benchmarks import slice_kernels as slice_bench
from haet_torch.benchmarks import slice_phases
from haet_torch.ops.kernels import slice_kernels as tsk
from haet_tpu.ops.pallas import slice_kernels as jsk

SRC = Path(tsk.__file__).resolve().parents[2] / "csrc" / "slice_kernels.cu"
H100_SMS = 132
#: dynamic shared memory a block can use, and an SM's (less 1 KB per block
#: the runtime keeps)
BLOCK_SMEM, SM_SMEM = 232448, 233472
#: the widest G*C the slice kernels took before their gate was lifted
OLD_GATE = 2048


def _coverage(geom, n):
    hits = np.zeros(n, np.int64)
    for _, _, row0, rows in tsk.warp_tiles(geom, n):
        assert 0 < rows <= tsk.TILE_ROWS
        hits[row0:row0 + rows] += 1
    return hits


@pytest.mark.parametrize("bh,n,c,g", [
    (8, 1, 32, 32), (8, 255, 32, 32), (8, 256, 32, 32), (8, 257, 32, 32),
    (8, 32186, 32, 32), (32, 32186, 32, 32), (8, 32768, 32, 32),
    (8, 1 << 20, 32, 32), (1, 5000, 32, 32), (300, 700, 32, 32),
    (16, 4096, 32, 64), (8, 3001, 32, 40), (8, 3001, 32, 128),
    (8, 3001, 16, 128), (8, 1001, 32, 600)])
def test_geometry_covers_every_point_once(bh, n, c, g):
    for kernel in ("slice_states", "deslice"):
        geom = tsk.launch_geometry(kernel, bh, n, c, g, H100_SMS)
        assert geom.route == "fast"
        assert (_coverage(geom, n) == 1).all()
        block_rows = tsk.WARPS * tsk.TILE_ROWS
        assert geom.span % block_rows == 0
        assert ((geom.per_cloud - 1) * geom.span < n
                <= geom.per_cloud * geom.span)
        # one wave: one block per SM
        blocks = geom.per_cloud * bh * geom.groups
        assert blocks <= max(H100_SMS, bh * geom.groups)


def test_car_shapes_fill_the_card():
    """At serve batch 1 and the training batch (B*H = 8) each cloud gets 16
    blocks of 2048 rows; the burst's 32 clouds get 4 blocks of 8192. At
    the NS preset's G 64 / C 32 slice_states splits the slices in two
    groups of blocks, deslice keeps them in one block."""
    for kernel in ("slice_states", "deslice"):
        for n in (32186, 32768):
            geom = tsk.launch_geometry(kernel, 8, n, 32, 32, H100_SMS)
            assert (geom.per_cloud, geom.span, geom.groups) == (16, 2048, 1)
        geom = tsk.launch_geometry(kernel, 32, 32186, 32, 32, H100_SMS)
        assert (geom.per_cloud, geom.span) == (4, 8192)
    geom = tsk.launch_geometry("slice_states", 16, 4096, 32, 64, H100_SMS)
    assert (geom.per_cloud, geom.span, geom.groups) == (4, 1024, 2)
    geom = tsk.launch_geometry("deslice", 16, 4096, 32, 64, H100_SMS)
    assert (geom.per_cloud, geom.span, geom.groups) == (8, 512, 1)


def test_every_shape_of_the_old_gate_is_taken():
    """Every (C, G) with G*C <= 2048 takes a route; the fast one exactly
    at C <= 32, with shared memory that fits the SM, slice groups of the
    slices a lane's registers hold, and one deslice launch; the generic
    one for wider heads, one block per CHUNK points (slice_states) or per
    ``dtile`` rows (deslice)."""
    fast = 0
    for c in range(1, OLD_GATE + 1):
        for g in range(1, OLD_GATE // c + 1):
            widths = tsk.fast_widths(c, g)
            assert (widths is not None) == (c <= 32), (c, g)
            for kernel in ("slice_states", "deslice"):
                geom = tsk.launch_geometry(kernel, 8, 32186, c, g, H100_SMS)
                assert (geom.route == "fast") == (widths is not None)
                assert geom.smem + 1024 <= SM_SMEM, (c, g, geom.smem)
                if widths is None:
                    rows = (tsk.CHUNK if kernel == "slice_states"
                            else tsk.generic_plan(c, g)[1])
                    assert geom.per_cloud == -(-32186 // rows)
                    continue
                cm, gl = widths
                assert c <= cm and g <= 32 * gl
                held = tsk.register_slices(cm, gl)
                assert cm * held <= 32 * 32 and held in (32, 64)
                want = -(-g // held) if kernel == "slice_states" else 1
                assert geom.groups == want
            fast += widths is not None
    assert fast == sum(OLD_GATE // c for c in range(1, 33))
    # every preset's widths take the tensor-core kernels: G 32 at C 16 and
    # 32, G 64 at C 16 and (the NS preset) C 32
    assert all(tsk.fast_widths(c, g) is not None for c, g in
               ((16, 32), (32, 32), (16, 64), (32, 64)))


def test_wrapper_refuses_wider_than_the_gate():
    """The gate is the generic kernels' widest head (C 2048, the widest of
    the old G*C <= 2048 gate), not a G*C product: G*C 4096 at C 64 passes
    the wrapper's checks, C 2049 raises."""
    def meta(c, g):
        return [torch.empty(sh, device="meta") for sh in
                ((1, 1, 4, c), (c, g), (g,), (c, 1), (1,))]
    assert tsk._check_inputs(*meta(64, 64)) == (1, 1, 4, 64, 64)
    with pytest.raises(ValueError, match="take C <= 2048"):
        tsk._check_inputs(*meta(tsk.MAX_GENERIC_C + 1, 4))


def test_constants_match_the_cuda_source():
    src = SRC.read_text()
    for name, value in (("WARPS", tsk.WARPS), ("TR", tsk.TILE_ROWS),
                        ("STAGES", tsk.STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    cases = re.search(r"#define HAET_FAST_CASES\(X\) \\\n(.*)", src)
    got = {tuple(map(int, m)) for m in re.findall(r"X\((\d+), (\d+)\)",
                                                  cases.group(1))}
    want = {(w[0], tsk.register_slices(*w)) for c in range(1, 65)
            for g in range(1, 200) if (w := tsk.fast_widths(c, g))}
    assert got == want
    # deslice's: (CM, held slices, staged slices when 32 or 64, else 0)
    cases = re.search(r"#define HAET_DESLICE_CASES\(X\)(.*?)\n\n", src,
                      re.S)
    got = {tuple(map(int, m)) for m in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", cases.group(1))}
    want = set()
    for c in range(1, 33):
        for g in range(1, 700, 7):
            cm, gl = tsk.fast_widths(c, g)
            gp = tsk.deslice_slices(cm, g)
            want.add((cm, tsk.register_slices(cm, gl),
                      gp if gp in (32, 64) else 0))
    assert got == want


def _partitioned_states(x, ws, bs, wa, ba, sms):
    """The fast slice_states' arithmetic in its own partition and order:
    per warp an online softmax tile by tile, then the warps of a block and
    the blocks of a cloud merged by log-sum-exp with the Pallas guards."""
    b, h, n, c = x.shape
    g = ws.shape[1]
    geom = tsk.launch_geometry("slice_states", b * h, n, c, g, sms)
    z = tsk._logits(x, ws, bs, wa, ba, 0.5, 1e-6).reshape(b * h, n, g)
    xf = x.reshape(b * h, n, c)

    def empty():
        return (torch.full((b * h, g), -math.inf), torch.zeros(b * h, g),
                torch.zeros(b * h, g, c))

    def merge(parts):
        mx = torch.stack([p[0] for p in parts]).amax(dim=0)
        ms = tsk._m_safe(mx)
        s, acc = torch.zeros_like(ms), torch.zeros(b * h, g, c)
        for m_p, s_p, a_p in parts:  # in order
            sc = torch.where(torch.isfinite(m_p), torch.exp(m_p - ms),
                             torch.zeros_like(ms))
            s = s + s_p * sc
            acc = acc + a_p * sc[..., None]
        return mx, s, acc

    warps = {}
    for blk, warp, row0, rows in tsk.warp_tiles(geom, n):
        zt, xt = z[:, row0:row0 + rows], xf[:, row0:row0 + rows]
        e_max = zt.amax(dim=1)
        e = torch.exp(zt - tsk._m_safe(e_max)[:, None])
        tile = (e_max, e.sum(dim=1), torch.einsum("bng,bnc->bgc", e, xt))
        state = warps.get((blk, warp), empty())
        warps[(blk, warp)] = merge([state, tile])
    blocks = [merge([warps.get((blk, w), empty())
                     for w in range(tsk.WARPS)])
              for blk in range(geom.per_cloud)]
    m, s, acc = merge(blocks)
    states = acc / tsk._denom(s)[..., None] / (1 + 1e-5)
    return (states.reshape(b, h, g, c), m.reshape(b, h, g),
            s.reshape(b, h, g)), geom


@pytest.mark.parametrize("n,c,g,sms", [(1000, 16, 8, 4), (2900, 32, 32, 8),
                                       (257, 12, 40, 4), (1500, 32, 64, 8)])
def test_partition_and_merge_match_plain_and_jax(n, c, g, sms):
    rng = np.random.RandomState(n)
    x = rng.randn(1, 2, n, c).astype(np.float32)
    ws = (0.3 * rng.randn(c, g)).astype(np.float32)
    bs = (0.1 * rng.randn(g)).astype(np.float32)
    wa = (0.1 * rng.randn(c, 1)).astype(np.float32)
    ba = np.zeros(1, np.float32)
    args = [torch.from_numpy(a) for a in (x, ws, bs, wa, ba)]
    got, geom = _partitioned_states(*args, sms)
    assert geom.per_cloud > 1  # several blocks and warps, ragged last tile
    plain = tsk.slice_states_plain(*args)
    jsk.INTERPRET = True
    try:
        jax_out = jsk._slice_states_impl(
            *(jnp.asarray(a) for a in (x, ws, bs, wa, ba)), 0.5, 1e-6, 512)
    finally:
        jsk.INTERPRET = False
    for name, a, p, j in zip(("states", "m", "s"), got, plain, jax_out):
        a = a.numpy()
        for ref in (p.numpy(), np.asarray(j)):
            err = np.abs(a - ref).max()
            assert err <= 1e-5 * np.abs(ref).max(), (name, err)


def _tf32(a, round_half=True):
    """float32 as the tensor core reads a TF32 operand: the top 19 bits of
    the register, after the kernels' half-ulp add (0x1000) that makes the
    truncation a rounding, or truncated as it stands."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    if round_half:
        u = u + 0x1000
    return (u & 0xffffe000).astype(np.uint32).view(np.float32)


def _tensor_core_mm(a, b, passes):
    """``a @ b`` as the kernels' mma.sync computes it: one pass of rounded
    TF32 operands, or 3xTF32 (lo*hi + hi*lo + hi*hi, with ``hi`` the
    rounded operand and ``lo = a - hi`` truncated by the tensor core);
    products and sums in float64, so only the operands' rounding shows."""
    f64 = lambda u, v: u.astype(np.float64) @ v.astype(np.float64)  # noqa
    if passes == 1:
        return f64(_tf32(a), _tf32(b))
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo = _tf32(a - a_hi, round_half=False)
    b_lo = _tf32(b - b_hi, round_half=False)
    return f64(a_lo, b_hi) + f64(a_hi, b_lo) + f64(a_hi, b_hi)


@pytest.mark.parametrize("output", ["states", "out"])
def test_3xtf32_meets_the_tolerance_and_one_pass_does_not(output):
    """Both products of each kernel (the logits x Ws, then E^T x or
    W states) through the emulated tensor cores, at the car's widths and
    ``chip_smoke.py``'s weight scales (logits up to ~55), against float64:
    3xTF32 stays within 1e-5 of max |output|, one-pass TF32 misses 1e-4."""
    rng = np.random.RandomState(0)
    n, c, g = 4096, 32, 32
    x = rng.randn(n, c).astype(np.float32)
    ws = (0.3 * rng.randn(c, g)).astype(np.float32)
    bs = (0.1 * rng.randn(g)).astype(np.float32)
    wa = (0.1 * rng.randn(c, 1)).astype(np.float32)
    st = rng.randn(g, c).astype(np.float32)
    shift = math.log(-math.log(1e-6))
    tau = 0.5 + np.clip(x.astype(np.float64) @ wa, -0.4, 0.4)

    def run(passes):
        mm = (lambda a, b: a.astype(np.float64) @ b) if passes == 0 else \
            (lambda a, b: _tensor_core_mm(a, b, passes))
        z = (mm(x, ws) + bs - shift) / tau
        e = np.exp(z - z.max(axis=0))
        if output == "states":
            return mm(e.T.astype(np.float32), x) / e.sum(axis=0)[:, None]
        w = (e / e.sum(axis=0)).astype(np.float32)
        return mm(w, st)

    want = run(0)
    scale = np.abs(want).max()
    assert np.abs(run(3) - want).max() <= 1e-5 * scale
    assert np.abs(run(1) - want).max() > 1e-4 * scale


def _fma_dot(x, w, chains):
    """``x @ w`` as the generic kernels' ``dot4`` computes it in float32:
    ``chains`` interleaved FMA chains over the channels (each FMA rounded
    once), summed in pairs."""
    parts = [np.zeros((x.shape[0], w.shape[1]), np.float32)
             for _ in range(chains)]
    for k in range(x.shape[1]):
        p = parts[k % chains].astype(np.float64)
        parts[k % chains] = (x[:, k:k + 1].astype(np.float64) * w[k:k + 1]
                             + p).astype(np.float32)
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _emulated_error(chains, x, ws, bs, wa, ba, st, m, s, ref):
    """The largest distance from ``ref`` of the generic deslice emulated
    in numpy with ``chains`` FMA chains per dot product."""
    shift = np.float32(math.log(-math.log(1e-6)))
    worst = 0.0
    for cloud in range(x.shape[1]):
        xc, stc = x[0, cloud].numpy(), st[0, cloud].numpy()
        raw = _fma_dot(xc, wa.numpy(), chains)[:, 0]
        tau = np.float32(0.5) + np.clip(raw, np.float32(-0.4),
                                        np.float32(0.4))
        z = (_fma_dot(xc, ws.numpy(), chains) + bs.numpy() - shift)
        z = z / tau[:, None]
        w = np.exp(z - m[0, cloud].numpy()) / s[0, cloud].numpy()
        out = _fma_dot(w.astype(np.float32), stc, 1)
        worst = max(worst, np.abs(out - ref[0, cloud].numpy()).max())
    return worst


@pytest.mark.parametrize("chains,within", [(1, False), (4, True)])
def test_generic_deslice_at_unscaled_weights(chains, within):
    """``chip_smoke.py:SLICE_UNSCALED`` (C 128, G 16, weights unscaled:
    temperatures at 0.1, logits past 100) holds the generic deslice to a
    float64 reference within 1e-4 of max |out|. Its arithmetic emulated in
    numpy (logits and tau from float32 FMA chains, then exp / s and the
    product over G in one chain): one chain per dot product misses that,
    the kernel's four chains meet it.

    The plain float32 version's logits come from the host BLAS, whose
    order of summation differs between CPUs (1.277e-4 of max |out| on an
    AMD EPYC, below 1e-4 on others): it is held to what float32 gives in
    any order, no further from float64 than one sequential FMA chain per
    dot product (the one-chain emulation)."""
    import chip_smoke

    tag, shape, index = chip_smoke.SLICE_UNSCALED
    x, ws, bs, wa, ba, st = slice_bench.inputs(
        shape, torch.device("cpu"), chip_smoke.SEED + 10 + index,
        scaled=False)
    _, m, s = tsk.slice_states_plain(x, ws, bs, wa, ba)
    plain = tsk.deslice_plain(x, ws, bs, wa, ba, st, m, s)
    _, ref = chip_smoke.slice_f64(x, ws, bs, wa, ba, st, m, s)
    args = (x, ws, bs, wa, ba, st, m, s, ref)
    worst = _emulated_error(chains, *args)
    sequential = worst if chains == 1 else _emulated_error(1, *args)
    scale = float(ref.abs().max())
    assert float((plain.double() - ref).abs().max()) <= sequential
    assert (worst <= 1e-4 * scale) == within, worst / scale


def test_phases_builds_are_switches_of_the_source():
    """``benchmarks/slice_phases.py`` builds ``csrc/slice_kernels.cu`` with
    the source's own switches: each define it passes guards code there,
    the trace records both fast kernels in the layout the driver reads,
    and the regular build has neither switch."""
    src = SRC.read_text()
    for defines in slice_phases.VARIANTS.values():
        for d in defines:
            assert f"#ifdef {d}" in src, d
    assert re.search(rf"constexpr int TRACE_CTAS = "
                     rf"{slice_phases.TRACE_CTAS};", src)
    assert slice_phases.TRACE_WARPS == tsk.WARPS
    assert "g_trace[2][TRACE_CTAS][WARPS][4]" in src
    assert len(re.findall(r"HAET_TRACE\(trace_record\((\d)", src)) == 2
    assert "int haet_trace_read(" in src
    assert not any(f in " ".join(slice_phases._build.NVCC_FLAGS)
                   for f in ("HAET_SLICE_TRACE", "HAET_SLICE_NO_MMA"))


def test_benchmark_bounds_and_medians():
    """The bounds ``benchmarks/slice_kernels.py`` prints beside each time:
    at serve batch 1 both kernels are bound by bytes (their operations in
    3xTF32 on the tensor cores take less), and at the float32 FMA rate
    alone slice_states would be bound by operations (16 us against 9.85);
    the A/B medians take every run of a side."""
    shape = slice_bench.SHAPES["serve_b1"]
    states, by = slice_bench.bound_us("slice_states", shape)
    assert by == "bytes" and 9.8 < states < 9.9
    f32, f32_by = slice_bench.bound_us("slice_states", shape,
                                       float32_only=True)
    assert f32_by == "operations" and 15.9 < f32 < 16.1
    deslice, by = slice_bench.bound_us("deslice", shape)
    assert by == "bytes" and 19.6 < deslice < 19.8
    assert slice_bench.bound_us("deslice", shape, float32_only=True) == (
        deslice, by)
    runs = [{"t": {"slice_states": {"us": u}, "deslice": {"us": 2 * u}}}
            for u in (3.0, 1.0, 2.0)]
    assert slice_bench.medians(runs) == {"t": {"slice_states": 2.0,
                                               "deslice": 4.0}}
    with pytest.raises(SystemExit, match="no CUDA device"):
        slice_bench.measure(Path("."), 1)


def test_benchmark_bounds_in_bf16():
    """The bf16 bounds at the training batch: the bytes of a bf16 ``x``
    halve, and each product takes the tensor-core passes its operand types
    need (a bf16 operand's 3xTF32 low part is zero: two passes; two bf16
    operands: one bf16 pass at twice the TF32 rate), so slice_states_bwd,
    with a float32 product of its own (``dpre Ws^T``), is the one bound by
    operations; the FLOP are the float32 kernels' either way."""
    shape = slice_bench.SHAPES["train_b1"]
    assert slice_bench.tf32_passes(0, 4) == slice_bench.tf32_passes(2, 4) \
        == slice_bench.TF32_PASSES == 3
    assert [slice_bench.tf32_passes(k, 2) for k in (0, 1, 2)] == [3, 2, 0.5]
    want = {"slice_states": (5.02, "bytes"), "deslice": (10.02, "bytes"),
            "slice_states_bwd": (10.54, "operations"),
            "deslice_bwd": (15.04, "bytes")}
    for kind, (us, by) in want.items():
        got = slice_bench.bound_us(kind, shape, isz=2)
        assert got[1] == by and abs(got[0] - us) < 0.01, (kind, got)
        f32 = slice_bench.work(kind, *shape)
        low = slice_bench.work(kind, *shape, isz=2)
        assert low[1] == f32[1] and low[2] < f32[2] == 3 * f32[1]
        assert slice_bench.bound_us(kind, shape)[0] > got[0]
