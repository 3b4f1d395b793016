"""The fused Erwin block's shape gate and per-CTA layouts, by arithmetic.

``haet_torch.ops.kernels.erwin_block.eligible`` must admit every shape the
earlier one-CTA-per-cloud kernel admitted (its own shared-memory formula,
kept here as the oracle) and nothing the JAX gate refuses; both kernels'
layouts must fit a CTA's 227 KB of shared memory for every admitted shape.
No kernel runs and nothing is compiled. Also the plumbing of the two
Erwin kernel drivers that only run on the card.
"""

import pytest

from haet_torch.benchmarks import erwin_kernels, erwin_phases
from haet_torch.ops.kernels import erwin_block as teb
from haet_tpu.ops.pallas import erwin_block as jeb

D = 3


def one_cta_gate(n: int, c: int, heads: int, hidden: int) -> bool:
    """The one-CTA-per-cloud kernel's gate: its shared memory,
    4 n (6C + hidden + 2D + 6) bytes, within 227 KB."""
    return (c % heads == 0 and (n & (n - 1)) == 0
            and 4 * n * (6 * c + hidden + 2 * D + 6) <= teb.MAX_SMEM_BYTES)


@pytest.mark.parametrize("ratio", [2, 4])
@pytest.mark.parametrize("heads", [4, 8])
@pytest.mark.parametrize("c", [16, 24, 32, 48, 64, 96, 128])
def test_gate_and_layouts(c, heads, ratio):
    hidden = ratio * c
    for n in (1 << i for i in range(10)):
        admitted = teb.eligible(n, c, heads, c, hidden, D)
        if one_cta_gate(n, c, heads, hidden):
            assert admitted, (n, c, heads, hidden)
        if not jeb.eligible(n, c, heads, c):
            assert not admitted, (n, c, heads, hidden)
        if not admitted:
            continue
        for bs in sorted({min(n, 16), min(n, 32), n}):
            fwd = teb.fwd_layout(n, c, D, hidden, heads, bs)
            bwd = teb.bwd_layout(n, c, D, hidden, heads, bs)
            assert fwd.smem <= teb.MAX_SMEM_BYTES
            assert bwd.smem <= teb.MAX_SMEM_BYTES
            # what spills has a scratch, what fits has none
            for layout, buffers in ((fwd, teb.FWD_BUFFERS),
                                    (bwd, teb.BWD_BUFFERS)):
                flags = layout.ints[len(buffers):2 * len(buffers)]
                local_spill = any(not f for f, (_, kind) in
                                  zip(flags, buffers) if kind != "weight")
                assert (layout.scratch > 0) == local_spill
    assert not teb.eligible(1024, c, heads, c, hidden, D)


@pytest.mark.parametrize("n,c,hidden,heads,bs", [
    (32, 32, 128, 8, 32), (16, 64, 256, 8, 16),     # the car's two blocks
    (32, 32, 128, 4, 32),                           # the micro driver's
    (32, 32, 64, 4, 32), (16, 64, 128, 8, 16),      # bench_flags' two
])
def test_main_path_shapes_stay_in_shared_memory(n, c, hidden, heads, bs):
    """Every block shape the drivers and the car run keeps all of both
    kernels' buffers, weight slices included, in shared memory."""
    for layout, buffers in ((teb.fwd_layout(n, c, D, hidden, heads, bs),
                             teb.FWD_BUFFERS),
                            (teb.bwd_layout(n, c, D, hidden, heads, bs),
                             teb.BWD_BUFFERS)):
        assert layout.scratch == 0
        assert all(layout.ints[len(buffers):2 * len(buffers)])


@pytest.mark.parametrize("total", [1, 3, 7, 8, 12, 24, 100, 128])
def test_rank_shares_fit_their_buffers(total):
    """The kernels give rank r of K the items [total r / K, total (r+1) / K)
    (``erwin_block.cu:slice_of``); the buffers are sized for ceil(total /
    K), and the shares cover every item once."""
    k = teb.CLUSTER
    shares = [(total * r // k, total * (r + 1) // k) for r in range(k)]
    assert shares[0][0] == 0 and shares[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    assert max(hi - lo for lo, hi in shares) <= -(-total // k)


@pytest.mark.parametrize("tag", sorted(erwin_kernels.SHAPES))
def test_timed_shapes_take_the_kernel(tag):
    """Every block shape ``benchmarks/erwin_kernels.py`` times passes the
    gate, and its inputs have the shapes the wrappers check."""
    clouds, n, c, ball, heads, hidden = erwin_kernels.SHAPES[tag]
    assert teb.eligible(n, c, heads, c, hidden, D)
    x, pos, dout, params, kw = erwin_kernels._inputs(
        teb, "cpu", erwin_kernels.SHAPES[tag], 0)
    assert x.shape == dout.shape == (clouds, n, c)
    assert pos.shape == (clouds, n, D)
    shapes = teb.param_shapes(c, D, heads, hidden)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert kw == dict(ball_size=ball, num_heads=heads, use_dist_bias=True)


def test_phase_tracer_instruments_the_kernel_source():
    """``benchmarks/erwin_phases.py`` patches ``csrc/erwin_block.cu`` by
    text: every patch still finds its place (each raises if not)."""
    src = erwin_phases.instrumented_source()
    assert src.count("clock64()") == 3
    assert "haet_trace_read" in src
