"""PyTorch port, slice ops and slice kernels vs the JAX package.

The same numpy inputs go through ``haet_tpu`` (the Pallas kernels in
interpret mode, and ``slice_ops``) and through ``haet_torch`` on the CPU,
where the kernel wrappers run their plain versions. N = 100 is not a
multiple of any tile or chunk. Tolerances are those of
``tests/test_pallas_slice.py`` (rtol 2e-4, atol 2e-5): float32 with sums in
another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.ops import slice_ops as tso
from haet_torch.ops.kernels import launch_counts, reset_launch_counts
from haet_torch.ops.kernels import slice_kernels as tsk
from haet_tpu.ops import slice_ops as jso
from haet_tpu.ops.pallas import slice_kernels as jsk

B, H, N, C, G = 1, 2, 100, 16, 8
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    jsk.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET = False
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(0)
    return dict(
        x=rng.randn(B, H, N, C).astype(np.float32),
        ws=rng.randn(C, G).astype(np.float32),
        bs=rng.randn(G).astype(np.float32),
        wa=rng.randn(C, 1).astype(np.float32),
        ba=rng.randn(1).astype(np.float32),
        st=rng.randn(B, H, G, C).astype(np.float32),
    )


def _t(d, *keys):
    return [torch.from_numpy(d[k]) for k in keys]


def _j(d, *keys):
    return [jnp.asarray(d[k]) for k in keys]


def _close(got, want, rtol=RTOL, atol=ATOL, name=None):
    got, want = np.asarray(got), np.asarray(want)
    if name:  # shown with `pytest -s`: the measured parity error
        print(f"PARITY {name}: max_abs_err {np.abs(got - want).max():.3e} "
              f"max|ref| {np.abs(want).max():.3e}")
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_slice_states_matches_pallas(data):
    st_j, m_j, s_j = jsk._slice_states_impl(*_j(data, "x", "ws", "bs", "wa",
                                                "ba"), 0.5, 1e-6, 32)
    st_t, m_t, s_t = tsk.slice_states(*_t(data, "x", "ws", "bs", "wa", "ba"))
    _close(st_t, st_j, name="slice_states states")
    _close(m_t, m_j, rtol=1e-5, atol=1e-6, name="slice_states m")
    _close(s_t, s_j, atol=1e-5, name="slice_states s")


def test_deslice_matches_pallas(data):
    xs = ("x", "ws", "bs", "wa", "ba")
    _, m_j, s_j = jsk._slice_states_impl(*_j(data, *xs), 0.5, 1e-6, 32)
    out_j = jsk._deslice_impl(*_j(data, *xs), jnp.asarray(data["st"]), m_j,
                              s_j, 0.5, 1e-6, 32)
    _, m_t, s_t = tsk.slice_states(*_t(data, *xs))
    out_t = tsk.deslice(*_t(data, *xs), torch.from_numpy(data["st"]), m_t,
                        s_t)
    _close(out_t, out_j, name="deslice out")


def test_slice_ops_match_jax(data):
    x, ws, bs, wa, ba, st = _t(data, "x", "ws", "bs", "wa", "ba", "st")
    xj, wsj, bsj, waj, baj, stj = _j(data, "x", "ws", "bs", "wa", "ba", "st")
    tau_t = tso.ada_temp(x @ wa + ba, 0.5)
    tau_j = jso.ada_temp(xj @ waj + baj, 0.5)
    _close(tau_t, tau_j)
    w_t = tso.rep_slice_weights(x @ ws + bs, tau_t, 1e-6)
    w_j = jso.rep_slice_weights(xj @ wsj + bsj, tau_j, 1e-6)
    _close(w_t, w_j)
    np.testing.assert_allclose(w_t.sum(dim=2).numpy(), 1.0, rtol=1e-5)
    _close(tso.eidetic_states(x, w_t), jso.eidetic_states(xj, w_j))
    _close(tso.deslice(st, w_t), jso.deslice(stj, w_j))
    merged = tso.merge_heads(x)
    _close(merged, jso.merge_heads(xj), rtol=0, atol=0)
    _close(tso.split_heads(merged, H), x, rtol=0, atol=0)


def test_fused_equals_unfused_composition(data):
    """The kernels' contract: states == eidetic_states up to the (1 + 1e-5)
    vs (sum w + 1e-5) norm, and deslice == slice_ops.deslice with the same
    weights."""
    x, ws, bs, wa, ba, st = _t(data, "x", "ws", "bs", "wa", "ba", "st")
    tau = tso.ada_temp(x @ wa + ba, 0.5)
    w = tso.rep_slice_weights(x @ ws + bs, tau, 1e-6)
    states, m, s = tsk.slice_states(x, ws, bs, wa, ba)
    _close(states, tso.eidetic_states(x, w))
    shift = math.log(-math.log(1e-6))
    z = ((x @ ws + bs) - shift) / tau
    _close(m, z.amax(dim=2), rtol=1e-5, atol=1e-6)
    _close(s, torch.exp(z - z.amax(dim=2, keepdim=True)).sum(dim=2),
           atol=1e-5)
    _close(tsk.deslice(x, ws, bs, wa, ba, st, m, s), tso.deslice(st, w))


def test_cpu_wrappers_launch_nothing(data):
    """On CPU tensors the wrappers run the plain versions: no launch."""
    reset_launch_counts()
    xs = _t(data, "x", "ws", "bs", "wa", "ba")
    states, m, s = tsk.slice_states(*xs)
    tsk.deslice(*xs, states, m, s)
    assert launch_counts()["slice_states"] == 0
    assert launch_counts()["deslice"] == 0


def test_wrappers_refuse_other_devices(data):
    xs = [t.to("meta") for t in _t(data, "x", "ws", "bs", "wa", "ba")]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tsk.slice_states(*xs)
    m = torch.empty(B, H, G, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tsk.deslice(*xs, torch.empty(B, H, G, C, device="meta"), m, m)


def test_all_minus_inf_column_guard():
    """A column whose logits are all -inf keeps finite states (the Pallas
    guards at slice_kernels.py:99-104 and :115)."""
    x = torch.zeros(1, 1, 4, 2)
    x[..., 0] = torch.tensor([1.0, 2.0, 3.0, 4.0])
    ws = torch.tensor([[float("-inf"), 1.0], [0.0, 0.0]])
    bs = torch.zeros(2)
    wa = torch.zeros(2, 1)
    ba = torch.zeros(1)
    states, m, s = tsk.slice_states(x, ws, bs, wa, ba)
    assert torch.isfinite(states[..., 1, :]).all()
    assert torch.isfinite(tsk.deslice(x, ws, bs, wa, ba, states, m, s)).all()
