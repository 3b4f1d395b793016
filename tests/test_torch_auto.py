"""PyTorch port, ``use_pallas="auto"`` against the JAX package's rule.

* The rule as a pure function of (N, G, threshold, device type)
  (:func:`haet_torch.models.physics_attention.pallas_auto_enabled`) at its
  edges: below and at the threshold, the G scaling and its floor at a
  quarter, the plain path on the CPU at every N.
* The rule's form is JAX's: on a grid of N and G, with the TPU's G span in
  place of the card's, the JAX module's ``_pallas_enabled`` under a TPU
  backend (``jax.default_backend`` stubbed; nothing runs) resolves as the
  port does for a CUDA input.
* A small auto model on the CPU takes the plain path above its threshold
  (no kernel wrapper called, equal bit for bit to ``use_pallas=False``) and
  matches JAX's auto model on the CPU, which is plain too, within 1e-5 of
  max |out|; the config's threshold reaches every attention module.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from haet_torch.models import HAETransolverIrregularMesh
from haet_torch.models import physics_attention as tpa
from haet_torch.utils import config as tcfg
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JIrr
from haet_tpu.models import physics_attention as jpa
from test_torch_model import init_like

T = tcfg.PALLAS_AUTO_THRESHOLD
SPAN = tcfg.PALLAS_AUTO_G_SPAN
RTOL = 1e-5
B, N = 2, 96
SMALL = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=2, n_hidden=32,
             n_head=4, slice_num=16, ball_sizes=(8, 4), mlp_ratio=1)


@pytest.mark.parametrize("n,g,device,span,want", [
    (T - 1, 32, "cuda", SPAN, False),            # just below
    (T, 32, "cuda", SPAN, True),                 # at the threshold
    (10 ** 9, 32, "cpu", SPAN, False),           # the CPU: plain at every N
    (1, 32, "cpu", SPAN, False),
    (T, 128, "cuda", SPAN, True),                # the card's G 128 (no
    (T - 1, 128, "cuda", SPAN, False),           # scaling: as at G 32)
    (int(1000 * (1 - 96 / 288)), 128, "cuda", 288.0, True),  # G scaling
    (int(1000 * (1 - 96 / 288)) - 1, 128, "cuda", 288.0, False),
    (250, 4096, "cuda", 288.0, True),            # the floor at 1/4
    (249, 4096, "cuda", 288.0, False),
], ids=["below", "at", "cpu_huge", "cpu_tiny", "g128_at", "g128_below",
        "scaled_at", "scaled_below", "floor_at", "floor_below"])
def test_auto_rule_edges(n, g, device, span, want, monkeypatch):
    """At the card's constants, and with a finite span (JAX's 288) for
    the rule's G scaling and its floor, at a base of 1000 points."""
    monkeypatch.setattr(tpa, "PALLAS_AUTO_G_SPAN", span)
    base = T if span == SPAN else 1000
    assert tpa.pallas_auto_enabled(n, g, base, device) is want


def test_auto_rule_has_jax_form(monkeypatch):
    """With JAX's TPU span (288) in place of the card's, the port's rule on
    CUDA resolves as the JAX module's ``_pallas_enabled`` under a TPU
    backend at every (N, G) of a grid around the thresholds; under the CPU
    backend JAX resolves to plain, as the port on the CPU."""
    monkeypatch.setattr(jpa.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(tpa, "PALLAS_AUTO_G_SPAN", 288.0)
    for g in (8, 32, 64, 100, 128, 256, 1024):
        attn = jpa.PhysicsAttentionIrregularMesh(
            dim=32, heads=4, dim_head=8, slice_num=g, use_pallas="auto",
            pallas_auto_threshold=T)
        eff = int(T * max(0.25, 1.0 - (g - 32) / 288.0))
        for n in (1, eff - 1, eff, eff + 1, 10 * eff + 7):
            assert attn._pallas_enabled(n) == tpa.pallas_auto_enabled(
                n, g, T, "cuda"), (g, n)
    monkeypatch.setattr(jpa.jax, "default_backend", lambda: "cpu")
    attn = jpa.PhysicsAttentionIrregularMesh(
        dim=32, heads=4, dim_head=8, slice_num=32, use_pallas="auto",
        pallas_auto_threshold=T)
    assert not attn._pallas_enabled(10 * T)
    assert not tpa.pallas_auto_enabled(10 * T, 32, T, "cpu")


def test_config_threshold_reaches_every_block():
    cfg = dataclasses.replace(tcfg.shapenet_car_config(), use_pallas="auto",
                              pallas_auto_threshold=5000)
    m = cfg.build(device="cpu")
    attns = [b.Attn for b in m.blocks]
    assert [a.pallas_auto_threshold for a in attns] == [5000, 5000]
    assert all(a.use_pallas == "auto" for a in attns)
    assert attns[0].pallas_enabled(5000, "cuda")
    assert not attns[0].pallas_enabled(4999, "cuda")
    assert not attns[0].pallas_enabled(10 ** 9, "cpu")
    assert tcfg.ModelConfig().pallas_auto_threshold == T


@pytest.fixture(scope="module")
def jax_auto():
    """The JAX auto model (threshold below N: still plain on the CPU) and
    its eval forward, built once."""
    rng = np.random.RandomState(3)
    x = rng.rand(B, N, 3).astype(np.float32)
    fx = rng.randn(B, N, 1).astype(np.float32)
    jm = JIrr(**SMALL, use_pallas="auto", pallas_auto_threshold=N // 2)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx)
    variables = init_like(template, rng, SMALL["n_hidden"])
    ref = np.asarray(jax.jit(jm.apply)(variables, x, fx))
    return variables, x, fx, ref


def test_auto_model_on_cpu_matches_jax(jax_auto, monkeypatch):
    variables, x, fx, ref = jax_auto
    calls = []
    for name in ("slice_states", "deslice"):
        fn = getattr(tpa.sk, name)
        monkeypatch.setattr(tpa.sk, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        outs = {}
        for flag in ("auto", False, True):
            m = HAETransolverIrregularMesh(
                **SMALL, use_pallas=flag, pallas_auto_threshold=N // 2,
                device="cpu").eval()
            load_jax_variables(m, variables)
            assert m.blocks[0].Attn.pallas_enabled(N, "cuda") == bool(flag)
            calls.clear()
            with torch.inference_mode():
                outs[flag] = m(torch.from_numpy(x),
                               torch.from_numpy(fx)).numpy()
            # the kernels' wrappers are called only when asked for
            # explicitly: "auto" takes the plain path on the CPU
            assert len(calls) == (4 if flag is True else 0), (flag, calls)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(outs["auto"], outs[False])
    scale = np.abs(ref).max()
    err = np.abs(outs["auto"] - ref).max()
    print(f"PARITY auto model (CPU) vs JAX auto: max_abs_err {err:.3e} "
          f"max|ref| {scale:.3e}")
    assert err <= RTOL * scale, (err, scale)
