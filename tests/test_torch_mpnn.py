"""PyTorch port, the Erwin-only car baseline's pieces vs the JAX package.

The same seeded numpy positions and features, and JAX's weights drawn by
``test_torch_model.init_like`` (carried over with
``haet_torch.utils.weights``), go through ``haet_tpu`` and ``haet_torch``
on the CPU:

* ``morton_code`` and ``morton_perm`` (d 1, 2, 3) and
  ``build_erwin_perms(grouping="morton")`` integer-equal to JAX's;
* ``knn_edges_brute``, ``knn_edges_grouped`` (called directly at N 512
  with a ball of 32, masked) and ``radius_edges``: each point's valid
  neighbours are the same set as JAX's (seeded clouds, no tied distances;
  ``torch.topk`` and ``lax.top_k`` may order ties and invalid slots
  differently);
* the segment reductions against ``jax.ops``;
* ``MPNN``'s forward and gradients on JAX's edges;
* ``ErwinTransformer`` with 3 MPNN steps on a radius graph (a masked,
  padded cloud) and with morton grouping, and ``ErwinCarModel`` at hidden
  32 and N 512, eval forwards;
* ``haet_torch.benchmarks.erwin_baseline --smoke --device cpu`` on the
  fixture folds.

Tolerance: forwards within 1e-5 of max |out|; gradients within 1e-4 of each
leaf's max |grad| (float32 in another summation order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.models.erwin import MPNN as TMPNN
from haet_torch.models.erwin import ErwinTransformer as TErwin
from haet_torch.ops import ball_groups as tbg
from haet_torch.ops import neighbors as tnb
from haet_torch.ops import scatter as tsc
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models.erwin import MPNN as JMPNN
from haet_tpu.models.erwin import ErwinTransformer as JErwin
from haet_tpu.ops import ball_groups as jbg
from haet_tpu.ops import neighbors as jnb
from haet_tpu.ops import scatter as jsc
from test_torch_car_data import build_car_dataset
from test_torch_erwin import _assert_perms_equal, _prefixed
from test_torch_model import init_like

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cloud(b, n, d, seed):
    return np.random.RandomState(seed).rand(b, n, d).astype(np.float32)


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _neighbour_sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [[frozenset(idx[b, i][valid[b, i]].tolist())
             for i in range(idx.shape[1])] for b in range(idx.shape[0])]


def _assert_same_edges(got, want):
    g, w = _neighbour_sets(*got), _neighbour_sets(*want)
    assert g == w
    return sum(len(s) for row in w for s in row)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_morton_code_and_perm_integer_equal(d):
    pos = _cloud(2, 256, d, d)
    pos[0, :5] = pos[0, 5:10]          # duplicated points tie in the code
    jc = np.asarray(jbg.morton_code(jnp.asarray(pos)))
    tc = tbg.morton_code(torch.from_numpy(pos))
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(
        tbg.morton_perm(torch.from_numpy(pos)).numpy(),
        np.asarray(jbg.morton_perm(jnp.asarray(pos))))


@pytest.mark.parametrize("masked", [False, True])
def test_morton_erwin_perms_integer_equal(masked):
    pos = _cloud(2, 128, 3, 7)
    mask = None
    if masked:
        mask = np.arange(128)[None].repeat(2, 0) < 100
    kw = dict(ball_sizes=(16, 8), strides=(2,), rotate_angle=45.0,
              grouping="morton")
    got = tbg.build_erwin_perms(
        torch.from_numpy(pos),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    want = jbg.build_erwin_perms(
        jnp.asarray(pos), mask=None if mask is None else jnp.asarray(mask),
        **kw)
    _assert_perms_equal(got, want)
    assert got.rot_perms[0] is not None


@pytest.mark.parametrize("include_self,masked", [(True, False), (False, True)])
def test_knn_brute_matches_jax(include_self, masked):
    pos = _cloud(2, 300, 3, 1)
    mask = (np.random.RandomState(2).rand(2, 300) > 0.2) if masked else None
    kw = dict(include_self=include_self)
    got = tnb.knn_edges_brute(
        torch.from_numpy(pos), 12,
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    want = jax.jit(lambda p, m: jnb.knn_edges_brute(p, 12, mask=m, **kw))(
        jnp.asarray(pos), None if mask is None else jnp.asarray(mask))
    assert got[0].shape == want[0].shape == (2, 300, 12)
    assert _assert_same_edges(got, want) > 0


@pytest.mark.parametrize("n,masked", [(512, False), (400, True)])
def test_knn_grouped_matches_jax(n, masked):
    """The ball-grouped search at N 512 (and 400, padded to 512) with a
    ball of 32: 16 balls, both groupings, the dedup and the pad slots."""
    pos = _cloud(1, n, 3, 3)
    mask = (np.random.RandomState(4).rand(1, n) > 0.1) if masked else None
    got = tnb.knn_edges_grouped(
        torch.from_numpy(pos), 16,
        mask=None if mask is None else torch.from_numpy(mask), ball=32)
    want = jax.jit(lambda p, m: jnb.knn_edges_grouped(p, 16, mask=m,
                                                      ball=32))(
        jnp.asarray(pos), None if mask is None else jnp.asarray(mask))
    assert got[0].shape == want[0].shape
    assert int(got[0].max()) < n
    assert _assert_same_edges(got, want) > 0
    # the rotated grouping found neighbours the main windows lack
    exact = tnb.knn_edges_brute(torch.from_numpy(pos), 16, mask=None
                                if mask is None else torch.from_numpy(mask))
    assert _neighbour_sets(*got) != _neighbour_sets(*exact) or n < 512


def test_knn_edges_routes_and_radius_matches_jax(monkeypatch):
    pos = _cloud(2, 256, 3, 5)
    got = tnb.radius_edges(torch.from_numpy(pos), 0.2, 32)
    want = jax.jit(lambda p: jnb.radius_edges(p, 0.2, 32))(jnp.asarray(pos))
    assert _assert_same_edges(got, want) > 0
    assert not np.asarray(want[1]).all()       # the radius cut some
    # above BRUTE_FORCE_MAX_N, knn_edges searches within balls
    monkeypatch.setattr(tnb, "BRUTE_FORCE_MAX_N", 128)
    monkeypatch.setattr(jnb, "BRUTE_FORCE_MAX_N", 128)
    got = tnb.radius_edges(torch.from_numpy(pos), 0.2, 32)
    want = jax.jit(lambda p: jnb.radius_edges(p, 0.2, 32))(jnp.asarray(pos))
    assert _assert_same_edges(got, want) > 0


def test_segment_ops_match_jax():
    rng = np.random.RandomState(0)
    data = rng.randn(50, 3).astype(np.float32)
    ids = rng.randint(0, 7, 50)
    ids[ids == 3] = 4                           # an empty segment
    for name in ("segment_sum", "segment_mean", "segment_max"):
        got = getattr(tsc, name)(torch.from_numpy(data),
                                 torch.from_numpy(ids), 7).numpy()
        want = np.asarray(getattr(jsc, name)(jnp.asarray(data),
                                             jnp.asarray(ids), 7))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    bf = torch.ones(600, dtype=torch.bfloat16)
    assert float(tsc.segment_mean(bf, torch.zeros(600, dtype=torch.long),
                                  1)[0]) == 1.0


def test_mpnn_forward_and_grads_match_jax():
    """Two MPNN steps on JAX's radius graph: the output within 1e-5 of
    max, the gradients of ``sum(out * w)`` for the input and every
    parameter within 1e-4 of each leaf's max."""
    rng = np.random.RandomState(0)
    h = rng.randn(2, 128, 16).astype(np.float32)
    pos = _cloud(2, 128, 3, 9)
    idx, valid = jnb.radius_edges(jnp.asarray(pos), 0.25, 8)
    jm = JMPNN(16, 2, 3)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), h, pos, idx,
                              valid)
    variables = init_like(template, rng, 16)
    w = rng.randn(2, 128, 16).astype(np.float32)

    def loss(params, h):
        out = jm.apply({"params": params}, h, pos, idx, valid)
        return jnp.sum(out * w), out

    (_, jout), (jgp, jgh) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"], h)
    tm = TMPNN(16, 2, 3)
    sd = {k.removeprefix("mpnn."): v for k, v in from_jax_variables(
        {"params": {"mpnn": variables["params"]}}).items()}
    tm.load_state_dict(sd, strict=True)
    ht = torch.from_numpy(h).requires_grad_(True)
    out = tm(ht, torch.from_numpy(pos),
             torch.from_numpy(np.asarray(idx)).long(),
             torch.from_numpy(np.asarray(valid)))
    assert _rel(out.detach(), jout) <= FWD_RTOL
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [ht, *params.values()])
    want = from_jax_variables({"params": {"mpnn": jgp}})
    assert _rel(grads[0], jgh) <= GRAD_RTOL
    for (k, _), g in zip(params.items(), grads[1:]):
        assert _rel(g, want["mpnn." + k].numpy()) <= GRAD_RTOL, k


ERWIN = dict(c_in=8, c_hidden=(16, 32), ball_sizes=(16, 8),
             enc_num_heads=(2, 4), enc_depths=(1, 1), dec_num_heads=(2,),
             dec_depths=(1,), strides=(2,), rotate=45, mlp_ratio=2,
             dimensionality=3)


@pytest.mark.parametrize("extra", [
    dict(mp_steps=3, mp_radius=0.3, mp_neighbors=8),
    dict(mp_steps=0, grouping="morton"),
], ids=["mpnn_radius", "morton"])
def test_erwin_matches_jax(extra):
    """The Erwin stage with MPNN on the radius graph of a cloud of 200
    points padded to 256 (the pads masked out of the graph), and with
    morton grouping: the eval forward within 1e-5 of max."""
    rng = np.random.RandomState(1)
    n = 200
    x = rng.randn(2, n, 8).astype(np.float32)
    pos = _cloud(2, n, 3, 11)
    xp, pp, mask = jbg.pad_pow2(jnp.asarray(x), jnp.asarray(pos))
    jm = JErwin(**ERWIN, embed=True, **extra)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), xp, pp,
                              mask=mask)
    variables = init_like(template, rng, 16)
    ref = np.asarray(jax.jit(lambda v, a, p, m: jm.apply(v, a, p, mask=m))(
        variables, xp, pp, mask))[:, :n]
    tm = TErwin(**ERWIN, embed=True, **extra).eval()
    tm.load_state_dict({k.removeprefix("erwin."): v for k, v in
                        from_jax_variables(_prefixed(variables)).items()},
                       strict=True)
    xt, pt, mt = tbg.pad_pow2(torch.from_numpy(x), torch.from_numpy(pos))
    with torch.no_grad():
        got = tm(xt, pt, mask=mt)[:, :n].numpy()
    assert _rel(got, ref) <= FWD_RTOL


@pytest.fixture(scope="module")
def jax_car_model():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from erwin_baseline import ErwinCarModel

    return ErwinCarModel


def test_erwin_car_model_matches_jax(jax_car_model):
    """``ErwinCarModel`` at hidden 32 (3 MPNN steps, radius 0.2, 32
    neighbours) on 500 points (padded to 512): every JAX variable loads
    key for key, and the eval forward is within 1e-5 of max."""
    from haet_torch.benchmarks.erwin_baseline import ErwinCarModel

    rng = np.random.RandomState(2)
    x = np.concatenate([rng.rand(1, 500, 3), rng.randn(1, 500, 4)],
                       -1).astype(np.float32)
    jm = jax_car_model(hidden_dim=32)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = init_like(template, rng, 32)
    ref = np.asarray(jax.jit(jm.apply)(variables, x))
    tm = ErwinCarModel(32, device="cpu").eval()
    load_jax_variables(tm, variables)
    assert {k for k in tm.state_dict()} >= {"head1.weight", "head2.bias",
                                            "erwin.embed.mpnn."
                                            "fused_message_update.2.0.weight"}
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 500, 4)
    assert _rel(got, ref) <= FWD_RTOL


def test_erwin_baseline_smoke_on_fixture(tmp_path, capsys):
    from haet_torch.benchmarks import erwin_baseline

    data_dir = str(tmp_path / "training_data")
    build_car_dataset(data_dir)
    metrics = erwin_baseline.main(["--smoke", "--device", "cpu",
                                   "--data_dir", data_dir,
                                   "--out_dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "synthetic stand-in" not in out
    assert "nb_parameters" in out and "relative l2 error press:" in out
    assert np.isfinite(metrics["rel_l2_press"])
    assert np.isfinite(metrics["rel_l2_velo"])
    assert os.path.exists(tmp_path / "runs" / "erwin_metrics.jsonl")
    assert os.path.exists(tmp_path / "runs" / "checkpoints" / "erwin_car")
