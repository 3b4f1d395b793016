"""PyTorch port, the structured-mesh PDE models vs the JAX package.

Three JAX models, each built once for the module (``jax.eval_shape`` of its
init, weights drawn with numpy by ``test_torch_model.init_like``: the init
distributions perturbed by 0.05 N(0, 1), BatchNorm statistics moved off
(0, 1)), each run on its plain path (the JAX package's own tests hold it to
its Pallas kernels); the port runs with both kernel flags set and off (the
kernels' plain versions on the CPU):

* ``grid``: ``HAETransolverStructuredMesh2D`` on an 8 x 8 grid, 2 layers,
  n_hidden 32, 4 heads, G 16 in Erwin balls of 8 and 4 (so the levels hold
  two balls and the odd blocks rotate, at d 2, as the Darcy preset's G 64
  does), ``unified_pos`` ref 4, ``fun_dim`` 1, dropout 0.1: the eval
  forward, and a train-mode forward and ``jax.grad`` of a scalar loss with
  the dropout masks JAX drew, recorded by a stand-in for
  ``flax.linen.Dropout.__call__`` (flax's arithmetic, the mask sown) and
  fed to the port;
* ``time``: the same on an 8 x 4 grid (H != W) with ``Time_Input``,
  ``fun_dim`` 0 and ``fx=None`` (the placeholder rule and the time
  embedding): the eval forward;
* ``volume``: ``HAETransolverStructuredMesh3D`` on a 4 x 4 x 4 volume: the
  eval forward.

Tolerances: forwards within 1e-5 of max |out|, train-mode outputs with
dropout within 1e-5, gradients within 1e-4 of each leaf's max |grad| (float32
in another summation order through two layers and their Erwin stages), or
1e-6 of the model's largest |grad| for the leaves that are zero in exact
arithmetic or nearly (biases in front of a train-mode BatchNorm, ~1e-8 of
the largest |grad|: rounding noise on both sides, up to 3 times their own
max apart; the relative-position projections of the Erwin blocks, whose
gradients cancel over the tokens, 1e-6-1e-4 of the largest |grad|).
Plumbing at no JAX build: ``timestep_embedding``, the rotary helpers and
``PositionalEncoding``, the Erwin perms at d 2, the conv weights through
``utils/weights.py`` key for key, every preset built at full width, and
``use_checkpoint`` against the plain model on the port alone.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.models import (HAETransolverStructuredMesh2D as T2D,
                               HAETransolverStructuredMesh3D as T3D)
from haet_torch.models.components import embedding as temb
from haet_torch.ops import ball_groups as tbg
from haet_torch.ops.kernels import plain_route_counts, reset_launch_counts
from haet_torch.utils import config as tcfg
from haet_torch.utils.config import PALLAS_AUTO_THRESHOLD
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models import (HAETransolverStructuredMesh2D as J2D,
                             HAETransolverStructuredMesh3D as J3D)
from haet_tpu.models.components import embedding as jemb
from haet_tpu.ops import ball_groups as jbg
from haet_tpu.utils import config as jcfg
from test_torch_erwin import _assert_perms_equal
from test_torch_model import init_like

B = 2
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
SMALL = dict(n_layers=2, n_hidden=32, n_head=4, slice_num=16,
             ball_sizes=(8, 4), mlp_ratio=1)
MODELS = {
    "grid": (J2D, T2D, dict(SMALL, space_dim=2, fun_dim=1, out_dim=1,
                            unified_pos=True, ref=4, H=8, W=8, dropout=0.1)),
    "time": (J2D, T2D, dict(SMALL, space_dim=2, fun_dim=0, out_dim=4,
                            Time_Input=True, H=8, W=4)),
    "volume": (J3D, T3D, dict(SMALL, space_dim=3, fun_dim=1, out_dim=1,
                              unified_pos=True, ref=2, H=4, W=4, D=4)),
}


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _inputs(name, rng):
    kw = MODELS[name][2]
    n = kw["H"] * kw["W"] * kw.get("D", 1)
    x = rng.rand(B, n, kw["space_dim"]).astype(np.float32)
    fx = (rng.randn(B, n, kw["fun_dim"]).astype(np.float32)
          if kw["fun_dim"] else None)
    t = (rng.rand(B, 1).astype(np.float32) * 20
         if kw.get("Time_Input") else None)
    return x, fx, t


def _args(x, fx, t):
    return (x, fx) if t is None else (x, fx, t)


@pytest.fixture(scope="module")
def built():
    """Each JAX model once: numpy weights, inputs and the eval forward."""
    out = {}
    for i, (name, (jcls, _, kw)) in enumerate(MODELS.items()):
        rng = np.random.RandomState(10 + i)
        jm = jcls(**kw)
        x, fx, t = _inputs(name, rng)
        template = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                  *_args(x, fx, t))
        variables = init_like(template, rng, kw["n_hidden"])
        ref = np.asarray(jax.jit(jm.apply)(variables, *_args(x, fx, t)))
        out[name] = dict(jm=jm, variables=variables, x=x, fx=fx, t=t,
                         ref=ref)
    return out


def _port(name, variables, use_pallas, **over):
    _, tcls, kw = MODELS[name]
    tm = tcls(**{**kw, **over}, use_pallas=use_pallas,
              use_pallas_erwin=use_pallas, device="cpu")
    load_jax_variables(tm, variables)
    return tm


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(built, name, use_pallas):
    b = built[name]
    tm = _port(name, b["variables"], use_pallas).eval()
    reset_launch_counts()
    with torch.inference_mode():
        out = tm(*(_t(a) for a in _args(b["x"], b["fx"], b["t"]))).numpy()
    assert out.shape == b["ref"].shape
    assert all(v == 0 for v in plain_route_counts().values())
    err = np.abs(out - b["ref"]).max()
    scale = np.abs(b["ref"]).max()
    print(f"PARITY {name} forward use_pallas={use_pallas}: {err:.3e} of "
          f"max {scale:.3e}")
    assert err <= FWD_RTOL * scale, (err, scale)


def test_time_input_and_placeholder_rules(built):
    """``T`` moves the output (the time embedding is applied), ``T``
    without ``Time_Input`` raises, and the grids add the placeholder only
    when ``fx`` is None."""
    b = built["time"]
    tm = _port("time", b["variables"], False).eval()
    x, t = torch.from_numpy(b["x"]), torch.from_numpy(b["t"])
    with torch.inference_mode():
        assert not torch.equal(tm(x, None, t), tm(x, None, t + 1.0))
        assert not torch.equal(tm(x, None, t), tm(x, None))
    g = built["grid"]
    tg = _port("grid", g["variables"], False).eval()
    xg, fxg = torch.from_numpy(g["x"]), torch.from_numpy(g["fx"])
    with pytest.raises(ValueError, match="Time_Input"):
        tg(xg, fxg, t)
    with torch.no_grad():
        before = tg(xg, fxg)
        tg.placeholder.add_(1.0)   # unused: fx is given
        assert torch.equal(tg(xg, fxg), before)


def _record_dropout(monkeypatch):
    """``flax.linen.Dropout.__call__`` with flax's arithmetic that also
    sows each keep mask into ``intermediates``."""
    def call(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.merge_param("deterministic", self.deterministic,
                                        deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep_prob = 1.0 - self.rate
        if rng is None:
            rng = self.make_rng(self.rng_collection)
        keep = jax.random.bernoulli(rng, keep_prob, inputs.shape)
        self.sow("intermediates", "dropout_mask", keep)
        return jnp.where(keep, inputs / keep_prob, jnp.zeros_like(inputs))

    monkeypatch.setattr(fnn.Dropout, "__call__", call)


@pytest.fixture(scope="module")
def grid_train(built):
    """JAX's train-mode output, updated BatchNorm statistics, dropout masks
    and gradients of ``sum(out * w)`` on the ``grid`` model."""
    b = built["grid"]
    mp = pytest.MonkeyPatch()
    _record_dropout(mp)
    w = np.random.RandomState(5).randn(*b["ref"].shape).astype(np.float32)
    jm, variables = b["jm"], b["variables"]

    def loss(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            b["x"], b["fx"], train=True,
                            mutable=["batch_stats", "intermediates"],
                            rngs={"dropout": jax.random.PRNGKey(7)})
        return jnp.sum(out * w), (out, upd)

    try:
        (_, (out, upd)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(variables["params"])
    finally:
        mp.undo()
    inter = upd["intermediates"]
    masks = [np.asarray(inter[f"blocks_{i}"]["Attn"]["Dropout_0"]
                        ["dropout_mask"][0])
             for i in range(SMALL["n_layers"])]
    return dict(w=w, out=np.asarray(out), masks=masks,
                stats=from_jax_variables({"batch_stats":
                                          upd["batch_stats"]}),
                grads=from_jax_variables({"params": grads}))


def _train_grads(tm, b, w, masks):
    """The port's train-mode output, gradients and state after one
    forward and backward with ``masks`` fed to the dropouts."""
    tm.train()
    for blk, m in zip(tm.blocks, masks):
        blk.Attn.to_out[1].feed = [torch.from_numpy(m.copy())]
    params = dict(tm.named_parameters())
    out = tm(torch.from_numpy(b["x"]), torch.from_numpy(b["fx"]))
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                list(params.values()), allow_unused=True)
    assert all(not blk.Attn.to_out[1].feed for blk in tm.blocks)
    return out.detach(), dict(zip(params, grads))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_grads_with_dropout_match_jax(built, grid_train, use_pallas):
    """Train mode, dropout 0.1 with JAX's masks: the output within 1e-5 of
    max, every leaf's gradient within 1e-4 of its max, and the BatchNorm
    statistics as JAX updates them."""
    b, j = built["grid"], grid_train
    assert 0.8 < np.mean(np.concatenate([m.ravel() for m in j["masks"]])) \
        < 1.0
    tm = _port("grid", b["variables"], use_pallas)
    out, grads = _train_grads(tm, b, j["w"], j["masks"])
    err = np.abs(out.numpy() - j["out"]).max()
    assert err <= FWD_RTOL * np.abs(j["out"]).max(), err
    gmax = max(float(v.abs().max()) for v in j["grads"].values())
    worst, noise = 0.0, 0
    for k, g in grads.items():
        if k.endswith("sigma_att"):
            assert g is None
            continue
        if k == "placeholder":   # unused: fx is given
            assert g is None and not j["grads"][k].any()
            continue
        want = j["grads"][k].numpy()
        scale = np.abs(want).max()
        e = np.abs(g.numpy() - want).max()
        assert e <= max(GRAD_RTOL * scale, GRAD_ATOL * gmax), (k, e, scale)
        if e <= GRAD_RTOL * scale:
            worst = max(worst, e / scale)
        else:   # held by the floor
            noise += 1
    sd = tm.state_dict()
    for k, v in j["stats"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    print(f"PARITY grid train use_pallas={use_pallas}: out {err:.3e}, "
          f"worst leaf {worst:.3e}, {noise} leaves at the floor")


def test_use_checkpoint_equals_plain(built, grid_train):
    """``use_checkpoint`` against the same model without it, on the CPU:
    the train-mode output and every gradient bit for bit (the recompute
    replays the forward's dropout masks), and the BatchNorm statistics
    and counters updated once."""
    b, j = built["grid"], grid_train
    plain = _port("grid", b["variables"], True)
    remat = _port("grid", b["variables"], True, use_checkpoint=True)
    out_p, g_p = _train_grads(plain, b, j["w"], j["masks"])
    out_r, g_r = _train_grads(remat, b, j["w"], j["masks"])
    assert torch.equal(out_p, out_r)
    for k, g in g_p.items():
        assert (g is None) == (g_r[k] is None), k
        if g is not None:
            assert torch.equal(g, g_r[k]), k
    sp, sr = plain.state_dict(), remat.state_dict()
    for k in sp:
        assert torch.equal(sp[k], sr[k]), k
    counts = {int(v) for k, v in sr.items()
              if k.endswith("num_batches_tracked")}
    assert counts == {1}
    # drawn from the generator, not fed: the recompute replays the
    # forward's masks
    xs = torch.from_numpy(b["x"]), torch.from_numpy(b["fx"])
    got = []
    for tm in (plain, remat):
        tm.dropout_generator.manual_seed(3)
        ps = [p for p in tm.parameters() if p.requires_grad]
        out = tm(*xs)
        got.append((out, torch.autograd.grad(out.sum(), ps,
                                             allow_unused=True)))
    assert torch.equal(got[0][0], got[1][0])
    assert all((a is None and c is None) or torch.equal(a, c)
               for a, c in zip(got[0][1], got[1][1]))


def test_conv_weights_cross_key_for_key(built):
    """``from_jax_variables`` gives the port's state-dict keys exactly, the
    conv kernels HWIO -> OIHW and DHWIO -> OIDHW, ``time_fc1``/``time_fc2``
    -> ``time_fc.0``/``time_fc.2``."""
    for name in MODELS:
        b = built[name]
        sd = from_jax_variables(b["variables"])
        tm = _port(name, b["variables"], False)
        assert sorted(sd) == sorted(tm.state_dict())
        kernel = np.asarray(b["variables"]["params"]["blocks_0"]["Attn"]
                            ["in_project_x"]["kernel"])
        w = tm.blocks[0].Attn.in_project_x.weight.detach().numpy()
        perm = (3, 2, 0, 1) if kernel.ndim == 4 else (4, 3, 0, 1, 2)
        np.testing.assert_array_equal(w, kernel.transpose(perm))
        assert w.shape[-1] == 3 and w.ndim == kernel.ndim
    p = built["time"]["variables"]["params"]
    sd = from_jax_variables(built["time"]["variables"])
    np.testing.assert_array_equal(sd["time_fc.2.weight"].numpy(),
                                  np.asarray(p["time_fc2"]["kernel"]).T)


@pytest.mark.parametrize("dim", [7, 8])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([[0.0], [0.5], [3.0], [19.0]], np.float32)
    got = temb.timestep_embedding(torch.from_numpy(t), dim).numpy()
    want = np.asarray(jemb.timestep_embedding(t, dim))
    assert got.shape == (4, dim)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        temb.timestep_embedding(torch.from_numpy(t[:, 0]), dim).numpy(),
        want, rtol=1e-6, atol=1e-6)


def test_rotary_and_positional_encoding_match_jax():
    rng = np.random.RandomState(2)
    c = rng.rand(2, 5).astype(np.float32)
    t = rng.randn(2, 5, 8).astype(np.float32)
    fx = temb.rotary_frequencies(torch.from_numpy(c), 4)
    np.testing.assert_allclose(fx.numpy(),
                               np.asarray(jemb.rotary_frequencies(c, 4)),
                               rtol=1e-6)
    fy = temb.rotary_frequencies(torch.from_numpy(c[::-1].copy()), 4)
    got = temb.apply_2d_rotary_pos_emb(torch.from_numpy(t), fx, fy).numpy()
    want = jemb.apply_2d_rotary_pos_emb(t, np.asarray(fx), np.asarray(fy))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    pe = temb.PositionalEncoding(8, max_len=16).eval()
    want = jemb.PositionalEncoding(8, max_len=16).apply({}, t)
    np.testing.assert_allclose(pe(torch.from_numpy(t)).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_darcy_shapes_perms_integer_equal():
    """Erwin's perms at the Darcy preset's level shapes, d 2: 32 clouds of
    64 tokens in balls of 32, then 32 in balls of 16 (the rotated levels)."""
    pos = np.random.RandomState(8).rand(32, 64, 2).astype(np.float32)
    kw = dict(ball_sizes=(32, 16), strides=(2,), rotate_angle=45.0)
    pt = tbg.build_erwin_perms(torch.from_numpy(pos), **kw)
    assert all(p is not None for p in pt.rot_perms)
    _assert_perms_equal(pt, jbg.build_erwin_perms(jnp.asarray(pos), **kw))


@pytest.mark.parametrize("preset", list(jcfg.PRESETS))
def test_every_preset_builds_at_full_width(preset):
    """Every JAX preset has a port counterpart, field for field (but
    ``pallas_auto_threshold``, the card's measured threshold where JAX has
    the TPU's), that builds at full width on the CPU; the Darcy model's
    parameter count equals JAX's (``jax.eval_shape`` of its init)."""
    want = jcfg.PRESETS[preset]()
    fields = dataclasses.asdict(want)
    fields["model"]["pallas_auto_threshold"] = PALLAS_AUTO_THRESHOLD
    got = tcfg.PRESETS[preset]()
    assert dataclasses.asdict(got) == fields
    tm = got.model.build(device="cpu")
    n = sum(p.numel() for p in tm.parameters())
    assert type(tm).__name__ == tcfg.VARIANTS[got.model.variant]
    if preset == "darcy":
        s = got.model.H * got.model.W
        jm = want.model.build()
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                np.zeros((1, s, 2), np.float32),
                                np.zeros((1, s, 1), np.float32))
        assert n == sum(int(np.prod(v.shape)) for v in
                        jax.tree_util.tree_leaves(shapes["params"]))
