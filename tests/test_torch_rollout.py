"""PyTorch port, the time-stepping PDE loops and rollout export vs the JAX
package.

Two JAX models, each built once for the module (``jax.eval_shape`` of its
init, weights drawn with numpy by ``test_torch_model.init_like``), run on
their plain path; the port runs with both kernel flags set (the kernels'
plain versions on the CPU):

* ``ns``: ``HAETransolverStructuredMesh2D`` on a 16 x 16 grid, 1 layer,
  n_hidden 32, 4 heads, G 16 in balls of 8 and 4, ``unified_pos``, a
  window of ``T_IN`` 4 frames and a rollout of ``T_OUT`` 3, dropout 0.1:
  the teacher-forced loss of ``benchmarks/exp_ns.py`` (``lax.scan`` over
  frames under ``jax.checkpoint``, each frame's own dropout rng) and its
  ``jax.value_and_grad``, with JAX's dropout masks fed to the port; the
  autoregressive eval; JAX's rollout artifact against the port's;
* ``plas``: the same model on an 8 x 8 grid with ``Time_Input``, ``fun_dim``
  1 and ``out_dim`` 4: ``exp_plas.py``'s training loss over ``T`` 3 queries
  (a ``lax.scan`` carrying the BatchNorm statistics) and its gradients,
  and its eval (``vmap`` over the queries).

Tolerances: forwards and losses within 1e-5 of max |out|, gradients within
1e-4 of each leaf's max |grad| or 1e-6 of the model's largest |grad| (the
rule of ``tests/test_torch_pde_model.py``). Also: the port's checkpointed
and unchecked NS gradients are equal bit for bit and the BatchNorm
statistics are updated once per frame; a ``B * T``-folded plasticity
forward differs from the per-query ones (the Erwin pseudo-positions are
normalised over the whole batch); the rollout artifact's manifest, its
``ValueError``s, ``BatchingServer`` serving it and the ambiguous-bundle
message; ``exp_ns`` (with ``--export_rollout``) and ``exp_plas`` with
``--smoke --device cpu`` on the fixtures, and ``micro_rollout --smoke``.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch import export as hexport
from haet_torch.benchmarks import exp_ns, exp_plas, micro_rollout
from haet_torch.models import HAETransolverStructuredMesh2D as T2D
from haet_torch.serve import BatchingServer
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu import export as jexport
from haet_tpu.models import HAETransolverStructuredMesh2D as J2D
from haet_tpu.train import RelLpLoss as JRelLp
from test_torch_model import init_like

FIXT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                    "data")
B, T_IN, T_OUT, T_Q = 2, 4, 3, 3
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-6
SMALL = dict(n_layers=1, n_hidden=32, n_head=4, slice_num=16,
             ball_sizes=(8, 4), mlp_ratio=1, space_dim=2)
NS_KW = dict(SMALL, fun_dim=T_IN, out_dim=1, unified_pos=True, ref=4, H=16,
             W=16, dropout=0.1)
PLAS_KW = dict(SMALL, fun_dim=1, out_dim=4, Time_Input=True, H=8, W=8)


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _grid(h, w):
    g1 = np.linspace(0, 1, h, dtype=np.float32)
    g2 = np.linspace(0, 1, w, dtype=np.float32)
    gx, gy = np.meshgrid(g1, g2, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], -1)[None].repeat(B, 0)


def _port(kw, variables):
    tm = T2D(**kw, use_pallas=True, use_pallas_erwin=True, device="cpu")
    load_jax_variables(tm, variables)
    return tm


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _hold_grads(grads: dict, want: dict):
    """Every gradient within ``GRAD_RTOL`` of its leaf's max, or
    ``GRAD_ATOL`` of the model's largest |grad|; ``sigma_att`` gets none,
    nor does the placeholder where ``fx`` is given (zero in JAX)."""
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, g in grads.items():
        if k.endswith("sigma_att") or g is None:
            assert k.endswith("sigma_att") or not want[k].any(), k
            continue
        w = want[k].numpy()
        e = np.abs(g.numpy() - w).max()
        assert e <= max(GRAD_RTOL * np.abs(w).max(), GRAD_ATOL * gmax), (k, e)


def _hold_stats(tm, want: dict, count: int):
    sd = tm.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        assert int(sd[k.rsplit(".", 1)[0] + ".num_batches_tracked"]) == count


def _masked_dropout(monkeypatch):
    """``flax.linen.Dropout.__call__`` with flax's arithmetic that also
    sows each keep mask (``tests/test_torch_pde_model.py``)."""
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


def _jax_ns_loss(jm, params, batch_stats, batch, train, rng):
    """``benchmarks/exp_ns.py:rollout_loss``: the frames under
    ``lax.scan`` (``jax.checkpoint`` in training), teacher forcing in
    training and feedback at eval; also returns the dropout masks."""
    rel_l2 = JRelLp(size_average=False)
    yy = batch["y"]
    b, n, _ = yy.shape
    ys = jnp.moveaxis(yy.reshape(b, n, T_OUT, 1), 2, 0)

    def body(carry, ys_t):
        y, t = ys_t
        fx, bs, loss = carry
        im, upd = jm.apply(
            {"params": params, "batch_stats": bs}, batch["pos"], fx,
            train=train, mutable=["batch_stats", "intermediates"],
            rngs={"dropout": jax.random.fold_in(rng, t)} if train else {})
        loss = loss + rel_l2(im.reshape(b, -1), y.reshape(b, -1)) / b
        fx = jnp.concatenate([fx[..., 1:], y if train else im], axis=-1)
        return (fx, upd["batch_stats"], loss), (im, upd.get(
            "intermediates", {}))

    (_, bs, loss), (preds, inter) = jax.lax.scan(
        jax.checkpoint(body) if train else body,
        (batch["x"], batch_stats, jnp.zeros((), jnp.float32)),
        (ys, jnp.arange(T_OUT, dtype=jnp.uint32)))
    pred = jnp.moveaxis(preds, 0, 2).reshape(b, n, T_OUT)
    full = rel_l2(pred.reshape(b, -1), yy.reshape(b, -1)) / b
    return loss, (full, bs, pred, inter)


@pytest.fixture(scope="module")
def ns():
    """The NS model, its batch, JAX's train-mode loss, gradients, updated
    statistics and masks, and its autoregressive eval."""
    rng = np.random.RandomState(0)
    n = NS_KW["H"] * NS_KW["W"]
    batch = {"pos": _grid(16, 16),
             "x": rng.randn(B, n, T_IN).astype(np.float32),
             "y": rng.randn(B, n, T_OUT).astype(np.float32)}
    jm = J2D(**NS_KW)
    variables = init_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                         batch["pos"], batch["x"]), rng, 32)
    mp = pytest.MonkeyPatch()
    _masked_dropout(mp)
    try:
        (loss, (full, bs, _, inter)), grads = jax.jit(jax.value_and_grad(
            lambda p: _jax_ns_loss(jm, p, variables["batch_stats"], batch,
                                   True, jax.random.PRNGKey(3)),
            has_aux=True))(variables["params"])
    finally:
        mp.undo()
    _, (efull, _, epred, _) = jax.jit(
        lambda v: _jax_ns_loss(jm, v["params"], v["batch_stats"], batch,
                               False, None))(variables)
    masks = [np.asarray(inter[f"blocks_{i}"]["Attn"]["Dropout_0"]
                        ["dropout_mask"][0])
             for i in range(SMALL["n_layers"])]
    return dict(jm=jm, variables=variables, batch=batch, loss=float(loss),
                full=float(full), masks=masks,
                grads=from_jax_variables({"params": grads}),
                stats=from_jax_variables({"batch_stats": bs}),
                eval_full=float(efull), eval_pred=np.asarray(epred))


def _ns_step(tm, ns, checkpoint_frames=True):
    """The port's teacher-forced loss, aux and gradients with JAX's masks
    fed to the dropouts (one per frame)."""
    for blk, m in zip(tm.blocks, ns["masks"]):
        blk.Attn.to_out[1].feed = [torch.from_numpy(m[t].copy())
                                   for t in range(T_OUT)]
    wrap = exp_ns.Rollout(tm, T_OUT, 1, checkpoint_frames).train()
    batch = {k: torch.from_numpy(v) for k, v in ns["batch"].items()}
    loss_fn, _ = exp_ns.rollout_loss(T_OUT, 1)
    loss, aux = loss_fn(wrap(batch["pos"], batch["x"], batch["y"]), batch)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert all(not blk.Attn.to_out[1].feed for blk in tm.blocks)
    return (float(loss.detach()), float(aux["full"].detach()),
            dict(zip(params, grads)))


def test_ns_teacher_forced_loss_and_grads_match_jax(ns):
    """The loss (the sum of the frames' rel-L2) and ``full`` within 1e-5,
    every gradient within the per-leaf rule, and the BatchNorm statistics
    as JAX's scan leaves them, updated once per frame."""
    assert 0.8 < np.mean(np.concatenate([m.ravel() for m in ns["masks"]])) \
        < 1.0
    tm = _port(NS_KW, ns["variables"])
    loss, full, grads = _ns_step(tm, ns)
    assert abs(loss - ns["loss"]) <= FWD_RTOL * abs(ns["loss"])
    assert abs(full - ns["full"]) <= FWD_RTOL * abs(ns["full"])
    _hold_grads(grads, ns["grads"])
    _hold_stats(tm, ns["stats"], T_OUT)


def test_ns_checkpointed_frames_equal_unchecked(ns):
    """Within the port: the per-frame checkpoint's gradients equal the
    unchecked ones bit for bit, and the statistics and counters too (the
    recompute replays each frame's masks and does not update BatchNorm)."""
    got = []
    for remat in (True, False):
        tm = _port(NS_KW, ns["variables"])
        got.append((*_ns_step(tm, ns, remat), tm.state_dict()))
    (l1, f1, g1, s1), (l2, f2, g2, s2) = got
    assert l1 == l2 and f1 == f2
    for k, g in g1.items():
        assert (g is None) == (g2[k] is None), k
        if g is not None:
            assert torch.equal(g, g2[k]), k
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def test_ns_autoregressive_eval_matches_jax(ns):
    tm = _port(NS_KW, ns["variables"])
    wrap = exp_ns.Rollout(tm, T_OUT, 1).eval()
    batch = {k: torch.from_numpy(v) for k, v in ns["batch"].items()}
    _, eval_fn = exp_ns.rollout_loss(T_OUT, 1)
    with torch.inference_mode():
        pred = wrap(batch["pos"], batch["x"])
        full = float(eval_fn(pred, batch)["loss"])
    assert _rel(pred, ns["eval_pred"]) <= FWD_RTOL
    assert abs(full - ns["eval_full"]) <= FWD_RTOL * ns["eval_full"]


@pytest.fixture(scope="module")
def rollout_art(ns, tmp_path_factory):
    """JAX's rollout artifact and the port's, one sample, on the same
    weights."""
    root = tmp_path_factory.mktemp("rollout")
    pos, fx0 = ns["batch"]["pos"][:1], ns["batch"]["x"][:1]
    jp = jexport.save_rollout_artifact(str(root / "jax"), ns["jm"],
                                       ns["variables"], (pos, fx0),
                                       steps=T_OUT)
    want = np.asarray(jexport.load_artifact(jp)(ns["variables"], pos, fx0))
    tm = _port(NS_KW, ns["variables"]).eval()
    tp = hexport.save_rollout_artifact(
        str(root / "port" / "rollout"), tm, tm.state_dict(), (pos, fx0),
        steps=T_OUT, extra_manifest={"rollout_steps": 99, "note": "x"})
    return dict(root=root, path=tp, tm=tm, pos=pos, fx0=fx0, want=want)


def test_rollout_artifact_matches_jax(rollout_art):
    """The port's program against JAX's (``save_rollout_artifact`` of the
    same weights), passed its weights and bound, within 1e-5 of max; the
    manifest records ``rollout_steps`` and ``step_width`` over the
    caller's extras."""
    a = rollout_art
    em = hexport.load_artifact(a["path"], device="cpu")
    sd = a["tm"].state_dict()
    for got in (em(sd, a["pos"], a["fx0"]),
                em.bind(sd)(a["pos"], a["fx0"])):
        assert tuple(got.shape) == (1, 256, T_OUT)
        assert _rel(got, a["want"]) <= FWD_RTOL
    with open(os.path.join(a["path"], "manifest.json")) as f:
        man = json.load(f)
    assert man["rollout_steps"] == T_OUT and man["step_width"] == 1
    assert man["note"] == "x"
    assert man["input_shapes"] == [[1, 256, 2], [1, 256, T_IN]]


def test_rollout_export_validates_window_and_out_dim(rollout_art):
    a = rollout_art
    with pytest.raises(ValueError, match="out_dim"):
        hexport.export_rollout(a["tm"], None, (a["pos"], a["fx0"]), steps=2,
                               step_width=3)
    with pytest.raises(ValueError, match="window"):
        hexport.export_rollout(a["tm"], None, (a["pos"], a["fx0"][..., :0]),
                               steps=2)
    with pytest.raises(ValueError, match="steps"):
        hexport.export_rollout(a["tm"], None, (a["pos"], a["fx0"]), steps=0)


def test_rollout_bundle_serves_and_ambiguity_names_rollout_steps(
        rollout_art):
    """A bundle root holding the rollout artifact serves its requests
    through ``BatchingServer`` as the program answers them; a forward and
    a rollout of one input signature in one bundle raise, naming
    ``rollout_steps``."""
    a = rollout_art
    bundle = hexport.ServingBundle.load(str(a["root"] / "port"),
                                        device="cpu")
    with BatchingServer(bundle, a["tm"].state_dict(), max_delay_s=0.0,
                        device="cpu") as srv:
        got = srv.predict(a["pos"][0], a["fx0"][0], timeout=120)
    assert got.shape == (256, T_OUT)
    assert _rel(got[None], a["want"]) <= FWD_RTOL

    class Forward:
        input_shapes = [[1, 256, 2], [1, 256, T_IN]]
        manifest = {"input_dtypes": ["float32", "float32"], "batch_size": 1}

    roll = bundle._by_key[next(iter(bundle._by_key))]
    with pytest.raises(ValueError, match="rollout_steps"):
        hexport.ServingBundle([roll, Forward()])


@pytest.fixture(scope="module")
def plas():
    """The plasticity model, its batch, JAX's training loss over the T
    queries (``lax.scan`` carrying the statistics), its gradients and
    statistics, and its eval (``vmap`` over the queries)."""
    rng = np.random.RandomState(1)
    n = PLAS_KW["H"] * PLAS_KW["W"]
    batch = {"pos": _grid(8, 8),
             "fx": rng.randn(B, n, 1).astype(np.float32),
             "y": rng.randn(B, n, T_Q, 4).astype(np.float32)}
    jm = J2D(**PLAS_KW)
    variables = init_like(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), batch["pos"], batch["fx"],
        jnp.zeros((B, 1))), rng, 32)
    ts = jnp.arange(T_Q, dtype=jnp.float32)
    rel_l2 = JRelLp(size_average=False)

    def t_of(t):
        return jnp.full((B, 1), t)

    def loss(params):
        def step(bs, t):
            out, upd = jm.apply({"params": params, "batch_stats": bs},
                                batch["pos"], batch["fx"], t_of(t),
                                mutable=["batch_stats"], train=True)
            return upd["batch_stats"], out
        bs, outs = jax.lax.scan(step, variables["batch_stats"], ts)
        y = jnp.transpose(batch["y"], (0, 2, 1, 3))
        return rel_l2(jnp.transpose(outs, (1, 0, 2, 3)).reshape(B, -1),
                      y.reshape(B, -1)) / B, bs

    (lval, bs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    evals = jax.jit(lambda v: jax.vmap(lambda t: jm.apply(
        v, batch["pos"], batch["fx"], t_of(t)))(ts))(variables)
    return dict(variables=variables, batch=batch, loss=float(lval),
                grads=from_jax_variables({"params": grads}),
                stats=from_jax_variables({"batch_stats": bs}),
                evals=np.asarray(evals))


def test_plas_training_queries_match_jax(plas):
    """The T queries in train mode, in order: the loss within 1e-5, the
    gradients within the per-leaf rule, the statistics as JAX's scan
    carries them (T updates)."""
    tm = _port(PLAS_KW, plas["variables"])
    wrap = exp_plas.TimeQueries(tm, T_Q).train()
    batch = {k: torch.from_numpy(v) for k, v in plas["batch"].items()}
    loss, _ = exp_plas.plas_loss(wrap(batch["pos"], batch["fx"]), batch)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    assert abs(float(loss.detach()) - plas["loss"]) <= FWD_RTOL * plas["loss"]
    _hold_grads(dict(zip(params, grads)), plas["grads"])
    _hold_stats(tm, plas["stats"], T_Q)


def test_plas_eval_is_one_forward_per_query(plas):
    """Eval: one forward per query against JAX's vmap within 1e-5, the
    statistics untouched; the ``B * T``-folded forward computes another
    function."""
    tm = _port(PLAS_KW, plas["variables"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    wrap = exp_plas.TimeQueries(tm, T_Q).eval()
    b = {k: torch.from_numpy(v) for k, v in plas["batch"].items()}
    with torch.inference_mode():
        out = wrap(b["pos"], b["fx"])                 # [B, T, N, 4]
        folded = tm(b["pos"].repeat(T_Q, 1, 1), b["fx"].repeat(T_Q, 1, 1),
                    torch.arange(T_Q, dtype=torch.float32).repeat_interleave(
                        B)[:, None])
    want = np.transpose(plas["evals"], (1, 0, 2, 3))
    assert _rel(out, want) <= FWD_RTOL
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    folded = folded.reshape(T_Q, B, -1, 4).transpose(0, 1)
    assert _rel(folded, want) > 100 * FWD_RTOL


def test_exp_ns_smoke_on_fixture(tmp_path, capsys, monkeypatch):
    """``exp_ns --smoke --device cpu`` on the NS fixture (16 x 16, 12
    frames; read through h5py), ``T_IN``/``T_OUT`` shrunk to 4/3 as the
    JAX driver's test shrinks them, with ``--export_rollout``: a finite
    ``rel_err``, JAX's metric keys, checkpoints, and the artifact's
    manifest; ``--accum_steps`` exits with JAX's message."""
    monkeypatch.setattr(exp_ns, "T_IN", T_IN)
    monkeypatch.setattr(exp_ns, "T_OUT", T_OUT)
    out_dir, art = tmp_path / "runs", str(tmp_path / "roll")
    rel = exp_ns.main(["--smoke", "--device", "cpu", "--data_path",
                       os.path.join(FIXT, "ns"), "--out_dir", str(out_dir),
                       "--ntrain", "3", "--ntest", "1",
                       "--export_rollout", art])
    out = capsys.readouterr().out
    assert "synthetic stand-in" not in out and np.isfinite(rel)
    assert f"rel_err:{rel}" in out and "rollout artifact ->" in out
    with open(out_dir / "ns_metrics.jsonl") as f:
        rec = [json.loads(ln) for ln in f]
    assert len(rec) == 2 and {"train/l2_step", "train/l2_full",
                              "val/l2_full", "epoch/time_seconds"} <= set(
        rec[0])
    for name in ("best", "last"):
        assert any(p.startswith(name) for p in
                   os.listdir(out_dir / "checkpoints" / "ns"))
    with open(os.path.join(art, "manifest.json")) as f:
        man = json.load(f)
    assert man["rollout_steps"] == T_OUT
    assert man["input_shapes"] == [[1, 256, 2], [1, 256, T_IN]]
    with pytest.raises(SystemExit, match="accum_steps is not supported"):
        exp_ns.main(["--smoke", "--device", "cpu", "--accum_steps", "2"])


def test_exp_plas_smoke_on_fixture(tmp_path, capsys):
    rel = exp_plas.main(["--smoke", "--device", "cpu", "--data_path",
                         os.path.join(FIXT, "plasticity"),
                         "--out_dir", str(tmp_path), "--ntrain", "2",
                         "--ntest", "1"])
    out = capsys.readouterr().out
    assert "synthetic stand-in" not in out and np.isfinite(rel)
    with open(tmp_path / "plas_metrics.jsonl") as f:
        rec = json.loads(f.readline())
    assert {"train/rel_l2", "val/rel_l2", "epoch/time_seconds"} <= set(rec)
    with pytest.raises(SystemExit, match="needs 2 devices"):
        exp_plas.main(["--smoke", "--device", "cpu", "--dp", "2",
                       "--data_path", os.path.join(FIXT, "plasticity")])


def test_micro_rollout_smoke():
    out = micro_rollout.run(rounds=1, steps=2, smoke=True, device="cpu")
    assert out["value_parity_max_abs"] <= 1e-5
    for k in ("rollout_artifact", "per_frame_loop"):
        assert all(np.isfinite(v) and v > 0 for v in out[k].values())
    assert out["dtype"] == "float32" and out["card"] is None
