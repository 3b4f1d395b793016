"""PyTorch port, the GPipe pipeline (``haet_torch/parallel/pipeline.py``).

One gloo group of four CPU ranks (spawned once for the module with the
harness of ``tests/test_torch_parallel.py``) runs every case
(:data:`CASES`) and returns numpy results; each test asserts its own. The
model is the JAX pipeline test's (``tests/test_pipeline.py:24-30``: 4
blocks, n_hidden 32, 4 heads, G 16, mlp_ratio 1, rotate 45) on a batch of
4 samples of 64 points, its weights numpy variables crossed over by
``haet_torch/utils/weights.py``.

References:

* JAX's ``PipelinedModel`` on a ``(dp 2, pp 2)`` mesh of the host devices
  that ``tests/conftest.py`` forces, two programs built once: the eval
  forward at M 2, held within ``RTOL`` (1e-4) of max |out|; a train-mode
  forward with its BatchNorm statistics and ``jax.grad`` of ``mean((out -
  y)^2)`` at M 2: the output within ``RTOL``, the gradients leaf by leaf
  within 1e-3 of the leaf's max |gradient| or 1e-5 of the largest, the
  running statistics at rtol 1e-5 (the tolerances of
  ``tests/test_torch_parallel.py``). The port's pipeline and JAX's take
  the pseudo-positions' min-max and the BatchNorm statistics per
  (microbatch x dp shard), so they meet where the unpipelined model does
  not;
* the unpipelined port model in this process: at M 1 on a mesh without dp,
  the pipeline equals it within ``MESH_RTOL`` (rtol 1e-5, atol 1e-6 of the
  largest |value|), gradients and statistics included.
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_parallel import (MESH_RTOL, RTOL, assert_mesh_close,
                                 case_result, run_cases, start_ranks)

from haet_torch import parallel
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.parallel.pipeline import (PipelinedModel, merge_raw_variables,
                                          merge_variables, split_variables)

MODEL = dict(space_dim=3, fun_dim=1, out_dim=2, n_hidden=32, n_layers=4,
             n_head=4, slice_num=16, mlp_ratio=1, rotate=45)
B, N = 4, 64


def batch(n_batch=B, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(n_batch, N, d), dtype=torch.float32)
                 for d in (3, 1, 2))


def build(state, **extra):
    m = TModel(**MODEL, device="cpu", **extra)
    m.load_state_dict(state)
    return m


def pipe(state, mesh, m=2, dp=True, model_kw=None, **kw):
    return PipelinedModel(build(state, **(model_kw or {})), mesh,
                          num_microbatches=m,
                          dp_axis="dp" if dp else None, **kw)


def pipe_run(pm, x, fx, y, train=True):
    """``{"out", "grads", "stats"}`` of a forward (and, in train mode, the
    gradients of ``mean((out - y)^2)`` reduced as the trainer reduces
    them), every stage's layers gathered: the stacked layout."""
    pm.train(train)
    if not train:
        with torch.no_grad():
            return {"out": pm(x, fx).numpy()}
    out = pm(x, fx)
    loss = ((out - y) ** 2).mean()
    named = [(k, p) for k, p in pm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    live = [(k, p, g) for (k, p), g in zip(named, grads) if g is not None]
    flat = torch.cat([g.reshape(-1) for _, _, g in live])
    pm.reduce_gradients(flat, [p for _, p, _ in live])
    parts = flat.split([g.numel() for _, _, g in live])
    full = {k: (pm.gather_stages(t.view_as(g)) if k.startswith("layers.")
                else t.view_as(g)).numpy()
            for (k, _, g), t in zip(live, parts)}
    stats = {k: v.numpy() for k, v in pm.full_state_dict().items()
             if "running" in k}
    return {"out": out.detach().numpy(), "grads": full, "stats": stats}


def plain_run(model, x, fx, y):
    """The unpipelined model's train run, in the stacked layout."""
    model.train()
    out = model(x, fx)
    loss = ((out - y) ** 2).mean()
    named = [(k, p) for k, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    g = {k: v for (k, _), v in zip(named, grads) if v is not None}
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return {"out": out.detach().numpy(),
            "grads": {k: v.numpy() for k, v in
                      split_variables(g, MODEL["n_layers"]).items()},
            "stats": {k: v.numpy() for k, v in
                      split_variables(stats, MODEL["n_layers"]).items()}}


# -- the cases the ranks run ----------------------------------------------

def _eval_dp2pp2(rank, p):
    mesh = parallel.make_pp_mesh(2, 2)
    return pipe_run(pipe(p["state"], mesh), *batch(), train=False)


def _train_dp2pp2(rank, p):
    return pipe_run(pipe(p["state"], parallel.make_pp_mesh(2, 2)), *batch())


def _pp2_m1(rank, p):
    """pp 2, M 1, without dp (the tp axis of the mesh unused: its two
    ranks run the same work)."""
    mesh = parallel.make_pp_mesh(1, 2, 2)
    return pipe_run(pipe(p["state"], mesh, m=1, dp=False), *batch())


def _pp2_tp2(rank, p):
    mesh = parallel.make_pp_mesh(1, 2, 2)
    return pipe_run(pipe(p["state"], mesh, m=1, dp=False,
                         model_kw={"shard_axes": (None, "tp")}), *batch())


def _pp2_tp2_kernels(rank, p):
    """pp 2 x tp 2 with both kernel flags (their plain versions on the
    CPU): JAX refuses them inside its pipeline, the port runs them."""
    mesh = parallel.make_pp_mesh(1, 2, 2)
    return pipe_run(pipe(p["state"], mesh, m=1, dp=False, model_kw={
        "shard_axes": (None, "tp"), "use_pallas": True,
        "use_pallas_erwin": True}), *batch())


def _padding(rank, p):
    """A batch of 3, and the same rows padded by hand as the pipeline pads
    them (wraparound: rows 0, 1, 2, 0)."""
    mesh = parallel.make_pp_mesh(2, 2)
    pm = pipe(p["state"], mesh)
    x, fx, _ = batch(3)
    rows = [0, 1, 2, 0]
    return {"out": pipe_run(pm, x, fx, None, train=False)["out"],
            "by_hand": pipe_run(pm, x[rows], fx[rows], None,
                                train=False)["out"][:3]}


def _dropout(rank, p):
    """The same masks whatever the stage count: pp 2 and pp 4 at M 2."""
    out = {}
    for name, mesh_args in (("pp2", (1, 2, 2)), ("pp4", (1, 4))):
        mesh = parallel.make_pp_mesh(*mesh_args)
        pm = pipe(p["state"], mesh, dp=False,
                  model_kw={"dropout": 0.1, "seed": 5})
        out[name] = pipe_run(pm, *batch())["out"]
    out["no_dropout"] = pipe_run(pipe(p["state"], mesh, dp=False),
                                 *batch())["out"]
    return out


def _remat(rank, p):
    mesh = parallel.make_pp_mesh(1, 2, 2)
    return {str(r): pipe_run(pipe(p["state"], mesh, dp=False, remat=r),
                             *batch())["grads"] for r in (True, False)}


def _message(fn) -> np.ndarray:
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("")


def _validations(rank, p):
    """JAX's checks (``pipeline.py:178-247``), on the port's meshes."""
    pp = parallel.make_pp_mesh(2, 2)
    tp = parallel.make_pp_mesh(1, 2, 2)
    plain = parallel.make_mesh(4, 1)

    def model(**kw):
        return TModel(**{**MODEL, **kw}, device="cpu")

    return {
        "layers": _message(lambda: PipelinedModel(model(n_layers=3), pp)),
        "no_pp": _message(lambda: PipelinedModel(model(), plain)),
        "no_dp": _message(lambda: PipelinedModel(model(), pp,
                                                 dp_axis="nope")),
        "micro": _message(lambda: PipelinedModel(model(), pp,
                                                 num_microbatches=-1)),
        "head_missing": _message(lambda: PipelinedModel(
            model(shard_axes=("dp", "tp")), pp, dp_axis="dp")),
        "collides": _message(lambda: PipelinedModel(
            model(shard_axes=(None, "pp")), tp)),
        "not_in_mesh": _message(lambda: PipelinedModel(
            model(shard_axes=(None, "nope")), tp)),
        "heads": _message(lambda: PipelinedModel(
            model(n_head=3, n_hidden=33, shard_axes=(None, "tp")), tp)),
        "batch_axis": _message(lambda: PipelinedModel(
            model(shard_axes=("other", "tp")), tp, dp_axis=None)),
        "mesh_size": _message(lambda: parallel.make_pp_mesh(2, 3)),
    }


def _trainer(model, mesh, **cfg_kw):
    from haet_torch.train import Trainer
    from haet_torch.utils.config import TrainConfig

    cfg = TrainConfig(lr=1e-3, max_grad_norm=0.5, **cfg_kw)
    return Trainer(model, lambda out, b: (((out - b["y"]) ** 2).mean(), {}),
                   cfg, total_steps=8, mesh=mesh)


def trainer_batch(seed=0):
    x, fx, y = batch(seed=seed)
    return {"x": x.numpy(), "fx": fx.numpy(), "y": y.numpy()}


def trainer_state(tr) -> dict:
    """The trainer's state (every stage's stacks): the model's tensors and
    Adam's first moments by parameter name."""
    state = tr.state_dict()
    names = [k for k, p in tr.model.named_parameters() if p.requires_grad]
    return {"model": {k: v.numpy() for k, v in state["model"].items()},
            "m": {names[i]: st["exp_avg"].numpy() for i, st in
                  state["optimizer"]["state"].items()}}


def _trainer_steps(rank, p):
    """Trainer over pp 2 at M 1 (mesh (1, 2, 2)): a step, ``train_steps``
    of two and ``accum_steps`` 2, the metrics and the gathered state."""
    mesh = parallel.make_pp_mesh(1, 2, 2)
    out = {}
    for name, kw in (("step", {}), ("accum", {"accum_steps": 2})):
        tr = _trainer(pipe(p["state"], mesh, m=1, dp=False), mesh, **kw)
        m = tr.train_step(trainer_batch())
        ms = tr.train_steps([trainer_batch(1), trainer_batch(2)])
        out[name] = {"loss": np.array([float(m["loss"]),
                                       *ms["loss"].tolist()]),
                     "grad_norm": np.array([float(m["grad_norm"]),
                                            *ms["grad_norm"].tolist()]),
                     **trainer_state(tr)}
    return out


def _resume(rank, p):
    """A checkpoint at pp 2 (dp 2), resumed at the same flags, equals the
    run that went on; resumed across layouts, JAX's message."""
    from haet_torch.train import Checkpointer

    mesh = parallel.make_pp_mesh(2, 2)
    root = p["root"]
    whole = _trainer(pipe(p["state"], mesh), mesh)
    for s in range(2):
        whole.train_step(trainer_batch(s))
    first = _trainer(pipe(p["state"], mesh), mesh)
    first.train_step(trainer_batch(0))
    ck = Checkpointer(os.path.join(root, "pp"))
    ck.save_last(first.state_dict(), 0)
    second = _trainer(pipe(p["state"], mesh), mesh)
    second.maybe_restore(ck)
    second.train_step(trainer_batch(1))
    out = {"whole": trainer_state(whole), "resumed": trainer_state(second)}
    plain = _trainer(build(p["state"]), None)
    try:
        plain.maybe_restore(ck)
        out["to_plain"] = np.array("")
    except RuntimeError as e:
        out["to_plain"] = np.array(str(e))
    ck_plain = Checkpointer(os.path.join(root, "plain"))
    ck_plain.save_last(plain.state_dict(), 0)
    try:
        _trainer(pipe(p["state"], mesh), mesh).maybe_restore(ck_plain)
        out["to_pp"] = np.array("")
    except RuntimeError as e:
        out["to_pp"] = np.array(str(e))
    return out


def _driver(rank, p):
    """``car_train --dp 2 --pp 2`` for one epoch on the four ranks."""
    from haet_torch.benchmarks import car_train

    metrics = car_train.main(["--smoke", "--dp", "2", "--pp", "2",
                              "--device", "cpu", "--prefetch", "0",
                              "--out_dir", os.path.join(p["root"], "car")])
    return {k: np.array(v) for k, v in metrics.items()
            if isinstance(v, float) and k != "time_per_sample"}


CASES = {"eval_dp2pp2": _eval_dp2pp2, "train_dp2pp2": _train_dp2pp2,
         "pp2_m1": _pp2_m1, "pp2_tp2": _pp2_tp2,
         "pp2_tp2_kernels": _pp2_tp2_kernels, "padding": _padding,
         "dropout": _dropout, "remat": _remat, "validations": _validations,
         "trainer": _trainer_steps, "resume": _resume, "driver": _driver}


def _rank_cases(rank, payload):
    torch.manual_seed(0)
    return run_cases(CASES, rank, payload)


# -- the fixtures ----------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX model, numpy variables of its shape (``init_like``) and the
    ranks' payload: the port's state dict of the same weights and a
    directory for their files."""
    import jax

    from haet_tpu.models import HAETransolverIrregularMesh as JModel
    from haet_torch.utils.weights import from_jax_variables
    from test_torch_model import init_like

    x, fx, _ = (t.numpy() for t in batch())
    jm = JModel(**MODEL)
    v = init_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, fx),
                  np.random.RandomState(3), MODEL["n_hidden"])
    root = str(tmp_path_factory.mktemp("pipeline"))
    return dict(jm=jm, v=v, payload=dict(state=from_jax_variables(v),
                                         root=root))


@pytest.fixture(scope="module")
def started(weights):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    collect = start_ranks(_rank_cases, weights["payload"], timeout=300)
    yield collect
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(weights, started):
    """JAX's pipeline on a (dp 2, pp 2) mesh: the eval forward and the
    train-mode forward, statistics and gradients, at M 2, converted to
    the port's stacked layout."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from haet_tpu.parallel import PipelinedModel as JPipelined
    from haet_torch.utils.weights import from_jax_pipeline_variables

    jm, v = weights["jm"], weights["v"]
    x, fx, y = (t.numpy() for t in batch())
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "pp"))
    pm = JPipelined(jm, mesh, num_microbatches=2, dp_axis="dp")
    pv = pm.to_pipeline_variables(v)
    with mesh:
        out = jax.jit(lambda v, a, b: pm.apply(v, a, b))(pv, x, fx)

        def loss(params):
            o, upd = pm.apply({"params": params,
                               "batch_stats": pv["batch_stats"]}, x, fx,
                              train=True, mutable=["batch_stats"])
            return jnp.mean((o - y) ** 2), (o, upd)

        (_, (tout, upd)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(pv["params"])
    grads, upd = jax.device_get((grads, upd))
    conv = from_jax_pipeline_variables(
        {"params": grads, "batch_stats": upd["batch_stats"]})
    return dict(
        eval=np.asarray(out), out=np.asarray(tout),
        grads={k: t.numpy() for k, t in conv.items()
               if "running" not in k and "num_batches" not in k},
        stats={k: t.numpy() for k, t in conv.items() if "running" in k},
        pvars=jax.device_get(pv))


@pytest.fixture(scope="module")
def ranks(started, jax_side):
    return started()


@pytest.fixture(scope="module")
def plain(weights):
    """The unpipelined port model's train run and its eval forward at a
    batch of 3."""
    state = weights["payload"]["state"]
    x, fx, _ = batch(3)
    m = build(state).eval()
    with torch.no_grad():
        three = m(x, fx).numpy()
    return dict(train=plain_run(build(state), *batch()), three=three)


def _against_jax_grads(got: dict, want: dict):
    gmax = max(float(np.abs(v).max()) for v in want.values())
    for k, w in want.items():
        if k.endswith("sigma_att"):
            assert k not in got and not w.any(), k
            continue
        err = float(np.abs(got[k] - w).max())
        assert err <= max(1e-3 * float(np.abs(w).max()), 1e-5 * gmax), (
            k, err)


# -- the layout helpers ---------------------------------------------------

def test_split_merge_round_trip_and_jax_layout(weights, jax_side):
    """``split_variables``/``merge_variables`` round-trip a state dict bit
    for bit, stack every block leaf on ``[L]`` and put the last block's
    ``ln_3``/``mlp2`` in ``head``; the port's stacked layout of JAX's
    weights equals JAX's ``split_variables`` converted through
    ``weights.py`` leaf by leaf, and ``merge_raw_variables`` of a
    checkpoint infers L."""
    from haet_torch.utils.weights import from_jax_pipeline_variables

    state = weights["payload"]["state"]
    L = MODEL["n_layers"]
    pv = split_variables(state, L)
    assert all(pv[k].shape[0] == L for k in pv if k.startswith("layers."))
    assert {k.split(".")[1] for k in pv if k.startswith("head.")} == {
        "ln_3", "mlp2"}
    back = merge_variables(pv, L)
    assert set(back) == set(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k
    converted = from_jax_pipeline_variables(jax_side["pvars"])
    assert set(converted) == set(pv)
    for k in pv:
        assert torch.equal(converted[k], pv[k]), k
    raw = merge_raw_variables({"model": {k: v.numpy() for k, v in
                                         pv.items()}})
    assert all(np.array_equal(raw[k], state[k]) for k in state)
    with pytest.raises(ValueError, match="not a stacked pipeline checkpoint"):
        merge_raw_variables({"model": state})


def test_model_hooks_restate_forward(weights):
    """``apply_pre``, the blocks and ``apply_head`` run apart equal the
    model's ``forward``, with the placeholder, ``unified_pos`` and
    ``Time_Input`` paths; ``block_kwargs`` build a block of the model's
    parameter names."""
    from haet_torch.models.haet import TransolverErwinBlock

    x, fx, _ = batch()
    T = torch.rand(B, 1)
    for kw in ({}, {"unified_pos": True, "ref": 4}, {"Time_Input": True}):
        m = TModel(**MODEL, device="cpu", **kw).eval()
        args = (x, fx, T) if kw.get("Time_Input") else (x, fx)
        with torch.no_grad():
            want = m(*args)
            got = _stack_then_head(m, *args)
        assert torch.equal(got, want), kw
    blk = TransolverErwinBlock(last_layer=False, **m.block_kwargs())
    names = {k.split(".", 2)[2] for k in m.state_dict()
             if k.startswith("blocks.0.")}
    assert set(blk.state_dict()) == names


def _stack_then_head(m, *args):
    """The model as the pipeline runs it: ``apply_pre``, every block
    without the last one's head, then ``apply_head``."""
    h = m.apply_pre(*args)
    for blk in m.blocks:
        if blk.last_layer:
            h = blk.Attn(blk._ln(blk.ln_1, h)) + h
            h = blk.mlp(blk._ln(blk.ln_2, h)) + h
        else:
            h = blk(h)
    return m.apply_head(h)


# -- against JAX's PipelinedModel -----------------------------------------

def test_eval_matches_jax_pipeline_dp2_pp2(ranks, jax_side):
    """(dp 2, pp 2), M 2, eval: every rank returns the global output,
    within ``RTOL`` of JAX's pipeline."""
    got = case_result(ranks, "eval_dp2pp2")["out"]
    err = float(np.abs(got - jax_side["eval"]).max())
    assert err <= RTOL * float(np.abs(jax_side["eval"]).max()), err


def test_train_matches_jax_pipeline_dp2_pp2(ranks, jax_side):
    """(dp 2, pp 2), M 2, train mode with BatchNorm: the output, every
    gradient (summed over dp, the embedding's over pp, every stage's
    layers gathered) and the running statistics (chained over each
    stage's microbatches, averaged over dp) against JAX's pipeline."""
    got = case_result(ranks, "train_dp2pp2")
    err = float(np.abs(got["out"] - jax_side["out"]).max())
    assert err <= RTOL * float(np.abs(jax_side["out"]).max()), err
    _against_jax_grads(got["grads"], jax_side["grads"])
    assert set(got["stats"]) == set(jax_side["stats"])
    for k, w in jax_side["stats"].items():
        np.testing.assert_allclose(got["stats"][k], w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()),
                                   err_msg=k)


# -- against the port itself -----------------------------------------------

@pytest.mark.parametrize("name", ["pp2_m1", "pp2_tp2", "pp2_tp2_kernels"])
def test_pipeline_equals_unpipelined_at_m1(ranks, plain, name):
    """pp 2 at M 1 without dp, heads whole or split over tp (with the
    kernel flags too): the output, the gradients and the BatchNorm
    statistics of the unpipelined model within ``MESH_RTOL``."""
    got = case_result(ranks, name)
    for k in ("out", "grads", "stats"):
        assert_mesh_close(got[k], plain["train"][k], f"{name} {k}")


def test_partial_batch_padding(ranks, plain):
    """A batch of 3 on (dp 2, pp 2) at M 2: padded to 4 with a wraparound
    copy, the pad row sliced off, bit for bit the batch padded by hand;
    within ``RTOL`` of the plain model's output on the real rows (the
    min-max per microbatch and dp shard moves it, as in JAX)."""
    got = case_result(ranks, "padding")
    assert got["out"].shape == plain["three"].shape
    np.testing.assert_array_equal(got["out"], got["by_hand"])
    err = float(np.abs(got["out"] - plain["three"]).max())
    assert err <= RTOL * float(np.abs(plain["three"]).max()), err


def test_dropout_masks_invariant_to_stage_count(ranks):
    """Dropout 0.1 at M 2: pp 2 and pp 4 draw the same masks from the
    model's generator (every layer's and microbatch's, in one order), so
    their outputs agree; and the masks drop something."""
    got = case_result(ranks, "dropout")
    np.testing.assert_allclose(got["pp2"], got["pp4"], rtol=1e-6, atol=0)
    assert float(np.abs(got["pp2"] - got["no_dropout"]).max()) > 1e-3


def test_remat_matches_no_remat(ranks):
    """``remat=True`` (each block recomputed in the backward, its masks
    and statistics kept) gives the gradients of ``remat=False``."""
    got = case_result(ranks, "remat")
    assert_mesh_close(got["True"], got["False"], "remat")


# -- the trainer, errors and drivers ----------------------------------------

def test_trainer_steps_accum_and_scan(ranks, weights):
    """``Trainer(PipelinedModel)`` at pp 2, M 1: a step and
    ``train_steps`` of two, with ``accum_steps`` 1 and 2, equal the
    unpipelined trainer's losses, gradient norms (the whole model's, all
    stages) and Adam's first moments (linear in the clipped gradients),
    within ``MESH_RTOL``. The parameters are not compared: a parameter
    whose gradient is float noise (a bias before a BatchNorm) moves by
    Adam's normalised noise."""
    got = case_result(ranks, "trainer")
    state = weights["payload"]["state"]
    for name, kw in (("step", {}), ("accum", {"accum_steps": 2})):
        tr = _trainer(build(state), None, **kw)
        m = tr.train_step(trainer_batch())
        ms = tr.train_steps([trainer_batch(1), trainer_batch(2)])
        for k in ("loss", "grad_norm"):
            want = np.array([float(m[k]), *ms[k].tolist()])
            np.testing.assert_allclose(got[name][k], want, rtol=MESH_RTOL,
                                       err_msg=f"{name} {k}")
        m = split_variables(trainer_state(tr)["m"], MODEL["n_layers"])
        assert_mesh_close(got[name]["m"],
                          {k: np.asarray(v) for k, v in m.items()},
                          f"{name} first moments")


def test_resume_exact_and_across_layouts(ranks):
    """A pp checkpoint (every stage's stacks, written by rank 0) resumed
    at the same flags gives the state of the run that went on, bit for
    bit; resuming it unpipelined, or a plain one pipelined, raises JAX's
    message."""
    got = case_result(ranks, "resume")
    for part in ("model", "m"):
        for k, w in got["whole"][part].items():
            np.testing.assert_array_equal(got["resumed"][part][k], w,
                                          err_msg=k)
    assert "by a --pp run cannot resume an unpipelined run" in str(
        got["to_plain"])
    assert "without --pp cannot resume a --pp run" in str(got["to_pp"])


def test_validations_raise_jax_messages(ranks):
    """Each check of JAX's ``PipelinedModel`` (bar the kernel flags, which
    the port runs) and of ``make_pp_mesh`` raises JAX's message."""
    got = {k: str(v) for k, v in case_result(ranks, "validations").items()}
    assert "must be divisible by the pipeline stage count" in got["layers"]
    assert "mesh has no 'pp' axis" in got["no_pp"]
    assert "mesh has no 'nope' axis" in got["no_dp"]
    assert "num_microbatches must be >= 1" in got["micro"]
    assert "head axis 'tp' is not in the mesh" in got["head_missing"]
    assert "collides" in got["collides"]
    assert "'nope' is not in the mesh" in got["not_in_mesh"]
    assert re.search(r"n_head \(3\) must be divisible by the tp mesh size",
                     got["heads"])
    assert "batch axis 'other'" in got["batch_axis"]
    assert got["mesh_size"] == "dp(2) * pp(3) * tp(1) != device count (4)"


def test_car_train_pp_then_car_eval(ranks, weights):
    """``car_train --smoke --dp 2 --pp 2`` (one layer a stage) trains and
    evaluates on the four ranks, each printing the same metrics;
    ``car_eval`` converts its stacked checkpoint and reproduces them."""
    from haet_torch.benchmarks import car_eval

    got = case_result(ranks, "driver")
    ckpt = os.path.join(weights["payload"]["root"], "car", "checkpoints",
                        "car")
    metrics = car_eval.main(["--smoke", "--n_hidden", "32", "--n_layers",
                             "2", "--slice_num", "16", "--which", "last",
                             "--checkpoint_dir", ckpt, "--device", "cpu"])
    for k in ("rel_l2_press", "rel_l2_velo"):
        np.testing.assert_allclose(metrics[k], float(got[k]), rtol=1e-5,
                                   err_msg=k)


def test_micro_pipeline_tax_on_the_cpu(capsys):
    """``micro_pipeline_tax`` as plumbing at a toy size, in a world of one
    made for it: the four variants' lines, each with a finite ms/step, the
    plain line at x1.000, and no process group left behind."""
    from haet_torch.benchmarks import micro_pipeline_tax

    try:
        out = micro_pipeline_tax.main(["--device", "cpu", "--points", "128",
                                       "--n_hidden", "32", "--n_layers",
                                       "2", "--rounds", "1", "--k_lo", "1",
                                       "--k_hi", "2"])
    finally:
        torch.distributed.destroy_process_group()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ms/step" in ln]
    assert [ln.split()[0] for ln in lines] == list(
        micro_pipeline_tax.VARIANTS)
    assert "(x1.000 vs plain)" in lines[0]
    assert all(np.isfinite(r["ms_per_step"]) and r["graph_ms_per_step"] is None
               for r in out.values())
