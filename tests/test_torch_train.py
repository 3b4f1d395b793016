"""PyTorch port, the training step vs the JAX package.

* Adam + OneCycle: the port's learning rate and Adam beta1 at every step
  against ``haet_tpu.train.trainer.make_optimizer``'s injected schedules,
  over a normal horizon and a stretched one (rtol 1e-5: JAX's float32
  closed form against torch's float64 ``OneCycleLR``).
* torch's ``clip_grad_norm_`` against ``clip_by_global_norm_torch``.
* the car batch padding and loss against ``shapenet_car.pad_sample`` and
  ``benchmarks/car_train.py``.
* a small HAET (1 block, n_hidden 32, 4 heads, G 16, Erwin c_hidden (8, 16),
  depths 1/1/1) takes 3 ``Trainer.train_step``s with both kernel flags on
  and both off, against one run of ``haet_tpu.train.Trainer`` with the car
  loss and optimizer on one car-like sample of 200 points padded to 256,
  from the same numpy weights. The JAX run is built once for the module,
  on the model's plain path, which the JAX package's own tests hold to its
  Pallas kernels and their custom VJPs; the port's kernel paths are held
  to those in interpret mode in ``test_torch_slice.py``,
  ``test_torch_erwin.py`` and ``test_torch_grads.py``. Tolerances are
  stated at each check.
"""

import contextlib
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from haet_torch.data.shapenet_car import CarSample as TCarSample
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.train import Trainer, make_optimizer
from haet_torch.train import car as tcar
from haet_torch.utils.config import TrainConfig, shapenet_car_train_config
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.data import shapenet_car as jcar
from haet_tpu.models import HAETransolverIrregularMesh as JModel
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk
from haet_tpu.train import Trainer as JTrainer
from haet_tpu.train.trainer import TrainState, clip_by_global_norm_torch
from haet_tpu.train.trainer import make_optimizer as jax_make_optimizer
from haet_tpu.utils.config import TrainConfig as JTrainConfig
from haet_tpu.utils.config import shapenet_car_config as jax_car_config
from test_torch_model import init_like

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks")

MODEL = dict(space_dim=7, fun_dim=0, out_dim=4, n_layers=1, n_hidden=32,
             n_head=4, slice_num=16, mlp_ratio=2, enc_num_heads=(2, 4),
             enc_depths=(1, 1), dec_num_heads=(2,), dec_depths=(1,),
             erwin_mlp_ratio=4, embed=True, rotate=45)
N_POINTS, N_PAD, N_SURF = 200, 256, 40
STEPS, HORIZON = 3, 10
# BatchNorm rows: B*H = 4 clouds of G = 16 slice tokens; pooling (stride 2)
# normalises 4 * 8 = 32 rows, unpooling 4 * 16 = 64.
BN_ROWS = {"pool": 32, "unpool": 64}


@pytest.fixture(scope="module")
def car_train():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import car_train

    return car_train


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    modes = jsk.INTERPRET, jeb.INTERPRET
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET, jeb.INTERPRET = modes
    torch.set_num_threads(threads)


def test_train_config_matches_jax():
    """``TrainConfig`` is JAX's field for field with the same defaults, and
    the car preset equals JAX's field for field, ``early_stop_patience``
    (7) included."""
    jax_fields = {f.name: f.default for f in dataclasses.fields(JTrainConfig)}
    assert {f.name: f.default for f in dataclasses.fields(TrainConfig)} \
        == jax_fields
    port = dataclasses.asdict(shapenet_car_train_config())
    want = dataclasses.asdict(jax_car_config().train)
    assert port["early_stop_patience"] == want["early_stop_patience"] == 7
    assert port == want


@pytest.mark.parametrize("change,match", [
    (dict(optimizer="sgd"), "optimizer"),
    (dict(schedule="linear"), "schedule"),
    (dict(schedule="cosine"), "schedule"),
    (dict(accum_steps=0), "accum_steps"),
])
def test_unported_train_settings_raise(change, match):
    """Every optimizer, schedule and ``accum_steps`` of the JAX trainer
    runs (AdamW, ``cosine_annealing`` and ``constant`` included); what JAX
    refuses is refused."""
    cfg = dataclasses.replace(shapenet_car_train_config(), **change)
    with pytest.raises(ValueError, match=match):
        make_optimizer(cfg, 10, [torch.zeros(1, requires_grad=True)])


def test_mu_bf16_stores_the_first_moment_in_bf16():
    """``TrainConfig(mu_bf16=True)`` builds: Adam's first moments are bf16
    views of one buffer per group, the second moments and the parameters
    float32, and a step moves the parameters and rounds the stored moment
    from its float32 value."""
    cfg = dataclasses.replace(shapenet_car_train_config(), mu_bf16=True)
    params = [torch.nn.Parameter(torch.linspace(-1, 1, 6).reshape(2, 3)),
              torch.nn.Parameter(torch.ones(4))]
    opt, _ = make_optimizer(cfg, 10, params)
    mus = [opt.state[p]["exp_avg"] for p in params]
    assert [m.dtype for m in mus] == [torch.bfloat16] * 2
    assert mus[0].untyped_storage().data_ptr() == \
        mus[1].untyped_storage().data_ptr()
    assert {opt.state[p]["exp_avg_sq"].dtype for p in params} == \
        {torch.float32}
    before = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.full_like(p, 0.3)
    opt.step()
    beta1 = opt.param_groups[0]["betas"][0]
    want = (1 - torch.tensor(beta1, dtype=torch.float32)) * 0.3
    for p, m, b in zip(params, mus, before):
        assert torch.equal(m, want.to(torch.bfloat16).expand_as(m))
        assert not torch.equal(p.detach(), b)


@pytest.mark.parametrize("change", [dict(early_stop_patience=7),
                                    dict(checkpoint_every=1)],
                         ids=["early stopping", "checkpointing"])
def test_fit_settings_run(change, tmp_path):
    """Early stopping and periodic checkpoints no longer raise: the
    optimizer builds with each, and one ``fit`` epoch runs with it (one
    ``epoch_0`` save under ``checkpoint_every=1``)."""
    from haet_torch.train import Checkpointer, MetricsLogger

    cfg = dataclasses.replace(shapenet_car_train_config(), **change)
    make_optimizer(cfg, 10, [torch.zeros(1, requires_grad=True)])
    lin = torch.nn.Linear(3, 1)
    trainer = Trainer(lin, lambda out, b: (((out - b["y"]) ** 2).mean(), {}),
                      cfg, 4, batch_args=lambda b: (b["x"],))
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(8, 3).astype(np.float32),
             "y": rng.randn(8, 1).astype(np.float32)}
    ck = Checkpointer(str(tmp_path))
    recs = trainer.fit(lambda: [batch, batch], lambda: [batch], epochs=1,
                       logger=MetricsLogger(echo=False), checkpointer=ck)
    assert [r["epoch"] for r in recs] == [0] and trainer.step == 2
    assert np.isfinite(recs[0]["val/loss"])
    assert ck.periodic_epochs() == ([0] if "checkpoint_every" in change
                                    else [])


@pytest.mark.parametrize("total_steps", [20, 3])
def test_onecycle_matches_jax(total_steps):
    """Learning rate and beta1 of every step of the horizon; 3 steps is
    stretched to 4 on both sides (``pct_start * T <= 1``), with a warning."""
    cfg = shapenet_car_train_config()
    stretched = total_steps * cfg.pct_start <= 1
    with _stretch_warning(stretched):
        tx = jax_make_optimizer(jax_car_config().train, total_steps)
    p = torch.zeros(2, requires_grad=True)
    with _stretch_warning(stretched):
        opt, sched = make_optimizer(cfg, total_steps, [p])
    assert sched.total_steps == (4 if stretched else total_steps)
    params = {"w": jnp.zeros(2)}
    state = tx.init(params)
    update = jax.jit(tx.update)
    for _ in range(total_steps):
        _, state = update({"w": jnp.ones(2)}, state, params)
        hp = state[1].hyperparams
        group = opt.param_groups[0]
        np.testing.assert_allclose(group["lr"], float(hp["learning_rate"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(group["betas"][0], float(hp["b1"]),
                                   rtol=1e-5)
        p.grad = torch.ones(2)
        opt.step()
        sched.step()


def _stretch_warning(stretched):
    return (pytest.warns(UserWarning, match="stretched") if stretched
            else contextlib.nullcontext())


@pytest.mark.parametrize("scale", [3.0, 0.01])
def test_clip_matches_jax(scale):
    """torch's clip coefficient ``min(1, 1 / (norm + 1e-6))`` and the
    pre-clip norm, against the JAX copy, above and below the limit."""
    rng = np.random.RandomState(2)
    grads = {"a": scale * rng.randn(5, 3).astype(np.float32),
             "b": scale * rng.randn(7).astype(np.float32)}
    clip = clip_by_global_norm_torch(1.0)
    want, _ = clip.update(jax.tree_util.tree_map(jnp.asarray, grads),
                          clip.init(grads))
    params = []
    for g in grads.values():
        p = torch.zeros(g.shape, requires_grad=True)
        p.grad = torch.from_numpy(g.copy())
        params.append(p)
    norm = torch.nn.utils.clip_grad_norm_(params, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for p, k in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-9)


def _sample(n, seed=0):
    rng = np.random.RandomState(seed)
    surf = np.zeros(n, bool)
    surf[-min(N_SURF, n):] = True   # surface points come last in a car
    return (rng.rand(n, 3).astype(np.float32),
            rng.randn(n, 7).astype(np.float32),
            rng.randn(n, 4).astype(np.float32), surf)


@pytest.mark.parametrize("n", [200, 2048, 2500])
def test_car_pad_matches_jax(car_train, n):
    """Repeat-last padding, validity and surface masks, the bucket and the
    batch, equal to the JAX data layer and driver."""
    arrays = _sample(n, seed=n)
    sample = jcar.CarSample(*arrays)
    tsample = TCarSample(*arrays)
    assert tcar.bucket_size(n) == car_train.bucket_size(n)
    for n_pad in (tcar.bucket_size(n), 4096):
        for got, want in zip(tcar.pad_sample(tsample, n_pad),
                             jcar.pad_sample(sample, n_pad)):
            np.testing.assert_array_equal(got, want)
    got = tcar.make_batch(tsample)
    want = car_train.make_batch(sample)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="surface points"):
        tcar.pad_sample(tsample, n - 1)


def test_car_loss_matches_jax(car_train):
    batch = tcar.make_batch(TCarSample(*_sample(N_POINTS)), n_pad=N_PAD)
    out = np.random.RandomState(3).randn(1, N_PAD, 4).astype(np.float32)
    jl, jaux = car_train.loss_fn_builder(0.5)(jnp.asarray(out), batch)
    tl, taux = tcar.loss_fn_builder(0.5)(
        torch.from_numpy(out), {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def small():
    """One padded car-like batch and numpy weights for the small HAET (the
    init distributions perturbed by 0.05 N(0, 1), BatchNorm statistics moved
    off (0, 1)). The pooling projection is scaled by 10, so that the
    features its BatchNorm sees have a batch variance large enough for the
    biased and unbiased running-variance updates to differ well beyond the
    test's rtol (at the init scale they differ by ~2e-6 there; the
    unpooling's BatchNorm sees enough variance as it is)."""
    rng = np.random.RandomState(0)
    batch = tcar.make_batch(TCarSample(*_sample(N_POINTS)), n_pad=N_PAD)
    template = jax.eval_shape(JModel(**MODEL).init, jax.random.PRNGKey(0),
                              batch["x"])
    variables = init_like(template, rng, MODEL["n_hidden"])

    def scale(path, leaf):
        keys = {getattr(k, "key", None) for k in path}
        return leaf * 10 if {"pool", "proj"} <= keys else leaf

    return batch, {"params": jax.tree_util.tree_map_with_path(
        scale, variables["params"]),
        "batch_stats": variables["batch_stats"]}


def _leaves(tree):
    return {k: v.numpy() for k, v in from_jax_variables(tree).items()
            if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def jax_run(small, car_train):
    """The JAX side, once: step 1's gradients and their global norm, the
    losses of 3 steps, the BatchNorm statistics after step 1 and the
    parameters after step 3."""
    batch, variables = small
    jm = JModel(**MODEL)
    jcfg = JTrainConfig(lr=1e-3, optimizer="adam", final_div_factor=1000.0,
                        batch_size=1, max_grad_norm=1.0)
    jtr = JTrainer(model=jm, loss_fn=car_train.loss_fn_builder(0.5),
                   cfg=jcfg, total_steps=HORIZON,
                   batch_args=lambda b: (b["x"], None))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtr.tx.init(variables["params"]))
    key = jax.random.PRNGKey(1)

    def loss(params):
        out, _ = jtr._apply(params, state.batch_stats, batch, True, key)
        return jtr.loss_fn(out, batch)[0]

    jgrads = jax.jit(jax.grad(loss))(state.params)
    jlosses = []
    for step in range(STEPS):
        state, metrics = jtr.train_step(state, batch, key)
        jlosses.append(float(metrics["loss"]))
        if step == 0:
            jstats = _leaves({"batch_stats":
                              jax.device_get(state.batch_stats)})
    return dict(grads=jgrads, norm=float(optax.global_norm(jgrads)),
                losses=jlosses, stats=jstats,
                params=_leaves({"params": jax.device_get(state.params)}))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_small_haet_trains_like_jax(small, jax_run, use_pallas):
    batch, variables = small
    jgrads, jnorm, jlosses = (jax_run["grads"], jax_run["norm"],
                              jax_run["losses"])
    jstats, jparams = jax_run["stats"], jax_run["params"]

    tm = TModel(**MODEL, use_pallas=use_pallas, use_pallas_erwin=use_pallas,
                device="cpu")
    load_jax_variables(tm, variables)
    start = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    trainer = Trainer(tm, tcar.loss_fn_builder(0.5),
                      shapenet_car_train_config(), HORIZON,
                      batch_args=lambda b: (b["x"], None))
    lrs = []
    for step in range(STEPS):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        m = trainer.train_step(batch)
        tag = f"use_pallas={use_pallas} step {step + 1}"
        # float32 through 1 layer and 3 Erwin blocks, sums in other orders
        np.testing.assert_allclose(float(m["loss"]), jlosses[step],
                                   rtol=1e-5, err_msg=tag)
        if step == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), jnorm,
                                       rtol=1e-5)
            _check_step1_grads(tm, jgrads, min(1.0, 1.0 / (jnorm + 1e-6)),
                               tag)
            _check_batch_stats(tm, start, jstats, tag)

    # Adam's first steps move an entry by about +-lr whatever its gradient's
    # size, so a near-zero gradient whose sign differs by round-off moves
    # it by up to 2 lr per step: the bound is 2 * (sum of the 3 steps' lr).
    bound = 2 * sum(lrs)
    worst = 0.0
    for name, p in tm.named_parameters():
        err = float(np.abs(p.detach().numpy() - jparams[name]).max())
        worst = max(worst, err)
        assert err <= bound, (name, err, bound)
        if name.endswith("sigma_att"):   # no gradient: never moved
            np.testing.assert_array_equal(p.detach().numpy(),
                                          start[name].numpy())
            np.testing.assert_array_equal(jparams[name],
                                          start[name].numpy())
    print(f"PARITY small HAET use_pallas={use_pallas}: params after "
          f"{STEPS} steps max_abs_err {worst:.3e} (bound {bound:.3e})")


def _check_step1_grads(tm, jgrads, coef, tag):
    """Step 1's (clipped) gradients leaf by leaf: each within 1e-3 of its
    max |JAX gradient| (float32 through a whole forward and backward in two
    frameworks, amplified by train-mode BatchNorm over 32 rows: measured up
    to 3.4e-4, with either flag setting), or 1e-5 of
    the model's largest |gradient| for leaves whose gradient is zero up to
    round-off (biases in front of a train-mode BatchNorm: ~1e-6 of the
    largest |gradient| of noise on both sides)."""
    want = {k: v * coef for k, v in _leaves({"params": jgrads}).items()}
    gmax = max(float(np.abs(v).max()) for v in want.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        if name.endswith("sigma_att"):
            assert p.grad is None, name
            assert not want[name].any()
            continue
        err = float(np.abs(p.grad.numpy() - want[name]).max())
        scale = float(np.abs(want[name]).max())
        assert err <= max(1e-3 * scale, 1e-5 * gmax), (tag, name, err,
                                                       scale)
        if scale > 1e-4 * gmax:
            worst = max(worst, err / scale)
    print(f"PARITY small HAET {tag} grads: largest error over a leaf's "
          f"max |grad| {worst:.3e}")


def _check_batch_stats(tm, start, jstats, tag):
    """BatchNorm running statistics after one step at rtol 1e-5, where
    torch's own update (unbiased variance, rows / (rows - 1)) would miss
    the running variance by more than ten times that."""
    sd = tm.state_dict()
    for name, want in jstats.items():
        got = sd[name].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=tag + name)
        if name.endswith("running_var"):
            rows = BN_ROWS["unpool" if ".unpool." in name else "pool"]
            batch_var = (got - 0.9 * start[name].numpy()) / 0.1
            unbiased = (0.9 * start[name].numpy()
                        + 0.1 * batch_var * rows / (rows - 1))
            assert np.abs(unbiased - want).max() > 10 * 1e-5 * np.abs(
                want).max(), name
