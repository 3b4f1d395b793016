"""PyTorch port, ``Trainer(mesh=...)`` and the drivers' mesh flags.

Counterpart of ``tests/test_trainer_mesh.py``: one gloo group of four CPU
ranks (the harness of ``tests/test_torch_parallel.py``, spawned once for
the module, importing only the port) runs every case and returns numpy
results; each test asserts its own case. The model is that file's (one
block, n_hidden 32, 4 heads, G 16, rotate 0) on a batch of 8 samples of 64
points, ``mean((out - y)^2)``, Adam at a constant 1e-3, clipping at 1.0.

References:

* JAX's single-device ``Trainer``, two steps from the same numpy weights
  (one ``jax.jit`` of its step, no JAX mesh). The port against JAX: losses
  and the gradient norm at rtol 1e-5, the parameters after two steps
  through the no-signal mask below (the port's one-rank gradient norms
  marking the leaves without signal);
* the port's one-rank ``Trainer`` in this process: losses and gradient
  norms at rtol 1e-5, the per-leaf gradient norms at rtol 1e-5 / atol 1e-6
  (``tests/test_trainer_mesh.py``'s gradient tolerance), the parameters
  after Adam
  through ``tests/test_trainer_mesh.py:_assert_params_close``'s no-signal
  mask (rtol 1e-4, atol 2e-5; 1e-2 on a leaf whose gradient is below
  1e-6); every rank bitwise equal to the others.
"""

import json
import os

import numpy as np
import pytest
import torch

from haet_torch import parallel
from haet_torch.data.shapenet_car import CarSample
from haet_torch.train import Checkpointer, MetricsLogger, Trainer
from haet_torch.train import car as tcar
from haet_torch.utils.config import ModelConfig, TrainConfig
from test_torch_parallel import case_result, run_cases, start_ranks

MODEL = dict(variant="irregular", space_dim=3, fun_dim=1, out_dim=1,
             n_layers=1, n_hidden=32, n_head=4, slice_num=16, rotate=0)
B, N, LR = 8, 64, 1e-3
CAR = dict(variant="irregular", space_dim=7, fun_dim=0, out_dim=4,
           n_layers=1, n_hidden=32, n_head=4, slice_num=16, rotate=0)
#: valid points of each car-like sample (ragged), padded to 256
CAR_POINTS = (256, 100, 180, 40)


def train_cfg(accum=1) -> TrainConfig:
    return TrainConfig(lr=LR, epochs=1, batch_size=B, schedule="constant",
                       weight_decay=0.0, max_grad_norm=1.0,
                       accum_steps=accum)


def mse(out, b):
    return ((out - b["y"]) ** 2).mean(), {}


def data(seed=0, n_batch=B):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n_batch, N, 3).astype(np.float32),
            "fx": rng.randn(n_batch, N, 1).astype(np.float32),
            "y": rng.randn(n_batch, N, 1).astype(np.float32)}


def make_trainer(state, mesh=None, shard=None, accum=1, cfg=MODEL,
                 loss=mse, batch_args=lambda b: (b["x"], b["fx"])):
    model = ModelConfig(**cfg, shard_axes=shard).build(device="cpu")
    model.load_state_dict(state)
    return Trainer(model, loss, train_cfg(accum), total_steps=10,
                   batch_args=batch_args, mesh=mesh)


def params(trainer) -> dict:
    return {k: p.detach().numpy().copy()
            for k, p in trainer.model.named_parameters()}


def two_steps(trainer, batch) -> dict:
    """``grad_leaf_norms`` at the start, then two steps: their metrics, the
    BatchNorm statistics after the first (a function of the starting
    weights alone) and the parameters after the second."""
    norms = trainer.grad_leaf_norms(batch)
    ms = [trainer.train_step(batch)]
    stats = {k: v.numpy().copy() for k, v in
             trainer.model.state_dict().items() if "running" in k}
    ms.append(trainer.train_step(batch))
    return {"loss": np.array([float(m["loss"]) for m in ms]),
            "grad_norm": np.array([float(m["grad_norm"]) for m in ms]),
            "leaf_norms": {k: np.array(v) for k, v in norms.items()},
            "params": params(trainer), "stats": stats}


def car_batch() -> dict:
    """Four car-like samples with different valid counts, padded to 256:
    their masks differ from rank to rank under dp 4."""
    rng = np.random.RandomState(4)
    parts = []
    for n in CAR_POINTS:
        s = CarSample(pos=rng.randn(n, 3).astype(np.float32),
                      x=rng.randn(n, 7).astype(np.float32),
                      y=rng.randn(n, 4).astype(np.float32),
                      surf=rng.rand(n) < 0.3)
        parts.append(tcar.make_batch(s, n_pad=256))
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def car_step(state, mesh=None) -> dict:
    tr = make_trainer(state, mesh, cfg=CAR, loss=tcar.loss_fn_builder(0.5),
                      batch_args=lambda b: (b["x"], None))
    m = tr.train_step(car_batch())
    return {k: np.array(float(v)) for k, v in m.items()}


# -- the ranks' cases -----------------------------------------------------

def _case(n_dp, n_tp, shard=None, accum=1):
    def case(rank, p):
        mesh = parallel.make_mesh(n_dp, n_tp)
        return two_steps(make_trainer(p["state"], mesh, shard, accum),
                         data())
    return case


def _train_steps(rank, p):
    """K = 3 steps as ``train_steps`` and as three ``train_step``s."""
    mesh = parallel.make_mesh(4, 1)
    batches = [data(i) for i in range(3)]
    t1 = make_trainer(p["state"], mesh)
    scan = t1.train_steps(batches)
    t2 = make_trainer(p["state"], mesh)
    seq = [float(t2.train_step(b)["loss"]) for b in batches]
    return {"scan": scan["loss"].numpy(), "seq": np.array(seq),
            "params_scan": params(t1), "params_seq": params(t2)}


def _checkpoint(rank, p):
    """fit over dp 2: one epoch, a checkpoint, a resumed second epoch, and
    an unbroken two-epoch run; rank 0 writes the checkpoints and the
    log."""
    mesh = parallel.make_mesh(2, 2)
    batches = [data(i) for i in range(2)]
    root = p["tmp"]
    broken = make_trainer(p["state"], mesh)
    broken.fit(lambda: iter(batches), epochs=1,
               checkpointer=Checkpointer(os.path.join(root, "ck")),
               logger=MetricsLogger(os.path.join(root, "log.jsonl")))
    resumed = make_trainer(p["state"], mesh)
    restored = resumed.maybe_restore(Checkpointer(os.path.join(root, "ck")))
    resumed.fit(lambda: iter(batches), epochs=2,
                logger=MetricsLogger(echo=False))
    whole = make_trainer(p["state"], mesh)
    whole.fit(lambda: iter(batches), epochs=2,
              logger=MetricsLogger(echo=False))
    return {"restored": np.array(restored), "step": np.array(resumed.step),
            "resumed": params(resumed), "whole": params(whole)}


def _eval_predict(rank, p):
    mesh = parallel.make_mesh(4, 1)
    tr = make_trainer(p["state"], mesh)
    b = data()
    return {"eval": np.array(float(tr.eval_step(b)["loss"])),
            "predict": tr.predict(b).numpy()}


def _car(rank, p):
    return car_step(p["car_state"], parallel.make_mesh(4, 1))


def _driver(rank, p):
    """``car_train --smoke --dp 2 --tp 2 --device cpu`` on the stand-in,
    each rank its own process of the run."""
    from haet_torch.benchmarks import car_train

    out = os.path.join(p["tmp"], "drv")
    metrics = car_train.main(["--smoke", "--dp", "2", "--tp", "2",
                              "--device", "cpu",
                              "--out_dir", out, "--prefetch", "0",
                              "--data_dir", os.path.join(out, "none")])
    return {k: np.array(v) for k, v in metrics.items()
            if k != "time_per_sample"}


CASES = {
    "dp4": _case(4, 1),
    "dp2tp2": _case(2, 2, ("dp", "tp")),
    "accum_dp4": _case(4, 1, accum=2),
    "accum_dp2tp2": _case(2, 2, ("dp", "tp"), accum=2),
    "train_steps": _train_steps,
    "checkpoint": _checkpoint,
    "eval_predict": _eval_predict,
    "car": _car,
    "driver": _driver,
}


def _rank_cases(rank, payload):
    return run_cases(CASES, rank, payload)


# -- the fixtures ---------------------------------------------------------

@pytest.fixture(scope="module")
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(threads, tmp_path_factory):
    """JAX's numpy variables of the model, and the ranks' payload."""
    import jax

    from haet_tpu.utils.config import ModelConfig as JModelConfig
    from haet_torch.utils.weights import from_jax_variables
    from test_torch_model import init_like

    b = data()
    jm = JModelConfig(**MODEL).build()
    v = init_like(jax.eval_shape(jm.init, jax.random.PRNGKey(0), b["x"],
                                 b["fx"]), np.random.RandomState(5), 32)
    car = ModelConfig(**CAR).build(device="cpu", seed=3)
    return dict(jm=jm, v=v, payload=dict(
        state=from_jax_variables(v), car_state=car.state_dict(),
        tmp=str(tmp_path_factory.mktemp("mesh"))))


@pytest.fixture(scope="module")
def started(weights):
    return start_ranks(_rank_cases, weights["payload"], timeout=300.0)


@pytest.fixture(scope="module")
def jax_run(weights, started):
    """Two steps of JAX's single-device ``Trainer``: losses, gradient
    norms, parameters."""
    import jax
    import jax.numpy as jnp

    from haet_tpu.train import Trainer as JTrainer
    from haet_tpu.train.trainer import TrainState
    from haet_tpu.utils.config import TrainConfig as JTrainConfig
    from haet_torch.utils.weights import from_jax_variables

    v = weights["v"]
    cfg = JTrainConfig(**{k: getattr(train_cfg(), k) for k in (
        "lr", "epochs", "batch_size", "schedule", "weight_decay",
        "max_grad_norm")})
    jtr = JTrainer(model=weights["jm"],
                   loss_fn=lambda out, b: (jnp.mean((out - b["y"]) ** 2),
                                           {}),
                   cfg=cfg, total_steps=10)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                       batch_stats=v["batch_stats"],
                       opt_state=jtr.tx.init(v["params"]))
    ms = []
    for i in range(2):
        state, m = jtr.train_step(state, data(), jax.random.PRNGKey(i))
        ms.append(m)
    return {"loss": np.array([float(m["loss"]) for m in ms]),
            "grad_norm": np.array([float(m["grad_norm"]) for m in ms]),
            "params": {k: t.numpy() for k, t in from_jax_variables(
                {"params": jax.device_get(state.params)}).items()}}


@pytest.fixture(scope="module")
def ranks(started, jax_run):
    return started()


@pytest.fixture(scope="module")
def one_rank(weights):
    """The port's one-rank runs of the cases."""
    s = weights["payload"]["state"]
    return {"plain": two_steps(make_trainer(s), data()),
            "accum": two_steps(make_trainer(s, accum=2), data()),
            "car": car_step(weights["payload"]["car_state"])}


def assert_params_close(got, want, leaf_norms, rtol=1e-4, atol=2e-5):
    """``tests/test_trainer_mesh.py:_assert_params_close``: a leaf whose
    gradient is below 1e-6 (Adam turns its round-off into full-rate steps
    on both sides) only within 1e-2."""
    for k, w in want.items():
        if float(leaf_norms.get(k, 0.0)) < 1e-6:
            np.testing.assert_allclose(got[k], w, atol=1e-2, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                       err_msg=k)


def assert_step_close(got, want):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-5)
    assert set(got["leaf_norms"]) == set(want["leaf_norms"])
    for k, v in want["leaf_norms"].items():
        np.testing.assert_allclose(got["leaf_norms"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert_params_close(got["params"], want["params"], want["leaf_norms"])
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=1e-5, err_msg=k)


# -- the tests ------------------------------------------------------------

@pytest.mark.parametrize("name", ["dp4", "dp2tp2"])
def test_mesh_training_matches_jax_and_one_rank(ranks, one_rank, jax_run,
                                                name):
    """Two steps over dp 4, and over dp 2 x tp 2 with the heads split: the
    state broadcast from rank 0, the loss the global batch's, the flat
    gradient summed over the mesh before clipping, Adam's update equal on
    every rank; against the one-rank trainer (losses, gradient norms,
    ``grad_leaf_norms``, parameters, BatchNorm statistics) and JAX's
    single-device ``Trainer``."""
    got = case_result(ranks, name)
    assert_step_close(got, one_rank["plain"])
    np.testing.assert_allclose(got["loss"], jax_run["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], jax_run["grad_norm"],
                               rtol=1e-5)
    assert_params_close(got["params"], jax_run["params"],
                        one_rank["plain"]["leaf_norms"])


@pytest.mark.parametrize("name", ["accum_dp4", "accum_dp2tp2"])
def test_accum_under_mesh_matches_one_rank(ranks, one_rank, name):
    """``accum_steps`` 2 under dp: each microbatch of 4 split over the
    ranks' rows, its BatchNorm statistics global, the microbatches'
    gradients summed, then one reduction over the mesh: the one-rank
    accumulation's step."""
    assert_step_close(case_result(ranks, name), one_rank["accum"])


def test_train_steps_under_mesh_match_sequential(ranks):
    """``train_steps`` of 3 batches on dp 4 equals 3 ``train_step``s."""
    got = case_result(ranks, "train_steps")
    np.testing.assert_array_equal(got["scan"], got["seq"])
    for k, v in got["params_seq"].items():
        np.testing.assert_array_equal(got["params_scan"][k], v, err_msg=k)


def test_checkpoint_under_dp_resumes(ranks, weights):
    """fit over dp 2 x tp 2 (no head split): rank 0 writes ``last`` and the
    log, every rank restores it, and the resumed second epoch equals an
    unbroken two-epoch run bit for bit."""
    got = case_result(ranks, "checkpoint")
    assert bool(got["restored"]) and int(got["step"]) == 4
    for k, v in got["whole"].items():
        np.testing.assert_array_equal(got["resumed"][k], v, err_msg=k)
    tmp = weights["payload"]["tmp"]
    lines = open(os.path.join(tmp, "log.jsonl")).read().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 0
    assert os.path.exists(os.path.join(tmp, "ck", "last.pt"))


def test_eval_and_predict_under_mesh(ranks, weights):
    """``eval_step`` and ``predict`` on dp 4: the global batch's loss and
    output on every rank."""
    got = case_result(ranks, "eval_predict")
    tr = make_trainer(weights["payload"]["state"])
    b = data()
    np.testing.assert_allclose(got["eval"], float(tr.eval_step(b)["loss"]),
                               rtol=1e-5)
    want = tr.predict(b).numpy()
    np.testing.assert_allclose(got["predict"], want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_car_loss_with_ragged_masks_is_the_global_batch(ranks, one_rank):
    """Trouble spot of the masked car loss: four samples with 256, 100,
    180 and 40 valid points on four ranks. The loss divides the masked
    sums of the whole batch by its mask count, on every rank, as the
    one-rank step does, where the mean of the ranks' own ratios would not
    (checked here: it differs by far more than the tolerance)."""
    got = case_result(ranks, "car")
    want = one_rank["car"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    b = car_batch()
    mask = b["mask"][..., None]
    per_rank = [(mask[i] * b["y"][i, :, :3] ** 2).sum() / (3 * mask[i].sum())
                for i in range(4)]
    whole = (mask * b["y"][..., :3] ** 2).sum() / (3 * mask.sum())
    assert abs(np.mean(per_rank) - whole) > 1e-3 * whole


def test_car_train_driver_over_four_ranks(ranks):
    """``car_train --smoke --dp 2 --tp 2 --device cpu`` over four ranks: two
    epochs on the stand-in (its batch of one sample replicated over dp, the
    heads split over tp), then the evaluation; finite metrics, equal on
    every rank."""
    got = case_result(ranks, "driver")
    assert got and all(np.isfinite(v).all() for k, v in got.items()
                       if k != "rho_d")
