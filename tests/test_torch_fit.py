"""PyTorch port, the training loop, checkpoints, losses and normalizers.

* losses and normalizers against ``haet_tpu.train.losses`` and
  ``haet_tpu.train.normalizer`` on the same numpy inputs (rtol 1e-6: the
  same float32 arithmetic in two frameworks, sums in other orders);
* the counterparts of ``tests/test_train.py``'s fit and checkpoint cases
  on a linear model (Adam + OneCycle: the port runs no other optimizer or
  schedule yet): early stopping, the observability metrics and the applied
  learning rate, periodic checkpoints and ``keep``, the best-val watermark
  across restarts, ``watch_every``, ``Prefetcher`` in ``fit``, early stop
  saving ``last``, the divergence guard, the stored resume epoch, a
  corrupt checkpoint, the logger's close, consecutive fits, ``stop_event``
  and SIGTERM (one small subprocess);
* **fit parity with JAX**: a small HAET (1 layer, n_hidden 32, G 16, 4
  heads, ``car_train --smoke``'s Erwin sizing, both kernel flags on: their
  plain versions on the CPU) on the fixture fold layout, from the same
  numpy weights and in the same batch order, 2 epochs of ``Trainer.fit``
  in both packages: ``train/loss``, ``val/loss`` and
  ``train/learning_rate`` per epoch within rtol 1e-4, and the driver's
  ``evaluate`` on the same weights within rtol 1e-5 (the fields) and on
  each package's own final state within rtol 1e-4 (the readings and the
  reason at the test);
* **resume**: a run stopped by ``stop_event`` after epoch 1 and resumed
  through a fresh ``Trainer`` and ``Checkpointer`` ends bit-identical to an
  unbroken run (parameters, buffers, Adam and OneCycle state).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch.benchmarks import car_train as tdriver
from haet_torch.data import Prefetcher
from haet_torch.data import shapenet_car as tcar
from haet_torch.train import (Checkpointer, EarlyStopping, MetricsLogger,
                              Trainer)
from haet_torch.train import car as tcar_train
from haet_torch.train import losses as tlosses
from haet_torch.train import normalizer as tnorm
from haet_torch.utils.config import TrainConfig
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.data import shapenet_car as jcar
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk
from haet_tpu.train import Trainer as JTrainer
from haet_tpu.train import losses as jlosses
from haet_tpu.train import normalizer as jnorm
from haet_tpu.train.trainer import TrainState
from haet_tpu.utils.config import shapenet_car_config as jax_car_config
from test_torch_car_data import build_car_dataset
from test_torch_model import init_like

ROOT = Path(__file__).resolve().parents[1]
BENCH = str(ROOT / "benchmarks")


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    modes = jsk.INTERPRET, jeb.INTERPRET
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET, jeb.INTERPRET = modes
    torch.set_num_threads(threads)


# -- losses and normalizers -------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(p=1), dict(size_average=False),
                                dict(reduction=False)],
                         ids=["default", "p1", "sum", "none"])
def test_rel_lp_loss_matches_jax(kw):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 2).astype(np.float32)
    y = rng.randn(3, 40, 2).astype(np.float32)
    tl, jl = tlosses.RelLpLoss(**kw), jlosses.RelLpLoss(**kw)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for t, j in ((tl(tx, ty), jl(x, y)), (tl.abs(tx, ty), jl.abs(x, y))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


def test_grid_ops_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 36, 3).astype(np.float32)
    for t, j in zip(tlosses.central_diff(torch.from_numpy(x), 0.2, 6),
                    jlosses.central_diff(x, 0.2, 6)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    np.testing.assert_array_equal(
        tlosses.zero_boundary(torch.from_numpy(x), 6).numpy(),
        np.asarray(jlosses.zero_boundary(x, 6)))


def test_mse_press_velo_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.randn(50, 4).astype(np.float32)
    target = rng.randn(50, 4).astype(np.float32)
    surf = rng.rand(50) > 0.6
    tl, (tv, tp) = tlosses.mse_press_velo(
        torch.from_numpy(pred), torch.from_numpy(target),
        torch.from_numpy(surf), 0.5)
    jl, (jv, jp) = jlosses.mse_press_velo(pred, target, surf, 0.5)
    for t, j in ((tl, jl), (tv, jv), (tp, jp)):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)


@pytest.mark.parametrize("name", ["IdentityTransformer", "UnitTransformer",
                                  "UnitGaussianNormalizer"])
def test_normalizers_match_jax(name):
    """Statistics equal (the same numpy code); encode and decode of numpy
    arrays equal, of tensors within rtol 1e-6."""
    rng = np.random.RandomState(3)
    x = (2 + 3 * rng.randn(5, 30, 2)).astype(np.float32)
    t, j = getattr(tnorm, name)(x), getattr(jnorm, name)(x)
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    enc = j.encode(x)
    np.testing.assert_array_equal(t.encode(x), enc)
    np.testing.assert_array_equal(t.decode(enc), j.decode(enc))
    np.testing.assert_allclose(t.encode(torch.from_numpy(x)).numpy(), enc,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t.decode(torch.from_numpy(np.asarray(enc))).numpy(), j.decode(enc),
        rtol=1e-6, atol=1e-6)


def test_streaming_normalizer_matches_jax():
    rng = np.random.RandomState(4)
    t, j = tnorm.StreamingNormalizer(3), jnorm.StreamingNormalizer(3)
    for n in (17, 5, 40):
        chunk = rng.randn(n, 3).astype(np.float32)
        t.update(chunk)
        j.update(chunk)
    np.testing.assert_array_equal(t.mean, j.mean)
    np.testing.assert_array_equal(t.std, j.std)
    x = rng.randn(4, 3)
    np.testing.assert_array_equal(t.encode(x), j.encode(x))
    np.testing.assert_array_equal(t.decode(x), j.decode(x))


# -- the loop on a linear model (tests/test_train.py's cases) ----------------

def _make_trainer(total_steps=50, seed=0, **cfg_kw):
    torch.manual_seed(seed)
    cfg = TrainConfig(**{**dict(lr=1e-1, optimizer="adam", epochs=20,
                                batch_size=8), **cfg_kw})
    return Trainer(torch.nn.Linear(4, 1),
                   lambda out, b: (((out - b["y"]) ** 2).mean(), {}),
                   cfg, total_steps, batch_args=lambda b: (b["x"],))


def _data(n=64):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [2], [-1], [0.5]], np.float32))
    return {"x": x, "y": y.astype(np.float32)}


def batch_iter(d, bs, shuffle=True, seed=0):
    """``haet_tpu.data.batch_iter``: one RandomState, a new permutation per
    pass."""
    n = len(d["x"])
    rng = np.random.RandomState(seed)

    def gen():
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n, bs):
            yield {k: v[idx[i:i + bs]] for k, v in d.items()}
    return gen


class Capture:
    def __init__(self):
        self.recs = []

    def log(self, rec):
        self.recs.append(rec)

    def epochs(self):
        return [r["epoch"] for r in self.recs if "epoch" in r]


def _quiet():
    return MetricsLogger(echo=False)


def test_early_stopping():
    es = EarlyStopping(patience=2)
    assert not es.update(1.0)
    assert not es.update(0.9)
    assert not es.update(0.95)
    assert es.update(0.95)
    assert es.should_stop


def test_trainer_fits_linear_problem():
    trainer = _make_trainer(total_steps=160)
    d = _data()
    trainer.fit(batch_iter(d, 8), logger=_quiet())
    assert trainer.step == 160
    assert float(trainer.eval_step(d)["loss"]) < 0.05


def test_checkpoint_resume(tmp_path):
    trainer = _make_trainer()
    d = _data()
    trainer.train_step(d)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_last(trainer.state_dict(), 0)
    t2 = _make_trainer(seed=1)
    assert t2.maybe_restore(ck)
    assert t2.step == 1
    torch.testing.assert_close(t2.model.weight, trainer.model.weight,
                               rtol=0, atol=0)
    raw = ck.restore_raw("last")
    assert raw["step"] == 1
    np.testing.assert_array_equal(raw["model"]["weight"],
                                  trainer.model.weight.detach().numpy())


def test_fit_observability_metrics(tmp_path):
    """The reference's metric names per epoch and per batch; the logged
    learning rate is the one the step APPLIED (torch's ``get_last_lr()``
    before ``scheduler.step()``): the first batch record has the
    schedule's first rate."""
    trainer = _make_trainer(total_steps=4)
    trainer.batch_log_every = 1
    first_lr = trainer.optimizer.param_groups[0]["lr"]
    lrs = []
    step = trainer.train_step

    def spy(batch):
        lrs.append(trainer.optimizer.param_groups[0]["lr"])
        return step(batch)
    trainer.train_step = spy
    log_path = str(tmp_path / "metrics.jsonl")
    with MetricsLogger(path=log_path, echo=False) as logger:
        trainer.fit(batch_iter(_data(16), 8), epochs=2, logger=logger)
    recs = [json.loads(line) for line in open(log_path)]
    epoch_recs = [r for r in recs if "epoch" in r]
    batch_recs = [r for r in recs if "batch/total_loss" in r]
    assert len(epoch_recs) == 2 and len(batch_recs) == 4
    for key in ("train/avg_batch_time", "train/memory_used_mb",
                "train/learning_rate", "train/grad_norm", "train/loss",
                "epoch/time_seconds"):
        assert key in epoch_recs[-1], key
    assert epoch_recs[-1]["train/memory_used_mb"] > 0
    assert "train/device_memory_mb" not in epoch_recs[-1]   # the CPU
    for key in ("batch/total_loss", "batch/learning_rate",
                "batch/memory_used_mb", "batch/batch_time",
                "batch/eta_seconds"):
        assert key in batch_recs[0], key
    assert batch_recs[0]["batch/learning_rate"] == first_lr == lrs[0]
    assert [r["batch/learning_rate"] for r in batch_recs] == lrs
    assert [r["train/learning_rate"] for r in epoch_recs] == [lrs[1], lrs[3]]


def test_periodic_checkpoints_and_keep(tmp_path):
    trainer = _make_trainer(total_steps=10, checkpoint_every=1)
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    trainer.fit(batch_iter(_data(16), 8), epochs=5, logger=_quiet(),
                checkpointer=ck)
    assert ck.periodic_epochs() == [3, 4]
    assert ck.restore("latest_periodic")["step"] == trainer.step == 10
    assert ck.restore("epoch_3")["step"] == 8
    assert ck.restore("epoch_0") is None
    assert ck.epoch_of("latest_periodic") == 4


def test_best_val_survives_restart(tmp_path):
    trainer = _make_trainer()
    state = trainer.state_dict()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_best(state, val_loss=0.10, epoch=3)
    assert ck.best_val == pytest.approx(0.10)
    ck2 = Checkpointer(str(tmp_path / "ck"))
    assert ck2.best_val == float("inf")   # construction alone stays fresh
    assert ck2.rearm_best()
    assert ck2.best_val == pytest.approx(0.10) and ck2.best_epoch == 3
    worse = {**state, "step": 100}
    ck2.save_best(worse, val_loss=0.50, epoch=4)
    assert ck2.restore("best")["step"] == 0
    ck2.save_best(worse, val_loss=0.05, epoch=5)
    assert ck2.restore("best")["step"] == 100
    ck3 = Checkpointer(str(tmp_path / "ck"))
    assert ck3.rearm_best() and ck3.best_val == pytest.approx(0.05)
    # the resume path re-arms it
    t2 = _make_trainer()
    ck4 = Checkpointer(str(tmp_path / "ck"))
    t2.maybe_restore(ck4, "best")
    assert ck4.best_val == pytest.approx(0.05) and t2.step == 100


def test_fresh_run_into_existing_dir_overwrites_best(tmp_path):
    state = _make_trainer().state_dict()
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_best(state, val_loss=0.07, epoch=9)
    ck2 = Checkpointer(str(tmp_path / "ck"))
    ck2.save_best({**state, "step": 100}, val_loss=0.50, epoch=0)
    assert ck2.restore("best")["step"] == 100


def test_rearm_best_ignores_stale_meta_without_checkpoint(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    (d / "best_meta.json").write_text(
        json.dumps({"best_val": 0.01, "best_epoch": 1}))
    ck = Checkpointer(str(d))
    assert not ck.rearm_best()
    assert ck.best_val == float("inf")


def test_watch_every_logs_per_leaf_grad_norms():
    """Every K epochs, per-parameter gradient norms of one batch, whose
    root sum of squares is the step's ``grad_norm``; the probe changes
    no parameter, buffer or step."""
    trainer = _make_trainer(total_steps=8)
    trainer.watch_every = 2
    d = _data(16)
    cap = Capture()
    trainer.fit(batch_iter(d, 8), epochs=4, logger=cap)
    recs = {r["epoch"]: r for r in cap.recs}
    keys = [k for k in recs[1] if k.startswith("gradients/")]
    assert sorted(keys) == ["gradients/bias", "gradients/weight"]
    assert all(np.isfinite(recs[1][k]) and recs[1][k] >= 0 for k in keys)
    assert not any(k.startswith("gradients/") for k in recs[0])
    assert any(k.startswith("gradients/") for k in recs[3])
    batch = {k: v[:8] for k, v in d.items()}
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    leaf = trainer.grad_leaf_norms(batch)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    trainer.scheduler.total_steps += 1   # one more step for the check
    m = trainer.train_step(batch)
    assert np.sqrt(sum(v ** 2 for v in leaf.values())) == pytest.approx(
        float(m["grad_norm"]), rel=1e-5)


def test_eval_fn_replaces_the_loss_in_eval():
    """``eval_fn`` gives ``eval_step``'s metrics, logged under ``val/``;
    the eval leaves the model as it was."""
    trainer = _make_trainer(total_steps=4)
    trainer.eval_fn = lambda out, b: {"mae": (out - b["y"]).abs().mean()}
    d = _data(8)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    m = trainer.eval_step(d)
    assert sorted(m) == ["mae"]
    with torch.no_grad():
        want = (trainer.model(torch.from_numpy(d["x"]))
                - torch.from_numpy(d["y"])).abs().mean()
    assert float(m["mae"]) == float(want)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    [rec] = trainer.fit(lambda: [d], lambda: [d], epochs=1, logger=_quiet())
    assert "val/mae" in rec and "val/loss" not in rec


def test_trainer_fit_with_prefetcher():
    trainer = _make_trainer(total_steps=12)
    d = _data(32)
    trainer.fit(Prefetcher(batch_iter(d, 8)), epochs=3, logger=_quiet())
    assert trainer.step == 12
    assert np.isfinite(float(trainer.eval_step(d)["loss"]))


def test_early_stop_still_saves_last_checkpoint(tmp_path):
    """A huge min_delta counts every eval as no improvement: patience 1
    stops at the second eval, whose state still reaches ``last``."""
    trainer = _make_trainer(total_steps=80, early_stop_patience=1,
                            early_stop_min_delta=1e9)
    d = _data()
    ck = Checkpointer(str(tmp_path / "ck"))
    log_path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path=log_path, echo=False) as logger:
        trainer.fit(batch_iter(d, 8, shuffle=False),
                    eval_batches=batch_iter(d, 8, shuffle=False), epochs=10,
                    checkpointer=ck, logger=logger)
    recs = [json.loads(line) for line in open(log_path)]
    assert any(r.get("early_stop") for r in recs)
    assert trainer.step == 16 < 10 * 8
    assert ck.restore("last")["step"] == trainer.step
    assert ck.epoch_of("last", trainer.step) == 1


def _nan_trainer(**cfg_kw):
    cfg = TrainConfig(lr=1e-3, optimizer="adam", epochs=5, batch_size=8,
                      **cfg_kw)
    return Trainer(torch.nn.Linear(4, 1),
                   lambda out, b: (torch.sqrt(-(out ** 2).sum() - 1.0), {}),
                   cfg, 10, batch_args=lambda b: (b["x"],))


def test_fit_aborts_on_nonfinite_loss(tmp_path):
    """A NaN loss raises after the epoch, the state saved under
    ``diverged``, not ``last``."""
    trainer = _nan_trainer()
    ck = Checkpointer(str(tmp_path))
    d = _data(8)
    with pytest.raises(FloatingPointError, match="diverged"):
        trainer.fit(lambda: [d], checkpointer=ck, logger=_quiet())
    assert ck.restore("diverged") is not None
    assert ck.restore_raw("last") is None


def test_fit_nonfinite_guard_can_be_disabled():
    trainer = _nan_trainer(stop_on_nonfinite=False)
    d = _data(8)
    trainer.fit(lambda: [d], epochs=2, logger=_quiet())
    assert trainer.step == 2


def test_resume_epoch_stored_not_derived(tmp_path):
    """10 samples at batch 4 take 3 steps an epoch; the nominal
    ``total_steps // epochs`` (16 // 4) says 4, so a derived epoch would
    restart at 6 // 4 = 1. The stored one resumes at 2."""
    d = _data(10)
    t1 = _make_trainer(total_steps=16)
    ck = Checkpointer(str(tmp_path))
    t1.fit(batch_iter(d, 4), epochs=2, logger=_quiet(), checkpointer=ck)
    assert t1.step == 6
    assert ck.epoch_of("last", 6) == 1
    assert ck.epoch_of("last", 5) is None
    t2 = _make_trainer(total_steps=16, seed=1)
    assert t2.maybe_restore(Checkpointer(str(tmp_path)))
    assert t2.step == 6
    cap = Capture()
    t2.fit(batch_iter(d, 4), epochs=4, logger=cap,
           checkpointer=Checkpointer(str(tmp_path)))
    assert cap.epochs() == [2, 3]


def test_corrupted_checkpoint_error_names_cause(tmp_path):
    trainer = _make_trainer()
    ck = Checkpointer(str(tmp_path))
    ck.save_last(trainer.state_dict(), epoch=0)
    with open(ck.path("last"), "r+b") as f:
        f.truncate(100)
    with pytest.raises(RuntimeError, match="could not be read") as e:
        ck.restore_raw("last")
    assert "last.pt" in str(e.value)
    with pytest.raises(RuntimeError, match="corrupt"):
        _make_trainer().maybe_restore(Checkpointer(str(tmp_path)))


def test_metrics_logger_close(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path, echo=False) as logger:
        logger.log({"loss": torch.tensor(1.0)})
        assert logger._f is not None
    assert logger._f is None
    logger.close()
    [rec] = [json.loads(line) for line in open(path)]
    assert rec["loss"] == 1.0


def test_consecutive_fits_continue_epoch_numbering(tmp_path):
    trainer = _make_trainer(total_steps=8)
    d = _data(8)
    ck = Checkpointer(str(tmp_path))
    cap = Capture()
    trainer.fit(batch_iter(d, 4), epochs=2, logger=cap, checkpointer=ck)
    assert cap.epochs() == [0, 1]
    cap = Capture()
    trainer.fit(batch_iter(d, 4, seed=1), epochs=4, logger=cap,
                checkpointer=ck)
    assert cap.epochs() == [2, 3]
    assert ck.epoch_of("last", trainer.step) == 3


def test_stop_event_saves_last_and_resumes(tmp_path):
    """The in-flight step completes, ``last`` is saved under the last
    completed epoch (-1: none), and the resume re-runs the interrupted
    epoch with the newer parameters; the schedule continues by step."""
    d = _data(8)
    ev = threading.Event()

    def batches():
        for i in range(4):
            if i == 2:
                ev.set()
            yield d

    trainer = _make_trainer(total_steps=14)
    ck = Checkpointer(str(tmp_path / "ck"))
    trainer.fit(batches, checkpointer=ck, epochs=3, stop_event=ev,
                logger=_quiet())
    assert trainer.step == 2
    assert ck.epoch_of("last", step=2) == -1
    t2 = _make_trainer(total_steps=14, seed=1)
    t2.maybe_restore(ck)
    assert t2.step == 2
    t2.fit(lambda: iter([d] * 4), checkpointer=ck, epochs=3, logger=_quiet())
    assert t2.step == 2 + 12
    assert ck.epoch_of("last", t2.step) == 2


def test_stop_event_on_last_batch_counts_epoch_complete(tmp_path):
    d = _data(8)
    ev = threading.Event()

    def batches():
        for _ in range(4):
            yield d
        ev.set()   # asked for a 5th batch: after the last step

    trainer = _make_trainer(total_steps=8)
    ck = Checkpointer(str(tmp_path / "ck"))
    trainer.fit(batches, checkpointer=ck, epochs=2, stop_event=ev,
                logger=_quiet())
    assert trainer.step == 4
    assert ck.epoch_of("last", step=4) == 0


def test_sigterm_preempt_saves_then_dies(tmp_path):
    """``preempt_save`` (the default): SIGTERM mid-training saves a
    resumable ``last`` and then re-delivers the signal."""
    ckdir = str(tmp_path / "ck")
    worker = tmp_path / "worker.py"
    worker.write_text(
        "import sys, time\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from haet_torch.train import Checkpointer, Trainer\n"
        "from haet_torch.utils.config import TrainConfig\n"
        "cfg = TrainConfig(lr=1e-2, optimizer='adam', epochs=100)\n"
        "tr = Trainer(torch.nn.Linear(4, 1),\n"
        "             lambda o, b: (((o - b['y']) ** 2).mean(), {}),\n"
        "             cfg, 10000, batch_args=lambda b: (b['x'],))\n"
        "r = np.random.RandomState(0)\n"
        "b = dict(x=r.randn(8, 4).astype(np.float32),\n"
        "         y=r.randn(8, 1).astype(np.float32))\n"
        f"ck = Checkpointer({ckdir!r})\n"
        "def batches():\n"
        "    for _ in range(10000):\n"
        "        print('STEPPING', flush=True)\n"
        "        time.sleep(0.05)\n"
        "        yield b\n"
        "tr.fit(batches, checkpointer=ck, epochs=100)\n"
        "print('NOT_REACHED', flush=True)\n")
    proc = subprocess.Popen(
        [sys.executable, str(worker)], cwd=str(ROOT),
        env=dict(os.environ, PYTHONUNBUFFERED="1"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        seen = False
        for _ in range(10000):
            line = proc.stdout.readline()
            if not line:
                break
            if "STEPPING" in line:
                seen = True
                break
        assert seen, f"worker never stepped:\n{proc.stderr.read()}"
        threading.Event().wait(0.2)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == -signal.SIGTERM, (proc.returncode, err)
    assert "NOT_REACHED" not in out
    assert "preempted=1" in out, out
    raw = Checkpointer(ckdir).restore_raw("last")
    assert raw is not None and raw["step"] >= 1 and "weight" in raw["model"]


def test_sigterm_handler_restored(tmp_path):
    """``fit`` puts the previous SIGTERM handler back when it returns."""
    def mine(signum, frame):
        pass

    prev = signal.signal(signal.SIGTERM, mine)
    try:
        _make_trainer(total_steps=4).fit(lambda: [_data(8)], epochs=2,
                                         logger=_quiet())
        assert signal.getsignal(signal.SIGTERM) is mine
    finally:
        signal.signal(signal.SIGTERM, prev)


# -- a small HAET: fit against JAX, and resume ------------------------------

SMOKE_ARGS = ["--smoke"]


@pytest.fixture(scope="module")
def fold(tmp_path_factory):
    """The fixture fold layout loaded by the port (2 train / 1 val), and
    the same samples as the JAX package's ``CarSample``s."""
    root = tmp_path_factory.mktemp("car")
    build_car_dataset(str(root / "training_data"))
    train, val, coef, synth = tcar.load_train_val_fold(
        str(root / "training_data"), 0)
    assert not synth and (len(train), len(val)) == (2, 1)

    def as_jax(s):
        return jcar.CarSample(**dataclasses.asdict(s))
    return train, val, coef, [as_jax(s) for s in train], \
        [as_jax(s) for s in val]


def _smoke_models():
    """The port's and JAX's ``car_train --smoke`` model configs."""
    tcfg = tdriver.model_config(tdriver.parse_args(SMOKE_ARGS))
    jcfg = jax_car_config().model
    jcfg.n_hidden, jcfg.n_layers, jcfg.slice_num = 32, 1, 16
    jcfg.n_head = 4
    jcfg.enc_num_heads = jcfg.enc_depths = None
    jcfg.dec_num_heads = jcfg.dec_depths = None
    jcfg.erwin_mlp_ratio = None
    jcfg.embed = False
    return tcfg, jcfg


@pytest.fixture(scope="module")
def jax_fit(fold):
    """JAX's ``Trainer.fit``, 2 epochs in a fixed order, from numpy
    weights; the per-epoch records, the final state's ``evaluate``, and
    the weights it started from and ended with."""
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import car_train as jdriver

    _, _, coef, jtrain, jval = fold
    _, jcfg = _smoke_models()
    jm = jcfg.build()
    first = jdriver.make_batch(jtrain[0])
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), first["x"])
    variables = init_like(template, np.random.RandomState(0), 32)
    tcfg = dataclasses.replace(jax_car_config().train, epochs=2)
    jtr = JTrainer(model=jm, loss_fn=jdriver.loss_fn_builder(0.5), cfg=tcfg,
                   total_steps=2 * len(jtrain),
                   batch_args=lambda b: (b["x"], None))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtr.tx.init(variables["params"]))
    cap = Capture()
    state = jtr.fit(state, lambda: (jdriver.make_batch(s) for s in jtrain),
                    lambda: (jdriver.make_batch(s) for s in jval),
                    logger=cap)
    metrics = jdriver.evaluate(jtr, state, jval, coef)
    end = {"params": jax.device_get(state.params),
           "batch_stats": jax.device_get(state.batch_stats)}
    return cap.recs, metrics, {"start": variables, "end": end}


def _port_trainer(fold, variables=None, seed=0, epochs=2):
    """The port's car trainer of the smoke model on the fold: the car
    preset's training for ``epochs`` over its 2 samples."""
    from haet_torch.utils.config import shapenet_car_train_config

    train = fold[0]
    tcfg, _ = _smoke_models()
    model = tdriver.build_model(tcfg, "cpu", seed=seed)
    if variables is not None:
        load_jax_variables(model, variables)
    cfg = dataclasses.replace(shapenet_car_train_config(), epochs=epochs)
    return Trainer(model, tcar_train.loss_fn_builder(0.5), cfg,
                   total_steps=epochs * len(train),
                   batch_args=lambda b: (b["x"], None))


FIELD_METRICS = ("rel_l2_press", "rel_l2_velo", "rmse_press", "rmse_velo")


def _check_metrics(got, want, rtol_fields, rtol_cd, tag):
    assert sorted(got) == sorted(want)
    worst = 0.0
    for k in FIELD_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol_fields,
                                   err_msg=f"{tag} {k}")
        worst = max(worst, abs(got[k] - want[k]) / abs(want[k]))
    np.testing.assert_allclose(got["cd_rel_err"], want["cd_rel_err"],
                               rtol=rtol_cd, err_msg=f"{tag} cd_rel_err")
    # one validation sample: Spearman's rho of one pair is nan on both
    np.testing.assert_array_equal(got["rho_d"], want["rho_d"])
    return worst, abs(got["cd_rel_err"] / want["cd_rel_err"] - 1)


def test_fit_matches_jax(fold, jax_fit):
    """Per epoch within rtol 1e-4 (measured: at most 7.9e-6, over the
    losses and the learning rate). ``evaluate``, two ways:

    * on the same weights (JAX's final state loaded into the port): the
      fields within rtol 1e-5 (measured 1.6e-7), ``cd_rel_err`` within 1e-4
      (9.1e-6: the drag coefficient is a cancelling sum, ~50x the fields'
      relative error);
    * on each package's own final state: the fields within rtol 1e-4
      (measured 1.49e-5, ``rel_l2_velo``), ``cd_rel_err`` within 1e-3
      (2.6e-4). After 4 Adam steps the two states differ by up to 3.2e-4
      in a weight (lr peaks at 1e-3): Adam moves a weight by about the
      rate whatever its gradient's size, so round-off-sized gradient
      differences become weight differences of that order.
    """
    from haet_torch.utils.weights import load_jax_variables as load

    train, val, coef = fold[:3]
    jrecs, jmetrics, jfinal = jax_fit
    trainer = _port_trainer(fold, jfinal["start"])
    cap = Capture()
    trainer.fit(lambda: (tcar_train.make_batch(s) for s in train),
                lambda: (tcar_train.make_batch(s) for s in val), logger=cap)
    assert cap.epochs() == [r["epoch"] for r in jrecs] == [0, 1]
    worst = 0.0
    for t, j in zip(cap.recs, jrecs):
        for k in ("train/loss", "val/loss", "train/learning_rate",
                  "train/loss_velo", "train/loss_press"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=k)
            worst = max(worst, abs(t[k] - j[k]) / abs(j[k]))
    own = _check_metrics(tcar_train.evaluate(trainer.model, val, coef),
                         jmetrics, 1e-4, 1e-3, "own final states")
    load(trainer.model, jfinal["end"])
    same = _check_metrics(tcar_train.evaluate(trainer.model, val, coef),
                          jmetrics, 1e-5, 1e-4, "JAX's final weights")
    print(f"PARITY fit 2 epochs: per-epoch rel {worst:.3e}; evaluate "
          f"(fields, cd_rel_err) own states {own[0]:.3e}, {own[1]:.3e}; "
          f"same weights {same[0]:.3e}, {same[1]:.3e}")


def _snapshot(trainer):
    sd = trainer.state_dict()
    return {"model": {k: v.clone() for k, v in sd["model"].items()},
            "optimizer": sd["optimizer"], "scheduler": dict(sd["scheduler"]),
            "step": sd["step"]}


def _assert_same_state(a, b):
    assert a["step"] == b["step"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["scheduler"] == b["scheduler"]
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["param_groups"] == ob["param_groups"]
    assert sorted(oa["state"]) == sorted(ob["state"])
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_resume_is_bit_identical(fold, tmp_path):
    """3 epochs unbroken, against 2 epochs, a stop before epoch 2's first
    step and a resume through a fresh Trainer and Checkpointer; eval every
    epoch (which must leave BatchNorm's statistics alone). On one thread:
    a multi-threaded CPU matrix product may split its sums by the threads
    it gets, which varies with the machine's load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _resume_is_bit_identical(fold, tmp_path)
    finally:
        torch.set_num_threads(threads)


def _resume_is_bit_identical(fold, tmp_path):
    train, val = fold[:2]

    def batches():
        return (tcar_train.make_batch(s) for s in train)

    def evals():
        return (tcar_train.make_batch(s) for s in val)

    whole = _port_trainer(fold, seed=0, epochs=3)
    whole.fit(batches, evals, checkpointer=Checkpointer(
        str(tmp_path / "whole")), logger=_quiet())
    want = _snapshot(whole)

    first = _port_trainer(fold, seed=0, epochs=3)
    ev = threading.Event()
    calls = []

    def stopping_batches():
        calls.append(1)
        if len(calls) == 3:
            ev.set()
        return batches()

    ck_dir = str(tmp_path / "stopped")
    first.fit(stopping_batches, evals, checkpointer=Checkpointer(ck_dir),
              stop_event=ev, logger=_quiet())
    assert first.step == 2 * len(train)
    assert Checkpointer(ck_dir).epoch_of("last", first.step) == 1

    fresh = _port_trainer(fold, seed=5, epochs=3)
    ck = Checkpointer(ck_dir)
    assert fresh.maybe_restore(ck)
    cap = Capture()
    fresh.fit(batches, evals, checkpointer=ck, logger=cap)
    assert cap.epochs() == [2]
    _assert_same_state(_snapshot(fresh), want)
