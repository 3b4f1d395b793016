"""PyTorch port, the PDE presets' training vs the JAX package's ``Trainer``.

One small JAX model, built once for the module: the 2D structured model on
an 8 x 4 grid (1 block, n_hidden 32, 4 heads, G 16 in Erwin balls of 8 and
4, ``fun_dim`` 1) with ``use_checkpoint`` (``nn.remat`` per block on the
JAX side, ``torch.utils.checkpoint`` on the port's), weights drawn with
numpy (``test_torch_model.init_like``), a batch of 4 samples and an MSE
loss. The JAX side runs ``haet_tpu.train.Trainer``'s step in two compiled
pieces shared by every setting: the gradients of its train-mode
``_apply`` (or its ``_accum_grads`` over 2 microbatches), then the
trainer's own optimizer (``make_optimizer``: optax's AdamW with the
``sigma_att`` mask, ``inject_hyperparams`` under OneCycle) and
``optax.apply_updates``. The port runs 3 ``Trainer.train_step``s for each
setting:

* AdamW + OneCycle (``cycle_momentum``), AdamW + ``cosine_annealing`` with
  ``t_max`` 2 (periodic: its third rate is 0), AdamW + ``constant``, and
  AdamW + OneCycle with ``accum_steps`` 2 and clipping at 0.1;
* a peak rate of 1e-4 and a weight decay of 5, so that the decay's factor
  ``1 - lr * wd`` shows (7.5e-4 to 1.5e-3 over the 3 steps): the
  placeholder gets no gradient (``fx`` is given), so optax and the port
  move it by the decay alone; ``sigma_att`` is neither stepped nor decayed.

Tolerances: losses rtol 1e-5; the rate of each step rtol 1e-5 (JAX's
float32 closed forms against torch's float64 schedulers); after 3
steps, every parameter within 1e-5 of the model's max |parameter| (~1,
the LayerNorm scales; Adam's first steps are about +-lr per entry whatever
the gradient's size, so an entry's distance is lr times its gradient's
relative round-off: at a peak rate of 1e-3 up to 1.4e-5 on an entry whose
gradient is small within its leaf), but the
leaves whose step-1 gradient is below 1e-3 of the largest (zero in exact
arithmetic: biases in front of a train-mode BatchNorm; or cancelling over
the tokens: the Erwin blocks' relative-position projections, whose two
float32 gradients agree to only ~1e-3 of themselves): Adam moves an entry
by about +-lr whatever its gradient's size, so such a leaf's round-off
moves the two sides apart by up to 2 lr a step (``test_torch_train.py``
holds them the same way); BatchNorm
statistics after one checkpointed step rtol 1e-5 against JAX's remat model,
updated once.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from haet_torch.models import HAETransolverStructuredMesh2D as TModel
from haet_torch.train import Trainer
from haet_torch.utils.config import TrainConfig
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models import HAETransolverStructuredMesh2D as JModel
from haet_tpu.train import Trainer as JTrainer
from haet_tpu.train.trainer import TrainState
from haet_tpu.utils.config import TrainConfig as JTrainConfig
from test_torch_model import init_like

MODEL = dict(space_dim=2, fun_dim=1, out_dim=1, n_layers=1, n_hidden=32,
             n_head=4, slice_num=16, ball_sizes=(8, 4), mlp_ratio=1, H=8,
             W=4, use_checkpoint=True)
B, STEPS, HORIZON = 4, 3, 10
BASE = dict(lr=1e-4, weight_decay=5.0, optimizer="adamw", batch_size=B)
SETTINGS = {
    "adamw_onecycle": dict(BASE),
    "adamw_cosine": dict(BASE, schedule="cosine_annealing", t_max=2),
    "adamw_constant": dict(BASE, schedule="constant"),
    "adamw_accum2": dict(BASE, accum_steps=2, max_grad_norm=0.1),
}
PARAM_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jloss(out, b):
    mse = jnp.mean((out[..., 0] - b["y"]) ** 2)
    return mse, {"mse": mse}


def tloss(out, b):
    mse = torch.mean((out[..., 0] - b["y"]) ** 2)
    return mse, {"mse": mse}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    n = MODEL["H"] * MODEL["W"]
    batch = {"pos": rng.rand(B, n, 2).astype(np.float32),
             "fx": rng.randn(B, n, 1).astype(np.float32),
             "y": rng.randn(B, n).astype(np.float32)}
    jm = JModel(**MODEL)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), batch["pos"],
                              batch["fx"])
    variables = init_like(template, rng, MODEL["n_hidden"])
    base = JTrainer(model=jm, loss_fn=jloss,
                    cfg=JTrainConfig(**SETTINGS["adamw_onecycle"]),
                    total_steps=HORIZON,
                    batch_args=lambda b: (b["pos"], b["fx"]))

    def grads(params, batch_stats, b, key):
        def loss(p):
            out, new_bs = base._apply(p, batch_stats, b, True, key)
            return base.loss_fn(out, b)[0], new_bs
        (l, new_bs), g = jax.value_and_grad(loss, has_aux=True)(params)
        return l, new_bs, g

    accum = jax.jit(functools.partial(base._accum_grads, accum=2))
    return dict(batch=batch, variables=variables, jm=jm,
                grads=jax.jit(grads), accum=accum)


def jax_run(setup, setting):
    """3 JAX steps: ``(losses, rates, batch stats after step 1, params)``."""
    cfg = JTrainConfig(**SETTINGS[setting])
    jtr = JTrainer(model=setup["jm"], loss_fn=jloss, cfg=cfg,
                   total_steps=HORIZON,
                   batch_args=lambda b: (b["pos"], b["fx"]))
    params = setup["variables"]["params"]
    bs = setup["variables"]["batch_stats"]
    opt_state = jtr.tx.init(params)
    update = jax.jit(jtr.tx.update)
    key = jax.random.PRNGKey(1)
    losses, rates, stats = [], [], None
    for step in range(STEPS):
        if cfg.accum_steps > 1:
            state = TrainState(step=jnp.asarray(step), params=params,
                               batch_stats=bs, opt_state=opt_state)
            loss, _, bs, g = setup["accum"](state, setup["batch"], key)
        else:
            loss, bs, g = setup["grads"](params, bs, setup["batch"], key)
        rates.append(float(jtr.sched(step)))
        upd, opt_state = update(g, opt_state, params)
        params = optax.apply_updates(params, upd)
        losses.append(float(loss))
        if step == 0:
            stats = from_jax_variables({"batch_stats": bs})
    return losses, rates, stats, from_jax_variables({"params": params})


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_training_matches_jax(setup, setting):
    losses, rates, stats, params = jax_run(setup, setting)
    cfg = TrainConfig(**SETTINGS[setting])
    tm = TModel(**MODEL, use_pallas=True, use_pallas_erwin=True,
                device="cpu")
    load_jax_variables(tm, setup["variables"])
    start = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    trainer = Trainer(tm, tloss, cfg, HORIZON,
                      batch_args=lambda b: (b["pos"], b["fx"]))
    got_rates, small = [], set()
    for step in range(STEPS):
        got_rates.append(trainer.optimizer.param_groups[0]["lr"])
        m = trainer.train_step(setup["batch"])
        np.testing.assert_allclose(float(m["loss"]), losses[step],
                                   rtol=1e-5, err_msg=f"{setting} {step}")
        if step == 0:
            sd = tm.state_dict()
            for k, v in stats.items():
                if k.endswith("num_batches_tracked"):
                    assert int(sd[k]) == cfg.accum_steps, k   # once each
                    continue
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                           rtol=1e-5, err_msg=k)
            gmax = max(float(p.grad.abs().max())
                       for p in trainer._grad_params)
            small = {k for k, p in tm.named_parameters()
                     if p.grad is not None
                     and float(p.grad.abs().max()) < 1e-3 * gmax}
    np.testing.assert_allclose(got_rates, rates, rtol=1e-5, atol=1e-12)
    bound = 2 * sum(rates)
    scale = max(float(v.abs().max()) for v in params.values())
    worst = 0.0
    for k, p in tm.named_parameters():
        got, want = p.detach().numpy(), params[k].numpy()
        err = float(np.abs(got - want).max())
        if k in small:
            assert err <= bound, (setting, k, err, bound)
            continue
        assert err <= PARAM_RTOL * scale, (setting, k, err, scale)
        worst = max(worst, err / scale)
    sig = [k for k in start if k.endswith("sigma_att")]
    assert sig
    for k in sig:
        assert torch.equal(tm.state_dict()[k], start[k])
        assert torch.equal(params[k], start[k])
    # the unused placeholder: decayed by 1 - lr * wd at each step, alone
    decay = np.prod([1 - r * cfg.weight_decay for r in rates])
    ph = tm.placeholder.detach().numpy()
    np.testing.assert_allclose(ph, start["placeholder"].numpy() * decay,
                               rtol=1e-6)
    assert np.abs(ph - start["placeholder"].numpy()).max() > 1e-4 * np.abs(
        ph).max()
    print(f"PARITY {setting}: params after {STEPS} steps within "
          f"{worst:.3e} of max |param|; {len(small)} leaves of small "
          f"gradients within "
          f"{bound:.2e}")


def test_accum_steps_must_divide_the_batch(setup):
    cfg = TrainConfig(**dict(SETTINGS["adamw_accum2"], accum_steps=3))
    tm = TModel(**MODEL, device="cpu")
    trainer = Trainer(tm, tloss, cfg, HORIZON,
                      batch_args=lambda b: (b["pos"], b["fx"]))
    with pytest.raises(ValueError, match="accum_steps=3"):
        trainer.train_step(setup["batch"])
