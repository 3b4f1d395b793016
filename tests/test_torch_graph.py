"""PyTorch port, the training step as CUDA graphs: what the CPU can hold.

On the card ``Trainer.train_step`` replays a CUDA graph of the whole step
and ``Trainer.train_steps`` one graph of K steps (``haet_torch.train.graphs``);
``chip_smoke.py`` phase 9 holds them against the eager step there. Here:

* ``Trainer.train_steps`` (K = 4 eager steps on the CPU) against the JAX
  package's ``Trainer.train_steps`` (one ``lax.scan``) on the same numpy
  weights and 4 car-like batches of one signature, with ``cycle_momentum``
  on, clipping at 1.0 and a horizon of 7, so that the rate and beta1 change
  at every step: losses at rtol 1e-5, every parameter within the bound of
  ``test_torch_train.py`` (2 x the sum of the steps' rates).
* The port's Adam, which reads lr and beta1 from a tensor, under torch's
  ``OneCycleLR``, against ``torch.optim.Adam`` with the same scheduler on
  floats over 10 steps: lr and beta1 equal per step (as float32),
  parameters at rtol 1e-6.
* A ``torch.optim.Adam`` state loads into the port's Adam in place and
  both step alike after it (rtol 1e-6).
* The storage of the training state (every gradient, Adam's state, lr and
  beta1, the BatchNorm buffers, the parameters) survives ``train_step``,
  ``grad_leaf_norms``, a restore from a ``Checkpointer`` file and
  ``train_steps``; the restore copies the file's values.
* The profiler's kernel names mapped to the port's kernels; batch
  signatures.
* ``bench_loop_diag`` and ``haet_torch.bench`` on the CPU, where there is
  no CUDA graph.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch import bench
from haet_torch.benchmarks import bench_loop_diag
from haet_torch.data.shapenet_car import CarSample as TCarSample
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.ops.kernels import count_kernels, port_kernel
from haet_torch.train import Checkpointer, Trainer, make_optimizer
from haet_torch.train import car as tcar
from haet_torch.train.graphs import signature
from haet_torch.utils.config import shapenet_car_train_config
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel
from haet_tpu.ops.pallas import erwin_block as jeb
from haet_tpu.ops.pallas import slice_kernels as jsk
from haet_tpu.train import Trainer as JTrainer
from haet_tpu.train.trainer import TrainState
from haet_tpu.utils.config import TrainConfig as JTrainConfig
from test_torch_model import init_like

MODEL = dict(space_dim=7, fun_dim=0, out_dim=4, n_layers=1, n_hidden=32,
             n_head=4, slice_num=16, mlp_ratio=2, enc_num_heads=(2, 4),
             enc_depths=(1, 1), dec_num_heads=(2,), dec_depths=(1,),
             erwin_mlp_ratio=4, embed=True, rotate=45)
N_POINTS, N_PAD, N_SURF = 200, 256, 40
K, HORIZON = 4, 7


@pytest.fixture(scope="module", autouse=True)
def interpret_and_threads():
    modes = jsk.INTERPRET, jeb.INTERPRET
    jsk.INTERPRET = jeb.INTERPRET = True
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    jsk.INTERPRET, jeb.INTERPRET = modes
    torch.set_num_threads(threads)


def _batch(seed):
    rng = np.random.RandomState(seed)
    surf = np.zeros(N_POINTS, bool)
    surf[-N_SURF:] = True   # surface points come last in a car sample
    return tcar.make_batch(TCarSample(
        rng.rand(N_POINTS, 3).astype(np.float32),
        rng.randn(N_POINTS, 7).astype(np.float32),
        rng.randn(N_POINTS, 4).astype(np.float32), surf), n_pad=N_PAD)


@pytest.fixture(scope="module")
def small():
    """K batches of one signature and numpy weights for the small HAET."""
    batches = [_batch(seed) for seed in range(K)]
    template = jax.eval_shape(JModel(**MODEL).init, jax.random.PRNGKey(0),
                              batches[0]["x"])
    return batches, init_like(template, np.random.RandomState(0),
                              MODEL["n_hidden"])


def _port_trainer(variables, total_steps=HORIZON):
    tm = TModel(**MODEL, device="cpu")
    load_jax_variables(tm, variables)
    return Trainer(tm, tcar.loss_fn_builder(0.5),
                   shapenet_car_train_config(), total_steps,
                   batch_args=lambda b: (b["x"], None))


def test_train_steps_match_jax(small):
    batches, variables = small
    jm = JModel(**MODEL)
    jcfg = JTrainConfig(lr=1e-3, optimizer="adam", final_div_factor=1000.0,
                        batch_size=1, max_grad_norm=1.0)
    assert jcfg.cycle_momentum
    jtr = JTrainer(model=jm, loss_fn=tcar_jax_loss(), cfg=jcfg,
                   total_steps=HORIZON, batch_args=lambda b: (b["x"], None))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jtr.tx.init(variables["params"]))
    state, jm_metrics = jtr.train_steps(state, batches,
                                        jax.random.PRNGKey(1))

    trainer = _port_trainer(variables)
    lrs, beta1s = [], []
    with warnings.catch_warnings():   # a twin schedule, stepped alone
        warnings.simplefilter("ignore")
        for _ in range(K):
            lrs.append(trainer.optimizer.param_groups[0]["lr"])
            beta1s.append(trainer.optimizer.param_groups[0]["betas"][0])
            trainer.advance_schedule()
    assert len(set(lrs)) == K and len(set(beta1s)) == K
    trainer = _port_trainer(variables)
    metrics = trainer.train_steps(batches)
    assert trainer.step == K
    assert sorted(metrics) == sorted(jm_metrics)
    for k, v in metrics.items():
        assert v.shape == (K,), k
    # float32 through 1 layer and 3 Erwin blocks, sums in other orders
    np.testing.assert_allclose(metrics["loss"].numpy(),
                               np.asarray(jm_metrics["loss"]), rtol=1e-5)
    jparams = {k: v.numpy() for k, v in from_jax_variables(
        {"params": jax.device_get(state.params)}).items()}
    # test_torch_train.py's bound: Adam moves an entry by about +-lr a step
    # whatever its gradient's size
    bound = 2 * sum(lrs)
    for name, p in trainer.model.named_parameters():
        err = float(np.abs(p.detach().numpy() - jparams[name]).max())
        assert err <= bound, (name, err, bound)


def tcar_jax_loss():
    """``benchmarks/car_train.py``'s loss (its module is the JAX driver)."""
    import os
    import sys

    bench_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmarks")
    if bench_dir not in sys.path:
        sys.path.insert(0, bench_dir)
    import car_train

    return car_train.loss_fn_builder(0.5)


def test_tensor_hparams_adam_matches_float_adam():
    cfg = shapenet_car_train_config()
    assert cfg.cycle_momentum
    rng = np.random.RandomState(5)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(10)]
    ours = [torch.tensor(a, requires_grad=True) for a in init]
    ref = [torch.tensor(a, requires_grad=True) for a in init]
    opt, sched = make_optimizer(cfg, 10, ours)
    ref_opt = torch.optim.Adam(ref, lr=cfg.lr)
    ref_sched = torch.optim.lr_scheduler.OneCycleLR(
        ref_opt, max_lr=cfg.lr, total_steps=10, pct_start=cfg.pct_start,
        anneal_strategy="cos", cycle_momentum=True,
        base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
        div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
    lr_ptr = opt.hparams.data_ptr()
    for step in range(10):
        for p, q, g in zip(ours, ref, grads[step]):
            p.grad = torch.from_numpy(g.copy())
            q.grad = torch.from_numpy(g.copy())
        want = ref_opt.param_groups[0]
        opt.step()
        ref_opt.step()
        lr, beta1 = opt.hparams[0].tolist()
        assert lr == np.float32(want["lr"]), step
        assert beta1 == np.float32(want["betas"][0]), step
        for p, q in zip(ours, ref):
            np.testing.assert_allclose(p.detach().numpy(),
                                       q.detach().numpy(), rtol=1e-6,
                                       atol=1e-9)
        sched.step()
        ref_sched.step()
        # the groups keep the scheduler's floats; the tensor its storage
        assert isinstance(opt.param_groups[0]["betas"][0], float)
        assert opt.hparams.data_ptr() == lr_ptr


def test_adam_loads_torch_adam_state_in_place():
    """A ``torch.optim.Adam`` state (CPU step counts, float rates) loads
    into the port's Adam in place, and the next steps of both agree; a
    state whose parameters stepped apart is refused."""
    rng = np.random.RandomState(6)
    init = [rng.randn(4, 3).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    ref = [torch.tensor(a, requires_grad=True) for a in init]
    ref_opt = torch.optim.Adam(ref, lr=1e-3, betas=(0.9, 0.999))
    for _ in range(3):
        for q in ref:
            q.grad = torch.from_numpy(rng.randn(*q.shape).astype(np.float32))
        ref_opt.step()
    ours = [torch.tensor(q.detach().numpy(), requires_grad=True) for q in ref]
    opt, _ = make_optimizer(shapenet_car_train_config(), 10, ours)
    ptrs = [t.data_ptr() for st in opt.state.values() for t in st.values()]
    opt.load_state_dict(ref_opt.state_dict())
    assert ptrs == [t.data_ptr() for st in opt.state.values()
                    for t in st.values()]
    assert opt.param_groups[0]["lr"] == 1e-3
    assert opt.param_groups[0]["betas"] == (0.9, 0.999)
    for p, q in zip(ours, ref):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], ref_opt.state[q][k]), k
    for _ in range(2):
        for p, q in zip(ours, ref):
            g = rng.randn(*q.shape).astype(np.float32)
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        opt.step()
        ref_opt.step()
    for p, q in zip(ours, ref):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    apart = ref_opt.state_dict()
    apart["state"][1]["step"] = torch.tensor(2.0)
    with pytest.raises(ValueError, match="step together"):
        opt.load_state_dict(apart)


def _storage(trainer) -> dict:
    """``{what: data_ptr}`` of every tensor of the training state."""
    ptrs = {f"param {k}": p.data_ptr()
            for k, p in trainer.model.named_parameters()}
    ptrs.update({f"grad {k}": p.grad.data_ptr()
                 for k, p in trainer.model.named_parameters()
                 if p.grad is not None})
    ptrs.update({f"buffer {k}": b.data_ptr()
                 for k, b in trainer.model.named_buffers()})
    for i, p in enumerate(trainer.params):
        for k, t in trainer.optimizer.state[p].items():
            ptrs[f"adam {i} {k}"] = t.data_ptr()
    ptrs["lr, beta1"] = trainer.optimizer.hparams.data_ptr()
    return ptrs


def test_training_state_keeps_its_storage(small, tmp_path):
    batches, variables = small
    trainer = _port_trainer(variables, total_steps=16)
    trainer.train_step(batches[0])
    for k, p in trainer.model.named_parameters():   # all but sigma_att
        assert (p.grad is None) == k.endswith("sigma_att"), k
    want = _storage(trainer)
    ck = Checkpointer(str(tmp_path))
    ck.save_last(trainer.state_dict(), 0)
    saved = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    saved_adam = [t.clone() for st in trainer.optimizer.state.values()
                  for t in st.values()]

    trainer.train_step(batches[1])
    assert _storage(trainer) == want, "train_step"
    trainer.grad_leaf_norms(batches[2])
    assert _storage(trainer) == want, "grad_leaf_norms"
    assert trainer.maybe_restore(ck)
    assert _storage(trainer) == want, "load_state_dict"
    assert trainer.step == 1
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for t, w in zip((t for st in trainer.optimizer.state.values()
                     for t in st.values()), saved_adam):
        assert torch.equal(t, w)
    trainer.train_steps(batches[:3])
    assert _storage(trainer) == want, "train_steps"
    assert trainer.step == 4


def test_train_steps_takes_one_signature(small):
    batches, variables = small
    trainer = _port_trainer(variables)
    other = {**batches[1], "x": batches[1]["x"][:, :128]}
    with pytest.raises(ValueError, match="one signature"):
        trainer.train_steps([batches[0], other])
    with pytest.raises(ValueError, match="at least one"):
        trainer.train_steps([])
    assert signature(batches[0]) == signature(batches[1])
    assert signature({"x": batches[0]["x"], "fx": None}) == (
        ("fx", None), ("x", (1, N_PAD, 7), torch.float32))
    assert trainer.graphs is None   # the CPU: every step eager


# demangled names as the profiler prints them, in launch order: one car
# layer's slice forwards and backwards and one Erwin block each way
KERNELS = (
    "void slice_states_fast<32, 32>(float const*, float const*, int)",
    "void erwin_block_fwd<false>(float const*, float const*, float*)",
    "void deslice_fast<32, 32, true>(float const*, float*)",
    "void at::native::elementwise_kernel<128, 4>(int, float)",
    "void slice_bwd_f32<32, 1, 3>(float const*, float const*, float)",
    "sum_partials(float const*, int, int, SumOut)",
    "void slice_bwd_f32<32, 1, 0>(float const*, float const*, float)",
    "sum_partials(float const*, int, int, SumOut)",
    "void erwin_block_bwd<true>(float const*, float*)",
    "erwin_block_sum_partials(float const*, float*, int, int)",
    "void slice_bwd_generic<1>(float const*, float)",
    "sum_partials(float const*, int, int, SumOut)",
    "void slice_bwd_generic<2>(float const*, float)",
    "sum_partials(float const*, int, int, SumOut)",
    "slice_partials_generic(float const*, int)",
    "slice_merge_generic(float const*, int)",
    "void copy_scale<float4, 1, unsigned int>(float4 const*, float4*)",
)


def test_profiled_kernel_names_map_to_the_port():
    got = count_kernels(KERNELS)
    assert got["calls"] == {
        "slice_states": 2, "deslice": 1, "slice_states_bwd": 1,
        "deslice_bwd": 1, "fused_erwin_block": 1,
        "fused_erwin_block_bwd": 1, "copy_scale": 1}
    assert got["launches"] == {
        "slice_states": 3, "deslice": 1, "slice_states_bwd": 4,
        "deslice_bwd": 4, "fused_erwin_block": 1,
        "fused_erwin_block_bwd": 2, "copy_scale": 1}
    assert got["kernels"] == len(KERNELS) and got["other"] == 1
    assert port_kernel("erwin_block_sum_partials(float const*)") == (
        "fused_erwin_block_bwd", False)
    with pytest.raises(ValueError, match="follows no slice backward"):
        count_kernels(["sum_partials(float const*)"])


def test_bench_loop_diag_cpu():
    res = bench_loop_diag.main(["--device", "cpu", "--variants",
                                "dispatched", "--points", "128", "--ks",
                                "1,2", "--rounds", "1"])
    assert list(res) == ["dispatched"]
    windows = res["dispatched"]["ms_per_window"]
    assert sorted(windows) == [1, 2]
    assert all(np.isfinite(v) and v > 0 for v in windows.values())
    assert np.isfinite(res["dispatched"]["sec_per_step"])
    for variants in (bench_loop_diag.VARIANTS, ["graph-tied"]):
        with pytest.raises(ValueError, match="cpu"):
            bench_loop_diag.run("cpu", points=128, ks=(1, 2), rounds=1,
                                variants=variants)


def test_bench_cpu_has_no_graph_strategy(monkeypatch):
    monkeypatch.setattr(bench, "N_POINTS", 128)
    monkeypatch.setattr(bench, "K_LO", 1)
    monkeypatch.setattr(bench, "K_HI", 2)
    rec = bench.run(device="cpu", budget_s=0.0, rounds=1)
    assert rec["graph_sec_per_step"] is None
    assert rec["graph_is_upper_bound"] is None
    assert rec["graph_note"] == bench.GRAPH_NOTE_CPU
    assert "CPU" in rec["graph_note"]
    assert rec["strategy"] == "dispatch"
    assert rec["sec_per_step"] == rec["dispatch_sec_per_step"] > 0


def test_eager_flag_and_cpu_trainer(small):
    """``eager`` selects the per-op step on a card; on the CPU the step is
    eager whatever it says, and the trainer's config is untouched."""
    _, variables = small
    tm = TModel(**MODEL, device="cpu")
    load_jax_variables(tm, variables)
    cfg = shapenet_car_train_config()
    for eager in (False, True):
        trainer = Trainer(tm, tcar.loss_fn_builder(0.5), cfg, HORIZON,
                          batch_args=lambda b: (b["x"], None), eager=eager)
        assert trainer.graphs is None
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        shapenet_car_train_config())
