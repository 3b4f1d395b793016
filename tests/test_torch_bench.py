"""PyTorch port, the benchmark drivers vs the JAX package's drivers.

* One chain step of ``micro_erwin_fused`` (the forward, and the
  forward+backward update ``v + 1e-6 grad_v sum(out**2)``) against the JAX
  ``ErwinTransformerBlock`` at the micro shape, weights carried over by
  ``haet_torch.utils.weights``: within 1e-5 of max |out|.
* One ``haet_torch.bench`` step against ``bench.py``'s ``train_step``
  (``:107-119``, local to ``main()`` and re-created here) on a tiny model:
  the loss to rtol 1e-5 and every gradient leaf to 1e-4 of its max (with
  a floor for the leaves whose gradient is round-off).
* The directly built models' parameter counts against the JAX ones
  (``jax.eval_shape``, no compile).
* ``find_max_n`` against ``pallas_mem_sweep.find_max_n`` under one fake
  probe; ``classify_failure``; the timing arithmetic under a fake clock;
  ``StepTimer`` against the JAX one.
* Every driver's ``main`` on the CPU at toy sizes, as plumbing: CPU times
  are no device metric, and the drivers report none (``device_*`` None).
"""

import contextlib
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haet_torch import bench
from haet_torch.benchmarks import bench_flags, mem_sweep, profile_step
from haet_torch.benchmarks import micro_erwin_fused as micro
from haet_torch.benchmarks import timing, trace_loss
from haet_torch.benchmarks import velocity_mem_checker as velocity
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.ops.kernels import launch_counts, reset_launch_counts
from haet_torch.utils import profiling as tprof
from haet_torch.utils.weights import from_jax_variables, load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel
from haet_tpu.models.erwin import ErwinTransformer as JErwin
from haet_tpu.models.erwin import ErwinTransformerBlock as JBlock
from haet_tpu.models.physics_attention import \
    PhysicsAttentionIrregularMesh as JPhysicsAttention
from haet_tpu.utils import profiling as jprof

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fill(template, rng):
    """numpy variables for a JAX shape tree: unit-ish norms, ``sigma_att``
    near -1, everything else ``0.1 N(0, 1)``; BatchNorm statistics off
    (0, 1)."""
    def leaf(path, sds):
        name = path[-1].key
        if name == "var":
            return (0.5 + rng.rand(*sds.shape)).astype(np.float32)
        if name == "scale":
            base = np.ones(sds.shape)
        elif name == "sigma_att":
            base = -np.ones(sds.shape)
        else:
            base = np.zeros(sds.shape)
        return (base + 0.1 * rng.randn(*sds.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, template)


def _n_params(template) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in
               jax.tree_util.tree_leaves(template["params"]))


# ---------------------------------------------------------------------------
# The micro driver's chain step.
# ---------------------------------------------------------------------------

def test_micro_chain_step_matches_jax():
    x, pos = (t.numpy() for t in micro.inputs("cpu"))
    jblk = JBlock(dim=micro.C, num_heads=micro.HEADS, ball_size=micro.BALL,
                  mlp_ratio=micro.MLP_RATIO, dimensionality=micro.D,
                  use_dist_bias=True)
    template = jax.eval_shape(jblk.init, jax.random.PRNGKey(0), x, pos)
    variables = _fill(template, np.random.RandomState(1))

    @jax.jit
    def jax_steps(v):
        """``micro_erwin_fused.py:92-108``: one forward, one update."""
        out = jblk.apply(variables, v, pos)
        g = jax.grad(lambda u: jnp.sum(jblk.apply(variables, u, pos) ** 2))(v)
        return out, g, v + 1e-6 * g

    want_out, want_g, want_upd = (np.asarray(a) for a in jax_steps(x))
    xt, pt = torch.from_numpy(x), torch.from_numpy(pos)
    for blk in micro.blocks("cpu"):
        load_jax_variables(blk, jax.device_get(variables))
        out = micro.fwd_step(blk, pt)(xt).numpy()
        upd = micro.fwd_bwd_step(blk, pt)(xt).numpy()
        # the update hides the gradient under x's round-off: hold the
        # gradient itself too
        g = micro.sq_grad(blk, xt, pt).numpy()
        for name, got, want in (("fwd", out, want_out), ("grad", g, want_g),
                                ("fwd+bwd", upd, want_upd)):
            err, scale = np.abs(got - want).max(), np.abs(want).max()
            print(f"PARITY micro {name} use_pallas={blk.use_pallas}: "
                  f"max_abs_err {err:.3e} max|ref| {scale:.3e}")
            assert err <= 1e-5 * scale, (name, blk.use_pallas, err, scale)


# ---------------------------------------------------------------------------
# The bench step.
# ---------------------------------------------------------------------------

TINY = dict(space_dim=7, fun_dim=0, out_dim=4, n_layers=1, n_hidden=32,
            n_head=4, slice_num=16, mlp_ratio=2, rotate=45,
            enc_num_heads=(2, 4), enc_depths=(1, 1), dec_num_heads=(2,),
            dec_depths=(1,), erwin_mlp_ratio=4, embed=True)


def test_bench_step_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(1, 256, 7).astype(np.float32)
    y = rng.randn(1, 256, 4).astype(np.float32)
    jm = JModel(**TINY)
    variables = _fill(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x,
                                     None), rng)

    @jax.jit
    def jax_loss_and_grads(params):
        """The loss of ``bench.py:109-115``, and its gradients."""
        def loss_fn(p):
            out, upd = jm.apply(
                {"params": p, "batch_stats": variables["batch_stats"]}, x,
                None, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            return (jnp.mean((out.astype(jnp.float32) - y) ** 2),
                    upd["batch_stats"])
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, grads

    jloss, jgrads = jax_loss_and_grads(variables["params"])
    tm = TModel(**TINY, device="cpu")
    load_jax_variables(tm, jax.device_get(variables))
    loss = bench.make_train_step(tm, torch.from_numpy(y))(
        torch.from_numpy(x))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = from_jax_variables({"params": jax.device_get(jgrads)})
    gmax = max(float(v.abs().max()) for v in want.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        if name.endswith("sigma_att"):
            assert p.grad is None and not want[name].any(), name
            continue
        got, w = p.grad.numpy(), want[name].numpy()
        err, scale = float(np.abs(got - w).max()), float(np.abs(w).max())
        # or 1e-6 of the largest |gradient| for leaves whose own max is
        # about that size: zero up to round-off (biases in front of a
        # train-mode BatchNorm) or close (the position projections, ~3e-7
        # of it here); the leaves above it agree within 2e-5 of their max
        assert err <= max(1e-4 * scale, 1e-6 * gmax), (name, err, scale)
        if scale > 1e-5 * gmax:
            worst = max(worst, err / scale)
    print(f"PARITY bench step: loss {float(loss):.6f} vs {float(jloss):.6f};"
          f" largest gradient error over its leaf's max {worst:.3e}")


# ---------------------------------------------------------------------------
# Parameter counts of the directly built models.
# ---------------------------------------------------------------------------

def _jax_count(case):
    rng = np.random.RandomState(0)
    if case == "bench_flags":
        m = JModel(space_dim=7, fun_dim=0, out_dim=4, n_layers=2,
                   n_hidden=256, n_head=8, slice_num=32, mlp_ratio=2,
                   rotate=45)
        args = (rng.randn(1, 64, 7).astype(np.float32), None)
    elif case == "profile_step car":
        m = JModel(space_dim=7, fun_dim=0, out_dim=4, n_layers=2,
                   n_hidden=256, n_head=8, slice_num=32, mlp_ratio=2,
                   rotate=45, enc_num_heads=(8, 8), enc_depths=(4, 4),
                   dec_num_heads=(8,), dec_depths=(4,), erwin_mlp_ratio=4,
                   embed=True)
        args = (rng.randn(1, 64, 7).astype(np.float32), None)
    elif case == "profile_step physics attention":
        m = JPhysicsAttention(dim=256, heads=8, dim_head=32, slice_num=32,
                              mlp_ratio=2, rotate=45)
        args = (rng.randn(1, 64, 256).astype(np.float32),)
    elif case == "profile_step erwin stage":
        m = JErwin(c_in=32, c_hidden=(32, 64), ball_sizes=(32, 16),
                   enc_num_heads=(4, 8), enc_depths=(2, 2),
                   dec_num_heads=(4,), dec_depths=(2,), strides=(2,),
                   rotate=45, mp_steps=0, embed=False, mlp_ratio=2,
                   dimensionality=3)
        args = (rng.randn(8, 32, 32).astype(np.float32),
                rng.rand(8, 32, 3).astype(np.float32))
    else:   # the memory probes' model
        m = JModel(space_dim=3, fun_dim=1, out_dim=1, n_layers=1,
                   n_hidden=256, n_head=8, slice_num=32, mlp_ratio=2,
                   rotate=45)
        args = (rng.rand(1, 64, 3).astype(np.float32),
                rng.rand(1, 64, 1).astype(np.float32))
    return _n_params(jax.eval_shape(m.init, jax.random.PRNGKey(0), *args))


def _torch_model(case):
    return {
        "bench_flags": lambda: bench_flags.build_model("baseline",
                                                       device="cpu"),
        "profile_step car": lambda: profile_step.build_car_model("cpu"),
        "profile_step physics attention":
            lambda: profile_step.build_physics_attention("cpu"),
        "profile_step erwin stage":
            lambda: profile_step.build_erwin_stage("cpu"),
        "mem_sweep": lambda: mem_sweep.build_model(True, device="cpu"),
    }[case]()


@pytest.mark.parametrize("case", [
    "bench_flags", "profile_step car", "profile_step physics attention",
    "profile_step erwin stage", "mem_sweep"])
def test_driver_models_match_jax_param_counts(case):
    n = sum(p.numel() for p in _torch_model(case).parameters())
    assert n == _jax_count(case)
    if case == "profile_step car":
        assert n == 1_757_190


# ---------------------------------------------------------------------------
# The memory sweep's search and failure classes.
# ---------------------------------------------------------------------------

def _jax_mem_sweep():
    spec = importlib.util.spec_from_file_location(
        "jax_pallas_mem_sweep", ROOT / "benchmarks" / "pallas_mem_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("boundary", [0, 700_000, 3_000_000, 50_000_000,
                                      10 ** 9])
def test_find_max_n_matches_jax(monkeypatch, boundary):
    jms = _jax_mem_sweep()
    seen = {"jax": [], "torch": []}

    def fake(tag):
        def probe(n, use_pallas, *args, **kw):
            seen[tag].append(n)
            if n <= boundary:
                return {"num_points": n, "ok": True}
            return {"num_points": n, "ok": False, "failure": "oom"}
        return probe

    monkeypatch.setattr(jms, "probe_subprocess", fake("jax"))
    monkeypatch.setattr(mem_sweep, "probe_subprocess", fake("torch"))
    want = jms.find_max_n(True, 1_000_000, 128_000_000, lambda r: None)
    got = mem_sweep.find_max_n(True, 1_000_000, 128_000_000, lambda r: None)
    assert got == want
    assert seen["torch"] == seen["jax"]


def test_classify_failure_on_cuda_messages():
    oom = ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
           "2.00 GiB. GPU 0 has a total capacity of 79.19 GiB")
    assert mem_sweep.classify_failure(oom) == "oom"
    assert mem_sweep.classify_failure(
        "RuntimeError: CUDA error: an illegal memory access") == "other"
    rec = mem_sweep.run_classified_subprocess(
        [sys.executable, "-c", f"import sys; sys.exit({oom!r})"],
        {"num_points": 5, "pallas": True})
    assert rec["failure"] == "oom" and rec["oom"] and not rec["ok"]
    assert "CUDA out of memory" in rec["error_tail"]
    rec = mem_sweep.run_classified_subprocess(
        [sys.executable, "-c",
         "print('noise'); print('{\"num_points\": 5, \"ok\": true}')"],
        {"num_points": 5, "pallas": True})
    assert rec == {"num_points": 5, "ok": True}


# ---------------------------------------------------------------------------
# Timing arithmetic and the profiling helpers.
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_timed_cancels_the_window_cost(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "perf_counter", clock)
    order = []

    def make_fn(reps):
        def run(x):
            order.append(reps)
            clock.now += 0.5 + 0.002 * reps      # fixed cost + per call
            return x
        return run

    t = timing.timed(make_fn, torch.ones(2), lo=5, hi=25, rounds=3)
    assert t == pytest.approx(0.002, rel=1e-9)
    assert order == [5, 25] * 4          # one warm-up, then interleaved
    assert timing.fmt(t).strip() == "2.000 ms"


@pytest.mark.parametrize("rounds, budget_s, max_rounds, want", [
    (3, 0.0, 0, 3), (2, 3.5, 16, 2), (2, 5.0, 16, 3), (2, 100.0, 4, 4)])
def test_interleaved_minima_runs_to_its_budget(monkeypatch, rounds, budget_s,
                                               max_rounds, want):
    clock = FakeClock()
    monkeypatch.setattr(timing, "perf_counter", clock)

    def fn():
        clock.now += 1.0                   # every window takes 1 s
        return torch.zeros(())

    best, n = timing.interleaved_minima({"a": fn, "b": fn}, rounds=rounds,
                                        budget_s=budget_s,
                                        max_rounds=max_rounds)
    assert n == want
    assert best == {"a": 1.0, "b": 1.0}


def test_per_call_falls_back_to_the_hi_window():
    assert timing.per_call(1.0, 3.0, 5, 25) == (pytest.approx(0.1), False)
    # drift larger than the work: never faster than the hi window allows
    assert timing.per_call(3.0, 2.5, 5, 25) == (pytest.approx(0.1), True)
    assert timing.fmt(-1e-3).strip() == "below drift noise"


def test_fetch_and_loop():
    out = timing.loop(lambda v: v + 1)(3)(torch.zeros(2))
    assert timing.fetch({"a": out, "b": (out, [out])}) == 18.0
    with pytest.raises(TypeError):
        timing.fetch(None)
    assert timing.device_us_per_call(lambda r: None, reps=3,
                                     device="cpu") is None


def test_step_timer_matches_jax(tmp_path):
    tt, jt = tprof.StepTimer(), jprof.StepTimer()
    assert tt.metrics() == jt.metrics() == {}
    tt.times = [0.1, 0.3, 0.2]
    jt.times = list(tt.times)
    assert tt.metrics() == jt.metrics()
    assert tt.metrics("eval/") == jt.metrics("eval/")
    with tt.step():
        pass
    assert len(tt.times) == 4 and tt.times[-1] >= 0
    assert tprof.device_memory_mb("cpu") is None
    assert tprof.host_rss_mb() > 0
    with tprof.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


class FakeProfile:
    """A finished profile whose first ``lost`` device records are gone, as
    the card's profiler drops them late in a process."""

    def __init__(self, lost):
        cuda = torch.autograd.DeviceType.CUDA
        names = ([tprof.SENTINEL_KERNEL + "(long)"] * tprof.SENTINELS
                 + ["slice_states_fast<32, 32, float>", "Memset (Device)"])
        self.device = [types.SimpleNamespace(name=n, key=n, device_type=cuda)
                       for n in names[lost:]]
        self.host = [types.SimpleNamespace(
            name="cudaLaunchKernel", key="cudaLaunchKernel",
            device_type=torch.autograd.DeviceType.CPU)]

    def events(self):
        return self.host + self.device

    def key_averages(self):
        return self.events()


@pytest.mark.parametrize("lost", [0, 5, tprof.SENTINELS - 1,
                                  tprof.SENTINELS, tprof.SENTINELS + 1])
def test_device_trace_sentinels_take_the_profilers_loss(lost):
    trace = tprof.DeviceTrace(FakeProfile(lost))
    if lost >= tprof.SENTINELS:
        with pytest.raises(RuntimeError, match="sentinel"):
            trace.finish()
        return
    trace.finish()
    assert trace.lost == lost
    for events in (trace.events(), trace.key_averages()):
        assert [e.name for e in events] == [
            "cudaLaunchKernel", "slice_states_fast<32, 32, float>",
            "Memset (Device)"]


@pytest.mark.parametrize("host", [True, False])
def test_device_trace_records_the_host_unless_told_not(monkeypatch, host):
    """``device_trace(host=False)`` asks the profiler for the CUDA activity
    alone; the default records the host too."""
    from torch.profiler import ProfilerActivity

    asked = []

    @contextlib.contextmanager
    def profile(activities):
        asked.append(activities)
        yield FakeProfile(0)

    monkeypatch.setattr(torch.profiler, "profile", profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(tprof, "TRACE_MARGIN_S", 0.0)
    with tprof.device_trace(host) as trace:
        pass
    assert trace.lost == 0
    assert asked == [[ProfilerActivity.CPU, ProfilerActivity.CUDA] if host
                     else [ProfilerActivity.CUDA]]


# ---------------------------------------------------------------------------
# Every driver on the CPU at toy sizes (plumbing).
# ---------------------------------------------------------------------------

def test_drivers_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (micro.run, bench_flags.run, profile_step.run, bench.run):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trace_loss.main([])
    with pytest.raises(RuntimeError, match="no CPU form"):
        trace_loss.run(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mem_sweep.run_probe(64, True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        velocity.benchmark_model(64)


def test_micro_main_cpu(capsys):
    reset_launch_counts()
    res = micro.main(["--device", "cpu", "--reps_lo", "1", "--reps_hi", "2",
                      "--rounds", "1"])
    assert set(res) == {"copy_scale", "plain block fwd", "fused block fwd",
                        "plain block fwd+bwd", "fused block fwd+bwd",
                        "copy_calls"}
    assert res["copy_calls"] == 2 * (1 + 2)   # warm-up + 1 round
    assert all(res[k]["device_us"] is None for k in res if k != "copy_calls")
    assert sum(launch_counts().values()) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res


def test_bench_flags_main_cpu():
    res = bench_flags.main(["--device", "cpu", "--points", "128",
                            "--n_hidden", "32", "--n_layers", "1",
                            "--slice_num", "16", "--k_lo", "1", "--k_hi",
                            "2", "--rounds", "1"])
    assert list(res) == list(bench_flags.VARIANTS)
    for r in res.values():
        assert r["erwin_blocks"] == 6          # depths 2/2/2, one layer
        assert r["steps"] == 1 + 2 * (1 + 2)   # first, warm-up, 1 round
        assert r["device_ms_per_step"] is None
        assert set(r["launches_per_step"]) == set(launch_counts())
        assert not any(r["launches_per_step"].values())   # CPU: no kernel
        assert not any(r["plain_routes_per_step"].values())


def test_profile_step_main_cpu():
    res = profile_step.main(["--device", "cpu", "--points", "128", "--lo",
                             "1", "--hi", "2", "--rounds", "1"])
    assert len(res) == 7
    assert all(r["device_ms"] is None for r in res.values())


def test_bench_main_cpu(monkeypatch):
    monkeypatch.setattr(bench, "N_POINTS", 128)
    monkeypatch.setattr(bench, "K_LO", 1)
    monkeypatch.setattr(bench, "K_HI", 2)
    rec = bench.main(["--device", "cpu", "--rounds", "1", "--budget_s",
                      "0"])
    assert rec["dtype"] == "float32" and rec["device"] == "cpu"
    assert rec["value"] > 0 and rec["step_tflops"] > 0
    assert rec["rounds"] == 1
    assert rec["mfu"] is None and rec["probe_tflops"] is None
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.BASELINE_PPS)


def test_mem_sweep_main_cpu(monkeypatch, capsys, tmp_path):
    assert mem_sweep.main(["--probe", "256", "--pallas", "1", "--device",
                           "cpu"]) == 0
    probe = json.loads(capsys.readouterr().out.splitlines()[-1])
    # the probe runs bf16, as pallas_mem_sweep.run_probe does
    assert probe["ok"] and probe["peak_memory_mb"] is None
    assert probe["dtype"] == "bfloat16"
    for bf16 in (True, False):
        rec = mem_sweep.run_probe(64, True, bf16=bf16, grad=True,
                                  device="cpu")
        assert rec["ok"]
        assert rec["dtype"] == ("bfloat16" if bf16 else "float32")

    def probe_fn(n, use_pallas, *a, **k):
        ok = n <= (4_000_000 if use_pallas else 2_000_000)
        return {"num_points": n, "ok": ok, **({} if ok else
                                              {"failure": "oom"})}

    monkeypatch.setattr(mem_sweep, "probe_subprocess", probe_fn)
    out = tmp_path / "sweep.jsonl"
    assert mem_sweep.main(["--out", str(out), "--device", "cpu"]) == 0
    summary = json.loads(out.read_text().splitlines()[-1])
    assert summary["max_points_plain"] == 2_000_000
    assert summary["max_points_kernel"] == 4_000_000
    assert summary["kernel_headroom_x"] == 2.0
    assert summary["plain_boundary_failure"] == "oom"


def test_velocity_main_cpu(monkeypatch, capsys):
    # the checker's plumbing on a narrow model, in windows of 2 and 4
    # chained forwards in place of 2 and 256 (the widths and the window
    # change nothing of what is checked here)
    monkeypatch.setattr(velocity, "HAETransolverIrregularMesh",
                        lambda **kw: TModel(**{**kw, "n_hidden": 32,
                                               "n_head": 4,
                                               "slice_num": 16}))
    monkeypatch.setattr(velocity, "HI_MIN", 4)
    monkeypatch.setattr(velocity, "HI_MAX", 4)
    res = velocity.main(["--device", "cpu", "--max_points", "1000",
                         "--rounds", "1"])
    assert [r["num_points"] for r in res] == [1000]
    assert res[0]["peak_memory_mb"] is None and res[0]["forward_seconds"] > 0

    def oom(n, *a):
        raise torch.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(velocity, "benchmark_model", oom)
    assert velocity.main(["--device", "cpu"]) == []
    assert "CUDA out of memory" in capsys.readouterr().out

    def broken(n, *a):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(velocity, "benchmark_model", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        velocity.main(["--device", "cpu"])


def test_new_modules_import_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'haet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import haet_torch.bench, haet_torch.utils.profiling\n"
            "import haet_torch.ops.kernels.copy_kernel\n"
            "from haet_torch.benchmarks import (bench_flags, mem_sweep,\n"
            "    micro_erwin_fused, profile_step, timing,\n"
            "    velocity_mem_checker)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
