"""PyTorch port, BatchingServer: batching contract and parity with JAX.

A served batch is compared with the JAX model applied to THAT SAME batch:
HAET's Erwin pseudo-positions are min-max normalised over the whole batch
(``haet_tpu/models/physics_attention.py:344-351``), so a sample's output
depends on the samples batched with it, and a per-sample reference would be
the wrong one. The model is small (1 layer, n_hidden 64, G 16) with
perturbed init-distribution weights, so that dependence is visible.
Tolerance: 1e-4 of max |out| (float32).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.serve import BatchingServer, SampleSignature
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel

N_PTS = 64
KW = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=1, n_hidden=64,
          n_head=4, slice_num=16)
SIG = SampleSignature(((N_PTS, 3), (N_PTS, 1)), ("float32", "float32"))
RTOL = 1e-4


def _init_like(template, rng, noise=0.1):
    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if path[0].key == "batch_stats":
            return ((0.5 + rng.rand(*shape)) if name == "var"
                    else 0.1 * rng.randn(*shape)).astype(np.float32)
        base = {"scale": np.ones(shape),
                "sigma_att": -np.ones(shape)}.get(name, np.zeros(shape))
        if name in ("kernel", "in_project_slice_kernel", "ada_temp_kernel"):
            base = 0.02 * rng.randn(*shape)
        return (base + noise * rng.randn(*shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, template)


def _sample(seed):
    r = np.random.RandomState(seed)
    return (r.randn(N_PTS, 3).astype(np.float32),
            r.randn(N_PTS, 1).astype(np.float32))


@pytest.fixture(scope="module")
def env():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jm = JModel(**KW)
    x, fx = _sample(0)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[None],
                              fx[None])
    variables = _init_like(template, np.random.RandomState(1))
    tm = TModel(**KW, device="cpu").eval()
    load_jax_variables(tm, variables)
    yield jm, variables, tm
    torch.set_num_threads(threads)


def _server(tm, sizes=(1, 2, 4), **kw):
    return BatchingServer(tm, {SIG: sizes}, device="cpu", **kw)


def test_served_batch_of_4_matches_jax_on_that_batch(env):
    jm, variables, tm = env
    samples = [_sample(i) for i in range(4)]
    srv = _server(tm, max_delay_s=60.0)
    futs = [srv.submit(x, fx) for x, fx in samples]
    srv.close(drain=True)
    outs = np.stack([f.result(timeout=60) for f in futs])
    assert srv.stats.snapshot()["batch_histogram"] == {4: 1}
    xb = np.stack([s[0] for s in samples])
    fb = np.stack([s[1] for s in samples])
    ref = np.asarray(jax.jit(jm.apply)(variables, xb, fb))
    scale = np.abs(ref).max()
    err = np.abs(outs - ref).max()
    print(f"PARITY served batch of 4: max_abs_err {err:.3e} max|ref| "
          f"{scale:.3e}")  # shown with `pytest -s`
    assert err <= RTOL * scale
    # The per-sample reference differs by far more than the tolerance:
    # batching is not output-neutral for this model (finding 2).
    alone = np.asarray(jax.jit(jm.apply)(variables, xb[:1], fb[:1]))[0]
    assert np.abs(alone - ref[0]).max() > 10 * RTOL * scale


def test_remainder_rides_smaller_batches(env):
    _, _, tm = env
    with _server(tm, max_delay_s=1.0) as srv:
        futs = [srv.submit(*_sample(i)) for i in range(7)]
        for f in futs:
            assert f.result(timeout=60).shape == (N_PTS, 2)
        hist = srv.stats.snapshot()["batch_histogram"]
    assert hist == {4: 1, 2: 1, 1: 1}


def test_concurrent_clients(env):
    _, _, tm = env
    srv = _server(tm, max_delay_s=0.02)
    results, errs = {}, []

    def client(i):
        try:
            results[i] = srv.predict(*_sample(i), timeout=60)
        except Exception as e:  # noqa: BLE001 - collected and asserted
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    srv.close()
    assert not errs
    assert all(not t.is_alive() for t in threads)
    assert sorted(results) == list(range(8))
    assert srv.stats.snapshot()["delivered"] == 8


def test_unknown_signature_raises(env):
    _, _, tm = env
    with _server(tm) as srv:
        with pytest.raises(ValueError, match="no declared signature"):
            srv.submit(np.zeros((N_PTS + 1, 3), np.float32),
                       np.zeros((N_PTS + 1, 1), np.float32))
        with pytest.raises(ValueError, match="no declared signature"):
            srv.submit(np.zeros((N_PTS, 3), np.float32), None)


def test_wrong_dtype_rejected_at_submit(env):
    _, _, tm = env
    with _server(tm) as srv:
        x, fx = _sample(0)
        with pytest.raises(ValueError, match="dtype mismatch"):
            srv.submit(x.astype(np.float64), fx)


def test_queue_backpressure(env):
    _, _, tm = env
    srv = _server(tm, max_delay_s=60.0, max_queue=2)
    f1 = srv.submit(*_sample(0))
    f2 = srv.submit(*_sample(1))
    with pytest.raises(RuntimeError, match="queue full"):
        srv.submit(*_sample(2))
    srv.close(drain=True)
    assert f1.result(timeout=10).shape == f2.result(timeout=10).shape


def test_cancelled_future_does_not_kill_dispatcher(env):
    _, _, tm = env
    srv = _server(tm, max_delay_s=0.5)
    try:
        doomed = srv.submit(*_sample(0))
        assert doomed.cancel()
        assert srv.predict(*_sample(1), timeout=60).shape == (N_PTS, 2)
    finally:
        srv.close()
    assert not srv._thread.is_alive()
    assert srv.stats.snapshot()["dispatches"] == 1


def test_close_without_drain_fails_queued(env):
    _, _, tm = env
    srv = _server(tm, max_delay_s=60.0)
    futs = [srv.submit(*_sample(i)) for i in range(2)]
    srv.close(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(*_sample(9))


def test_stranded_below_smallest_batch_fails(env):
    _, _, tm = env
    with _server(tm, sizes=(2,), max_delay_s=0.01) as srv:
        fut = srv.submit(*_sample(0))
        with pytest.raises(ValueError, match="smallest declared batch"):
            fut.result(timeout=60)


def test_max_delay_zero_dispatches_immediately(env):
    _, _, tm = env
    with _server(tm, max_delay_s=0.0) as srv:
        t0 = time.perf_counter()
        out = srv.predict(*_sample(3), timeout=60)
        assert time.perf_counter() - t0 < 30
        assert out.shape == (N_PTS, 2)
        assert srv.stats.snapshot()["batch_histogram"] == {1: 1}


def test_batch_sizes_must_be_powers_of_two(env):
    _, _, tm = env
    with pytest.raises(ValueError, match="powers of two"):
        _server(tm, sizes=(1, 3))


def test_default_device_is_cuda(env, monkeypatch):
    _, _, tm = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchingServer(tm, {SIG: (1,)})
