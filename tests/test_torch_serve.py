"""PyTorch port, BatchingServer over exported programs: the batching
contract, pad_to_batch, pad_to_points, pipeline_depth and reload, and
parity with JAX.

A served batch is compared with the JAX model applied to THAT SAME batch,
as the JAX server would dispatch it (the same stacked rows, the same
repeat-last padding, the same truncation): HAET's Erwin pseudo-positions
are min-max normalised over the whole batch
(``haet_tpu/models/physics_attention.py:344-351``), so a sample's output
depends on the samples batched with it, and a per-sample reference would be
the wrong one. The model is small (1 layer, n_hidden 64, G 16, 3 Erwin
blocks) with
perturbed init-distribution weights, so that dependence is visible; the
port's programs are exported once per module (a point family over buckets
64 and 128 at batch sizes 1 and 4, and an unbucketed family of batch 2 at
64 points).
Tolerance: 1e-4 of max |out| (float32). The server logic that needs no
model (fetch failures, the in-flight bound, dtype families, queue waits)
runs over stub bundles, as in ``tests/test_serve.py``.
"""

import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

from haet_torch import serve
from haet_torch.export import ServingBundle
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.utils.weights import load_jax_variables
from haet_tpu.models import HAETransolverIrregularMesh as JModel

N_PTS = 64
KW = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=1, n_hidden=64,
          n_head=4, slice_num=16, enc_depths=(1, 1), dec_depths=(1,))
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


def _sample(seed, n=N_PTS):
    r = np.random.RandomState(seed)
    return (r.randn(n, 3).astype(np.float32),
            r.randn(n, 1).astype(np.float32))


def _state(tm, jvars):
    load_jax_variables(tm, jvars)
    return {k: v.numpy().copy() for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jm = JModel(**KW)
    x, fx = _sample(0)
    template = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[None],
                              fx[None])
    jvars = _init_like(template, np.random.RandomState(1))
    jvars2 = _init_like(template, np.random.RandomState(2))
    tm = TModel(**KW, use_pallas=True, use_pallas_erwin=True,
                device="cpu").eval()
    v2 = _state(tm, jvars2)
    variables = _state(tm, jvars)
    root_p = str(tmp_path_factory.mktemp("points"))
    serve.export_point_family(root_p, tm, None, (x[None], fx[None]),
                              point_buckets=(N_PTS, 2 * N_PTS),
                              batch_sizes=(1, 4))
    # an unbucketed family with batch 2 only at N_PTS points; "mixed" adds
    # the point family's batch 1 at 2 N_PTS
    root_b2 = str(tmp_path_factory.mktemp("b2"))
    serve.export_batch_family(root_b2, tm, None, (x[None], fx[None]),
                              batch_sizes=(2,))
    points = ServingBundle.load(root_p, device="cpu")
    b2 = ServingBundle.load(root_b2, device="cpu")
    wide_b1 = points._by_key[((1, 2 * N_PTS, 3), (1, 2 * N_PTS, 1))]
    apply = jax.jit(jm.apply)
    yield dict(tm=tm, variables=variables, v2=v2, jvars=jvars,
               jvars2=jvars2, root_p=root_p, points=points, b2=b2,
               mixed=ServingBundle([*b2._by_key.values(), wide_b1]),
               jax=lambda xb, fb, v=jvars: np.asarray(apply(v, xb, fb)))
    torch.set_num_threads(threads)


def _server(env, bundle="points", **kw):
    return serve.BatchingServer(env[bundle], env["variables"], device="cpu",
                                **kw)


def _assert_close(got, want, what):
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"PARITY {what}: {err:.3e} of max")  # shown with `pytest -s`
    assert err <= RTOL, (what, err)


def test_served_batch_of_4_matches_jax_on_that_batch(env):
    samples = [_sample(i) for i in range(4)]
    srv = _server(env, max_delay_s=60.0)
    futs = [srv.submit(x, fx) for x, fx in samples]
    srv.close(drain=True)
    outs = np.stack([f.result(timeout=60) for f in futs])
    assert srv.stats.snapshot()["batch_histogram"] == {4: 1}
    xb = np.stack([s[0] for s in samples])
    fb = np.stack([s[1] for s in samples])
    ref = env["jax"](xb, fb)
    _assert_close(outs, ref, "served batch of 4")
    # The per-sample reference differs by far more than the tolerance:
    # batching is not output-neutral for this model.
    alone = env["jax"](xb[:1], fb[:1])[0]
    assert np.abs(alone - ref[0]).max() > 10 * RTOL * np.abs(ref).max()


def test_family_layouts(env):
    sigs = {(key[0][0], key[0][1]) for key in env["points"].shapes()}
    assert sigs == {(b, n) for b in (1, 4) for n in (N_PTS, 2 * N_PTS)}
    dirs = sorted(os.listdir(env["root_p"]))
    assert "b4_64x3-float32_64x1-float32" in dirs and len(dirs) == 4
    for m in env["points"]._by_key.values():
        shape = m.manifest["input_shapes"][0]
        assert m.manifest["point_bucket"] == shape[1]
        assert m.manifest["batch_size"] == shape[0]


def test_remainder_rides_smaller_batches(env):
    with _server(env, max_delay_s=1.0) as srv:
        futs = [srv.submit(*_sample(i)) for i in range(6)]
        for f in futs:
            assert f.result(timeout=60).shape == (N_PTS, 2)
        hist = srv.stats.snapshot()["batch_histogram"]
    assert hist == {4: 1, 1: 2}


def test_concurrent_clients(env):
    srv = _server(env, max_delay_s=0.02)
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
    with _server(env) as srv:
        with pytest.raises(ValueError, match="no artifact family"):
            srv.submit(np.zeros((N_PTS + 1, 3), np.float32),
                       np.zeros((N_PTS + 1, 1), np.float32))
        with pytest.raises(ValueError, match="no artifact family"):
            srv.submit(np.zeros((N_PTS, 3), np.float32), None)


def test_wrong_dtype_rejected_at_submit(env):
    with _server(env) as srv:
        x, fx = _sample(0)
        with pytest.raises(ValueError, match="dtype mismatch"):
            srv.submit(x.astype(np.float64), fx)


def test_queue_backpressure(env):
    srv = _server(env, max_delay_s=60.0, max_queue=2)
    f1 = srv.submit(*_sample(0))
    f2 = srv.submit(*_sample(1))
    with pytest.raises(RuntimeError, match="queue full"):
        srv.submit(*_sample(2))
    srv.close(drain=True)
    assert f1.result(timeout=10).shape == f2.result(timeout=10).shape


def test_cancelled_future_does_not_kill_dispatcher(env):
    srv = _server(env, max_delay_s=0.5)
    try:
        doomed = srv.submit(*_sample(0))
        assert doomed.cancel()
        assert srv.predict(*_sample(1), timeout=60).shape == (N_PTS, 2)
    finally:
        srv.close()
    assert not srv._thread.is_alive()
    assert srv.stats.snapshot()["dispatches"] == 1


def test_cancelled_requests_are_dropped_not_dispatched(env):
    srv = _server(env, max_delay_s=60.0)
    f1 = srv.submit(*_sample(0))
    f2 = srv.submit(*_sample(1))
    assert f1.cancel() and f2.cancel()
    srv.close(drain=True)  # the drain finds only cancelled requests
    assert srv.stats.snapshot()["dispatches"] == 0


def test_close_without_drain_fails_queued(env):
    srv = _server(env, max_delay_s=60.0)
    futs = [srv.submit(*_sample(i)) for i in range(2)]
    srv.close(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError, match="server closed"):
            f.result(timeout=10)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(*_sample(9))


def test_stranded_below_smallest_batch_fails(env):
    with _server(env, "mixed", max_delay_s=0.01) as srv:
        fut = srv.submit(*_sample(0))
        with pytest.raises(ValueError, match="smallest exported batch"):
            fut.result(timeout=60)


def test_stranded_queue_does_not_stall_other_queues(env):
    """After a queue strand-fails, the dispatcher scans again and serves
    another signature's ready request."""
    with _server(env, "mixed", max_delay_s=0.01) as srv:
        doomed = srv.submit(*_sample(0))            # b2 only: strands
        fut = srv.submit(*_sample(5, 2 * N_PTS))    # b1 exists
        with pytest.raises(ValueError, match="smallest exported batch"):
            doomed.result(timeout=30)
        assert fut.result(timeout=30).shape == (2 * N_PTS, 2)


def test_no_head_of_line_blocking_across_signatures(env):
    """A FULL batch of one signature dispatches while another signature's
    lone request waits out its delay window."""
    srv = _server(env, max_delay_s=120.0)
    try:
        slow = srv.submit(*_sample(0, 2 * N_PTS))
        time.sleep(0.05)
        futs = [srv.submit(*_sample(i)) for i in range(1, 5)]
        for f in futs:
            f.result(timeout=60)
        assert not slow.done()
    finally:
        srv.close()  # the drain serves the slow request too
    assert slow.result(timeout=10).shape == (2 * N_PTS, 2)


def test_mid_queue_cancels_do_not_inflate_readiness(env):
    """Cancelled requests do not count toward a full batch: with batch 2
    only, a live request beside a cancelled one waits for a partner."""
    srv = _server(env, "mixed", max_delay_s=60.0)
    try:
        futs = [srv.submit(*_sample(i)) for i in range(2)]
        assert futs[1].cancel()
        time.sleep(0.2)
        assert not futs[0].done(), futs[0]
        srv.submit(*_sample(9))  # a partner arrives in the window
    finally:
        srv.close(drain=True)
    assert futs[0].result(timeout=30).shape == (N_PTS, 2)


def test_max_delay_zero_dispatches_immediately(env):
    with _server(env, max_delay_s=0.0) as srv:
        t0 = time.perf_counter()
        out = srv.predict(*_sample(3), timeout=60)
        assert time.perf_counter() - t0 < 30
        assert out.shape == (N_PTS, 2)
        assert srv.stats.snapshot()["batch_histogram"] == {1: 1}


def test_batch_sizes_must_be_powers_of_two(env, tmp_path):
    """Batch sizes come from the exported family, which takes any size of
    at least 1, as the JAX package's does: a size below 1 raises before
    anything is written."""
    x, fx = _sample(0)
    with pytest.raises(ValueError, match="batch sizes must be >= 1"):
        serve.export_batch_family(str(tmp_path / "f"), env["tm"], None,
                                  (x[None], fx[None]), batch_sizes=(0, 2))
    assert not os.path.exists(tmp_path / "f")


def test_default_device_is_cuda(env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchingServer(env["points"], env["variables"])


def test_warmup_runs_every_size(env):
    with _server(env, max_delay_s=0.0) as srv:
        srv.warmup()
        assert srv.stats.requests == 0
        assert srv.predict(*_sample(0), timeout=60).shape == (N_PTS, 2)


# -- padding ---------------------------------------------------------------


def test_pad_to_batch_matches_jax_on_the_padded_batch(env):
    """A lone request on a family without batch 1 rides the batch-2 program
    beside a copy of itself; its answer is JAX's on that padded batch."""
    s = _sample(3)
    with _server(env, "mixed", max_delay_s=0.01, pad_to_batch=True) as srv:
        out = srv.predict(*s, timeout=60)
    snap = srv.stats.snapshot()
    assert snap["padded_samples"] == 1 and snap["batch_histogram"] == {1: 1}
    xb, fb = np.stack([s[0], s[0]]), np.stack([s[1], s[1]])
    _assert_close(out, env["jax"](xb, fb)[0], "pad_to_batch")


def _padded(s, n):
    return tuple(np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])
                 for a in s)


def test_pad_to_points_serves_ragged_fold(env):
    """Three point counts, one exact: each answer at the caller's count,
    each in the bucket of 64 equal to JAX on the repeat-last padded input
    truncated back (the exact one unpadded); padded_points counts the
    synthesised rows."""
    ns = [N_PTS - 16, N_PTS, 2 * N_PTS - 40]
    samples = [_sample(i, n) for i, n in enumerate(ns)]
    with _server(env, max_delay_s=0.0, pad_to_points=True) as srv:
        outs = [srv.predict(*s, timeout=120) for s in samples]
    for n, s, out in zip(ns, samples, outs):
        assert out.shape == (n, 2)
        if n <= N_PTS:
            xp, fp = _padded(s, N_PTS)
            _assert_close(out, env["jax"](xp[None], fp[None])[0, :n],
                          f"pad_to_points {n} -> {N_PTS}")
    assert srv.stats.snapshot()["padded_points"] == 16 + 40


def test_pad_to_points_deviation_from_exact_n_equals_jax(env):
    """Not output-exact: the padded answer's distance from the exact-N
    forward is JAX's own distance between the same two forwards."""
    n = N_PTS - 8
    s = _sample(11, n)
    with _server(env, max_delay_s=0.0, pad_to_points=True) as srv:
        served = srv.predict(*s, timeout=120)
    with torch.inference_mode():
        exact = env["tm"](*(torch.from_numpy(a[None]) for a in s))[0].numpy()
    xp, fp = _padded(s, N_PTS)
    jax_padded = env["jax"](xp[None], fp[None])[0, :n]
    jax_exact = env["jax"](s[0][None], s[1][None])[0]

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    port, ref = rel(served, exact), rel(jax_padded, jax_exact)
    print(f"PARITY pad_to_points deviation {n} -> {N_PTS}: port {port:.6f}, "
          f"JAX {ref:.6f}")
    assert ref > 1e-3  # visible: the padding is not output-exact
    assert abs(port - ref) <= 1e-3 * ref


def test_pad_to_points_picks_smallest_bucket(env):
    n = N_PTS + 8
    with _server(env, max_delay_s=0.0, pad_to_points=True) as srv:
        assert srv.predict(*_sample(0, n), timeout=120).shape == (n, 2)
        assert srv.stats.snapshot()["padded_points"] == 2 * N_PTS - n


def test_pad_to_points_ignores_unbucketed_families(env):
    with _server(env, "b2", pad_to_points=True) as srv:
        with pytest.raises(ValueError,
                           match="no point-bucket artifact fits"):
            srv.submit(*_sample(0, N_PTS - 8))


def test_pad_to_points_never_truncates_larger_requests(env):
    with _server(env, pad_to_points=True) as srv:
        with pytest.raises(ValueError, match="no artifact family"):
            srv.submit(*_sample(0, 2 * N_PTS + 1))
        with pytest.raises(ValueError, match="no artifact family"):
            srv.submit(np.zeros((N_PTS - 8, 3), np.float32),
                       np.float32(1.0))


def test_pad_to_points_off_by_default_with_hint(env):
    with _server(env) as srv:
        with pytest.raises(ValueError, match="pad_to_points"):
            srv.submit(*_sample(0, N_PTS - 8))


def test_family_exports_validate(env, tmp_path):
    tm = env["tm"]
    x, fx = _sample(0)
    with pytest.raises(ValueError, match="disagree on the point axis"):
        serve.export_point_family(str(tmp_path / "a"), tm, None,
                                  (x[None], fx[None, :-1]),
                                  point_buckets=(N_PTS,))
    with pytest.raises(ValueError, match="point families need"):
        serve.export_point_family(str(tmp_path / "b"), tm, None,
                                  (x[None], np.zeros((1,), np.float32)),
                                  point_buckets=(N_PTS,))
    for bad in ({"batch_size": 4}, {"point_bucket": N_PTS}):
        with pytest.raises(ValueError, match="reserved"):
            serve.export_batch_family(str(tmp_path / "c"), tm, None,
                                      (x[None], fx[None]), batch_sizes=(1,),
                                      extra_manifest=bad)
    # over a mesh every batch size must divide dp, checked before any
    # program is written (the default sizes hold 1)
    dp2 = types.SimpleNamespace(shape={"dp": 2, "tp": 1})
    with pytest.raises(ValueError, match=r"batch sizes \[1\] do not divide"):
        serve.export_batch_family(str(tmp_path / "d"), tm, None,
                                  (x[None], fx[None]), mesh=dp2)
    assert not os.listdir(tmp_path)


# -- pipeline_depth ----------------------------------------------------------


def test_pipeline_depth_matches_direct_apply(env):
    """Depth 2 answers bit for bit as depth 1 on the same two batches of 4
    (each request its own row, none mixed up), and as JAX on them."""
    samples = [_sample(i) for i in range(8)]
    outs = {}
    for depth in (1, 2):
        with _server(env, max_delay_s=60.0, pipeline_depth=depth) as srv:
            futs = [srv.submit(*s) for s in samples]
            outs[depth] = np.stack([f.result(timeout=120) for f in futs])
        snap = srv.stats.snapshot()
        assert snap["batch_histogram"] == {4: 2}, snap
        assert snap["delivered"] == snap["requests"] == 8
    np.testing.assert_array_equal(outs[1], outs[2])
    xb = np.stack([s[0] for s in samples[4:]])
    fb = np.stack([s[1] for s in samples[4:]])
    _assert_close(outs[2][4:], env["jax"](xb, fb), "pipelined batch")
    assert not srv._delivery_thread.is_alive()


def test_pipeline_depth_close_drains(env):
    srv = _server(env, max_delay_s=0.0, pipeline_depth=3)
    futs = [srv.submit(*_sample(i)) for i in range(6)]
    srv.close(drain=True)
    for f in futs:
        assert f.result(timeout=60).shape == (N_PTS, 2)
    assert not srv._delivery_thread.is_alive()


class _StubBundle:
    """One batch-1 family of 4 floats; ``answers(call)`` gives each call's
    output."""

    def __init__(self, answers=None):
        self.calls = 0
        self.answers = answers or (lambda call: np.zeros((1, 3), np.float32))

    def shapes(self):
        return [((1, 4),)]

    def predict(self, variables, *args):
        self.calls += 1
        return self.answers(self.calls)


def _stub_server(stub, **kw):
    return serve.BatchingServer(stub, None, device="cpu", **kw)


def test_pipeline_depth_fetch_error_fails_only_its_batch():
    class Boom:
        def __array__(self, *a, **k):
            raise RuntimeError("device exploded at fetch")

    stub = _StubBundle(lambda call: Boom() if call == 1
                       else np.full((1, 3), call, np.float32))
    srv = _stub_server(stub, max_delay_s=0.0, pipeline_depth=2)
    try:
        bad = srv.submit(np.zeros((4,), np.float32))
        with pytest.raises(RuntimeError, match="device exploded"):
            bad.result(timeout=30)
        assert srv.predict(np.zeros((4,), np.float32),
                           timeout=30).shape == (3,)
    finally:
        srv.close()
    assert srv.stats.snapshot()["delivered"] == 2


def test_pipeline_depth_bounds_inflight_batches():
    gate = threading.Event()

    class Blocker:
        def __array__(self, *a, **k):
            gate.wait(timeout=60)  # the delivery stalls until released
            return np.zeros((1, 3), np.float32)

    stub = _StubBundle(lambda call: Blocker())
    srv = _stub_server(stub, max_delay_s=0.0, pipeline_depth=2)
    try:
        futs = [srv.submit(np.zeros((4,), np.float32)) for _ in range(4)]
        time.sleep(0.3)
        assert stub.calls == 2, stub.calls  # the depth, not depth + 1
        gate.set()
        for f in futs:
            assert f.result(timeout=60).shape == (3,)
        assert stub.calls == 4
    finally:
        gate.set()
        srv.close()


def test_pipeline_depth_validates():
    with pytest.raises(ValueError, match="pipeline_depth"):
        _stub_server(_StubBundle(), pipeline_depth=0)


def test_delivery_failure_keeps_server_alive():
    stub = _StubBundle(lambda call: np.float32(3.0) if call == 1
                       else np.zeros((1, 3), np.float32))
    srv = _stub_server(stub, max_delay_s=0.0)
    try:
        bad = srv.submit(np.zeros((4,), np.float32))
        with pytest.raises(IndexError):
            bad.result(timeout=30)
        assert srv.predict(np.zeros((4,), np.float32),
                           timeout=30).shape == (3,)
        assert srv._thread.is_alive()
    finally:
        srv.close()


def test_scalar_and_mixed_signatures_skipped():
    class Stub(_StubBundle):
        def shapes(self):
            return [((), (4,)), ((2, 8), (4, 8)), ((1, 8), (1, 4))]

    srv = _stub_server(Stub(), max_delay_s=0.0)
    try:
        assert list(srv._sizes_by_sig) == [((8,), (4,))]
        out = srv.predict(np.zeros((8,), np.float32),
                          np.zeros((4,), np.float32), timeout=30)
        assert out.shape == (3,)
    finally:
        srv.close()


def test_inconsistent_family_dtypes_raise_at_construction():
    class StubModel:
        def __init__(self, dts):
            self.manifest = {"input_dtypes": dts}

    class Stub(_StubBundle):
        _by_key = {((1, 4),): StubModel(("float32",)),
                   ((2, 4),): StubModel(("bfloat16",))}

        def shapes(self):
            return list(self._by_key)

    with pytest.raises(ValueError, match="inconsistent artifact family"):
        _stub_server(Stub())


def test_mean_queue_wait_counts_only_dispatched():
    srv = _stub_server(_StubBundle(), max_delay_s=60.0)
    try:
        srv.predict(np.zeros((4,), np.float32), timeout=30)
        time.sleep(0.01)
        parked = srv.submit(np.zeros((4,), np.float32))
        parked.cancel()
        snap = srv.stats.snapshot()
        assert snap["requests"] == 2 and snap["delivered"] == 1
        assert srv.stats.dispatched_requests == 1
        assert snap["mean_queue_wait_s"] == pytest.approx(
            srv.stats.queue_wait_s_total)
        assert snap["latency_count"] == 1
        assert snap["latency_sum_s"] == pytest.approx(
            snap["latency_p50_s"])
    finally:
        srv.close()


# -- reload ------------------------------------------------------------------


def test_hot_reload_swaps_weights_as_jax(env):
    """After reload the answers are JAX's with the new weights."""
    s = _sample(0)
    with _server(env, max_delay_s=0.0) as srv:
        out1 = srv.predict(*s, timeout=60)
        srv.reload(env["v2"])
        out2 = srv.predict(*s, timeout=60)
        srv.reload(env["variables"])
        out3 = srv.predict(*s, timeout=60)
        snap = srv.stats.snapshot()
    xb, fb = s[0][None], s[1][None]
    _assert_close(out1, env["jax"](xb, fb)[0], "before reload")
    _assert_close(out2, env["jax"](xb, fb, env["jvars2"])[0], "reloaded")
    np.testing.assert_array_equal(out1, out3)
    assert snap["latency_p95_s"] >= snap["latency_p50_s"]


def test_reload_validates_structure_eagerly(env):
    """A wrong tree raises at reload and the old weights keep serving."""
    s = _sample(0)
    bad = dict(env["v2"])
    bad.pop("placeholder")
    with _server(env, max_delay_s=0.0) as srv:
        before = srv.predict(*s, timeout=60)
        with pytest.raises(ValueError, match="variables tree mismatch"):
            srv.reload(bad)
        np.testing.assert_array_equal(before, srv.predict(*s, timeout=60))


def test_reload_mid_traffic(env):
    """A client keeps submitting while reload runs on a pipelined server:
    no request fails, answers finished before the reload are the old
    weights', requests submitted after it returns get the new ones, and
    each answer in between is one of the two."""
    s = _sample(4)
    with _server(env, max_delay_s=0.0) as srv:
        old = srv.predict(*s, timeout=60)
    srv = _server(env, max_delay_s=0.0, pipeline_depth=2)
    stop, futs, errs = threading.Event(), [], []

    def client():
        try:
            while not stop.is_set():
                futs.append(srv.submit(*s))
                time.sleep(0.002)
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    t = threading.Thread(target=client)
    t.start()
    try:
        while len(futs) < 3:
            time.sleep(0.01)
        done_before = [f for f in list(futs) if f.done()]
        srv.reload(env["v2"])
        # the client may have submitted its next request before reload
        # returned and not yet appended it: that one may be either
        n_at_reload = len(futs) + 1
        time.sleep(0.2)
        stop.set()
        t.join(timeout=60)
        answers = [f.result(timeout=60) for f in futs]
        new = srv.predict(*s, timeout=60)
    finally:
        stop.set()
        srv.close()
    assert not errs and len(answers) > n_at_reload
    assert np.abs(new - old).max() > 1e-3
    for f in done_before:
        np.testing.assert_array_equal(f.result(), old)
    for i, a in enumerate(answers):
        if i >= n_at_reload:
            np.testing.assert_array_equal(a, new)
        else:
            assert (np.array_equal(a, old) or np.array_equal(a, new)), i


def test_bound_bundle_is_accepted_and_reload_refused(env):
    bound = env["points"].bind(env["variables"])
    with serve.BatchingServer(bound, None, max_delay_s=0.0,
                              pad_to_points=True, device="cpu") as srv:
        s = _sample(4)
        out = srv.predict(*s, timeout=60)
        _assert_close(out, env["jax"](s[0][None], s[1][None])[0],
                      "bound bundle")
        with pytest.raises(ValueError, match="BoundBundle"):
            srv.reload(env["variables"])
        x, fx = _sample(5)
        with pytest.raises(ValueError, match="dtype mismatch"):
            srv.submit(x.astype(np.float64), fx)
        n = N_PTS - 8  # the bucket markers ride the bound bundle
        assert srv.predict(*_sample(0, n), timeout=120).shape == (n, 2)
    bad = dict(env["variables"])
    bad.pop("placeholder")
    with pytest.raises(ValueError, match="variables tree mismatch"):
        env["points"].bind(bad)
    with pytest.raises(ValueError, match="variables tree mismatch"):
        serve.BatchingServer(env["points"], bad, device="cpu")


def test_stress_concurrent_cancel_reload_pipeline(env):
    """Concurrent clients, random cancels and a reload of the same weights
    against a depth-3 server: every answer that was not cancelled is its
    own sample's (within the batching effect, far below a mix-up of
    samples), and the stats reconcile."""
    srv = _server(env, max_delay_s=0.001, pipeline_depth=3, max_queue=4096)
    n_req, futs, cancelled, errs = 24, {}, set(), []
    lock = threading.Lock()

    def client(base):
        try:
            for i in range(base, base + n_req // 4):
                f = srv.submit(*_sample(i))
                with lock:
                    futs[i] = f
                if i % 7 == 3 and f.cancel():
                    with lock:
                        cancelled.add(i)
        except Exception as e:  # noqa: BLE001 - asserted below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(k * (n_req // 4),))
               for k in range(4)]
    for t in threads:
        t.start()
    srv.reload(env["variables"])
    for t in threads:
        t.join()
    assert not errs, errs
    done = 0
    for i, f in futs.items():
        if i in cancelled:
            continue
        x, fx = _sample(i)
        with torch.inference_mode():
            direct = env["tm"](torch.from_numpy(x[None]),
                               torch.from_numpy(fx[None]))[0].numpy()
        out = f.result(timeout=120)
        assert np.abs(out - direct).max() < 0.1 * np.abs(direct).max(), i
        done += 1
    assert done == n_req - len(cancelled)
    srv.close()
    snap = srv.stats.snapshot()
    assert snap["requests"] == n_req
    assert n_req - len(cancelled) <= snap["delivered"] <= n_req
    assert snap["latency_count"] == snap["delivered"]
    assert not srv._delivery_thread.is_alive()
