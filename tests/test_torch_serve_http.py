"""PyTorch port, the HTTP front end (``haet_torch.serve_http``).

Counterparts of ``tests/test_serve_http.py`` on the CPU: a real
ThreadingHTTPServer on an ephemeral port over a ``BatchingServer`` of a small
exported family (batch sizes 1 and 4, 64 points), driven with urllib. The
answers over HTTP are held to the in-process server's on the same bundle,
bit for bit (the JAX parity of those programs is
``tests/test_torch_export.py``'s and ``tests/test_torch_serve.py``'s).

Also the three faults of the JAX front end, repaired in the port: the
checkpoint watcher posts to the address the server is bound to (not always
the loopback one), its baseline stamp is the one read when the weights
were loaded (not after warm-up), and the Prometheus latency summary carries
``_count`` and ``_sum``. One CLI subprocess (``--device cpu``) runs the
deployment end to end and drains a request in flight on SIGTERM, exiting 0.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from haet_torch import serve, serve_http
from haet_torch.export import ServingBundle
from haet_torch.parallel.pipeline import split_variables
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.train.checkpoint import Checkpointer

N_PTS = 64
KW = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=1, n_hidden=32,
          n_head=4, slice_num=8, enc_depths=(1, 1), dec_depths=(1,),
          use_pallas=True, use_pallas_erwin=True)
#: the family's batch-1 program
B1 = f"b1_{N_PTS}x3-float32_{N_PTS}x1-float32"


def _sample(seed):
    r = np.random.RandomState(seed)
    return (r.randn(N_PTS, 3).astype(np.float32),
            r.randn(N_PTS, 1).astype(np.float32))


def _state(seed):
    tm = TModel(**KW, device="cpu", seed=seed)
    return {k: v.numpy() for k, v in tm.state_dict().items()}


def _start(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return serve_http.base_url(httpd)


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def http_env(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tm = TModel(**KW, device="cpu", seed=0)
    root = str(tmp_path_factory.mktemp("bundle"))
    x, fx = _sample(0)
    serve.export_batch_family(root, tm, None, (x[None], fx[None]),
                              batch_sizes=(1, 4))
    bundle = ServingBundle.load(root, device="cpu")
    v1, v2 = _state(0), _state(1)
    srv = serve.BatchingServer(bundle, v1, max_delay_s=0.05, device="cpu")
    httpd = serve_http.make_server(srv, "127.0.0.1", 0)
    base = _start(httpd)
    bound = {"v1": bundle.bind(v1), "v2": bundle.bind(v2)}
    yield dict(root=root, bundle=bundle, v1=v1, v2=v2, srv=srv, base=base,
               direct=lambda xb, fb, v="v1": bound[v].predict(
                   xb, fb).numpy())
    _stop(httpd)
    srv.close()
    torch.set_num_threads(threads)


def _post_predict(base, arrays, timeout=120):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        base + "/predict", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.status == 200
        with np.load(io.BytesIO(r.read())) as z:
            return z["output"]


def _post_reload(base, body: bytes, timeout=120):
    req = urllib.request.Request(base + "/reload", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def test_health_shapes_stats(http_env):
    base = http_env["base"]
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.read() == b"ok"
    with urllib.request.urlopen(base + "/shapes", timeout=30) as r:
        assert json.load(r)["signatures"] == [[[N_PTS, 3], [N_PTS, 1]]]
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        snap = json.load(r)
    assert {"requests", "dispatches", "batch_histogram", "latency_count",
            "latency_sum_s", "padded_points"} <= set(snap)


def test_predict_round_trip(http_env):
    x, fx = _sample(3)
    out = _post_predict(http_env["base"], {"arg0": x, "arg1": fx})
    np.testing.assert_array_equal(out,
                                  http_env["direct"](x[None], fx[None])[0])


def test_concurrent_posts_cobatch(http_env):
    srv = http_env["srv"]
    before = dict(srv.stats.batch_histogram)
    results = {}

    def client(i):
        x, fx = _sample(i)
        results[i] = _post_predict(http_env["base"], {"arg0": x, "arg1": fx})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    after = dict(srv.stats.batch_histogram)
    assert after.get(4, 0) - before.get(4, 0) == 1, after
    xb = np.stack([_sample(i)[0] for i in range(4)])
    fb = np.stack([_sample(i)[1] for i in range(4)])
    want = http_env["direct"](xb, fb)
    # the batch's row order is the arrival order: match each by its row
    for i in range(4):
        assert any(np.array_equal(results[i], row) for row in want), i


def _get(base, path, body=None):
    req = urllib.request.Request(base + path, data=body,
                                 method="GET" if body is None else "POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    return ei.value.code, json.load(ei.value)["error"]


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


@pytest.mark.parametrize("path,body,code,says", [
    ("/predict", _npz(arg0=_sample(0)[0][:32], arg1=_sample(0)[1]), 400,
     "no artifact family"),
    ("/predict", _npz(foo=_sample(0)[0], bar=_sample(0)[1]), 400,
     "arg0..argN"),
    ("/predict", b"not an npz", 400, "bad request body"),
    ("/predict", _npz(arg0=_sample(0)[0].astype(np.float64),
                      arg1=_sample(0)[1]), 400, "dtype mismatch"),
    ("/nope", None, 404, "unknown path"),
    ("/nope", b"", 404, "unknown path"),
    ("/reload", b"", 501, "not configured"),
], ids=["signature", "keys", "body", "dtype", "get", "post", "reload"])
def test_error_answers(http_env, path, body, code, says):
    got, error = _get(http_env["base"], path, body)
    assert got == code and says in error


def test_npz_keys_order_numerically():
    """arg10 sorts before arg2 as a string: the handler orders by number."""

    class StubServer:
        class stats:
            @staticmethod
            def snapshot():
                return {}

        @staticmethod
        def submit(*args):
            assert len(args) == 11
            for i, a in enumerate(args):
                np.testing.assert_array_equal(a, np.full((2,), i,
                                                         np.float32))
            f = Future()
            f.set_result(np.asarray([1.0], np.float32))
            return f

    httpd = serve_http.make_server(StubServer(), "127.0.0.1", 0)
    base = _start(httpd)
    try:
        out = _post_predict(base, {f"arg{i}": np.full((2,), i, np.float32)
                                   for i in range(11)})
        np.testing.assert_array_equal(out, np.asarray([1.0], np.float32))
    finally:
        _stop(httpd)


def test_metrics_prometheus_exposition(http_env):
    """The latency summary carries its quantiles, _count and _sum; _count
    is the delivered requests and _sum their latencies."""
    x, fx = _sample(21)
    _post_predict(http_env["base"], {"arg0": x, "arg1": fx})
    with urllib.request.urlopen(http_env["base"] + "/metrics",
                                timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    snap = http_env["srv"].stats.snapshot()
    lines = dict(ln.rsplit(" ", 1) for ln in body.splitlines()
                 if not ln.startswith("#"))
    assert "# TYPE haet_requests_total counter" in body
    assert "# TYPE haet_request_latency_seconds summary" in body
    assert float(lines["haet_requests_total"]) >= 1
    assert 'haet_request_latency_seconds{quantile="0.5"}' in lines
    assert 'haet_batch_size_dispatches_total{size="1"}' in lines
    count = int(lines["haet_request_latency_seconds_count"])
    total = float(lines["haet_request_latency_seconds_sum"])
    assert 1 <= count <= snap["delivered"]
    assert 0 < total <= snap["latency_sum_s"]


def test_drain_not_blocked_by_silent_client(http_env):
    """A POST whose body never arrives is answered 408 after one timeout
    and closed, so shutdown() + server_close() drains."""
    httpd = serve_http.make_server(http_env["srv"], "127.0.0.1", 0,
                                   request_timeout_s=1.0)
    _start(httpd)
    stuck = socket.create_connection(httpd.server_address[:2])
    try:
        stuck.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                      b"Content-Length: 100000\r\n\r\n")
        time.sleep(0.2)
        done = threading.Event()

        def drain():
            _stop(httpd)
            done.set()

        threading.Thread(target=drain, daemon=True).start()
        assert done.wait(timeout=10), "the drain hung on a silent client"
        stuck.settimeout(5)
        data = b""
        while True:
            chunk = stuck.recv(4096)
            if not chunk:
                break
            data += chunk
        assert b"408" in data.split(b"\r\n", 1)[0], data[:120]
    finally:
        stuck.close()


def _run_dir(tmp_path, variables, epoch=0, which="last"):
    ck = Checkpointer(str(tmp_path / "run"))
    state = {"model": variables, "step": epoch}
    if which == "best":
        ck.save_best(state, 1.0, epoch)
    else:
        ck.save_last(state, epoch)
    return ck.directory


def test_load_variables(http_env, tmp_path):
    """The model's state dict from a training state's 'model' entry or a
    plain state dict; a missing name is FileNotFoundError (404 over
    /reload); a pipeline-parallel (stacked) layout is converted."""
    v1 = {k: torch.from_numpy(v) for k, v in http_env["v1"].items()}
    ckdir = _run_dir(tmp_path, v1)
    got = serve_http._load_variables(ckdir, "last")
    assert sorted(got) == sorted(http_env["v1"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, http_env["v1"][k])
    torch.save(v1, os.path.join(ckdir, "plain.pt"))
    assert sorted(serve_http._load_variables(ckdir, "plain")) == sorted(v1)
    with pytest.raises(FileNotFoundError, match="no 'best' checkpoint"):
        serve_http._load_variables(ckdir, "best")
    with pytest.raises(FileNotFoundError):
        serve_http._load_variables(str(tmp_path / "absent"), "last")
    # a --pp run's stacked layout is converted to the plain one
    torch.save({"model": split_variables(v1, KW["n_layers"])},
               os.path.join(ckdir, "pp.pt"))
    got = serve_http._load_variables(ckdir, "pp")
    assert sorted(got) == sorted(http_env["v1"])
    for k, v in got.items():
        np.testing.assert_array_equal(v, http_env["v1"][k])


def test_reload_endpoint_swaps_weights_mid_traffic(http_env, tmp_path):
    """POST /reload while a client keeps posting: no request fails, later
    answers are the new weights', a missing name is 404, a garbled body
    400, an empty body reloads 'best'."""
    ckdir = _run_dir(tmp_path, {k: torch.from_numpy(v)
                                for k, v in http_env["v2"].items()})
    _run_dir(tmp_path, {k: torch.from_numpy(v)
                        for k, v in http_env["v1"].items()}, which="best")
    srv = serve.BatchingServer(http_env["bundle"], http_env["v1"],
                               max_delay_s=0.0, pipeline_depth=2,
                               device="cpu")
    reloaded = []

    def reload_fn(which):
        srv.reload(serve_http._load_variables(ckdir, which))
        reloaded.append(which)

    httpd = serve_http.make_server(srv, "127.0.0.1", 0,
                                   reload_fn=reload_fn)
    base = _start(httpd)
    xs, fs = _sample(7)
    stop, errs = threading.Event(), []

    def hammer():
        while not stop.is_set():
            try:
                _post_predict(base, {"arg0": xs, "arg1": fs})
            except Exception as e:  # noqa: BLE001 - asserted below
                errs.append(e)
                return

    ht = threading.Thread(target=hammer)
    ht.start()
    try:
        time.sleep(0.1)
        assert _post_reload(base, json.dumps({"which": "last"}).encode()) \
            == {"reloaded": "last"}
        time.sleep(0.1)
        stop.set()
        ht.join(timeout=120)
        assert not errs, errs
        np.testing.assert_array_equal(
            _post_predict(base, {"arg0": xs, "arg1": fs}),
            http_env["direct"](xs[None], fs[None], "v2")[0])
        assert _get(base, "/reload", json.dumps(
            {"which": "nope"}).encode())[0] == 404
        assert _get(base, "/reload", b"{not json")[0] == 400
        assert _post_reload(base, b"") == {"reloaded": "best"}
        np.testing.assert_array_equal(
            _post_predict(base, {"arg0": xs, "arg1": fs}),
            http_env["direct"](xs[None], fs[None])[0])
        assert reloaded == ["last", "best"]
    finally:
        stop.set()
        _stop(httpd)
        srv.close()


def test_watcher_posts_to_the_bound_address(http_env):
    """A server bound to another address than 127.0.0.1 (here 127.0.0.2,
    which loopback also serves) is reached at that address; one bound to
    every interface at the loopback one."""
    httpd = serve_http.make_server(http_env["srv"], "127.0.0.2", 0)
    base = _start(httpd)
    try:
        assert base == f"http://127.0.0.2:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.read() == b"ok"
    finally:
        _stop(httpd)
    anywhere = serve_http.make_server(http_env["srv"], "0.0.0.0", 0)
    try:
        assert serve_http.base_url(anywhere) == (
            f"http://127.0.0.1:{anywhere.server_address[1]}")
    finally:
        anywhere.server_close()


def test_watch_checkpoint_baseline_is_the_loaded_stamp(http_env, tmp_path):
    """A save that lands after the weights were loaded but before the
    watcher starts (the start-up window) is reloaded, because the watcher
    starts from the stamp read at load; a save of another name is not."""
    v1 = {k: torch.from_numpy(v) for k, v in http_env["v1"].items()}
    v2 = {k: torch.from_numpy(v) for k, v in http_env["v2"].items()}
    ckdir = _run_dir(tmp_path, v1)
    served = serve_http.checkpoint_stamp(ckdir, "last")
    srv = serve.BatchingServer(http_env["bundle"],
                               serve_http._load_variables(ckdir, "last"),
                               max_delay_s=0.0, device="cpu")
    reloads = []

    def reload_fn(which):
        srv.reload(serve_http._load_variables(ckdir, which))
        reloads.append(which)

    httpd = serve_http.make_server(srv, "127.0.0.1", 0, reload_fn=reload_fn)
    base = _start(httpd)
    Checkpointer(ckdir).save_last({"model": v2, "step": 1}, 1)  # start-up
    stop = threading.Event()
    wt = threading.Thread(target=serve_http.watch_checkpoint,
                          args=(base, ckdir, "last", 0.05, stop),
                          kwargs={"served": served}, daemon=True)
    wt.start()
    try:
        deadline = time.time() + 30
        while not reloads and time.time() < deadline:
            time.sleep(0.05)
        assert reloads == ["last"]
        xs, fs = _sample(2)
        np.testing.assert_array_equal(
            srv.predict(xs, fs, timeout=60),
            http_env["direct"](xs[None], fs[None], "v2")[0])
        _run_dir(tmp_path, v1, epoch=3, which="best")
        time.sleep(0.3)
        assert reloads == ["last"]  # 'best' is not the watched name
    finally:
        stop.set()
        wt.join(timeout=10)
        _stop(httpd)
        srv.close()


def test_cli_end_to_end_and_sigterm_drain(http_env, tmp_path):
    """``python -m haet_torch.serve_http --device cpu`` on the bundle and a
    checkpoint: /healthz, a /predict equal to the in-process server, then
    SIGTERM while a request waits in the batcher's delay window: that
    request is answered and the process exits 0. ``--dp``/``--tp`` ask for
    their ranks in one process, and exclude each other."""
    for flag in ("--dp", "--tp"):
        with pytest.raises(SystemExit, match="needs 2 devices, have 1"):
            serve_http.main(["--bundle", "x", "--checkpoint", "y", flag,
                             "2"])
    with pytest.raises(SystemExit, match="mutually exclusive"):
        serve_http.main(["--bundle", "x", "--checkpoint", "y", "--dp", "2",
                         "--tp", "2"])
    ckdir = _run_dir(tmp_path, {k: torch.from_numpy(v)
                                for k, v in http_env["v1"].items()})
    # the bundle's batch-1 program alone: each request here is served alone
    (tmp_path / "bundle").mkdir()
    os.symlink(os.path.join(http_env["root"], B1), tmp_path / "bundle" / B1)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "haet_torch.serve_http", "--device", "cpu",
         "--bundle", str(tmp_path / "bundle"), "--checkpoint", ckdir,
         "--which", "last", "--port", str(port), "--max_delay_ms", "500"],
        cwd=str(Path(__file__).resolve().parents[1]), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline, up = time.time() + 240, False
        while time.time() < deadline and not up:
            if proc.poll() is not None:
                raise AssertionError(f"exited early:\n{proc.stdout.read()}")
            try:
                with urllib.request.urlopen(base + "/healthz",
                                            timeout=5) as r:
                    up = r.read() == b"ok"
            except OSError:
                time.sleep(0.3)
        assert up, "the server never came up"
        xs, fs = _sample(3)
        np.testing.assert_array_equal(
            _post_predict(base, {"arg0": xs, "arg1": fs}),
            http_env["srv"].predict(xs, fs, timeout=60))
        result = {}

        def post():
            try:
                result["out"] = _post_predict(base, {"arg0": xs,
                                                     "arg1": fs})
            except Exception as e:  # noqa: BLE001 - asserted below
                result["err"] = e

        t = threading.Thread(target=post)
        t.start()
        time.sleep(0.2)  # the request waits out the 500 ms window
        proc.send_signal(signal.SIGTERM)
        t.join(timeout=120)
        assert "err" not in result, result
        np.testing.assert_array_equal(result["out"],
                                      http_env["direct"](xs[None],
                                                         fs[None])[0])
        assert proc.wait(timeout=60) == 0
        assert "draining" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def test_serving_drivers_on_the_cpu(monkeypatch):
    """``micro_serving_latency`` and ``micro_serving_server`` as plumbing,
    on a small model and 64 points: every number of their JSON finite, the
    batched modes dispatching, ``--tp 3`` exiting as it does not divide
    the heads."""
    from haet_torch.benchmarks import (micro_serving_latency,
                                       micro_serving_server)

    small = dict(KW, space_dim=7, fun_dim=0, out_dim=4)
    monkeypatch.setattr(micro_serving_latency, "car_model",
                        lambda dev: TModel(**small, device=dev).eval())
    monkeypatch.setattr(micro_serving_server, "car_model",
                        lambda dev: TModel(**small, device=dev).eval())
    # windows of 1 and 2 chained calls in place of 4 and 24
    monkeypatch.setattr(micro_serving_latency, "LO", 1)
    monkeypatch.setattr(micro_serving_latency, "HI", 2)
    lat = micro_serving_latency.main(["--device", "cpu", "--n", "64",
                                      "--rounds", "1", "--samples", "2"])
    srv = micro_serving_server.main(["--device", "cpu", "--n", "64",
                                     "--requests", "4", "--clients", "2",
                                     "--rounds", "1", "--batch_sizes", "1"])
    for res in (lat, srv):
        flat = [v for d in (res, *[v for v in res.values()
                                   if isinstance(v, dict)])
                for v in d.values() if isinstance(v, float)]
        assert flat and all(np.isfinite(flat))
    assert lat["dtype"] == "float32" and lat["card"] is None
    # the time per call in steady state, as the JAX driver's; the traced
    # kernel time needs a card
    assert lat["aot_bound"]["device_latency_s"] > 0
    assert lat["aot_bound"]["samples_per_sec"] == pytest.approx(
        1.0 / lat["aot_bound"]["device_latency_s"])
    assert lat["vs_baseline_device"] == pytest.approx(
        lat["baseline_a100_s"] / lat["aot_bound"]["device_latency_s"])
    assert lat["aot_bound"]["kernel_time_s"] is None
    assert lat["vs_baseline_kernel"] is None
    assert set(lat) >= {"aot", "aot_bound", "eager", "load_s"}
    assert sum(srv["batch_histogram_best_round"].values()) >= 2
    assert srv["sequential_b1_rps"] > 0
    # --tp is ported (tests/test_torch_mesh_serve.py): a K that does not
    # divide the heads exits, as in JAX
    with pytest.raises(SystemExit, match="must divide n_head"):
        micro_serving_latency.main(["--device", "cpu", "--tp", "3"])
