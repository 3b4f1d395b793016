"""PyTorch port, programs and serving over a mesh (``mesh=`` exports,
``BatchingServer`` with ``serve.follow``, ``serve_http --dp``,
``micro_serving_latency --tp``).

One gloo group of two CPU ranks (spawned once for the module with the
harness of ``tests/test_torch_parallel.py``) runs every case
(:data:`CASES`); each test asserts its own. The model is a 2-block
irregular HAET (n_hidden 32, 4 heads, G 16) on samples of 64 points, from
a seed. Every program is exported by rank 0 into one directory that both
ranks load with their mesh. The references are the single-device port in
this process (its exported programs, or the eager model that they equal
bit for bit): the mesh runs within ``MESH_RTOL`` (rtol 1e-5, atol 1e-6 of
the largest |value|), every rank bitwise equal to the other.
"""

import contextlib
import io
import json
import os
import signal
import socket
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_parallel import (assert_mesh_close, case_result, run_cases,
                                 start_ranks)

from haet_torch import export as hexport
from haet_torch import parallel, serve
from haet_torch.models import HAETransolverIrregularMesh as TModel
from haet_torch.parallel.pipeline import split_variables

KW = dict(space_dim=3, fun_dim=1, out_dim=2, n_layers=2, n_hidden=32,
          n_head=4, slice_num=16, mlp_ratio=1, rotate=45)
N = 64


def sample_batch(b, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, N, 3).astype(np.float32),
            rng.randn(b, N, 1).astype(np.float32))


def model(seed=0, **kw):
    return TModel(**KW, device="cpu", seed=seed, **kw).eval()


# -- the cases the ranks run ----------------------------------------------

def _dp_family(rank, p):
    """A dp 2 family of b2 and b4, loaded by both ranks, run on batches of
    2 and 4; then a family with b1 under dp 2 (nothing written)."""
    mesh = parallel.make_mesh(2, 1)
    x, fx = sample_batch(1)
    root = os.path.join(p["root"], "dp")
    serve.export_batch_family(root, model(), None, (x, fx),
                              batch_sizes=(2, 4), mesh=mesh)
    bundle = hexport.ServingBundle.load(root, mesh=mesh, device="cpu")
    out = {f"b{b}": bundle.predict(model().state_dict(),
                                   *sample_batch(b, b)).numpy()
           for b in (2, 4)}
    bad = os.path.join(p["root"], "bad")
    try:
        serve.export_batch_family(bad, model(), None, (x, fx),
                                  batch_sizes=(1, 2), mesh=mesh)
        out["b1_error"] = np.array("")
    except ValueError as e:
        out["b1_error"] = np.array(str(e))
    out["b1_written"] = np.array(os.path.exists(bad))
    out["manifest"] = np.array(json.dumps(
        bundle._by_key[((2, N, 3), (2, N, 1))].manifest["mesh_shape"]))
    return out


def _tp_program(rank, p):
    """A b1 program over tp 2 (``data_axis=None``), the heads split."""
    mesh = parallel.make_mesh(1, 2)
    x, fx = sample_batch(1)
    path = os.path.join(p["root"], "tp", "b1")
    hexport.save_artifact(path, model(shard_axes=(None, "tp")), None,
                          (x, fx), mesh=mesh, data_axis=None)
    prog = hexport.load_artifact(path, mesh=mesh, device="cpu")
    return {"out": prog(model().state_dict(), x, fx).numpy(),
            "data_axis": np.array(str(prog.manifest["data_axis"])),
            "nr_devices": np.array(prog.nr_devices)}


def _server(rank, p):
    """The dp family behind a ``BatchingServer`` on rank 0, followed by
    rank 1: a burst of 4 (one b4 dispatch), a lone request (padded to b2,
    ``pad_to_batch`` on by default at dp 2), then a reload and the burst
    again."""
    mesh = parallel.make_mesh(2, 1)
    bundle = hexport.ServingBundle.load(os.path.join(p["root"], "dp"),
                                        mesh=mesh, device="cpu")
    if rank != 0:
        serve.follow(bundle, model().state_dict())
        return {}
    x, fx = sample_batch(4, 4)
    out = {}
    with serve.BatchingServer(bundle, model().state_dict(), device="cpu",
                              max_delay_s=0.5) as srv:
        out["pad"] = np.array(srv.pad_to_batch)
        futs = [srv.submit(x[i], fx[i]) for i in range(4)]
        out["burst"] = np.stack([f.result(60) for f in futs])
        out["lone"] = srv.predict(x[0], fx[0], timeout=60)
        srv.reload(model(seed=3).state_dict())
        futs = [srv.submit(x[i], fx[i]) for i in range(4)]
        out["reloaded"] = np.stack([f.result(60) for f in futs])
        out["histogram"] = np.array(json.dumps(
            srv.stats.snapshot()["batch_histogram"], sort_keys=True))
    return out


def _latency(rank, p):
    """``micro_serving_latency --tp 2`` on the two ranks, a small model in
    place of the car preset and windows of 1 and 2 calls."""
    from haet_torch.benchmarks import micro_serving_latency as lat

    lat.car_model = lambda dev, seed=0, shard_axes=None: TModel(
        **dict(KW, space_dim=7, fun_dim=0, out_dim=4), device=dev,
        seed=seed, shard_axes=shard_axes).eval()
    lat.LO, lat.HI = 1, 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lat.main(["--device", "cpu", "--tp", "2", "--n", str(N),
                  "--rounds", "1", "--samples", "1"])
    return {"printed": np.array(buf.getvalue())}


def _http(rank, p):
    """``serve_http --dp 2`` on the dp family and a ``--pp`` checkpoint:
    rank 0 answers one ``/predict``, then takes SIGTERM and drains; rank 1
    follows until then."""
    from haet_torch import serve_http

    argv = ["--bundle", os.path.join(p["root"], "dp"), "--checkpoint",
            os.path.join(p["root"], "ckpt"), "--which", "last", "--dp", "2",
            "--device", "cpu", "--max_delay_ms", "1", "--port",
            str(p["port"])]
    if rank != 0:
        return {"rc": np.array(serve_http.main(argv))}
    out = {}

    def client():
        url = f"http://127.0.0.1:{p['port']}"
        try:
            for _ in range(600):
                try:
                    with urllib.request.urlopen(url + "/healthz",
                                                timeout=5) as r:
                        if r.read() == b"ok":
                            break
                except OSError:
                    time.sleep(0.1)
            x, fx = sample_batch(1, 9)
            buf = io.BytesIO()
            np.savez(buf, arg0=x[0], arg1=fx[0])
            req = urllib.request.Request(url + "/predict",
                                         data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                with np.load(io.BytesIO(r.read())) as z:
                    out["answer"] = z["output"]
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    out["rc"] = np.array(serve_http.main(argv))
    t.join(timeout=60)
    return out


CASES = {"dp_family": _dp_family, "tp_program": _tp_program,
         "server": _server, "latency": _latency, "http": _http}


def _rank_cases(rank, payload):
    return run_cases(CASES, rank, payload)


# -- the fixtures ----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The ranks' directory, holding a ``--pp`` run's checkpoint of the
    model (the stacked layout) for ``serve_http``."""
    from haet_torch.train import Checkpointer

    root = str(tmp_path_factory.mktemp("mesh_serve"))
    stacked = split_variables(model().state_dict(), KW["n_layers"])
    Checkpointer(os.path.join(root, "ckpt")).save_last({"model": stacked}, 0)
    return root


@pytest.fixture(scope="module")
def ranks(root):
    """The two ranks' results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        collect = start_ranks(_rank_cases, {"root": root,
                                            "port": _free_port()},
                              world=2, timeout=300)
        return collect()
    finally:
        torch.set_num_threads(n)


def eager(m, x, fx):
    with torch.no_grad():
        return m(torch.from_numpy(x), torch.from_numpy(fx)).numpy()


# -- the tests ---------------------------------------------------------------

def test_dp_family_equals_single_device_programs(ranks, tmp_path):
    """b2 and b4 over dp 2 (each rank its rows, the pseudo-positions'
    min-max all-reduced in the program) equal the single-device programs
    of the same sizes; the manifest records the mesh."""
    got = case_result(ranks, "dp_family")
    x, fx = sample_batch(1)
    serve.export_batch_family(str(tmp_path), model(), None, (x, fx),
                              batch_sizes=(2, 4))
    one = hexport.ServingBundle.load(str(tmp_path), device="cpu")
    for b in (2, 4):
        want = one.predict(model().state_dict(), *sample_batch(b, b))
        assert_mesh_close(got[f"b{b}"], want.numpy(), f"b{b}")
    assert json.loads(str(got["manifest"])) == {"dp": 2, "tp": 1}


def test_b1_under_dp2_raises_before_writing(ranks):
    """A family holding b1 over dp 2 raises JAX's message on every rank,
    and no program of it is written."""
    got = case_result(ranks, "dp_family")
    assert "batch sizes [1] do not divide the 'dp' mesh axis (2)" in str(
        got["b1_error"])
    assert not bool(got["b1_written"])


def test_tp_program_matches_unsharded(ranks):
    """A b1 program over tp 2 with replicated inputs (``data_axis=None``):
    each rank runs 2 of the 4 heads, and the output is the unsharded
    model's."""
    got = case_result(ranks, "tp_program")
    x, fx = sample_batch(1)
    assert_mesh_close(got["out"], eager(model(), x, fx), "tp b1")
    assert str(got["data_axis"]) == "None"
    assert int(got["nr_devices"]) == 2


def test_load_artifact_needs_a_mesh_of_its_size(ranks, root):
    """A multi-chip program loads only with a mesh of its device count,
    with JAX's messages."""
    path = os.path.join(root, "tp", "b1")
    with pytest.raises(ValueError, match="this artifact is a multi-chip "
                       r"program \(2 devices, data axis None\)"):
        hexport.load_artifact(path, device="cpu")
    four = types.SimpleNamespace(shape={"dp": 2, "tp": 2})
    with pytest.raises(ValueError, match="mesh has 4 devices but the "
                       "artifact was exported for 2"):
        hexport.load_artifact(path, mesh=four, device="cpu")


def test_batching_server_over_the_mesh(ranks):
    """Rank 0's ``BatchingServer`` over the dp bundle, rank 1 following:
    the burst is one b4 dispatch equal to the single-device model on the 4
    samples, the lone request is padded to b2 (its answer the model's on
    the sample and its copy), and after ``reload`` (reaching rank 1 too)
    the burst gives the new weights' answers."""
    got = case_result(ranks, "server", same=False)
    x, fx = sample_batch(4, 4)
    assert bool(got["pad"])
    assert_mesh_close(got["burst"], eager(model(), x, fx), "burst")
    two = eager(model(), np.repeat(x[:1], 2, 0), np.repeat(fx[:1], 2, 0))
    assert_mesh_close(got["lone"], two[0], "lone")
    assert_mesh_close(got["reloaded"], eager(model(seed=3), x, fx),
                      "reloaded")
    assert json.loads(str(got["histogram"])) == {"4": 2, "1": 1}


def test_serve_http_dp2_serves_a_pp_checkpoint(ranks):
    """``serve_http --dp 2`` on two ranks, the checkpoint a ``--pp`` run's
    stacked layout (converted): ``/predict`` answers the model's output,
    and both ranks exit 0 after SIGTERM."""
    got = case_result(ranks, "http", same=False)
    assert int(got["rc"]) == 0
    assert int(ranks[1]["http"]["rc"]) == 0
    x, fx = sample_batch(1, 9)
    want = eager(model(), np.repeat(x, 2, 0), np.repeat(fx, 2, 0))[0]
    assert_mesh_close(got["answer"], want, "http")


def test_micro_serving_latency_tp2(ranks):
    """``micro_serving_latency --tp 2 --device cpu`` prints its JSON with
    ``aot_tp_bound`` beside the unsharded variants, the tp program within
    the gate of the unsharded one."""
    got = case_result(ranks, "latency", same=False)
    lines = [ln for ln in str(got["printed"]).splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) >= {"aot", "aot_bound", "eager", "aot_tp_bound"}
    tp = res["aot_tp_bound"]
    assert tp["devices"] == 2 and tp["max_abs_dev_vs_1chip"] < 1e-3
    assert tp["device_latency_s"] > 0 and np.isfinite(tp["e2e_latency_s"])
    assert str(ranks[1]["latency"]["printed"]) == ""
