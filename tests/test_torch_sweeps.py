"""PyTorch port, the drivers of the sweeps and the parity run:
``mfu_sweep``, ``accum_mem_probe``, ``model_dict`` and ``parity_repro``
(``haet_torch/benchmarks/``), against the JAX drivers' keys and format.

On the CPU only as plumbing, at toy sizes (no number here is a device
metric):

* ``mfu_sweep`` (the car preset swapped for a 1-layer, 16-wide model, one
  N, one round, with its A/B row) prints rows whose keys are those of the
  JAX driver's ``emit`` calls (read from its source), ``platform`` the
  device's; its auto row asks the model's own attention module;
* ``accum_mem_probe``: one in-process probe prints the JAX probe's keys;
  the sweep (probes stubbed with a fake memory boundary) bisects as JAX's
  and prints its summary;
* ``model_dict`` names the JAX registry's models, each the port's class of
  the same name;
* ``parity_repro``'s ``emit_table`` equals JAX's for the same results and
  failures, line for line but the command line (which names the port's
  module); its PDE command lines carry the JAX launcher flags with
  ``--pde_flags`` last; one ``--tasks pipe --epochs 1`` run on the pipe
  fixture writes the table.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from haet_torch import models as tmodels
from haet_torch.benchmarks import accum_mem_probe, mfu_sweep, model_dict
from haet_torch.benchmarks import parity_repro as tpr
from haet_torch.utils import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "benchmarks")


def _jax_module(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(JAX_BENCH, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dict_keys(path, pick):
    """The constant keys of every dict literal ``pick(node)`` selects in
    the source file ``path``."""
    tree = ast.parse(open(path).read())
    nodes = sorted((node for node in ast.walk(tree)
                    if isinstance(node, ast.Dict) and pick(node)),
                   key=lambda node: node.lineno)
    return [[k.value for k in node.keys] for node in nodes]


def _has_key(name):
    return lambda node: any(isinstance(k, ast.Constant) and k.value == name
                            for k in node.keys)


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_mfu_sweep_rows_have_jax_keys(monkeypatch, capsys):
    small = dataclasses.replace(
        tcfg.shapenet_car_config(), n_layers=1, n_hidden=16, n_head=2,
        slice_num=8, enc_num_heads=(1, 2), enc_depths=(1, 1),
        dec_num_heads=(1,), dec_depths=(1,), pallas_auto_threshold=64)
    monkeypatch.setattr(mfu_sweep, "shapenet_car_config", lambda: small)
    rows = mfu_sweep.main(["--device", "cpu", "--ns", "96", "--rounds",
                           "1"])
    printed = [json.loads(ln)
               for ln in capsys.readouterr().out.splitlines()]
    assert printed == rows
    # the JAX driver's emit keys, in its order
    assert [list(r) for r in rows] == _dict_keys(
        os.path.join(JAX_BENCH, "mfu_sweep.py"), _has_key("kind"))
    assert rows[0]["kind"] == "mfu_vs_n" and rows[1]["kind"] == \
        "pallas_ab_at_max_n"
    assert rows[0]["platform"] == rows[1]["platform"] == "cpu"
    # FLOPs counted (rounded to 1e-4 TFLOP as JAX rounds: 0.0 here)
    assert rows[0]["sec_per_step"] > 0 and rows[0]["step_tflops"] == 0.0
    assert rows[0]["mfu"] is None and rows[0]["chip_share_est"] is None
    # auto resolves per the model's module: plain on the CPU above the
    # threshold
    assert rows[1]["auto_threshold_base_points"] == 64
    assert rows[1]["auto_resolves_to"] == "xla"
    assert rows[1]["sec_per_step_pallas_fused"] > 0


def test_accum_probe_has_jax_keys(capsys):
    rec = accum_mem_probe.run_probe(128, batch=2, accum=2, device="cpu")
    want = _dict_keys(os.path.join(JAX_BENCH, "accum_mem_probe.py"),
                      _has_key("first_call_seconds"))
    assert [list(rec)] == want
    assert rec["ok"] and rec["peak_memory_mb"] is None
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == rec


def test_accum_sweep_bisects_as_jax(monkeypatch, capsys):
    """With probes stubbed by a fake memory boundary (OOM past 300k points
    at accum 1, 900k at accum 8), the port's sweep and JAX's find the same
    boundaries, and the port prints JAX's summary shape."""
    limit = {1: 300_000, 8: 900_000}

    def fake(n, batch, accum, *rest, **kw):
        ok = n <= limit[accum]
        rec = {"num_points": n, "batch": batch, "accum": accum, "ok": ok}
        return rec if ok else {**rec, "failure": "oom", "oom": True}

    jam = _jax_module_stubbed(monkeypatch)
    monkeypatch.setattr(jam, "accum_probe_subprocess", fake)
    monkeypatch.setattr(accum_mem_probe, "accum_probe_subprocess", fake)
    for accum in (1, 8):
        got = accum_mem_probe.find_max_n(8, accum, 65536, 4_000_000,
                                         lambda r: None)
        want = jam.find_max_n(8, accum, 65536, 4_000_000, lambda r: None)
        assert got == want, accum
    accum_mem_probe.main(["--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert sorted(summary) == ["batch", "summary"]
    assert summary["batch"] == 8
    assert sorted(summary["summary"]) == ["accum1", "accum8"]
    assert summary["summary"]["accum1"]["boundary_failure"] == "oom"
    assert summary["summary"]["accum8"]["max_n"] > \
        summary["summary"]["accum1"]["max_n"]


def _jax_module_stubbed(monkeypatch):
    """JAX's accum_mem_probe, its ``pallas_mem_sweep`` import satisfied by
    a stand-in (only ``find_max_n`` runs, on stubbed probes)."""
    monkeypatch.setitem(sys.modules, "pallas_mem_sweep", SimpleNamespace(
        run_classified_subprocess=None))
    return _jax_module("accum_mem_probe")


def test_model_dict_names_match_jax():
    jmd = _jax_module("model_dict")
    assert list(model_dict.MODEL_DICT) == list(jmd.MODEL_DICT)
    for name, cls in jmd.MODEL_DICT.items():
        assert model_dict.MODEL_DICT[name] is getattr(tmodels, cls.__name__)
        assert model_dict.get_model(SimpleNamespace(model=name)) is \
            model_dict.MODEL_DICT[name]
    with pytest.raises(ValueError, match="unknown model"):
        model_dict.get_model("nope")


RESULTS = {"car": {"rel-L2 pressure": 0.1, "rel-L2 velocity": 0.03,
                   "rel-L2 pressure (imported torch ckpt)": 0.1001},
           "pipe": {"rel-L2": 0.0061}, "darcy": {"rel-L2": 0.0123}}


@pytest.mark.parametrize("epochs,failures", [
    (None, None), (3, {"ns": "driver failed (exit 1); full log: x"})],
    ids=["reference", "override_and_failure"])
def test_emit_table_matches_jax(epochs, failures):
    jpr = _jax_module("parity_repro")
    args = SimpleNamespace(data_root="/data", epochs=epochs)
    got = tpr.emit_table(RESULTS, args, failures).splitlines()
    want = jpr.emit_table(RESULTS, args, failures).splitlines()
    cmd = [i for i, ln in enumerate(want) if ln.startswith("Command:")]
    assert cmd == [2]
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert got[2] == want[2].replace("python benchmarks/parity_repro.py",
                                     "python -m haet_torch.benchmarks."
                                     "parity_repro")


def test_pde_commands_carry_jax_flags():
    jpr = _jax_module("parity_repro")
    args = SimpleNamespace(epochs=2, pde_flags="--device cpu --n-hidden 8")
    got = tpr._pde_cmd("exp_pipe", "/d", "/w", ["--lr", "1e-3"], args)
    want = jpr._pde_cmd("exp_pipe.py", "/d", "/w", ["--lr", "1e-3"], args)
    assert got[:3] == [sys.executable, "-m", "haet_torch.benchmarks.exp_pipe"]
    assert got[3:] == want[2:]
    assert got[-3:] == ["cpu", "--n-hidden", "8"]


def test_parity_repro_pipe_on_the_fixture(tmp_path):
    flags = ("--device cpu --n-hidden 16 --n-layers 1 --n-heads 2 "
             "--slice_num 8 --ntrain 2 --ntest 2 --batch-size 2")
    out = tmp_path / "PARITY.md"
    res = tpr.main(["--data_root", os.path.join(ROOT, "tests", "fixtures",
                                                "data"),
                    "--tasks", "pipe", "--epochs", "1", "--workdir",
                    str(tmp_path / "runs"), "--out", str(out),
                    "--pde_flags", flags])
    rel = res["pipe"]["rel-L2"]
    assert np.isfinite(rel) and rel > 0
    table = out.read_text()
    assert f"| pipe | rel-L2 | 0.00505 | {rel:.5f} |" in table
    assert "epochs overridden to 1" in table
    log = (tmp_path / "runs" / "pipe" / "pipe.log").read_text()
    assert "synthetic" not in log and f"rel_err:{rel}" in log
