"""PyTorch port, the PDE data layer and drivers vs the JAX package.

No JAX model is built here:

* every synthetic stand-in (``darcy_like`` ... ``plasticity_like``, the
  ``exp_3d`` volume) bit for bit the JAX package's at two seeds, and
  ``batch_iter``'s batches, order and partial last batch;
* the loaders on ``tests/fixtures/data`` (the upstream containers in
  miniature) equal to ``haet_tpu.data.pde_datasets``' arrays, the NS file
  through h5py where it is installed; a MATLAB v7.3 file without ``h5py``
  raises, naming it, rather than falling back to the stand-in; an absent
  file falls back, as in JAX;
* each PDE driver with ``--smoke --device cpu`` on the fixtures or the
  stand-in (one parametrised test; ``exp_elas`` with ``--accum_steps 2
  --dropout 0.1``, ``exp_3d`` with ``--use_checkpoint 1``): a finite
  ``rel_err``, its metrics and checkpoints written, the mesh flags
  refused; ``exp_darcy`` with ``--showcase`` writes its three renders.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from haet_torch.benchmarks import (exp_3d, exp_airfoil, exp_darcy, exp_elas,
                                   exp_pipe)
from haet_torch.data import pde_datasets as tpde
from haet_torch.data import synthetic as tsyn
from haet_tpu.data import pde_datasets as jpde
from haet_tpu.data import synthetic as jsyn

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "fixtures", "data")
BENCH = os.path.join(os.path.dirname(HERE), "benchmarks")


@pytest.fixture(scope="module", autouse=True)
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


STANDINS = {
    "darcy_like": dict(n=3, s=17),
    "ns_like": dict(n=2, s=16, t_in=3, t_out=2),
    "airfoil_like": dict(n=2, h=21, w=11),
    "elasticity_like": dict(n=3, npts=97),
    "plasticity_like": dict(n=2, h=11, w=7, t=5),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(STANDINS))
def test_standins_are_jax_bit_for_bit(name, seed):
    kw = STANDINS[name]
    _equal(getattr(tsyn, name)(**kw, seed=seed),
           getattr(jsyn, name)(**kw, seed=seed))


def test_heat3d_is_jax_bit_for_bit():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import exp_3d as jexp_3d

    _equal(exp_3d.heat3d_like(3, 6, seed=2), jexp_3d.heat3d_like(3, 6, 2))


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False),
                                               (True, True)])
def test_batch_iter_matches_jax(shuffle, drop_last):
    arrays = {"a": np.arange(11 * 2).reshape(11, 2),
              "b": np.arange(11, dtype=np.float32)}
    got = tsyn.batch_iter(arrays, 4, shuffle, seed=3, drop_last=drop_last)
    want = jsyn.batch_iter(arrays, 4, shuffle, seed=3, drop_last=drop_last)
    for _ in range(2):   # two epochs: the shuffle advances
        _equal(list(got()), list(want()))


LOADERS = {
    "darcy": (lambda m: m.load_darcy(DATA, 3, 2, 5)),
    "darcy_standin": (lambda m: m.load_darcy(os.path.join(DATA, "none"),
                                             3, 2, 30)),
    "ns": (lambda m: m.load_ns(DATA, 3, 2, t_in=10, t_out=2)),
    "pipe": (lambda m: m.load_structured_mesh(DATA, "Pipe", 3, 1, 9, 7)),
    "airfoil": (lambda m: m.load_structured_mesh(DATA, "NACA_Cylinder", 3,
                                                 1, 17, 9)),
    "elasticity": (lambda m: m.load_elasticity(DATA, 4, 2)),
    "plasticity": (lambda m: m.load_plasticity(DATA, 3, 2)),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_match_jax(name):
    got, want = LOADERS[name](tpde), LOADERS[name](jpde)
    assert got["synthetic"] is want["synthetic"] is (name == "darcy_standin")
    _equal(got, want)


def test_mat73_without_h5py_raises(monkeypatch):
    """A v7.3 file that scipy refuses needs h5py: without it the loader
    raises and names it; it does not fall back to the stand-in."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tpde.load_ns(DATA)


SMOKE = ["--smoke", "--device", "cpu", "--data_path", DATA]
DRIVERS = {
    "exp_darcy": (exp_darcy, SMOKE + ["--showcase"], "darcy"),
    "exp_pipe": (exp_pipe, SMOKE, "pipe"),
    # the smoke sizes without --smoke, whose 8 training samples would take
    # the fixture's 4 and leave airfoil's test slice [8:12] empty
    "exp_airfoil": (exp_airfoil, SMOKE[1:] + [
        "--epochs", "2", "--n-hidden", "32", "--n-layers", "2",
        "--n-heads", "4", "--slice_num", "16", "--batch-size", "2",
        "--ntrain", "2", "--ntest", "2"], "airfoil"),
    "exp_elas": (exp_elas, SMOKE + ["--accum_steps", "2", "--dropout",
                                    "0.1"], "elas"),
    "exp_3d": (exp_3d, ["--smoke", "--device", "cpu", "--use_checkpoint",
                        "1"], "heat3d"),
}


@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_smoke_on_the_cpu(name, tmp_path, capsys):
    mod, argv, tag = DRIVERS[name]
    rel = mod.main(argv + ["--out_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert np.isfinite(rel) and rel > 0
    assert f"rel_err:{rel}" in out
    lines = [json.loads(ln) for ln in
             (tmp_path / f"{tag}_metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in lines)
    assert (tmp_path / "checkpoints" / tag).is_dir()
    # the mesh flags ask for their ranks, --pp included
    for flag in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(SystemExit, match="needs 2 devices"):
            mod.main(argv + flag)
    with pytest.raises(SystemExit, match="--pp 2 x --tp 1 needs 2 devices"):
        mod.main(argv + ["--pp", "2"])
    if name == "exp_darcy":    # --showcase: the prediction renders
        renders = tmp_path / "results" / "darcy"
        assert sorted(os.listdir(renders)) == [
            "case_1_error.png", "case_1_gt.png", "case_1_pred.png"]
        assert f"showcase renders -> {renders}" in out
