"""PyTorch port, the ShapeNet-Car drivers ``car_train`` and ``car_eval``.

Both run on the CPU with ``--device cpu --smoke`` (n_hidden 32, 1 layer,
G 16, 2 epochs), both kernel flags set (their plain versions on the CPU):

* on a fixture-built fold layout (``param0``: 1 sample held out,
  ``param1``: 2): the fold counts print as in the JAX driver's test
  (``tests/test_drivers_real_branch.py:80-115``), the metrics are finite
  (``rho_d`` of one validation sample is nan, as in JAX), the ``.npy``
  cache is written and its ``--preprocessed`` branch runs, and ``--resume``
  restores ``last``;
* on the synthetic stand-in (no dataset directory): every metric finite;
* ``car_eval --which last`` reproduces ``car_train``'s final metrics at
  rtol 1e-5 (``car_train`` evaluates its final state, which ``last``
  holds); ``--save_preds`` writes the denormalised dumps;
* ``--bf16 1`` and ``--mu_bf16 1`` train (the bf16 compute dtype; Adam's
  first moment stored in bf16), and ``car_eval``, in float32 as the JAX
  driver evaluates, reproduces ``car_train --mu_bf16 1``'s metrics and
  comes within ``BF16_METRIC_RTOL`` of ``car_train --bf16 1``'s;
* ``car_eval --export_artifact`` (with and without
  ``--export_point_buckets``) writes programs that answer as the evaluated
  model, their manifests naming the fold and the checkpoint;
* ``car_eval --torch_checkpoint`` on a reference-format checkpoint gives
  the metrics of the same weights evaluated directly, with
  ``--visualize``, ``--max_slice_figs`` and ``--scatter`` writing their
  renders; the mesh flags, which wait for a later item, raise
  ``NotImplementedError`` naming it, and without ``--device`` and without
  a card both drivers raise.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from haet_torch.benchmarks import car_eval, car_train
from haet_torch.export import load_artifact
from haet_torch.train import Checkpointer
from haet_torch.train.car import evaluate
from haet_torch.utils.torch_import import to_torch_state_dict
from test_torch_car_data import build_car_dataset

METRICS = ("rel_l2_press", "rel_l2_velo", "rmse_press", "rmse_velo",
           "time_per_sample", "cd_rel_err", "rho_d")
SMOKE_EVAL = ["--smoke", "--n_hidden", "32", "--n_layers", "1",
              "--slice_num", "16"]
#: ``car_eval`` (float32) of a ``car_train --bf16 1`` checkpoint against
#: ``car_train``'s own bf16 evaluation: each metric averages the bf16
#: model's rounding (~1e-2 of max |out| per point) over the points;
#: measured up to 2.5e-4 relative (``cd_rel_err``)
BF16_METRIC_RTOL = 2e-3


@pytest.fixture(scope="module", autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    """``car_train`` on the fixture layout, then ``car_eval --which last``
    on its checkpoints, with the captured output of each."""
    root = tmp_path_factory.mktemp("drivers")
    data_dir, out = str(root / "training_data"), str(root / "runs")
    build_car_dataset(data_dir)
    common = ["--data_dir", data_dir, "--device", "cpu"]
    train_args = common + ["--smoke", "--out_dir", out, "--save_dir",
                           str(root / "cache")]
    return dict(root=root, out=out, common=common, train_args=train_args)


def _run(fn, argv, capsys):
    metrics = fn(argv)
    return metrics, capsys.readouterr().out


def test_car_train_on_fixture_layout(fixture_run, capsys):
    metrics, out = _run(car_train.main, fixture_run["train_args"], capsys)
    assert "synthetic stand-in" not in out
    assert "train 2 / val 1 samples" in out
    assert sorted(metrics) == sorted(METRICS)
    for k in METRICS[:-1]:
        assert np.isfinite(metrics[k]), k
    assert np.isnan(metrics["rho_d"])   # Spearman's rho of one pair
    cache = fixture_run["root"] / "cache"
    for fold, names in [("param0", ["car_a"]),
                        ("param1", ["car_b", "car_c"])]:
        for n in names:
            for f in ("pos.npy", "x.npy", "y.npy", "surf.npy"):
                assert (cache / fold / n / f).exists(), (fold, n, f)
    ck = os.path.join(fixture_run["out"], "checkpoints", "car")
    assert {"best.pt", "last.pt", "epochs.json"} <= set(os.listdir(ck))
    assert os.path.exists(os.path.join(fixture_run["out"],
                                       "car_metrics.jsonl"))

    # car_eval on `last` reproduces them; --save_preds dumps the fold
    ev_out = str(fixture_run["root"] / "eval")
    got, out = _run(car_eval.main, fixture_run["common"] + SMOKE_EVAL + [
        "--checkpoint_dir", ck, "--which", "last", "--save_preds",
        "--out_dir", ev_out], capsys)
    for k in METRICS[:-2]:
        if k != "time_per_sample":
            np.testing.assert_allclose(got[k], metrics[k], rtol=1e-5,
                                       err_msg=k)
    np.testing.assert_allclose(got["cd_rel_err"], metrics["cd_rel_err"],
                               rtol=1e-5)
    pred = np.load(os.path.join(ev_out, "results", "0_pred.npy"))
    gt = np.load(os.path.join(ev_out, "results", "0_gt.npy"))
    assert pred.shape == gt.shape and pred.shape[1] == 4
    assert np.isfinite(pred).all()
    assert "per-sample predictions" in out

    # the cache's branch, then a resume of the finished run: `last` is
    # restored at its step and epoch, no epoch is left to run, and the
    # evaluation of the same state repeats
    args = fixture_run["train_args"] + ["--preprocessed"]
    pre, out = _run(car_train.main, args, capsys)
    assert "train 2 / val 1 samples" in out
    assert np.isfinite(pre["rel_l2_press"])
    resumed, out = _run(car_train.main, args + ["--resume"], capsys)
    assert "[Trainer] resumed from step 4 (epoch 1)" in out
    assert "epoch=" not in out
    for k in ("rel_l2_press", "rel_l2_velo", "rmse_press", "rmse_velo"):
        assert resumed[k] == pre[k], k


def test_drivers_on_synthetic_stand_in(tmp_path, capsys):
    out_dir = str(tmp_path / "runs")
    common = ["--data_dir", str(tmp_path / "absent"), "--device", "cpu"]
    metrics, out = _run(car_train.main, common + [
        "--smoke", "--out_dir", out_dir, "--prefetch", "0"], capsys)
    assert "synthetic stand-in" in out
    assert "train 6 / val 2 samples" in out
    for k in METRICS:
        assert np.isfinite(metrics[k]), k
    got, _ = _run(car_eval.main, common + SMOKE_EVAL + [
        "--checkpoint_dir", os.path.join(out_dir, "checkpoints", "car"),
        "--which", "last"], capsys)
    for k in METRICS:
        if k != "time_per_sample":
            np.testing.assert_allclose(got[k], metrics[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("argv,match", [
    (["--dp", "2"], "needs 2 devices, have 1"),
    (["--tp", "2"], "needs 2 devices, have 1"),
    (["--pp", "2"], r"--dp 1 x --pp 2 x --tp 1 needs 2 devices, have 1"),
    (["--multihost"], "HAET_COORDINATOR"),
])
def test_car_train_unported_flags_raise(argv, match):
    """The mesh flags are ported: in this one process ``--dp 2``, ``--tp
    2`` and ``--pp 2`` exit asking for their ranks before any process
    group is made, and ``--multihost`` for a cluster to join
    (``tests/test_torch_trainer_mesh.py`` and
    ``tests/test_torch_pipeline.py`` run them over four ranks)."""
    argv = ["--smoke", "--device", "cpu"] + argv
    with pytest.raises(SystemExit, match=match):
        car_train.main(argv)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("flag", ["--bf16", "--mu_bf16"])
def test_car_train_bf16_flags_train(flag, tmp_path, capsys, monkeypatch):
    """Each flag trains one smoke epoch on the stand-in with the state it
    names in bf16: the model's output (its parameters stay float32), or
    Adam's first moment; the metrics are finite, and ``car_eval`` of
    ``last``, in float32, reproduces them (``--mu_bf16``: the same float32
    model) or comes within ``BF16_METRIC_RTOL`` of them (``--bf16``)."""
    from haet_torch.train import trainer as trainer_mod

    seen = {}
    real_init = trainer_mod.Trainer.__init__

    def spy(self, model, *a, **k):
        real_init(self, model, *a, **k)
        seen["trainer"] = self

    monkeypatch.setattr(trainer_mod.Trainer, "__init__", spy)
    out_dir = str(tmp_path / "runs")
    common = ["--data_dir", str(tmp_path / "absent"), "--device", "cpu"]
    metrics, _ = _run(car_train.main, common + [
        "--smoke", "--epochs", "1", "--out_dir", out_dir, "--prefetch", "0",
        flag, "1"], capsys)
    tr = seen["trainer"]
    assert {p.dtype for p in tr.model.parameters()} == {torch.float32}
    moments = {st["exp_avg"].dtype for st in tr.optimizer.state.values()}
    x = torch.zeros(1, 64, 7)
    with torch.inference_mode():
        out_dtype = tr.model.eval()(x).dtype
    if flag == "--bf16":
        assert out_dtype == torch.bfloat16 and moments == {torch.float32}
    else:
        assert out_dtype == torch.float32 and moments == {torch.bfloat16}
    for k in METRICS:
        assert np.isfinite(metrics[k]), k
    got, _ = _run(car_eval.main, common + SMOKE_EVAL + [
        "--checkpoint_dir", os.path.join(out_dir, "checkpoints", "car"),
        "--which", "last"], capsys)
    for k in METRICS:
        if k != "time_per_sample":
            print(f"PARITY car_eval (float32) against car_train {flag} 1: "
                  f"{k} {got[k]:.6g} {metrics[k]:.6g}")
            np.testing.assert_allclose(
                got[k], metrics[k], err_msg=k,
                rtol=BF16_METRIC_RTOL if flag == "--bf16" else 1e-5)


@pytest.fixture(scope="module")
def reference_eval(fixture_run):
    """``car_eval --torch_checkpoint --visualize --max_slice_figs 2
    --scatter`` on the fixture fold, once: a reference-format checkpoint
    (``{"epoch", "model_state_dict", "val_loss": np.float64}``) of a seeded
    smoke model, and that model's own evaluation of the fold."""
    root = fixture_run["root"]
    argv = fixture_run["common"] + SMOKE_EVAL
    args = car_eval.parse_args(argv)
    model = car_train.build_model(car_train.model_config(args), "cpu",
                                  seed=11)
    pt = str(root / "reference.pt")
    torch.save({"epoch": 3, "model_state_dict": {
        k: torch.from_numpy(v) for k, v in to_torch_state_dict(model).items()},
        "val_loss": np.float64(0.25)}, pt)
    _, val_s, coef, _ = car_train.load_fold(args)
    direct = evaluate(model, val_s, coef)
    out_dir = str(root / "reference_eval")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = car_eval.main(argv + [
            "--torch_checkpoint", pt, "--visualize", "--max_slice_figs", "2",
            "--scatter", "--out_dir", out_dir])
    return dict(got=got, direct=direct, out=buf.getvalue(), dir=out_dir)


@pytest.mark.parametrize("argv,match", [
    (["--torch_checkpoint"], "imported reference torch checkpoint"),
    (["--visualize"], "slice visualizations ->"),
    (["--scatter"], "Cd scatter ->"),
    (["--max_slice_figs", "2"], "slice_1_sample_0.png"),
], ids=[f"argv{i}-drivers and utils" for i in range(2, 6)])
def test_car_eval_unported_flags_raise(reference_eval, argv, match):
    """The four flags that waited for the drivers and utils item are
    ported (the test keeps its name): one ``car_eval`` with all four on the
    fixture fold. ``--torch_checkpoint`` gives the metrics of the same
    weights evaluated directly; ``--visualize`` writes the reference's
    render set, ``--max_slice_figs 2`` two per-slice figures of it;
    ``--scatter`` the Cd scatter."""
    r = reference_eval
    vis = os.path.join(r["dir"], "visualizations")
    flag = argv[0]
    if flag == "--torch_checkpoint":
        assert match in r["out"]
        for k in METRICS:
            if k != "time_per_sample":
                np.testing.assert_allclose(r["got"][k], r["direct"][k],
                                           rtol=1e-6, err_msg=k)
    elif flag == "--visualize":
        assert match in r["out"]
        assert {"car_slices_0.png", "slice_heatmap_0.png",
                "projection_xy_0.png", "projection_xz_0.png",
                "projection_yz_0.png"} <= set(os.listdir(vis))
    elif flag == "--scatter":
        assert match in r["out"]
        assert os.path.exists(os.path.join(r["dir"], "cd_scatter.png"))
    else:
        slices = sorted(f for f in os.listdir(vis) if f.startswith("slice_")
                        and "_sample_" in f)
        assert slices == ["slice_0_sample_0.png", match]


@pytest.mark.parametrize("buckets", [None, "4096"],
                         ids=["artifact", "point_buckets"])
def test_car_eval_exports(fixture_run, buckets, capsys):
    """``car_eval --export_artifact``: the evaluated weights' batch-1
    program at the first validation sample's bucket, or with
    ``--export_point_buckets`` a family of batch sizes 1, 2, 4 per bucket;
    each manifest names the fold and the checkpoint, and each program
    answers as the evaluated model (the ``last`` checkpoint)."""
    out = fixture_run["root"] / f"export_{buckets is not None}"
    ck = os.path.join(fixture_run["out"], "checkpoints", "car")
    if not os.path.exists(os.path.join(ck, "last.pt")):
        _run(car_train.main, fixture_run["train_args"], capsys)
    argv = fixture_run["common"] + SMOKE_EVAL + [
        "--checkpoint_dir", ck, "--which", "last",
        "--export_artifact", str(out)]
    if buckets:
        argv += ["--export_point_buckets", buckets]
    _, printed = _run(car_eval.main, argv, capsys)
    manifests = {d: json.load(open(out / d / "manifest.json"))
                 for d in sorted(os.listdir(out))}
    shapes = sorted(tuple(m["input_shapes"][0]) for m in manifests.values())
    if buckets:
        assert "serving point-bucket family ([4096])" in printed
        assert shapes == [(1, 4096, 7), (2, 4096, 7), (4, 4096, 7)]
        assert all(m["point_bucket"] == 4096 for m in manifests.values())
    else:
        assert "serving artifact ->" in printed and len(shapes) == 1
        assert shapes[0][0] == 1 and shapes[0][1] % 2048 == 0
    state = Checkpointer(ck).restore("last")["model"]
    model = car_train.build_model(car_eval.model_config(
        car_eval.parse_args(argv)), "cpu")
    model.load_state_dict(state)
    model.eval()
    for m in manifests.values():
        assert m["checkpoint"] == "last" and m["fold_id"] == 0
    first = min(manifests, key=lambda d: manifests[d]["input_shapes"])
    em = load_artifact(str(out / first), device="cpu")
    x = np.random.RandomState(0).randn(*shapes[0]).astype(np.float32)
    with torch.inference_mode():
        want = model(torch.from_numpy(x), None)
    torch.testing.assert_close(em.bind(state)(x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("main", [car_train.main, car_eval.main],
                         ids=["car_train", "car_eval"])
def test_drivers_need_a_card_by_default(main, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--smoke", "--data_dir", str(tmp_path)])
