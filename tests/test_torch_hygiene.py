"""PyTorch port, import hygiene and the device rule.

``haet_torch`` and ``chip_smoke.py`` import ``torch``, numpy, scipy and
the standard library only: never JAX, flax, optax or anything of ``haet_tpu``,
and never scikit-learn (absent on the card's machine; the data layer's
nearest neighbours come from scipy).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from haet_torch.data.shapenet_car import CarSample
from haet_torch.models import HAETransolverIrregularMesh
from haet_torch.train import Trainer
from haet_torch.train.car import loss_fn_builder, make_batch
from haet_torch.utils.config import shapenet_car_train_config
from haet_torch.utils.env import default_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "haet_tpu",
             "sklearn")


def _port_files():
    return sorted((ROOT / "haet_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_are_found():
    names = {p.name for p in _port_files()}
    assert {"chip_smoke.py", "serve.py", "erwin_block.py",
            "slice_kernels.py", "trainer.py", "car.py", "checkpoint.py",
            "shapenet_car.py", "vtk_io.py", "car_train.py",
            "car_eval.py", "export.py", "serve_http.py",
            "micro_serving_latency.py", "micro_serving_server.py",
            "embedding.py", "dropout.py", "pde_datasets.py",
            "pde_common.py", "exp_darcy.py", "exp_pipe.py",
            "exp_airfoil.py", "exp_elas.py", "exp_3d.py", "exp_ns.py",
            "exp_plas.py", "micro_rollout.py", "erwin_baseline.py",
            "neighbors.py", "scatter.py", "mfu_sweep.py",
            "accum_mem_probe.py", "model_dict.py", "parity_repro.py",
            "torch_import.py", "visualization.py", "mesh.py",
            "distributed.py", "collectives.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'haet_tpu',\n"
            "          'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "import haet_torch, haet_torch.serve, haet_torch.models\n"
            "import haet_torch.utils.config, haet_torch.utils.weights\n"
            "import haet_torch.ops.kernels.slice_kernels\n"
            "import haet_torch.ops.kernels.erwin_block\n"
            "import haet_torch.train, haet_torch.train.car\n"
            "import haet_torch.data.shapenet_car, haet_torch.data.vtk_io\n"
            "import haet_torch.data.preprocess_car\n"
            "import haet_torch.benchmarks.car_train\n"
            "import haet_torch.benchmarks.car_eval\n"
            "import haet_torch.export, haet_torch.serve_http\n"
            "import haet_torch.benchmarks.micro_serving_latency\n"
            "import haet_torch.benchmarks.micro_serving_server\n"
            "import haet_torch.models.components\n"
            "import haet_torch.data.pde_datasets, haet_torch.data.synthetic\n"
            "import haet_torch.benchmarks.pde_common\n"
            "import haet_torch.benchmarks.exp_darcy\n"
            "import haet_torch.benchmarks.exp_pipe\n"
            "import haet_torch.benchmarks.exp_airfoil\n"
            "import haet_torch.benchmarks.exp_elas\n"
            "import haet_torch.benchmarks.exp_3d\n"
            "import haet_torch.parallel, haet_torch.parallel.collectives\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_new_modules_import_with_matplotlib_blocked():
    """The modules of the sweeps, the utils and the native readers import
    where matplotlib (absent on the card's machine) and JAX are: plotting
    imports matplotlib only when it runs."""
    code = ("import sys\n"
            "for m in ('matplotlib', 'jax', 'jaxlib', 'flax', 'optax',\n"
            "          'haet_tpu', 'sklearn'):\n"
            "    sys.modules[m] = None\n"
            "import haet_torch.utils.visualization\n"
            "import haet_torch.utils.torch_import, haet_torch.native\n"
            "import haet_torch.benchmarks.mfu_sweep\n"
            "import haet_torch.benchmarks.accum_mem_probe\n"
            "import haet_torch.benchmarks.model_dict\n"
            "import haet_torch.benchmarks.parity_repro\n"
            "import haet_torch.benchmarks.car_eval\n"
            "import haet_torch.benchmarks.exp_darcy\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_serving_imports_no_model_code():
    """A process that loads programs and reads checkpoints (the config,
    the HTTP front end, the checkpointer) imports no model code: the auto
    threshold lives in the config, which the models read, not the other
    way round, and the trainer imports the pipeline only when built."""
    code = ("import sys\n"
            "import haet_torch.utils.config, haet_torch.serve_http\n"
            "import haet_torch.export, haet_torch.train.checkpoint\n"
            "assert 'haet_torch.models' not in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_native_builds_name_no_jax_package_path():
    """The native sources under ``haet_torch/native/`` are built from
    there into ``haet_torch/_build/``: no build command, output or
    ``#include`` names a path of the JAX package."""
    from haet_torch import native

    for name, (src, _) in native.LIBS.items():
        path = ROOT / "haet_torch" / "native" / src
        assert path.exists(), src
        includes = [ln for ln in path.read_text().splitlines()
                    if ln.lstrip().startswith("#include")]
        assert not [ln for ln in includes if "haet_tpu" in ln], src
        out = native.library_path(name)
        assert out.parent == ROOT / "haet_torch" / "_build", out
        cmd = native.compile_command(name, out)
        assert str(path) in cmd
        assert not [a for a in cmd if "haet_tpu" in a], cmd


def test_default_device_rule(monkeypatch):
    assert default_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device(None)


def test_chip_smoke_refuses_without_card():
    """Without a card the smoke run exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, torch, runpy\n"
         "torch.cuda.is_available = lambda: False\n"
         "sys.argv = ['chip_smoke.py']\n"
         "runpy.run_path('chip_smoke.py', run_name='__main__')\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_cpu_train_step_leaves_every_gradient_but_sigma():
    """A CPU ``train_step`` of a small model with both kernel flags set
    leaves a finite ``.grad`` on every parameter upstream and downstream of
    the kernels' autograd functions, and none on ``sigma_att`` (the distance
    bias is gradient-free). The card's half of this check is
    ``chip_smoke.py`` phase 6."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        model = HAETransolverIrregularMesh(
            space_dim=7, fun_dim=0, out_dim=4, n_layers=1, n_hidden=32,
            n_head=4, slice_num=16, enc_num_heads=(2, 4), enc_depths=(1, 1),
            dec_num_heads=(2,), dec_depths=(1,), embed=True, use_pallas=True,
            use_pallas_erwin=True, device="cpu")
        trainer = Trainer(model, loss_fn_builder(0.5),
                          shapenet_car_train_config(), 10,
                          batch_args=lambda b: (b["x"], None))
        rng = np.random.RandomState(0)
        surf = np.zeros(100, bool)
        surf[-20:] = True
        metrics = trainer.train_step(make_batch(CarSample(
            rng.rand(100, 3), rng.randn(100, 7), rng.randn(100, 4), surf),
            n_pad=128))
    finally:
        torch.set_num_threads(threads)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    n_sigma = 0
    for name, p in model.named_parameters():
        if name.endswith("sigma_att"):
            assert p.grad is None, name
            n_sigma += 1
        else:
            assert p.grad is not None, name
            assert bool(torch.isfinite(p.grad).all()), name
    assert n_sigma == 3   # one Erwin block per level

