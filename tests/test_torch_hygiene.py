"""PyTorch port, import hygiene and the device rule.

``haet_torch`` and ``chip_smoke.py`` import ``torch``, numpy and the
standard library only: never JAX, flax, optax or anything of ``haet_tpu``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from haet_torch.utils.env import default_device

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "haet_tpu")


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
            "slice_kernels.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'optax', 'haet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import haet_torch, haet_torch.serve, haet_torch.models\n"
            "import haet_torch.utils.config, haet_torch.utils.weights\n"
            "import haet_torch.ops.kernels.slice_kernels\n"
            "import haet_torch.ops.kernels.erwin_block\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_rule(monkeypatch):
    assert default_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
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
