"""haet_torch — the PyTorch/CUDA port of ``haet_tpu`` for NVIDIA Hopper.

The package mirrors ``haet_tpu``'s layout (``ops/``, ``models/``,
``utils/``, ``train/``, ``serve.py``) and imports only ``torch``, numpy and
the standard library: never JAX and nothing of ``haet_tpu``. Weights cross
over from the JAX package only through :mod:`haet_torch.utils.weights`.

The Pallas TPU kernels on the served and trained paths are hand-written
CUDA kernels for ``sm_90a`` under ``haet_torch/csrc/``, built with ``nvcc``
at first use (:mod:`haet_torch.ops.kernels._build`); the forwards are
``haet::`` operators (which exported programs call, :mod:`haet_torch.export`)
inside ``torch.autograd.Function`` s. Each wrapper launches its kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""

from .utils.env import default_device  # noqa: F401

__version__ = "0.1.0"
