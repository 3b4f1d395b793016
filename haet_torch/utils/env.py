"""Device and precision policy of the port.

Every entry point takes ``device=None``, which means the CUDA card. Without a
card it raises instead of quietly running on the CPU; a caller who wants the
CPU says so with ``device="cpu"`` (the tests do).

Precision: the JAX reference computes the slice logits at
``Precision.HIGHEST`` (``haet_tpu/ops/pallas/slice_kernels.py:55-70``) and the
rest of the model in full float32. On the card a float32 matmul is full
float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False, and a
cuDNN op only while ``torch.backends.cudnn.allow_tf32`` is False (its default
is True), so both are stated here and set by :func:`default_device`.
"""

from __future__ import annotations

import torch

#: the float32 policy: no TF32 anywhere (matches ``Precision.HIGHEST``)
ALLOW_TF32 = False


def set_precision_policy() -> None:
    """Apply :data:`ALLOW_TF32` to PyTorch's matmul and cuDNN switches."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32


def default_device(device=None) -> torch.device:
    """Resolve an entry point's ``device`` argument.

    ``None`` means CUDA and raises when no card is present; anything else is
    passed to :class:`torch.device` as given. Also applies the precision
    policy, so every entry point runs under it.
    """
    set_precision_policy()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "haet_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
