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

The bf16 model (``ModelConfig.bf16``) takes its dense products in bf16, as
XLA's bf16 dots do: bf16 operands, float32 accumulation, one rounding of
the result. cuBLAS may otherwise reduce a split-K bf16 product's partial
sums in bf16, so ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` is False too
(:data:`ALLOW_BF16_REDUCED_REDUCTION`).

The structured models' convolutions run in cuDNN, whose default backward
algorithms may sum with atomics in an order that changes from call to
call; ``torch.backends.cudnn.deterministic`` (:data:`CUDNN_DETERMINISTIC`)
picks deterministic ones, so that a step replayed from a CUDA graph equals
the eager step bit for bit, as the kernels' own sums do.
"""

from __future__ import annotations

import contextlib
import functools

import torch

#: the float32 policy: no TF32 anywhere (matches ``Precision.HIGHEST``)
ALLOW_TF32 = False
#: the bf16 policy: bf16 products accumulate in float32 throughout
ALLOW_BF16_REDUCED_REDUCTION = False
#: cuDNN's convolutions in a fixed summation order
CUDNN_DETERMINISTIC = True


def set_precision_policy() -> None:
    """Apply :data:`ALLOW_TF32` to PyTorch's matmul and cuDNN switches,
    :data:`ALLOW_BF16_REDUCED_REDUCTION` to its bf16 matmuls and
    :data:`CUDNN_DETERMINISTIC` to cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.deterministic = CUDNN_DETERMINISTIC
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = (
        ALLOW_BF16_REDUCED_REDUCTION)


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


def host_numpy(t: torch.Tensor):
    """``t`` as a numpy array on the host. numpy has no bf16, so a bf16
    tensor comes back as the exact float32 widening of its values (the JAX
    package returns ``ml_dtypes`` bf16 arrays, which the port does not
    depend on): the values are identical, only the dtype differs."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def grad_off():
    """``torch.no_grad()`` where autograd records, and no context where it
    already does not. Equal in effect; but a ``torch.export`` trace (run
    under ``no_grad``) then holds no grad-mode regions, which its
    ``set_grad_enabled`` pass would inline one at a time, each a
    recompilation of the whole graph: quadratic in the graph's length, and
    a rollout program is ``steps`` forwards long."""
    return (torch.no_grad() if torch.is_grad_enabled()
            else contextlib.nullcontext())


def without_grad(fn):
    """``fn`` run under :func:`grad_off` (the decorator form)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with grad_off():
            return fn(*args, **kwargs)
    return wrapped
