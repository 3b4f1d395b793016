"""Scaled copy ``x * 1.000001``: the micro benchmark's fixed-cost kernel.

Counterpart of the Pallas TPU kernel ``copy_kernel`` and its chain
``chain_copy`` in ``benchmarks/micro_erwin_fused.py:70-80``: one kernel that
reads a float32 array and writes ``x * 1.000001`` to a new one
(``out_shape``), chained ``reps`` times so that the per-call cost of a
launch can be timed. The CUDA kernel is ``haet_torch/csrc/copy_kernel.cu``.

* :func:`copy_scale` launches the kernel on a CUDA tensor and runs
  :func:`copy_scale_plain` on a CPU tensor;
* :func:`chain_copy` is the Python loop that stands in for the JAX
  ``fori_loop``.

The constant is float32(1.000001), as JAX's weakly typed Python float is on
a float32 ref, so the kernel, the plain version and the JAX kernel give the
same bits.
"""

from __future__ import annotations

import ctypes

import torch

from . import LaunchCounter, _build

#: the multiplier of ``micro_erwin_fused.py:71``
SCALE = 1.000001

LAUNCHES = LaunchCounter()


def copy_scale_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`copy_scale`."""
    return x * SCALE


def copy_scale(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.000001`` in a new tensor.

    On a CUDA tensor (float32, contiguous, at least one element) it launches
    the kernel or raises; on a CPU tensor it runs :func:`copy_scale_plain`.
    The C function and the stream query are resolved at the first launch
    (:func:`_entry`), so a call costs the checks, one allocation and one
    ctypes call.
    """
    if not x.is_cuda:
        if x.device.type == "cpu":
            return copy_scale_plain(x)
        raise ValueError(f"copy_scale runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"copy_scale takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("copy_scale needs a contiguous tensor")
    n = x.numel()
    if n < 1:
        raise ValueError("copy_scale needs at least one element")
    fn, raw_stream = _ENTRY or _entry()
    out = torch.empty_like(x)
    status = fn(x.data_ptr(), out.data_ptr(), n, raw_stream(x.get_device()))
    if status:
        _build.check(_build.load("copy_kernel"), status, "copy_scale")
    LAUNCHES.add()
    return out


def chain_copy(x: torch.Tensor, reps: int) -> torch.Tensor:
    """:func:`copy_scale` applied ``reps`` times, each call on the last
    one's output (the ``fori_loop`` of ``micro_erwin_fused.py:80``)."""
    for _ in range(reps):
        x = copy_scale(x)
    return x


#: ``(C function, stream query)`` once resolved by :func:`_entry`
_ENTRY = None


def _entry():
    """Build or load the library and resolve ``haet_copy_scale_f32`` with
    its argument types, and the query of the current stream's raw handle
    (``torch._C._cuda_getCurrentRawStream``, the int that
    ``torch.cuda.current_stream(dev).cuda_stream`` gives without making a
    ``Stream`` object)."""
    global _ENTRY
    fn = _build.load("copy_kernel").haet_copy_scale_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _ENTRY = (fn, torch._C._cuda_getCurrentRawStream)
    return _ENTRY
