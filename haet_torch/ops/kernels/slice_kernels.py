"""Fused rep-slice tokenizer: ``slice_states`` and ``deslice``.

Counterparts of the Pallas TPU kernels in
``haet_tpu/ops/pallas/slice_kernels.py`` (``slice_states`` and ``deslice``),
with the same arguments and layouts:

* :func:`slice_states` -> ``(states [B,H,G,C], m [B,H,G], s [B,H,G])``: the
  eidetic states from an online column softmax over the points axis, plus
  its running max ``m`` and max-shifted denominator ``s``;
* :func:`deslice` -> ``out [B,H,N,C] = w @ states`` with the weights
  ``w = exp(z - m) / s`` recomputed from those residuals.

The kernels (``haet_torch/csrc/slice_kernels.cu``) never materialise the
``[B, H, N, G]`` weights. On CPU tensors the wrappers run the plain versions
below, which do materialise them; on CUDA tensors they launch the kernel or
raise. Forward only: the backwards come with the training slice.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import LaunchCounter, _build

#: points per block of the slice_states partial pass (8 x 126 blocks at the
#: car shapes, B*H = 8, N = 32186)
CHUNK = 256
#: the kernel keeps G*C accumulators in registers: 256 threads x 8
MAX_GC = 256 * 8

SLICE_STATES_LAUNCHES = LaunchCounter()
DESLICE_LAUNCHES = LaunchCounter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _shift(epsilon: float) -> float:
    return math.log(-math.log(epsilon))


def _logits(x, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon):
    """``z = (x @ Ws + bs - log(-log eps)) / tau`` in float32."""
    x = x.float()
    raw = x @ w_ada.float() + b_ada.float()
    tau = base_temp + raw.clamp(-0.4, 0.4)
    return (x @ w_slice.float() + b_slice.float() - _shift(epsilon)) / tau


def slice_states_plain(x_proj, w_slice, b_slice, w_ada, b_ada,
                       base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`slice_states` (materialises ``[B,H,N,G]``)."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    m = z.amax(dim=2)                                           # [B,H,G]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(z - m_safe[:, :, None, :])
    s = e.sum(dim=2)
    denom = torch.where(s > 0, s, torch.ones_like(s))
    acc = torch.einsum("bhng,bhnc->bhgc", e, x_proj.float())
    states = acc / denom[..., None] / (1.0 + 1e-5)
    return states.to(x_proj.dtype), m, s


def deslice_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                  base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`deslice`."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    denom = torch.where(s > 0, s, torch.ones_like(s))
    w = torch.exp(z - m_safe[:, :, None, :]) / denom[:, :, None, :]
    out = torch.einsum("bhng,bhgc->bhnc", w, states.float())
    return out.to(x_proj.dtype)


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada):
    if x_proj.dim() != 4:
        raise ValueError(f"x_proj must be [B, H, N, C], got {x_proj.shape}")
    b, h, n, c = x_proj.shape
    g = w_slice.shape[-1]
    dev = x_proj.device
    _check("x_proj", x_proj, (b, h, n, c), dev)
    _check("w_slice", w_slice, (c, g), dev)
    _check("b_slice", b_slice, (g,), dev)
    _check("w_ada", w_ada, (c, 1), dev)
    _check("b_ada", b_ada, (1,), dev)
    if n < 1:
        raise ValueError("slice kernels need at least one point")
    if g * c > MAX_GC:
        raise ValueError(f"G*C = {g * c} exceeds the kernel's {MAX_GC}")
    return b, h, n, c, g


def _stream(device) -> ctypes.c_void_p:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def slice_states(x_proj, w_slice, b_slice, w_ada, b_ada,
                 base_temp: float = 0.5, epsilon: float = 1e-6):
    """Fused eidetic states.

    Args:
        x_proj: ``[B, H, N, C]`` float32, contiguous.
        w_slice/b_slice: ``[C, G]``, ``[G]``; w_ada/b_ada: ``[C, 1]``, ``[1]``.

    Returns ``(states [B,H,G,C], m [B,H,G], s [B,H,G])``.
    """
    if x_proj.device.type == "cpu":
        return slice_states_plain(x_proj, w_slice, b_slice, w_ada, b_ada,
                                  base_temp, epsilon)
    if x_proj.device.type != "cuda":
        raise ValueError(f"slice_states runs on cuda or cpu, not "
                         f"{x_proj.device}")
    b, h, n, c, g = _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada)
    bh = b * h
    n_chunks = -(-n // CHUNK)
    dev = x_proj.device
    part_m = torch.empty((bh, n_chunks, g), device=dev, dtype=torch.float32)
    part_s = torch.empty_like(part_m)
    part_acc = torch.empty((bh, n_chunks, g, c), device=dev,
                           dtype=torch.float32)
    states = torch.empty((b, h, g, c), device=dev, dtype=torch.float32)
    m = torch.empty((b, h, g), device=dev, dtype=torch.float32)
    s = torch.empty_like(m)
    lib = _lib()
    status = lib.haet_slice_states_f32(
        x_proj.data_ptr(), w_slice.data_ptr(), b_slice.data_ptr(),
        w_ada.data_ptr(), b_ada.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), part_acc.data_ptr(), states.data_ptr(),
        m.data_ptr(), s.data_ptr(), bh, n, c, g, CHUNK, base_temp,
        _shift(epsilon), _stream(dev))
    _build.check(lib, status, "slice_states")
    SLICE_STATES_LAUNCHES.add()
    return states, m, s


def deslice(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
            base_temp: float = 0.5, epsilon: float = 1e-6):
    """Fused deslice: ``out[b,h,n,:] = sum_g w[b,h,n,g] states[b,h,g,:]``
    with ``w`` recomputed from the ``(m, s)`` residuals of
    :func:`slice_states`. Returns ``[B, H, N, C]``."""
    if x_proj.device.type == "cpu":
        return deslice_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                             m, s, base_temp, epsilon)
    if x_proj.device.type != "cuda":
        raise ValueError(f"deslice runs on cuda or cpu, not {x_proj.device}")
    b, h, n, c, g = _check_inputs(x_proj, w_slice, b_slice, w_ada, b_ada)
    dev = x_proj.device
    _check("states", states, (b, h, g, c), dev)
    _check("m", m, (b, h, g), dev)
    _check("s", s, (b, h, g), dev)
    out = torch.empty_like(x_proj)
    lib = _lib()
    status = lib.haet_deslice_f32(
        x_proj.data_ptr(), w_slice.data_ptr(), b_slice.data_ptr(),
        w_ada.data_ptr(), b_ada.data_ptr(), states.data_ptr(), m.data_ptr(),
        s.data_ptr(), out.data_ptr(), b * h, n, c, g, base_temp,
        _shift(epsilon), _stream(dev))
    _build.check(lib, status, "deslice")
    DESLICE_LAUNCHES.add()
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("slice_kernels")
    if not getattr(lib, "_haet_typed", False):
        lib.haet_slice_states_f32.argtypes = (
            [_P] * 11 + [_I] * 5 + [_F, _F, _P])
        lib.haet_slice_states_f32.restype = _I
        lib.haet_deslice_f32.argtypes = [_P] * 9 + [_I] * 4 + [_F, _F, _P]
        lib.haet_deslice_f32.restype = _I
        lib._haet_typed = True
    return lib
