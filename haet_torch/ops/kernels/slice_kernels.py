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
raise.

Gradients: :class:`SliceStatesFn` and :class:`DesliceFn` wrap the forwards,
and their backwards are :func:`slice_states_bwd` and :func:`deslice_bwd` on
both devices: the hand-derived, chunked passes over N of the JAX
``custom_vjp`` (``slice_kernels.py:253-380`` and ``:448-523``), written as
PyTorch code. Like the JAX backwards, they never hold more than one
``[B*H, BWD_CHUNK, G]`` weight tile. Only ``states`` and ``out`` carry a
gradient; ``m`` and ``s`` are marked non-differentiable.
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
#: points per chunk of the backward passes (``_BWD_CHUNK`` of the JAX code);
#: a module constant so that tests can make the chunk loop run several times
BWD_CHUNK = 64 * 1024

#: the slice norm of the states: ``sum_n w + 1e-5`` with ``sum_n w == 1``
_NORM = 1.0 + 1e-5

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


# The residual guards of the Pallas kernels (``slice_kernels.py:99-104,
# :115, :139-140``): an all ``-inf`` column keeps ``m`` finite, and an empty
# one divides by 1.
def _m_safe(m):
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _denom(s):
    return torch.where(s > 0, s, torch.ones_like(s))


def slice_states_plain(x_proj, w_slice, b_slice, w_ada, b_ada,
                       base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`slice_states` (materialises ``[B,H,N,G]``)."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    m = z.amax(dim=2)                                           # [B,H,G]
    e = torch.exp(z - _m_safe(m)[:, :, None, :])
    s = e.sum(dim=2)
    acc = torch.einsum("bhng,bhnc->bhgc", e, x_proj.float())
    states = acc / _denom(s)[..., None] / _NORM
    return states.to(x_proj.dtype), m, s


def deslice_plain(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                  base_temp: float = 0.5, epsilon: float = 1e-6):
    """Plain version of :func:`deslice`."""
    z = _logits(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp, epsilon)
    w = (torch.exp(z - _m_safe(m)[:, :, None, :])
         / _denom(s)[:, :, None, :])
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
    """Fused eidetic states, differentiable in ``states``
    (:class:`SliceStatesFn`).

    Args:
        x_proj: ``[B, H, N, C]`` float32, contiguous.
        w_slice/b_slice: ``[C, G]``, ``[G]``; w_ada/b_ada: ``[C, 1]``, ``[1]``.

    Returns ``(states [B,H,G,C], m [B,H,G], s [B,H,G])``.
    """
    return SliceStatesFn.apply(x_proj, w_slice, b_slice, w_ada, b_ada,
                               base_temp, epsilon)


def deslice(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
            base_temp: float = 0.5, epsilon: float = 1e-6):
    """Fused deslice: ``out[b,h,n,:] = sum_g w[b,h,n,g] states[b,h,g,:]``
    with ``w`` recomputed from the ``(m, s)`` residuals of
    :func:`slice_states`. Returns ``[B, H, N, C]``, differentiable in every
    input but ``m`` and ``s`` (:class:`DesliceFn`)."""
    return DesliceFn.apply(x_proj, w_slice, b_slice, w_ada, b_ada, states, m,
                           s, base_temp, epsilon)


def _slice_states_fwd(x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                      epsilon):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
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


def _deslice_fwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                 base_temp, epsilon):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
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


class SliceStatesFn(torch.autograd.Function):
    """:func:`slice_states` with :func:`slice_states_bwd` as its backward
    (the JAX ``custom_vjp``, ``slice_kernels.py:316-383``). The float32
    states are the residual; a gradient arriving on ``m`` or ``s`` is
    dropped, as the JAX backward drops it."""

    @staticmethod
    def forward(ctx, x_proj, w_slice, b_slice, w_ada, b_ada, base_temp,
                epsilon):
        states, m, s = _slice_states_fwd(x_proj, w_slice, b_slice, w_ada,
                                         b_ada, base_temp, epsilon)
        ctx.save_for_backward(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                              m, s)
        ctx.consts = (base_temp, epsilon)
        ctx.mark_non_differentiable(m, s)
        return states, m, s

    @staticmethod
    def backward(ctx, g_states, _g_m, _g_s):
        grads = slice_states_bwd(*ctx.saved_tensors, g_states, *ctx.consts)
        return (*grads, None, None)


class DesliceFn(torch.autograd.Function):
    """:func:`deslice` with :func:`deslice_bwd` as its backward (the JAX
    ``custom_vjp``, ``slice_kernels.py:441-526``): no gradient for ``m``,
    ``s``."""

    @staticmethod
    def forward(ctx, x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                base_temp, epsilon):
        ctx.save_for_backward(x_proj, w_slice, b_slice, w_ada, b_ada, states,
                              m, s)
        ctx.consts = (base_temp, epsilon)
        return _deslice_fwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m,
                            s, base_temp, epsilon)

    @staticmethod
    def backward(ctx, g_out):
        grads = deslice_bwd(*ctx.saved_tensors, g_out, *ctx.consts)
        return (*grads, None, None, None, None)


# ---------------------------------------------------------------------------
# Chunked backwards (plain PyTorch, both devices).
#
# Per (b, h), with the softmax over the points axis n:
#   raw[n] = x[n] @ Wa + ba;  tau[n] = base + clip(raw[n], +-0.4)
#   logit[n, g] = (x[n] @ Ws + bs - log(-log eps)) / tau[n]
#   w[n, g] = exp(logit - m[g]) / s[g]                (m, s: the residuals)
# Given dL/dw, the softmax jacobian gives dL/dlogit = w (dL/dw - t[g]) with
# t[g] = sum_n w dL/dw; then the Ada-Temp chain to x, Ws, bs, Wa, ba. Every
# term decomposes over chunks of n once (m, s) are known.
# ---------------------------------------------------------------------------

def _w_chunk(xc, ws, bs, wa, ba, base_temp, shift, m_safe, denom):
    """``(w, logit, tau, raw)`` of one ``[BH, T, C]`` chunk, float32."""
    raw = xc @ wa + ba                                   # [BH, T, 1]
    tau = base_temp + raw.clamp(-0.4, 0.4)
    logit = (xc @ ws + bs - shift) / tau                 # [BH, T, G]
    w = torch.exp(logit - m_safe[:, None, :]) / denom[:, None, :]
    return w, logit, tau, raw


def _chain_to_inputs(xc, w, dw, t, logit, tau, raw, ws, wa):
    """``dL/dw`` of one chunk -> ``(dx, dWs, dbs, dWa, dba)``
    (``slice_kernels.py:293-305``; the clip passes a gradient only strictly
    inside ``(-0.4, 0.4)``)."""
    dlogit = w * (dw - t[:, None, :])
    dpre = dlogit / tau
    dtau = -(dlogit * logit).sum(dim=-1, keepdim=True) / tau
    draw = torch.where((raw > -0.4) & (raw < 0.4), dtau,
                       torch.zeros_like(dtau))
    dx = dpre @ ws.t() + draw @ wa.t()
    return (dx, torch.einsum("btc,btg->cg", xc, dpre), dpre.sum(dim=(0, 1)),
            torch.einsum("btc,bto->co", xc, draw), draw.sum(dim=(0, 1)))


def _flat_f32(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s):
    b, h, n, c = x_proj.shape
    g = w_slice.shape[1]
    bh = b * h
    m_safe = _m_safe(m.reshape(bh, g).float())
    denom = _denom(s.reshape(bh, g).float())
    return ((b, h, n, c, g), x_proj.reshape(bh, n, c).float(),
            (w_slice.float(), b_slice.float(), w_ada.float(), b_ada.float()),
            states.reshape(bh, g, c).float(), m_safe, denom)


def _chunks(n: int):
    return [slice(i, min(i + BWD_CHUNK, n)) for i in range(0, n, BWD_CHUNK)]


def slice_states_bwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s,
                     g_states, base_temp: float = 0.5,
                     epsilon: float = 1e-6):
    """Backward of :func:`slice_states` from its residuals and ``dL/dstates``:
    ``(dx_proj, dWs, dbs, dWa, dba)`` (``slice_kernels.py:327-380``).

    One pass over N in chunks of :data:`BWD_CHUNK`: with ``states = A /
    (1 + 1e-5)`` and ``sum_n w == 1``, the softmax coupling has the closed
    form ``t[g] = sum_c G^[g, c] A[g, c] + dnorm[g]``, where ``G^`` is the
    states' gradient over the norm and ``dnorm = -sum_c G^ states`` is the
    norm's own gradient.
    """
    (b, h, n, c, g), xf, (ws, bs, wa, ba), st, m_safe, denom = _flat_f32(
        x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s)
    shift = _shift(epsilon)
    ghat = g_states.reshape(b * h, g, c).float() / _NORM     # [BH, G, C]
    dnorm = -(ghat * st).sum(dim=-1)                         # [BH, G]
    t = (ghat * (st * _NORM)).sum(dim=-1) + dnorm
    dx = torch.empty_like(xf)
    dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
    dwa, dba = torch.zeros_like(wa), torch.zeros_like(ba)
    for sl in _chunks(n):
        xc = xf[:, sl]
        w, logit, tau, raw = _w_chunk(xc, ws, bs, wa, ba, base_temp, shift,
                                      m_safe, denom)
        dw = xc @ ghat.transpose(1, 2) + dnorm[:, None, :]
        dxc, dws_c, dbs_c, dwa_c, dba_c = _chain_to_inputs(
            xc, w, dw, t, logit, tau, raw, ws, wa)
        dx[:, sl] = w @ ghat + dxc                     # the A path, then z
        dws += dws_c
        dbs += dbs_c
        dwa += dwa_c
        dba += dba_c
    return (dx.reshape(b, h, n, c).to(x_proj.dtype), dws.to(w_slice.dtype),
            dbs.to(b_slice.dtype), dwa.to(w_ada.dtype), dba.to(b_ada.dtype))


def deslice_bwd(x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s, g_out,
                base_temp: float = 0.5, epsilon: float = 1e-6):
    """Backward of :func:`deslice` from its residuals and ``dL/dout``:
    ``(dx_proj, dWs, dbs, dWa, dba, dstates)`` (``slice_kernels.py:448-523``).

    The coupling ``t[g] = sum_n w (dL/dout @ states^T)`` has no closed form,
    so two passes run over N: the first sums ``t`` and ``dL/dstates``, the
    second applies the softmax and Ada-Temp chain.
    """
    (b, h, n, c, g), xf, (ws, bs, wa, ba), st, m_safe, denom = _flat_f32(
        x_proj, w_slice, b_slice, w_ada, b_ada, states, m, s)
    shift = _shift(epsilon)
    go = g_out.reshape(b * h, n, c).float()
    st_t = st.transpose(1, 2)                                # [BH, C, G]
    t = torch.zeros_like(m_safe)
    dst = torch.zeros_like(st)
    for sl in _chunks(n):
        w, *_ = _w_chunk(xf[:, sl], ws, bs, wa, ba, base_temp, shift, m_safe,
                         denom)
        goc = go[:, sl]
        t += (w * (goc @ st_t)).sum(dim=1)
        dst += w.transpose(1, 2) @ goc
    dx = torch.empty_like(xf)
    dws, dbs = torch.zeros_like(ws), torch.zeros_like(bs)
    dwa, dba = torch.zeros_like(wa), torch.zeros_like(ba)
    for sl in _chunks(n):
        xc = xf[:, sl]
        w, logit, tau, raw = _w_chunk(xc, ws, bs, wa, ba, base_temp, shift,
                                      m_safe, denom)
        dx[:, sl], dws_c, dbs_c, dwa_c, dba_c = _chain_to_inputs(
            xc, w, go[:, sl] @ st_t, t, logit, tau, raw, ws, wa)
        dws += dws_c
        dbs += dbs_c
        dwa += dwa_c
        dba += dba_c
    return (dx.reshape(b, h, n, c).to(x_proj.dtype), dws.to(w_slice.dtype),
            dbs.to(b_slice.dtype), dwa.to(w_ada.dtype), dba.to(b_ada.dtype),
            dst.reshape(b, h, g, c).to(states.dtype))


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
