"""Fused Erwin transformer block, forward and backward.

Counterpart of ``haet_tpu/ops/pallas/erwin_block.py:fused_erwin_block``:
one launch runs a whole ``ErwinTransformerBlock``
(``x += BMSA(RMSNorm(x), pos); x += SwiGLU(RMSNorm(x))``) for every cloud,
with the kernels in ``haet_torch/csrc/erwin_block.cu``: each cloud on a
thread-block cluster of :data:`CLUSTER` CTAs that share out its products
and exchange activations through the cluster's shared memory. On CUDA
tensors :class:`ErwinBlockFn` ties the forward kernel to the backward kernel
(``_fused_block_bwd`` of the JAX code), which recomputes the block from
``(x, pos)`` and gives ``dx``, ``dpos`` and every parameter gradient but
``sigma_att``'s (the distance bias carries none, as in the reference).

The functional pieces below (:func:`ball_msa`, :func:`swiglu`,
:func:`erwin_block_plain`) are the one definition of the block's math: the
modules of :mod:`haet_torch.models.erwin` call them, and
:func:`erwin_block_plain` is the kernel's plain version, run on CPU tensors.

Parameters are passed as the block's own ``named_parameters()`` dict, in
torch layout (``norm1.weight``, ``BMSA.qkv.weight`` ``[3C, C]``, ...), as the
JAX function takes its flax param subtree; :class:`ErwinBlockFn` takes them
as separate tensors in :data:`PARAM_NAMES` order, so autograd tracks each.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ball_groups import effective_ball_size
from . import LaunchCounter, _build

LAUNCHES = LaunchCounter()
BWD_LAUNCHES = LaunchCounter()
#: blocks built with ``use_pallas`` whose shape failed :func:`eligible` and
#: ran the plain block instead (counted by ``ErwinTransformerBlock``), and
#: those of them recorded for autograd, whose backward is the plain block's
PLAIN_ROUTES = LaunchCounter()
BWD_PLAIN_ROUTES = LaunchCounter()

#: dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
RMS_EPS = 1e-6

#: parameter names, in the order the C entry point takes them
PARAM_NAMES = (
    "norm1.weight", "BMSA.pe_proj.weight", "BMSA.pe_proj.bias",
    "BMSA.qkv.weight", "BMSA.qkv.bias", "BMSA.sigma_att",
    "BMSA.proj.weight", "BMSA.proj.bias", "norm2.weight",
    "swiglu.w1.weight", "swiglu.w1.bias", "swiglu.w2.weight",
    "swiglu.w2.bias", "swiglu.w3.weight", "swiglu.w3.bias",
)
#: the parameters the backward kernel gives a gradient, in its order
GRAD_NAMES = tuple(k for k in PARAM_NAMES if k != "BMSA.sigma_att")

#: CTAs per cloud: each cloud runs on a thread-block cluster of this many
#: (the portable cluster size), each owning a share of every product
CLUSTER = 8

#: the kernels' buffers (``csrc/erwin_block.cu:FwdBuf``/``BwdBuf``) with
#: their kind, in the order the layouts place them into shared memory:
#: "shared" ones are activations every rank holds whole, most of them read
#: by peers (exchanges, partial sums), "weight"
#: ones are the block's parameter vectors and the rank's weight slices
#: (read from the parameter tensors themselves when they do not fit),
#: "local" ones the rank's own
FWD_BUFFERS = (
    ("x", "shared"), ("qkv", "shared"), ("o", "shared"),
    ("vec", "weight"), ("w_qkvh", "weight"), ("w_qkv", "weight"),
    ("w_o", "weight"), ("w_1", "weight"), ("w_2", "weight"),
    ("w_3", "weight"),
    ("hm", "local"), ("u", "local"), ("t", "local"), ("pos", "local"),
    ("rel", "local"), ("rinv", "local"), ("probs", "local"))
BWD_BUFFERS = (
    ("qkv", "shared"), ("o", "shared"), ("x1", "shared"), ("dqkv", "shared"),
    ("vec", "weight"), ("w_qkvh", "weight"), ("w_qkv", "weight"),
    ("w_o", "weight"), ("w_1", "weight"), ("w_2", "weight"),
    ("w_3", "weight"),
    ("x", "local"), ("dx1", "local"), ("hm", "local"), ("zn", "local"),
    ("dz", "local"), ("pos", "local"), ("rel", "local"), ("r1", "local"),
    ("r2", "local"), ("rowdot", "local"), ("u", "local"), ("t", "local"),
    ("g", "local"), ("probs", "local"), ("dprobs", "local"))


class Layout(NamedTuple):
    """Where one kernel keeps its buffers in each CTA: ``ints`` is what the
    C entry point takes (the offsets, the shared-memory flags and the
    scratch stride), ``smem`` the dynamic shared memory in bytes, ``scratch``
    the floats of global scratch per CTA."""
    ints: tuple
    smem: int
    scratch: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _heads_spanned(items: int, per_head: int, k: int = CLUSTER) -> int:
    """The most heads any rank's share of ``items`` (pairs or units, head
    by head, ``per_head`` each) touches: the heads whose q, k, v rows it
    computes."""
    most = 0
    for r in range(k):
        lo, hi = items * r // k, items * (r + 1) // k
        if hi > lo:
            most = max(most, (hi - 1) // per_head - lo // per_head + 1)
    return most


def _buffer_floats(n, c, d, hidden, heads, bs, k=CLUSTER) -> dict:
    """Floats of every buffer of either kernel in one CTA: the activations
    each rank holds whole (rows padded by one float against bank
    conflicts), its shares of the hidden columns and of the attention
    pairs, the parameter vectors and its weight slices (rows padded
    likewise)."""
    ldc, ld3, hs = c + 1, 3 * c + 1, _ceil(hidden, k)
    hd, nb = c // heads, n // bs
    full = {name: n * ldc for name in ("x", "o", "hm", "x1", "dx1", "zn",
                                       "dz")}
    return {**full, "qkv": n * ld3, "dqkv": n * ld3,
            "u": n * (hs + 1), "t": n * (hs + 1), "g": n * (hs + 1),
            "pos": n * d, "rel": n * d, "rinv": n, "r1": n, "r2": n,
            "rowdot": n,
            # the forward's share of (head, query) pairs; the backward's
            # share of whole (head, ball) units, bs pairs each
            "probs_fwd": _ceil(heads * n, k) * bs,
            "probs": _ceil(heads * (n // bs), k) * bs * bs,
            "dprobs": _ceil(heads * (n // bs), k) * bs * bs,
            "vec": 8 * c + c * d + heads + 2 * hidden,
            # the q, k, v rows of the heads of the rank's pairs (forward)
            # or units (backward)
            "w_qkvh_fwd": 3 * hd * _heads_spanned(heads * n, n, k) * ldc,
            "w_qkvh": 3 * hd * _heads_spanned(heads * nb, nb, k) * ldc,
            "w_qkv": _ceil(3 * c, k) * ldc, "w_o": _ceil(c, k) * ldc,
            "w_1": hs * ldc, "w_2": hs * ldc, "w_3": c * (hs + 1)}


def _layout(buffers, floats: dict) -> Layout:
    """Each buffer in order into shared memory while it fits in
    :data:`MAX_SMEM_BYTES`; else a weight stays in its tensor and any other
    buffer goes to the CTA's global scratch."""
    offs, flags = [], []
    used = spilled = 0
    for name, kind in buffers:
        size = floats[name]
        if 4 * (used + size) <= MAX_SMEM_BYTES:
            offs.append(used)
            flags.append(1)
            used += size
        elif kind == "weight":
            offs.append(0)
            flags.append(0)
        else:
            offs.append(spilled)
            flags.append(0)
            spilled += size
    return Layout(tuple(offs + flags + [spilled]), 4 * used, spilled)


def fwd_layout(n: int, c: int, d: int, hidden: int, heads: int,
               bs: int) -> Layout:
    """The forward kernel's buffers in one CTA of a cloud's cluster."""
    floats = _buffer_floats(n, c, d, hidden, heads, bs)
    floats.update(probs=floats["probs_fwd"], w_qkvh=floats["w_qkvh_fwd"],
                  w_qkv=0)   # the forward uses no share of the Wqkv rows
    return _layout(FWD_BUFFERS, floats)


def bwd_layout(n: int, c: int, d: int, hidden: int, heads: int,
               bs: int) -> Layout:
    """The backward kernel's buffers in one CTA of a cloud's cluster."""
    return _layout(BWD_BUFFERS, _buffer_floats(n, c, d, hidden, heads, bs))


def eligible(n: int, c: int, num_heads: int, dim: int, hidden: int,
             d: int = 3) -> bool:
    """Shape gate of the fused kernels, one for both directions: the JAX
    gate (``haet_tpu/ops/pallas/erwin_block.py:eligible``: n a power of two
    up to 512, C up to 512, heads dividing C).

    Every shape inside it fits: :func:`fwd_layout`/:func:`bwd_layout` keep
    what does not fit in a CTA's shared memory in a global scratch (and
    the weight slices in their tensors). At the car shapes everything is in
    shared memory. ``hidden`` and ``d`` size the layouts, not the gate.
    Shapes outside the gate take the plain block at the module level.
    """
    return (c == dim and c % num_heads == 0 and 1 <= n <= 512 and c <= 512
            and (n & (n - 1)) == 0)


class _Plan(NamedTuple):
    fwd: Layout
    bwd: Layout
    fwd_ints: ctypes.Array
    bwd_ints: ctypes.Array
    grad_shapes: tuple
    grad_sizes: tuple


@functools.lru_cache(maxsize=64)
def _plan(n: int, c: int, d: int, hidden: int, heads: int, bs: int) -> _Plan:
    """Both layouts, as the C entry points take them, and the gradient
    shapes, once per block shape."""
    fwd = fwd_layout(n, c, d, hidden, heads, bs)
    bwd = bwd_layout(n, c, d, hidden, heads, bs)
    shapes = param_shapes(c, d, heads, hidden)
    grad_shapes = tuple(shapes[k] for k in GRAD_NAMES)
    return _Plan(fwd, bwd, (ctypes.c_int * len(fwd.ints))(*fwd.ints),
                 (ctypes.c_int * len(bwd.ints))(*bwd.ints), grad_shapes,
                 tuple(math.prod(s) for s in grad_shapes))


# ---------------------------------------------------------------------------
# The block's math, shared by the modules and the plain version.
# ---------------------------------------------------------------------------

def ball_msa(x, pos, pe_w, pe_b, qkv_w, qkv_b, sigma, proj_w, proj_b, *,
             ball_size: int, num_heads: int):
    """Ball multi-head self-attention (``haet_tpu/models/erwin.py:61-131``).

    ``x: [B, N, C]``, ``pos: [B, N, D]``; ``sigma`` is ``sigma_att``
    ``[1, H, 1, 1]`` or None (no distance bias). The bias
    ``sigma * cdist`` is computed without gradient.
    """
    B, N, C = x.shape
    D = pos.shape[-1]
    bs = effective_ball_size(ball_size, N)
    nb = N // bs
    h, hd = num_heads, C // num_heads
    pos_b = pos.reshape(B, nb, bs, D)
    rel_pos = pos_b - pos_b.mean(dim=2, keepdim=True)
    x = x + F.linear(rel_pos.reshape(B, N, D), pe_w, pe_b)
    qkv = F.linear(x, qkv_w, qkv_b).reshape(B, nb, bs, 3, h, hd)
    q, k, v = (qkv[:, :, :, i].movedim(3, 2) for i in range(3))
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    if sigma is not None:
        with torch.no_grad():
            diff = pos_b[:, :, :, None, :] - pos_b[:, :, None, :, :]
            dist = torch.sqrt((diff * diff).sum(-1) + 1e-12)  # [B, nb, bs, bs]
            bias = sigma.detach().reshape(1, 1, h, 1, 1) * dist[:, :, None]
        logits = logits + bias
    attn = torch.softmax(logits, dim=-1)
    out = (attn @ v).movedim(2, 3).reshape(B, N, C)
    return F.linear(out, proj_w, proj_b)


def swiglu(x, w1, b1, w2, b2, w3, b3):
    """``w3(w2(x) * silu(w1(x)))``."""
    return F.linear(F.linear(x, w2, b2) * F.silu(F.linear(x, w1, b1)), w3, b3)


def rms_norm(x, weight):
    return F.rms_norm(x, (x.shape[-1],), weight, RMS_EPS)


def erwin_block_plain(x, pos, params: dict, *, ball_size: int,
                      num_heads: int, use_dist_bias: bool = True):
    """Plain version of :func:`fused_erwin_block`."""
    p = params
    sigma = p["BMSA.sigma_att"] if use_dist_bias else None
    x = x + ball_msa(rms_norm(x, p["norm1.weight"]), pos,
                     p["BMSA.pe_proj.weight"], p["BMSA.pe_proj.bias"],
                     p["BMSA.qkv.weight"], p["BMSA.qkv.bias"], sigma,
                     p["BMSA.proj.weight"], p["BMSA.proj.bias"],
                     ball_size=ball_size, num_heads=num_heads)
    return x + swiglu(rms_norm(x, p["norm2.weight"]),
                      p["swiglu.w1.weight"], p["swiglu.w1.bias"],
                      p["swiglu.w2.weight"], p["swiglu.w2.bias"],
                      p["swiglu.w3.weight"], p["swiglu.w3.bias"])


def erwin_block_bwd_plain(x, pos, dout, params: dict, *, ball_size: int,
                          num_heads: int, use_dist_bias: bool = True):
    """Plain version of :func:`fused_erwin_block_bwd`: autograd of
    :func:`erwin_block_plain`."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        pos = pos.detach().requires_grad_()
        leaves = {k: params[k].detach().requires_grad_() for k in GRAD_NAMES}
        p = dict(leaves)
        if use_dist_bias:
            p["BMSA.sigma_att"] = params["BMSA.sigma_att"]
        out = erwin_block_plain(x, pos, p, ball_size=ball_size,
                                num_heads=num_heads,
                                use_dist_bias=use_dist_bias)
        dx, dpos, *grads = torch.autograd.grad(
            out, [x, pos, *leaves.values()], dout)
    return dx, dpos, dict(zip(GRAD_NAMES, grads))


# ---------------------------------------------------------------------------
# The kernel wrappers.
# ---------------------------------------------------------------------------

def param_shapes(c: int, d: int, heads: int, hidden: int) -> dict:
    """``{name: shape}`` of the block's parameters, in torch layout."""
    return {
        "norm1.weight": (c,), "BMSA.pe_proj.weight": (c, d),
        "BMSA.pe_proj.bias": (c,), "BMSA.qkv.weight": (3 * c, c),
        "BMSA.qkv.bias": (3 * c,), "BMSA.sigma_att": (1, heads, 1, 1),
        "BMSA.proj.weight": (c, c), "BMSA.proj.bias": (c,),
        "norm2.weight": (c,), "swiglu.w1.weight": (hidden, c),
        "swiglu.w1.bias": (hidden,), "swiglu.w2.weight": (hidden, c),
        "swiglu.w2.bias": (hidden,), "swiglu.w3.weight": (c, hidden),
        "swiglu.w3.bias": (c,),
    }


def _checked(what, x, pos, params, num_heads, use_dist_bias, dout=None):
    """Check a CUDA call's inputs; returns ``(b, n, c, d, hidden, ptrs)``
    with ``ptrs`` the parameter pointers in :data:`PARAM_NAMES` order
    (None for an unused ``sigma_att``)."""
    if x.dim() != 3 or pos.dim() != 3 or pos.shape[:2] != x.shape[:2]:
        raise ValueError(f"x [B, N, C] and pos [B, N, D] expected, got "
                         f"{tuple(x.shape)} and {tuple(pos.shape)}")
    b, n, c = x.shape
    d = pos.shape[-1]
    hidden = params["swiglu.w1.weight"].shape[0]
    if not eligible(n, c, num_heads, params["norm1.weight"].shape[0], hidden,
                    d):
        raise ValueError(
            f"{what}: shape n={n}, C={c}, heads={num_heads}, "
            f"hidden={hidden}, D={d} is outside the kernel's gate (n a "
            f"power of two up to 512, C up to 512 and divisible by the "
            f"heads); route it to the plain block")
    shapes = {"x": (b, n, c), "pos": (b, n, d), "dout": (b, n, c),
              **param_shapes(c, d, num_heads, hidden)}
    tensors = {"x": x, "pos": pos}
    if dout is not None:
        tensors["dout"] = dout
    for name in PARAM_NAMES:
        if name == "BMSA.sigma_att" and not use_dist_bias:
            continue
        tensors[name] = params[name]
    for name, t in tensors.items():
        want = shapes[name]
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(want)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ptrs = [tensors[k].data_ptr() if k in tensors else None
            for k in PARAM_NAMES]
    return b, n, c, d, hidden, ptrs


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _device(x, what):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return x.device.type


def fused_erwin_block(x, pos, params: dict, *, ball_size: int,
                      num_heads: int, use_dist_bias: bool = True):
    """Run one Erwin block through the fused kernel.

    Args:
        x: ``[B, N, C]`` float32 features (B = clouds).
        pos: ``[B, N, D]`` float32 positions.
        params: the block's ``named_parameters()`` (:data:`PARAM_NAMES`;
            ``BMSA.sigma_att`` only read when ``use_dist_bias``).
        ball_size: requested ball size (clamped to the cloud like BallMSA).

    Returns ``[B, N, C]``. On CUDA tensors it goes through
    :class:`ErwinBlockFn`, so its backward is the backward kernel. Raises on
    a CUDA shape outside :func:`eligible`.
    """
    if _device(x, "fused_erwin_block") == "cpu":
        return erwin_block_plain(x, pos, params, ball_size=ball_size,
                                 num_heads=num_heads,
                                 use_dist_bias=use_dist_bias)
    return ErwinBlockFn.apply(
        ball_size, num_heads, use_dist_bias, x, pos,
        *(None if k == "BMSA.sigma_att" and not use_dist_bias else params[k]
          for k in PARAM_NAMES))


def _scratch(layout: Layout, clouds: int, device):
    """The CTAs' global scratch for what ``layout`` spills, or None."""
    if not layout.scratch:
        return None
    return torch.empty((clouds * CLUSTER, layout.scratch), device=device,
                       dtype=torch.float32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fused_fwd(x, pos, params, ball_size, num_heads, use_dist_bias):
    b, n, c, d, hidden, ptrs = _checked("fused_erwin_block", x, pos, params,
                                        num_heads, use_dist_bias)
    bs = effective_ball_size(ball_size, n)
    plan = _plan(n, c, d, hidden, num_heads, bs)
    out = torch.empty_like(x)
    scratch = _scratch(plan.fwd, b, x.device)
    lib = _lib()
    status = lib.haet_erwin_block_fwd_f32(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(), _ptr(scratch), *ptrs,
        b, n, c, d, num_heads, bs, hidden, int(use_dist_bias), CLUSTER,
        plan.fwd_ints, plan.fwd.smem, _stream(x.device))
    _build.check(lib, status, "fused_erwin_block")
    LAUNCHES.add()
    return out


def fused_erwin_block_bwd(x, pos, dout, params: dict, *, ball_size: int,
                          num_heads: int, use_dist_bias: bool = True):
    """Backward of :func:`fused_erwin_block` through the backward kernel.

    Returns ``(dx, dpos, grads)`` with ``grads`` a ``{name: gradient}`` dict
    over :data:`GRAD_NAMES` (no ``sigma_att``). The kernel writes each
    cloud's parameter gradients to a ``[clouds, P]`` partials buffer and a
    second launch sums them over the clouds in a fixed order. On CPU tensors
    it runs :func:`erwin_block_bwd_plain`. Raises on a CUDA shape outside
    :func:`eligible`.
    """
    if _device(x, "fused_erwin_block_bwd") == "cpu":
        return erwin_block_bwd_plain(x, pos, dout, params,
                                     ball_size=ball_size,
                                     num_heads=num_heads,
                                     use_dist_bias=use_dist_bias)
    b, n, c, d, hidden, ptrs = _checked("fused_erwin_block_bwd", x, pos,
                                        params, num_heads, use_dist_bias,
                                        dout)
    bs = effective_ball_size(ball_size, n)
    plan = _plan(n, c, d, hidden, num_heads, bs)
    dev = x.device
    np_ = sum(plan.grad_sizes)
    dx = torch.empty_like(x)
    dpos = torch.empty_like(pos)
    partials = torch.empty((b, np_), device=dev, dtype=torch.float32)
    grads = torch.empty(np_, device=dev, dtype=torch.float32)
    scratch = _scratch(plan.bwd, b, dev)
    lib = _lib()
    status = lib.haet_erwin_block_bwd_f32(
        x.data_ptr(), pos.data_ptr(), dout.data_ptr(), dx.data_ptr(),
        dpos.data_ptr(), partials.data_ptr(), grads.data_ptr(),
        _ptr(scratch), *ptrs, b, n, c, d, num_heads, bs, hidden,
        int(use_dist_bias), np_, CLUSTER, plan.bwd_ints, plan.bwd.smem,
        _stream(dev))
    _build.check(lib, status, "fused_erwin_block_bwd")
    BWD_LAUNCHES.add()
    return dx, dpos, {k: g.view(shape) for k, g, shape in
                      zip(GRAD_NAMES, grads.split(plan.grad_sizes),
                          plan.grad_shapes)}


class ErwinBlockFn(torch.autograd.Function):
    """The fused block on CUDA tensors: the forward kernel, and the backward
    kernel as its backward (the JAX ``custom_vjp``,
    ``erwin_block.py:319-406``). Takes the parameters as separate tensors
    in :data:`PARAM_NAMES` order (``sigma_att`` None without the distance
    bias) and returns no gradient for ``sigma_att``."""

    @staticmethod
    def forward(ctx, ball_size, num_heads, use_dist_bias, x, pos, *params):
        p = dict(zip(PARAM_NAMES, params))
        ctx.save_for_backward(x, pos, *params)
        ctx.cfg = dict(ball_size=ball_size, num_heads=num_heads,
                       use_dist_bias=use_dist_bias)
        return _fused_fwd(x, pos, p, ball_size, num_heads, use_dist_bias)

    @staticmethod
    def backward(ctx, dout):
        x, pos, *params = ctx.saved_tensors
        dx, dpos, grads = fused_erwin_block_bwd(
            x, pos, dout.contiguous(), dict(zip(PARAM_NAMES, params)),
            **ctx.cfg)
        return (None, None, None, dx, dpos,
                *(grads.get(k) for k in PARAM_NAMES))


def _lib() -> ctypes.CDLL:
    lib = _build.load("erwin_block")
    if not getattr(lib, "_haet_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.haet_erwin_block_fwd_f32.argtypes = (
            [P] * 19 + [I] * 9 + [ctypes.POINTER(I), I, P])
        lib.haet_erwin_block_fwd_f32.restype = I
        lib.haet_erwin_block_bwd_f32.argtypes = (
            [P] * 23 + [I] * 10 + [ctypes.POINTER(I), I, P])
        lib.haet_erwin_block_bwd_f32.restype = I
        lib._haet_typed = True
    return lib
