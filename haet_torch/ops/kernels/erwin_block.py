"""Fused Erwin transformer block (forward).

Counterpart of ``haet_tpu/ops/pallas/erwin_block.py:fused_erwin_block``:
one launch runs a whole ``ErwinTransformerBlock``
(``x += BMSA(RMSNorm(x), pos); x += SwiGLU(RMSNorm(x))``) for every cloud,
with the kernel in ``haet_torch/csrc/erwin_block.cu``.

The functional pieces below (:func:`ball_msa`, :func:`swiglu`,
:func:`erwin_block_plain`) are the one definition of the block's math: the
modules of :mod:`haet_torch.models.erwin` call them, and
:func:`erwin_block_plain` is the kernel's plain version, run on CPU tensors.

Parameters are passed as the block's own ``named_parameters()`` dict, in
torch layout (``norm1.weight``, ``BMSA.qkv.weight`` ``[3C, C]``, ...), as the
JAX function takes its flax param subtree.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from ..ball_groups import effective_ball_size
from . import LaunchCounter, _build

LAUNCHES = LaunchCounter()
#: blocks built with ``use_pallas`` whose shape failed :func:`eligible` and
#: ran the plain block instead (counted by ``ErwinTransformerBlock``)
PLAIN_ROUTES = LaunchCounter()

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


def smem_bytes(n: int, c: int, d: int, hidden: int) -> int:
    """Dynamic shared memory of the kernel for one cloud, in float32: ``x``,
    the normed/hm buffer and the attention output (``n (C+1)`` each),
    ``qkv`` (``n (3C+1)``), the SwiGLU hidden (``n (hidden+1)``; every row is
    padded by one float against bank conflicts), positions and relative
    positions (``2 n D``) and one 1/rms per row."""
    return 4 * n * (6 * c + hidden + 2 * d + 6)


def eligible(n: int, c: int, num_heads: int, dim: int, hidden: int,
             d: int = 3) -> bool:
    """Shape gate of the fused kernel, derived from its shared memory.

    The JAX gate (``n <= 512``) was sized for 16 MB of TPU VMEM. Here the
    bound is :func:`smem_bytes` <= 227 KB: n <= 128 at C = 32 with a 128-wide
    SwiGLU, n <= 64 at C = 64 with 256. Shapes outside it take the plain
    block at the module level.
    """
    return (c == dim and c % num_heads == 0 and n >= 1
            and (n & (n - 1)) == 0
            and smem_bytes(n, c, d, hidden) <= MAX_SMEM_BYTES)


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


# ---------------------------------------------------------------------------
# The kernel wrapper.
# ---------------------------------------------------------------------------

def fused_erwin_block(x, pos, params: dict, *, ball_size: int,
                      num_heads: int, use_dist_bias: bool = True):
    """Run one Erwin block through the fused kernel.

    Args:
        x: ``[B, N, C]`` float32 features (B = clouds).
        pos: ``[B, N, D]`` float32 positions.
        params: the block's ``named_parameters()`` (:data:`PARAM_NAMES`;
            ``BMSA.sigma_att`` only read when ``use_dist_bias``).
        ball_size: requested ball size (clamped to the cloud like BallMSA).

    Returns ``[B, N, C]``. Raises on a CUDA shape outside :func:`eligible`.
    """
    if x.device.type == "cpu":
        return erwin_block_plain(x, pos, params, ball_size=ball_size,
                                 num_heads=num_heads,
                                 use_dist_bias=use_dist_bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_erwin_block runs on cuda or cpu, not "
                         f"{x.device}")
    if x.dim() != 3 or pos.dim() != 3 or pos.shape[:2] != x.shape[:2]:
        raise ValueError(f"x [B, N, C] and pos [B, N, D] expected, got "
                         f"{tuple(x.shape)} and {tuple(pos.shape)}")
    b, n, c = x.shape
    d = pos.shape[-1]
    hidden = params["swiglu.w1.weight"].shape[0]
    if not eligible(n, c, num_heads, params["norm1.weight"].shape[0], hidden,
                    d):
        raise ValueError(
            f"fused_erwin_block: shape n={n}, C={c}, heads={num_heads}, "
            f"hidden={hidden}, D={d} is outside the kernel's gate "
            f"(needs {smem_bytes(n, c, d, hidden)} B of shared memory, "
            f"limit {MAX_SMEM_BYTES}); route it to the plain block")
    shapes = {
        "x": (b, n, c), "pos": (b, n, d),
        "norm1.weight": (c,), "BMSA.pe_proj.weight": (c, d),
        "BMSA.pe_proj.bias": (c,), "BMSA.qkv.weight": (3 * c, c),
        "BMSA.qkv.bias": (3 * c,), "BMSA.sigma_att": (1, num_heads, 1, 1),
        "BMSA.proj.weight": (c, c), "BMSA.proj.bias": (c,),
        "norm2.weight": (c,), "swiglu.w1.weight": (hidden, c),
        "swiglu.w1.bias": (hidden,), "swiglu.w2.weight": (hidden, c),
        "swiglu.w2.bias": (hidden,), "swiglu.w3.weight": (c, hidden),
        "swiglu.w3.bias": (c,),
    }
    tensors = {"x": x, "pos": pos}
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
    bs = effective_ball_size(ball_size, n)
    out = torch.empty_like(x)
    ptrs = [tensors[k].data_ptr() if k in tensors else None
            for k in PARAM_NAMES]
    lib = _lib()
    status = lib.haet_erwin_block_fwd_f32(
        x.data_ptr(), pos.data_ptr(), out.data_ptr(), *ptrs,
        b, n, c, d, num_heads, bs, hidden, int(use_dist_bias),
        smem_bytes(n, c, d, hidden),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, status, "fused_erwin_block")
    LAUNCHES.add()
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("erwin_block")
    if not getattr(lib, "_haet_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.haet_erwin_block_fwd_f32.argtypes = [P] * 18 + [I] * 8 + [I, P]
        lib.haet_erwin_block_fwd_f32.restype = I
        lib._haet_typed = True
    return lib
