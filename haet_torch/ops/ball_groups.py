"""On-device ball grouping for the Erwin stage, plain PyTorch.

Counterpart of ``haet_tpu/ops/ball_groups.py``. The median-split ball tree
is ``levels`` rounds of within-segment **stable** argsorts along each
segment's max-spread axis, so the permutations equal the JAX package's
integer for integer on the same positions, ties included. ``"morton"``
grouping is one stable sort by a Z-order code of the positions quantised
over each cloud's bounding box (:func:`morton_code`, :func:`morton_perm`):
cheaper, with other ball membership, and equal to the JAX package's codes
and permutations integer for integer. Everything here is gradient-free:
positions are detached on the way in.

Clouds are dense ``pos: [B, N, D]`` with N a power of two (:func:`pad_pow2`
duplicates real points to get there).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..utils.env import without_grad

def _take_points(pos: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Gather ``pos[b, order[b]]`` -> ``[B, N, D]``."""
    return torch.gather(pos, 1, order[..., None].expand(-1, -1, pos.shape[-1]))


def median_split_perm(pos: torch.Tensor, levels: int) -> torch.Tensor:
    """Median-split ball-tree permutation ``[B, N]`` (int64, tree slot ->
    point index) over ``pos: [B, N, D]``, N a power of two."""
    B, N, D = pos.shape
    if N & (N - 1):
        raise ValueError(f"N must be a power of two, got {N}")
    levels = max(0, min(levels, int(math.log2(N))))
    order = torch.arange(N, device=pos.device).expand(B, N)
    p = pos
    for level in range(levels):
        seg = N >> level
        if seg <= 1:
            break
        S = N // seg
        pv = p.reshape(B, S, seg, D)
        spread = pv.amax(dim=2) - pv.amin(dim=2)                # [B, S, D]
        split_dim = spread.argmax(dim=-1)                       # [B, S]
        key = torch.gather(
            pv, 3, split_dim[:, :, None, None].expand(B, S, seg, 1))[..., 0]
        idx = torch.sort(key, dim=-1, stable=True).indices      # [B, S, seg]
        order = torch.gather(order.reshape(B, S, seg), 2, idx).reshape(B, N)
        p = torch.gather(pv, 2, idx[..., None].expand(B, S, seg, D)
                         ).reshape(B, N, D)
    return order


def _part1by1(x: torch.Tensor) -> torch.Tensor:
    """16 bits of ``x`` spread with a zero bit between each (2D Morton)."""
    x = x & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """10 bits of ``x`` spread with two zero bits between each (3D
    Morton)."""
    x = x & 0x000003FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_code(pos: torch.Tensor) -> torch.Tensor:
    """The int32 Z-order code of ``pos: [..., N, D]`` (D in 1, 2, 3),
    quantised over each cloud's bounding box: 30 bits in 1D, 15 bits per
    axis in 2D, 10 in 3D (``haet_tpu/ops/ball_groups.py:113-136``)."""
    D = pos.shape[-1]
    lo = pos.amin(dim=-2, keepdim=True)
    hi = pos.amax(dim=-2, keepdim=True)
    scale = torch.where(hi - lo > 0, hi - lo, torch.ones_like(hi))
    unit = (pos - lo) / scale
    if D == 1:
        return torch.clamp(unit[..., 0] * 0x3FFFFFFF, 0,
                           0x3FFFFFFF).to(torch.int32)
    if D == 2:
        top = (1 << 15) - 1
        q = torch.clamp(unit * top, 0, top).to(torch.int32)
        return (_part1by1(q[..., 0]) << 1) | _part1by1(q[..., 1])
    if D == 3:
        top = (1 << 10) - 1
        q = torch.clamp(unit * top, 0, top).to(torch.int32)
        return ((_part1by2(q[..., 0]) << 2) | (_part1by2(q[..., 1]) << 1)
                | _part1by2(q[..., 2]))
    raise ValueError(f"morton_code supports D in (1, 2, 3); got {D}")


def morton_perm(pos: torch.Tensor, levels: int = 0) -> torch.Tensor:
    """Space-filling-curve grouping ``[B, N]`` (int64): one stable sort by
    :func:`morton_code`. ``levels`` is taken for the groupers' common
    signature and ignored."""
    del levels
    return torch.sort(morton_code(pos), dim=-1, stable=True).indices


#: the groupings :func:`build_erwin_perms` takes, by name
GROUPERS = {"median": median_split_perm, "morton": morton_perm}


def rotation_matrix(angle_deg: float, dim: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Cross-ball rotation matrix, including the reference's unusual 3D
    matrix (``balltree.pyx:576-596``; ``haet_tpu/ops/ball_groups.py:146``)."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    if dim == 1:
        rows = [[1.0]]
    elif dim == 2:
        rows = [[c, -s], [s, c]]
    elif dim == 3:
        rows = [
            [c * c, s * c * (s - 1), s * (s + c * c)],
            [s * c, s * s * s + c * c, s * c * (s - 1)],
            [-s, s * c, c * c],
        ]
    else:
        raise ValueError(f"Unsupported dimension: {dim}")
    # round through float32 like the JAX package's jnp.array(dtype=f32)
    return torch.tensor(rows, dtype=torch.float32).to(dtype)


_ROTATIONS: dict = {}


def _device_rotation(angle_deg: float, dim: int, dtype, device):
    """:func:`rotation_matrix` on ``device``, made once per key: a copy
    from the host in every forward would synchronise the stream, which a
    CUDA graph's capture refuses. Under ``torch.export`` the matrix is made
    anew and becomes a constant of the program (a tensor made while
    tracing is a fake one, which the cache must not keep)."""
    if torch.compiler.is_exporting():
        return rotation_matrix(angle_deg, dim, dtype).to(device)
    key = (angle_deg, dim, dtype, torch.device(device))
    R = _ROTATIONS.get(key)
    if R is None:
        R = _ROTATIONS.setdefault(
            key, rotation_matrix(angle_deg, dim, dtype).to(device))
    return R


def pad_pow2(x: torch.Tensor, pos: torch.Tensor):
    """Pad the points axis (axis 1) to the next power of two by duplicating
    real points (``idx = [0..n) ++ [0..pad) % n``).

    Returns ``(x_pad, pos_pad, mask)`` with ``mask: [B, N_pad]`` False on
    the duplicates.
    """
    B, n = x.shape[0], x.shape[1]
    n_pad = 1 << max(0, math.ceil(math.log2(max(n, 1))))
    mask = (torch.arange(n_pad, device=x.device) < n).expand(B, n_pad)
    if n_pad == n:
        return x, pos, mask
    idx = torch.arange(n_pad, device=x.device) % n
    return x.index_select(1, idx), pos.index_select(1, idx), mask


def effective_ball_size(ball_size: int, n: int) -> int:
    """The largest power of two <= min(ball_size, n): the ball a level
    attends over. Shared by BallMSA, BasicLayer's rotation skip and
    :func:`build_erwin_perms`, which must agree."""
    return 1 << (min(ball_size, n).bit_length() - 1)


def invert_perm(perm: torch.Tensor) -> torch.Tensor:
    """Inverse of a batched permutation: ``inv[b, perm[b, i]] = i``."""
    return torch.sort(perm, dim=-1, stable=True).indices


@dataclass
class ErwinPerms:
    """Permutations of one Erwin forward.

    ``perm: [B, N]`` tree slot -> point; ``unperm: [B, N]`` tree order
    back to input order (mask-aware); ``rot_perms``/``rot_inv_perms`` per
    level, ``None`` where rotation is off or the level is one full ball.
    """

    perm: torch.Tensor
    unperm: torch.Tensor
    rot_perms: list = field(default_factory=list)
    rot_inv_perms: list = field(default_factory=list)


@without_grad
def build_erwin_perms(pos: torch.Tensor, *, ball_sizes: tuple,
                      strides: tuple, rotate_angle: float = 45.0,
                      grouping: str = "median",
                      mask: Optional[torch.Tensor] = None) -> ErwinPerms:
    """All permutations an Erwin forward needs (``haet_tpu`` ``:238-327``,
    reference ``build_balltree_with_rotations``, ``balltree.pyx:598-662``).

    The rotated per-level targets come from the flat leaf count ``B*N``
    (``balltree.pyx:643``), and a level whose ball covers it whole builds no
    rotation perm (full-ball attention is permutation-equivariant).
    """
    if grouping not in GROUPERS:
        raise ValueError(f"unknown grouping {grouping!r}")
    grouper = GROUPERS[grouping]
    pos = pos.detach()
    B, N, D = pos.shape
    full_levels = max(int(math.log2(N)) - 1, 0)
    perm = grouper(pos, full_levels)

    if mask is None:
        unperm = invert_perm(perm)
    else:
        # Masked slots sort last, so unperm lists the real points in input
        # order first and the caller trims the duplicates off the end.
        mask_t = torch.gather(mask, 1, perm)
        key = torch.where(mask_t, perm, torch.full_like(perm, N + 1))
        unperm = torch.sort(key, dim=-1, stable=True).indices

    num_layers = len(ball_sizes)
    rot_perms: list = []
    rot_inv_perms: list = []
    if rotate_angle <= 0:
        rot_perms = [None] * num_layers
        rot_inv_perms = [None] * num_layers
    else:
        R = _device_rotation(rotate_angle, D, pos.dtype, pos.device)
        leaves = _take_points(pos, perm) @ R
        total0 = B * N
        targets = [max(0, int(math.log2(total0 / bs))) for bs in ball_sizes]
        n_level = N
        for i in range(num_layers):
            bs_eff = effective_ball_size(ball_sizes[i], n_level)
            if bs_eff >= n_level:
                rot_perms.append(None)
                rot_inv_perms.append(None)
            else:
                t = min(targets[i], int(math.log2(max(n_level, 1))))
                rp = grouper(leaves, t)
                rot_perms.append(rp)
                rot_inv_perms.append(invert_perm(rp))
            if i < num_layers - 1:
                s = strides[i]
                leaves = leaves.reshape(B, n_level // s, s, D).mean(dim=2)
                n_level //= s

    return ErwinPerms(perm=perm, unperm=unperm, rot_perms=rot_perms,
                      rot_inv_perms=rot_inv_perms)
