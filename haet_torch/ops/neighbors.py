"""Capped-degree neighbour search, on the device.

Counterpart of ``haet_tpu/ops/neighbors.py``, the replacement for
``torch_cluster.radius_graph`` (the reference's ``erwin_flash.py:160-166``
and the ShapeNet-Car ``GraphDataset``'s ``r=0.2, max_neighbors=32``).
Instead of a ragged edge list every point carries ``K`` neighbour slots and
a validity mask, so the aggregation over them has static shapes.

* :func:`knn_edges_brute`: exact, from all ``N^2`` distances, for clouds of
  at most :data:`BRUTE_FORCE_MAX_N` points;
* :func:`knn_edges_grouped`: larger clouds, searched among the points of
  each point's ball and its two neighbouring balls, in the median-split
  order and in a second order of the positions rotated by 45 degrees;
  neighbours across distant ball boundaries may be missed, as in JAX;
* :func:`radius_edges`: kNN filtered to ``distance <= radius``.

Everything runs without autograd (JAX's ``stop_gradient``;
:func:`~haet_torch.utils.env.grad_off`).
Indices are int64, torch's index dtype (int32 in JAX). ``torch.topk``
makes no promise on ties where ``lax.top_k`` takes the lower index; a
masked slot holds the dtype's max distance, so which of them come out does
not matter (they are invalid), and the valid neighbours of a point are the
same set as JAX's wherever the distances are not tied.
"""

from __future__ import annotations

import math

import torch

from ..utils.env import without_grad
from .ball_groups import (_device_rotation, invert_perm, median_split_perm,
                          pad_pow2)

#: above this cloud size :func:`knn_edges` searches within balls
BRUTE_FORCE_MAX_N = 4096


def _gather_points(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b]]`` for ``a: [B, N, C]`` and ``idx: [B, M]``."""
    return torch.gather(a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))


def knn_edges(pos: torch.Tensor, k: int, *, mask=None,
              include_self: bool = True, ball: int = 128):
    """The ``k`` nearest neighbours of each point: exact for clouds of at
    most :data:`BRUTE_FORCE_MAX_N` points, within balls above."""
    if pos.shape[1] > BRUTE_FORCE_MAX_N:
        return knn_edges_grouped(pos, k, mask=mask,
                                 include_self=include_self, ball=ball)
    return knn_edges_brute(pos, k, mask=mask, include_self=include_self)


@without_grad
def knn_edges_brute(pos: torch.Tensor, k: int, *, mask=None,
                    include_self: bool = True):
    """Exact kNN of ``pos: [B, N, D]``: ``(idx, valid)``, each ``[B, N,
    min(k, N)]``. ``mask [B, N]``: invalid points neither send nor receive
    edges; ``include_self`` keeps the self edge (the reference's
    ``loop=True``)."""
    B, N, _ = pos.shape
    k = min(k, N)
    d2 = ((pos[:, :, None, :] - pos[:, None, :, :]) ** 2).sum(-1)
    big = torch.finfo(d2.dtype).max
    if not include_self:
        eye = torch.eye(N, dtype=torch.bool, device=pos.device)[None]
        d2 = d2.masked_fill(eye, big)
    if mask is not None:
        d2 = d2.masked_fill(~mask[:, None, :], big)
    neg, idx = torch.topk(-d2, k, dim=-1)
    valid = neg > -big
    if mask is not None:
        valid = valid & mask[:, :, None]
    return idx, valid


def _ball_windows(pos_p, pmask, perm, ball: int):
    """Each point's candidates in ``perm``'s ball order: the points of its
    ball and of the balls before and after it, ``w = 3 * ball`` slots as
    ``(positions [B, Np, w, D], indices [B, Np, w], valid [B, Np, w])``
    in the original point order (the fill of the first ball's previous and
    the last ball's next window is invalid)."""
    B, Np, D = pos_p.shape
    nb = Np // ball
    w = 3 * ball

    def window(a, fill):
        edge = torch.full_like(a[:, :1], fill)
        return torch.cat([torch.cat([edge, a[:, :-1]], 1), a,
                          torch.cat([a[:, 1:], edge], 1)], dim=2)

    cpos = window(_gather_points(pos_p, perm).reshape(B, nb, ball, D), 0.0)
    cmask = window(torch.gather(pmask, 1, perm).reshape(B, nb, ball), False)
    cmask[:, 0, :ball] = False
    cmask[:, -1, 2 * ball:] = False
    cidx = window(perm.reshape(B, nb, ball), 0)
    inv = invert_perm(perm)

    def unperm(a):
        # per ball -> per point of it, in tree order; then original order
        tail = a.shape[3:]
        flat = a[:, :, None].expand(B, nb, ball, w, *tail).reshape(
            B, Np, w, *tail)
        idx = inv.reshape(B, Np, *([1] * (flat.ndim - 2))).expand(
            B, Np, w, *tail)
        return torch.gather(flat, 1, idx)

    return unperm(cpos), unperm(cidx), unperm(cmask)


@without_grad
def knn_edges_grouped(pos: torch.Tensor, k: int, *, mask=None,
                      include_self: bool = True, ball: int = 128):
    """Approximate kNN of a large cloud through ball grouping
    (``haet_tpu/ops/neighbors.py:74-205``): the median-split order and the
    45-degree rotated one each give a point ``3 * ball`` candidates, a
    rotated candidate already among the valid main ones is dropped, and the
    ``k`` nearest of the rest are its neighbours. ``ball`` is rounded up to
    a power of two of at least ``k / 6`` (at most the padded cloud).

    JAX drops the duplicates by comparing every rotated candidate with
    every main one (``[B, Np, 3 ball, 3 ball]`` booleans, ~4.8e9 at 32768
    points and ball 128); here each rotated candidate is looked up in its
    point's sorted main candidates (``searchsorted``), the same edge set.
    """
    B, N, D = pos.shape
    k = min(k, N)
    pos_p, _, pmask = pad_pow2(pos, pos)
    Np = pos_p.shape[1]
    if mask is not None:
        pmask = pmask & torch.cat(
            [mask, mask.new_zeros(B, Np - mask.shape[1])], dim=1)
    ball = 1 << max(0, (max(ball, -(-k // 6)) - 1)).bit_length()
    ball = min(ball, Np)
    k = min(k, 6 * ball)  # only binding when the ball hit the Np cap
    levels = max(0, int(math.log2(Np)) - int(math.log2(ball)))

    cp1, ci1, cm1 = _ball_windows(pos_p, pmask,
                                  median_split_perm(pos_p, levels), ball)
    R = _device_rotation(45.0, D, pos_p.dtype, pos_p.device)
    cp2, ci2, cm2 = _ball_windows(pos_p, pmask,
                                  median_split_perm(pos_p @ R, levels), ball)
    # a main window's fill slots hold index 0: compare against the valid
    # main candidates only
    main = torch.where(cm1, ci1, torch.full_like(ci1, -1)).sort(-1).values
    at = torch.searchsorted(main, ci2.contiguous()).clamp_max(
        main.shape[-1] - 1)
    cm2 = cm2 & (torch.gather(main, -1, at) != ci2)

    cand_pos = torch.cat([cp1, cp2], dim=2)        # [B, Np, 6 ball, D]
    cand_idx = torch.cat([ci1, ci2], dim=2)
    cand_mask = torch.cat([cm1, cm2], dim=2)
    d2 = ((cand_pos - pos_p[:, :, None, :]) ** 2).sum(-1)
    big = torch.finfo(d2.dtype).max
    d2 = d2.masked_fill(~cand_mask, big)
    if not include_self:
        self_idx = torch.arange(Np, device=pos.device)[None, :, None]
        d2 = d2.masked_fill(cand_idx == self_idx, big)
    neg, ci = torch.topk(-d2, k, dim=-1)
    valid = (neg > -big)[:, :N]
    idx = torch.gather(cand_idx, -1, ci)[:, :N]
    if mask is not None:
        valid = valid & mask[:, :, None]
    # an invalid slot may hold a pad index >= N: clamp, so that gathers
    # stay in bounds (it is masked out anyway)
    return idx.clamp_max(N - 1), valid


@without_grad
def radius_edges(pos: torch.Tensor, radius: float, k: int, *, mask=None,
                 include_self: bool = True):
    """The radius graph capped at ``k`` neighbours: :func:`knn_edges`
    filtered to ``distance <= radius``."""
    idx, valid = knn_edges(pos, k, mask=mask, include_self=include_self)
    B, N, D = pos.shape
    K = idx.shape[-1]
    nbr = _gather_points(pos, idx.reshape(B, N * K)).reshape(B, N, K, D)
    d2 = ((nbr - pos[:, :, None, :]) ** 2).sum(-1)
    return idx, valid & (d2 <= radius * radius)
