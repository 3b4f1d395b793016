"""Dropout as flax's ``nn.Dropout``, drawing from an explicit generator.

The JAX models apply dropout once per block, after physics attention's
``to_out`` (``haet_tpu/models/physics_attention.py:415``), with the rng the
trainer splits per step. Here the masks come from a ``torch.Generator`` that
the model owns, on the model's device (:attr:`Dropout.generator`, set by the
model), never from torch's global generator: a seed fixes the masks on a
device, and a CUDA graph that registers the generator
(:mod:`haet_torch.train.graphs`) draws fresh masks on every replay, as an
eager step would. The two frameworks' generators give different bits, so
the parity tests feed JAX's masks through :attr:`Dropout.feed`.

Under ``use_checkpoint`` a block runs its forward a second time in the
backward; :func:`checkpoint_contexts` makes that recompute reuse the masks
of the forward and leaves the BatchNorm statistics alone, as JAX's
``nn.remat`` recomputes a pure function.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn


class Dropout(nn.Module):
    """``flax.linen.Dropout(rate)``: in train mode each element is kept
    with probability ``1 - rate`` (a uniform draw below it) and scaled by
    ``1 / (1 - rate)``; a rate of 1 gives zeros; eval mode is the identity.

    Attributes set by the owner, not state: ``generator`` (the model's
    generator, required to draw), ``feed`` (a list of boolean keep masks,
    taken in order instead of drawing: a test hook), ``record`` and
    ``replay`` (:func:`checkpoint_contexts`)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None
        self.feed = None
        self.record = None
        self.replay = None

    def extra_repr(self) -> str:
        return f"rate={self.rate}"

    def forward(self, x, part=None):
        """``part``: ``(global shape, index)`` when ``x`` is a rank's part of
        a tensor (:meth:`haet_torch.parallel.Layout.dropout_part`): the
        mask is drawn (or fed) for the whole tensor and indexed, so the
        rank keeps the elements the single-device mask gives it."""
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep_prob = 1.0 - self.rate
        if self.replay is not None:
            keep = next(self.replay)
        else:
            if self.feed:
                keep = self.feed.pop(0).to(x.device)
            else:
                if self.generator is None:
                    raise RuntimeError("Dropout in train mode needs the "
                                       "model's generator "
                                       "(Dropout.generator)")
                shape = x.shape if part is None else part[0]
                keep = torch.rand(shape, generator=self.generator,
                                  device=x.device) < keep_prob
            if part is not None:
                keep = keep[part[1]]
        if self.record is not None:
            self.record.append(keep)
        return torch.where(keep, x / keep_prob, 0.0)


def checkpoint_contexts(module: nn.Module):
    """``(forward, recompute)`` context managers for
    ``torch.utils.checkpoint``'s ``context_fn`` over ``module``: the
    forward records each :class:`Dropout`'s masks, the recompute replays
    them and runs every BatchNorm of ``module`` without updating its
    running statistics (its ``recomputing`` flag)."""
    from ..erwin import FlaxBatchNorm1d

    drops = [m for m in module.modules() if isinstance(m, Dropout)]
    norms = [m for m in module.modules() if isinstance(m, FlaxBatchNorm1d)]
    masks = [[] for _ in drops]

    @contextlib.contextmanager
    def forward():
        for d, rec in zip(drops, masks):
            d.record = rec
        try:
            yield
        finally:
            for d in drops:
                d.record = None

    @contextlib.contextmanager
    def recompute():
        for d, rec in zip(drops, masks):
            d.replay = iter(rec)
        for n in norms:
            n.recomputing = True
        try:
            yield
        finally:
            for d in drops:
                d.replay = None
            for n in norms:
                n.recomputing = False

    return forward(), recompute()
