"""Adam + OneCycle + clipping, and one training step.

Counterpart of ``haet_tpu/train/trainer.py``: its OneCycle schedule is a
closed form of torch's ``OneCycleLR`` (``:52-113``), with Adam's beta1
cycled (``cycle_momentum``) and torch's ``clip_grad_norm_`` copied
(``:146-163``), so here the originals are used: ``torch.optim.Adam``,
``OneCycleLR`` and ``clip_grad_norm_``. The JAX horizon stretch for tiny
runs is kept (:func:`onecycle_horizon`).

``sigma_att`` gets no gradient (the distance bias is gradient-free), so
Adam skips it, as torch does in the reference; the JAX side moves it by
exactly zero with its zero gradient.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from ..utils.config import TrainConfig


def onecycle_horizon(cfg: TrainConfig, total_steps: int) -> int:
    """The OneCycle horizon (``haet_tpu/train/trainer.py:91-113``): torch's
    first phase ends at ``pct_start * T - 1``, so a horizon with
    ``pct_start * T <= 1`` is stretched to the smallest T past it, with a
    warning (the run then ends mid-decay at an elevated LR)."""
    p = float(cfg.pct_start)
    if not 0.0 < p < 1.0:
        raise ValueError(f"pct_start must be in (0, 1), got {p}")
    if p * total_steps > 1.0:
        return total_steps
    stretched = math.floor(1.0 / p) + 1
    while p * stretched <= 1.0:  # float rounding at e.g. p = 0.5
        stretched += 1
    warnings.warn(
        f"onecycle horizon stretched from {total_steps} to {stretched} "
        f"steps (pct_start={p} needs pct_start*total_steps > 1): the run "
        "will end mid-decay at an elevated LR. Use more steps or a larger "
        "pct_start if this is a real training run.", stacklevel=3)
    return stretched


def make_optimizer(cfg: TrainConfig, total_steps: int, params):
    """``(Adam, OneCycleLR)`` over ``params`` for ``total_steps`` optimizer
    steps (``haet_tpu/train/trainer.py:186-244``): beta1 cycles between
    ``max_momentum`` and ``base_momentum`` when ``cycle_momentum``. Call the
    scheduler's ``step()`` after each optimizer step."""
    cfg.check_ported()
    optimizer = torch.optim.Adam(params, lr=cfg.lr)
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=cfg.lr,
        total_steps=onecycle_horizon(cfg, total_steps),
        pct_start=cfg.pct_start, anneal_strategy="cos",
        cycle_momentum=cfg.cycle_momentum,
        base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
        div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
    return optimizer, scheduler


class Trainer:
    """One optimizer step at a time on a model that already lies on its
    device.

    Args:
        model: an ``nn.Module`` called as ``model(*batch_args(batch))``.
        loss_fn: ``loss_fn(out, batch) -> (loss, {name: tensor})``.
        cfg: the :class:`TrainConfig` (see :meth:`TrainConfig.check_ported`).
        total_steps: the schedule's horizon in optimizer steps.
        batch_args: ``batch -> tuple`` of the model's inputs.

    Batches are dicts of numpy arrays or tensors; they are moved to the
    model's device.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 cfg: TrainConfig, total_steps: int,
                 batch_args: Callable = lambda b: (b["x"], b["fx"])):
        self.model = model
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.batch_args = batch_args
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = make_optimizer(cfg, total_steps,
                                                        self.params)
        self.device = self.params[0].device

    def _on_device(self, batch: dict) -> dict:
        return {k: None if v is None else torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, batch: dict) -> dict:
        """Forward in train mode, loss, backward, clip, Adam, OneCycle.

        Returns ``{"loss", "grad_norm" (before clipping), **aux}`` as 0-d
        tensors (``haet_tpu/train/trainer.py:569``). The clipped gradients
        stay on the parameters until the next step.
        """
        batch = self._on_device(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = self.loss_fn(self.model(*self.batch_args(batch)), batch)
        loss.backward()
        if self.cfg.max_grad_norm is not None:
            grad_norm = torch.nn.utils.clip_grad_norm_(
                self.params, self.cfg.max_grad_norm)
        else:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad) for p in self.params
                 if p.grad is not None]))
        self.optimizer.step()
        self.scheduler.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    @torch.inference_mode()
    def predict(self, batch: dict):
        """The model's output on ``batch`` in eval mode."""
        self.model.eval()
        return self.model(*self.batch_args(self._on_device(batch)))

