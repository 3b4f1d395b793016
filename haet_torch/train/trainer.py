"""Adam + OneCycle + clipping, the training step and the training loop.

Counterpart of ``haet_tpu/train/trainer.py``: its OneCycle schedule is a
closed form of torch's ``OneCycleLR`` (``:52-113``), with Adam's beta1
cycled (``cycle_momentum``) and torch's ``clip_grad_norm_`` copied
(``:146-163``), so here the originals are used: ``torch.optim.Adam``,
``OneCycleLR`` and ``clip_grad_norm_``. The JAX horizon stretch for tiny
runs is kept (:func:`onecycle_horizon`). :meth:`Trainer.fit` is the JAX
``fit`` (``:736-1013``): epochs, eval, the metrics logger, early stopping,
checkpoints with resume, the divergence guard and the save on SIGTERM.

``sigma_att`` gets no gradient (the distance bias is gradient-free), so
Adam skips it, as torch does in the reference; the JAX side moves it by
exactly zero with its zero gradient.
"""

from __future__ import annotations

import json
import math
import os
import time
import warnings
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..utils.config import TrainConfig
from ..utils.profiling import StepTimer, device_memory_mb, host_rss_mb


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




class EarlyStopping:
    """Patience-based early stopping (reference ``train.py:21-46``)."""

    def __init__(self, patience: int = 7, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best: float | None = None
        self.counter = 0
        self.should_stop = False

    def update(self, val_loss: float) -> bool:
        if self.best is None or val_loss < self.best - self.min_delta:
            self.best = val_loss
            self.counter = 0
        else:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        return self.should_stop


class MetricsLogger:
    """JSON-lines metrics log with the reference's key names
    (``train.py:109-137``), echoed to stdout when ``echo``. Close it, or use
    it as a context manager, to release the file."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def log(self, metrics: dict):
        rec = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()}
        rec["_time"] = time.time()
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            print(" ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items() if k != "_time"), flush=True)

    def close(self):
        """Flush and release the JSONL handle; idempotent."""
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _means(metrics: list) -> dict:
    """Per-key means of a list of ``{name: 0-d tensor}``, fetched from the
    device in one transfer and averaged in float64 on the host (the JAX
    loop's ``np.mean`` of the fetched floats)."""
    if not metrics:
        return {}
    keys = list(metrics[0])
    vals = torch.stack([torch.stack([m[k].detach().float() for k in keys])
                        for m in metrics]).cpu().double().numpy()
    return {k: float(np.mean(vals[:, j])) for j, k in enumerate(keys)}


class Trainer:
    """The training engine on a model that already lies on its device.

    Args:
        model: an ``nn.Module`` called as ``model(*batch_args(batch))``.
        loss_fn: ``loss_fn(out, batch) -> (loss, {name: tensor})``.
        cfg: the :class:`TrainConfig` (see :meth:`TrainConfig.check_ported`).
        total_steps: the schedule's horizon in optimizer steps.
        batch_args: ``batch -> tuple`` of the model's inputs.
        eval_fn: ``(out, batch) -> {name: tensor}`` for :meth:`eval_step`;
            None evaluates ``loss_fn``.
        batch_log_every: log per-batch metrics every K batches (0: never).
        watch_every: log per-parameter gradient norms on one batch every K
            epochs (0: never).

    Batches are dicts of numpy arrays or tensors; they are moved to the
    model's device. The trainer owns the training state: the model, Adam,
    OneCycleLR and :attr:`step` (:meth:`state_dict`).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 cfg: TrainConfig, total_steps: int,
                 batch_args: Callable = lambda b: (b["x"], b["fx"]),
                 eval_fn: Optional[Callable] = None,
                 batch_log_every: int = 0, watch_every: int = 0):
        self.model = model
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.total_steps = total_steps
        self.batch_args = batch_args
        self.eval_fn = eval_fn
        self.batch_log_every = batch_log_every
        self.watch_every = watch_every
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = make_optimizer(cfg, total_steps,
                                                        self.params)
        self.device = self.params[0].device
        self.step = 0
        self._resume_epoch = None

    def _on_device(self, batch: dict) -> dict:
        return {k: None if v is None else torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # -- state ------------------------------------------------------------
    def state_dict(self) -> dict:
        """The training state: the model's ``state_dict`` (BatchNorm
        running statistics and ``num_batches_tracked`` included), Adam's,
        OneCycleLR's (its ``last_epoch``; the cycled beta1 sits in Adam's
        param groups) and the step."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def maybe_restore(self, checkpointer, which: str = "last") -> bool:
        """Resume from ``which`` if it exists (onto this trainer's device,
        wherever it was written). Re-arms the best-val watermark, so that
        the first eval after the restart cannot overwrite a better ``best``,
        and takes the epoch to resume after from the checkpoint's sidecar.
        Returns whether a checkpoint was restored."""
        checkpointer.rearm_best()
        state = checkpointer.restore(which, map_location=self.device)
        if state is None:
            self._resume_epoch = None
            return False
        self.load_state_dict(state)
        self._resume_epoch = checkpointer.epoch_of(which, self.step)
        print(f"[Trainer] resumed from step {self.step}"
              + (f" (epoch {self._resume_epoch})"
                 if self._resume_epoch is not None else ""), flush=True)
        return True

    # -- steps ------------------------------------------------------------
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
        # Past the horizon torch's OneCycleLR raises; the JAX schedule
        # clamps the step to it (haet_tpu/train/trainer.py:66-70), so the
        # rate and beta1 stay at their values at total_steps, as here. A
        # run resumed after a preemption re-runs the interrupted epoch
        # and so takes that many steps more than the horizon.
        if self.scheduler.last_epoch < self.scheduler.total_steps:
            self.scheduler.step()
        self.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                **{k: v.detach() for k, v in aux.items()}}

    @torch.inference_mode()
    def eval_step(self, batch: dict) -> dict:
        """Eval-mode forward (BatchNorm reads its running statistics and
        leaves them as they are); ``eval_fn``'s metrics, or ``{"loss",
        **aux}`` of ``loss_fn``, as 0-d tensors."""
        batch = self._on_device(batch)
        self.model.eval()
        out = self.model(*self.batch_args(batch))
        if self.eval_fn is not None:
            return self.eval_fn(out, batch)
        loss, aux = self.loss_fn(out, batch)
        return {"loss": loss, **aux}

    @torch.inference_mode()
    def predict(self, batch: dict):
        """The model's output on ``batch`` in eval mode."""
        self.model.eval()
        return self.model(*self.batch_args(self._on_device(batch)))

    def grad_leaf_norms(self, batch: dict) -> dict:
        """``{parameter name: L2 norm of its gradient}`` of a train-mode
        forward and backward on ``batch``, the scalar summary of the
        reference's ``wandb.watch`` histograms (``train.py:192-208``). The
        probe changes no state: the BatchNorm buffers are put back and the
        gradients dropped, as the JAX probe is a pure function."""
        buffers = {k: v.clone() for k, v in self.model.named_buffers()}
        batch = self._on_device(batch)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss, _ = self.loss_fn(self.model(*self.batch_args(batch)), batch)
        loss.backward()
        names = [k for k, p in self.model.named_parameters()
                 if p.grad is not None]
        norms = torch.stack([torch.linalg.vector_norm(p.grad)
                             for p in self.model.parameters()
                             if p.grad is not None]).cpu().tolist()
        self.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for k, v in self.model.named_buffers():
                v.copy_(buffers[k])
        return dict(zip(names, norms))

    # -- the loop ---------------------------------------------------------
    def fit(self, train_batches: Callable[[], Iterable],
            eval_batches: Optional[Callable[[], Iterable]] = None, *,
            epochs: Optional[int] = None, logger=None, checkpointer=None,
            eval_every: int = 1, stop_event=None) -> list:
        """Train for ``epochs`` (default ``cfg.epochs``), calling
        ``train_batches()`` (and ``eval_batches()``) once per epoch.

        Returns the epoch records logged by this call. The epoch count
        continues from a restored checkpoint's sidecar, or from an earlier
        ``fit`` of this trainer.

        ``stop_event``: a :class:`threading.Event`; when set, the loop
        finishes the step in flight, saves ``last`` under the last
        COMPLETED epoch's number (a resume re-runs the interrupted epoch
        with the newer parameters, the step-indexed schedule continuing
        exactly) and returns. Checked once per batch. Without one,
        ``cfg.preempt_save`` (the default) arms the same stop on SIGTERM in
        a single-process run on the main thread: save first, then
        re-deliver the signal so that the process still dies of it. The
        previous handler is put back on every exit.
        """
        import signal
        import threading

        did_install = False
        prev_handler = None
        ev = None
        if stop_event is None and self.cfg.preempt_save:
            dist = torch.distributed
            if (dist.is_available() and dist.is_initialized()
                    and dist.get_world_size() > 1):
                print("[Trainer] preempt_save: multi-process run, leaving "
                      "SIGTERM alone (per-process stop points would "
                      "desynchronize the collectives); resume from the "
                      "per-epoch 'last' saves instead.", flush=True)
            elif threading.current_thread() is threading.main_thread():
                ev = threading.Event()

                def on_sigterm(signum, frame):
                    ev.set()
                    print("[Trainer] SIGTERM: finishing the in-flight "
                          "step, saving 'last', then exiting...", flush=True)

                prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
                did_install = True
                stop_event = ev
        try:
            return self._fit_loop(train_batches, eval_batches, epochs=epochs,
                                  logger=logger, checkpointer=checkpointer,
                                  eval_every=eval_every,
                                  stop_event=stop_event)
        finally:
            if did_install:
                # prev_handler is None when it was installed from C: fall
                # back to the default disposition
                signal.signal(signal.SIGTERM,
                              prev_handler if prev_handler is not None
                              else signal.SIG_DFL)
                if ev.is_set():
                    # save-then-die, also when the signal landed in the
                    # last epoch's tail and the loop ended normally
                    os.kill(os.getpid(), signal.SIGTERM)

    def _fit_loop(self, train_batches, eval_batches, *, epochs, logger,
                  checkpointer, eval_every, stop_event) -> list:
        epochs = epochs if epochs is not None else self.cfg.epochs
        logger = logger or MetricsLogger()
        stopper = (EarlyStopping(self.cfg.early_stop_patience,
                                 self.cfg.early_stop_min_delta)
                   if self.cfg.early_stop_patience else None)
        if self.step == 0:
            start_epoch = 0
        elif self._resume_epoch is not None:
            start_epoch = self._resume_epoch + 1
        else:
            # no sidecar entry: derive from the nominal steps per epoch
            start_epoch = self.step // max(
                1, self.total_steps // max(epochs, 1))
        records = []
        lr = self.optimizer.param_groups[0]["lr"]
        epoch = start_epoch
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            timer = StepTimer()
            train_metrics = []
            watch_batch = None
            interrupted = False
            for i, batch in enumerate(train_batches()):
                if stop_event is not None and stop_event.is_set():
                    # the flag, not the event, tells a real break from an
                    # event set during the epoch's last batch, whose
                    # epoch then runs its tail normally
                    interrupted = True
                    break
                if i == 0 and self.watch_every:
                    watch_batch = batch
                # the rate this step applies (OneCycleLR moves the group's
                # lr to the next step's in scheduler.step())
                lr = self.optimizer.param_groups[0]["lr"]
                with timer.step():
                    m = self.train_step(batch)
                train_metrics.append(m)
                if self.batch_log_every and i % self.batch_log_every == 0:
                    logger.log({
                        "batch/total_loss": float(m["loss"]),
                        "batch/learning_rate": lr,
                        "batch/memory_used_mb": host_rss_mb(),
                        "batch/batch_time": timer.times[-1],
                        "batch/eta_seconds": timer.times[-1] * max(
                            0, self.total_steps - self.step),
                    })
            if interrupted:
                if checkpointer is not None:
                    checkpointer.save_last(self.state_dict(), epoch - 1)
                logger.log({"epoch": epoch, "preempted": True,
                            "step": self.step})
                self._resume_epoch = epoch - 1
                return records
            if not train_metrics and epoch == start_epoch:
                print("[Trainer] WARNING: train_batches yielded no batches",
                      flush=True)
            tm = {f"train/{k}": v for k, v in _means(train_metrics).items()}
            tm.update(timer.metrics("train/"))
            tm["train/learning_rate"] = lr
            tm["train/memory_used_mb"] = host_rss_mb()
            dev_mb = device_memory_mb(self.device)
            if dev_mb is not None:
                tm["train/device_memory_mb"] = dev_mb
            rec = {"epoch": epoch, **tm,
                   "epoch/time_seconds": time.time() - t0}
            train_loss = tm.get("train/loss")
            if (self.cfg.stop_on_nonfinite and train_loss is not None
                    and not np.isfinite(train_loss)):
                logger.log({**rec, "non_finite_loss": True})
                if checkpointer is not None:
                    checkpointer.save_diverged(self.state_dict(), epoch)
                raise FloatingPointError(
                    f"non-finite training loss ({train_loss}) at epoch "
                    f"{epoch}; state saved to 'diverged' for inspection "
                    "('last' still holds the previous epoch). Common "
                    "causes: lr too high, bad input normalization, a "
                    "corrupt batch. Set TrainConfig(stop_on_nonfinite="
                    "False) to keep running anyway.")
            if (self.watch_every and watch_batch is not None
                    and (epoch + 1) % self.watch_every == 0):
                rec.update({f"gradients/{k}": v for k, v in
                            self.grad_leaf_norms(watch_batch).items()})
            if eval_batches is not None and (epoch + 1) % eval_every == 0:
                em = {f"val/{k}": v for k, v in _means(
                    [self.eval_step(b) for b in eval_batches()]).items()}
                rec.update(em)
                val_loss = em.get("val/loss")
                if checkpointer is not None and val_loss is not None:
                    checkpointer.save_best(self.state_dict(), val_loss, epoch)
                if (stopper is not None and val_loss is not None
                        and stopper.update(val_loss)):
                    logger.log({**rec, "early_stop": True})
                    records.append(rec)
                    # the final epoch's state must still reach 'last'
                    if checkpointer is not None:
                        checkpointer.save_last(self.state_dict(), epoch)
                    break
            logger.log(rec)
            records.append(rec)
            if checkpointer is not None:
                checkpointer.save_last(self.state_dict(), epoch)
                if (self.cfg.checkpoint_every
                        and (epoch + 1) % self.cfg.checkpoint_every == 0):
                    checkpointer.save_periodic(self.state_dict(), epoch)
        # a later fit() continues after the epochs this one completed
        if epochs > start_epoch:
            self._resume_epoch = epoch
        return records
