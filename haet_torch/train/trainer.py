"""Adam + OneCycle + clipping, the training step and the training loop.

Counterpart of ``haet_tpu/train/trainer.py``: its OneCycle schedule is a
closed form of torch's ``OneCycleLR`` (``:52-113``), with Adam's beta1
cycled (``cycle_momentum``) and torch's ``clip_grad_norm_`` copied
(``:146-163``), so here the originals are used: ``torch.optim.Adam``,
``OneCycleLR`` and ``clip_grad_norm_``. The JAX horizon stretch for tiny
runs is kept (:func:`onecycle_horizon`). :meth:`Trainer.fit` is the JAX
``fit`` (``:736-1013``): epochs, eval, the metrics logger, early stopping,
checkpoints with resume, the divergence guard and the save on SIGTERM.
On a CUDA device each step is a replay of a CUDA graph
(:mod:`haet_torch.train.graphs`), the counterpart of the JAX trainer's
jitted step, and :meth:`Trainer.train_steps` runs K steps as one graph, as
its ``lax.scan`` does; Adam (:class:`Adam`) therefore reads the learning
rate and beta1 from a device tensor.

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


#: the param-group entries a checkpoint sets: the schedule's, not torch
#: Adam's flags (``capturable``, ``foreach``)
SCHEDULE_KEYS = ("lr", "betas", "initial_lr", "max_lr", "min_lr",
                 "max_momentum", "base_momentum")


class Adam(torch.optim.Adam):
    """Adam with each group's learning rate and beta1 read from a tensor on
    the parameters' device, so that a captured step reads the values of
    the step it replays.

    ``hparams`` ``[groups, 2]`` float32 holds ``(lr, beta1)`` per group.
    The param groups keep the Python floats that torch's ``OneCycleLR``
    writes: with ``cycle_momentum`` it rebinds ``group["betas"]`` to a new
    tuple of floats at every step, and a captured Adam handed those floats
    would keep, for ever, the beta1 it saw at capture. So the scheduler is
    torch's own, and this optimizer is the wrapper: outside a capture
    :meth:`step` first writes the groups' floats into ``hparams``; inside
    one the caller has written them (``haet_torch.train.graphs`` copies each
    step's own row).

    The update is torch's Adam (``eps`` 1e-8, beta2 0.999, no weight decay,
    the bias corrections of the current beta1 and beta2, in float64, as
    torch's Adam takes them) in multi-tensor ops whose scalars are device
    tensors, with ``m = b1 m + (1 - b1) g`` as optax writes it. torch's own
    step cannot be captured with a Tensor beta1 (torch 2.11's
    ``_foreach_lerp_`` reads a Tensor weight back to the host). The
    parameters of a group step together (the step counts of those with a
    gradient are equal), so one bias correction serves the group, as one
    multi-tensor launch per op needs. The state of every parameter is
    allocated here, once, in torch Adam's format, and
    :meth:`load_state_dict` copies into it: a captured step keeps writing
    into the same storage for the optimizer's life.
    """

    def __init__(self, params, lr: float):
        super().__init__(params, lr=lr)
        device = self.param_groups[0]["params"][0].device
        self.hparams = torch.zeros((len(self.param_groups), 2),
                                   dtype=torch.float32, device=device)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=p.device),
                    "exp_avg": torch.zeros_like(
                        p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}

    @torch.no_grad()
    def write_hparams(self) -> None:
        """The groups' current ``(lr, beta1)`` into :attr:`hparams` (two
        fills per group on the device: no synchronisation)."""
        for row, group in zip(self.hparams, self.param_groups):
            row[0].fill_(group["lr"])
            row[1].fill_(group["betas"][0])

    def host_hparams(self) -> list:
        """``[[lr, beta1] per group]``: the floats of the next step."""
        return [[g["lr"], g["betas"][0]] for g in self.param_groups]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("this Adam takes no closure")
        if not (self.hparams.is_cuda
                and torch.cuda.is_current_stream_capturing()):
            self.write_hparams()
        for row, group in zip(self.hparams, self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(params, row[0], row[1], group["betas"][1],
                             group["eps"])

    def _update(self, params, lr, beta1, beta2: float, eps: float) -> None:
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        m = [st["exp_avg"] for st in states]
        v = [st["exp_avg_sq"] for st in states]
        steps = [st["step"] for st in states]
        torch._foreach_add_(steps, 1.0)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1 - beta1))
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - beta2)
        # p += m / denom, denom = (sqrt(v) / sqrt(1 - b2^t) + eps) / step,
        # step = -lr / (1 - b1^t), the corrections in float64 as torch's
        # Adam takes them (1 - 0.999 loses 1e-5 of itself in float32)
        t = steps[0].double()
        denom = torch._foreach_sqrt(v)
        torch._foreach_mul_(denom, (1 - beta2 ** t).rsqrt().float())
        torch._foreach_add_(denom, eps)
        torch._foreach_mul_(denom, ((1 - beta1.double() ** t)
                                    / -lr.double()).float())
        torch._foreach_addcdiv_(params, m, denom)

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict) -> None:
        """Load a state in torch Adam's format (this class's, or
        ``torch.optim.Adam``'s, from any device) in place: each state tensor
        keeps its storage (a state the file lacks, as for a parameter that
        never had a gradient, is set to zero), and of the saved groups only
        :data:`SCHEDULE_KEYS` are taken. Raises where the parameters that
        stepped did not step together."""
        saved_groups = state_dict["param_groups"]
        if [len(g["params"]) for g in saved_groups] != [
                len(g["params"]) for g in self.param_groups]:
            raise ValueError("the checkpoint's Adam groups do not match "
                             "this optimizer's parameters")
        params = [p for g in self.param_groups for p in g["params"]]
        saved = state_dict["state"]
        if len({float(st["step"]) for st in saved.values()} - {0.0}) > 1:
            raise ValueError("the checkpoint's parameters did not step "
                             "together: this Adam keeps one step count")
        for i, p in enumerate(params):
            got = saved.get(i, {})
            for k, t in self.state[p].items():
                if k in got:
                    t.copy_(torch.as_tensor(got[k]))
                else:
                    t.zero_()
        for group, sg in zip(self.param_groups, saved_groups):
            for k in SCHEDULE_KEYS:
                if k in sg:
                    group[k] = (tuple(float(b) for b in sg[k])
                                if k == "betas" else float(sg[k]))


def make_optimizer(cfg: TrainConfig, total_steps: int, params):
    """``(Adam, OneCycleLR)`` over ``params`` for ``total_steps`` optimizer
    steps (``haet_tpu/train/trainer.py:186-244``): beta1 cycles between
    ``max_momentum`` and ``base_momentum`` when ``cycle_momentum``. Call the
    scheduler's ``step()`` after each optimizer step. The Adam is the port's
    :class:`Adam`, whose steps a CUDA graph can hold."""
    cfg.check_ported()
    params = list(params)
    optimizer = Adam(params, lr=cfg.lr)
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=cfg.lr,
        total_steps=onecycle_horizon(cfg, total_steps),
        pct_start=cfg.pct_start, anneal_strategy="cos",
        cycle_momentum=cfg.cycle_momentum,
        base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
        div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
    return optimizer, scheduler


def flat_views(params) -> torch.Tensor:
    """One buffer for the gradients of ``params`` (one dtype and device),
    each parameter's ``grad`` set to its view of it, in order."""
    dtypes = {(p.dtype, p.device) for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"the trained parameters mix dtypes or devices: "
                         f"{sorted(map(str, dtypes))}")
    flat = torch.empty(sum(p.numel() for p in params),
                       dtype=params[0].dtype, device=params[0].device)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


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
        eager: on a CUDA device, run each step op by op from Python instead
            of replaying its CUDA graph (the reference the graphs are held
            against, and the path :meth:`grad_leaf_norms` takes). On the
            CPU every step is eager.

    Batches are dicts of numpy arrays or tensors; they are moved to the
    model's device. The trainer owns the training state: the model, Adam,
    OneCycleLR and :attr:`step` (:meth:`state_dict`). Every tensor of it
    keeps its storage for the trainer's life, the gradients too (allocated
    by the first step; a parameter that gets none, ``sigma_att``, keeps
    ``grad`` None): on a CUDA device :meth:`train_step` replays a CUDA
    graph of the whole step (:class:`~haet_torch.train.graphs.StepGraphs`,
    the counterpart of ``jax.jit(self._step)``), which reads and writes
    that storage.
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 cfg: TrainConfig, total_steps: int,
                 batch_args: Callable = lambda b: (b["x"], b["fx"]),
                 eval_fn: Optional[Callable] = None,
                 batch_log_every: int = 0, watch_every: int = 0,
                 eager: bool = False):
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
        # the parameters that receive a gradient, found by the first step,
        # and the buffer their gradients are views of
        self._grad_params = None
        self._flat_grad = None
        self.graphs = None
        if not eager and self.device.type == "cuda":
            from .graphs import StepGraphs

            self.graphs = StepGraphs(self)

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
        """Restore :meth:`state_dict`'s state in place (the model's
        ``load_state_dict`` copies into its tensors,
        :meth:`Adam.load_state_dict` into its own), so that the captured
        graphs stay valid."""
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
        stay on the parameters until the next step. On a CUDA device, unless
        the trainer is ``eager``, the step is a replay of the batch
        signature's CUDA graph.
        """
        if self.graphs is not None:
            return {k: v[0] for k, v in self.graphs.run([batch]).items()}
        metrics = self.step_body(self._on_device(batch))
        self.advance_schedule()
        self.step += 1
        return metrics

    def train_steps(self, batches) -> dict:
        """Several optimizer steps, ``haet_tpu/train/trainer.py:697-733``:
        ``batches`` share one signature (keys, shapes and dtypes, as JAX
        stacks them). Returns each metric stacked ``[K]``. On a CUDA device,
        unless the trainer is ``eager``, the K steps are one CUDA graph; on
        the CPU they are K eager steps."""
        batches = list(batches)
        if not batches:
            raise ValueError("train_steps needs at least one batch")
        from .graphs import signature

        sig = signature(batches[0])
        if any(signature(b) != sig for b in batches[1:]):
            raise ValueError("train_steps takes batches of one signature "
                             "(keys, shapes and dtypes)")
        if self.graphs is not None:
            return self.graphs.run(batches)
        metrics = [self.train_step(b) for b in batches]
        return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}

    def advance_schedule(self) -> None:
        """OneCycleLR's step after an optimizer step. Past the horizon
        torch's OneCycleLR raises; the JAX schedule clamps the step to it
        (haet_tpu/train/trainer.py:66-70), so the rate and beta1 stay at
        their values at total_steps, as here. A run resumed after a
        preemption re-runs the interrupted epoch and so takes that many
        steps more than the horizon."""
        if self.scheduler.last_epoch < self.scheduler.total_steps:
            self.scheduler.step()

    def step_body(self, batch: dict) -> dict:
        """One step on a batch of tensors on the model's device: the
        forward in train mode, the loss, the gradients copied into the
        parameters' gradients, clipping and Adam (OneCycle is the caller's:
        :meth:`advance_schedule`). The op-by-op step, and the one that
        :class:`~haet_torch.train.graphs.StepGraphs` captures."""
        self.model.train()
        loss, aux = self.loss_fn(self.model(*self.batch_args(batch)), batch)
        if self._grad_params is None:
            grads = torch.autograd.grad(loss, self.params, allow_unused=True)
            self._grad_params = [p for p, g in zip(self.params, grads)
                                 if g is not None]
            grads = [g for g in grads if g is not None]
            self._flat_grad = flat_views(self._grad_params)
        else:
            grads = torch.autograd.grad(loss, self._grad_params)
        # into the gradients allocated by the first step, views of one
        # buffer: a concatenation is a few launches, where a copy per
        # parameter (or autograd's accumulation into existing gradients)
        # is one each
        torch.cat([g.reshape(-1) for g in grads], out=self._flat_grad)
        if self.cfg.max_grad_norm is not None:
            grad_norm = torch.nn.utils.clip_grad_norm_(
                self._grad_params, self.cfg.max_grad_norm)
        else:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
        self.optimizer.step()
        # detached: a live autograd graph would keep the parameters'
        # gradient accumulators, and the stream they were made on, into
        # the next step
        return {k: v.detach() for k, v in
                {"loss": loss, "grad_norm": grad_norm, **aux}.items()}

    def state_tensors(self) -> list:
        """Every tensor a step writes: the parameters, the model's buffers
        (BatchNorm statistics and counters) and Adam's state."""
        return [*self.model.parameters(), *self.model.buffers(),
                *(t for st in self.optimizer.state.values()
                  for t in st.values())]

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
        parameters' gradients are not touched, as the JAX probe is a pure
        function. It runs op by op, on a CUDA device too."""
        buffers = {k: v.clone() for k, v in self.model.named_buffers()}
        batch = self._on_device(batch)
        self.model.train()
        loss, _ = self.loss_fn(self.model(*self.batch_args(batch)), batch)
        named = [(k, p) for k, p in self.model.named_parameters()
                 if p.requires_grad]
        grads = torch.autograd.grad(loss, [p for _, p in named],
                                    allow_unused=True)
        names = [k for (k, _), g in zip(named, grads) if g is not None]
        norms = torch.stack([torch.linalg.vector_norm(g) for g in grads
                             if g is not None]).cpu().tolist()
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
