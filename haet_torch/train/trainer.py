"""Adam/AdamW + schedules + clipping, the training step and the loop.

Counterpart of ``haet_tpu/train/trainer.py``: its OneCycle schedule is a
closed form of torch's ``OneCycleLR`` (``:52-113``), with Adam's beta1
cycled (``cycle_momentum``) and torch's ``clip_grad_norm_`` copied
(``:146-163``), so here the originals are used: ``OneCycleLR`` and
``clip_grad_norm_``. The JAX horizon stretch for tiny runs is kept
(:func:`onecycle_horizon`). ``cosine_annealing`` (``t_max``, periodic, as
the reference steps it per batch) and ``constant`` are closed forms
(``:126-142``), each a ``LambdaLR``; beta1 is cycled under OneCycle only.
The optimizer is the port's :class:`Adam`, whose ``weight_decay`` makes it
optax's AdamW. ``accum_steps`` runs each step over that many microbatches:
their mean gradient, the BatchNorm statistics carried from one to the next,
then one clip and one update (``_accum_grads``, ``:572-614``).
:meth:`Trainer.fit` is the JAX ``fit`` (``:736-1013``): epochs, eval, the
metrics logger, early stopping, checkpoints with resume, the divergence
guard and the save on SIGTERM. On a CUDA device each step is a replay of a
CUDA graph (:mod:`haet_torch.train.graphs`), the counterpart of the JAX
trainer's jitted step, and :meth:`Trainer.train_steps` runs K steps as one
graph, as its ``lax.scan`` does; Adam therefore reads the learning rate
and beta1 from a device tensor.

``sigma_att`` gets no gradient (the distance bias is gradient-free), so
Adam skips it, as torch does in the reference, and AdamW does not decay it
(``weight_decay_mask``, ``:166-183``); the JAX side moves it by exactly
zero with its zero gradient.

``Trainer(mesh=...)`` (JAX ``:357, 381-440, 572-620, 663-720``) trains over
a :class:`~haet_torch.parallel.Mesh`, one process per rank, each rank
calling the trainer with the same global batches. The state is replicated:
rank 0's parameters, buffers and Adam state are broadcast at construction.
The model is bound to the mesh (:func:`~haet_torch.parallel.bind_mesh`),
so each forward runs the rank's part of the batch and returns the global
output, and the loss is the global batch's on every rank. After the
backward the flat gradient buffer is summed over the mesh
(:func:`~haet_torch.parallel.reduce_gradients`: the head-sharded
parameters' parts over tp, then the whole over dp and cp), before
clipping. Only rank 0 writes checkpoints and logs (:class:`Checkpointer`
and :class:`MetricsLogger` see to it); every rank restores. On the card the collectives of a
step are captured in its CUDA graph, which NCCL allows and gloo does not:
a gloo mesh on the card needs ``eager=True``.

A model that is (or holds) a :class:`~haet_torch.parallel.pipeline.
PipelinedModel` trains over the pipeline's mesh with no other change to
the caller (JAX ``pipeline.py:69-72``): each rank holds the embedding and
the head, but only its stage's stacked layers and their Adam moments
(``state_sharding``, ``:381-400``); the pipeline sums the gradients
(:meth:`~haet_torch.parallel.pipeline.PipelinedModel.reduce_gradients`).
Checkpoints hold the stacked layout with every stage's layers: each rank's
stacks are gathered over pp when the state is taken (every rank calls
:meth:`state_dict`, rank 0 writes), and each rank keeps its stage's on
restore. A checkpoint of the other layout raises JAX's message
(``:466-496``).
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

from .. import parallel
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
    """Adam, or AdamW with ``weight_decay``, with each group's learning
    rate and beta1 read from a tensor on the parameters' device, so that a
    captured step reads the values of the step it replays.

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

    ``weight_decay`` > 0 is ``optax.adamw``'s decoupled decay, masked as
    the JAX trainer masks it: each step first scales every parameter of a
    group but those in ``no_decay`` by ``1 - lr * weight_decay``, then
    takes the Adam step (optax adds ``weight_decay * p`` to the Adam
    direction before the rate scales both: the same update, rounded once
    more). A parameter without a gradient (the 2D/3D models' placeholder
    when ``fx`` is given) is decayed all the same, as optax decays it with
    its zero gradient; ``sigma_att``, in ``no_decay``, is left alone.

    ``mu_dtype=torch.bfloat16`` is optax's ``adam(mu_dtype=bfloat16)``
    (``TrainConfig.mu_bf16``): the first moment is stored in bf16, and each
    step computes it in float32 from the stored value and the float32
    gradient, takes the update from that float32 value and rounds only the
    stored copy (to nearest even); the second moment stays float32. The
    group's bf16 moments are views of one buffer, so the step widens,
    updates and rounds them in a few whole-buffer launches. A parameter
    without a gradient counts as a zero gradient there (its moment decays
    by beta1, as under optax, where every parameter has a gradient; the
    port's ``sigma_att``, the only such parameter, keeps a zero moment).
    """

    def __init__(self, params, lr: float, mu_dtype=None,
                 weight_decay: float = 0.0, no_decay=()):
        super().__init__(params, lr=lr)
        device = self.param_groups[0]["params"][0].device
        self.weight_decay = weight_decay
        skip = {id(p) for p in no_decay}
        #: per group, the parameters AdamW decays
        self._decayed = [[p for p in g["params"] if id(p) not in skip]
                         for g in self.param_groups]
        self.hparams = torch.zeros((len(self.param_groups), 2),
                                   dtype=torch.float32, device=device)
        self.mu_dtype = mu_dtype
        #: per group, the buffer of its bf16 first moments (``mu_dtype``)
        self._mu = []
        for group in self.param_groups:
            ps = group["params"]
            if mu_dtype is not None:
                flat = torch.zeros(sum(p.numel() for p in ps), dtype=mu_dtype,
                                   device=device)
                self._mu.append(flat)
                mus = [t.view_as(p) for t, p in
                       zip(flat.split([p.numel() for p in ps]), ps)]
            else:
                mus = [torch.zeros_like(p, memory_format=torch.preserve_format)
                       for p in ps]
            for p, mu in zip(ps, mus):
                self.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32,
                                        device=p.device),
                    "exp_avg": mu,
                    "exp_avg_sq": torch.zeros_like(
                        p, memory_format=torch.preserve_format)}
        # zeros standing in for a missing gradient (views: no launch)
        self._zero = (torch.zeros(max(p.numel() for g in self.param_groups
                                      for p in g["params"]), device=device)
                      if mu_dtype is not None else None)

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
        for i, (row, group) in enumerate(zip(self.hparams,
                                             self.param_groups)):
            if self.weight_decay and self._decayed[i]:
                torch._foreach_mul_(self._decayed[i],
                                    1.0 - row[0] * self.weight_decay)
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                m = (self._mu_step(i, group["params"], row[1])
                     if self.mu_dtype is not None else None)
                self._update(params, row[0], row[1], group["betas"][1],
                             group["eps"], m)

    def _mu_step(self, i: int, params: list, beta1) -> dict:
        """The first moments of group ``i`` (``mu_dtype``): ``m = b1 m + (1
        - b1) g`` in float32 from the stored bf16 values, the stored copy
        rounded from it; returns ``{parameter: its float32 m}`` (views)."""
        g = torch.cat([(p.grad if p.grad is not None
                        else self._zero[:p.numel()]).reshape(-1)
                       for p in params])
        m = self._mu[i].float()
        m.mul_(beta1)
        m.add_(g * (1 - beta1))
        self._mu[i].copy_(m)
        return {p: t.view_as(p) for p, t in
                zip(params, m.split([p.numel() for p in params]))}

    def _update(self, params, lr, beta1, beta2: float, eps: float,
                mu=None) -> None:
        grads = [p.grad for p in params]
        states = [self.state[p] for p in params]
        v = [st["exp_avg_sq"] for st in states]
        steps = [st["step"] for st in states]
        torch._foreach_add_(steps, 1.0)
        if mu is None:
            m = [st["exp_avg"] for st in states]
            torch._foreach_mul_(m, beta1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - beta1))
        else:  # computed in float32 by _mu_step
            m = [mu[p] for p in params]
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


def make_schedule(cfg: TrainConfig, total_steps: int):
    """The ``cosine_annealing`` or ``constant`` rate as a factor of
    ``cfg.lr`` per step, for ``LambdaLR`` (``haet_tpu/train/trainer.py:
    126-142``): ``(1 + cos(pi * step / t_max)) / 2``, periodic past
    ``t_max`` (``t_max`` None: ``total_steps``), or 1."""
    if cfg.schedule == "constant":
        return lambda step: 1.0
    t_max = cfg.t_max if cfg.t_max is not None else total_steps
    if t_max <= 0:
        raise ValueError(
            f"cosine_annealing needs t_max > 0, got {t_max} "
            "(t_max=None uses the run's total step count)")
    return lambda step: 0.5 * (1.0 + math.cos(math.pi * step / t_max))


def make_optimizer(cfg: TrainConfig, total_steps: int, params,
                   no_decay=()):
    """``(Adam, scheduler)`` over ``params`` for ``total_steps`` optimizer
    steps (``haet_tpu/train/trainer.py:186-244``): Adam, or AdamW
    (``cfg.optimizer``) decaying every parameter but those in
    ``no_decay``; OneCycleLR, whose beta1 cycles between ``max_momentum``
    and ``base_momentum`` when ``cycle_momentum``, or a ``LambdaLR`` of
    :func:`make_schedule` (beta1 0.9, optax's default). Call the
    scheduler's ``step()`` after each optimizer step. The Adam is the
    port's :class:`Adam`, whose steps a CUDA graph can hold."""
    cfg.check_ported()
    params = list(params)
    optimizer = Adam(params, lr=cfg.lr,
                     mu_dtype=torch.bfloat16 if cfg.mu_bf16 else None,
                     weight_decay=(cfg.weight_decay if cfg.optimizer == "adamw"
                                   else 0.0),
                     no_decay=no_decay)
    if cfg.schedule != "onecycle":
        return optimizer, torch.optim.lr_scheduler.LambdaLR(
            optimizer, make_schedule(cfg, total_steps))
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=cfg.lr,
        total_steps=onecycle_horizon(cfg, total_steps),
        pct_start=cfg.pct_start, anneal_strategy="cos",
        cycle_momentum=cfg.cycle_momentum,
        base_momentum=cfg.base_momentum, max_momentum=cfg.max_momentum,
        div_factor=cfg.div_factor, final_div_factor=cfg.final_div_factor)
    return optimizer, scheduler


def split_batch(batch: dict, parts: int) -> list:
    """``batch`` as ``parts`` microbatches along the leading axis, in order
    (None values stay None); raises where ``parts`` does not divide it, as
    the JAX trainer does."""
    out = [{} for _ in range(parts)]
    for k, v in batch.items():
        if v is None:
            for mb in out:
                mb[k] = None
            continue
        if v.shape[0] % parts:
            raise ValueError(
                f"accum_steps={parts} must divide the batch dimension "
                f"({v.shape[0]})")
        for mb, piece in zip(out, torch.split(v, v.shape[0] // parts)):
            mb[k] = piece
    return out


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
    it as a context manager, to release the file. Under a process group
    the metrics are global, and rank 0 alone writes and echoes them."""

    def __init__(self, path: str | None = None, echo: bool = True):
        if not parallel.is_writer():
            path, echo = None, False
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
        mesh: a :class:`~haet_torch.parallel.Mesh` to train over (see the
            module's docstring); the model must hold an HAET model.

    Batches are dicts of numpy arrays or tensors; they are moved to the
    model's device. The trainer owns the training state: the model, Adam,
    the scheduler and :attr:`step` (:meth:`state_dict`). Every tensor of it
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
                 eager: bool = False, mesh=None):
        self.model = model
        self.mesh = mesh
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.total_steps = total_steps
        self.batch_args = batch_args
        self.eval_fn = eval_fn
        self.batch_log_every = batch_log_every
        self.watch_every = watch_every
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer, self.scheduler = make_optimizer(
            cfg, total_steps, self.params,
            no_decay=[p for k, p in model.named_parameters()
                      if k.rsplit(".", 1)[-1] == "sigma_att"])
        self.device = self.params[0].device
        self.step = 0
        self._resume_epoch = None
        # the parameters that receive a gradient, found by the first step,
        # and the buffer their gradients are views of
        self._grad_params = None
        self._flat_grad = None
        self.graphs = None
        # here, not at import: the pipeline imports the models, which a
        # process that only serves or reads checkpoints does not load
        from ..parallel.pipeline import pipelines

        self._pipes = pipelines(model)
        if len(self._pipes) > 1:
            raise ValueError("a trainer takes one PipelinedModel")
        if self._pipes and mesh is not self._pipes[0].mesh:
            raise ValueError("a PipelinedModel trains over its own mesh: "
                             "pass it as Trainer(mesh=...)")
        if mesh is not None:
            if (not eager and self.device.type == "cuda"
                    and mesh.backend != "nccl"):
                raise ValueError(
                    f"a {mesh.backend} mesh's collectives cannot be captured "
                    "in a CUDA graph: pass eager=True, or use NCCL")
            if self._pipes:
                pp = self._pipes[0].pp_axis
                stacked = self._stacked_ids()
                state = self.state_tensors()
                mesh.broadcast_([t for t in state if id(t) not in stacked])
                mesh.broadcast_([t for t in state if id(t) in stacked],
                                axes=[a for a in mesh.axis_names if a != pp])
            else:
                parallel.bind_mesh(model, mesh)
                #: parameters whose gradients are parts over tp
                self._tp_partial = parallel.tp_partial_parameters(model)
                mesh.broadcast_(self.state_tensors())
        if not eager and self.device.type == "cuda":
            from .graphs import StepGraphs

            self.graphs = StepGraphs(self)

    def _on_device(self, batch: dict) -> dict:
        return {k: None if v is None else torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    # -- state ------------------------------------------------------------
    def _stacked_ids(self) -> set:
        """The ids of the pipeline's stacked tensors (its stage's layers)
        and of their Adam moments: empty without a pipeline."""
        if not self._pipes:
            return set()
        stacked = self._pipes[0].stacked_tensors()
        ids = {id(t) for t in stacked}
        for p in stacked:
            ids.update(id(t) for t in self.optimizer.state.get(p, {}).values()
                       if t.ndim)
        return ids

    def _restack(self, state: dict, fn) -> dict:
        """``state`` (this trainer's :meth:`state_dict` layout) with ``fn``
        applied to the entries of the pipeline's stacked tensors."""
        pm = self._pipes[0]
        ids = {id(t) for t in pm.stacked_tensors()}
        local = self.model.state_dict(keep_vars=True)
        model = {k: fn(v) if k in local and id(local[k]) in ids else v
                 for k, v in state["model"].items()}
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        opt = dict(state["optimizer"])
        opt["state"] = {i: ({k: fn(v) if getattr(v, "ndim", 0) else v
                             for k, v in st.items()}
                            if id(params[i]) in ids else st)
                        for i, st in state["optimizer"]["state"].items()}
        return {**state, "model": model, "optimizer": opt}

    def state_dict(self) -> dict:
        """The training state: the model's ``state_dict`` (BatchNorm
        running statistics and ``num_batches_tracked`` included), Adam's,
        the scheduler's (its ``last_epoch``; a cycled beta1 sits in Adam's
        param groups) and the step. Under a pipeline the stages' stacks
        are gathered (a collective: every rank calls it)."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(),
                 "step": self.step}
        if self._pipes:
            state = self._restack(state, self._pipes[0].gather_stages)
        return state

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s state in place (the model's
        ``load_state_dict`` copies into its tensors,
        :meth:`Adam.load_state_dict` into its own), so that the captured
        graphs stay valid. Under a pipeline each rank keeps its stage's
        layers of the stacks."""
        if self._pipes:
            state = self._restack(state, self._pipes[0].local_part)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def num_params(self) -> int:
        """The model's parameter count, every pipeline stage's layers
        included."""
        stages = self._pipes[0].n_stages if self._pipes else 1
        stacked = {id(t) for pm in self._pipes for t in pm.stacked_tensors()}
        return sum(p.numel() * (stages if id(p) in stacked else 1)
                   for p in self.model.parameters())

    def maybe_restore(self, checkpointer, which: str = "last") -> bool:
        """Resume from ``which`` if it exists (onto this trainer's device,
        wherever it was written). Re-arms the best-val watermark, so that
        the first eval after the restart cannot overwrite a better ``best``,
        and takes the epoch to resume after from the checkpoint's sidecar.
        Returns whether a checkpoint was restored. Under a mesh every rank
        restores, then waits for the others."""
        checkpointer.rearm_best()
        state = checkpointer.restore(which, map_location=self.device)
        if self.mesh is not None:
            parallel.barrier()
        if state is None:
            self._resume_epoch = None
            return False
        try:
            self.load_state_dict(state)
        except Exception as e:
            # a layout mismatch only where the checkpoint's tree shows it
            is_pp = bool(self._pipes)
            if any("layers" in k.split(".")
                   for k in state.get("model", {})) == is_pp:
                raise
            raise RuntimeError(
                "checkpoint tree does not match this run's state layout: "
                "a checkpoint written "
                + ("without --pp cannot resume a --pp run" if is_pp else
                   "by a --pp run cannot resume an unpipelined run")
                + " (the optimizer-state layouts differ). Resume with the "
                "original parallel flags, or evaluate/export via car_eval, "
                "which auto-converts pipeline-layout checkpoints.") from e
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
        """The scheduler's step after an optimizer step. Past its horizon
        torch's OneCycleLR raises; the JAX schedule clamps the step to it
        (haet_tpu/train/trainer.py:66-70), so the rate and beta1 stay at
        their values at total_steps, as here. A run resumed after a
        preemption re-runs the interrupted epoch and so takes that many
        steps more than the horizon. The cosine and constant schedules
        have no horizon."""
        horizon = getattr(self.scheduler, "total_steps", None)
        if horizon is None or self.scheduler.last_epoch < horizon:
            self.scheduler.step()

    def step_body(self, batch: dict) -> dict:
        """One step on a batch of tensors on the model's device: the
        forward in train mode, the loss, the gradients copied into the
        parameters' gradients, clipping and Adam (the schedule is the
        caller's: :meth:`advance_schedule`). With ``accum_steps`` A > 1 the
        batch is A microbatches, each a forward and a backward in turn (the
        BatchNorm statistics carried from one to the next), whose gradients
        are summed into the parameters' gradients and divided by A; the
        loss and the aux metrics are the microbatches' means. The op-by-op
        step, and the one that :class:`~haet_torch.train.graphs.StepGraphs`
        captures."""
        self.model.train()
        accum = self.cfg.accum_steps
        micro = [batch] if accum == 1 else split_batch(batch, accum)
        losses, auxes = [], []
        for i, mb in enumerate(micro):
            loss, aux = self.loss_fn(self.model(*self.batch_args(mb)), mb)
            if self._grad_params is None:
                grads = torch.autograd.grad(loss, self.params,
                                            allow_unused=True)
                self._grad_params = [p for p, g in zip(self.params, grads)
                                     if g is not None]
                grads = [g for g in grads if g is not None]
                self._flat_grad = flat_views(self._grad_params)
            else:
                grads = torch.autograd.grad(loss, self._grad_params)
            # into the gradients allocated by the first step, views of one
            # buffer: a concatenation is a few launches, where a copy per
            # parameter (or autograd's accumulation into existing
            # gradients) is one each
            if i == 0:
                torch.cat([g.reshape(-1) for g in grads], out=self._flat_grad)
            else:
                self._flat_grad.add_(torch.cat([g.reshape(-1)
                                                for g in grads]))
            losses.append(loss.detach())
            auxes.append({k: v.detach() for k, v in aux.items()})
        if accum > 1:
            self._flat_grad.div_(accum)
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
            grads = [p.grad for p in self._grad_params]
        if self.mesh is not None:
            self._reduce(self._flat_grad, self._grad_params, micro[0])
            grads = [p.grad for p in self._grad_params]
        if self._pipes and self._pipes[0].n_stages > 1:
            # each rank holds one stage's layers: the norm is the whole
            # model's, as torch's clip_grad_norm_ would take it
            grad_norm = self._pipes[0].grad_norm(self._grad_params)
            if self.cfg.max_grad_norm is not None:
                torch._foreach_mul_(grads, torch.clamp(
                    self.cfg.max_grad_norm / (grad_norm + 1e-6), max=1.0))
        elif self.cfg.max_grad_norm is not None:
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

    def _reduce(self, flat, params, batch) -> None:
        """Sum the flat gradients of ``params`` over the mesh, for the
        layout of ``batch`` (its first model input's batch and points)."""
        if self._pipes:
            self._pipes[0].reduce_gradients(flat, params)
            return
        x = self.batch_args(batch)[0]
        layout = self.mesh.layout(x.shape[0], x.shape[1] if x.ndim > 1 else 1)
        parallel.reduce_gradients(
            flat, self.mesh, layout,
            parallel.tp_ranges(params, self._tp_partial))

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
        named = [(k, p) for k, p in self.model.named_parameters()
                 if p.requires_grad]
        # microbatched as the step is: a batch the step only ever sees in
        # accum_steps pieces may not fit whole
        accum = self.cfg.accum_steps
        total = None
        micro = [batch] if accum == 1 else split_batch(batch, accum)
        for mb in micro:
            loss, _ = self.loss_fn(self.model(*self.batch_args(mb)), mb)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
            total = grads if total is None else [
                None if g is None else t + g for t, g in zip(total, grads)]
        grads = [None if g is None else g / accum for g in total]
        if self.mesh is not None:
            live = [(p, g) for (_, p), g in zip(named, grads)
                    if g is not None]
            flat = torch.cat([g.reshape(-1) for _, g in live])
            self._reduce(flat, [p for p, _ in live], micro[0])
            parts = iter(flat.split([g.numel() for _, g in live]))
            grads = [None if g is None else next(parts).view_as(g)
                     for g in grads]
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
