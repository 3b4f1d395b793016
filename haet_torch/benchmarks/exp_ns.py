"""Navier-Stokes benchmark driver (reference ``exp_ns.py``).

    python -m haet_torch.benchmarks.exp_ns [--smoke] [--device cpu]
        [--data_path DIR] [--export_rollout DIR]

Counterpart of ``benchmarks/exp_ns.py``: 64 x 64 vorticity, ``T_IN`` 10
input frames, a rollout of ``T_OUT`` 10 frames of ``STEP`` 1, on
``HAETransolverStructuredMesh2D`` (``ns_config``: 8 layers, n_hidden 256,
G 64, ``unified_pos``), AdamW + OneCycle. Training is teacher-forced: each
frame's window takes the ground-truth frame, and the loss is the sum over
frames of the rel-L2 per sample over the batch (:func:`rollout_loss`);
each frame's forward runs under ``torch.utils.checkpoint``, as JAX wraps
the frame in ``jax.checkpoint``, its recompute replaying the frame's
dropout masks and leaving the BatchNorm statistics alone (one update per
frame); each frame draws its own dropout masks. Eval is autoregressive
(:func:`haet_torch.export.rollout`) and its loss, ``full``, the rel-L2 of
the whole ``[B, N, T_OUT]`` prediction. Each epoch logs
``train/l2_step``, ``train/l2_full``, ``val/l2_full`` and
``epoch/time_seconds`` to ``<out_dir>/ns_metrics.jsonl`` and saves
``best`` and ``last`` under ``<out_dir>/checkpoints/ns``; the end prints
the test set's per-sample rel-L2 as ``rel_err:``. ``--export_rollout DIR``
then writes the ``T_OUT // STEP``-step rollout program of the first test
sample (:func:`haet_torch.export.save_rollout_artifact`).

The step runs op by op (no CUDA graph), ~40-50k kernels per step at the
preset. The NS file is MATLAB v7.3, which needs ``h5py``; where it is not
installed the loader raises naming the file, so point ``--data_path`` at a
directory without it to train on the synthetic stand-in. ``--smoke`` runs
2 epochs of a small model. The card is the default device; ``--device
cpu`` runs on the CPU; ``--dp``/``--tp``/``--pp``/``--multihost`` train
over a mesh, one process per rank (``pde_common``); ``--export_rollout``
with ``--pp`` exits, as in JAX (the rollout program runs the unpipelined
model).
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..data.pde_datasets import load_ns
from ..data.synthetic import batch_iter
from ..export import rollout, save_rollout_artifact
from ..models.components.dropout import checkpoint_contexts
from ..train import Checkpointer, MetricsLogger
from ..train.losses import RelLpLoss
from ..utils.config import ns_config
from ..utils.env import default_device
from .pde_common import (apply_model_args, base_parser, check_mesh_args,
                         init_custom_loop_state, shrink_for_smoke,
                         weighted_eval)

T_IN, T_OUT, STEP = 10, 10, 1


class Rollout(nn.Module):
    """The NS model's ``steps`` frames of ``step`` as one module of
    ``(pos, fx [B, N, T_in], y [B, N, steps * step])`` returning the
    ``[B, N, steps * step]`` prediction. In train mode the window takes the
    ground-truth frames (teacher forcing) and, while autograd records,
    each frame's forward is checkpointed (unless the model checkpoints its
    own blocks: the two do not nest); in eval mode it is the
    autoregressive :func:`~haet_torch.export.rollout` and ``y`` is not
    read."""

    def __init__(self, model: nn.Module, steps: int, step: int,
                 checkpoint_frames: bool = True):
        super().__init__()
        self.model = model
        self.steps = steps
        self.step = step
        self.checkpoint_frames = checkpoint_frames

    def frame(self, pos, fx):
        if (self.checkpoint_frames and torch.is_grad_enabled()
                and not getattr(self.model, "use_checkpoint", False)):
            return checkpoint(self.model, pos, fx, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=functools.partial(
                                  checkpoint_contexts, self.model))
        return self.model(pos, fx)

    def forward(self, pos, fx, y=None):
        if not self.training:
            return rollout(self.model, pos, fx, self.steps, self.step)
        preds = []
        for t in range(self.steps):
            preds.append(self.frame(pos, fx))
            truth = y[..., t * self.step:(t + 1) * self.step]
            fx = torch.cat([fx[..., self.step:], truth.to(fx.dtype)], -1)
        return torch.cat(preds, dim=-1)


def rollout_loss(steps: int, step: int):
    """``(loss_fn, eval_fn)`` of a ``[B, N, steps * step]`` prediction:
    the loss is the sum over frames of ``RelLpLoss(size_average=False)``
    over the batch size, with the whole rollout's (``full``) as an aux
    metric; eval reports ``full`` as its loss."""
    rel_l2 = RelLpLoss(size_average=False)

    def full_of(pred, y):
        b = pred.shape[0]
        return rel_l2(pred.reshape(b, -1), y.reshape(b, -1)) / b

    def loss_fn(pred, batch):
        y = batch["y"]
        loss = sum(full_of(pred[..., t * step:(t + 1) * step],
                           y[..., t * step:(t + 1) * step])
                   for t in range(steps))
        return loss, {"full": full_of(pred, y)}

    def eval_fn(pred, batch):
        return {"loss": full_of(pred, batch["y"])}

    return loss_fn, eval_fn


def main(argv=None) -> float:
    args = parse_args(argv)
    cfg = apply_model_args(ns_config(), args)
    if cfg.train.accum_steps > 1:
        raise SystemExit(
            "exp_ns: --accum_steps is not supported by this custom rollout "
            "loop (the per-frame checkpoint already bounds activation "
            "memory; use --use_checkpoint)")
    check_mesh_args(args)
    dev = default_device(args.device)
    data = load_ns(args.data_path, args.ntrain, args.ntest, T_IN, T_OUT)
    if data["synthetic"]:
        print("[ns] dataset not found -> synthetic stand-in data")
    s = data["s"]
    cfg.model.H = cfg.model.W = s
    cfg.model.fun_dim = T_IN
    train = {k: v.astype(np.float32) for k, v in data["train"].items()}
    test = {k: v.astype(np.float32) for k, v in data["test"].items()}
    bs = cfg.train.batch_size
    steps = T_OUT // STEP
    loss_fn, eval_fn = rollout_loss(steps, STEP)
    model, trainer = init_custom_loop_state(
        cfg, args, dev, len(train["y"]),
        lambda m: Rollout(m, steps, STEP), loss_fn,
        lambda b: (b["pos"], b["x"], b["y"]), eval_fn)

    logger = MetricsLogger(os.path.join(args.out_dir, "ns_metrics.jsonl"))
    ckpt = Checkpointer(os.path.join(args.out_dir, "checkpoints", "ns"))
    for ep in range(cfg.train.epochs):
        t0 = time.time()
        step_losses, full_losses = [], []
        for batch in batch_iter(train, bs, True, ep)():
            m = trainer.train_step(batch)
            step_losses.append(float(m["loss"]))
            full_losses.append(float(m["full"]))
        evs = [float(trainer.eval_step(b)["loss"])
               for b in batch_iter(test, bs, False)()]
        logger.log({"epoch": ep,
                    "train/l2_step": float(np.mean(step_losses)),
                    "train/l2_full": float(np.mean(full_losses)),
                    "val/l2_full": float(np.mean(evs)),
                    "epoch/time_seconds": time.time() - t0})
        state = trainer.state_dict()
        ckpt.save_best(state, float(np.mean(evs)), ep)
        ckpt.save_last(state, ep)
    rel = weighted_eval(trainer, test, bs)
    print(f"rel_err:{rel}", flush=True)
    logger.close()

    if args.export_rollout:
        if args.pp > 1:
            raise SystemExit(
                "--export_rollout with --pp: convert the stacked pipeline "
                "checkpoint to the plain layout first (parallel.pipeline."
                "merge_variables; car_eval --export_artifact shows the "
                "flow) — rollout export runs the unpipelined model")
        save_rollout_artifact(args.export_rollout, model, None,
                              (test["pos"][:1], test["x"][:1]), steps=steps)
        print(f"rollout artifact -> {args.export_rollout}", flush=True)
    return rel


def parse_args(argv=None):
    p = base_parser("haet_torch Navier-Stokes")
    p.add_argument("--export_rollout", type=str, default=None,
                   help="after training, export the whole autoregressive "
                        "rollout (T_OUT frames) as one program to this "
                        "directory")
    args = p.parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    return args


if __name__ == "__main__":
    main()
