"""Plasticity benchmark driver (reference ``exp_plas.py``).

    python -m haet_torch.benchmarks.exp_plas [--smoke] [--device cpu]
        [--data_path DIR]

Counterpart of ``benchmarks/exp_plas.py``: the 101 x 31 grid (``H`` and
``W`` from the data), ``fun_dim`` 1, ``out_dim`` 4 and ``Time_Input``, on
``HAETransolverStructuredMesh2D`` (``plasticity_config``), AdamW +
OneCycle, batch 8 clamped to the data. The model is queried for each of
the data's ``T`` (20) time steps (:class:`TimeQueries`). In training the
queries run one after the other in train mode, each updating the BatchNorm
statistics in turn, as JAX's ``lax.scan`` carries them, and each drawing
its own dropout masks; in eval the statistics stay frozen, one forward per
query. Never one forward of the ``B * T`` queries folded into the batch:
the Erwin pseudo-positions are min-max normalised over the whole batch, so
that would compute another function (JAX ``vmap``s the queries). The loss
is the rel-L2 per sample over ``[B, T * N * 4]`` in JAX's ``(B, T, N, 4)``
order. Each epoch logs ``train/rel_l2``, ``val/rel_l2`` and
``epoch/time_seconds`` to ``<out_dir>/plas_metrics.jsonl`` and saves
``best`` and ``last`` under ``<out_dir>/checkpoints/plas``; the end prints
the test set's per-sample rel-L2 as ``rel_err:``.

The step runs op by op (no CUDA graph). ``--smoke`` runs 2 epochs of a
small model. The card is the default device; ``--device cpu`` runs on the
CPU; ``--dp``/``--tp``/``--pp``/``--multihost`` train over a mesh, one
process per rank (``pde_common``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

from ..data.pde_datasets import load_plasticity
from ..data.synthetic import batch_iter
from ..train import Checkpointer, MetricsLogger
from ..train.losses import RelLpLoss
from ..utils.config import plasticity_config
from ..utils.env import default_device
from .pde_common import (apply_model_args, base_parser, check_mesh_args,
                         init_custom_loop_state, shrink_for_smoke,
                         weighted_eval)


class TimeQueries(nn.Module):
    """The model queried at ``t = 0 .. t_steps - 1``: ``(pos, fx) -> [B,
    t_steps, N, out_dim]``, one forward per query, in order."""

    def __init__(self, model: nn.Module, t_steps: int):
        super().__init__()
        self.model = model
        self.t_steps = t_steps

    def forward(self, pos, fx):
        b = pos.shape[0]
        return torch.stack([
            self.model(pos, fx, torch.full((b, 1), float(t),
                                           device=pos.device))
            for t in range(self.t_steps)], dim=1)


def plas_loss(out, batch):
    """The rel-L2 per sample of ``[B, T, N, 4]`` against ``y [B, N, T, 4]``
    taken in ``(B, T, N, 4)`` order, over the batch size."""
    b = out.shape[0]
    y = batch["y"].permute(0, 2, 1, 3)
    loss = RelLpLoss(size_average=False)(out.reshape(b, -1),
                                         y.reshape(b, -1)) / b
    return loss, {}


def main(argv=None) -> float:
    args = parse_args(argv)
    cfg = apply_model_args(plasticity_config(), args)
    if cfg.train.accum_steps > 1:
        raise SystemExit(
            "exp_plas: --accum_steps is not supported by this custom "
            "time-query loop (use --use_checkpoint for memory)")
    check_mesh_args(args)
    dev = default_device(args.device)
    data = load_plasticity(args.data_path, args.ntrain, args.ntest)
    if data["synthetic"]:
        print("[plasticity] dataset not found -> synthetic stand-in data")
    cfg.model.H, cfg.model.W = data["h"], data["w"]
    cfg.model.fun_dim = 1
    cfg.model.out_dim = 4
    cfg.model.Time_Input = True
    train = {k: v.astype(np.float32) for k, v in data["train"].items()}
    test = {k: v.astype(np.float32) for k, v in data["test"].items()}
    # the batch clamped to the data (tiny stand-ins)
    cfg.train.batch_size = min(cfg.train.batch_size, len(train["y"]),
                               len(test["y"]))
    bs = cfg.train.batch_size
    _, trainer = init_custom_loop_state(
        cfg, args, dev, len(train["y"]),
        lambda m: TimeQueries(m, data["t"]), plas_loss,
        lambda b: (b["pos"], b["fx"]))

    logger = MetricsLogger(os.path.join(args.out_dir, "plas_metrics.jsonl"))
    ckpt = Checkpointer(os.path.join(args.out_dir, "checkpoints", "plas"))
    for ep in range(cfg.train.epochs):
        t0 = time.time()
        losses = [float(trainer.train_step(batch)["loss"])
                  for batch in batch_iter(train, bs, True, ep)()]
        evs = [float(trainer.eval_step(b)["loss"])
               for b in batch_iter(test, bs, False)()]
        logger.log({"epoch": ep, "train/rel_l2": float(np.mean(losses)),
                    "val/rel_l2": float(np.mean(evs)),
                    "epoch/time_seconds": time.time() - t0})
        state = trainer.state_dict()
        ckpt.save_best(state, float(np.mean(evs)), ep)
        ckpt.save_last(state, ep)
    rel = weighted_eval(trainer, test, bs)
    print(f"rel_err:{rel}", flush=True)
    logger.close()
    return rel


def parse_args(argv=None):
    p = base_parser("haet_torch Plasticity")
    p.set_defaults(batch_size=8)  # reference HAETransolver_Plas.sh
    args = p.parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    return args


if __name__ == "__main__":
    main()
