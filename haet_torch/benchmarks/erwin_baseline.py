"""Erwin-only ShapeNet-Car baseline (reference ``benchmarks/02.1``).

    python -m haet_torch.benchmarks.erwin_baseline [--smoke] [--device cpu]
        [--data_dir DIR]

Counterpart of ``benchmarks/erwin_baseline.py``: a bare
:class:`~haet_torch.models.ErwinTransformer` over the raw 7 car features
(no physics-attention tokenizer) and a 2-layer head, c_hidden (128, 128),
balls (64, 32), heads 8/8/8, depths 4/4 and a decoder of 4, stride 2,
rotation 45, mlp_ratio 4, d 3, with 3 steps of MPNN message passing over
the radius graph (r 0.2, at most 32 neighbours): :class:`ErwinCarModel`.
It trains through ``Trainer.fit`` at batch 1 (AdamW + OneCycle, clipping at
1.0, early stopping after 7 evals without improvement), on one
``RandomState(0)`` shuffle made outside the batch factory, and evaluates
the validation fold as ``car_train`` does. ``--smoke`` runs 1 epoch at
hidden 32 with one MPNN step.

The baseline runs no hand-written kernel, in either package: the fused
Erwin block's gate takes clouds of at most 512 points
(``ops/kernels/erwin_block.py:eligible``), and this model is one cloud of
the sample's padded points (32768 for a ShapeNet-Car sample), so its
blocks are the plain block, as JAX leaves ``use_pallas_blocks`` off.
Clouds above 4096 points find their neighbours through the ball-grouped
search (:func:`~haet_torch.ops.neighbors.knn_edges_grouped`).

The card is the default device; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import shapenet_car
from ..models.erwin import ErwinTransformer
from ..models.haet import init_weights
from ..ops.ball_groups import pad_pow2
from ..train import Checkpointer, MetricsLogger, Trainer
from ..train.car import evaluate, loss_fn_builder, make_batch
from ..utils.config import TrainConfig
from ..utils.env import default_device


class ErwinCarModel(nn.Module):
    """ErwinTransformer and a prediction head (reference
    ``02.1/main.py:51-106``; ``benchmarks/erwin_baseline.py:35-72``).

    ``model(x [B, N, 7], fx=None) -> [B, N, 4]``: the first 3 features are
    the positions; the points are padded to a power of two by duplicating
    real ones (masked out of the neighbour graph and cut off the output).
    Module names are the JAX model's (``erwin``, ``head1``, ``head2``), so
    ``haet_torch/utils/weights.py`` loads its variables. Parameters are
    initialised on the CPU from ``torch.Generator().manual_seed(seed)``
    (:func:`~haet_torch.models.haet.init_weights`), then moved to
    ``device`` (None: the card).
    """

    def __init__(self, hidden_dim: int = 128, mp_steps: int = 3,
                 radius: float = 0.2, *, device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        self.erwin = ErwinTransformer(
            c_in=7, c_hidden=(hidden_dim, hidden_dim), ball_sizes=(64, 32),
            enc_num_heads=(8, 8), enc_depths=(4, 4), dec_num_heads=(8,),
            dec_depths=(4,), strides=(2,), rotate=45, mlp_ratio=4,
            dimensionality=3, mp_steps=mp_steps, mp_radius=radius,
            mp_neighbors=32, embed=True)
        self.head1 = nn.Linear(hidden_dim, hidden_dim)
        self.head2 = nn.Linear(hidden_dim, 4)
        with torch.no_grad():
            init_weights(self, torch.Generator().manual_seed(seed))
        self.to(device)

    def forward(self, x, fx=None):
        pos = x[..., :3]
        xp, posp, mask = pad_pow2(x, pos)
        out = self.erwin(xp, posp, mask=mask)[:, :x.shape[1]]
        return self.head2(F.gelu(self.head1(out), approximate="none"))


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = default_device(args.device)
    train_s, val_s, coef, is_synth = shapenet_car.load_train_val_fold(
        args.data_dir, args.fold_id)
    if is_synth:
        print("[erwin_baseline] dataset not found -> synthetic stand-in data")
    cfg = TrainConfig(lr=args.lr, epochs=args.epochs, batch_size=1,
                      max_grad_norm=1.0, early_stop_patience=7)
    model = ErwinCarModel(args.hidden_dim, args.mp_steps, args.r,
                          device=dev, seed=cfg.seed)
    trainer = Trainer(model, loss_fn_builder(args.weight), cfg,
                      total_steps=len(train_s) * cfg.epochs,
                      batch_args=lambda b: (b["x"],))
    print(f"nb_parameters {trainer.num_params()}", flush=True)

    # one RandomState outside the factory: fit() calls train_batches()
    # every epoch, and a re-seeded one would replay one order every epoch
    shuffle_rng = np.random.RandomState(0)

    def train_batches():
        for i in shuffle_rng.permutation(len(train_s)):
            yield make_batch(train_s[i])

    with MetricsLogger(os.path.join(args.out_dir,
                                    "erwin_metrics.jsonl")) as logger:
        trainer.fit(train_batches, lambda: (make_batch(s) for s in val_s),
                    logger=logger, checkpointer=Checkpointer(os.path.join(
                        args.out_dir, "checkpoints", "erwin_car")))
        metrics = evaluate(model, val_s, coef, logger)
    print("relative l2 error press:", metrics["rel_l2_press"])
    print("relative l2 error velo:", metrics["rel_l2_velo"], flush=True)
    return metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser("haet_torch Erwin-only car baseline")
    p.add_argument("--data_dir", type=str,
                   default="./data/shapenet_car/mlcfd_data/training_data")
    p.add_argument("--fold_id", type=int, default=0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight", type=float, default=0.5)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--mp_steps", type=int, default=3)
    p.add_argument("--r", type=float, default=0.2,
                   help="MPNN radius-graph radius (reference 02.1 default)")
    p.add_argument("--out_dir", type=str, default="./runs")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs = 1
        args.hidden_dim = 32
        args.mp_steps = 1
    return args


if __name__ == "__main__":
    main()
