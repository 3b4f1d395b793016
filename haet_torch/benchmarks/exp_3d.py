"""Volumetric (3D structured) benchmark driver (``benchmarks/exp_3d.py``).

    python -m haet_torch.benchmarks.exp_3d [--smoke] [--device cpu]

Counterpart of ``benchmarks/exp_3d.py``: ``HAETransolverStructuredMesh3D``
(Conv3d slice projection, ``ref^3`` unified position features, ref 4 by
default) on a synthetic heat-diffusion volume of 32^3 (16^3 with
``--smoke``): the initial temperature in, the field after ten diffusion
steps out, AdamW + OneCycle, rel-L2 of the decoded field, printed as
``rel_err:``. ``use_checkpoint`` is on at full size unless
``--use_checkpoint 0`` says otherwise, as in the JAX driver. The card is
the default device; ``--device cpu`` runs on the CPU;
``--dp``/``--tp``/``--pp``/``--multihost`` train over a mesh, one process
per rank (``pde_common``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..train.normalizer import UnitTransformer
from ..utils.config import ExperimentConfig, ModelConfig, TrainConfig
from ..utils.env import default_device
from .exp_pipe import rel_l2_loss
from .pde_common import (apply_model_args, base_parser, check_mesh_args,
                         shrink_for_smoke, train_and_eval)


def heat3d_like(n: int, s: int, seed: int = 0):
    """``(pos [n, s^3, 3], u0 [n, s^3], u [n, s^3])``: a smoothed random
    initial temperature and the field after ten diffusion steps
    (``benchmarks/exp_3d.py:32-47``)."""
    rng = np.random.RandomState(seed)
    u0 = rng.randn(n, s, s, s).astype(np.float32)
    for _ in range(2):
        u0 = sum(np.roll(u0, sh, ax) for ax in (1, 2, 3) for sh in (-1, 1)) / 6
    u = u0.copy()
    for _ in range(10):
        u = 0.4 * u + 0.6 * (
            sum(np.roll(u, sh, ax) for ax in (1, 2, 3) for sh in (-1, 1)) / 6
        )
    g = np.linspace(0, 1, s, dtype=np.float32)
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    pos = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], -1)[None].repeat(n, 0)
    return pos, u0.reshape(n, -1), u.reshape(n, -1)


def main(argv=None) -> float:
    p = base_parser("haet_torch 3D volume")
    p.set_defaults(use_checkpoint=None)  # None: on at full size
    p.set_defaults(ref=4)  # 4^3 = 64 position features
    args = p.parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    check_mesh_args(args)
    dev = default_device(args.device)
    s = 16 if args.smoke else 32
    cfg = ExperimentConfig(
        name="heat3d",
        model=ModelConfig(variant="structured_3d", space_dim=3, fun_dim=1,
                          out_dim=1, H=s, W=s, D=s),
        train=TrainConfig(lr=args.lr, epochs=args.epochs,
                          batch_size=args.batch_size),
    )
    use_checkpoint = ((not args.smoke) if args.use_checkpoint is None
                      else bool(args.use_checkpoint))
    args.use_checkpoint = int(use_checkpoint)
    cfg = apply_model_args(cfg, args)

    pos_tr, x_tr, y_tr = heat3d_like(max(8, min(args.ntrain, 32)), s, 0)
    pos_te, x_te, y_te = heat3d_like(max(4, min(args.ntest, 8)), s, 1)
    x_norm = UnitTransformer(x_tr)
    y_norm = UnitTransformer(y_tr)
    train = {"pos": pos_tr,
             "fx": x_norm.encode(x_tr)[..., None].astype(np.float32),
             "y": y_tr.astype(np.float32)}
    test = {"pos": pos_te,
            "fx": x_norm.encode(x_te)[..., None].astype(np.float32),
            "y": y_te.astype(np.float32)}
    loss_fn = rel_l2_loss(
        torch.tensor(np.float32(y_norm.mean.squeeze()), device=dev),
        torch.tensor(np.float32(y_norm.std.squeeze()), device=dev))
    rel, _ = train_and_eval(cfg, args, dev, "heat3d", train, test, loss_fn,
                            lambda b: (b["pos"], b["fx"]))
    return rel


if __name__ == "__main__":
    main()
