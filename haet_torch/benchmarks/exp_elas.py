"""Elasticity benchmark driver (reference ``exp_elas.py``).

    python -m haet_torch.benchmarks.exp_elas [--smoke] [--device cpu]
        [--data_path DIR]

Counterpart of ``benchmarks/exp_elas.py``: 972-point unit-cell clouds
(``Random_UnitCell_{XY,sigma}_10.npy``), ``fun_dim`` 0,
``HAETransolverIrregularMesh`` (``elasticity_config``), the stress
normalised per point by ``UnitGaussianNormalizer``, AdamW with cosine
annealing of ``t_max`` = epochs stepped per batch (as the reference's
``CosineAnnealingLR(T_max=epochs)``), batch 1 by default, rel-L2 of the
decoded stress, printed as ``rel_err:``. The synthetic stand-in stands in
when the files are absent. The card is the default device; ``--device
cpu`` runs on the CPU;
``--dp``/``--tp``/``--pp``/``--multihost`` train over a mesh, one process
per rank (``pde_common``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pde_datasets import load_elasticity
from ..train.normalizer import UnitGaussianNormalizer
from ..utils.config import elasticity_config
from ..utils.env import default_device
from .exp_pipe import rel_l2_loss
from .pde_common import (apply_model_args, base_parser, check_mesh_args,
                         shrink_for_smoke, train_and_eval)


def main(argv=None) -> float:
    p = base_parser("haet_torch Elasticity")
    p.set_defaults(batch_size=1)  # reference HAETransolver_Elas.sh
    args = p.parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    check_mesh_args(args)
    dev = default_device(args.device)
    cfg = apply_model_args(elasticity_config(), args)
    data = load_elasticity(args.data_path, args.ntrain, args.ntest)
    if data["synthetic"]:
        print("[elasticity] dataset not found -> synthetic stand-in data")

    y_norm = UnitGaussianNormalizer(data["train"]["y"])
    train, test = ({"pos": data[k]["pos"].astype(np.float32),
                    "y": data[k]["y"].astype(np.float32),
                    "y_enc": y_norm.encode(data[k]["y"]).astype(np.float32)}
                   for k in ("train", "test"))
    loss_fn = rel_l2_loss(
        torch.tensor(np.asarray(y_norm.mean, np.float32), device=dev),
        torch.tensor(np.asarray(y_norm.std + y_norm.eps, np.float32),
                     device=dev))
    rel, _ = train_and_eval(cfg, args, dev, "elas", train, test, loss_fn,
                            lambda b: (b["pos"], None), seed=cfg.train.seed)
    return rel


if __name__ == "__main__":
    main()
