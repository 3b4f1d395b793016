"""Pipe benchmark driver (reference ``exp_pipe.py``).

    python -m haet_torch.benchmarks.exp_pipe [--smoke] [--device cpu]
        [--data_path DIR]

Counterpart of ``benchmarks/exp_pipe.py``: the 129 x 129 mesh coordinates
(``Pipe_{X,Y,Q}.npy``) are the input, ``fun_dim`` 0 (the placeholder path),
``HAETransolverStructuredMesh2D`` (``pipe_config``), AdamW + OneCycle,
rel-L2 on the decoded field, printed as ``rel_err:``. :func:`run` also
drives ``exp_airfoil``. The synthetic stand-in stands in when the files are
absent; ``--smoke`` runs 2 epochs of a small model on a 33 x 33 crop. The
card is the default device; ``--device cpu`` runs on the CPU;
``--dp``/``--tp``/``--pp``/``--multihost`` train over a mesh, one process
per rank (``pde_common``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pde_datasets import load_structured_mesh
from ..train.losses import RelLpLoss
from ..train.normalizer import UnitTransformer
from ..utils.config import pipe_config
from ..utils.env import default_device
from .pde_common import (apply_model_args, base_parser, check_mesh_args,
                         shrink_for_smoke, train_and_eval)


def rel_l2_loss(y_mean, y_std):
    """The rel-L2 loss of the decoded first output channel."""
    rel_l2 = RelLpLoss(size_average=False)

    def loss_fn(out, batch):
        out = out[..., 0].float() * y_std + y_mean
        l2 = rel_l2(out, batch["y"]) / out.shape[0]
        return l2, {"rel_l2": l2}

    return loss_fn


def run(args, prefix="Pipe", h=129, w=129, config_fn=pipe_config,
        name="pipe") -> float:
    check_mesh_args(args)
    dev = default_device(args.device)
    cfg = apply_model_args(config_fn(), args)
    if args.smoke:
        h, w = 33, 33
    data = load_structured_mesh(args.data_path, prefix, args.ntrain,
                                args.ntest, h, w)
    if data["synthetic"]:
        print(f"[{name}] dataset not found -> synthetic stand-in data")
    cfg.model.H, cfg.model.W = data["h"], data["w"]

    x_norm = UnitTransformer(data["train"]["pos"])
    y_norm = UnitTransformer(data["train"]["y"])
    train, test = ({"pos": x_norm.encode(data[k]["pos"]).astype(np.float32),
                    "y": data[k]["y"].astype(np.float32)}
                   for k in ("train", "test"))
    loss_fn = rel_l2_loss(
        torch.tensor(np.float32(y_norm.mean.squeeze()), device=dev),
        torch.tensor(np.float32(y_norm.std.squeeze()), device=dev))
    rel, _ = train_and_eval(cfg, args, dev, name, train, test, loss_fn,
                            lambda b: (b["pos"], None), seed=cfg.train.seed)
    return rel


def main(argv=None) -> float:
    args = base_parser("haet_torch Pipe").parse_args(argv)
    if args.smoke:
        shrink_for_smoke(args)
    return run(args)


if __name__ == "__main__":
    main()
