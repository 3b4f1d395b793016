"""Darcy flow benchmark driver (PDE-solving standard benchmark).

    python -m haet_torch.benchmarks.exp_darcy [--smoke] [--device cpu]
        [--epochs 500] [--data_path DIR]

Counterpart of ``benchmarks/exp_darcy.py``, with its flags: the 421^2 grids
downsampled to 85 x 85 (``--downsample 5``), ``UnitTransformer``
normalisation, ``HAETransolverStructuredMesh2D`` (the ``darcy_config``
preset; ``--unified_pos`` defaults to 0 here, as in the JAX driver), AdamW +
OneCycle, the rel-L2 loss on the decoded field plus 0.1 x the rel-L2 of its
central differences with the boundary ring zeroed (reference
``exp_darcy.py:219-226``), eval every epoch, then the test set's per-sample
rel-L2, printed as ``rel_err:``. The synthetic stand-in stands in when the
``.mat`` files are absent. ``--smoke`` runs 2 epochs of a small model on a
31 x 31 grid.

The card is the default device; ``--device cpu`` runs on the CPU.
``--showcase`` then renders the first test sample's prediction, target and
error (:func:`haet_torch.utils.visualization.plot_prediction_triptych`,
reference ``exp_darcy.py:166-200``) under ``<out_dir>/results/darcy``; it
needs matplotlib.
``--dp``/``--tp``/``--pp``/``--multihost`` train over a mesh, one process
per rank (``pde_common``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.pde_datasets import load_darcy
from ..train.losses import RelLpLoss, central_diff, zero_boundary
from ..train.normalizer import UnitTransformer
from ..utils.config import darcy_config
from ..utils.env import default_device, host_numpy
from .pde_common import add_mesh_args, check_mesh_args, train_and_eval


def build(args):
    """``darcy_config`` sized by the flags (``exp_darcy.py:46-61``)."""
    cfg = darcy_config(args.downsample)
    cfg.train.lr = args.lr
    cfg.train.epochs = args.epochs
    cfg.train.batch_size = args.batch_size
    cfg.model.n_hidden = args.n_hidden
    cfg.model.n_layers = args.n_layers
    cfg.model.n_head = args.n_heads
    cfg.model.slice_num = args.slice_num
    cfg.model.unified_pos = bool(args.unified_pos)
    cfg.model.mlp_ratio = args.mlp_ratio
    cfg.model.bf16 = bool(args.bf16)
    cfg.train.max_grad_norm = args.max_grad_norm
    cfg.train.accum_steps = args.accum_steps
    cfg.train.mu_bf16 = bool(args.mu_bf16)
    return cfg


def darcy_loss(s: int, y_mean, y_std):
    """``(loss_fn, eval_fn)`` on the decoded field of an ``s x s`` grid:
    rel-L2 + 0.1 x the gradient regulariser, and rel-L2 alone."""
    rel_l2 = RelLpLoss(size_average=False)
    dx = 1.0 / s

    def decode(out):
        return out[..., 0].float() * y_std + y_mean

    def loss_fn(out, batch):
        out = decode(out)
        y = batch["y"]
        l2 = rel_l2(out, y) / out.shape[0]
        outz = zero_boundary(out[..., None], s)
        gx_p, gy_p = central_diff(outz, dx, s)
        gx_t, gy_t = central_diff(y[..., None], dx, s)
        deriv = (rel_l2(gx_p, gx_t) + rel_l2(gy_p, gy_t)) / out.shape[0]
        return l2 + 0.1 * deriv, {"rel_l2": l2, "deriv": deriv}

    def eval_fn(out, batch):
        out = decode(out)
        return {"loss": rel_l2(out, batch["y"]) / out.shape[0]}

    return loss_fn, eval_fn


def main(argv=None) -> float:
    args = parse_args(argv)
    check_mesh_args(args)
    dev = default_device(args.device)
    cfg = build(args)
    data = load_darcy(args.data_path, args.ntrain, args.ntest,
                      args.downsample)
    s = data["s"]
    if data["synthetic"]:
        print("[exp_darcy] dataset not found -> synthetic stand-in data")
    # the grid side comes from the loaded file
    cfg.model.H = cfg.model.W = s

    x_norm = UnitTransformer(data["train"]["x"])
    y_norm = UnitTransformer(data["train"]["y"])
    train, test = ({"pos": data[k]["pos"],
                    "fx": x_norm.encode(data[k]["x"])[..., None].astype(
                        np.float32),
                    "y": data[k]["y"].astype(np.float32)}
                   for k in ("train", "test"))
    loss_fn, eval_fn = darcy_loss(
        s, torch.tensor(np.float32(y_norm.mean.squeeze()), device=dev),
        torch.tensor(np.float32(y_norm.std.squeeze()), device=dev))
    rel, trainer = train_and_eval(cfg, args, dev, "darcy", train, test,
                                  loss_fn, lambda b: (b["pos"], b["fx"]),
                                  eval_fn=eval_fn, resume=args.resume,
                                  seed=cfg.train.seed)
    if args.showcase:
        showcase(trainer, test, s, y_norm, args.out_dir)
    return rel


def showcase(trainer, test: dict, s: int, y_norm, out_dir: str) -> str:
    """The first test sample's prediction, target and error renders
    (``exp_darcy.py:145-156``)."""
    from ..utils.visualization import plot_prediction_triptych

    batch = {k: v[:1] for k, v in test.items()}
    out = host_numpy(trainer.predict(batch))
    pred = out[0, :, 0] * float(y_norm.std.squeeze()) + float(
        y_norm.mean.squeeze())
    path = os.path.join(out_dir, "results", "darcy")
    plot_prediction_triptych(pred, batch["y"][0], s, s, path, 1)
    print(f"showcase renders -> {path}", flush=True)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser("haet_torch Darcy")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=4, dest="batch_size")
    p.add_argument("--n-hidden", type=int, default=128, dest="n_hidden")
    p.add_argument("--n-layers", type=int, default=8, dest="n_layers")
    p.add_argument("--n-heads", type=int, default=8, dest="n_heads")
    p.add_argument("--slice_num", type=int, default=64)
    p.add_argument("--mlp_ratio", type=int, default=1)
    p.add_argument("--max_grad_norm", type=float, default=None,
                   help="global grad-norm clip (reference HAET_Darcy.sh "
                        "passes 0.1)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: microbatches per optimizer "
                        "step (must divide --batch-size)")
    p.add_argument("--downsample", type=int, default=5)
    p.add_argument("--unified_pos", type=int, default=0)
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--ntest", type=int, default=200)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--mu_bf16", type=int, default=0,
                   help="store Adam's first moment in bfloat16")
    p.add_argument("--data_path", type=str, default="./data/fno")
    p.add_argument("--out_dir", type=str, default="./runs")
    p.add_argument("--showcase", action="store_true",
                   help="save prediction/gt/error images after eval")
    p.add_argument("--resume", action="store_true",
                   help="resume from the last checkpoint in out_dir")
    add_mesh_args(p)
    p.add_argument("--smoke", action="store_true",
                   help="tiny synthetic run (CI/dev)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs = 2
        args.n_hidden = 32
        args.n_layers = 2
        args.n_heads = 4
        args.slice_num = 16
        args.batch_size = 2
        args.ntrain, args.ntest = 8, 4
        args.downsample = 14  # 31x31
    return args


if __name__ == "__main__":
    main()
