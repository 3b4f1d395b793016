"""What the PDE drivers share: the counterpart of ``benchmarks/_common.py``.

:func:`base_parser` is the JAX drivers' flag surface (``_common.py:16-50``)
plus ``--device`` (the card unless ``--device cpu``) and the mesh flags:
``--dp``, ``--tp``, ``--pp``, ``--pp_microbatches`` and ``--multihost``
train over a mesh (:func:`~haet_torch.benchmarks.car_train.check_mesh_args`,
:func:`~haet_torch.benchmarks.car_train.make_mesh_from_args`,
:func:`~haet_torch.benchmarks.car_train.maybe_pipeline`).
:func:`shrink_for_smoke` and :func:`apply_model_args` size a preset from the
flags as JAX does, :func:`weighted_eval` is the per-sample test loss, and
:func:`train_and_eval` the drivers' common tail: the model with both kernel
flags set (as ``car_train`` builds it; on the CPU the kernels' plain
versions run), ``Trainer.fit`` with a JSONL log and checkpoints under
``--out_dir``, then the final ``rel_err``. :func:`init_custom_loop_state`
is the start of the drivers with a loop of their own (``exp_ns``,
``exp_plas``; ``benchmarks/_common.py:188-213``).
"""

from __future__ import annotations

import argparse
import os

from ..data.synthetic import batch_iter
from ..train import Checkpointer, MetricsLogger, Trainer
from .car_train import (add_mesh_args, build_model, check_mesh_args,
                        make_mesh_from_args, maybe_pipeline)

__all__ = ["base_parser", "shrink_for_smoke", "apply_model_args",
           "weighted_eval", "train_and_eval", "init_custom_loop_state",
           "add_mesh_args", "check_mesh_args", "make_mesh_from_args",
           "maybe_pipeline"]


def base_parser(name: str) -> argparse.ArgumentParser:
    """The reference exp_* drivers' flags (``benchmarks/_common.py:16-50``)
    and ``--device``."""
    p = argparse.ArgumentParser(name)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--weight_decay", type=float, default=1e-5)
    p.add_argument("--batch-size", type=int, default=4, dest="batch_size")
    p.add_argument("--n-hidden", type=int, default=128, dest="n_hidden")
    p.add_argument("--n-layers", type=int, default=8, dest="n_layers")
    p.add_argument("--n-heads", type=int, default=8, dest="n_heads")
    p.add_argument("--slice_num", type=int, default=64)
    p.add_argument("--mlp_ratio", type=int, default=1)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=None)
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: microbatches per optimizer "
                        "step (must divide --batch-size)")
    p.add_argument("--unified_pos", type=int, default=0)
    p.add_argument("--ref", type=int, default=8)
    p.add_argument("--ntrain", type=int, default=1000)
    p.add_argument("--ntest", type=int, default=200)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--mu_bf16", type=int, default=0,
                   help="store Adam's first moment in bfloat16")
    p.add_argument("--use_checkpoint", type=int, default=0,
                   help="recompute each block in the backward pass")
    p.add_argument("--data_path", type=str, default="./data/fno")
    p.add_argument("--out_dir", type=str, default="./runs")
    p.add_argument("--save_name", type=str, default=name)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    add_mesh_args(p)
    return p


def shrink_for_smoke(args):
    """``--smoke``: 2 epochs of a 2-layer, 32-wide, 4-head, G 16 model on 8
    training and 4 test samples, batch 2."""
    args.epochs = 2
    args.n_hidden = 32
    args.n_layers = 2
    args.n_heads = 4
    args.slice_num = 16
    args.batch_size = 2
    args.ntrain, args.ntest = 8, 4
    return args


def apply_model_args(cfg, args):
    """The flags into the preset ``cfg`` (``_common.py:64-88``); a
    ``cosine_annealing`` preset's ``t_max`` follows the epoch count, as the
    reference's ``CosineAnnealingLR(T_max=epochs)``."""
    cfg.train.lr = args.lr
    cfg.train.weight_decay = args.weight_decay
    cfg.train.epochs = args.epochs
    if cfg.train.t_max is not None:
        cfg.train.t_max = args.epochs
    cfg.train.batch_size = args.batch_size
    cfg.train.max_grad_norm = args.max_grad_norm
    cfg.train.accum_steps = args.accum_steps
    cfg.train.mu_bf16 = bool(args.mu_bf16)
    cfg.model.n_hidden = args.n_hidden
    cfg.model.n_layers = args.n_layers
    cfg.model.n_head = args.n_heads
    cfg.model.slice_num = args.slice_num
    cfg.model.mlp_ratio = args.mlp_ratio
    cfg.model.dropout = args.dropout
    cfg.model.unified_pos = bool(args.unified_pos)
    cfg.model.ref = args.ref
    cfg.model.bf16 = bool(args.bf16)
    cfg.model.use_checkpoint = bool(args.use_checkpoint)
    return cfg


def weighted_eval(trainer, test: dict, bs: int) -> float:
    """The per-SAMPLE mean eval loss over the whole test set
    (``_common.py:262-279``): the reference sums per-sample losses and
    divides by ntest, so a trailing partial batch weighs by its size."""
    tot, n = 0.0, 0
    for b in batch_iter(test, bs, False)():
        k = len(next(iter(b.values())))
        tot += float(trainer.eval_step(b)["loss"]) * k
        n += k
    return tot / max(n, 1)


def train_and_eval(cfg, args, dev, name: str, train: dict, test: dict,
                   loss_fn, batch_args, eval_fn=None, resume: bool = False,
                   seed: int = 0) -> tuple:
    """Build ``cfg.model`` on ``dev`` (both kernel flags), train it with
    ``Trainer.fit`` over ``batch_iter(train)`` (shuffled, seed 1; the
    partial last batch kept, so ``ceil(n / bs)`` steps per epoch) with eval
    on ``test`` every epoch, ``<out_dir>/<name>_metrics.jsonl`` and
    checkpoints under ``<out_dir>/checkpoints/<name>``, then print and
    return the final per-sample ``rel_err``. Over the flags' mesh, if any
    (the log and checkpoints by rank 0). Returns ``(rel_err,
    trainer)``."""
    bs = cfg.train.batch_size
    mesh = make_mesh_from_args(cfg.model, cfg.train, args)
    model = maybe_pipeline(build_model(cfg.model, dev, seed=seed), mesh,
                           args)
    steps = max(1, -(-len(next(iter(train.values()))) // bs))
    trainer = Trainer(model, loss_fn, cfg.train,
                      total_steps=steps * cfg.train.epochs,
                      batch_args=batch_args, eval_fn=eval_fn, mesh=mesh)
    print(f"Total Trainable Params: {trainer.num_params()}", flush=True)
    ckpt = Checkpointer(os.path.join(args.out_dir, "checkpoints", name))
    if resume:
        trainer.maybe_restore(ckpt)
    with MetricsLogger(os.path.join(args.out_dir,
                                    f"{name}_metrics.jsonl")) as logger:
        trainer.fit(batch_iter(train, bs, True, 1),
                    batch_iter(test, bs, False), logger=logger,
                    checkpointer=ckpt)
    rel = weighted_eval(trainer, test, bs)
    print(f"rel_err:{rel}", flush=True)
    return rel, trainer


def init_custom_loop_state(cfg, args, dev, n_train: int, wrap, loss_fn,
                           batch_args, eval_fn=None) -> tuple:
    """The state of a driver with its own loop over the model
    (``benchmarks/_common.py:188-213``): ``cfg.model`` on ``dev`` with both
    kernel flags and seeded from ``cfg.train.seed``, wrapped by ``wrap``
    (a module that runs the model as the loop needs: the NS rollout, the
    plasticity time queries), and a :class:`Trainer` over the wrapper,
    whose optimizer and schedule are ``cfg.train``'s over ``ceil(n_train /
    batch) * epochs`` steps, built as every driver's are. The trainer is
    ``eager``: each step runs op by op (no CUDA graph). Over the flags'
    mesh, if any (:func:`make_mesh_from_args`; call
    :func:`check_mesh_args` first). Returns ``(model, trainer)``."""
    bs = cfg.train.batch_size
    mesh = make_mesh_from_args(cfg.model, cfg.train, args)
    model = maybe_pipeline(build_model(cfg.model, dev, seed=cfg.train.seed),
                           mesh, args)
    steps = max(1, -(-n_train // bs))  # ceil: the partial batch is kept
    trainer = Trainer(wrap(model), loss_fn, cfg.train,
                      total_steps=steps * cfg.train.epochs,
                      batch_args=batch_args, eval_fn=eval_fn, eager=True,
                      mesh=mesh)
    print(f"Total Trainable Params: {trainer.num_params()}", flush=True)
    return model, trainer
