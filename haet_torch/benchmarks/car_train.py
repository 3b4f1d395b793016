"""ShapeNet-Car aerodynamics benchmark: training + evaluation.

    python -m haet_torch.benchmarks.car_train [--smoke] [--device cpu]

Counterpart of ``benchmarks/car_train.py:129-245``, with its flags: the car
preset (2 layers, n_hidden 256, 8 heads, G 32, Erwin depths 4/4/4) with
both kernel flags set, the car loss ``MSE(velocity) + 0.5 *
MSE(surface pressure)``, Adam + OneCycle, clipping at 1.0 and early
stopping after 7 evals without improvement, through ``Trainer.fit`` (eval
on the held-out fold every epoch, ``best``/``last`` checkpoints under
``<out_dir>/checkpoints/car``, metrics in ``<out_dir>/car_metrics.jsonl``);
then :func:`haet_torch.train.car.evaluate` of the final state (the one
``last`` holds) on the validation fold. ``--smoke`` runs 2 epochs at
n_hidden 32, 1 layer (one per stage with ``--pp``), G 16, 4 heads and the
Erwin defaults.

Data: the fold layout under ``--data_dir`` (``param0..8/<sample>/``), or
the synthetic stand-in when it is absent. Batches are one sample each,
padded to its 2048-point bucket, assembled in a background thread
(``--prefetch``). The shuffle is one ``RandomState(0)`` made on each
``main()``, outside the batch factory, as in the JAX driver: a resumed run
(``--resume``) therefore replays epoch 0's order from its first resumed
epoch on. ``Trainer.fit`` resumes exactly for a given order.

``--bf16 1`` builds the model in the bf16 compute dtype over float32
parameters and ``--mu_bf16 1`` stores Adam's first moment in bf16, as the
JAX driver's flags do (``benchmarks/car_train.py:136-137``); both default
to 0, as there.

The card is the default device; ``--device cpu`` runs on the CPU.

``--dp``, ``--tp``, ``--pp``, ``--pp_microbatches`` and ``--multihost``
(:func:`add_mesh_args`, the JAX drivers' ``benchmarks/_common.py:88-198``)
train over a mesh, one process per rank, each loading the same data:
launch one process per rank under torchrun or with ``HAET_COORDINATOR``/
``HAET_NUM_PROCESSES``/``HAET_PROCESS_ID`` set (``README.md``). NCCL joins
ranks on cards, gloo on the CPU (``--device cpu``). A batch of one sample,
the car's, is not split over dp: each step replicates it, and the note
says so. ``--pp S`` runs the block stack as an S-stage GPipe pipeline
(:func:`maybe_pipeline`, :class:`~haet_torch.parallel.pipeline.
PipelinedModel`) on a ``(dp, pp)`` or ``(dp, pp, tp)`` mesh; its
checkpoints hold the stacked layout, which ``car_eval`` converts.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import parallel
from ..data import Prefetcher, shapenet_car
from ..train import Checkpointer, MetricsLogger, Trainer
from ..train.car import evaluate, loss_fn_builder, make_batch
from ..utils.config import shapenet_car_config, shapenet_car_train_config
from ..utils.env import default_device

def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """The JAX drivers' mesh flags (``benchmarks/_common.py:96-109``)."""
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh size (0 = no mesh)")
    p.add_argument("--tp", type=int, default=1,
                   help="head tensor-parallel mesh size (n_heads %% tp == 0)")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline-parallel stage count over the block stack "
                        "(requires n_layers %% pp == 0; composes with --dp "
                        "and --tp on a (dp, pp, tp) mesh)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipelined step (0 = one per "
                        "stage)")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of HAET_COORDINATOR / "
                        "HAET_NUM_PROCESSES / HAET_PROCESS_ID or torchrun's "
                        "variables first")


def _mesh_size(args) -> tuple:
    """``(dp, pp, tp)`` the flags ask for, ``(0, 1, 1)`` for no mesh:
    ``--tp`` or ``--pp`` without ``--dp`` means dp 1, as in JAX."""
    n_tp = max(1, args.tp)
    n_pp = max(1, getattr(args, "pp", 1))
    if not args.dp and n_tp <= 1 and n_pp <= 1:
        return 0, 1, 1
    return args.dp or 1, n_pp, n_tp


def check_mesh_args(args) -> None:
    """Check the mesh flags and join the process group they ask for, before
    anything is made on the card (:func:`parallel.init_distributed` binds
    this rank to its card)."""
    if args.multihost and not parallel.cluster_configured():
        raise SystemExit("--multihost needs a cluster to join: set "
                         "HAET_COORDINATOR, HAET_NUM_PROCESSES and "
                         "HAET_PROCESS_ID, or launch under torchrun")
    n_dp, n_pp, n_tp = _mesh_size(args)
    n = parallel.requested_world()
    if n_dp and n_dp * n_pp * n_tp != n:
        what = (f"--dp {n_dp} x --pp {n_pp} x --tp {n_tp}" if n_pp > 1
                else f"--dp {n_dp} x --tp {n_tp}")
        raise SystemExit(f"{what} needs {n_dp * n_pp * n_tp} devices, have "
                         f"{n} (one rank each)")
    if n_dp or args.multihost:
        parallel.init_distributed(device=args.device)


def make_mesh_from_args(model_cfg, train_cfg, args):
    """The mesh of the flags (``benchmarks/_common.py:112-185``): ``(dp,
    tp)``, or with ``--pp`` > 1 ``(dp, pp)`` / ``(dp, pp, tp)``; None
    without ``--dp``/``--tp``/``--pp``. With tp > 1 sets
    ``model_cfg.shard_axes``. Raises SystemExit where pp does not divide
    the layers or tp the heads; prints a note where the batch does not
    divide dp (or the pipeline's microbatches x dp). Call
    :func:`check_mesh_args` first."""
    n_dp, n_pp, n_tp = _mesh_size(args)
    if not n_dp:
        return None
    if n_pp > 1 and model_cfg.n_layers % n_pp:
        raise SystemExit(
            f"--pp {n_pp} must divide n_layers ({model_cfg.n_layers})")
    if n_tp > 1:
        if model_cfg.n_head % n_tp:
            raise SystemExit(
                f"--tp {n_tp} must divide n_heads ({model_cfg.n_head})")
        model_cfg.shard_axes = ("dp", "tp")
    if n_pp > 1:
        mesh = parallel.make_pp_mesh(n_dp, n_pp, n_tp)
        mb = getattr(args, "pp_microbatches", 0) or n_pp
        if train_cfg.batch_size % (mb * n_dp):
            print(f"[mesh] note: batch size {train_cfg.batch_size} is not "
                  f"divisible by pp_microbatches x dp ({mb} x {n_dp}); "
                  "every step will pad (wasted compute)", flush=True)
        print(f"[mesh] dp={n_dp} pp={n_pp} tp={n_tp} microbatches={mb} "
              f"({n_dp * n_pp * n_tp} ranks, {mesh.backend})", flush=True)
        return mesh
    mesh = parallel.make_mesh(n_dp, n_tp)
    if train_cfg.batch_size % n_dp:
        print(f"[mesh] note: batch size {train_cfg.batch_size} is not "
              f"divisible by the dp mesh size {n_dp}; every step replicates "
              "its batch over dp (no dp speedup)", flush=True)
    print(f"[mesh] dp={n_dp} tp={n_tp} ({n_dp * n_tp} ranks, "
          f"{mesh.backend})", flush=True)
    return mesh


def maybe_pipeline(model, mesh, args):
    """``model`` as a :class:`~haet_torch.parallel.pipeline.PipelinedModel`
    over ``mesh`` when ``--pp`` > 1 (``benchmarks/_common.py:188-198``),
    else ``model``: the trainer takes either unchanged."""
    if mesh is None or getattr(args, "pp", 1) <= 1:
        return model
    from ..parallel.pipeline import PipelinedModel

    mb = getattr(args, "pp_microbatches", 0) or None
    return PipelinedModel(model, mesh, num_microbatches=mb, dp_axis="dp")


def model_config(args):
    """The car preset's model config sized by ``args``, in bf16 with
    ``car_train --bf16 1`` (``car_eval`` has no such flag and builds it in
    float32, as the JAX driver does; ``--smoke`` resets the preset's
    pinned 8-head Erwin sizing to the defaults, which scale with
    ``n_head``)."""
    cfg = shapenet_car_config()
    cfg.n_hidden = args.n_hidden
    cfg.n_layers = args.n_layers
    cfg.slice_num = args.slice_num
    cfg.bf16 = bool(getattr(args, "bf16", 0))
    if args.smoke:
        cfg.n_head = 4
        cfg.enc_num_heads = cfg.enc_depths = None
        cfg.dec_num_heads = cfg.dec_depths = None
        cfg.erwin_mlp_ratio = None
        cfg.embed = False
    return cfg


def build_model(cfg, device, seed: int = 0):
    """The model of ``cfg`` (any variant) on ``device`` with both kernel
    flags set."""
    kw = cfg.model_kwargs()
    kw["use_pallas"] = True
    return cfg.model_class()(**kw, use_pallas_erwin=True, device=device,
                             seed=seed)


def load_fold(args):
    """``(train, val, coef, is_synthetic)`` of ``--data_dir`` and
    ``--fold_id``, normalised by the training fold's statistics."""
    return shapenet_car.load_train_val_fold(
        args.data_dir, args.fold_id, savedir=args.save_dir,
        preprocessed=args.preprocessed)


def print_metrics(metrics: dict) -> None:
    print("relative l2 error press:", metrics["rel_l2_press"])
    print("relative l2 error velo:", metrics["rel_l2_velo"])
    print("press:", metrics["rmse_press"])
    print("velo:", metrics["rmse_velo"])
    if "rho_d" in metrics:
        print("rho_d:", metrics["rho_d"], "c_d:", metrics["cd_rel_err"])
    print("time:", metrics["time_per_sample"], flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_mesh_args(args)
    dev = default_device(args.device)
    cfg = model_config(args)
    train_cfg = shapenet_car_train_config()
    train_cfg.epochs = args.epochs
    train_cfg.lr = args.lr
    train_cfg.mu_bf16 = bool(args.mu_bf16)
    mesh = make_mesh_from_args(cfg, train_cfg, args)

    train_s, val_s, coef, is_synth = load_fold(args)
    if is_synth:
        print("[car_train] dataset not found -> synthetic stand-in data")
    print(f"train {len(train_s)} / val {len(val_s)} samples", flush=True)
    model = maybe_pipeline(build_model(cfg, dev, train_cfg.seed), mesh, args)
    trainer = Trainer(model, loss_fn_builder(args.weight), train_cfg,
                      total_steps=len(train_s) * train_cfg.epochs,
                      batch_args=lambda b: (b["x"], None), mesh=mesh)
    print(f"nb_parameters {trainer.num_params()}", flush=True)

    ckpt = Checkpointer(os.path.join(args.out_dir, "checkpoints", "car"))
    if args.resume:
        trainer.maybe_restore(ckpt)

    # one RandomState outside the factory: fit() calls train_batches()
    # every epoch, and a re-seeded one would replay one order every epoch
    shuffle_rng = np.random.RandomState(0)

    def train_batches():
        for i in shuffle_rng.permutation(len(train_s)):
            yield make_batch(train_s[i])

    def eval_batches():
        for s in val_s:
            yield make_batch(s)

    with MetricsLogger(os.path.join(args.out_dir,
                                    "car_metrics.jsonl")) as logger:
        trainer.fit(Prefetcher(train_batches, depth=args.prefetch)
                    if args.prefetch else train_batches,
                    eval_batches, logger=logger, checkpointer=ckpt)
        metrics = evaluate(model, val_s, coef, logger)
    print_metrics(metrics)
    return metrics


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="haet_torch ShapeNet-Car")
    p.add_argument("--data_dir", type=str,
                   default="./data/shapenet_car/mlcfd_data/training_data")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--preprocessed", action="store_true")
    p.add_argument("--fold_id", type=int, default=0)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight", type=float, default=0.5)
    p.add_argument("--n_hidden", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--slice_num", type=int, default=32)
    p.add_argument("--bf16", type=int, default=0)
    p.add_argument("--mu_bf16", type=int, default=0,
                   help="store Adam's first moment in bfloat16")
    p.add_argument("--out_dir", type=str, default="./runs")
    p.add_argument("--prefetch", type=int, default=2,
                   help="background batch prefetch depth (0 disables)")
    add_mesh_args(p)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs = 2
        args.n_hidden = 32
        # one layer, or one per pipeline stage
        args.n_layers = max(1, args.pp)
        args.slice_num = 16
    return args


if __name__ == "__main__":
    main()
