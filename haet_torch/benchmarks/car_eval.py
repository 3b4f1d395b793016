"""ShapeNet-Car evaluation CLI.

    python -m haet_torch.benchmarks.car_eval [--which last] [--device cpu]

Counterpart of ``benchmarks/car_eval.py:32-267``, with its flags: loads the
model part of the checkpoint ``--which`` (``best`` by default) that
``car_train`` wrote under ``--checkpoint_dir`` into a fresh car model
(both kernel flags set) and reports :func:`haet_torch.train.car.evaluate`
on the validation fold: per-sample rel-L2 of surface pressure and exterior
velocity, the denormalised RMSEs, the drag coefficient's relative error
and Spearman rho, and the time per sample. No optimizer is built: the JAX
driver's eval ``Trainer`` exists only to hold its state. ``--save_preds``
writes each sample's denormalised prediction and target to
``<out_dir>/results/{i}_pred.npy`` and ``{i}_gt.npy``. ``--smoke`` resets
the Erwin sizing as ``car_train --smoke`` does; the widths come from
``--n_hidden``, ``--n_layers`` and ``--slice_num``. It evaluates in
float32, as the JAX driver does, whatever dtype ``car_train`` computed in:
the checkpoint's parameters are float32 either way.

``--export_artifact DIR`` then writes the evaluated model's eval forward as a
serving artifact (:mod:`haet_torch.export`) at the first validation
sample's shape, padded to its 2048-point bucket: ``DIR/b1_n{N}``, batch 1.
With ``--export_point_buckets 32768,34816`` it writes a point-bucket family
instead (:func:`haet_torch.serve.export_point_family`, batch sizes 1, 2
and 4 per bucket) under ``DIR``, which ``serve_http --pad_to_points 1``
serves to a ragged fold. Each manifest records the fold and the checkpoint
the weights came from.

Not ported yet, and raising with their ``ROADMAP.md`` item:
``--torch_checkpoint``, ``--visualize``, ``--scatter`` and
``--max_slice_figs`` (queue 1: the rest of the drivers and utils).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train import Checkpointer
from ..train.car import evaluate, make_batch, predict
from ..utils.env import default_device
from .car_train import build_model, load_fold, model_config

UTILS_TODO = ("{} is not ported yet (ROADMAP.md, queue 1: the rest of the "
              "drivers and utils)")


def check_unported(args) -> None:
    for flag in ("torch_checkpoint", "max_slice_figs"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(UTILS_TODO.format(f"--{flag}"))
    for flag in ("visualize", "scatter"):
        if getattr(args, flag):
            raise NotImplementedError(UTILS_TODO.format(f"--{flag}"))


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_unported(args)
    dev = default_device(args.device)
    _, val_s, coef, _ = load_fold(args)
    model = build_model(model_config(args), dev)
    state = Checkpointer(args.checkpoint_dir).restore(args.which,
                                                      map_location=dev)
    if state is None:
        print(f"[car_eval] no checkpoint at {args.checkpoint_dir}/"
              f"{args.which} — evaluating the random init", flush=True)
    else:
        model.load_state_dict(state["model"])

    metrics = evaluate(model, val_s, coef)
    print("relative l2 error press:", metrics["rel_l2_press"])
    print("relative l2 error velo:", metrics["rel_l2_velo"])
    if "rho_d" in metrics:
        print("rho_d:", metrics["rho_d"])
        print("c_d:", metrics["cd_rel_err"])
    print("time:", metrics["time_per_sample"], flush=True)

    if args.save_preds:
        # reference main_evaluation.py:252, 297-298
        results_dir = os.path.join(args.out_dir, "results")
        os.makedirs(results_dir, exist_ok=True)
        for idx, s in enumerate(val_s):
            out = predict(model, make_batch(s))[0][:len(s.pos)]
            np.save(os.path.join(results_dir, f"{idx}_pred.npy"),
                    coef.decode_y(out))
            np.save(os.path.join(results_dir, f"{idx}_gt.npy"),
                    coef.decode_y(s.y))
        print(f"per-sample predictions -> {results_dir} "
              f"({len(val_s)} samples)", flush=True)

    if args.export_artifact:
        export(args, model, val_s[0])
    return metrics


def export(args, model, sample) -> str:
    """The serving artifact or point-bucket family of ``--export_artifact``
    (``benchmarks/car_eval.py:166-205``) over ``model``'s weights."""
    from ..export import save_artifact
    from ..serve import export_point_family

    x = make_batch(sample)["x"]
    provenance = {"fold_id": args.fold_id, "checkpoint": args.which}
    if args.export_point_buckets:
        buckets = sorted(int(b) for b in args.export_point_buckets.split(","))
        path = export_point_family(
            args.export_artifact, model, model.state_dict(), (x, None),
            point_buckets=buckets, batch_sizes=(1, 2, 4),
            extra_manifest=provenance)
        print(f"serving point-bucket family ({buckets}) -> {path}",
              flush=True)
    else:
        path = save_artifact(
            os.path.join(args.export_artifact, f"b1_n{x.shape[1]}"), model,
            model.state_dict(), (x, None), extra_manifest=provenance)
        print(f"serving artifact -> {path}", flush=True)
    return path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="haet_torch ShapeNet-Car evaluation")
    p.add_argument("--data_dir", type=str,
                   default="./data/shapenet_car/mlcfd_data/training_data")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--preprocessed", action="store_true")
    p.add_argument("--fold_id", type=int, default=0)
    p.add_argument("--checkpoint_dir", type=str,
                   default="./runs/checkpoints/car")
    p.add_argument("--torch_checkpoint", type=str, default=None)
    p.add_argument("--which", type=str, default="best",
                   choices=["best", "last"])
    p.add_argument("--n_hidden", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--slice_num", type=int, default=32)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--max_slice_figs", type=int, default=None)
    p.add_argument("--scatter", action="store_true")
    p.add_argument("--save_preds", action="store_true",
                   help="save per-sample denormalised pred/gt .npy dumps "
                        "into out_dir/results")
    p.add_argument("--out_dir", type=str, default="./runs")
    p.add_argument("--export_artifact", type=str, default=None,
                   help="write a serving artifact (or, with "
                        "--export_point_buckets, a bucket family) here")
    p.add_argument("--export_point_buckets", type=str, default=None,
                   help="comma-separated point buckets, e.g. 32768,34816")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main()
