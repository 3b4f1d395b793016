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

A checkpoint of a ``car_train --pp`` run (the stacked pipeline layout) is
converted to the plain model's by
:func:`~haet_torch.parallel.pipeline.merge_raw_variables`, as the JAX
driver converts it (``benchmarks/car_eval.py:81-96``).

``--torch_checkpoint PT`` evaluates a checkpoint the reference code
trained (a torch ``.pt``, bare or ``{"model_state_dict": ...}``) instead,
read by :func:`haet_torch.utils.torch_import.load_torch_checkpoint`.
``--scatter`` plots the predicted against the true drag coefficient
(``<out_dir>/cd_scatter.png``; it shares ``--save_preds``' prediction
pass), and ``--visualize`` writes the reference's slice-weight renders of
the first validation sample (:func:`haet_torch.utils.visualization.
visualize_car_and_slices`, at most ``--max_slice_figs`` per-slice figures)
under ``<out_dir>/visualizations``; both need matplotlib.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.car_metrics import drag_coefficient
from ..parallel.pipeline import merge_raw_variables
from ..train import Checkpointer
from ..train.car import evaluate, make_batch, predict
from ..utils.env import default_device
from ..utils.torch_import import load_torch_checkpoint
from ..utils.visualization import get_slice_weights, visualize_car_and_slices
from .car_train import build_model, load_fold, model_config


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = default_device(args.device)
    _, val_s, coef, _ = load_fold(args)
    model = build_model(model_config(args), dev)
    if args.torch_checkpoint:
        # a checkpoint trained by the reference code (a torch .pt), read
        # through the reference-schema importer
        model.load_state_dict(load_torch_checkpoint(args.torch_checkpoint,
                                                    model))
        print(f"[car_eval] imported reference torch checkpoint "
              f"{args.torch_checkpoint}", flush=True)
    else:
        state = Checkpointer(args.checkpoint_dir).restore(args.which,
                                                          map_location=dev)
        if state is None:
            print(f"[car_eval] no checkpoint at {args.checkpoint_dir}/"
                  f"{args.which} — evaluating the random init", flush=True)
        elif any(k.startswith("layers.") for k in state["model"]):
            # a --pp run's stacked pipeline layout (pre, layers, head):
            # converted to the plain model's blocks
            model.load_state_dict(merge_raw_variables(state))
            print("[car_eval] converted a --pp pipeline-layout checkpoint "
                  "to the plain model layout", flush=True)
        else:
            model.load_state_dict(state["model"])

    metrics = evaluate(model, val_s, coef)
    print("relative l2 error press:", metrics["rel_l2_press"])
    print("relative l2 error velo:", metrics["rel_l2_velo"])
    if "rho_d" in metrics:
        print("rho_d:", metrics["rho_d"])
        print("c_d:", metrics["cd_rel_err"])
    print("time:", metrics["time_per_sample"], flush=True)

    # save_preds and scatter share one prediction pass over the fold
    scatter = args.scatter and "rho_d" in metrics
    if args.save_preds or scatter:
        cds = predictions_pass(args, model, val_s, coef, scatter)
        if scatter:
            plot_cd_scatter(*cds, metrics["rho_d"], args.out_dir)

    if args.export_artifact:
        export(args, model, val_s[0])

    if args.visualize:
        # the reference's artifact set (visualization.py:20-260) on the
        # first validation sample's surface points
        s = val_s[0]
        x = torch.from_numpy(make_batch(s)["x"]).to(dev)
        w = get_slice_weights(model, x, None)
        vis_dir = os.path.join(args.out_dir, "visualizations")
        visualize_car_and_slices(s, w, vis_dir, sample_idx=0,
                                 max_slice_figs=args.max_slice_figs)
        print(f"slice visualizations -> {vis_dir}", flush=True)
    return metrics


def predictions_pass(args, model, samples, coef, scatter: bool):
    """One prediction per sample: ``--save_preds``' denormalised dumps
    (reference ``main_evaluation.py:252, 297-298``) and, with ``scatter``,
    the predicted and true drag coefficients of the samples with surface
    quads. Returns ``(true Cd list, predicted Cd list)``."""
    results_dir = os.path.join(args.out_dir, "results")
    if args.save_preds:
        os.makedirs(results_dir, exist_ok=True)
    cds_g, cds_p = [], []
    for idx, s in enumerate(samples):
        od = coef.decode_y(predict(model, make_batch(s))[0][:len(s.pos)])
        yd = coef.decode_y(s.y)
        if args.save_preds:
            np.save(os.path.join(results_dir, f"{idx}_pred.npy"), od)
            np.save(os.path.join(results_dir, f"{idx}_gt.npy"), yd)
        # surf_slice=None would make pos[surf_slice] a newaxis index (a
        # wrong Cd, not an error): skip such samples, as evaluate() does
        if scatter and s.quads is not None and s.surf_slice is not None:
            pts = s.pos[s.surf_slice]
            cds_p.append(drag_coefficient(pts, s.quads,
                                          od[s.surf_slice, 3],
                                          od[s.surf_slice, :3]))
            cds_g.append(drag_coefficient(pts, s.quads,
                                          yd[s.surf_slice, 3],
                                          yd[s.surf_slice, :3]))
    if args.save_preds:
        print(f"per-sample predictions -> {results_dir} "
              f"({len(samples)} samples)", flush=True)
    return cds_g, cds_p


def plot_cd_scatter(cds_g, cds_p, rho_d: float, out_dir: str) -> str:
    """The predicted-against-true Cd scatter (reference
    ``main_evaluation.py:360-417``) as ``out_dir/cd_scatter.png``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(cds_g, cds_p, s=16)
    lo, hi = min(cds_g + cds_p), max(cds_g + cds_p)
    ax.plot([lo, hi], [lo, hi], "k--", lw=1)
    ax.set_xlabel("true Cd")
    ax.set_ylabel("predicted Cd")
    ax.set_title(f"rho_d={rho_d:.3f}")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "cd_scatter.png")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    print(f"Cd scatter -> {path}", flush=True)
    return path


def export(args, model, sample) -> str:
    """The serving artifact or point-bucket family of ``--export_artifact``
    (``benchmarks/car_eval.py:166-205``) over ``model``'s weights."""
    from ..export import save_artifact
    from ..serve import export_point_family

    x = make_batch(sample)["x"]
    # where the weights came from
    provenance = {"fold_id": args.fold_id,
                  "checkpoint": (f"torch:{args.torch_checkpoint}"
                                 if args.torch_checkpoint else args.which)}
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
    p.add_argument("--torch_checkpoint", type=str, default=None,
                   help="evaluate a reference-trained torch .pt checkpoint")
    p.add_argument("--which", type=str, default="best",
                   choices=["best", "last"])
    p.add_argument("--n_hidden", type=int, default=256)
    p.add_argument("--n_layers", type=int, default=2)
    p.add_argument("--slice_num", type=int, default=32)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--max_slice_figs", type=int, default=None,
                   help="cap per-slice dominance figures (None = all G, "
                        "as the reference)")
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
