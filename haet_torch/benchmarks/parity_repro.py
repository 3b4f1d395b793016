"""One-command real-data parity reproduction of the port.

    python -m haet_torch.benchmarks.parity_repro --data_root ./data \
        [--tasks car,pipe,elas,ns,darcy,airfoil,plas] [--epochs N] \
        [--out PARITY.md] [--torch_checkpoint PT] [--car_flags "..."] \
        [--pde_flags "..."]

Counterpart of ``benchmarks/parity_repro.py``: runs the reference configs
of every task (ShapeNet-Car fold 0 for 200 epochs, and the six PDE
benchmarks) and writes a BASELINE.md-format markdown table whose rows line
up with the reference's numbers (:data:`REFERENCE`: Pipe, Elasticity and
Navier-Stokes are parity rows; Darcy, Airfoil and Plasticity, which the
reference never completed, are record rows). Each task shells out to the
port's own driver CLI (``python -m haet_torch.benchmarks.<driver>``) with
the flags of the JAX package's launcher scripts
(``benchmarks/scripts/*.sh``), so the table reproduces with no hidden glue.
``--car_flags`` and ``--pde_flags`` are appended last, so they win: e.g.
``--device cpu`` reaches every driver, or small sizes in a quick run.

The real datasets are not in this repository and nothing here downloads
them (``fetch_datasets.py`` stays with the JAX package); without them the
drivers run on their synthetic stand-ins or, with ``--data_root
tests/fixtures/data``, on the committed fixtures, which makes the table a
smoke test of the path, not a parity result. ``--epochs`` marks the table
as not the reference schedule. One failing task becomes a FAILED row and
the others go on; the table is rewritten after every task.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PROG = "python -m haet_torch.benchmarks.parity_repro"

# (task, metric label, reference value, reference source)
REFERENCE = {
    "car": [
        ("rel-L2 pressure", 0.09144, "transolver_erwin_eval.out"),
        ("rel-L2 velocity", 0.02578, "transolver_erwin_eval.out"),
        ("Spearman rho_d", 0.98647, "transolver_erwin_eval.out"),
    ],
    "pipe": [("rel-L2", 0.00505, "overall_results.md:7")],
    "elas": [("rel-L2", 0.10848, "overall_results.md:9")],
    "ns": [("rel-L2", 0.16251, "overall_results.md:11")],
    # the reference NEVER produced numbers for these three — airfoil
    # "done with problems on loss", plasticity "training never starts
    # after 8h" (overall_results.md:8,10), darcy's launcher points at a
    # missing exp_darcy2.py (HAET_Darcy.sh:19). Their rows record OUR
    # result so the first data-equipped run SUPERSEDES the reference's
    # record instead of merely matching it.
    "darcy": [("rel-L2", None,
               "no committed reference number (HAET_Darcy.sh broken) — "
               "recording ours")],
    "airfoil": [("rel-L2", None,
                 "no committed reference number (overall_results.md:8 "
                 "'problems on loss') — recording ours")],
    "plas": [("rel-L2", None,
              "no committed reference number (overall_results.md:10 "
              "'training never starts') — recording ours")],
}

_REL_ERR = re.compile(r"rel_err:([\d.eE+-]+)")


def _parse_rel(out, log_path):
    m = _REL_ERR.search(out)
    if not m:
        raise RuntimeError(
            "driver finished but printed no 'rel_err:' line — output "
            f"format drift or truncated stdout; full log: {log_path}")
    return float(m.group(1))


_CAR_LINES = {
    "rel-L2 pressure": re.compile(r"relative l2 error press:\s*([\d.eE+-]+)"),
    "rel-L2 velocity": re.compile(r"relative l2 error velo:\s*([\d.eE+-]+)"),
    "Spearman rho_d": re.compile(r"rho_d:\s*([\d.eE+-]+)"),
}


def _driver(name: str) -> list:
    """The command that runs the port's driver ``name``."""
    return [sys.executable, "-m", f"haet_torch.benchmarks.{name}"]


def _run(cmd, log_path):
    """Run a driver command (the repository's root on its import path),
    tee its output to the console and a log; returns its stdout."""
    print("+", " ".join(cmd), flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, env=env)
    with open(log_path, "w") as f:
        f.write(proc.stdout)
    tail = proc.stdout[-2000:]
    print(tail, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"driver failed (exit {proc.returncode}); full log: {log_path}")
    return proc.stdout


def _pde_cmd(driver, data_root, workdir, flags, args):
    """A PDE driver's command: the launcher script's flags, then
    ``--epochs``, then ``--pde_flags`` last."""
    cmd = _driver(driver) + ["--data_path", data_root,
                             "--out_dir", workdir] + flags
    if args.epochs:
        cmd += ["--epochs", str(args.epochs)]
    if args.pde_flags:
        cmd += args.pde_flags.split()  # appended last: overrides win
    return cmd


def run_pipe(args, workdir):
    # scripts/HAET_Pipe.sh == reference scripts/Transolver_Pipe.sh flags
    out = _run(_pde_cmd("exp_pipe", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "8", "--mlp_ratio", "2",
        "--n-hidden", "128", "--n-layers", "8", "--n-heads", "8",
        "--slice_num", "64", "--max_grad_norm", "0.1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "pipe.log"))
    return {"rel-L2": _parse_rel(out, os.path.join(workdir, "pipe.log"))}


def run_elas(args, workdir):
    out = _run(_pde_cmd("exp_elas", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "1", "--n-hidden", "128",
        "--n-layers", "8", "--n-heads", "8", "--slice_num", "128",
        "--max_grad_norm", "0.1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "elas.log"))
    return {"rel-L2": _parse_rel(out, os.path.join(workdir, "elas.log"))}


def run_ns(args, workdir):
    out = _run(_pde_cmd("exp_ns", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "2", "--n-hidden", "256",
        "--n-layers", "8", "--n-heads", "8", "--slice_num", "32",
        "--unified_pos", "1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "ns.log"))
    return {"rel-L2": _parse_rel(out, os.path.join(workdir, "ns.log"))}


def run_car(args, workdir):
    data_dir = args.car_data_dir or os.path.join(
        args.data_root, "shapenet_car", "training_data")
    train_cmd = _driver("car_train") + [
                 "--data_dir", data_dir, "--fold_id", "0",
                 "--lr", "1e-3", "--weight", "0.5", "--n_hidden", "256",
                 "--n_layers", "2", "--slice_num", "32",
                 "--out_dir", workdir]
    train_cmd += ["--epochs", str(args.epochs or 200)]
    if args.car_flags:
        train_cmd += args.car_flags.split()
    _run(train_cmd, os.path.join(workdir, "car_train.log"))

    eval_cmd = _driver("car_eval") + [
                "--data_dir", data_dir, "--fold_id", "0",
                "--n_hidden", "256", "--n_layers", "2", "--slice_num", "32",
                "--checkpoint_dir",
                os.path.join(workdir, "checkpoints", "car"),
                "--out_dir", workdir]
    if args.car_flags:
        eval_cmd += args.car_flags.split()
    out = _run(eval_cmd, os.path.join(workdir, "car_eval.log"))
    res = {}
    for label, rx in _CAR_LINES.items():
        m = rx.search(out)
        if m:
            res[label] = float(m.group(1))
    missing = [lb for lb in _CAR_LINES if lb not in res
               and lb != "Spearman rho_d"]  # rho_d needs quad meshes
    if missing:
        raise RuntimeError(
            f"car_eval printed no {missing} lines — output format drift; "
            f"full log: {os.path.join(workdir, 'car_eval.log')}")
    if args.torch_checkpoint:
        out_t = _run(eval_cmd + ["--torch_checkpoint",
                                 args.torch_checkpoint],
                     os.path.join(workdir, "car_eval_torchckpt.log"))
        for label, rx in _CAR_LINES.items():
            m = rx.search(out_t)
            if m:
                res[label + " (imported torch ckpt)"] = float(m.group(1))
    return res


def run_darcy(args, workdir):
    # scripts/HAET_Darcy.sh (the reference's own launcher points at a
    # missing exp_darcy2.py — these are the flags it pins)
    out = _run(_pde_cmd("exp_darcy", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "4", "--n-hidden", "128",
        "--n-layers", "8", "--n-heads", "8", "--slice_num", "64",
        "--downsample", "5", "--unified_pos", "1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "darcy.log"))
    return {"rel-L2": _parse_rel(out, os.path.join(workdir, "darcy.log"))}


def run_airfoil(args, workdir):
    # scripts/HAET_Airfoil.sh == reference HAETransolver_Airfoil.sh flags
    out = _run(_pde_cmd("exp_airfoil", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "4", "--n-hidden", "128",
        "--n-layers", "8", "--n-heads", "8", "--slice_num", "64",
        "--max_grad_norm", "0.1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "airfoil.log"))
    return {"rel-L2": _parse_rel(out,
                                 os.path.join(workdir, "airfoil.log"))}


def run_plas(args, workdir):
    # scripts/HAET_Plas.sh == reference HAETransolver_Plas.sh flags
    out = _run(_pde_cmd("exp_plas", args.data_root, workdir, [
        "--lr", "1e-3", "--batch-size", "8", "--n-hidden", "128",
        "--n-layers", "8", "--n-heads", "8", "--slice_num", "64",
        "--max_grad_norm", "0.1",
    ] + (["--epochs", "500"] if not args.epochs else []), args),
        os.path.join(workdir, "plas.log"))
    return {"rel-L2": _parse_rel(out, os.path.join(workdir, "plas.log"))}


RUNNERS = {"car": run_car, "pipe": run_pipe, "elas": run_elas,
           "ns": run_ns, "darcy": run_darcy, "airfoil": run_airfoil,
           "plas": run_plas}


def emit_table(results, args, failures=None) -> str:
    """The markdown table of ``results`` (``{task: {label: value}}``) and
    ``failures`` (``{task: error}``), as ``parity_repro.py:236-263``
    writes it."""
    lines = [
        "# Real-data parity reproduction",
        "",
        f"Command: `{PROG} --data_root "
        f"{args.data_root}"
        + (f" --epochs {args.epochs}" if args.epochs else "") + "`",
        "",
    ]
    if args.epochs:
        lines += [f"**NOTE: epochs overridden to {args.epochs} — NOT the "
                  "reference schedule; numbers are smoke-level only.**", ""]
    lines += ["| Task | Metric | Reference (A100) | This repo | Source |",
              "|---|---|---|---|---|"]
    for task, vals in results.items():
        ref_rows = {label: (val, src) for label, val, src
                    in REFERENCE.get(task, [])}
        for label, ours in vals.items():
            base = label.split(" (")[0]
            ref_val, src = ref_rows.get(base, (None, ""))
            ref_s = f"{ref_val}" if ref_val is not None else "—"
            lines.append(f"| {task} | {label} | {ref_s} | {ours:.5f} "
                         f"| {src} |")
    for task, err in (failures or {}).items():
        lines.append(f"| {task} | — | — | FAILED: {err[:120]} | |")
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser("parity_repro",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", required=True,
                    help="fetch_datasets.py --root directory")
    ap.add_argument("--tasks", default="car,pipe,elas,ns,darcy,airfoil,"
                                       "plas")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the reference epoch counts (CI only)")
    ap.add_argument("--workdir", default="./runs/parity")
    ap.add_argument("--out", default="PARITY.md")
    ap.add_argument("--torch_checkpoint", default=None,
                    help="reference .pt to import-evaluate on car")
    ap.add_argument("--car_data_dir", default=None,
                    help="override the car training_data dir")
    ap.add_argument("--car_flags", default=None,
                    help="extra flags for car_train/car_eval (CI fixtures)")
    ap.add_argument("--pde_flags", default=None,
                    help="extra flags appended to the PDE driver calls "
                         "(appended last, so they override)")
    args = ap.parse_args(argv)

    tasks = [t.strip() for t in args.tasks.split(",") if t.strip()]
    if not tasks:
        raise SystemExit(f"--tasks selected nothing "
                         f"(got {args.tasks!r}); "
                         f"choose from {sorted(RUNNERS)}")
    for task in tasks:
        if task not in RUNNERS:
            raise SystemExit(f"unknown task {task!r}; "
                             f"choose from {sorted(RUNNERS)}")
    results, failures = {}, {}
    for task in tasks:
        wd = os.path.join(args.workdir, task)
        os.makedirs(wd, exist_ok=True)
        # One failing task must not discard days of completed runs: record
        # the error as a table row, keep going, and REWRITE the table
        # after every task so partial progress is always on disk.
        try:
            results[task] = RUNNERS[task](args, wd)
        except Exception as e:
            print(f"[parity_repro] task {task!r} FAILED: {e}",
                  file=sys.stderr)
            failures[task] = str(e)
        table = emit_table(results, args, failures)
        with open(args.out, "w") as f:
            f.write(table)
    print(table)
    print(f"table -> {args.out}")
    if failures:
        raise SystemExit(
            f"{len(failures)}/{len(tasks)} tasks failed: "
            f"{sorted(failures)} (completed results kept in {args.out})")
    return results


if __name__ == "__main__":
    main()
