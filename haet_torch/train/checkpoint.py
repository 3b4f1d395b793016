"""Checkpointing with true mid-training resume, as ``torch.save`` files.

Counterpart of ``haet_tpu/train/checkpoint.py`` (orbax there) with the same
policy: names ``best``, ``last``, ``diverged`` and ``epoch_{N}``, the
periodic ones pruned to ``keep``; the best-val watermark in a sidecar
(``best_meta.json``), re-armed only on the resume path and ignored when no
``best`` stands behind it; the epoch of each checkpoint in a second sidecar
(``epochs.json``) beside the state's step, so that a torn pair reads as
unknown.

A state is a dict (``Trainer.state_dict()``: the model's ``state_dict``
with the BatchNorm buffers and counters, Adam's, OneCycleLR's and the
step). Each is written to ``<name>.pt.tmp`` and moved into place with
``os.replace``, so a torn write never replaces a good checkpoint. Saves are
synchronous.

Under a process group every rank calls the saves with the same state: rank
0 alone writes, and every rank waits for it (a barrier), so that any rank
may restore right after.
"""

from __future__ import annotations

import functools
import json
import os
import re

import torch

from ..parallel import barrier, is_writer
from ..utils.env import host_numpy

_EPOCH_RE = re.compile(r"^epoch_(\d+)\.pt$")


def _by_writer(save):
    """``save`` run by the writer alone (rank 0, or the only process), then
    a barrier across the process group (none without one)."""
    @functools.wraps(save)
    def wrapped(self, *args, **kwargs):
        if is_writer():
            save(self, *args, **kwargs)
        barrier()
    return wrapped


class Checkpointer:
    """best / last / periodic checkpoint policy (reference ``train.py``).

    Args:
        directory: checkpoint root; each name is the file ``<name>.pt``.
        keep: how many periodic ``epoch_*`` checkpoints to retain (oldest
            pruned first); ``best``/``last`` are always kept.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        # The watermark that decides whether a new eval beats the stored
        # `best`. It survives a restart through best_meta.json, re-armed by
        # rearm_best() on the resume path (Trainer.maybe_restore) and NOT on
        # construction: a from-scratch rerun into an existing directory must
        # start at inf, or its best epochs could never beat the previous
        # run's stale watermark.
        self.best_val = float("inf")
        self.best_epoch: int | None = None

    def path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def rearm_best(self) -> bool:
        """Restore the best-val watermark from the sidecar meta (resume
        path). Returns True if a watermark backed by an existing ``best``
        checkpoint was re-armed; stale meta is ignored."""
        meta = _read_json(self._meta_path)
        if meta is None or not os.path.exists(self.path("best")):
            return False
        self.best_val = float(meta.get("best_val", float("inf")))
        be = meta.get("best_epoch")
        self.best_epoch = int(be) if be is not None else None
        return True

    @property
    def _meta_path(self) -> str:
        return os.path.join(self.directory, "best_meta.json")

    # The epoch is stored with each checkpoint, beside the state's step,
    # instead of being derived from step // steps_per_epoch (which drifts
    # when the last batch of an epoch is partial). A crash between the
    # state's write and the sidecar's leaves a step mismatch, which
    # epoch_of reads as unknown.
    @property
    def _epochs_path(self) -> str:
        return os.path.join(self.directory, "epochs.json")

    def _record_epoch(self, name: str, epoch: int, state) -> None:
        rec = _read_json(self._epochs_path) or {}
        step = state.get("step") if isinstance(state, dict) else None
        rec[name] = {"epoch": int(epoch),
                     "step": int(step) if step is not None else None}
        _write_json(self._epochs_path, rec)

    def epoch_of(self, name: str, step: int | None = None):
        """Epoch recorded for checkpoint ``name``, or None if unknown. When
        ``step`` is given, the entry must match the restored state's step
        (a mismatched entry is treated as unknown)."""
        if name == "latest_periodic":
            epochs = self.periodic_epochs()
            if not epochs:
                return None
            name = f"epoch_{epochs[-1]}"
        ent = (_read_json(self._epochs_path) or {}).get(name)
        if ent is None:
            return None
        if step is not None:
            stored = ent.get("step")
            if stored is None or int(stored) != int(step):
                return None
        return int(ent["epoch"])

    def _save(self, name: str, state) -> None:
        path = self.path(name)
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)

    @_by_writer
    def save_best(self, state, val_loss: float, epoch: int) -> None:
        if val_loss < self.best_val:
            self.best_val = val_loss
            self.best_epoch = epoch
            self._save("best", state)   # before the watermark that names it
            _write_json(self._meta_path, {"best_val": self.best_val,
                                          "best_epoch": self.best_epoch})
            self._record_epoch("best", epoch, state)

    @_by_writer
    def save_last(self, state, epoch: int) -> None:
        self._save("last", state)
        self._record_epoch("last", epoch, state)

    @_by_writer
    def save_diverged(self, state, epoch: int) -> None:
        """Save a non-finite (diverged) state under ``diverged`` for
        forensics. Not ``last``: NaN parameters there would leave the run
        no good state to resume from."""
        self._save("diverged", state)
        self._record_epoch("diverged", epoch, state)

    @_by_writer
    def save_periodic(self, state, epoch: int) -> None:
        """Save ``epoch_{N}`` and prune to the ``keep`` most recent."""
        self._save(f"epoch_{epoch}", state)
        self._record_epoch(f"epoch_{epoch}", epoch, state)
        epochs = self.periodic_epochs()
        n_prune = max(0, len(epochs) - self.keep) if self.keep > 0 else 0
        for old in epochs[:n_prune]:
            os.remove(self.path(f"epoch_{old}"))

    def periodic_epochs(self) -> list[int]:
        """Sorted epoch numbers of the periodic checkpoints on disk."""
        out = []
        for name in os.listdir(self.directory):
            m = _EPOCH_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _resolve(self, name: str):
        if name == "latest_periodic":
            epochs = self.periodic_epochs()
            if not epochs:
                return None
            name = f"epoch_{epochs[-1]}"
        path = self.path(name)
        return path if os.path.exists(path) else None

    def restore(self, name: str = "last", map_location=None):
        """The state saved under ``name`` (``best`` / ``last`` /
        ``epoch_{N}`` / ``latest_periodic`` / ``diverged``), its tensors on
        ``map_location`` (a checkpoint written on the card restores on the
        CPU and the other way round). None if absent; a file that cannot be
        read raises naming the path and the cause."""
        path = self._resolve(name)
        if path is None:
            return None
        try:
            return torch.load(path, map_location=map_location,
                              weights_only=True)
        except Exception as e:   # torch.load raises several kinds
            raise RuntimeError(
                f"checkpoint at {path} could not be read: likely corrupt or "
                f"partially written ({type(e).__name__}: {e})") from e

    def restore_raw(self, name: str = "last"):
        """:meth:`restore` onto the host with every tensor a numpy array,
        for reading a checkpoint without a model or a device; a bf16 tensor
        (the first moment under ``mu_bf16``) as the exact float32 widening
        of its values (:func:`~haet_torch.utils.env.host_numpy`)."""
        state = self.restore(name, map_location="cpu")
        return None if state is None else _to_numpy(state)


def _to_numpy(tree):
    if isinstance(tree, torch.Tensor):
        return host_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError):
        return None


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)

