"""Reference-checkpoint interchange: the reference's torch ``state_dict``
<-> a port model.

Counterpart of ``haet_tpu/utils/torch_import.py``. The reference trains
with PyTorch and saves ``state_dict`` checkpoints (``benchmarks/02-.../
train.py:250-259`` saves ``{"epoch", "model_state_dict", ...}``;
``exp_darcy.py:259-263`` bare state_dicts). The port's modules are named
as the reference's, so its own ``state_dict`` is in the reference schema
and holds torch layouts: a checkpoint's tensors load without a transpose.
What this module adds is the JAX importer's contract:

    model = shapenet_car_config().build()
    model.load_state_dict(load_torch_checkpoint("best_model.pt", model))

* containers (``model_state_dict``/``state_dict``/``model``) unwrapped,
  ``torch.compile``/``DataParallel`` prefixes stripped (:func:`_strip`),
  ``rename`` prefix rewrites for wrappers named otherwise (the Erwin-only
  baseline), BatchNorm ``num_batches_tracked`` ignored on input;
* every key read through the JAX importer's mapping,
  :func:`_translate_module_path` to the JAX package's module path and back
  through :func:`haet_torch.utils.weights.torch_key` (one copy of the
  mapping, shared with the JAX bridge), so a key the JAX package maps is
  mapped here and one it refuses is refused;
* ``strict``: a template key left unfilled or a checkpoint key left unused
  raises ``ValueError`` with the JAX importer's messages; a shape mismatch
  always raises.

:func:`to_torch_state_dict` exports a port model in the reference schema
(numpy arrays, no ``num_batches_tracked``), as the JAX exporter does from
flax variables.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .weights import torch_key

# torch.compile / DataParallel wrappers the reference eval already strips
# (``main_evaluation.py:229-240``).
_PREFIXES = ("_orig_mod.", "module.")

# Containers the reference wraps state_dicts in (``train.py:250-259``).
_CONTAINER_KEYS = ("model_state_dict", "state_dict", "model")

_COUNTER = "num_batches_tracked"


def _strip(key: str) -> str:
    changed = True
    while changed:
        changed = False
        for p in _PREFIXES:
            if key.startswith(p):
                key = key[len(p):]
                changed = True
    return key


def _translate_module_path(key: str) -> str:
    """A reference module path (everything up to the leaf) in the JAX
    package's naming (``torch_import.py:104-130``); the leaf stays
    torch-named (``weight``/``bias``/``running_mean``/...)."""
    k = key
    # Erwin internals first -- their '.blocks.N.' must not be confused with
    # the model's top-level '.blocks.N.' rewrite below.
    k = re.sub(r"erwin\.(encoder|decoder)\.(\d+)\.blocks\.(\d+)\.",
               r"erwin.\g<1>\g<2>.block\g<3>.", k)
    k = re.sub(r"erwin\.(encoder|decoder)\.(\d+)\.", r"erwin.\g<1>\g<2>.", k)
    k = re.sub(r"erwin\.bottleneck\.blocks\.(\d+)\.",
               r"erwin.bottleneck.block\g<1>.", k)
    # MPNN: fused Sequential(message Linear, GELU, non-affine LN) and
    # Sequential(update Linear, non-affine LN) -- only index 0 has params.
    k = re.sub(r"mpnn\.fused_message_update\.(\d+)\.0\.",
               r"mpnn.message_\g<1>.", k)
    k = re.sub(r"mpnn\.update_fns\.(\d+)\.0\.", r"mpnn.update_\g<1>.", k)
    # Top-level transformer blocks.
    k = re.sub(r"^blocks\.(\d+)\.", r"blocks_\g<1>.", k)
    # torch Sequential indices with a single parametrized member.
    k = k.replace(".linear_pre.0.", ".linear_pre.")
    k = k.replace(".to_out.0.", ".to_out.")
    # time_fc = Sequential(Linear, SiLU, Linear); in JAX two named Dense.
    k = re.sub(r"^time_fc\.0\.", "time_fc1.", k)
    k = re.sub(r"^time_fc\.2\.", "time_fc2.", k)
    return k


def _candidates(key: str) -> list:
    """The JAX variable paths a reference ``key`` may fill
    (``torch_import.py:180-205``), most likely first."""
    parts = _translate_module_path(key).split(".")
    mod, leaf = parts[:-1], parts[-1]
    slice_head = mod[-1] if mod and mod[-1] in (
        "in_project_slice", "ada_temp_linear") else None
    if leaf == "running_mean":
        return [("batch_stats", *mod, "mean")]
    if leaf == "running_var":
        return [("batch_stats", *mod, "var")]
    if leaf in ("weight", "bias") and slice_head:
        name = {"in_project_slice": "in_project_slice",
                "ada_temp_linear": "ada_temp"}[slice_head]
        kind = "kernel" if leaf == "weight" else "bias"
        return [("params", *mod[:-1], f"{name}_{kind}")]
    if leaf == "weight":
        return [("params", *mod, "kernel"), ("params", *mod, "scale")]
    return [("params", *mod, leaf)]


def _template(template) -> Dict[str, torch.Tensor]:
    if isinstance(template, torch.nn.Module):
        return template.state_dict()
    return dict(template)


def _to_tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))


def convert_state_dict(state_dict: Mapping[str, Any], template, *,
                       strict: bool = True,
                       rename: Mapping[str, str] | None = None) -> dict:
    """A reference ``state_dict`` as a state dict of the port model
    ``template``.

    Args:
      state_dict: reference parameter names to tensors or arrays. May be a
        whole checkpoint dict: a known container (``model_state_dict``/
        ``state_dict``/``model``) is unwrapped.
      template: the port model for the matching config (or its
        ``state_dict``): keys, shapes, dtypes and devices come from it.
      strict: raise ``ValueError`` when a template key (but a BatchNorm's
        ``num_batches_tracked``) is unfilled or a checkpoint key is unused.
        With ``strict=False`` unfilled keys keep the template's values.
      rename: prefix rewrites (longest first, once per key, after the
        wrapper prefixes are stripped), e.g. for the 02.1 Erwin-only
        baseline ``{"model.": "erwin.", "pred_head.0.": "head1.",
        "pred_head.2.": "head2."}``.

    Returns a new ``{key: tensor}`` with every template key, ready for
    ``model.load_state_dict(..., strict=True)``.
    """
    for c in _CONTAINER_KEYS:
        if c in state_dict and isinstance(state_dict[c], Mapping):
            state_dict = state_dict[c]
            break
    rename = dict(sorted((rename or {}).items(),
                         key=lambda kv: -len(kv[0])))
    tmpl = _template(template)
    out: Dict[str, torch.Tensor] = {}
    unused, errors = [], []

    for raw_key, raw_val in state_dict.items():
        key = _strip(raw_key)
        if key.endswith(_COUNTER):
            continue
        for pre, sub in rename.items():
            if key.startswith(pre):
                key = sub + key[len(pre):]
                break
        hit = next((k for k in map(torch_key, _candidates(key))
                    if k in tmpl), None)
        if hit is None:
            unused.append(raw_key)
            continue
        val, want = _to_tensor(raw_val), tmpl[hit]
        if tuple(val.shape) != tuple(want.shape):
            errors.append(f"{raw_key}: shape {tuple(val.shape)} vs template "
                          f"{tuple(want.shape)} at {hit}")
            continue
        out[hit] = val.to(device=want.device, dtype=want.dtype).clone()

    missing = [k for k in tmpl if k not in out and not k.endswith(_COUNTER)]
    if errors:
        raise ValueError("shape mismatches importing checkpoint:\n  "
                         + "\n  ".join(errors))
    if strict and (missing or unused):
        msg = []
        if missing:
            msg.append("template leaves not found in checkpoint:\n  "
                       + "\n  ".join(sorted(missing)))
        if unused:
            msg.append("checkpoint keys not mapped:\n  "
                       + "\n  ".join(sorted(unused)))
        raise ValueError("\n".join(msg))
    return {k: out.get(k, v) for k, v in tmpl.items()}


def to_torch_state_dict(model) -> Dict[str, np.ndarray]:
    """``model`` (or its ``state_dict``) as a reference-schema
    ``state_dict`` of float32/int numpy arrays in torch layouts, without
    ``num_batches_tracked`` counters, as ``torch_import.py:288-300``
    exports one from flax variables. bf16 tensors come back as their exact
    float32 widening."""
    out = {}
    for k, v in _template(model).items():
        if k.endswith(_COUNTER):
            continue
        v = v.detach().cpu()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


def load_torch_checkpoint(path: str, template, *, strict: bool = True,
                          rename: Mapping[str, str] | None = None,
                          weights_only: bool = True) -> dict:
    """``torch.load`` a reference ``.pt`` checkpoint file and convert it for
    the port model ``template`` (:func:`convert_state_dict`).

    Takes bare state_dicts and the reference's training-checkpoint dicts
    (``{"epoch", "model_state_dict", ...}``, ``train.py:250-259``). Loads
    with ``weights_only=True`` by default: reference checkpoints are plain
    tensor/int/dict trees and need no pickle code execution, but for the
    numpy float64 scalars ``train.py`` saves as ``val_loss``/``train_loss``,
    whose reconstruction globals are allowlisted (data only). Pass
    ``weights_only=False`` only for a file you trust completely:
    unpickling an arbitrary file executes arbitrary code.
    """
    import pickle

    if not weights_only:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    else:
        from torch.serialization import safe_globals

        try:
            with safe_globals(_numpy_pickle_globals()):
                sd = torch.load(path, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError as e:
            raise ValueError(
                f"{path} contains pickled objects beyond tensors and numpy "
                "scalars, which the safe weights-only loader rejects. If "
                "you trust this file completely, pass weights_only=False "
                "(unpickling arbitrary files executes arbitrary code)."
            ) from e
    return convert_state_dict(sd, template, strict=strict, rename=rename)


def _numpy_pickle_globals() -> list:
    """The globals numpy scalars pickle through (``multiarray.scalar``,
    ``np.dtype`` and the concrete DType classes): data-only constructors,
    safe to allowlist for ``torch.load(weights_only=True)``."""
    cands: list = [np.dtype]
    for mod_name in ("_core", "core"):  # numpy 2 / numpy 1 spellings
        mod = getattr(np, mod_name, None)
        scalar = getattr(getattr(mod, "multiarray", None), "scalar", None)
        if scalar is not None:
            cands.append(scalar)
            break
    try:
        import numpy.dtypes as _ndt

        cands += [v for n, v in vars(_ndt).items() if n.endswith("DType")]
    except ImportError:  # numpy < 1.25
        pass
    return cands
