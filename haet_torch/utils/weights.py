"""Weight bridge from the JAX package: flax variables -> torch state_dict.

This is the only way weights cross from ``haet_tpu`` to the port. The
mapping is a copy of ``haet_tpu/utils/torch_import.py:253-300``
(``_torch_key`` / ``to_torch_state_dict``), not an import of it, since the
port never imports ``haet_tpu``:

* dots for the flax path, ``blocks_N`` -> ``blocks.N``, Erwin
  ``encoderI/blockJ`` -> ``encoder.I.blocks.J`` (likewise decoder,
  bottleneck), ``linear_pre`` -> ``linear_pre.0``, ``to_out`` -> ``to_out.0``;
* ``kernel [in, out]`` -> ``weight [out, in]``; ``scale`` -> ``weight``;
  the raw slice-head params -> ``in_project_slice``/``ada_temp_linear``;
* BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``, and a zero
  ``num_batches_tracked`` per BatchNorm so a ``strict=True`` load works.

:func:`from_jax_pipeline_variables` takes the JAX pipeline's layout
(``haet_tpu/parallel/pipeline.py:split_variables``: ``pre``, ``layers``
stacked ``[L, ...]``, ``head``) to the port's stacked one
(:func:`haet_torch.parallel.pipeline.split_variables`), each stacked leaf
converted layer by layer.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_KERNELS = ("kernel", "in_project_slice_kernel", "ada_temp_kernel")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def torch_key(path: tuple) -> str:
    """flax ``('params'|'batch_stats', ...)`` path -> reference key."""
    col, *mod = path
    leaf = mod.pop()
    if col == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf in ("kernel", "scale"):
        leaf = "weight"
    elif leaf == "in_project_slice_kernel":
        mod, leaf = mod + ["in_project_slice"], "weight"
    elif leaf == "in_project_slice_bias":
        mod, leaf = mod + ["in_project_slice"], "bias"
    elif leaf == "ada_temp_kernel":
        mod, leaf = mod + ["ada_temp_linear"], "weight"
    elif leaf == "ada_temp_bias":
        mod, leaf = mod + ["ada_temp_linear"], "bias"
    k = ".".join(mod + [leaf])
    k = re.sub(r"^blocks_(\d+)\.", r"blocks.\g<1>.", k)
    k = re.sub(r"erwin\.(encoder|decoder)(\d+)\.block(\d+)\.",
               r"erwin.\g<1>.\g<2>.blocks.\g<3>.", k)
    k = re.sub(r"erwin\.(encoder|decoder)(\d+)\.", r"erwin.\g<1>.\g<2>.", k)
    k = re.sub(r"erwin\.bottleneck\.block(\d+)\.",
               r"erwin.bottleneck.blocks.\g<1>.", k)
    k = re.sub(r"mpnn\.message_(\d+)\.", r"mpnn.fused_message_update.\g<1>.0.",
               k)
    k = re.sub(r"mpnn\.update_(\d+)\.", r"mpnn.update_fns.\g<1>.0.", k)
    k = k.replace(".linear_pre.", ".linear_pre.0.")
    k = k.replace(".to_out.", ".to_out.0.")
    k = re.sub(r"^time_fc1\.", "time_fc.0.", k)
    k = re.sub(r"^time_fc2\.", "time_fc.2.", k)
    return k


def _torch_layout(arr: np.ndarray) -> np.ndarray:
    """flax kernel -> torch weight (Linear [in,out] -> [out,in]; Conv
    HWIO -> OIHW; DHWIO -> OIDHW)."""
    if arr.ndim == 2:
        return arr.T
    if arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    if arr.ndim == 5:
        return arr.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"unsupported flax kernel ndim {arr.ndim}")


def from_jax_variables(variables: Mapping) -> dict:
    """The port's ``state_dict`` (float32/int64 CPU tensors) for JAX
    ``{"params", "batch_stats"}`` variables given as nested dicts of numpy
    arrays."""
    sd = {}
    for path, leaf in _flatten(variables).items():
        arr = np.asarray(leaf)
        if path[-1] in _KERNELS:
            arr = _torch_layout(arr)
        key = torch_key(path)
        sd[key] = torch.tensor(arr)  # a copy: JAX host arrays are read-only
        if key.endswith(".running_mean"):
            sd[key[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long))
    return sd


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> None:
    """Load JAX variables into ``model`` with ``strict=True``."""
    model.load_state_dict(from_jax_variables(variables), strict=True)


def from_jax_pipeline_variables(pvars: Mapping) -> dict:
    """The port's stacked pipeline state dict (``pre.*``, ``layers.*``
    ``[L, ...]``, ``head.*``) for JAX pipeline-layout variables
    ``{"params": {"pre", "layers", "head"}, "batch_stats": {"layers"}}``
    given as nested dicts of numpy arrays: the same tensors as converting
    the merged variables and splitting them."""
    params = pvars["params"]
    sd = {f"pre.{k}": v for k, v in
          from_jax_variables({"params": params["pre"]}).items()}
    last = "blocks_0"  # any block's name: only the key's tail is kept
    for col, tree in (("params", params["layers"]),
                      ("batch_stats", (pvars.get("batch_stats") or {})
                       .get("layers", {}))):
        for path, leaf in _flatten(tree).items():
            arr = np.asarray(leaf)
            if path[-1] in _KERNELS:
                arr = np.stack([_torch_layout(a) for a in arr])
            key = "layers." + torch_key((col, last) + path).split(".", 2)[2]
            sd[key] = torch.tensor(arr)
            if key.endswith(".running_mean"):
                sd[key[:-len("running_mean")] + "num_batches_tracked"] = (
                    torch.zeros(arr.shape[0], dtype=torch.long))
    for k, v in from_jax_variables(
            {"params": {last: params["head"]}}).items():
        sd["head." + k.split(".", 2)[2]] = v
    return sd
