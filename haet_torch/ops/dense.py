"""Dense products and normalisations in a compute dtype, flax's policy.

A flax module built with ``dtype=jnp.bfloat16`` and float32 parameters
(``haet_tpu/utils/config.py:ModelConfig.bf16``) computes as follows, and
these helpers do the same with the dtype written into each call:

* ``nn.Dense``: the input, kernel and bias are cast to the compute dtype,
  the product is taken in it (float32 accumulation, rounded once), and the
  bias is added to the rounded product, a second rounding, as flax writes
  ``y = dot(x, kernel); y += bias``; the float32 parameters receive float32
  gradients (:func:`linear`).
* ``nn.LayerNorm``, ``nn.RMSNorm``, ``nn.BatchNorm``: the statistics and
  the normalisation in float32, the output cast to the compute dtype
  (:func:`normalized`).

``dtype=None`` is the float32 model: every call is the plain one.
``torch.autocast`` follows another policy (it picks casts per op and
returns float32 from ``layer_norm``), so the port does not use it.
"""

from __future__ import annotations

import torch.nn.functional as F


def linear(x, weight, bias=None, dtype=None):
    """``x @ weight.T + bias`` in ``dtype`` (None: as given, one fused
    call)."""
    if dtype is None:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def normalized(norm, x, dtype=None):
    """``norm(x)`` (a function of a float32 tensor) computed in float32 and
    returned in ``dtype`` (None: as given)."""
    if dtype is None:
        return norm(x)
    return norm(x.float()).to(dtype)
