"""Data, head-tensor and point parallelism over ``torch.distributed``.

Counterpart of ``haet_tpu/parallel/`` (``mesh.py``, ``distributed.py``):
explicit SPMD, one process per rank. :func:`init_distributed` joins the
process group, :func:`make_mesh` builds the ``(dp, tp)`` (or ``(dp, cp)``)
mesh, :func:`bind_mesh` makes a model run its rank's part of each forward,
and ``Trainer(mesh=...)`` sums the gradients
(:func:`reduce_gradients`). :func:`make_pp_mesh` builds the ``(dp, pp)`` or
``(dp, pp, tp)`` mesh of the GPipe pipeline
(:class:`~haet_torch.parallel.pipeline.PipelinedModel`, importable from
here), and :mod:`~haet_torch.parallel.mesh_ops` holds the collectives an
exported program calls by mesh axis.
"""

from __future__ import annotations

import torch.distributed as dist

from .distributed import (barrier, cluster_configured, init_distributed,
                          is_writer, process_batch_slice, requested_world,
                          world)
from .mesh import Layout, Mesh, make_mesh, make_pp_mesh


def mesh_models(module) -> list:
    """The HAET models inside ``module`` (itself included)."""
    from ..models.haet import _HAETBase

    return [m for m in module.modules() if isinstance(m, _HAETBase)]


def bind_mesh(module, mesh) -> None:
    """Bind ``mesh`` (None unbinds) to every HAET model inside ``module``,
    which then takes the global batch on every rank, runs this rank's part
    of it and returns the global output (:meth:`bind_mesh` of the model);
    raises where ``module`` holds none."""
    models = mesh_models(module)
    if not models:
        raise ValueError(f"{type(module).__name__} holds no HAET model to "
                         "bind a mesh to")
    for m in models:
        m.bind_mesh(mesh)


def tp_partial_parameters(module) -> list:
    """The parameters whose gradients each tp rank holds a part of: those
    used inside the head-sharded core of a bound model's attentions (the
    projection, the slice and temperature heads, Erwin), to be summed over
    tp. The others see the whole heads on every tp rank."""
    return [p for m in mesh_models(module) for blk in m.blocks
            for p in blk.Attn.head_sharded_parameters()]


def tp_ranges(params: list, partial: list) -> list:
    """The ``(start, stop)`` element ranges of ``partial`` inside a flat
    buffer of ``params``, contiguous runs merged."""
    ids = {id(p) for p in partial}
    ranges, offset = [], 0
    for p in params:
        if id(p) in ids:
            if ranges and ranges[-1][1] == offset:
                ranges[-1] = (ranges[-1][0], offset + p.numel())
            else:
                ranges.append((offset, offset + p.numel()))
        offset += p.numel()
    return ranges


def reduce_gradients(flat, mesh, layout: Layout, ranges: list) -> None:
    """Sum the flat gradient buffer of one step over the mesh, in place:
    the ``ranges`` of the head-sharded parameters over tp first, then the
    whole buffer over the axes that split the batch (dp, cp)."""
    tp = mesh.group("tp") if mesh.size("tp") > 1 else None
    if tp is not None:
        for lo, hi in ranges:
            dist.all_reduce(flat[lo:hi], group=tp)
    group = mesh.group(*layout.split_axes())
    if group is not None:
        dist.all_reduce(flat, group=group)


def __getattr__(name):
    # the pipeline imports the models, which import this package
    if name in ("PipelinedModel", "merge_raw_variables", "merge_variables",
                "split_variables", "pipelines"):
        from . import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)


__all__ = ["Layout", "Mesh", "PipelinedModel", "barrier", "bind_mesh", "cluster_configured",
           "init_distributed", "is_writer", "make_mesh", "make_pp_mesh",
           "merge_raw_variables", "merge_variables", "mesh_models",
           "pipelines",
           "process_batch_slice", "reduce_gradients", "requested_world",
           "split_variables",
           "tp_partial_parameters", "tp_ranges", "world"]
