"""The mesh's collectives as operators an exported program can hold.

A forward over a mesh crosses ranks: under dp for the pseudo-positions'
min-max over the global batch and the output's gather, under head TP for
the same min-max and the heads' gather, and each rank takes its part of
the batch rows and of the projection's columns. A bound model makes these
calls on ``torch.distributed`` process groups, Python objects that
``torch.export`` cannot hold, and computes its part from its own mesh
coordinates, which a program exported on one rank would bake in for all.

So, while :func:`exporting` is active, the model's mesh calls
(:func:`~haet_torch.parallel.collectives.gather`,
:func:`~haet_torch.parallel.collectives.all_reduce_max`,
:meth:`~haet_torch.parallel.Layout.shard` and the head split's columns)
trace as ``haet::`` operators that name mesh axes instead:

* ``haet::mesh_part(x, axes, dim)``: this rank's equal part of ``x`` along
  ``dim`` over the ranks of ``axes``;
* ``haet::mesh_gather(x, axes, dim)``: the parts of every rank of
  ``axes``, concatenated along ``dim``;
* ``haet::mesh_max(x, axes)``: the elementwise maximum over ``axes``.

``axes`` is a comma-separated list of mesh axis names. The operators
resolve it at call time against the mesh of :func:`using`, which
``haet_torch.export.load_artifact(path, mesh=...)`` activates around every
call, so one program, exported on rank 0, runs on every rank of a mesh of
its shape. Their fake versions take the axis sizes from the mesh being
exported with.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..ops.kernels import define_op

_EXPORTING = []
_USING = []


@contextlib.contextmanager
def exporting(mesh):
    """The model's mesh calls trace as ``haet::`` operators over
    ``mesh``'s axes while this is active."""
    _EXPORTING.append(mesh)
    try:
        yield mesh
    finally:
        _EXPORTING.pop()


def export_mesh():
    """The mesh being exported with, or None."""
    return _EXPORTING[-1] if _EXPORTING else None


@contextlib.contextmanager
def using(mesh):
    """Resolve the ``haet::mesh_*`` operators against ``mesh``."""
    _USING.append(mesh)
    try:
        yield mesh
    finally:
        _USING.pop()


def _mesh():
    mesh = _USING[-1] if _USING else export_mesh()
    if mesh is None:
        raise RuntimeError(
            "a haet::mesh_* operator needs a mesh: load the program with "
            "haet_torch.export.load_artifact(path, mesh=...)")
    return mesh


def _axes(axes: str) -> tuple:
    return tuple(a for a in axes.split(",") if a)


def _size(mesh, axes: str) -> int:
    n = 1
    for a in _axes(axes):
        n *= mesh.shape[a]
    return n


def _index(mesh, axes: str) -> int:
    i = 0
    for a in _axes(axes):
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _part_impl(x, axes, dim):
    mesh = _mesh()
    n = _size(mesh, axes)
    k = x.shape[dim] // n
    return x.narrow(dim, _index(mesh, axes) * k, k).clone()


def _part_fake(x, axes, dim):
    shape = list(x.shape)
    shape[dim] //= _size(_mesh(), axes)
    return x.new_empty(shape)


def _gather_impl(x, axes, dim):
    mesh = _mesh()
    group = mesh.group(*_axes(axes))
    parts = [torch.empty_like(x) for _ in range(_size(mesh, axes))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _gather_fake(x, axes, dim):
    shape = list(x.shape)
    shape[dim] *= _size(_mesh(), axes)
    return x.new_empty(shape)


def _max_impl(x, axes):
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=_mesh().group(*_axes(axes)))
    return out


def _max_fake(x, axes):
    return torch.empty_like(x)


mesh_part = define_op("mesh_part", "(Tensor x, str axes, int dim) -> Tensor",
                      _part_impl, _part_fake)
mesh_gather = define_op("mesh_gather",
                        "(Tensor x, str axes, int dim) -> Tensor",
                        _gather_impl, _gather_fake)
mesh_max = define_op("mesh_max", "(Tensor x, str axes) -> Tensor",
                     _max_impl, _max_fake)


def axes_of(group) -> str:
    """The operators' name of one of the export mesh's process groups."""
    return ",".join(export_mesh().axes_of(group))
