"""The meshes over the world's ranks, and how a batch lies on them.

Counterpart of ``haet_tpu/parallel/mesh.py:23-106``. The JAX mesh names
devices and XLA partitions the program over it; here :class:`Mesh` holds a
``torch.distributed`` process group per axis and the model runs one rank's
part of the program (:meth:`HAETransolverIrregularMesh.bind_mesh`):

* ``dp``: data parallel, the batch rows split over the axis;
* ``tp``: tensor parallel over the attention heads of a model built with
  ``shard_axes=("dp", "tp")``, each rank running the slice -> Erwin ->
  deslice core on its ``H / tp`` heads;
* ``cp``: the point axis, in place of ``tp`` (a ``(dp, cp)`` mesh): each rank
  holds ``N / cp`` points of every sample, and the slice reductions over N
  are summed over the axis.

The second axis varies fastest: rank ``r`` sits at ``(r // n, r % n)``. A
mesh covers the whole world, ``dp * tp`` = world size, as the JAX mesh
covers its devices. The pipeline's mesh (:func:`make_pp_mesh`) is ``(dp,
pp)`` or ``(dp, pp, tp)``, the last axis again fastest, with a group per
axis and per set of axes.

:class:`Layout` says how one forward's global batch lies on the mesh. The
rows are split over dp when dp divides the batch; a trailing batch that dp
does not divide stays whole on every rank, as JAX replicates it
(``mesh.py:96-103``). :meth:`Layout.shard` is this rank's part of a batch:
a bound model applies it inside its forward, so that callers pass the
global batch on every rank.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import mesh_ops
from .collectives import axis_part, gather
from .distributed import world

#: the axes a mesh may have after ``dp``
SECOND_AXES = ("tp", "cp")


class Mesh:
    """A ``(dp, tp)`` or ``(dp, cp)`` mesh (:func:`make_mesh`), or a
    ``(dp, pp)`` or ``(dp, pp, tp)`` one for the pipeline
    (:func:`make_pp_mesh`), over the process group's ranks, the last axis
    varying fastest. :meth:`group` is the process group of this rank along
    any set of axes."""

    def __init__(self, n_dp: int, n_second: int, axis: str = "tp", *,
                 n_tp: int | None = None):
        if axis not in SECOND_AXES + ("pp",):
            raise ValueError(f"the mesh's second axis is one of "
                             f"{SECOND_AXES + ('pp',)}, got {axis!r}")
        if n_tp is not None and axis != "pp":
            raise ValueError("a third axis (tp) follows pp only")
        rank, n = world()
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs the process group: call "
                               "haet_torch.parallel.init_distributed first")
        names, sizes = ["dp", axis], [n_dp, n_second]
        if n_tp is not None:
            names.append("tp")
            sizes.append(n_tp)
        if int(np.prod(sizes)) != n:
            raise ValueError(" * ".join(f"{a}({k})" for a, k in
                                        zip(names, sizes))
                             + f" != device count ({n})")
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))
        ranks = np.arange(n).reshape(sizes)
        here = np.unravel_index(rank, sizes)
        self.coords = {a: int(c) for a, c in zip(names, here)}
        self.backend = dist.get_backend()
        self._ranks = ranks
        self._groups = {tuple(names): dist.group.WORLD}
        # every rank makes every group, in one order: the sets of axes
        # from the fastest single axis on (for (dp, tp): tp, then dp)
        k = len(names)
        subsets = [tuple(names[i] for i in idx)
                   for r in range(1, k)
                   for idx in sorted(itertools.combinations(range(k), r),
                                     key=lambda c: [-i for i in c[::-1]])]
        for axes in subsets:
            keep = [names.index(a) for a in axes]
            rest = [i for i in range(k) if i not in keep]
            moved = np.moveaxis(ranks, rest, list(range(len(rest))))
            moved = moved.reshape(-1, int(np.prod([sizes[i]
                                                   for i in keep])))
            mine = np.ravel_multi_index([here[i] for i in rest],
                                        [sizes[i] for i in rest])
            for j, members in enumerate(moved):
                g = dist.new_group(members.tolist())
                if j == mine:
                    self._groups[axes] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r})"

    def size(self, axis: str) -> int:
        """The size of ``axis`` (0 if the mesh lacks it)."""
        return self.shape.get(axis, 0)

    def group(self, *axes: str):
        """The process group of this rank over ``axes`` (None for none)."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key] if key else None

    def layout(self, batch: int, points: int,
               split_batch: bool = True) -> "Layout":
        """How a global batch of ``batch`` samples of ``points`` points lies
        on the mesh (``split_batch`` False: whole on every rank); raises
        where cp does not divide the points."""
        n_cp = self.size("cp")
        if n_cp and points % n_cp:
            raise ValueError(
                f"the point axis cp({n_cp}) must divide the {points} points")
        return Layout(self, split_batch and batch % self.shape["dp"] == 0,
                      n_cp > 0, batch, points)

    def rank_of(self, **coords) -> int:
        """The global rank at this rank's coordinates, with ``coords``
        replacing some of them."""
        at = dict(self.coords, **coords)
        return int(self._ranks[tuple(at[a] for a in self.axis_names)])

    def axes_of(self, group) -> tuple:
        """The mesh axes of one of this mesh's process groups."""
        for axes, g in self._groups.items():
            if g is group:
                return axes
        raise ValueError(f"{group!r} is not a process group of {self!r}")

    @torch.no_grad()
    def broadcast_(self, tensors, axes=None) -> None:
        """Each tensor set in place to that of the first rank of this
        rank's group over ``axes`` (None: every axis, rank 0)."""
        group = None if axes is None else self.group(*axes)
        src = 0 if group is None else dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t, src=src, group=group)


def make_mesh(n_dp: int | None = None, n_tp: int = 1,
              axis: str = "tp") -> Mesh:
    """The ``(dp, axis)`` mesh over every rank (``axis`` ``"tp"``, or
    ``"cp"`` for the point axis); ``n_dp`` None fills the world. Needs
    :func:`~haet_torch.parallel.distributed.init_distributed` first."""
    if axis not in SECOND_AXES:
        raise ValueError(f"the mesh's second axis is one of "
                         f"{SECOND_AXES}, got {axis!r} (make_pp_mesh builds "
                         "the pipeline's)")
    if n_dp is None:
        n_dp = world()[1] // n_tp
    return Mesh(n_dp, n_tp, axis)


def make_pp_mesh(n_dp: int = 1, n_pp: int = 1, n_tp: int = 1) -> Mesh:
    """The ``(dp, pp)`` mesh, or with ``n_tp > 1`` the ``(dp, pp, tp)``
    one, for :class:`~haet_torch.parallel.pipeline.PipelinedModel`
    (``haet_tpu/parallel/mesh.py:35-54``): tp varies fastest (the head
    gather is the chattiest collective), then pp, so that a stage's hop
    crosses at most one tp group. Needs
    :func:`~haet_torch.parallel.distributed.init_distributed` first."""
    n = world()[1]
    if n_dp * n_pp * n_tp != n:
        raise ValueError(
            f"dp({n_dp}) * pp({n_pp}) * tp({n_tp}) != device count ({n})")
    return Mesh(n_dp, n_pp, "pp", n_tp=n_tp if n_tp > 1 else None)


@dataclass(frozen=True)
class Layout:
    """One forward's global batch on a :class:`Mesh`: ``dp`` whether its
    rows are split over dp, ``cp`` whether its points are split over cp;
    ``batch`` and ``points`` its global sizes."""

    mesh: Mesh
    dp: bool
    cp: bool
    batch: int
    points: int

    def _part(self, axis: str, total: int) -> slice:
        n = self.mesh.size(axis)
        i = self.mesh.coords[axis]
        return slice(i * total // n, (i + 1) * total // n)

    def rows(self) -> slice:
        """This rank's rows of the batch."""
        return self._part("dp", self.batch) if self.dp else slice(None)

    def point_rows(self) -> slice:
        """This rank's points of each sample."""
        return self._part("cp", self.points) if self.cp else slice(None)

    def shard(self, t, points: bool = True):
        """This rank's part of ``t [batch, ...]``: its rows, and with
        ``points`` its points along dim 1 (None stays None)."""
        if t is None:
            return None
        if self.dp:
            t = axis_part(t, self.mesh.group("dp"), self.mesh.coords["dp"],
                          self.mesh.shape["dp"])
        if points and self.cp:
            if mesh_ops.export_mesh() is not None:
                raise ValueError("a program over the point axis (cp) is "
                                 "not exported: export over dp or tp")
            t = t[:, self.point_rows()]
        return t

    def gather(self, t):
        """The global ``[batch, points, ...]`` tensor of every rank's part
        ``t``, on every rank; the backward keeps this rank's part of the
        gradient (every rank computes the same function of the whole)."""
        if self.cp:
            t = gather(t, self.mesh.group("cp"), 1)
        if self.dp:
            t = gather(t, self.mesh.group("dp"), 0)
        return t

    def split_axes(self) -> tuple:
        """The axes over which the ranks hold different data of the batch,
        so that their parameters' gradients are parts of the whole."""
        return tuple(a for a, on in (("dp", self.dp), ("cp", self.cp)) if on)

    def dropout_part(self, local_shape) -> tuple:
        """``(global shape, index)`` of a ``[batch, points, ...]`` dropout
        mask: the mask is drawn for the whole batch and each rank keeps its
        part, so that a rank's mask is the rows the single-device mask
        would give it."""
        shape = (self.batch, self.points, *local_shape[2:])
        return shape, (self.rows(), self.point_rows())


__all__ = ["Mesh", "Layout", "make_mesh", "make_pp_mesh"]
