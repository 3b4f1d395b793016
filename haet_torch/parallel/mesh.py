"""The ``(dp, tp)`` mesh over the world's ranks, and how a batch lies on it.

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
covers its devices.

:class:`Layout` says how one forward's global batch lies on the mesh. The
rows are split over dp when dp divides the batch; a trailing batch that dp
does not divide stays whole on every rank, as JAX replicates it
(``mesh.py:96-103``). :meth:`Layout.shard` is this rank's part of a batch:
a bound model applies it inside its forward, so that callers pass the
global batch on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .collectives import gather
from .distributed import world

#: the axes a mesh may have after ``dp``
SECOND_AXES = ("tp", "cp")


class Mesh:
    """A ``(dp, tp)`` or ``(dp, cp)`` mesh over the process group's ranks
    (:func:`make_mesh`). :meth:`group` is the process group of this rank
    along any set of axes."""

    def __init__(self, n_dp: int, n_second: int, axis: str = "tp"):
        if axis not in SECOND_AXES:
            raise ValueError(f"the mesh's second axis is one of "
                             f"{SECOND_AXES}, got {axis!r}")
        rank, n = world()
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs the process group: call "
                               "haet_torch.parallel.init_distributed first")
        if n_dp * n_second != n:
            raise ValueError(
                f"dp({n_dp}) * {axis}({n_second}) != device count ({n})")
        self.axis_names = ("dp", axis)
        self.shape = {"dp": n_dp, axis: n_second}
        self.coords = {"dp": rank // n_second, axis: rank % n_second}
        self.backend = dist.get_backend()
        ranks = np.arange(n).reshape(n_dp, n_second)
        self._groups = {("dp", axis): dist.group.WORLD}
        # every rank makes every group, in one order
        for d in range(n_dp):
            g = dist.new_group(ranks[d].tolist())
            if d == self.coords["dp"]:
                self._groups[(axis,)] = g
        for j in range(n_second):
            g = dist.new_group(ranks[:, j].tolist())
            if j == self.coords[axis]:
                self._groups[("dp",)] = g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, backend={self.backend!r})"

    def size(self, axis: str) -> int:
        """The size of ``axis`` (0 if the mesh lacks it)."""
        return self.shape.get(axis, 0)

    def group(self, *axes: str):
        """The process group of this rank over ``axes`` (None for none)."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key] if key else None

    def layout(self, batch: int, points: int) -> "Layout":
        """How a global batch of ``batch`` samples of ``points`` points lies
        on the mesh; raises where cp does not divide the points."""
        n_cp = self.size("cp")
        if n_cp and points % n_cp:
            raise ValueError(
                f"the point axis cp({n_cp}) must divide the {points} points")
        return Layout(self, batch % self.shape["dp"] == 0, n_cp > 0, batch,
                      points)

    @torch.no_grad()
    def broadcast_(self, tensors) -> None:
        """Each tensor set to rank 0's, in place."""
        for t in tensors:
            dist.broadcast(t, src=0)


def make_mesh(n_dp: int | None = None, n_tp: int = 1,
              axis: str = "tp") -> Mesh:
    """The ``(dp, axis)`` mesh over every rank (``axis`` ``"tp"``, or
    ``"cp"`` for the point axis); ``n_dp`` None fills the world. Needs
    :func:`~haet_torch.parallel.distributed.init_distributed` first."""
    if n_dp is None:
        n_dp = world()[1] // n_tp
    return Mesh(n_dp, n_tp, axis)


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
        t = t[self.rows()]
        return t[:, self.point_rows()] if points and self.cp else t

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


__all__ = ["Mesh", "Layout", "make_mesh"]
