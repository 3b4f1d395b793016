"""The collectives of the parallel path, as autograd functions.

The JAX package is single-controller SPMD: XLA inserts every collective of a
sharded program and differentiates through it. The port runs one process
per rank, so each reduction that XLA made global is made here by hand, and
so is its backward. Every function takes a ``torch.distributed`` process
group and uses only ``all_reduce``, ``all_gather`` (the list form) and
``broadcast``, the collectives that both NCCL and gloo carry for CUDA
tensors; nothing is routed through the host here.

* :func:`gather` concatenates the ranks' pieces along a dimension. Its
  backward keeps the rank's own piece of the gradient (``reduce=False``:
  every rank computed the same function of the gathered tensor, so each
  holds the whole gradient), or first sums the gradient over the group
  (``reduce=True``: each rank's gradient is a part of it).
* :func:`reduce_grad` is the identity whose backward sums the gradient over
  the group: the input of a computation that each rank runs on a part of
  the heads.
* :func:`all_reduce_sum` sums over the group, and so does its backward.
* :func:`all_reduce_max` takes the elementwise maximum, without gradient.
* :func:`group_moments` and :func:`sync_batch_norm` are train-mode
  BatchNorm over the rows of every rank of a group.

The pipeline's stage hop (``lax.ppermute`` in JAX,
``haet_tpu/parallel/pipeline.py:412-413``) is point to point:
:func:`stage_send` and :func:`stage_recv` pass one microbatch's activation
to the next stage, and their backwards pass its gradient back.
:func:`from_last_stage` broadcasts the last stage's outputs over the pp
group, and its backward takes the gradient on the last stage only, so that
the loss every pp rank computes counts once. gloo's ``send``/``recv`` take
CPU tensors only: under gloo a CUDA activation goes through the host
(:func:`_p2p`); NCCL sends it from the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh_ops


def group_size(group) -> int:
    """The number of ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def _all_gather(t: torch.Tensor, group) -> list:
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def _summed(g: torch.Tensor, group) -> torch.Tensor:
    g = g.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(g, group=group)
    return g


class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        ctx.size = x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = _summed(g, ctx.group)
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None, None


def gather(x: torch.Tensor, group, dim: int, reduce: bool = False):
    """The ranks' ``x`` concatenated along ``dim`` in group order; the
    backward keeps this rank's piece of the gradient, summed over the group
    first when ``reduce``. Traces as ``haet::mesh_gather`` under
    :func:`~haet_torch.parallel.mesh_ops.exporting`."""
    if mesh_ops.export_mesh() is not None:
        return mesh_ops.mesh_gather(x, mesh_ops.axes_of(group), dim)
    return _Gather.apply(x, group, dim, reduce)


class _ReduceGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def reduce_grad(x: torch.Tensor, group):
    """``x``, whose gradient is summed over ``group`` in the backward."""
    if mesh_ops.export_mesh() is not None:
        return x
    return _ReduceGrad.apply(x, group)


def axis_part(t: torch.Tensor, group, index: int, n: int, dim: int = 0):
    """Part ``index`` of ``n`` equal parts of ``t`` along ``dim``: this
    rank's, ``group`` being its axis (``haet::mesh_part`` under
    :func:`~haet_torch.parallel.mesh_ops.exporting`)."""
    if mesh_ops.export_mesh() is not None:
        return mesh_ops.mesh_part(t, mesh_ops.axes_of(group), dim)
    k = t.shape[dim] // n
    return t.narrow(dim, index * k, k)


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group):
    """The sum of ``x`` over ``group``, on every rank; differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group):
    """The elementwise maximum of ``x`` over ``group`` (no gradient); traces
    as ``haet::mesh_max`` under
    :func:`~haet_torch.parallel.mesh_ops.exporting`."""
    if mesh_ops.export_mesh() is not None:
        return mesh_ops.mesh_max(x, mesh_ops.axes_of(group))
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def group_moments(x: torch.Tensor, group):
    """``(mean, var, count)`` over the rows of ``x: [rows, C]`` of every
    rank of ``group``, in float32: each rank's ``(count, mean, biased
    var)`` is gathered, then combined as Chan's parallel formula does,
    ``mean = sum n_i m_i / n``, ``var = sum n_i (v_i + (m_i - mean)^2) /
    n``. ``count`` is a 0-d tensor."""
    var, mean = torch.var_mean(x, dim=0, correction=0)
    n = torch.full((1,), x.shape[0], dtype=mean.dtype, device=x.device)
    stats = torch.stack(_all_gather(torch.cat([n, mean, var]), group))
    c = mean.shape[0]
    ns, means, vars_ = stats[:, :1], stats[:, 1:1 + c], stats[:, 1 + c:]
    count = ns.sum()
    mean = (ns * means).sum(0) / count
    var = (ns * (vars_ + (means - mean) ** 2)).sum(0) / count
    return mean, var, count


class _SyncBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, mean, invstd, count, group):
        xhat = (x - mean) * invstd
        ctx.save_for_backward(xhat, weight, invstd, count)
        ctx.group = group
        return xhat * weight + bias

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, invstd, count = ctx.saved_tensors
        sdy, sdyx = dy.sum(0), (dy * xhat).sum(0)
        total = _summed(torch.cat([sdy, sdyx]), ctx.group)
        gdy, gdyx = total.chunk(2)
        dx = weight * invstd * (dy - gdy / count - xhat * (gdyx / count))
        # the parameters' gradients are this rank's part: the trainer sums
        # them over the group with the others
        return dx, sdyx, sdy, None, None, None, None


def sync_batch_norm(x, weight, bias, mean, invstd, count, group):
    """``(x - mean) * invstd * weight + bias`` over ``x: [rows, C]`` with
    the group's statistics (:func:`group_moments`); the backward sums
    ``sum dy`` and ``sum dy * xhat`` over ``group``, as ``SyncBatchNorm``
    does, and returns this rank's part of the parameters' gradients."""
    return _SyncBatchNorm.apply(x, weight, bias, mean, invstd, count, group)


def _p2p(op, t: torch.Tensor, peer: int, tag: int) -> None:
    """``dist.send`` or ``dist.recv`` of ``t`` with ``peer`` (in place for
    a receive); a CUDA tensor through a host copy under gloo."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.detach().cpu() if op is dist.send else torch.empty(
            t.shape, dtype=t.dtype)
        op(host, peer, tag=tag)
        if op is dist.recv:
            t.copy_(host)
        return
    op(t.contiguous() if op is dist.send else t, peer, tag=tag)


class _StageSend(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, peer, tag):
        ctx.peer, ctx.tag = peer, tag
        ctx.shape, ctx.dtype, ctx.device = x.shape, x.dtype, x.device
        _p2p(dist.send, x.detach(), peer, tag)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype, device=ctx.device)
        _p2p(dist.recv, g, ctx.peer, ctx.tag)
        return g, None, None


def stage_send(x: torch.Tensor, peer: int, tag: int) -> torch.Tensor:
    """Send ``x`` to rank ``peer`` (the next stage); returns a 0-d zero
    whose backward receives ``x``'s gradient from ``peer``: add it to
    what the loss depends on (:func:`from_last_stage`)."""
    return _StageSend.apply(x, peer, tag)


class _StageRecv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, like, peer, tag):
        ctx.peer, ctx.tag = peer, tag
        out = torch.empty_like(like, memory_format=torch.contiguous_format)
        _p2p(dist.recv, out, peer, tag)
        return out

    @staticmethod
    def backward(ctx, g):
        _p2p(dist.send, g, ctx.peer, ctx.tag)
        return torch.zeros_like(g), None, None


def stage_recv(like: torch.Tensor, peer: int, tag: int) -> torch.Tensor:
    """The tensor rank ``peer`` (the previous stage) sends, of ``like``'s
    shape and dtype; the backward sends its gradient back to ``peer`` and
    gives ``like`` a zero gradient (``like`` ties the stage to what made
    it, so every rank's parameters receive a gradient)."""
    return _StageRecv.apply(like, peer, tag)


class _FromLast(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dep, like, group, src, last):
        ctx.last = last
        out = (x.detach().clone(memory_format=torch.contiguous_format)
               if last else torch.empty_like(
                   like, memory_format=torch.contiguous_format))
        dist.broadcast(out, src=src, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.last:
            return g, None, None, None, None, None
        return None, g.new_zeros(()), None, None, None, None


def from_last_stage(x, dep, like: torch.Tensor, group, src: int,
                    last: bool) -> torch.Tensor:
    """The last stage's ``x`` on every rank of the pp ``group`` (``src``
    its global rank; ``like`` a tensor of its shape and dtype). On the
    last stage (``last``) the backward passes the gradient to ``x``; on
    the others it passes a zero to ``dep`` (their :func:`stage_send`
    tokens), whose backwards then receive the real gradients."""
    return _FromLast.apply(x, dep, like, group, src, last)
