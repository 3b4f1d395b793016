"""GPipe pipeline parallelism over the HAET block stack.

Counterpart of ``haet_tpu/parallel/pipeline.py``. The models are
``embedding -> L identical pre-LN blocks -> LN + Linear head``, and between
blocks the only traffic is the activation ``fx [B, N, C]``, so the stack is
a pipeline:

* the ``L`` blocks are split into ``S = mesh.shape["pp"]`` contiguous
  stages of ``L / S`` blocks; their parameters and buffers are **stacked on
  a leading layer axis**, and each rank holds only its stage's ``[L / S,
  ...]`` part (and, under ``Trainer``, only those Adam moments): the memory
  point of pp;
* the batch is split into ``M`` microbatches, which stream from stage to
  stage. JAX runs every stage for all ``M + S - 1`` ticks under a
  ``shard_map`` and hops with ``lax.ppermute``; here each rank runs only
  its own stage, on real microbatches only (GPipe's forward, then
  autograd's reverse), and the hop is point to point
  (:func:`~haet_torch.parallel.collectives.stage_send` /
  :func:`~haet_torch.parallel.collectives.stage_recv`, whose backwards pass
  the gradient back a stage). Every pp rank returns the last stage's
  outputs (:func:`~haet_torch.parallel.collectives.from_last_stage`, JAX's
  ``psum`` over pp), and the head's loss counts once;
* ``remat=True`` checkpoints each block (per microbatch), recomputing it in
  the backward with the forward's dropout masks
  (:func:`~haet_torch.models.components.dropout.checkpoint_contexts`).

Semantics kept from JAX, not improved (``:24-72``):

* **dp** (``dp_axis``): each dp rank runs the pipeline on its rows.
  Microbatches are strided, microbatch ``m`` being rows ``b * M + m``, and
  a dp rank holds a contiguous block of ``b``. A batch that ``M * dp``
  does not divide is padded with wraparound copies, and the pad rows are
  sliced off the output (``:330-333``).
* The pseudo-position min-max of physics attention is taken per
  (microbatch x dp shard), inside the stage: not the batch-global
  reduction of the unpipelined dp path. Exact at ``M = 1``, ``dp = 1``.
* Train-mode BatchNorm chains its statistics across a stage's
  microbatches, in order and over real microbatches only; it is per dp
  shard, and the running statistics are averaged over dp on exit
  (``:393-399, 432-435``).
* Dropout masks depend on (dp shard, global layer, microbatch), not on the
  stage count: every rank draws the masks of every layer and microbatch
  from the model's generator in one order, for the global microbatch, and
  keeps its layers' and its rows' (``Dropout.feed``, the test hook, is
  taken as it is).
* **head TP**: a model built with ``shard_axes=(batch_axis, "tp")`` on a
  ``(dp, pp, tp)`` mesh (:func:`~haet_torch.parallel.mesh.make_pp_mesh`)
  runs each stage's attention on the rank's ``H / tp`` heads, as the
  unpipelined path does.

**The kernels.** JAX refuses ``use_pallas`` and ``use_pallas_erwin``
inside the pipeline (``:185-190``), because the fused kernels' own
``shard_map`` cannot nest in the pipeline's: a limit of its tracing, not
another function. The port has no such nesting: each stage runs its blocks
with the model's kernel flags at the rank's local shapes, as the meshed
ranks do, and a kernel that cannot launch raises. This departs from JAX's
validation on purpose.

:func:`split_variables`, :func:`merge_variables` and
:func:`merge_raw_variables` convert a model's ``state_dict`` to the
stacked layout (``pre.*``, ``layers.*`` with a leading ``[L]``, ``head.*``:
the last block's ``ln_3`` and ``mlp2``) and back (``:100-160``).
:class:`PipelinedModel` keeps its state in that layout, its ``layers.*``
the stage's ``[L / S]`` part; ``Trainer`` checkpoints gather the stages'
stacks, so that a checkpoint is the whole ``[L]`` layout.
"""

from __future__ import annotations

import copy
import functools
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.components.dropout import Dropout, checkpoint_contexts
from ..ops.dense import normalized
from . import tp_ranges
from .collectives import (from_last_stage, gather, group_size, stage_recv,
                          stage_send)
from .mesh import Layout

#: the last block's parameters that belong to the output head
#: (``haet_tpu/parallel/pipeline.py:89``)
HEAD_KEYS = ("ln_3", "mlp2")

__all__ = ["HEAD_KEYS", "PipelinedModel", "merge_raw_variables",
           "merge_variables", "pipelines", "split_variables"]


def _block_key(key: str):
    """``(layer, rest)`` of a ``blocks.{i}.rest`` key, else None."""
    if not key.startswith("blocks."):
        return None
    i, rest = key[len("blocks."):].split(".", 1)
    return int(i), rest


def split_variables(state: dict, n_layers: int) -> dict:
    """A model's ``state_dict`` in the stacked pipeline layout: ``pre.k``
    for every key outside the blocks, ``layers.rest`` stacked ``[L, ...]``
    from ``blocks.{i}.rest``, and ``head.rest`` for the last block's
    :data:`HEAD_KEYS`."""
    out, per = {}, {}
    for k, v in state.items():
        bk = _block_key(k)
        if bk is None:
            out[f"pre.{k}"] = v
            continue
        i, rest = bk
        if rest.split(".", 1)[0] in HEAD_KEYS:
            if i != n_layers - 1:
                raise ValueError(f"{k}: the head belongs to the last block")
            out[f"head.{rest}"] = v
        else:
            per.setdefault(rest, {})[i] = v
    for rest, layers in per.items():
        if sorted(layers) != list(range(n_layers)):
            raise ValueError(f"blocks.*.{rest}: layers {sorted(layers)} of "
                             f"{n_layers}")
        out[f"layers.{rest}"] = torch.stack(
            [torch.as_tensor(layers[i]) for i in range(n_layers)])
    return out


def merge_variables(pvars: dict, n_layers: int) -> dict:
    """The stacked pipeline layout back to the model's ``state_dict``
    (:func:`split_variables` inverted), as tensors."""
    out = {}
    for k, v in pvars.items():
        part, rest = k.split(".", 1)
        v = torch.as_tensor(v)
        if part == "pre":
            out[rest] = v
        elif part == "head":
            out[f"blocks.{n_layers - 1}.{rest}"] = v
        elif part == "layers":
            if v.shape[0] != n_layers:
                raise ValueError(f"{k}: {v.shape[0]} layers stacked, not "
                                 f"{n_layers}")
            for i in range(n_layers):
                out[f"blocks.{i}.{rest}"] = v[i].clone()
        else:
            raise ValueError(f"{k}: not a key of the pipeline layout")
    return out


def merge_raw_variables(raw: dict) -> dict:
    """A restored checkpoint in the stacked layout (``Checkpointer.
    restore_raw``: a training state, whose ``"model"`` entry is used, or a
    state dict) as the model's ``state_dict``, the layer count inferred
    from the stacked axis. One helper for everything that reads ``--pp``
    checkpoints unpipelined (``car_eval``, ``serve_http``)."""
    state = raw.get("model", raw)
    stacked = [k for k in state if k.startswith("layers.")]
    if not stacked:
        raise ValueError(
            "not a stacked pipeline checkpoint: params has no 'layers' "
            f"subtree (keys: {sorted({k.split('.', 1)[0] for k in state})})")
    n_layers = int(torch.as_tensor(state[stacked[0]]).shape[0])
    return merge_variables(state, n_layers)


def pipelines(module: nn.Module) -> list:
    """The :class:`PipelinedModel` instances inside ``module``."""
    return [m for m in module.modules() if isinstance(m, PipelinedModel)]


class _Head(nn.Module):
    """The last block's ``mlp2(LN_3(h))``, run after the pipeline."""

    def __init__(self, block):
        super().__init__()
        self.ln_3 = block.ln_3
        self.mlp2 = block.mlp2
        self.dtype = block.dtype

    def forward(self, h):
        return self.mlp2(normalized(self.ln_3, h, self.dtype))


def _embedding(model) -> nn.Module:
    """A shallow copy of ``model`` without its blocks: the embedding,
    sharing its parameters, for :meth:`apply_pre`."""
    pre = copy.copy(model)
    pre._modules = {k: v for k, v in model._modules.items()
                    if k != "blocks"}
    pre._parameters = dict(model._parameters)
    pre._buffers = dict(model._buffers)
    pre._non_persistent_buffers_set = set(
        model._non_persistent_buffers_set)
    pre.blocks = nn.ModuleList()
    pre.mesh = None
    return pre


class PipelinedModel(nn.Module):
    """Pipeline-parallel execution of a HAET model over ``mesh``'s pp axis.

    Args:
        model: an ``_HAETBase`` model (2D, 3D or irregular), whose weights
            the pipeline takes: ``pre`` and ``head`` share them, the
            stage's layers are copied into the stacks (drop ``model``
            after, for the memory).
        mesh: a :class:`~haet_torch.parallel.Mesh` with ``pp_axis`` (and
            ``dp_axis`` when given), e.g. :func:`make_pp_mesh`.
        num_microbatches: microbatches per forward; default the stage
            count.
        pp_axis / dp_axis: the mesh's axis names.
        remat: recompute each block in the backward (GPipe's memory
            recipe).

    Every rank calls it with the same global batch, as a bound model;
    each runs its stage on its dp rows and returns the global output. Its
    ``state_dict`` is the stacked layout with this stage's layers
    (:meth:`full_state_dict` gathers every stage's).
    """

    def __init__(self, model, mesh, *, num_microbatches: Optional[int] = None,
                 pp_axis: str = "pp", dp_axis: Optional[str] = None,
                 remat: bool = True):
        super().__init__()
        if pp_axis not in mesh.shape:
            raise ValueError(f"mesh has no {pp_axis!r} axis: {mesh.shape}")
        if dp_axis is not None and dp_axis not in mesh.shape:
            raise ValueError(f"mesh has no {dp_axis!r} axis: {mesh.shape}")
        self.tp_axis = None
        sa = getattr(model.blocks[0].Attn, "shard_axes", None)
        if sa is not None:
            b_ax, h_ax = sa
            if h_ax is not None:
                if h_ax not in mesh.shape:
                    raise ValueError(
                        f"model shard_axes head axis {h_ax!r} is not in "
                        f"the mesh: {dict(mesh.shape)}")
                if h_ax in (pp_axis, dp_axis):
                    raise ValueError(
                        f"head-TP axis {h_ax!r} collides with the "
                        "pipeline's pp/dp axes; use a distinct mesh axis "
                        "(make_pp_mesh(n_tp=...))")
                n_tp = int(mesh.shape[h_ax])
                if n_tp > 1 and int(model.n_head) % n_tp:
                    raise ValueError(
                        f"n_head ({model.n_head}) must be divisible by "
                        f"the tp mesh size ({n_tp})")
                self.tp_axis = h_ax
            if b_ax is not None and b_ax != dp_axis:
                raise ValueError(
                    f"model shard_axes batch axis {b_ax!r} must be the "
                    f"pipeline's dp_axis ({dp_axis!r}) or None — the "
                    "pipeline shards the batch itself")
        self.mesh = mesh
        self.pp_axis = pp_axis
        self.dp_axis = dp_axis
        self.n_stages = int(mesh.shape[pp_axis])
        self.n_layers = int(model.n_layers)
        if self.n_layers % self.n_stages:
            raise ValueError(
                f"n_layers ({self.n_layers}) must be divisible by the "
                f"pipeline stage count ({self.n_stages})")
        self.num_microbatches = int(num_microbatches or self.n_stages)
        if self.num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        self.remat = remat
        self.stage = int(mesh.coords[pp_axis])
        self.local_layers = self.n_layers // self.n_stages
        self.dropout_generator = model.dropout_generator
        self.dropout_rate = float(model.dropout)

        self.pre = _embedding(model)
        self.head = _Head(model.blocks[-1])
        bk = model.block_kwargs()
        bk["attn_kwargs"]["shard_axes"] = (
            (None, self.tp_axis) if self.tp_axis is not None else None)
        device = model.placeholder.device
        block = type(model.blocks[0])(last_layer=False, **bk).to(device)
        lo = self.stage * self.local_layers
        mine = model.blocks[lo:lo + self.local_layers]
        with torch.no_grad():
            for name, _ in list(block.named_parameters()):
                mod, leaf = _owner(block, name)
                mod._parameters[leaf] = nn.Parameter(torch.stack(
                    [b.get_parameter(name).detach() for b in mine]))
            for name, _ in list(block.named_buffers()):
                mod, leaf = _owner(block, name)
                mod._buffers[leaf] = torch.stack(
                    [b.get_buffer(name).detach() for b in mine]).clone()
        #: the stage block's dropouts (one a block)
        self._drops = [d for d in block.modules() if isinstance(d, Dropout)]
        for d in self._drops:
            d.generator = self.dropout_generator
        block.Attn.bind_mesh(mesh)
        #: the stage's blocks: one block whose parameters and buffers are
        #: stacked ``[L / S, ...]``, run layer by layer on their slices
        self.layers = block
        self.train(model.training)

    # -- the state --------------------------------------------------------
    def stacked_tensors(self) -> list:
        """The stage's stacked parameters and buffers (``layers.*``)."""
        return [*self.layers.parameters(), *self.layers.buffers()]

    def to_pipeline_variables(self, state: dict) -> dict:
        return split_variables(state, self.n_layers)

    def from_pipeline_variables(self, pvars: dict) -> dict:
        return merge_variables(pvars, self.n_layers)

    def local_part(self, t):
        """This stage's layers of a stacked ``[L, ...]`` tensor."""
        lo = self.stage * self.local_layers
        return t[lo:lo + self.local_layers]

    def gather_stages(self, t: torch.Tensor) -> torch.Tensor:
        """The whole ``[L, ...]`` stack of the stage's ``[L / S, ...]``
        ``t``, on every rank (a collective over pp)."""
        if self.n_stages == 1:
            return t.detach().clone()
        return gather(t.detach(), self.mesh.group(self.pp_axis), 0)

    def full_state_dict(self) -> dict:
        """The state in the stacked layout with every stage's layers (a
        collective over pp: every rank calls it)."""
        ids = {id(t) for t in self.stacked_tensors()}
        return {k: self.gather_stages(v) if id(v) in ids else v.detach()
                for k, v in self.state_dict(keep_vars=True).items()}

    def load_full_state_dict(self, state: dict) -> None:
        """Load a stacked-layout state with every stage's layers (e.g.
        :func:`split_variables` of a model's), keeping this stage's."""
        self.load_state_dict({k: self.local_part(torch.as_tensor(v))
                              if k.startswith("layers.") else v
                              for k, v in state.items()})

    # -- the gradients ----------------------------------------------------
    def tp_partial_parameters(self) -> list:
        """The stacked parameters whose gradients are parts over tp."""
        return self.layers.Attn.head_sharded_parameters()

    def reduce_gradients(self, flat, params: list) -> None:
        """Sum one step's flat gradient buffer of ``params`` over the
        mesh, in place: the head-sharded parameters' parts over tp, the
        embedding's over pp (only stage 0 uses it), and the whole over dp
        (each dp rank ran its rows)."""
        mesh = self.mesh
        if self.tp_axis is not None and mesh.size(self.tp_axis) > 1:
            for lo, hi in tp_ranges(params, self.tp_partial_parameters()):
                dist.all_reduce(flat[lo:hi], group=mesh.group(self.tp_axis))
        if self.n_stages > 1:
            for lo, hi in tp_ranges(params, list(self.pre.parameters())):
                dist.all_reduce(flat[lo:hi], group=mesh.group(self.pp_axis))
        if self.dp_axis is not None and mesh.size(self.dp_axis) > 1:
            dist.all_reduce(flat, group=mesh.group(self.dp_axis))

    def grad_norm(self, params: list) -> torch.Tensor:
        """The L2 norm of the whole model's gradient (every stage's layers,
        the embedding and the head once), on every rank, from the reduced
        gradients of ``params`` (a collective over pp)."""
        ids = {id(t) for t in self.stacked_tensors()}
        sq = [torch.stack([torch.linalg.vector_norm(p.grad)
                           for p in params if (id(p) in ids) == staged]
                          ).square().sum() for staged in (True, False)]
        if self.n_stages > 1:
            dist.all_reduce(sq[0], group=self.mesh.group(self.pp_axis))
        return (sq[0] + sq[1]).sqrt()

    # -- the forward ------------------------------------------------------
    def _n_dp(self) -> int:
        return self.mesh.size(self.dp_axis) if self.dp_axis else 1

    def forward(self, x, fx=None, T=None):
        B = x.shape[0]
        M, n_dp = self.num_microbatches, self._n_dp()
        unit = M * n_dp
        b_pad = -(-B // unit) * unit
        per = b_pad // n_dp
        d = self.mesh.coords[self.dp_axis] if self.dp_axis else 0
        rows = (torch.arange(d * per, (d + 1) * per, device=x.device) % B
                if b_pad != B else slice(d * per, (d + 1) * per))
        x = x[rows]
        fx = None if fx is None else fx[rows]
        T = None if T is None else T[rows]
        h = self.pre.apply_pre(x, fx, T)
        h = self._pipeline(h, b_pad)
        y = self.head(h)
        if n_dp > 1:
            y = gather(y, self.mesh.group(self.dp_axis), 0)
        return y[:B]

    def _masks(self, b_pad: int, shape, device) -> Optional[dict]:
        """``{(local layer, microbatch): keep mask}`` of this rank's layers
        and rows, drawn for every layer and microbatch in one order, or
        None (no dropout in this forward, or masks fed)."""
        if (not self.training or self.dropout_rate == 0.0
                or self.dropout_rate == 1.0
                or any(d.feed for d in self._drops)):
            return None
        M, keep = self.num_microbatches, 1.0 - self.dropout_rate
        bl = shape[0]
        d = self.mesh.coords[self.dp_axis] if self.dp_axis else 0
        lo = self.stage * self.local_layers
        out = {}
        for gl in range(self.n_layers):
            for m in range(M):
                mask = torch.rand((b_pad // M, *shape[1:]),
                                  generator=self.dropout_generator,
                                  device=device) < keep
                if lo <= gl < lo + self.local_layers:
                    out[(gl - lo, m)] = mask[d * bl:(d + 1) * bl]
        return out

    def _slices(self, i: int) -> dict:
        return {**{k: p[i] for k, p in self.layers.named_parameters()},
                **{k: b[i] for k, b in self.layers.named_buffers()}}

    def _call_layer(self, h, i: int, layout):
        return torch.func.functional_call(self.layers, self._slices(i),
                                          (h, layout))

    def _layer(self, h, i: int, layout, mask):
        if mask is not None:
            for dr in self._drops:
                dr.replay = iter([mask])
        try:
            if self.remat and torch.is_grad_enabled():
                return checkpoint(
                    self._call_layer, h, i, layout, use_reentrant=False,
                    preserve_rng_state=False,
                    context_fn=functools.partial(checkpoint_contexts,
                                                 self.layers))
            return self._call_layer(h, i, layout)
        finally:
            if mask is not None:
                for dr in self._drops:
                    dr.replay = None

    def _pipeline(self, h, b_pad: int):
        """This rank's stage over the ``M`` microbatches of its rows ``h
        [per, N, C]``; returns the last stage's outputs, in ``h``'s row
        order, on every pp rank."""
        S, M, s = self.n_stages, self.num_microbatches, self.stage
        per, n, c = h.shape
        bl = per // M
        micro = h.view(bl, M, n, c)
        layout = Layout(self.mesh, False, False, bl, n)
        masks = self._masks(b_pad, (bl, n, c), h.device)
        prev = self.mesh.rank_of(**{self.pp_axis: s - 1}) if s > 0 else None
        nxt = self.mesh.rank_of(**{self.pp_axis: s + 1}) if s < S - 1 \
            else None
        outs, tokens = [], []
        for m in range(M):
            a = micro[:, m]
            if prev is not None:
                a = stage_recv(a, prev, m)
            for i in range(self.local_layers):
                a = self._layer(a, i, layout,
                                None if masks is None else masks[(i, m)])
            if nxt is not None:
                tokens.append(stage_send(a, nxt, m))
            else:
                outs.append(a)
        if self.training:
            self._average_statistics()
        if S == 1:
            return torch.stack(outs, 1).reshape(per, n, c)
        like = torch.empty((per, n, c), dtype=h.dtype, device=h.device)
        last = s == S - 1
        return from_last_stage(
            torch.stack(outs, 1).reshape(per, n, c) if last else None,
            None if last else torch.stack(tokens).sum(), like,
            self.mesh.group(self.pp_axis),
            self.mesh.rank_of(**{self.pp_axis: S - 1}), last)

    @torch.no_grad()
    def _average_statistics(self) -> None:
        """The BatchNorm running statistics averaged over dp (each dp rank
        normalised its own rows), ``:432-435``."""
        if self._n_dp() == 1:
            return
        group = self.mesh.group(self.dp_axis)
        for name, b in self.layers.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                dist.all_reduce(b, group=group)
                b.div_(group_size(group))


def _owner(module: nn.Module, name: str):
    """``(submodule, leaf)`` holding the parameter or buffer ``name``."""
    path, _, leaf = name.rpartition(".")
    return (module.get_submodule(path) if path else module), leaf
