"""Dynamic request batching over exported programs.

Counterpart of ``haet_tpu/serve.py`` (``export_batch_family``,
``export_point_family``, ``ServerStats``, ``BatchingServer``) with the same
contract, over the port's ``torch.export`` artifacts
(:mod:`haet_torch.export`):

* **Batch is part of the program.** :func:`export_batch_family` writes one
  artifact per batch size of one sample signature, and
  :func:`export_point_family` one such family per point-count bucket, for
  ragged point clouds (ShapeNet-Car meshes span ~29-38k points).
* **Dynamic batching without padding.** :class:`BatchingServer` queues
  single-sample requests, groups those of one signature (shapes, dtypes and
  absent inputs) and dispatches the largest exported batch size the queue
  can fill; a remainder rides smaller programs. A queue is ready once it
  fills its largest program or its oldest request has waited
  ``max_delay_s``; among ready queues the oldest head goes first, so one
  signature never blocks another. Requests of another signature or dtype
  are rejected at ``submit``; ``max_queue`` bounds the queued requests;
  cancelled futures are dropped before dispatch.
* **Explicit padding only.** ``pad_to_batch`` fills an aged-out group's
  smallest program with copies of its last sample, ``pad_to_points`` pads a
  cloud's points (repeat-last row) to the smallest exported point bucket
  and truncates the answer back. Both are opt-in.
* **pipeline_depth.** With 2 or more, a delivery thread owns the fetch of
  each batch to the host and the futures, so the dispatcher assembles and
  dispatches batch k+1 while batch k's answer is on its way. On one CUDA
  stream a blocking ``.cpu()`` in that thread would also wait for batch
  k+1's kernels, queued before the copy; so each batch's device-to-host copy
  is queued into a pinned buffer right after its forward, an event is
  recorded behind it, and the delivery thread waits on that event. A ring
  of ``pipeline_depth`` buffers per output shape serves the batches in
  flight.
* **reload.** A new checkpoint is checked against every program's manifest
  first (a wrong tree raises and the old weights keep serving), then copied
  into the served state in place, under the dispatcher's lock, between
  batches and on the serving stream: batches already dispatched finish on
  the old weights, batches dispatched after ``reload`` returns use the new
  ones.

Batching is not output-neutral for HAET: the Erwin pseudo-positions are
min-max normalised over the whole batch (``physics_attention.py``), so a
served sample's output depends on the samples dispatched with it (and on
``pad_to_batch``'s copies), exactly as in the JAX reference.

A rollout artifact (``haet_torch.export.save_rollout_artifact``) serves
here as a forward's does: its requests are ``(pos, fx0)`` and its answers
``[N, steps * step_width]``.

**Over a mesh** (JAX ``:60-145, 440-452``). :func:`export_batch_family` and
:func:`export_point_family` take ``mesh=`` and ``data_axis=`` and check
every batch size against dp before anything is written. JAX's server is
one process over many devices; the port runs one process per rank, so a
bundle loaded with ``mesh=`` is served by a :class:`BatchingServer` on rank
0 and by :func:`follow` on every other rank. Rank 0 batches; before each
dispatch it broadcasts the batch's signature and inputs over the mesh, and
each follower runs its part of the same program with it. ``reload``
broadcasts the new weights, and ``close`` sends the followers home.
``pad_to_batch`` is on by default iff dp > 1, where a lone request can
never fill a program.
"""

from __future__ import annotations

import collections
import contextlib
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import export as hexport
from .utils.env import default_device, host_numpy

__all__ = ["BatchingServer", "export_batch_family", "export_point_family",
           "follow", "ServerStats"]


def export_batch_family(path: str, model: torch.nn.Module, variables,
                        example_args: Sequence[Any],
                        batch_sizes: Sequence[int] = (1, 2, 4, 8), *,
                        mesh=None, data_axis: Optional[str] = "dp",
                        extra_manifest: Optional[dict] = None,
                        _point_bucket: Optional[int] = None) -> str:
    """Write one artifact per batch size under ``path`` (a
    :class:`~haet_torch.export.ServingBundle` root).

    ``example_args`` carries the SINGLE-sample signature: arrays shaped
    ``[1, ...]`` (``None`` for absent optional inputs, e.g. ``fx``). Each
    batch size exports the program again with the leading axis set to
    ``b``. Artifact directories are named by batch size, sample shapes and
    dtypes (the canonical ones the program takes), so several signatures can
    share one bundle root. With ``mesh`` (every rank calls it, rank 0
    writes) each program runs over the mesh (``haet_torch.export``), the
    batch split over ``data_axis``, whose size must divide every batch
    size: checked for all of them before anything is written.
    """
    if extra_manifest:
        # batch_size is measured per artifact, and point_bucket is the
        # pad_to_points marker only export_point_family may stamp
        reserved = {"batch_size", "point_bucket"} & set(extra_manifest)
        if reserved:
            raise ValueError(
                f"extra_manifest keys {sorted(reserved)} are reserved "
                "(measured/marker fields of the family itself)")
    dts = hexport._canonical_input_dtypes(example_args)
    sig_tag = "_".join(
        "x".join(str(d) for d in np.shape(a)[1:]) + "-" + dt
        for a, dt in zip([a for a in example_args if a is not None], dts))
    sizes = sorted({int(b) for b in batch_sizes})
    bad = [b for b in sizes if b < 1]
    if bad:
        raise ValueError(f"batch sizes must be >= 1, got {bad}")
    if mesh is not None and data_axis is not None:
        # every size before anything is written: a half-written family
        # would serve with sizes silently missing
        n_dp = int(mesh.shape[data_axis])
        bad = [b for b in sizes if b % n_dp]
        if bad:
            raise ValueError(
                f"batch sizes {bad} do not divide the '{data_axis}' mesh "
                f"axis ({n_dp}); pass multiples of the data-parallel "
                f"degree (e.g. batch_sizes="
                f"{tuple(n_dp * m for m in (1, 2, 4))}), or data_axis=None "
                "for replicated inputs (head-TP)")
    for b in sizes:
        ex_b = tuple(None if a is None else np.broadcast_to(
            _host(a), (b,) + np.shape(a)[1:]).copy() for a in example_args)
        extra = dict(extra_manifest or {})
        extra["batch_size"] = b
        if _point_bucket is not None:
            extra["point_bucket"] = int(_point_bucket)
        hexport.save_artifact(os.path.join(path, f"b{b}_{sig_tag}"), model,
                              variables, ex_b, extra_manifest=extra,
                              mesh=mesh, data_axis=data_axis)
    return path


def export_point_family(path: str, model: torch.nn.Module, variables,
                        example_args: Sequence[Any],
                        point_buckets: Sequence[int],
                        batch_sizes: Sequence[int] = (1, 2, 4, 8), *,
                        mesh=None, data_axis: Optional[str] = "dp",
                        extra_manifest: Optional[dict] = None) -> str:
    """:func:`export_batch_family` over POINT-COUNT buckets: one batch
    family per N in ``point_buckets``, all under one bundle root, each
    manifest marked ``point_bucket`` (the marker ``pad_to_points`` keys
    on). ``example_args`` carries the single-sample signature at any point
    count, every array shaped ``[1, N, ...]`` with one shared N; each bucket
    resizes axis 1 by repeat-last-row extension or truncation (only shapes
    and dtypes matter for export)."""
    for i, a in enumerate(example_args):
        if a is not None and np.ndim(a) < 2:
            raise ValueError(
                f"point families need every array arg shaped [1, N, ...] "
                f"(a shared point axis 1) — arg {i} has shape "
                f"{np.shape(a)}; per-sample scalars/vectors cannot ride "
                "point buckets")
    ns = {np.shape(a)[1] for a in example_args if a is not None}
    if len(ns) != 1:
        raise ValueError(
            f"example args disagree on the point axis (axis 1): {ns}")
    n0 = ns.pop()
    if extra_manifest and "point_bucket" in extra_manifest:
        raise ValueError("extra_manifest key 'point_bucket' is reserved "
                         "(it is the marker pad_to_points keys on)")
    for n in sorted({int(n) for n in point_buckets}):
        if n < 1:
            raise ValueError(f"point buckets must be >= 1, got {n}")
        idx = np.minimum(np.arange(n), n0 - 1)
        ex_n = tuple(None if a is None else np.take(_host(a), idx, axis=1)
                     for a in example_args)
        export_batch_family(path, model, variables, ex_n,
                            batch_sizes=batch_sizes, mesh=mesh,
                            data_axis=data_axis,
                            extra_manifest=extra_manifest, _point_bucket=n)
    return path


def _host(a) -> np.ndarray:
    """An example input (array or tensor) as a host array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class ServerStats:
    """Counters the dispatcher and delivery threads update; all access
    under ``self.lock``."""

    def __init__(self, latency_window: int = 1024):
        self.lock = threading.Lock()
        self.requests = 0
        self.dispatches = 0
        # requests whose queue wait was accumulated: the mean's denominator
        self.dispatched_requests = 0
        # requests whose result (or error) reached the caller
        self.delivered = 0
        self.batch_histogram = collections.Counter()
        self.queue_wait_s_total = 0.0
        # samples pad_to_batch synthesised, points pad_to_points did
        self.padded_samples = 0
        self.padded_points = 0
        # the newest submit->result latencies for percentiles, and the
        # count and sum of all of them (a Prometheus summary's _count/_sum)
        self.latencies_s = collections.deque(maxlen=latency_window)
        self.latency_count = 0
        self.latency_s_total = 0.0

    @staticmethod
    def _pct(xs, q: float):
        if not xs:
            return None
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def add_latency(self, seconds: float) -> None:
        """Record one request's latency (caller holds ``self.lock``)."""
        self.latencies_s.append(seconds)
        self.latency_count += 1
        self.latency_s_total += seconds

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_s)
            return {
                "requests": self.requests,
                "dispatches": self.dispatches,
                "delivered": self.delivered,
                "batch_histogram": dict(self.batch_histogram),
                "mean_queue_wait_s": (
                    self.queue_wait_s_total / self.dispatched_requests
                    if self.dispatched_requests else 0.0),
                "latency_p50_s": self._pct(lat, 0.50),
                "latency_p95_s": self._pct(lat, 0.95),
                "latency_count": self.latency_count,
                "latency_sum_s": self.latency_s_total,
                "padded_samples": self.padded_samples,
                "padded_points": self.padded_points,
            }


class _Request:
    __slots__ = ("args", "key", "future", "t_enqueued", "orig_n",
                 "n_padded")

    def __init__(self, args, key, orig_n=None, n_padded=None):
        self.args = args
        self.key = key
        self.future: Future = Future()
        self.t_enqueued = time.perf_counter()
        # pad_to_points: the caller's point count and the bucket's
        self.orig_n = orig_n
        self.n_padded = n_padded


class _Pending:
    """A batch's answer on its way to a pinned host buffer: ready once
    ``event`` has completed."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


#: what rank 0 broadcasts to the followers of a mesh bundle
_RUN, _RELOAD, _STOP = 1, 2, 3


class _MeshLink:
    """The dispatches of a mesh bundle crossing from rank 0 to the other
    ranks: a header ``[command, signature index]`` broadcast over the
    mesh, then the batch's inputs (or a checkpoint's tensors), each on the
    bundle's device. The signatures are the bundle's, in ``shapes()``
    order, the same on every rank that loaded the one directory."""

    def __init__(self, bundle):
        self.keys = list(bundle.shapes())
        self.device = bundle.device
        models = list(bundle._by_key.values())
        self.dtypes = [tuple(bundle._by_key[k].manifest["input_dtypes"])
                       for k in self.keys]
        self.spec = models[0].manifest["variables"]

    def _header(self, cmd: int = 0, idx: int = 0) -> tuple:
        t = torch.tensor([cmd, idx], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return tuple(t.tolist())

    def _tensors(self, shapes, dtypes, values=None) -> list:
        out = []
        for i, (shape, dt) in enumerate(zip(shapes, dtypes)):
            if values is None:
                t = torch.empty(shape, dtype=getattr(torch, dt),
                                device=self.device)
            else:
                t = hexport._to_device(values[i], self.device, dt)
                t = t.contiguous()
            dist.broadcast(t, src=0)
            out.append(t)
        return out

    def send_run(self, args) -> None:
        arrays = [a for a in args if a is not None]
        key = tuple(tuple(np.shape(a)) for a in arrays)
        idx = self.keys.index(key)
        self._header(_RUN, idx)
        self._tensors(key, self.dtypes[idx], arrays)

    def send_reload(self, variables) -> None:
        self._header(_RELOAD)
        names = sorted(self.spec)
        self._tensors([self.spec[k][0] for k in names],
                      [self.spec[k][1] for k in names],
                      [variables[k] for k in names])

    def send_stop(self) -> None:
        self._header(_STOP)

    def receive(self):
        """``(command, payload)`` of rank 0's next message: the batch's
        inputs for a run, the state dict for a reload."""
        cmd, idx = self._header()
        if cmd == _RUN:
            return cmd, self._tensors(self.keys[idx], self.dtypes[idx])
        if cmd == _RELOAD:
            names = sorted(self.spec)
            return cmd, dict(zip(names, self._tensors(
                [self.spec[k][0] for k in names],
                [self.spec[k][1] for k in names])))
        return cmd, None


def follow(bundle, variables) -> None:
    """Serve a mesh bundle's other ranks: bind ``variables`` and run each
    dispatch rank 0's :class:`BatchingServer` broadcasts (its part of the
    same program, over the mesh), load each checkpoint it reloads, and
    return when it closes. Every rank but 0 calls this with the bundle
    loaded from the same directory with its mesh."""
    if getattr(bundle, "mesh", None) is None:
        raise ValueError("follow() serves a bundle loaded with mesh=")
    link = _MeshLink(bundle)
    bound = bundle.bind(variables)
    while True:
        cmd, payload = link.receive()
        if cmd == _STOP:
            return
        if cmd == _RUN:
            bound.predict(*payload)
        elif cmd == _RELOAD:
            bound.update(payload)


class BatchingServer:
    """Groups single-sample requests into the largest exported batches.

    Args:
        bundle: a :class:`~haet_torch.export.ServingBundle` (e.g.
            :func:`export_batch_family` then ``ServingBundle.load``), a
            :class:`~haet_torch.export.BoundBundle`, or any object with
            ``shapes()`` and ``predict(variables, *batch)``.
        variables: the model's state dict, served by every program (unused
            for a bound bundle).
        max_delay_s: how long the oldest queued request may wait for
            co-batchable traffic before dispatch (0 = immediately).
        max_queue: backpressure bound; ``submit`` raises when full.
        pad_to_batch: a group that ages out below the smallest exported
            batch fills that program with copies of its last sample (their
            answers are discarded) instead of failing. None (the default):
            on iff the bundle's programs split the batch over dp > 1.
        pad_to_points: opt-in: a sample whose point count N has no program
            is padded along axis 0 of every input (repeat-last row, as
            training pads) to the smallest exported point bucket that
            fits, and the answer's rows are truncated back to N. NOT
            output-exact: the rep-slice softmax normalises over all points,
            so the copies shift the real ones' slice statistics (the
            deviation shrinks as N nears the bucket). Only families
            exported by :func:`export_point_family` are pad targets.
        pipeline_depth: batches in flight at once; 1 = synchronous, 2 or
            more = a delivery thread fetches and delivers (module
            docstring).
        device: where the programs run; ``None`` means CUDA (raises without
            a card). A loaded bundle must be for this device's type.

    A bundle loaded with ``mesh=`` is served by this server on rank 0 and
    by :func:`follow` on the other ranks (module docstring).

    Use as a context manager or call :meth:`close`.
    """

    def __init__(self, bundle, variables, *, max_delay_s: float = 0.002,
                 max_queue: int = 1024, pad_to_batch: Optional[bool] = None,
                 pad_to_points: bool = False, pipeline_depth: int = 1,
                 device=None):
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.device = default_device(device)
        bdev = getattr(bundle, "device", None)
        if bdev is not None and bdev.type != self.device.type:
            raise ValueError(f"the bundle's programs run on {bdev}, the "
                             f"server on {self.device}")
        self.bundle = bundle
        self.variables = variables
        mesh = getattr(bundle, "mesh", None)
        #: rank 0's link to the followers of a mesh bundle
        self._link = None
        if mesh is not None:
            if dist.get_rank() != 0:
                raise ValueError("a mesh bundle is batched on rank 0; the "
                                 "other ranks call serve.follow()")
            self._link = _MeshLink(bundle)
        if pad_to_batch is None:
            pad_to_batch = mesh is not None and mesh.size("dp") > 1 and any(
                m.manifest.get("data_axis") == "dp"
                for m in bundle._by_key.values())
        if isinstance(bundle, hexport.BoundBundle):
            # checked when it was bound
            self._bound = bundle
        else:
            self._validate_variables(variables)
            self._bound = (bundle.bind(variables)
                           if hasattr(bundle, "bind") else None)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self.pad_to_batch = bool(pad_to_batch)
        self.pad_to_points = bool(pad_to_points)
        self.stats = ServerStats()
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)

        # batch sizes per single-sample signature (shapes without the batch
        # axis), the dtypes the manifests want, and the point-bucket ones
        self._sizes_by_sig: dict = {}
        self._dtypes_by_sig: dict = {}
        self._point_bucket_sigs: set = set()
        for key in bundle.shapes():
            if any(len(s) == 0 for s in key):
                continue  # a scalar input: no batch axis to group over
            batches = {s[0] for s in key}
            if len(batches) != 1:
                continue  # mixed leading axes: not a batchable signature
            sig = tuple(tuple(s[1:]) for s in key)
            self._sizes_by_sig.setdefault(sig, []).append(int(batches.pop()))
            model = getattr(bundle, "_by_key", {}).get(key)
            manifest = getattr(model, "manifest", None) or {}
            if manifest.get("point_bucket") is not None:
                self._point_bucket_sigs.add(sig)
            dts = manifest.get("input_dtypes")
            if dts is not None:
                prev = self._dtypes_by_sig.get(sig)
                if prev is not None and prev != tuple(dts):
                    # at construction, not at dispatch, where it would fail
                    # every co-batched request
                    raise ValueError(
                        f"inconsistent artifact family: batch sizes of "
                        f"sample signature {sig} were exported with "
                        f"different input dtypes ({prev} vs "
                        f"{tuple(dts)}); re-export the family with one "
                        "dtype (or use separate bundle roots)")
                self._dtypes_by_sig[sig] = tuple(dts)
        for sizes in self._sizes_by_sig.values():
            sizes.sort(reverse=True)

        self._lock = threading.Condition()
        # held while a batch is assembled and queued on the device, and by
        # reload's copy: the copy lands between batches
        self._run_lock = threading.Lock()
        self._queues: dict = collections.defaultdict(collections.deque)
        self._closed = False
        # pinned answer buffers, pipeline_depth per output shape and dtype
        self._rings: dict = {}
        # pipeline_depth > 1: dispatched batches ride _fetch_q to the
        # delivery thread; the in-flight bound is the semaphore, acquired
        # before a batch is dispatched and released once it is delivered
        self._fetch_q = None
        self._delivery_thread = None
        self._inflight = None
        if self.pipeline_depth > 1:
            self._fetch_q = queue.Queue()
            self._inflight = threading.Semaphore(self.pipeline_depth)
            self._delivery_thread = threading.Thread(
                target=self._delivery_loop, daemon=True,
                name="haet-torch-delivery")
            self._delivery_thread.start()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True,
                                        name="haet-torch-dispatcher")
        self._thread.start()

    def _validate_variables(self, variables) -> None:
        """Check a checkpoint against the programs' manifests now, not on
        the first request."""
        for m in getattr(self.bundle, "_by_key", {}).values():
            check = getattr(m, "_check_variables", None)
            if check is not None:
                check(variables)

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    # -- client side ----------------------------------------------------

    def _point_bucket_for(self, sig):
        """``(N_bucket, signature)`` of the smallest exported point bucket
        reachable from ``sig`` by padding the point axis (axis 0 of every
        array arg, all sharing one N), or None. Trailing dims must match
        exactly, and only families marked ``point_bucket`` qualify."""
        if any(len(s) == 0 for s in sig):
            return None  # a scalar arg has no point axis to pad
        n_set = {s[0] for s in sig}
        if len(n_set) != 1:
            return None
        n = n_set.pop()
        best = None
        for cand in self._point_bucket_sigs:
            if len(cand) != len(sig):
                continue
            np_set = {c[0] for c in cand if len(c)}
            if len(np_set) != 1:
                continue
            n_pad = np_set.pop()
            if n_pad < n:
                continue
            if all(c[1:] == s[1:] for c, s in zip(cand, sig)):
                if best is None or n_pad < best[0]:
                    best = (n_pad, cand)
        return best

    def submit(self, *args) -> Future:
        """Enqueue ONE sample (arrays without the batch axis, ``None`` for
        absent optional inputs). The Future's result is this sample's
        output as a numpy array, batch axis stripped (a bf16 output as its
        exact float32 widening)."""
        arrs = tuple(None if a is None else np.asarray(a) for a in args)
        sig = tuple(tuple(np.shape(a)) for a in arrs if a is not None)
        orig_n = n_padded = None
        if sig not in self._sizes_by_sig and self.pad_to_points:
            bucket = self._point_bucket_for(sig)
            if bucket is not None:
                n_padded, target = bucket
                orig_n = sig[0][0]
                # repeat-last-row padding, the policy training uses
                arrs = tuple(
                    None if a is None else np.concatenate(
                        [a, np.repeat(a[-1:], n_padded - orig_n, axis=0)])
                    for a in arrs)
                sig = target
        if sig not in self._sizes_by_sig:
            if self.pad_to_points:
                hint = (" (no point-bucket artifact fits: pad_to_points "
                        "only pads onto families exported via "
                        "export_point_family — bucketed signatures "
                        f"here: {sorted(self._point_bucket_sigs)})")
            else:
                hint = (" (pad_to_points=True would serve smaller point "
                        "counts through the nearest larger "
                        "export_point_family bucket)")
            raise ValueError(
                f"no artifact family for sample signature {sig}; "
                f"available: {sorted(self._sizes_by_sig)}{hint}")
        dtypes = tuple(a.dtype.name for a in arrs if a is not None)
        want = self._dtypes_by_sig.get(sig)
        if want is not None and dtypes != want:
            # here: in a batch it would promote the stack and fail every
            # co-batched request
            raise ValueError(
                f"dtype mismatch: artifact family expects {want}, got "
                f"{dtypes}. Cast the inputs explicitly (no implicit casts "
                "at the serving boundary).")
        # co-batching key: shapes, dtypes and the None positions
        none_mask = tuple(a is None for a in arrs)
        req = _Request(arrs, (sig, dtypes, none_mask), orig_n=orig_n,
                       n_padded=n_padded)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.max_queue:
                raise RuntimeError(
                    f"queue full ({depth} >= max_queue={self.max_queue})")
            self._queues[req.key].append(req)
            with self.stats.lock:
                self.stats.requests += 1
                if orig_n is not None:
                    self.stats.padded_points += n_padded - orig_n
            self._lock.notify()
        return req.future

    def predict(self, *args, timeout: Optional[float] = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(*args).result(timeout=timeout)

    # -- dispatcher side ------------------------------------------------

    @staticmethod
    def _deliver(future: Future, fn, *args):
        """set_result/set_exception tolerant of client-cancelled futures
        (an InvalidStateError would kill the thread and hang the rest)."""
        try:
            fn(future, *args)
        except Exception:  # noqa: BLE001 - cancelled by its client
            pass

    def _take_group(self):
        """Under the lock: ``((key, [requests], pad_to), wait)`` to
        dispatch, or ``(None, seconds to wait or None)``. Cancelled
        requests are purged before the readiness test; after a queue is
        strand-failed the scan starts again, since another queue may be
        ready now."""
        while True:
            now = time.perf_counter()
            pick, pick_t, wait = None, None, None
            for key, q in self._queues.items():
                if any(r.future.cancelled() for r in q):
                    alive = [r for r in q if not r.future.cancelled()]
                    q.clear()
                    q.extend(alive)
                if not q:
                    continue
                sizes = self._sizes_by_sig[key[0]]
                head_t = q[0].t_enqueued
                if (len(q) >= sizes[0] or now - head_t >= self.max_delay_s
                        or self._closed):
                    if pick_t is None or head_t < pick_t:
                        pick, pick_t = key, head_t
                else:
                    remaining = self.max_delay_s - (now - head_t)
                    wait = remaining if wait is None else min(wait,
                                                              remaining)
            if pick is None:
                return None, wait
            sizes = self._sizes_by_sig[pick[0]]
            q = self._queues[pick]
            pad_to = None
            if len(q) < sizes[-1]:
                if self.pad_to_batch:
                    take, pad_to = len(q), sizes[-1]
                else:
                    # aged out below the smallest program: fail fast
                    n_stranded = len(q)
                    while q:
                        self._deliver(
                            q.popleft().future, Future.set_exception,
                            ValueError(
                                f"{n_stranded} queued request(s) for "
                                f"signature {pick[0]} cannot fill the "
                                f"smallest exported batch size "
                                f"({sizes[-1]}); export a b1 artifact "
                                "(export_batch_family includes 1 by "
                                "default), pass pad_to_batch=True, or send "
                                "more traffic within max_delay_s"))
                    continue
            else:
                take = next(s for s in sizes if s <= len(q))
            return (pick, [q.popleft() for _ in range(take)], pad_to), wait

    def _dispatch_loop(self):
        try:
            while True:
                with self._lock:
                    group, wait = self._take_group()
                    while group is None:
                        if self._closed and not any(self._queues.values()):
                            return
                        self._lock.wait(timeout=wait)
                        group, wait = self._take_group()
                _, reqs, pad_to = group
                if self._inflight is not None:
                    self._inflight.acquire()
                try:
                    pending = self._dispatch_batch(reqs, pad_to)
                except Exception as e:  # noqa: BLE001 - to every caller
                    if self._inflight is not None:
                        self._inflight.release()
                    with self.stats.lock:
                        self.stats.delivered += len(reqs)
                    for r in reqs:
                        self._deliver(r.future, Future.set_exception, e)
                    continue
                t = time.perf_counter()
                with self.stats.lock:
                    self.stats.dispatches += 1
                    self.stats.batch_histogram[len(reqs)] += 1
                    self.stats.dispatched_requests += len(reqs)
                    if pad_to is not None:
                        self.stats.padded_samples += pad_to - len(reqs)
                    for r in reqs:
                        self.stats.queue_wait_s_total += t - r.t_enqueued
                if self._fetch_q is None:
                    self._finish_batch(reqs, pending)
                else:
                    self._fetch_q.put((reqs, pending))
        finally:
            # drain or crash: release the delivery thread after the batches
            # in flight
            if self._fetch_q is not None:
                self._fetch_q.put(None)

    def _delivery_loop(self):
        while True:
            item = self._fetch_q.get()
            if item is None:
                return
            self._finish_batch(*item)

    def _dispatch_batch(self, reqs, pad_to=None):
        """Stack the batch (with pad_to_batch's copies), run its program
        and queue its answer's copy to the host; returns what
        :meth:`_fetch` waits on. Holds the run lock, so that reload's copy
        lands between batches."""
        args = []
        for j in range(len(reqs[0].args)):
            if reqs[0].args[j] is None:
                args.append(None)
                continue
            a = np.stack([r.args[j] for r in reqs])
            if pad_to is not None and pad_to > len(reqs):
                a = np.concatenate(
                    [a, np.repeat(a[-1:], pad_to - len(reqs), axis=0)])
            args.append(a)
        with self._run_lock, self._on_stream():
            return self._start_fetch(self._predict(args))

    def _predict(self, args):
        """The batch's program on ``args`` (over the mesh: the followers
        told first). The caller holds the run lock."""
        if self._link is not None:
            self._link.send_run(args)
        if self._bound is not None:
            return self._bound.predict(*args)
        return self.bundle.predict(self.variables, *args)

    def _start_fetch(self, out):
        """A CUDA answer is copied into the next pinned buffer of its ring,
        with an event behind the copy; anything else passes through."""
        if not (isinstance(out, torch.Tensor) and out.is_cuda):
            return out
        key = (tuple(out.shape), out.dtype)
        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = [
                [torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                 for _ in range(self.pipeline_depth)], 0]
        # batches are delivered in order and at most pipeline_depth are in
        # flight, so this slot's previous batch has been delivered
        host = ring[0][ring[1] % self.pipeline_depth]
        ring[1] += 1
        host.copy_(out, non_blocking=True)
        event = torch.cuda.Event()
        event.record(self._stream)
        return _Pending(host, event)

    @staticmethod
    def _fetch(pending) -> np.ndarray:
        """The batch's answer on the host (a bf16 one widened exactly)."""
        if isinstance(pending, _Pending):
            pending.event.synchronize()
            return np.array(host_numpy(pending.host))  # the slot is reused
        if isinstance(pending, torch.Tensor):
            return host_numpy(pending)
        return np.asarray(pending)

    def _finish_batch(self, reqs, pending):
        """Fetch and deliver one batch. Never raises: a failure is
        delivered to this batch's callers, and the thread lives on."""
        try:
            try:
                host = self._fetch(pending)
            except Exception as e:  # noqa: BLE001 - a device-side failure
                with self.stats.lock:
                    self.stats.delivered += len(reqs)
                for r in reqs:
                    self._deliver(r.future, Future.set_exception, e)
                return
            t = time.perf_counter()
            with self.stats.lock:
                self.stats.delivered += len(reqs)
                for r in reqs:
                    self.stats.add_latency(t - r.t_enqueued)
            try:
                for i, r in enumerate(reqs):
                    res = host[i]
                    if (r.orig_n is not None and np.ndim(res)
                            and len(res) == r.n_padded):
                        res = res[:r.orig_n]  # pad_to_points: the copies go
                    self._deliver(r.future, Future.set_result, res)
            except Exception as e:  # noqa: BLE001 - e.g. a 0-d answer
                for r in reqs:
                    self._deliver(r.future, Future.set_exception, e)
        finally:
            if self._inflight is not None:
                self._inflight.release()

    def reload(self, variables):
        """Serve another checkpoint without a restart.

        The state is checked against every program's manifest first: a
        wrong tree raises here and the old weights keep serving. Then it is
        copied into the served state in place, under the dispatcher's lock
        and on the serving stream: batches already dispatched finish on the
        old weights, batches dispatched after ``reload`` returns use the new
        ones. The programs stay as they are: unlike the JAX server's, there
        is nothing to compile before the swap (no ``warmup``).
        """
        if isinstance(self.bundle, hexport.BoundBundle):
            raise ValueError(
                "this server was built from a caller-bound BoundBundle "
                "(weights already baked in); construct the BatchingServer "
                "from the raw ServingBundle + variables to use reload()")
        self._validate_variables(variables)
        if self._bound is not None:
            with self._run_lock, self._on_stream():
                if self._link is not None:
                    self._link.send_reload(variables)
                self._bound.update(variables)
        self.variables = variables

    def warmup(self):
        """Run a zero-filled batch through every program (all signatures x
        batch sizes), so that no live request pays a first call's costs
        (the allocator, library handles). Families whose manifests lack
        input dtypes are skipped."""
        for sig, sizes in self._sizes_by_sig.items():
            dtypes = self._dtypes_by_sig.get(sig)
            if dtypes is None:
                continue
            for b in sizes:
                batch = tuple(np.zeros((b,) + shape, dtype=dt)
                              for shape, dt in zip(sig, dtypes))
                with self._run_lock, self._on_stream():
                    self._fetch(self._predict(batch))

    # -- lifecycle ------------------------------------------------------

    def close(self, drain: bool = True):
        """Stop the dispatcher. ``drain=True`` serves queued requests
        first; ``drain=False`` fails them with ``RuntimeError``."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    while q:
                        self._deliver(
                            q.popleft().future, Future.set_exception,
                            RuntimeError("server closed before dispatch"))
            self._lock.notify_all()
        self._thread.join()
        if self._delivery_thread is not None:
            self._delivery_thread.join()
        if self._link is not None:
            with self._run_lock:
                self._link.send_stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
