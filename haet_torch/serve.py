"""Dynamic request batching over a torch model.

Counterpart of ``haet_tpu/serve.py:212-560`` (``BatchingServer``,
``ServerStats``) with the same contract, run over an eager torch model under
``torch.inference_mode()`` instead of exported XLA artifacts:

* The server declares its sample signatures up front: for each, the
  per-sample shapes and dtypes of the positional inputs (``None`` for an
  absent optional input such as ``fx``) and the batch sizes it dispatches
  (:class:`SampleSignature`). A request with another signature is rejected
  at ``submit``, and so is a request with the right shapes but other dtypes.
* Greedy dispatch: a queue is ready once it fills its largest batch size or
  its oldest request has waited ``max_delay_s`` (or the server is
  draining); it then dispatches the largest declared batch size the queue
  can fill. Nothing is padded: a remainder rides smaller batch sizes, and a
  queue that ages out below the smallest size fails its requests.
* ``max_queue`` bounds the queued requests (``submit`` raises when full).
* Cancelled futures are dropped before dispatch and never receive a
  result.

Batching is not output-neutral for HAET: the Erwin pseudo-positions are
min-max normalised over the whole batch (``physics_attention.py``), so a
served sample's output depends on the samples dispatched with it, exactly
as in the JAX reference.

Queued here for later slices (``ROADMAP.md``): ``pad_to_batch``,
``pad_to_points``, ``pipeline_depth``, ``reload``, export artifacts and the
HTTP front end.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .utils.env import default_device, host_numpy

__all__ = ["BatchingServer", "SampleSignature", "ServerStats"]


@dataclass(frozen=True)
class SampleSignature:
    """Per-sample input shapes and dtypes (batch axis excluded); ``None``
    marks an absent optional input."""

    shapes: tuple
    dtypes: tuple

    @classmethod
    def of(cls, *args) -> "SampleSignature":
        """The signature of one sample's positional arguments."""
        arrs = [None if a is None else np.asarray(a) for a in args]
        return cls(
            tuple(None if a is None else tuple(a.shape) for a in arrs),
            tuple(None if a is None else a.dtype.name for a in arrs))


#: how many of the newest request latencies ``ServerStats`` keeps
LATENCY_WINDOW = 1024


class ServerStats:
    """Counters the dispatcher updates; all access under ``self.lock``."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.dispatches = 0
        self.dispatched_requests = 0
        self.delivered = 0
        self.batch_histogram = collections.Counter()
        self.queue_wait_s_total = 0.0
        self.latencies_s = collections.deque(maxlen=LATENCY_WINDOW)

    @staticmethod
    def _pct(xs, q: float):
        if not xs:
            return None
        return xs[min(len(xs) - 1, int(q * len(xs)))]

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
            }


class _Request:
    __slots__ = ("args", "sig", "future", "t_enqueued")

    def __init__(self, args, sig):
        self.args = args
        self.sig = sig
        self.future: Future = Future()
        self.t_enqueued = time.perf_counter()


class BatchingServer:
    """Groups single-sample requests into the largest declared batches.

    Args:
        model: a torch module called as ``model(*batched_args)``; it is put
            in eval mode and run under ``torch.inference_mode()``.
        signatures: ``{SampleSignature: power-of-two batch sizes}``.
        max_delay_s: how long the oldest queued request may wait for
            co-batchable traffic before dispatch (0 = immediately).
        max_queue: backpressure bound on queued requests.
        device: where batches run; ``None`` means CUDA (raises without a
            card).

    Use as a context manager or call :meth:`close`.
    """

    def __init__(self, model: torch.nn.Module, signatures: dict, *,
                 max_delay_s: float = 0.002, max_queue: int = 1024,
                 device=None):
        self.device = default_device(device)
        self.model = model.eval()
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)
        self.stats = ServerStats()
        self._sizes: dict = {}
        for sig, sizes in signatures.items():
            sizes = sorted({int(b) for b in sizes}, reverse=True)
            if not sizes or any(b < 1 or b & (b - 1) for b in sizes):
                raise ValueError(
                    f"batch sizes must be powers of two, got {sizes}")
            self._sizes[sig] = sizes
        self._lock = threading.Condition()
        self._queues: dict = collections.defaultdict(collections.deque)
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True,
                                        name="haet-torch-dispatcher")
        self._thread.start()

    # -- client side ----------------------------------------------------

    def submit(self, *args) -> Future:
        """Enqueue ONE sample (arrays without the batch axis, ``None`` for
        absent optional inputs). The Future's result is this sample's output
        as a numpy array (batch axis stripped)."""
        arrs = tuple(None if a is None else np.asarray(a) for a in args)
        sig = SampleSignature.of(*arrs)
        if sig not in self._sizes:
            same_shape = [s for s in self._sizes if s.shapes == sig.shapes]
            if same_shape:
                raise ValueError(
                    f"dtype mismatch: the server expects "
                    f"{same_shape[0].dtypes}, got {sig.dtypes}. Cast the "
                    "inputs explicitly (no implicit casts at the serving "
                    "boundary).")
            raise ValueError(f"no declared signature for sample {sig}; "
                             f"available: {list(self._sizes)}")
        req = _Request(arrs, sig)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            depth = sum(len(q) for q in self._queues.values())
            if depth >= self.max_queue:
                raise RuntimeError(
                    f"queue full ({depth} >= max_queue={self.max_queue})")
            self._queues[sig].append(req)
            with self.stats.lock:
                self.stats.requests += 1
            self._lock.notify()
        return req.future

    def predict(self, *args, timeout: Optional[float] = None):
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(*args).result(timeout=timeout)

    # -- dispatcher side ------------------------------------------------

    @staticmethod
    def _deliver(future: Future, fn, *args):
        """set_result/set_exception tolerant of client-cancelled futures."""
        if future.set_running_or_notify_cancel():
            fn(future, *args)

    def _take_group(self):
        """Under the lock: ``(sig, [requests])`` to dispatch, or
        ``(None, seconds to wait or None)``. Among ready queues the oldest
        head goes first; cancelled requests are dropped here."""
        while True:
            now = time.perf_counter()
            pick, pick_t, wait = None, None, None
            for sig, q in self._queues.items():
                if any(r.future.cancelled() for r in q):
                    alive = [r for r in q if not r.future.cancelled()]
                    q.clear()
                    q.extend(alive)
                if not q:
                    continue
                head_t = q[0].t_enqueued
                if (len(q) >= self._sizes[sig][0]
                        or now - head_t >= self.max_delay_s or self._closed):
                    if pick_t is None or head_t < pick_t:
                        pick, pick_t = sig, head_t
                else:
                    remaining = self.max_delay_s - (now - head_t)
                    wait = remaining if wait is None else min(wait, remaining)
            if pick is None:
                return None, wait
            sizes = self._sizes[pick]
            q = self._queues[pick]
            if len(q) < sizes[-1]:
                # aged out below the smallest declared batch: fail fast
                n_stranded = len(q)
                while q:
                    self._deliver(q.popleft().future, Future.set_exception,
                                  ValueError(
                                      f"{n_stranded} queued request(s) for "
                                      f"{pick} cannot fill the smallest "
                                      f"declared batch size ({sizes[-1]})"))
                continue
            take = next(s for s in sizes if s <= len(q))
            return (pick, [q.popleft() for _ in range(take)]), wait

    def _dispatch_loop(self):
        while True:
            with self._lock:
                group, wait = self._take_group()
                while group is None:
                    if self._closed and not any(self._queues.values()):
                        return
                    self._lock.wait(timeout=wait)
                    group, wait = self._take_group()
            _, reqs = group
            t0 = time.perf_counter()
            with self.stats.lock:
                self.stats.dispatches += 1
                self.stats.batch_histogram[len(reqs)] += 1
                self.stats.dispatched_requests += len(reqs)
                for r in reqs:
                    self.stats.queue_wait_s_total += t0 - r.t_enqueued
            try:
                out = self._run_batch(reqs)
            except Exception as e:  # noqa: BLE001 - surfaced to every caller
                with self.stats.lock:
                    self.stats.delivered += len(reqs)
                for r in reqs:
                    self._deliver(r.future, Future.set_exception, e)
                continue
            t = time.perf_counter()
            with self.stats.lock:
                self.stats.delivered += len(reqs)
                for r in reqs:
                    self.stats.latencies_s.append(t - r.t_enqueued)
            for i, r in enumerate(reqs):
                self._deliver(r.future, Future.set_result, out[i])

    def _run_batch(self, reqs) -> np.ndarray:
        """Stack, run the model, and fetch the batch to the host: a bf16
        model's output as the exact float32 widening of its values
        (:func:`~haet_torch.utils.env.host_numpy`)."""
        args = []
        for j, a0 in enumerate(reqs[0].args):
            if a0 is None:
                args.append(None)
            else:
                batch = np.stack([r.args[j] for r in reqs])
                args.append(torch.from_numpy(batch).to(self.device))
        with torch.inference_mode():
            out = self.model(*args)
        return host_numpy(out)

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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

