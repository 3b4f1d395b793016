"""Background batch prefetching of the port (``haet_tpu/data/prefetch.py``).

The reference overlaps host-side data work with device compute via PyG
``DataLoader`` worker processes (``main.py``/``train.py``); here a bounded
background thread does the same for any iterable factory: while the device
runs step k, the thread assembles batch k+1 (VTK parse, SDF, padding,
normalization — all GIL-releasing numpy/file work).

Usage (an iterable factory, as ``Trainer.fit`` takes one):

    train_batches = Prefetcher(make_batches, depth=2)
    trainer.fit(train_batches, ...)
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable


class Prefetcher:
    """Wrap an iterable factory with a depth-bounded background producer.

    Each call to the instance starts a fresh pass (and a fresh thread), so
    it composes with multi-epoch training loops exactly like the plain
    factory would. Exceptions in the producer re-raise in the consumer.
    """

    def __init__(self, batches_fn: Callable[[], Iterable], depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.batches_fn = batches_fn
        self.depth = depth

    def __call__(self):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        SENTINEL = object()

        def put_or_abandon(item) -> bool:
            """Stop-aware put: never blocks forever if the consumer walked
            away from the generator mid-pass (early break / error in the
            training loop) — an unconditional put would leak the thread
            plus its queued batch references for every abandoned pass."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in self.batches_fn():
                    if not put_or_abandon(b):
                        return
                put_or_abandon(SENTINEL)
            except BaseException as e:  # propagate to the consumer
                put_or_abandon(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
