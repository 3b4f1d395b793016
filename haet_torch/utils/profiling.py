"""Tracing and profiling helpers of the port.

Counterpart of ``haet_tpu/utils/profiling.py:27-82``, on ``torch.profiler``
and the CUDA caching allocator:

* :func:`trace` -- a context manager that records a ``torch.profiler``
  trace and writes it as a Chrome trace (``trace.json``) into ``log_dir``;
* :class:`StepTimer` -- per-step wall clock with the reference's metric
  names (``train/avg_batch_time`` ...);
* :func:`device_memory_mb` -- peak device memory allocated, in MiB
  (``torch.cuda.max_memory_allocated``), or None where there is none (the
  CPU), as the JAX helper returns None where a device has no memory stats;
* :func:`host_rss_mb` -- host resident set size from ``/proc``;
* :func:`kernel_events` -- a profile's device kernels by name;
* :func:`device_trace` -- a ``torch.profiler`` trace of host and card
  with a margin of :data:`TRACE_MARGIN_S` on both sides and
  :data:`SENTINELS` launches of a sentinel kernel before the traced work,
  the one every device measurement of the port takes.

A host clock around asynchronous CUDA work measures the enqueue: end a
timed region with ``torch.cuda.synchronize()`` or a host fetch of a value
that depends on the work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


#: seconds a device trace leaves between its opening and the first launch,
#: and between the card's end of the work and its closing: the profiler
#: keeps a record only inside its window, and the card's timestamps were
#: seen to land milliseconds early (``benchmarks/trace_loss.py``)
TRACE_MARGIN_S = 0.1
#: launches of a one-thread kernel (``torch.cuda._sleep(0)``, named
#: :data:`SENTINEL_KERNEL`) between the margin and the traced work. On the
#: H100's machine a trace also loses its first device records, the more
#: the longer its process has run (``benchmarks/trace_loss.py``): the
#: sentinels take that loss, and a trace that lost them all raises rather
#: than count short.
SENTINELS = 128
SENTINEL_KERNEL = "spin_kernel"


class DeviceTrace:
    """The profile of a :func:`device_trace`: ``events()`` and
    ``key_averages()`` as ``torch.profiler.profile``'s, without the
    sentinels; ``lost``, the sentinel records the profiler dropped, is set
    by :meth:`finish` once the trace has closed."""

    def __init__(self, prof):
        self.prof = prof
        self.lost = None

    def finish(self) -> None:
        """Count the sentinels that reached the profile; raises when none
        did, since the loss may then reach into the traced work."""
        seen = sum(SENTINEL_KERNEL in e.name for e in self.prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        self.lost = SENTINELS - seen
        if not seen:
            raise RuntimeError(
                f"the profiler dropped all {SENTINELS} sentinel records "
                f"that open the trace: its count of the traced work may "
                f"be short")

    def events(self) -> list:
        return [e for e in self.prof.events()
                if SENTINEL_KERNEL not in e.name]

    def key_averages(self) -> list:
        return [e for e in self.prof.key_averages()
                if SENTINEL_KERNEL not in e.key]


@contextlib.contextmanager
def device_trace(host: bool = True):
    """``torch.profiler.profile`` of the host and the card, opened
    :data:`TRACE_MARGIN_S` and :data:`SENTINELS` sentinel kernels before
    the traced work and closed that margin after the card has finished it;
    yields a :class:`DeviceTrace`. ``host=False`` records the CUDA activity
    alone (the kernels, copies and runtime calls, no host operators): the
    profiler then parses a fraction of the records of an eager step."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
        for _ in range(SENTINELS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        trace = DeviceTrace(prof)
        yield trace
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)
    trace.finish()


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("runs/trace"): ...`` -> ``runs/trace/trace.json``.

    Records host activity, and the card's when one is present; yields the
    ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates per-step timings; reports reference-style metrics."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        self.times.append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def step(self):
        self.start()
        yield
        self.stop()

    def metrics(self, prefix: str = "train/"):
        if not self.times:
            return {}
        return {
            f"{prefix}avg_batch_time": sum(self.times) / len(self.times),
            f"{prefix}last_batch_time": self.times[-1],
            f"{prefix}num_batches": len(self.times),
        }


def device_memory_mb(device) -> float | None:
    """Peak device memory allocated on a CUDA ``device`` since the last
    ``torch.cuda.reset_peak_memory_stats``, in MiB; None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def host_rss_mb() -> float:
    """Host resident set size in MiB (the reference uses psutil,
    ``train.py:49-51``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def kernel_events(prof) -> list:
    """The profile's device kernels by name, longest first. Kernels only:
    an operator's entry, and a user annotation such as
    ``Optimizer.step#Adam.step``, repeat their kernels' device time."""
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    return sorted(events, key=lambda e: -e.self_device_time_total)
