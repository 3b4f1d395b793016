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
* :func:`kernel_events` -- a profile's device kernels by name.

A host clock around asynchronous CUDA work measures the enqueue: end a
timed region with ``torch.cuda.synchronize()`` or a host fetch of a value
that depends on the work.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


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
