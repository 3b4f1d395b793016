"""Hand-written CUDA kernels of the port, with their plain versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors; the three forwards are also the operators
``haet::slice_states``, ``haet::deslice`` and ``haet::erwin_block``
(:func:`define_op`), registered when this package is imported, which
``torch.export`` records and an exported program calls. Every wrapper keeps a launch counter that rises by
one per kernel launch (never on the plain path), so a run can show that its
main path went through the kernels. The counters count calls from the
host: a CUDA graph's capture counts once and its replays not at all.
:func:`profile_launches` counts the launches on the device instead, from a
``torch.profiler`` trace, replays included.
"""

from __future__ import annotations

import re
import threading


class LaunchCounter:
    """A thread-safe count of one wrapper's kernel launches."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


#: the ``haet`` operator libraries: a registration lasts as long as its
#: ``torch.library.Library`` object
_LIBRARIES: list = []


def define_op(name: str, schema: str, impl, fake):
    """Register the operator ``haet::<name><schema>``: ``impl`` for CPU and
    CUDA tensors (it picks the kernel or the plain version itself) and
    ``fake`` for tracing (``torch.export`` runs it on fake tensors, which
    have no data pointer to launch on). Returns the operator. A plain
    ``torch.library.Library`` registration: ``torch.library.custom_op``'s
    Python layers cost several times its dispatch on every call."""
    import torch

    lib = torch.library.Library("haet", "FRAGMENT")
    lib.define(name + schema)
    for key in ("CPU", "CUDA"):
        lib.impl(name, impl, key)
    torch.library.register_fake(f"haet::{name}", fake, lib=lib)
    _LIBRARIES.append(lib)
    return getattr(torch.ops.haet, name).default


def counters() -> dict:
    """``{kernel name: LaunchCounter}`` for every kernel of the port."""
    from . import copy_kernel, erwin_block, slice_kernels

    return {
        "slice_states": slice_kernels.SLICE_STATES_LAUNCHES,
        "deslice": slice_kernels.DESLICE_LAUNCHES,
        "slice_states_bwd": slice_kernels.SLICE_STATES_BWD_LAUNCHES,
        "deslice_bwd": slice_kernels.DESLICE_BWD_LAUNCHES,
        "fused_erwin_block": erwin_block.LAUNCHES,
        "fused_erwin_block_bwd": erwin_block.BWD_LAUNCHES,
        "copy_scale": copy_kernel.LAUNCHES,
    }


def launch_counts() -> dict:
    """``{kernel name: launches so far}``."""
    return {k: c.value for k, c in counters().items()}


def plain_route_counts() -> dict:
    """``{kernel name: calls its module routed to the plain version}``:
    modules built to use the kernel whose shape failed its gate, in both
    directions (a backward counts when such a forward is recorded for
    autograd, whose backward is then autograd of the plain block)."""
    from . import erwin_block

    return {"fused_erwin_block": erwin_block.PLAIN_ROUTES.value,
            "fused_erwin_block_bwd": erwin_block.BWD_PLAIN_ROUTES.value}


def reset_launch_counts() -> None:
    """Zero every launch counter and plain-route counter."""
    from . import erwin_block

    for c in (*counters().values(), erwin_block.PLAIN_ROUTES,
              erwin_block.BWD_PLAIN_ROUTES):
        c.reset()


#: the CUDA kernels of each wrapper, by their demangled names: ``(pattern,
#: port kernel, is_call)``, where one ``is_call`` kernel runs per wrapper
#: call. ``sum_partials`` (the slice backwards' sums) belongs to the
#: backward whose pass it follows; the slice backward kernels' mode is their
#: last template argument (3 and 0: slice_states_bwd's first pass and chain,
#: 1 and 2: deslice_bwd's)
KERNEL_NAMES = (
    (re.compile(r"\bslice_states_fast\b"), "slice_states", True),
    (re.compile(r"\bslice_partials_generic\b"), "slice_states", False),
    (re.compile(r"\bslice_merge_generic\b"), "slice_states", True),
    (re.compile(r"\bdeslice_(?:fast|generic)\b"), "deslice", True),
    (re.compile(r"\bslice_bwd_(?:fast|generic)<(?:[^<>]*,\s*)?3>"),
     "slice_states_bwd", True),
    (re.compile(r"\bslice_bwd_(?:fast|generic)<(?:[^<>]*,\s*)?0>"),
     "slice_states_bwd", False),
    (re.compile(r"\bslice_bwd_(?:fast|generic)<(?:[^<>]*,\s*)?1>"),
     "deslice_bwd", True),
    (re.compile(r"\bslice_bwd_(?:fast|generic)<(?:[^<>]*,\s*)?2>"),
     "deslice_bwd", False),
    (re.compile(r"\bsum_partials\b"), None, False),
    (re.compile(r"\berwin_block_fwd\b"), "fused_erwin_block", True),
    (re.compile(r"\berwin_block_bwd\b"), "fused_erwin_block_bwd", True),
    (re.compile(r"\berwin_block_sum_partials\b"), "fused_erwin_block_bwd",
     False),
    (re.compile(r"\bcopy_scale\b"), "copy_scale", True),
)


def port_kernel(name: str):
    """``(port kernel or None, is_call)`` of a CUDA kernel's name; None for
    a kernel that is not the port's, and for ``sum_partials``, whose owner
    is the backward before it."""
    for pattern, port, is_call in KERNEL_NAMES:
        if pattern.search(name):
            return port, is_call
    return None, False


def count_kernels(names) -> dict:
    """From CUDA kernel names in launch order: ``{"calls": {port kernel:
    wrapper calls}, "launches": {port kernel: CUDA kernels}, "kernels":
    every kernel, "other": kernels that are not the port's, "names": the
    port's kernel names, each once, sorted}``, keyed as
    :func:`launch_counts`. Raises on a ``sum_partials`` that follows no
    slice backward."""
    calls = dict.fromkeys(counters(), 0)
    launches = dict.fromkeys(counters(), 0)
    owner, total, seen = None, 0, set()
    for name in names:
        total += 1
        port, is_call = port_kernel(name)
        if port is None and re.search(r"\bsum_partials\b", name):
            if owner not in ("slice_states_bwd", "deslice_bwd"):
                raise ValueError(f"{name} follows no slice backward")
            port = owner
        if port is None:
            continue
        owner = port
        launches[port] += 1
        calls[port] += is_call
        seen.add(name)
    return {"calls": calls, "launches": launches, "kernels": total,
            "other": total - sum(launches.values()), "names": sorted(seen)}


def profile_launches(fn, *args, host: bool = True):
    """``(fn(*args), counts)``: ``fn`` run under ``torch.profiler`` with the
    device synchronised before the trace ends, and :func:`count_kernels` of
    the CUDA kernels it ran, replays of CUDA graphs included, plus
    ``"copies"``, the memory copies and sets on the device,
    ``"device_ms"``, the device time of both, ``"span_ms"``, from the
    first one's start to the last one's end, and ``"lost"``, the device
    records the profiler dropped, all of them sentinels
    (:func:`haet_torch.utils.profiling.device_trace`). Raises when the
    trace holds a graph launch but no kernel: the profiler would then not
    see inside graphs. ``host=False`` traces the CUDA activity alone, as
    :func:`~haet_torch.utils.profiling.device_trace` does."""
    import torch

    from ...utils.profiling import device_trace

    with device_trace(host) as prof:
        out = fn(*args)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    kernels = sorted((e for e in device
                      if not e.name.startswith(("Memcpy", "Memset"))),
                     key=lambda e: e.time_range.start)
    if not kernels and any("GraphLaunch" in e.name for e in prof.events()):
        raise RuntimeError("the profiler saw a CUDA graph launch and no "
                           "kernel: it does not trace inside graphs here")
    counts = count_kernels(e.name for e in kernels)
    counts["copies"] = len(device) - len(kernels)
    counts["device_ms"] = sum(e.time_range.elapsed_us()
                              for e in device) / 1e3
    counts["span_ms"] = ((max(e.time_range.end for e in device)
                          - min(e.time_range.start for e in device)) / 1e3
                         if device else 0.0)
    counts["lost"] = prof.lost
    return out, counts


# Importing the kernel modules registers their forwards as the operators
# ``haet::slice_states``, ``haet::deslice`` and ``haet::erwin_block``, which
# an exported program (``haet_torch.export``) calls by name.
from . import erwin_block, slice_kernels  # noqa: E402,F401
