"""Hand-written CUDA kernels of the port, with their plain versions.

Each wrapper launches its kernel on CUDA tensors and runs its plain PyTorch
version on CPU tensors. Every wrapper keeps a launch counter that rises by
one per kernel launch (never on the plain path), so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

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
