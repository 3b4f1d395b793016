"""Multi-process init: one process per rank over ``torch.distributed``.

Counterpart of ``haet_tpu/parallel/distributed.py:49-120``. The JAX package
runs one process per host, each owning several chips, under one controller;
the port runs one process per card (or, on the CPU, per rank), and every
collective is explicit (:mod:`haet_torch.parallel.collectives`).

* :func:`init_distributed` joins the process group. Its order of
  resolution is JAX's: explicit arguments, then ``HAET_COORDINATOR``
  (``host:port``) / ``HAET_NUM_PROCESSES`` / ``HAET_PROCESS_ID``, then
  torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``, which
  stand where JAX autodetects a TPU pod. With none of them it makes a world
  of one in this process (no rendezvous), so that a mesh of one rank has
  its groups. The backend is NCCL for ranks on the card and gloo on the
  CPU (``device="cpu"``); ``backend="gloo"`` with CUDA tensors runs several
  ranks on one card, which NCCL refuses.
* :func:`process_batch_slice` is the rows of a global batch that this
  process would load, for a loader that reads only its own. The port's
  drivers give every rank the global batch, and a bound model keeps its
  rank's part inside its forward (:meth:`~haet_torch.parallel.Layout.shard`,
  the one place that shards).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..utils.env import default_device


def _env_int(name: str):
    return int(os.environ[name]) if name in os.environ else None


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, device=None,
                     backend: str | None = None) -> bool:
    """Join the process group; idempotent. Returns whether a group of more
    than one process is active.

    ``device`` (None: the card) picks the backend, NCCL on CUDA and gloo on
    the CPU, unless ``backend`` names one. On CUDA each rank is bound to
    ``cuda:{local_rank}`` (torchrun's ``LOCAL_RANK``, else the rank modulo
    the visible cards), so tensors made on ``"cuda"`` go to its card.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("HAET_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("HAET_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("HAET_PROCESS_ID")
    init_method = None
    if coordinator is not None:
        init_method = f"tcp://{coordinator}"
    elif "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        init_method = "env://"
        if num_processes is None:
            num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    dev = default_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = num_processes or 1
    rank = process_id or 0
    kw = {}
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        local = rank % torch.cuda.device_count() if local is None else local
        torch.cuda.set_device(local)
        if backend == "nccl":
            # eager communicator: the first collective may sit in a graph
            kw["device_id"] = torch.device("cuda", local)
    if init_method is None:
        if world != 1:
            raise ValueError(
                f"{world} processes need a coordinator: pass coordinator= "
                "or set HAET_COORDINATOR, or launch under torchrun")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = init_method
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)
    return world > 1


def world() -> tuple:
    """``(rank, world size)``: ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def requested_world() -> int:
    """The world size :func:`init_distributed` joins or has joined: the
    process group's, else ``HAET_NUM_PROCESSES`` or torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    for name in ("HAET_NUM_PROCESSES", "WORLD_SIZE"):
        if name in os.environ:
            return int(os.environ[name])
    return 1


def cluster_configured() -> bool:
    """Whether the environment names a cluster to join (``HAET_*`` or
    torchrun's variables)."""
    return "HAET_COORDINATOR" in os.environ or (
        "MASTER_ADDR" in os.environ and "RANK" in os.environ)


def is_writer() -> bool:
    """Whether this process writes files and logs: rank 0, or the only
    process."""
    return world()[0] == 0


def barrier() -> None:
    """Wait for every rank (nothing without a process group): an
    all-reduce of one element, read back on the host."""
    if dist.is_initialized():
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        t = torch.zeros(1, device=dev)
        dist.all_reduce(t)
        t.item()


def process_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch of ``global_batch`` that this process
    loads: an equal contiguous slice per process, in rank order; raises
    where the processes do not divide it."""
    rank, n = world()
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {n}")
    per = global_batch // n
    return slice(rank * per, (rank + 1) * per)
