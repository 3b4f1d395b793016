"""The training step as CUDA graphs: the counterpart of the JAX trainer's
one compiled device program per step (``jax.jit(self._step)``,
``haet_tpu/train/trainer.py:371``, ``:541-570``) and per K steps
(``lax.scan``, ``:697-733``).

:class:`StepGraphs` keeps one ``torch.cuda.CUDAGraph`` per batch signature
(the keys, shapes and dtypes, as jit keys its cache on shapes) and count of
steps K. A graph holds K whole steps: the copy of each step's learning rate
and beta1 into Adam's device tensor, the train-mode forward, the car loss,
the gradients, ``clip_grad_norm_``, Adam and the BatchNorm updates; every
kernel of the port on the step's path runs inside it. Before a replay the
host writes the K batches and the K steps' ``(lr, beta1)`` into pinned
staging buffers and copies them to the graph's static device buffers on the
same stream (the batches are numpy arrays that change from step to step,
so their copy is not a node of the graph).

Capture. Each new graph first runs ``WARMUP`` eager steps on the stream it
is captured on, on the trainer's real state, which is then put back: the
warm-up steps are thrown away, so a graphed run equals the eager run step
for step. They build the kernels, set their shared-memory attributes,
allocate the slice kernels' per-stream arrival counters, cuBLAS's
workspace for the stream, and (on the trainer's first step) the static
gradients, all outside the graph. Garbage is collected before each capture:
a dead graph freed by Python's cyclic collector during a capture would
invalidate it. A capture or a launch that fails raises; nothing falls back
to the eager step.

Memory. The trainer's graphs share one memory pool
(``torch.cuda.graph_pool_handle()``). That is safe only because nothing
that outlives a replay lives in the pool: the parameters, gradients, Adam's
state, the learning rate and beta1, the BatchNorm buffers, the static
inputs and the static metrics are allocated outside any capture and keep
their storage for the trainer's life (``Trainer.load_state_dict`` copies
into them), so the pool holds only a step's temporaries; and because the
replays run one at a time on one stream. A graph's temporaries may then
share memory with another graph's, whatever the order of the replays.
"""

from __future__ import annotations

import gc
import time
import weakref

import torch

#: eager steps run (and thrown away) before each capture
WARMUP = 3


def signature(batch: dict) -> tuple:
    """``((key, shape, dtype) or (key, None), ...)`` of a batch, sorted by
    key: batches of one signature replay one graph."""
    sig = []
    for k in sorted(batch):
        v = batch[k]
        if v is None:
            sig.append((k, None))
        else:
            t = torch.as_tensor(v)
            sig.append((k, tuple(t.shape), t.dtype))
    return tuple(sig)


class _Graph:
    """One captured graph of K steps and its static buffers."""

    def __init__(self, sig: tuple, steps: int, hparams: torch.Tensor):
        dev = hparams.device
        self.steps = steps
        self.inputs = [{k: None if rest[0] is None else torch.empty(
            rest[0], dtype=rest[1], device=dev) for k, *rest in sig}
            for _ in range(steps)]
        self.staging = [{k: None if t is None else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True) for k, t in b.items()}
            for b in self.inputs]
        self.hparams = torch.empty((steps, *hparams.shape),
                                   dtype=hparams.dtype, device=dev)
        self.hparams_staging = torch.empty(self.hparams.shape,
                                           dtype=hparams.dtype,
                                           pin_memory=True)
        # set when the last load's copies have left the staging buffers
        self.copied = torch.cuda.Event()
        self.copied.record()
        self.graph = torch.cuda.CUDAGraph()
        self.keys: list = []
        self.metrics = None

    def load(self, batches: list, hparams: list) -> None:
        """The K batches and ``[K, groups, 2]`` rates into the static
        buffers, through the pinned staging buffers, on the current
        stream."""
        self.copied.synchronize()
        for b, static, stage in zip(batches, self.inputs, self.staging):
            for k, dst in static.items():
                if dst is None:
                    continue
                src = torch.as_tensor(b[k])
                if src.is_cuda:
                    dst.copy_(src)
                else:
                    stage[k].copy_(src)
                    dst.copy_(stage[k], non_blocking=True)
        self.hparams_staging.copy_(torch.tensor(hparams,
                                                dtype=self.hparams.dtype))
        self.hparams.copy_(self.hparams_staging, non_blocking=True)
        self.copied.record()


class StepGraphs:
    """A :class:`~haet_torch.train.trainer.Trainer`'s CUDA graphs."""

    def __init__(self, trainer):
        # a proxy: a trainer and its graphs in a reference cycle would be
        # freed by the cyclic collector, at whatever moment it runs
        self.trainer = weakref.proxy(trainer)
        self.device = trainer.device
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: dict = {}
        #: seconds of each capture, warm-up included, in capture order
        self.capture_s: list = []

    def __len__(self) -> int:
        return len(self._graphs)

    def prepare(self, batches: list) -> None:
        """Capture the graph of ``batches``' signature and count unless it
        exists: its warm-up is thrown away, so no step is taken."""
        self._graph(batches)

    def run(self, batches: list) -> dict:
        """K steps over ``batches`` (one signature) as one replay, capturing
        the graph first if it is new; advances the schedule and the step
        count by K and returns each metric stacked ``[K]``."""
        tr = self.trainer
        graph = self._graph(batches)
        rates = []
        for _ in batches:
            rates.append(tr.optimizer.host_hparams())
            tr.advance_schedule()
        graph.load(batches, rates)
        graph.graph.replay()
        tr.step += len(batches)
        out = graph.metrics.clone()
        return {k: out[:, j] for j, k in enumerate(graph.keys)}

    def _graph(self, batches: list) -> _Graph:
        key = (signature(batches[0]), len(batches))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._capture(key, batches)
        return graph

    def _capture(self, key, batches) -> _Graph:
        tr = self.trainer
        sig, steps = key
        t0 = time.perf_counter()
        graph = _Graph(sig, steps, tr.optimizer.hparams)
        graph.load(batches, [tr.optimizer.host_hparams()] * steps)
        state = tr.state_tensors()
        # detached: a clone recorded for autograd would keep the
        # parameters' gradient accumulators, made on this stream, alive
        # into the capture on another
        saved = [t.detach().clone() for t in state]
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP):
                metrics = tr.step_body(graph.inputs[0])
            with torch.no_grad():
                torch._foreach_copy_(state, saved)
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        del saved
        graph.keys = list(metrics)
        # a CUDA graph that the cyclic collector destroys during a capture
        # invalidates the capture; torch no longer collects at its start
        gc.collect()
        graph.metrics = torch.empty((steps, len(graph.keys)),
                                    dtype=torch.float32, device=self.device)
        with torch.cuda.graph(graph.graph, pool=self.pool,
                              stream=self.stream,
                              capture_error_mode="thread_local"):
            for i in range(steps):
                with torch.no_grad():
                    tr.optimizer.hparams.copy_(graph.hparams[i])
                metrics = tr.step_body(graph.inputs[i])
                with torch.no_grad():
                    graph.metrics[i].copy_(torch.stack(
                        [metrics[k].float() for k in graph.keys]))
        del metrics
        self._graphs[key] = graph
        self.capture_s.append(time.perf_counter() - t0)
        return graph
