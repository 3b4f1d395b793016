"""Throughput of the batching server under concurrent load.

    python -m haet_torch.benchmarks.micro_serving_server [--n 32186]
        [--requests 48] [--clients 8] [--rounds 3] [--device cpu]

Counterpart of ``benchmarks/micro_serving_server.py``: the car preset at
full width (both kernel flags; bf16 on the card, float32 on the CPU, as the
JAX driver), seeded weights, exported as a batch family (1, 2, 4, 8) and
loaded back, behind three :class:`~haet_torch.serve.BatchingServer` s, one
per mode, all warmed up first. The same requests in each mode, the modes
interleaved in each round, the best round kept:

* ``sequential_b1``: one client, one request at a time (``max_delay_s``
  0), each riding the batch-1 program;
* ``batched``: ``--clients`` threads submit their share at once, with a
  ``--max_delay_ms`` window;
* ``batched_pd2``: the same with ``pipeline_depth=2`` (batch k's fetch
  overlaps batch k+1's dispatch).

Prints one JSON line with samples per second of each mode, the best
round's batch histogram and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time

import numpy as np
import torch

from ..export import ServingBundle
from ..serve import BatchingServer, export_batch_family
from ..utils.env import default_device
from .micro_serving_latency import car_model, card

__all__ = ["run", "main"]


def run(n: int = 32186, requests: int = 48, clients: int = 8,
        rounds: int = 3, max_delay_ms: float = 5.0, device=None,
        batch_sizes=(1, 2, 4, 8)) -> dict:
    dev = default_device(device)
    model = car_model(dev)
    variables = model.state_dict()
    rng = np.random.RandomState(0)
    x1 = rng.randn(1, n, 7).astype(np.float32)
    samples = [rng.randn(n, 7).astype(np.float32) for _ in range(requests)]

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        export_batch_family(td, model, variables, (x1, None),
                            batch_sizes=batch_sizes)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        bundle = ServingBundle.load(td, device=dev)
        t_load = time.perf_counter() - t0
    kw = dict(max_queue=4 * requests, device=dev)
    srv_seq = BatchingServer(bundle, variables, max_delay_s=0.0, **kw)
    srv_bat = BatchingServer(bundle, variables,
                             max_delay_s=max_delay_ms / 1e3, **kw)
    srv_pd2 = BatchingServer(bundle, variables,
                             max_delay_s=max_delay_ms / 1e3,
                             pipeline_depth=2, **kw)
    for srv in (srv_seq, srv_bat, srv_pd2):
        srv.warmup()

    def run_sequential():
        t0 = time.perf_counter()
        for s in samples:
            srv_seq.predict(s, None, timeout=600)
        return time.perf_counter() - t0

    def run_batched(srv):
        per = (requests + clients - 1) // clients
        chunks = [samples[i * per:(i + 1) * per] for i in range(clients)]
        futs, lock = [], threading.Lock()

        def client(chunk):
            fs = [srv.submit(s, None) for s in chunk]
            with lock:
                futs.extend(fs)

        with srv.stats.lock:
            before = dict(srv.stats.batch_histogram)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in chunks if c]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for f in futs:
            f.result(timeout=600)
        dt = time.perf_counter() - t0
        with srv.stats.lock:
            hist = {b: c - before.get(b, 0)
                    for b, c in srv.stats.batch_histogram.items()
                    if c - before.get(b, 0)}
        return dt, hist

    best_seq = best_bat = best_pd2 = float("inf")
    hist = hist_pd2 = {}
    try:
        for _ in range(rounds):
            best_seq = min(best_seq, run_sequential())
            dt, h = run_batched(srv_bat)
            if dt < best_bat:
                best_bat, hist = dt, h
            dt, h = run_batched(srv_pd2)
            if dt < best_pd2:
                best_pd2, hist_pd2 = dt, h
    finally:
        for srv in (srv_seq, srv_bat, srv_pd2):
            srv.close()
    rps = {k: requests / t for k, t in (("sequential_b1", best_seq),
                                         ("batched", best_bat),
                                         ("batched_pd2", best_pd2))}
    return {
        "metric": "serving_throughput", "n_points": n, "requests": requests,
        "clients": clients, "batch_sizes": list(batch_sizes),
        "dtype": "bfloat16" if dev.type == "cuda" else "float32",
        "export_s": t_export, "load_s": t_load,
        "sequential_b1_rps": rps["sequential_b1"],
        "batched_rps": rps["batched"],
        "batched_pd2_rps": rps["batched_pd2"],
        "speedup": rps["batched"] / rps["sequential_b1"],
        "pd2_over_pd1": rps["batched_pd2"] / rps["batched"],
        "batch_histogram_best_round": hist,
        "batch_histogram_best_round_pd2": hist_pd2,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "card": card(dev),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=32186)
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--max_delay_ms", type=float, default=5.0)
    ap.add_argument("--batch_sizes", default="1,2,4,8",
                    help="the exported family")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = run(args.n, args.requests, args.clients, args.rounds,
              args.max_delay_ms, args.device,
              tuple(int(b) for b in args.batch_sizes.split(",")))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
