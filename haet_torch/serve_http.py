"""Minimal HTTP front end for the batching server (standard library only).

Counterpart of ``haet_tpu/serve_http.py``: ``haet_torch.export`` writes the
programs, :mod:`haet_torch.serve` batches requests onto them, and this
module answers over HTTP. ``http.server.ThreadingHTTPServer`` gives one
thread per connection, and every handler blocks on
``BatchingServer.submit``'s future, so concurrent requests co-batch onto the
largest exported program.

Protocol (numpy-native; JSON would 4x the payload of float data):

* ``POST /predict``: the body is an ``.npz`` archive with the positional
  model inputs under ``arg0``, ``arg1``, ... (single-sample shapes, no
  batch axis; absent optional inputs left out). The answer is an ``.npz``
  with the output under ``output``. A signature or dtype the server does
  not serve is 400 with its message, a full queue 503, a request that
  outlives ``request_timeout_s`` 504, anything else 500.
* ``GET /healthz``: 200 ``ok`` once the server accepts requests.
* ``GET /shapes``: JSON, the single-sample signatures served.
* ``GET /stats``: JSON, the server's counters and batch-size histogram.
* ``GET /metrics``: the same counters in the Prometheus text exposition
  format, the request latency as a summary with its quantiles, ``_count``
  and ``_sum``.
* ``POST /reload``: body optional JSON ``{"which": "best"}``; loads that
  checkpoint and swaps it in (``BatchingServer.reload``); 501 when no
  checkpoint directory is configured, 404 when the name is absent.

CLI::

    python -m haet_torch.serve_http --bundle ARTIFACT_DIR \\
        --checkpoint RUN_DIR [--which best] [--port 8000] \\
        [--max_delay_ms 2] [--pad_to_points 1] [--device cpu]

The checkpoint is read with ``Checkpointer.restore_raw``; the model's
state dict is its ``"model"`` entry. ``--watch_checkpoint SECS`` polls the
run's ``epochs.json`` and reloads ``--which`` through ``/reload`` whenever
its entry advances; the watcher posts to the address the server is bound
to, and starts from the stamp read when the weights were loaded, so that a
save landing during start-up is not taken as served. SIGTERM drains: the
listener stops, in-flight handlers finish (bounded by
``--request_timeout_s``), queued requests are served, and the process
exits 0. A ``--pp`` run's checkpoint (the stacked pipeline layout) is
converted by ``merge_raw_variables`` (JAX ``serve_http.py:350-354``).

``--dp N`` serves a bundle exported over a dp mesh of N ranks, ``--tp N``
one exported with ``data_axis=None`` over a tp mesh (JAX ``:388-445``;
they are mutually exclusive). JAX's server is one process over N devices;
here N processes are launched, under torchrun or with ``HAET_COORDINATOR``
/ ``HAET_NUM_PROCESSES`` / ``HAET_PROCESS_ID``, each loading the bundle
with the mesh: rank 0 answers HTTP and batches, the other ranks follow its
dispatches (``haet_torch.serve.follow``) and exit when it drains.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import threading
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from . import parallel
from .serve import BatchingServer, follow

__all__ = ["make_server", "main", "watch_checkpoint"]


def _npz_bytes(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _prometheus_text(snap: dict) -> str:
    """A ``ServerStats.snapshot()`` in the Prometheus text exposition
    format (one scrape, one snapshot)."""
    lines = []

    def metric(name, mtype, help_, samples):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        for suffix_labels, val in samples:
            lines.append(f"{name}{suffix_labels} {val}")

    metric("haet_requests_total", "counter",
           "Requests accepted by submit().", [("", snap["requests"])])
    metric("haet_dispatches_total", "counter",
           "Device batches dispatched.", [("", snap["dispatches"])])
    metric("haet_delivered_total", "counter",
           "Request results (or errors) delivered to callers.",
           [("", snap["delivered"])])
    metric("haet_padded_samples_total", "counter",
           "Samples synthesized by pad_to_batch (outputs discarded).",
           [("", snap["padded_samples"])])
    metric("haet_padded_points_total", "counter",
           "Points synthesized by pad_to_points (output rows truncated).",
           [("", snap["padded_points"])])
    metric("haet_mean_queue_wait_seconds", "gauge",
           "Mean submit->dispatch wait over dispatched requests.",
           [("", snap["mean_queue_wait_s"])])
    hist = snap["batch_histogram"]
    if hist:
        metric("haet_batch_size_dispatches_total", "counter",
               "Dispatches by device batch size.",
               [('{size="%s"}' % size, count)
                for size, count in sorted(hist.items())])
    # a summary carries its quantiles, _count and _sum; the quantiles are
    # over the rolling window, _count and _sum over every latency recorded
    quants = [('{quantile="%s"}' % q, snap[k])
              for q, k in (("0.5", "latency_p50_s"),
                           ("0.95", "latency_p95_s"))
              if snap[k] is not None]
    metric("haet_request_latency_seconds", "summary",
           "Submit->result latency (quantiles over a rolling window).",
           quants + [("_count", snap["latency_count"]),
                     ("_sum", snap["latency_sum_s"])])
    return "\n".join(lines) + "\n"


def make_server(batching_server: BatchingServer, host: str = "127.0.0.1",
                port: int = 8000, *, request_timeout_s: float = 300.0,
                reload_fn=None) -> ThreadingHTTPServer:
    """Wrap a running :class:`BatchingServer` in a ThreadingHTTPServer.

    Returns the server, not started: call ``serve_forever()`` (typically on
    a thread), then ``shutdown()`` and ``server_close()``, which joins the
    handlers in flight. The caller owns the BatchingServer.
    ``request_timeout_s`` bounds every socket read and one request's wait on
    the batcher (504 after it, and the request is cancelled).
    ``reload_fn(which)`` enables ``POST /reload``; reloads are serialised.
    """
    reload_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # bounds every socket read, so that a silent client cannot pin its
        # (non-daemon) thread and hang a graceful drain
        timeout = request_timeout_s

        def log_message(self, fmt, *args):  # noqa: D102 - one line per
            pass                            # request is noise here

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _body(self):
            """The request body, or None after answering 408 (the promised
            body never came: close, or a drain would wait a second
            timeout on the next request line)."""
            try:
                length = int(self.headers.get("Content-Length", "0"))
                return self.rfile.read(length) if length else b""
            except TimeoutError:
                self.close_connection = True
                self._send_json(408, {"error": "request body timed out"})
                return None

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/shapes":
                sigs = sorted(batching_server._sizes_by_sig)
                self._send_json(200, {"signatures": [
                    [list(s) for s in sig] for sig in sigs]})
            elif self.path == "/stats":
                self._send_json(200, batching_server.stats.snapshot())
            elif self.path == "/metrics":
                body = _prometheus_text(batching_server.stats.snapshot())
                self._send(200, body.encode(),
                           "text/plain; version=0.0.4; charset=utf-8")
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/reload":
                self._do_reload()
                return
            if self.path != "/predict":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            raw = self._body()
            if raw is None:
                return
            try:
                with np.load(io.BytesIO(raw)) as z:
                    # the KEY SET: sorted names put arg10 before arg2
                    expect = [f"arg{i}" for i in range(len(z.files))]
                    if set(z.files) != set(expect):
                        raise ValueError(f"npz keys must be arg0..argN, got "
                                         f"{sorted(z.files)}")
                    args = [z[k] for k in expect]
            except Exception as e:  # noqa: BLE001 - unparseable: the client's
                self._send_json(400, {"error": f"bad request body: {e}"})
                return
            try:
                fut = batching_server.submit(*args)
            except ValueError as e:  # unknown signature / dtype mismatch
                self._send_json(400, {"error": str(e)})
                return
            except RuntimeError as e:  # queue full / server closed
                self._send_json(503, {"error": str(e)})
                return
            try:
                out = fut.result(timeout=request_timeout_s)
            except ValueError as e:  # stranded batch
                self._send_json(400, {"error": str(e)})
                return
            except FuturesTimeoutError:
                fut.cancel()  # never dispatched for a client that left
                self._send_json(504, {
                    "error": f"prediction did not complete within "
                             f"{request_timeout_s} s"})
                return
            except Exception as e:  # noqa: BLE001 - surfaced verbatim
                self._send_json(500, {"error": repr(e)})
                return
            self._send(200, _npz_bytes(output=np.asarray(out)),
                       "application/octet-stream")

        def _do_reload(self):
            if reload_fn is None:
                self._send_json(501, {
                    "error": "reload is not configured (make_server "
                             "reload_fn / CLI --checkpoint)"})
                return
            body = self._body()
            if body is None:
                return
            try:
                which = (json.loads(body).get("which", "best")
                         if body.strip() else "best")
            except Exception as e:  # noqa: BLE001 - the client's error
                self._send_json(400, {"error": f"bad reload body: {e}"})
                return
            try:
                with reload_lock:
                    reload_fn(which)
            except FileNotFoundError as e:
                self._send_json(404, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - surfaced verbatim
                self._send_json(500, {"error": repr(e)})
                return
            self._send_json(200, {"reloaded": which})

    httpd = ThreadingHTTPServer((host, port), Handler)
    # non-daemon handler threads: server_close() joins the ones in flight
    # (each bounded by request_timeout_s), so shutdown() + server_close()
    # drains instead of cutting answers mid-write
    httpd.daemon_threads = False
    return httpd


def base_url(httpd: ThreadingHTTPServer) -> str:
    """The URL that reaches ``httpd`` from its own host: its bound address,
    or the loopback one when it listens on every interface."""
    host, port = httpd.server_address[:2]
    if host in ("", "0.0.0.0", "::"):
        host = "127.0.0.1"
    if ":" in host:
        host = f"[{host}]"
    return f"http://{host}:{port}"


def checkpoint_stamp(checkpoint: str, which: str):
    """The ``epochs.json`` entry of ``which`` (``{epoch, step}``, which
    every ``Checkpointer.save_*`` records), as a string, or None."""
    try:
        with open(os.path.join(checkpoint, "epochs.json")) as f:
            ent = json.load(f).get(which)
        return json.dumps(ent, sort_keys=True) if ent else None
    except (OSError, json.JSONDecodeError):
        return None


def watch_checkpoint(base: str, checkpoint: str, which: str,
                     interval_s: float, stop, served=None) -> None:
    """Poll a run's checkpoint sidecar and POST ``/reload`` to ``base``
    whenever the entry of ``which`` advances past ``served``, the stamp of
    the weights being served (:func:`checkpoint_stamp`, read when they were
    loaded; None when they had none); runs until ``stop`` (a
    ``threading.Event``) is set. Saves of other names do not trigger a
    reload. A failed reload (a half-written save) keeps the old weights and
    is retried on the next poll: the stamp advances only after a reload
    succeeds."""
    import urllib.request

    while not stop.wait(interval_s):
        cur = checkpoint_stamp(checkpoint, which)
        if cur is None or cur == served:
            continue
        try:
            req = urllib.request.Request(
                base + "/reload", data=json.dumps({"which": which}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=600) as r:
                r.read()
            served = cur
            print(f"[serve_http] checkpoint '{which}' advanced -> "
                  f"reloaded ({cur})", flush=True)
        except Exception as e:  # noqa: BLE001 - retried on the next poll
            print(f"[serve_http] auto-reload failed (will retry next "
                  f"poll): {e}", flush=True)


def _load_variables(checkpoint: str, which: str) -> dict:
    """The model's state dict from checkpoint ``which`` under
    ``checkpoint`` (the ``"model"`` entry of a training state, or a plain
    state dict), as numpy arrays."""
    from .train.checkpoint import Checkpointer

    if not os.path.isdir(checkpoint):
        raise FileNotFoundError(f"no checkpoint directory {checkpoint}")
    raw = Checkpointer(checkpoint).restore_raw(which)
    if raw is None:
        raise FileNotFoundError(
            f"no '{which}' checkpoint under {checkpoint}")
    state = raw.get("model", raw)
    if any(k.startswith("layers.") for k in state):
        # a --pp run's stacked pipeline layout: the plain per-block one
        from .parallel.pipeline import merge_raw_variables

        state = {k: v.numpy() for k, v in
                 merge_raw_variables(state).items()}
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bundle", required=True,
                    help="ServingBundle root (export_batch_family output)")
    ap.add_argument("--checkpoint", required=True,
                    help="training run's checkpoint directory")
    ap.add_argument("--which", default="best",
                    help="checkpoint name: best / last / epoch_N")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max_delay_ms", type=float, default=2.0)
    ap.add_argument("--max_queue", type=int, default=1024)
    ap.add_argument("--request_timeout_s", type=float, default=300.0,
                    help="bound one request's wait on the batcher "
                         "(504 after this)")
    ap.add_argument("--dp", type=int, default=0,
                    help="serve a bundle exported over a dp mesh of this "
                         "many ranks (one process each; 0 = single-device "
                         "artifacts)")
    ap.add_argument("--tp", type=int, default=0,
                    help="serve a head-TP bundle (exported with mesh= and "
                         "data_axis=None) over this many ranks; mutually "
                         "exclusive with --dp")
    ap.add_argument("--pad_to_batch", type=int, default=-1,
                    help="1: fill aged-out partial groups with copies of "
                         "their last sample; 0: fail them; -1 (default): "
                         "auto, on iff --dp > 1")
    ap.add_argument("--warmup", type=int, default=1,
                    help="run every exported program once before "
                         "accepting traffic")
    ap.add_argument("--pad_to_points", type=int, default=0,
                    help="1: serve point counts without an exact program "
                         "by repeat-last-row padding to the nearest larger "
                         "exported bucket (answers truncated back; NOT "
                         "output-exact); 0 (default): exact N only")
    ap.add_argument("--watch_checkpoint", type=float, default=0.0,
                    help="poll the checkpoint's sidecar every this many "
                         "seconds and reload --which when it advances "
                         "(0 = off)")
    ap.add_argument("--pipeline_depth", type=int, default=2,
                    help="batches in flight at once; 2 (default) overlaps "
                         "the next batch's dispatch with this one's fetch; "
                         "1 = synchronous")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.dp and args.tp:
        raise SystemExit("--dp and --tp are mutually exclusive (one mesh "
                         "axis per serving bundle; pp x tp bundles are "
                         "not a thing at inference)")
    from .export import ServingBundle

    mesh = None
    n_mesh = args.dp or args.tp
    if n_mesh:
        n = parallel.requested_world()
        if n != n_mesh:
            raise SystemExit(
                f"--{'dp' if args.dp else 'tp'} {n_mesh} needs {n_mesh} "
                f"devices, have {n} (one rank each: launch under torchrun "
                "or with HAET_COORDINATOR / HAET_NUM_PROCESSES / "
                "HAET_PROCESS_ID)")
        parallel.init_distributed(device=args.device)
        mesh = (parallel.make_mesh(n_mesh, 1) if args.dp
                else parallel.make_mesh(1, n_mesh))
    bundle = ServingBundle.load(args.bundle, mesh=mesh, device=args.device)
    # the stamp of the weights about to be served, read beside them: a
    # save landing during start-up (loading, warm-up) is then seen
    served = checkpoint_stamp(args.checkpoint, args.which)
    variables = _load_variables(args.checkpoint, args.which)
    if mesh is not None and not parallel.is_writer():
        follow(bundle, variables)
        return 0
    pad = args.dp > 1 if args.pad_to_batch < 0 else bool(args.pad_to_batch)
    with BatchingServer(bundle, variables,
                        max_delay_s=args.max_delay_ms / 1e3,
                        max_queue=args.max_queue, pad_to_batch=pad,
                        pad_to_points=bool(args.pad_to_points),
                        pipeline_depth=args.pipeline_depth,
                        device=args.device) as srv:
        if args.warmup:
            print("warming up (every exported program once)...",
                  flush=True)
            srv.warmup()

        def reload_fn(which):
            srv.reload(_load_variables(args.checkpoint, which))

        httpd = make_server(srv, args.host, args.port,
                            request_timeout_s=args.request_timeout_s,
                            reload_fn=reload_fn)
        print(f"serving {len(bundle.shapes())} artifact(s) on "
              f"{base_url(httpd)} (max_delay={args.max_delay_ms} ms)",
              flush=True)

        # SIGTERM takes Ctrl-C's drain path: stop accepting, join the
        # handlers in flight, then the BatchingServer drains its queues
        def _sigterm(signum, frame):
            raise KeyboardInterrupt

        try:
            import signal

            signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass  # not the main thread (embedded use)
        watch_stop = threading.Event()
        if args.watch_checkpoint > 0:
            threading.Thread(
                target=watch_checkpoint,
                args=(base_url(httpd), args.checkpoint, args.which,
                      args.watch_checkpoint, watch_stop),
                kwargs={"served": served}, daemon=True,
                name="haet-ckpt-watch").start()
            print(f"watching '{args.which}' under {args.checkpoint} "
                  f"every {args.watch_checkpoint} s", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            print("draining (signal received)...", flush=True)
        finally:
            watch_stop.set()  # no reload mid-drain
            httpd.shutdown()
            httpd.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
