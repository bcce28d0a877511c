"""Truncation server: HTTP JSON API over the port's Predictor.

The counterpart of the JAX package's `serve.py` (without its AOT-bundle
mode, which is not ported). It wraps `rlt_tpu_torch.infer.Predictor`, on the
CUDA card unless `--device cpu` is given, with:

* **power-of-two bucketing** — requests are zero-padded up to the next
  power-of-two batch (<= max_batch), so the card sees at most
  log2(max_batch)+1 batch shapes (`bucket_sizes`); pad rows are sliced off
  the response. On the card each bucket is one CUDA graph, captured at its
  first dispatch (or by `--warmup`, every bucket before traffic) and
  replayed under the device lock.
* **ragged list handling** — ranked lists shorter than the model's seq_len
  are zero-padded (the training convention) and the returned cut k is
  clamped to the true list length.
* **stdlib-only HTTP** — `http.server.ThreadingHTTPServer`; one lock
  serializes device dispatch (a single chip executes serially anyway; the
  lock also keeps the latency stats coherent).
* **dynamic micro-batching** (`--microbatch`) — concurrent requests are
  coalesced into one padded device dispatch: a worker drains a queue, waits
  up to `--max-wait-ms` for co-arrivals, concatenates up to `max_batch`
  lists, runs ONE predict, and scatters rows back to their requests. Under
  concurrent small-request load this converts N dispatch latencies into
  one (per-dispatch overhead dominates small batches).

Endpoints:
  GET  /healthz            -> {"ok": true, "model": ..., "seq_len": ...}
  GET  /stats              -> request/list counters + latency percentiles
  POST /truncate           -> body {"features": [[[...]]]} (B lists x <=L
                              positions x F features) or {"scores": [[...]]}
                              for score-only (F=1) models; returns
                              {"k": [...]}, plus per-list distributions when
                              the body sets "return_distribution": true.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from rlt_tpu_torch.config import TrainConfig
from rlt_tpu_torch.infer import COMPUTE_DTYPES, Predictor


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch (n <= max_batch)."""
    if n > max_batch:
        raise ValueError(f"batch of {n} exceeds max_batch={max_batch}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def bucket_sizes(max_batch: int) -> list[int]:
    """Every bucket `bucket_size` can give under `max_batch`."""
    return sorted({bucket_size(n, max_batch) for n in range(1, max_batch + 1)})


class _PendingRequest:
    """One enqueued micro-batch participant; the worker fills the result
    slots and sets the event."""

    __slots__ = ("x", "n", "event", "ks", "dist", "bucket", "error")

    def __init__(self, x: np.ndarray):
        self.x = x
        self.n = x.shape[0]
        self.event = threading.Event()
        self.ks = self.dist = self.bucket = self.error = None


class TruncationService:
    """Predictor + bucketing + stats; the HTTP layer delegates here so tests
    can also drive it directly."""

    def __init__(self, cfg: TrainConfig, state_dict=None, max_batch: int = 256,
                 microbatch: bool = False, max_wait_ms: float = 2.0, device=None):
        self.cfg = cfg
        self.predictor = Predictor(cfg, state_dict=state_dict, device=device)
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=1024)  # seconds, per /truncate call
        self.requests = 0
        self.lists_served = 0
        self.dispatches = 0  # device programs run (< requests when coalescing)
        self.microbatch = microbatch
        self._max_wait_s = max_wait_ms / 1e3
        if microbatch:
            self._queue: deque[_PendingRequest] = deque()
            self._qcond = threading.Condition()
            self._stopping = False
            self._worker = threading.Thread(
                target=self._coalesce_loop, name="rlt-microbatch", daemon=True)
            self._worker.start()

    def close(self):
        """Stop the micro-batch worker (idempotent; no-op without one)."""
        if self.microbatch:
            with self._qcond:
                self._stopping = True
                self._qcond.notify_all()
            self._worker.join(timeout=5)

    # -- input shaping ------------------------------------------------------

    def _to_features(self, body: dict) -> tuple[np.ndarray, np.ndarray]:
        """Parse request body into (B, L, F) padded features + true lengths."""
        L, F = self.cfg.seq_len, self.cfg.input_size
        if "features" in body:
            rows = body["features"]
            want_f = F
        elif "scores" in body:
            if F != 1:
                raise ValueError(
                    f"model {self.cfg.model_name!r} wants {F} features per "
                    "position; send 'features', not 'scores'")
            rows = [[[s] for s in row] for row in body["scores"]]
            want_f = 1
        else:
            raise ValueError("body must contain 'features' or 'scores'")
        if not isinstance(rows, list) or not rows:
            raise ValueError("empty request")
        lengths = np.zeros(len(rows), np.int32)
        x = np.zeros((len(rows), L, want_f), np.float32)
        for i, row in enumerate(rows):
            a = np.asarray(row, np.float32)
            if a.ndim != 2 or a.shape[1] != want_f:
                raise ValueError(
                    f"list {i}: expected (<= {L}, {want_f}) positions x "
                    f"features, got {a.shape}")
            if a.shape[0] > L:
                raise ValueError(
                    f"list {i}: {a.shape[0]} positions exceeds the model's "
                    f"seq_len {L}")
            x[i, : a.shape[0]] = a
            lengths[i] = a.shape[0]
        return x, lengths

    # -- serving ------------------------------------------------------------

    def _dispatch(self, x: np.ndarray):
        """Pad `x` to its bucket and run ONE device program under the device
        lock. Returns (cuts, distributions, bucket) for the first x.shape[0]
        rows."""
        n = x.shape[0]
        b = bucket_size(n, self.max_batch)
        if b > n:  # pad to the bucket's static shape
            x = np.concatenate([x, np.zeros((b - n,) + x.shape[1:], x.dtype)])
        with self._lock:
            ks, dist = self.predictor.predict_with_distribution(x)
            self.dispatches += 1
        return ks, dist, b

    def _coalesce_loop(self):
        """Micro-batch worker: drain co-arriving requests into one dispatch."""
        while True:
            with self._qcond:
                while not self._queue and not self._stopping:
                    self._qcond.wait()
                if self._stopping:
                    for r in self._queue:  # fail fast, don't hang clients
                        r.error = RuntimeError("service shutting down")
                        r.event.set()
                    self._queue.clear()
                    return
                # batch window: wait for co-arrivals until the batch is full
                # or the deadline passes (first-arrival latency bound)
                deadline = time.perf_counter() + self._max_wait_s
                while sum(r.n for r in self._queue) < self.max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._stopping:
                        break
                    self._qcond.wait(timeout=remaining)
                batch, rows = [], 0
                while self._queue and rows + self._queue[0].n <= self.max_batch:
                    r = self._queue.popleft()
                    batch.append(r)
                    rows += r.n
            if not batch:
                continue
            try:
                x = batch[0].x if len(batch) == 1 else np.concatenate(
                    [r.x for r in batch])
                ks, dist, b = self._dispatch(x)
            except Exception as e:  # surface to every waiting client
                for r in batch:
                    r.error = e
                    r.event.set()
                continue
            off = 0
            for r in batch:
                r.ks, r.dist = ks[off:off + r.n], dist[off:off + r.n]
                r.bucket, off = b, off + r.n
                r.event.set()

    def _submit(self, x: np.ndarray):
        req = _PendingRequest(x)
        with self._qcond:
            if self._stopping:
                raise RuntimeError("service shutting down")
            self._queue.append(req)
            self._qcond.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.ks, req.dist, req.bucket

    def truncate(self, body: dict) -> dict:
        x, lengths = self._to_features(body)
        n = x.shape[0]
        if n > self.max_batch:
            raise ValueError(f"batch of {n} exceeds max_batch={self.max_batch}")
        t0 = time.perf_counter()
        if self.microbatch:
            ks, dist, b = self._submit(x)
        else:
            ks, dist, b = self._dispatch(x)
        dt = time.perf_counter() - t0
        with self._lock:
            self._latencies.append(dt)
            self.requests += 1
            self.lists_served += n
        ks = np.minimum(
            np.asarray(ks)[:n].astype(np.int64), lengths)  # clamp to true len
        out = {"k": ks.tolist(), "bucket": b, "latency_ms": round(dt * 1e3, 3)}
        if body.get("return_distribution"):
            out["distribution"] = [
                np.asarray(dist[i][: lengths[i]]).tolist() for i in range(n)
            ]
        return out

    def warmup(self) -> list[int]:
        """Ready every bucket before traffic, under the device lock: on the
        card, capture its graph. Returns the buckets."""
        sizes = bucket_sizes(self.max_batch)
        with self._lock:
            for b in sizes:
                self.predictor.prepare(b)
        return sizes

    def health(self) -> dict:
        return {
            "ok": True,
            "model": self.cfg.model_name,
            "seq_len": self.cfg.seq_len,
            "input_size": self.cfg.input_size,
            "compute_dtype": self.cfg.compute_dtype,
            "max_batch": self.max_batch,
        }

    def stats(self) -> dict:
        lat = sorted(self._latencies)

        def pct(p):
            if not lat:
                return None
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 3)

        return {
            "requests": self.requests,
            "lists_served": self.lists_served,
            "dispatches": self.dispatches,
            "latency_ms": {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99)},
        }


def make_server(service: TruncationService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; port 0 picks a free port."""

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.health())
            elif self.path == "/stats":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/truncate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                self._send(200, service.truncate(body))
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # malformed JSON etc.
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, *args):  # quiet by default; stats cover it
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse
    import logging

    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("rlt_tpu_torch.serve")

    p = argparse.ArgumentParser(description="rlt_tpu_torch truncation server")
    p.add_argument("--model-name", type=str, default="mmoecut")
    p.add_argument("--model-path", type=str, default=None,
                   help="torch state_dict file (torch.save(model.state_dict()))")
    p.add_argument("--retrieve-data", type=str, default="robust04",
                   help="shape preset: robust04 (L=300) | mq2007 (L=40)")
    p.add_argument("--compute-dtype", type=str, default="float32",
                   choices=tuple(COMPUTE_DTYPES),
                   help="serve with bf16 parameters, features and kernels")
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--max-batch", type=int, default=256)
    p.add_argument("--microbatch", action="store_true",
                   help="coalesce concurrent requests into one device "
                   "dispatch (dynamic micro-batching)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   help="micro-batch co-arrival window (first-request "
                   "latency bound)")
    p.add_argument("--warmup", action="store_true",
                   help="ready every bucket before accepting traffic (on the card: "
                   "capture its CUDA graph)")
    args = p.parse_args(argv)

    cfg = TrainConfig(model_name=args.model_name, model_path=args.model_path,
                      retrieve_data=args.retrieve_data,
                      compute_dtype=args.compute_dtype)
    service = TruncationService(cfg, max_batch=args.max_batch,
                                microbatch=args.microbatch,
                                max_wait_ms=args.max_wait_ms,
                                device=args.device)
    if args.warmup:
        logger.info("warmup: buckets %s ready", service.warmup())
    server = make_server(service, args.host, args.port)
    logger.info("serving %s on http://%s:%d (seq_len=%d, max_batch=%d, %s)",
                cfg.model_name, *server.server_address, cfg.seq_len,
                service.max_batch, cfg.compute_dtype)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        service.close()


if __name__ == "__main__":
    main()
