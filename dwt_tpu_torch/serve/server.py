"""Serving front ends: dispatcher thread, in-process client, HTTP JSON lines.

The port of ``dwt_tpu.serve.server``'s core::

    submit()  ->  MicroBatcher (admission, coalescing, shedding)
                      |  PlannedBatch stream
                      v
              ServeEngine.stage (pinned H2D) -> ServeEngine.forward
                      |  logits -> host
                      v
              per-request futures resolved

:class:`ServeClient` is the in-process form; :class:`HttpFront` puts a
stdlib ``http.server`` front end over it (``POST /infer``, ``GET
/healthz``, ``GET /stats``; one JSON line per response).  ``/infer``
takes ``{"inputs": [...]}`` JSON, or a ``.npy`` body with
``Content-Type: application/x-npy`` — a 128-image batch at 224² is
~77 MB as float32 and several hundred MB as JSON text.

Run: ``python -m dwt_tpu_torch.serve.server --model resnet50 --ckpt_dir
DIR`` to serve the newest valid checkpoint of a training run (the port's,
or the JAX package's host-shard format), or ``--init_random`` for fresh
weights from ``--seed`` (``--model lenet`` serves the digits model at
28×28×1, ``--model resnet101 --num_classes 12`` the VisDA model; on CUDA,
``--device cpu`` for the CPU).  The ``--model`` choices are the JAX
server's; a ViT-DWT is served through :class:`ServeEngine`'s Python API,
which takes any registry backbone.  ``serve_ready``,
``/healthz`` and every ``/infer`` reply carry the checkpoint's ``step``.
``--serve_dtype bf16`` (``--bf16``) serves in bf16 from the f32
parameters; ``--whitener`` names the checkpoint's whitening backend.
SIGTERM or
SIGINT drains: in-flight requests complete, queued requests dispatch,
new arrivals get 503 with ``Retry-After``, exit code 0.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import io
import json
import logging
import select
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dwt_tpu_torch.config import model_dtype
from dwt_tpu_torch.nn.lenet import INPUT_SHAPE as LENET_INPUT_SHAPE
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.registry import build_backbone
from dwt_tpu_torch.serve.batcher import (
    Future,
    MicroBatcher,
    PlannedBatch,
    ShedError,
    resolve_future,
)
from dwt_tpu_torch.serve.engine import ServeEngine

log = logging.getLogger(__name__)

NPY_CONTENT_TYPE = "application/x-npy"


class _Dispatcher(threading.Thread):
    """Drains the batcher through the engine; resolves request futures.
    One thread owns all device work."""

    # Idle poll period of the batch wait (bounds the heartbeat's age on
    # an idle server).
    POLL_S = 1.0

    def __init__(self, engine: ServeEngine, batcher: MicroBatcher):
        super().__init__(name="dwt-serve-dispatch", daemon=True)
        self.engine = engine
        self.batcher = batcher
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.counts = collections.Counter()        # ok/error requests, imgs
        self.batches = collections.Counter()       # dispatched batches by bucket
        self._beat = time.monotonic()

    @property
    def heartbeat_age_s(self) -> float:
        return time.monotonic() - self._beat

    def _serve(self, pb: PlannedBatch) -> None:
        try:
            x = self.engine.stage(pb.x)
            t0 = time.perf_counter()
            logits = self.engine.forward(x, pb.bucket).cpu().numpy()
            seconds = time.perf_counter() - t0
        except Exception as e:  # resolve, don't strand waiters
            log.exception("batch of bucket %d failed", pb.bucket)
            with self._lock:
                self.counts["error"] += len(pb.requests)
            for req in pb.requests:
                resolve_future(req.future, exc=e)
            return
        self.batcher.note_served(pb.real_n, seconds)
        with self._lock:
            self.batches[pb.bucket] += 1
            self.counts["ok"] += len(pb.requests)
            self.counts["images"] += pb.real_n
        for req, (lo, hi) in zip(pb.requests, pb.slices):
            resolve_future(req.future, result=logits[lo:hi])

    def run(self) -> None:
        try:
            while True:
                pb = self.batcher.next_batch(timeout=self.POLL_S)
                self._beat = time.monotonic()
                if pb is None:
                    # A poll timeout can race drain() with requests still
                    # queued: exit only once stopping AND empty.
                    if self.batcher.stopping and self.batcher.queued_items == 0:
                        return
                    continue
                self._serve(pb)
                self._beat = time.monotonic()
        except BaseException as e:
            # The dispatcher is dead: close admission and fail everything
            # pending rather than strand it until client timeouts.
            self.error = e
            log.exception("serving dispatcher died; failing pending requests")
            self.batcher.close()
            self.batcher.fail_pending(e)

    def snapshot(self) -> Tuple[dict, dict]:
        with self._lock:
            return dict(self.counts), dict(self.batches)


class ServeClient:
    """In-process serving client: batcher + dispatcher around an engine.

    ``submit`` returns a :class:`Future` of the request's
    ``[n, classes]`` logits; ``infer`` is the blocking form;
    ``close(drain=True)`` stops admissions, flushes the queue and joins
    the dispatcher.
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        max_batch_delay_ms: float = 5.0,
        max_queue_items: int = 1024,
    ):
        self.engine = engine
        self.batcher = MicroBatcher(
            buckets=engine.buckets,
            max_batch_delay_ms=max_batch_delay_ms,
            max_queue_items=max_queue_items,
            sample_shape=engine.input_shape,
        )
        self._dispatcher = _Dispatcher(engine, self.batcher)
        self._shed = 0
        self._shed_lock = threading.Lock()
        self._t0 = time.monotonic()
        self._dispatcher.start()

    @property
    def dispatcher_alive(self) -> bool:
        return self._dispatcher.is_alive()

    @property
    def dispatcher_error(self) -> Optional[BaseException]:
        return self._dispatcher.error

    @property
    def batches(self) -> dict:
        """Dispatched batches by bucket size."""
        return self._dispatcher.snapshot()[1]

    def stats(self) -> dict:
        """The ``/stats`` body."""
        counts, batches = self._dispatcher.snapshot()
        out = {
            "ok_requests": counts.get("ok", 0),
            "error_requests": counts.get("error", 0),
            "shed_requests": self._shed,
            "served_images": counts.get("images", 0),
            "batches_by_bucket": {str(b): n for b, n in sorted(batches.items())},
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queued_items": self.batcher.queued_items,
            "dispatcher_heartbeat_age_s": round(
                self._dispatcher.heartbeat_age_s, 3),
            "device": str(self.engine.device),
        }
        if self.engine.device.type == "cuda":
            out["device_memory"] = {
                "bytes_in_use": torch.cuda.memory_allocated(self.engine.device),
                "peak_bytes_in_use":
                    torch.cuda.max_memory_allocated(self.engine.device),
            }
        return out

    def submit(self, x: np.ndarray) -> Future:
        try:
            return self.batcher.submit(x)
        except ShedError:
            with self._shed_lock:
                self._shed += 1
            raise

    def infer(self, x: np.ndarray, timeout: Optional[float] = 60.0):
        return self.submit(x).result(timeout)

    def close(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Graceful stop: (optionally) let the queue drain, then join the
        dispatcher.  With ``drain=False`` queued requests are failed."""
        if not drain:
            self.batcher.fail_pending(RuntimeError("server shutting down"))
        self.batcher.close()
        self._dispatcher.join(timeout)
        if self._dispatcher.is_alive():
            raise RuntimeError("serving dispatcher did not drain in time")


class HttpServeClient:
    """Keep-alive HTTP client for the server: one persistent connection
    per calling thread."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self._local = threading.local()

    def _conn(self) -> http.client.HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
            self._local.conn = conn
        return conn

    def request(
        self, method: str, path: str, body: Optional[bytes] = None,
        content_type: str = "application/json",
    ) -> Tuple[int, dict]:
        """One request → ``(status, parsed JSON body)``.  A broken
        connection is dropped and the error raised: ``/infer`` is not
        idempotent, so nothing is re-sent."""
        headers = {"Content-Type": content_type} if body is not None else {}
        conn = self._conn()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, OSError):
            self.close()
            raise
        return resp.status, (json.loads(data) if data else {})

    def infer(self, x: np.ndarray, binary: bool = False) -> np.ndarray:
        """Logits for ``x [n, ...sample]``, sent as JSON or, with
        ``binary``, as a ``.npy`` body."""
        x = np.asarray(x, np.float32)
        if binary:
            buf = io.BytesIO()
            np.save(buf, x, allow_pickle=False)
            status, payload = self.request(
                "POST", "/infer", buf.getvalue(), NPY_CONTENT_TYPE)
        else:
            status, payload = self.request(
                "POST", "/infer", json.dumps({"inputs": x.tolist()}).encode())
        if status == 200:
            return np.asarray(payload["logits"], np.float32)
        if status in (429, 503) and "retry_after_ms" in payload:
            raise ShedError(payload["retry_after_ms"], 0)
        raise RuntimeError(f"/infer returned {status}: {payload.get('error', payload)}")

    def healthz(self) -> Tuple[int, dict]:
        return self.request("GET", "/healthz")

    def stats(self) -> dict:
        status, payload = self.request("GET", "/stats")
        if status != 200:
            raise RuntimeError(f"/stats returned {status}")
        return payload

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


# ------------------------------------------------------------- HTTP front


class _Handler(BaseHTTPRequestHandler):
    """Keep-alive JSON-line handler: HTTP/1.1 persistent connections, a
    drain-aware idle wait, and a body read on every POST branch (unread
    bytes would parse as the next request on the connection)."""

    client: ServeClient = None  # type: ignore[assignment]  # set by HttpFront
    draining: threading.Event = None  # type: ignore[assignment]
    # Socket read timeout: handler threads are non-daemon and joined at
    # shutdown, so a stalled client must not hold exit hostage.
    timeout = 120.0
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("http: " + fmt, *args)

    def handle_one_request(self):
        # Idle keep-alive wait in short select slices, so a parked
        # connection neither blocks the drain nor outlives the timeout.
        idle_deadline = time.monotonic() + self.timeout
        while True:
            try:
                ready, _, _ = select.select([self.connection], [], [], 0.5)
            except (OSError, ValueError):  # connection torn down
                self.close_connection = True
                return
            if ready:
                break
            if self.draining.is_set() or time.monotonic() > idle_deadline:
                self.close_connection = True
                return
        super().handle_one_request()

    def _reply(self, code: int, payload: dict, headers=()) -> None:
        body = (json.dumps(payload) + "\n").encode()  # one JSON line
        self.send_response(code)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        client = self.client
        if self.path == "/healthz":
            alive = client.dispatcher_alive
            err = client.dispatcher_error
            self._reply(200 if alive else 503, {
                "ok": alive,
                "draining": self.draining.is_set(),
                "buckets": list(client.engine.buckets),
                "queued_items": client.batcher.queued_items,
                "step": client.engine.step,
                "device": str(client.engine.device),
                **({"dispatcher_error": f"{type(err).__name__}: {err}"}
                   if err is not None else {}),
            })
        elif self.path == "/stats":
            self._reply(200, client.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _read_inputs(self, body: bytes) -> np.ndarray:
        if self.headers.get("Content-Type", "").startswith(NPY_CONTENT_TYPE):
            x = np.load(io.BytesIO(body), allow_pickle=False)
        else:
            x = np.asarray(json.loads(body or b"{}")["inputs"], np.float32)
        x = np.asarray(x, np.float32)
        if x.ndim == len(self.client.engine.input_shape):
            x = x[None]  # single sample -> batch of one
        return x

    def do_POST(self):
        length = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(length) if length > 0 else b""  # ALWAYS read
        if self.path != "/infer":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            x = self._read_inputs(body)
        except (ValueError, KeyError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
            return
        if self.draining.is_set():
            self._reply(503, {"error": "draining", "retry_after_ms": 1000},
                        headers=[("Retry-After", "1")])
            return
        try:
            logits = self.client.submit(x).result(timeout=60.0)
        except ShedError as e:
            self._reply(429, {
                "error": "overloaded", "retry_after_ms": e.retry_after_ms,
            }, headers=[("Retry-After", str(max(1, e.retry_after_ms // 1000)))])
            return
        except ValueError as e:
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, {
            "logits": logits.tolist(),
            "pred": np.argmax(logits, axis=-1).tolist(),
            "step": self.client.engine.step,
        })


class HttpFront:
    """The HTTP server over a :class:`ServeClient`, listening on a
    background thread; ``port`` is the bound port (pass 0 for any free
    one).  ``close()`` drains: new requests get 503, queued requests
    complete, handler threads are joined."""

    def __init__(self, client: ServeClient, host: str = "127.0.0.1",
                 port: int = 0):
        self.client = client
        self.draining = threading.Event()
        handler = type("Handler", (_Handler,), {
            "client": client, "draining": self.draining,
        })

        class _Server(ThreadingHTTPServer):
            # Non-daemon handlers, joined by server_close(): a drain must
            # not cut a response mid-write at interpreter exit.
            daemon_threads = False

        self.httpd = _Server((host, port), handler)
        self.host = host
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="dwt-serve-http", daemon=True
        )
        self._thread.start()

    def close(self) -> None:
        self.draining.set()
        self.client.batcher.drain()
        self.client.close(drain=True)
        self.httpd.shutdown()
        self._thread.join(timeout=10)
        self.httpd.server_close()


# ------------------------------------------------------------------ CLI


def resolve_serve_dtype(args) -> str:
    """``--serve_dtype`` name ("f32" | "bf16"): given, it wins; else the
    legacy ``--bf16`` boolean aliases bf16; else f32."""
    name = getattr(args, "serve_dtype", None)
    if name is None:
        return "bf16" if getattr(args, "bf16", False) else "f32"
    return name


def build_model(args):
    """``(model, input_shape)`` for ``--model lenet|tiny|resnet50|resnet101``
    (the ResNets through the backbone registry); fresh
    weights from ``--seed`` under ``--init_random`` (and without it,
    weights a checkpoint replaces).  LeNet-DWT always has
    10 classes and takes 28×28×1 (``--num_classes`` and ``--image_size``
    are the ResNets').  ``--serve_dtype`` sets only the compute dtype: the
    parameters stay f32, so any checkpoint serves at either precision;
    ``--whitener`` must be the checkpoint's."""
    seed = args.seed if args.init_random and not args.ckpt_dir else None
    kw = dict(group_size=args.group_size, seed=seed,
              dtype=model_dtype(resolve_serve_dtype(args)),
              whitener=getattr(args, "whitener", "cholesky"))
    if args.model == "lenet":
        return build_lenet(**kw), LENET_INPUT_SHAPE
    model = build_backbone(args.model, num_classes=args.num_classes,
                           image_size=args.image_size, **kw)
    return model, (args.image_size, args.image_size, 3)


def build_engine(args) -> ServeEngine:
    """The engine of ``--ckpt_dir`` (which wins) or ``--init_random``."""
    if not (args.ckpt_dir or args.init_random):
        raise SystemExit(
            "dwt_tpu_torch serve: pass --ckpt_dir (a training checkpoint "
            "directory) or --init_random for a fresh-init smoke server"
        )
    model, input_shape = build_model(args)
    kwargs = dict(buckets=[int(b) for b in args.buckets.split(",")],
                  device=args.device)
    if args.ckpt_dir:
        return ServeEngine.from_checkpoint(args.ckpt_dir, model, input_shape,
                                           **kwargs)
    return ServeEngine(model, input_shape, **kwargs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Micro-batching inference server for the DWT "
        "deployment forward (PyTorch/CUDA port)"
    )
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="serve the newest valid checkpoint of this training "
                        "checkpoint directory (main or anchors)")
    p.add_argument("--init_random", action="store_true",
                   help="serve a freshly initialized model (weights from "
                        "--seed)")
    p.add_argument("--model", choices=["lenet", "tiny", "resnet50", "resnet101"],
                   default="resnet50")
    p.add_argument("--num_classes", type=int, default=65,
                   help="resnet head size (lenet is always 10)")
    p.add_argument("--image_size", type=int, default=224,
                   help="resnet input resolution (lenet takes 28)")
    p.add_argument("--group_size", type=int, default=4)
    p.add_argument("--whitener",
                   choices=["cholesky", "newton_schulz", "swbn"],
                   default="cholesky",
                   help="the checkpoint's whitening backend (its stats, and "
                        "how the eval matrices are computed)")
    p.add_argument("--bf16", action="store_true",
                   help="legacy alias for --serve_dtype bf16")
    p.add_argument("--serve_dtype", choices=["f32", "bf16"], default=None,
                   help="forward compute dtype: bf16 runs the deployment "
                        "forward's activations in bf16 and casts the "
                        "(f32-factorized) whiten cache to bf16 once.  Params "
                        "restore f32 either way.  Default: f32 (or bf16 when "
                        "--bf16 is set)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--buckets", default="1,8,32,128",
                   help="comma-separated batch sizes warmed at start")
    p.add_argument("--max_batch_delay_ms", type=float, default=5.0,
                   help="longest a queued request waits for batch-mates")
    p.add_argument("--max_queue", type=int, default=1024,
                   help="queued samples past which requests are shed (429)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without CUDA) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8978)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    client = ServeClient(
        engine,
        max_batch_delay_ms=args.max_batch_delay_ms,
        max_queue_items=args.max_queue,
    )
    front = HttpFront(client, args.host, args.port)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        # Flag-only handler; the main thread runs the drain.
        signal.signal(sig, lambda signum, frame: stop.set())
    print(json.dumps({
        "kind": "serve_ready", "host": args.host, "port": front.port,
        "buckets": list(engine.buckets), "device": str(engine.device),
        "step": engine.step, "source": engine.source,
        "warmup_s": engine.warmup_s,
    }), flush=True)
    stop.wait()
    log.info("drain: signal received; completing in-flight work")
    front.close()
    print(json.dumps({"kind": "serve_summary", **client.stats()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
