"""Serving front ends: dispatcher thread, in-process client, HTTP JSON lines.

The port of ``dwt_tpu.serve.server``::

    submit()  ->  MicroBatcher (admission, coalescing, shedding)
                      |  PlannedBatch stream
                      v
              ServeEngine.stage (pinned H2D) -> ServeEngine.forward
                      |  logits -> host            (one engine.state
                      v                             snapshot per batch)
              per-request futures resolved + AccessLog records
                      |
                      v
              DomainAdapter.offer (real rows only; --adapt_every)

:class:`ServeClient` is the in-process form; :class:`HttpFront` puts a
stdlib ``http.server`` front end over it (``POST /infer``, ``GET
/healthz``, ``GET /stats``, ``GET /metrics`` — the Prometheus text of
the process-wide registry; one JSON line per JSON response).
``/infer`` takes ``{"inputs": [...]}`` JSON, or a ``.npy`` body with
``Content-Type: application/x-npy`` — a 128-image batch at 224² is
~77 MB as float32 and several hundred MB as JSON text.  Every ``/infer``
reply carries the checkpoint ``step`` and the ``version`` of the
generation that computed it.

Run: ``python -m dwt_tpu_torch.serve.server --model resnet50 --ckpt_dir
DIR`` to serve the newest valid checkpoint of a training run (the port's,
or the JAX package's host-shard or delta format), or ``--init_random``
for fresh weights from ``--seed`` (``--model lenet`` serves the digits
model at 28×28×1, ``--model resnet101 --num_classes 12`` the VisDA
model; on CUDA, ``--device cpu`` for the CPU).  The ``--model`` choices
are the JAX server's; a ViT-DWT is served through :class:`ServeEngine`'s
Python API, which takes any registry backbone.  ``--serve_dtype bf16``
(``--bf16``) serves in bf16 from the f32 parameters; ``--quantize_int8``
keeps the weights resident as int8; ``--whitener`` names the
checkpoint's whitening backend.

The deployment plane (``dwt_tpu_torch.fleet``): ``--watch`` hot-reloads
new checkpoints of ``--ckpt_dir``, ``--adapt_every S`` folds live
traffic's whitening/BN moments into adapted generations; both submit
through one canary gate (``--canary_fixture``), atomic swap and
post-swap monitor (``--rollback_*``), with lifecycle events on the
``--access_log`` JSONL stream.  ``--obs_trace PATH`` (or
``DWT_OBS_TRACE``) records the serving spans — ``admission``, ``plan``
and ``build_batch`` in the batcher, ``stage``, ``device`` and ``resolve``
here, each carrying the batch's ``req_ids`` — and writes them as a Chrome
trace at the drain.  SIGTERM or SIGINT drains: the reloader
and the adapter stop, in-flight requests complete, queued requests
dispatch, new arrivals get 503 with ``Retry-After``, exit code 0.

**Across ranks** (``--distributed`` with ``--data_parallel``, or
``--mesh_shape``/``--sharding_rules``; the JAX server's flags, resolved
by ``parallel.plan_from_flags`` with its decisions and texts): one
process per rank, launched as the trainers are (the DWT_* or torchrun
variables).  Rank 0 is the front — everything above — and its engine a
:class:`~dwt_tpu_torch.serve.fanout.FanoutEngine`; every other rank is a
follower with no HTTP port, running the front's operations in order
(``dwt_tpu_torch.serve.fanout``).  ``GET /fanout`` reports every rank
(``?digest=1`` adds each rank's generation digest, ``?shapes=1`` its
local parameter shapes).  The front's drain stops the followers and every
rank exits 0; a follower that dies makes the front fail that batch's
requests, turn ``/healthz`` unhealthy and exit 1.  ``--quantize_int8``
under a gspmd plan is refused (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import collections
import http.client
import io
import json
import logging
import signal
import threading
import time
import urllib.parse
from http.server import ThreadingHTTPServer
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.config import model_dtype
from dwt_tpu_torch.nn.lenet import INPUT_SHAPE as LENET_INPUT_SHAPE
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.registry import build_backbone
from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.ops import cuda_whitening
from dwt_tpu_torch.parallel import (
    host_group,
    plan_from_flags,
    process_count,
    process_index,
    shutdown_distributed,
)
from dwt_tpu_torch.parallel.mesh import join_from_flags
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.serve.batcher import (
    Future,
    MicroBatcher,
    PlannedBatch,
    ShedError,
    resolve_future,
)
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.serve.fanout import FanoutEngine, follow
from dwt_tpu_torch.serve.http import DrainAwareHandler
from dwt_tpu_torch.serve.metrics import AccessLog
from dwt_tpu_torch.utils.metrics import device_memory_stats

log = logging.getLogger(__name__)

NPY_CONTENT_TYPE = "application/x-npy"

# Seconds a front that lost a rank keeps answering (``/healthz`` 503, every
# request an error) before it drains and exits 1: a balancer's probe sees it.
FAULT_GRACE_S = 1.0


class _Dispatcher(threading.Thread):
    """Drains the batcher through the engine; resolves request futures.
    One thread owns all serving device work."""

    # Idle poll period of the batch wait (bounds the heartbeat's age on
    # an idle server).
    POLL_S = 1.0

    def __init__(self, engine: ServeEngine, batcher: MicroBatcher,
                 access_log: AccessLog):
        super().__init__(name="dwt-serve-dispatch", daemon=True)
        self.engine = engine
        self.batcher = batcher
        self.access_log = access_log
        self.error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.counts = collections.Counter()        # ok/error requests, imgs
        self.batches = collections.Counter()       # dispatched batches by bucket
        self._beat = time.monotonic()
        # Optional per-batch observer ``fn(x, real_n)`` — the online
        # adapter's harvest hook (``DomainAdapter.offer``).  None by
        # default: a non-adaptive server pays one attribute read.  Called
        # AFTER the batch's futures resolve, with the padded batch and
        # its real-row count; it must be cheap and must not raise.
        self.batch_hook = None
        # Batch identity for the access records: every record of one
        # dispatched batch carries the same batch_seq, so "no batch ever
        # mixed versions" is checkable from the log alone.
        self._batch_seq = 0
        self._t_pull: Optional[float] = None  # the batch being served

    @property
    def heartbeat_age_s(self) -> float:
        # With a batch in flight, its age since pull (a hung device call
        # keeps growing it); idle, the time since the last poll wake.
        t0 = self._t_pull
        return time.monotonic() - (self._beat if t0 is None else t0)

    @property
    def in_flight_count(self) -> int:
        """Batches pulled but not yet resolved (0 or 1)."""
        return int(self._t_pull is not None)

    def _serve(self, pb: PlannedBatch) -> None:
        # An injected straggler (replica_slow_at): the sleep lands in the
        # batch's service time, so e2e latency and the balancer's drain-rate
        # EWMA see a slow replica, not a dead one (probes still answer).
        inject.maybe_replica_slow()
        engine = self.engine
        # ONE state snapshot per batch — the hot-swap contract: a swap
        # landing mid-batch flips the engine's reference, but this batch
        # computes and is attributed entirely on the generation it took.
        st = engine.state
        version = st.version.label
        self._batch_seq += 1
        batch_seq = self._batch_seq
        # The spans' req_ids join them to this batch's access records.
        req_ids = [r.req_id for r in pb.requests]
        try:
            with obs.span("stage", "serve", bucket=pb.bucket, req_ids=req_ids):
                x = engine.stage(pb.x)
            t0 = time.perf_counter()
            # The dispatcher's one sync: the copy to the host waits for the
            # forward, so the span is the batch's device time (tracing adds
            # no wait of its own).
            with obs.span("device", "serve", bucket=pb.bucket, n=pb.real_n,
                          req_ids=req_ids):
                logits = engine.forward(x, pb.bucket, state=st).cpu().numpy()
            seconds = time.perf_counter() - t0
        except Exception as e:  # resolve, don't strand waiters
            log.exception("batch of bucket %d failed", pb.bucket)
            with self._lock:
                self.counts["error"] += len(pb.requests)
            for req in pb.requests:
                self.access_log.record(
                    "error", req.n, bucket=pb.bucket, req_id=req.req_id,
                    version=version, batch_seq=batch_seq,
                    error=f"{type(e).__name__}: {e}",
                )
                resolve_future(req.future, exc=e)
            return
        self.batcher.note_served(pb.real_n, seconds)
        with self._lock:
            self.batches[pb.bucket] += 1
            self.counts["ok"] += len(pb.requests)
            self.counts["images"] += pb.real_n
        now = self.batcher.clock()
        with obs.span("resolve", "serve", bucket=pb.bucket, n=pb.real_n,
                      req_ids=req_ids):
            for req, (lo, hi) in zip(pb.requests, pb.slices):
                # Record BEFORE resolving: a caller woken by the future finds
                # its record already in the log.
                self.access_log.record(
                    "ok", req.n, bucket=pb.bucket, batch_n=pb.bucket,
                    real_n=pb.real_n, req_id=req.req_id,
                    version=version, batch_seq=batch_seq,
                    queue_ms=(pb.dispatch_t - req.enqueue_t) * 1e3,
                    device_ms=seconds * 1e3,
                    e2e_ms=(now - req.enqueue_t) * 1e3,
                )
                req.future.version = version
                resolve_future(req.future, result=logits[lo:hi])
        hook = self.batch_hook
        if hook is not None:
            hook(pb.x, pb.real_n)

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
                self._t_pull = time.monotonic()
                self._serve(pb)
                self._t_pull = None
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
    ``[n, classes]`` logits (its ``version`` attribute names the
    generation that computed them); ``infer`` is the blocking form;
    ``close(drain=True)`` stops admissions, flushes the queue and joins
    the dispatcher.
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        max_batch_delay_ms: float = 5.0,
        max_queue_items: int = 1024,
        access_log: Optional[AccessLog] = None,
        max_request_share: float = 1.0,
    ):
        self.engine = engine
        self.access_log = access_log or AccessLog()
        self.batcher = MicroBatcher(
            buckets=engine.buckets,
            max_batch_delay_ms=max_batch_delay_ms,
            max_queue_items=max_queue_items,
            sample_shape=engine.input_shape,
            max_request_share=max_request_share,
        )
        self._dispatcher = _Dispatcher(engine, self.batcher, self.access_log)
        self.adapter = None  # attach_adapter (online domain adaptation)
        self._shed = 0
        self._shed_lock = threading.Lock()
        self._t0 = time.monotonic()
        # Live metrics: callback gauges sampled at scrape time (the newest
        # client in a process owns them).
        reg = get_registry()
        reg.gauge(
            "dwt_serve_queue_depth", "samples queued for dispatch"
        ).set_function(lambda: self.batcher.queued_items)
        reg.gauge(
            "dwt_serve_in_flight_batches",
            "batches staged/computing but unresolved",
        ).set_function(lambda: self._dispatcher.in_flight_count)
        reg.gauge(
            "dwt_serve_dispatcher_heartbeat_age_s",
            "seconds since the dispatcher last showed liveness",
        ).set_function(lambda: self.dispatcher_heartbeat_age_s)
        reg.gauge(
            "dwt_serve_uptime_s", "seconds since this client started"
        ).set_function(lambda: time.monotonic() - self._t0)
        self._m_version = reg.gauge(
            "dwt_serve_version",
            "currently served checkpoint generation (value is always 1)",
            labelnames=("version",),
        )
        self._m_swaps = reg.gauge(
            "dwt_serve_swap_count", "hot swaps since process start"
        )
        self._dispatcher.start()

    def attach_adapter(self, adapter) -> None:
        """Wire a :class:`~dwt_tpu_torch.serve.adapt.DomainAdapter` into
        this client: the dispatcher feeds it every dispatched bucket's
        real rows, and ``/stats`` grows the adaptation fields.  ``None``
        detaches."""
        self.adapter = adapter
        self._dispatcher.batch_hook = None if adapter is None else adapter.offer

    def refresh_version_metrics(self) -> None:
        """Re-stamp the served-version info gauge (scrape time: a swap
        may have landed since the last scrape)."""
        self._m_version.clear()
        self._m_version.labels(version=self.engine.version.label).set(1)
        self._m_swaps.set(self.engine.swap_count)

    @property
    def dispatcher_alive(self) -> bool:
        return self._dispatcher.is_alive()

    @property
    def dispatcher_error(self) -> Optional[BaseException]:
        return self._dispatcher.error

    @property
    def dispatcher_heartbeat_age_s(self) -> float:
        return self._dispatcher.heartbeat_age_s

    @property
    def batches(self) -> dict:
        """Dispatched batches by bucket size."""
        return self._dispatcher.snapshot()[1]

    def stats(self) -> dict:
        """The ``/stats`` body: the access log's summary (per-version
        windows included), the request counts by outcome, the live
        process view, the served version, with an adapter attached its
        fields and, on a card, the device memory and the kernels'
        launches."""
        counts, batches = self._dispatcher.snapshot()
        out = self.access_log.summary()
        out.update({
            "ok_requests": counts.get("ok", 0),
            "error_requests": counts.get("error", 0),
            "shed_requests": self._shed,
            "served_images": counts.get("images", 0),
            "batches_by_bucket": {str(b): n for b, n in sorted(batches.items())},
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "queued_items": self.batcher.queued_items,
            "in_flight_batches": self._dispatcher.in_flight_count,
            "dispatcher_heartbeat_age_s": round(
                self._dispatcher.heartbeat_age_s, 3),
            "device": str(self.engine.device),
            "version": self.engine.version.label,
            "swap_count": self.engine.swap_count,
        })
        if self.adapter is not None:
            out["adaptation"] = self.adapter.stats()
        if self.engine.device.type == "cuda":
            mem = device_memory_stats()
            if mem is not None:
                out["device_memory"] = mem
            # The process's hand-kernel launches so far: how a fleet shows
            # that its replicas ran the kernels (a CPU engine launches none).
            out["kernel_launches"] = {"apply": cuda_whitening.apply_launches,
                                      "moments": cuda_whitening.moments_launches}
        return out

    def submit(self, x: np.ndarray) -> Future:
        try:
            return self.batcher.submit(x)
        except ShedError as e:
            with self._shed_lock:
                self._shed += 1
            self.access_log.record(
                "shed", int(np.asarray(x).shape[0]),
                retry_after_ms=e.retry_after_ms, queued=e.queued,
            )
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

    def request_raw(
        self, method: str, path: str, body: Optional[bytes] = None,
        content_type: str = "application/json",
    ) -> Tuple[int, bytes]:
        """One request → ``(status, body bytes)``.  A broken connection is
        dropped and the error raised: ``/infer`` is not idempotent, so
        nothing is re-sent."""
        headers = {"Content-Type": content_type} if body is not None else {}
        conn = self._conn()
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except (http.client.HTTPException, OSError):
            self.close()
            raise
        return resp.status, data

    def request(
        self, method: str, path: str, body: Optional[bytes] = None,
        content_type: str = "application/json",
    ) -> Tuple[int, dict]:
        """One request → ``(status, parsed JSON body)``."""
        status, data = self.request_raw(method, path, body, content_type)
        return status, (json.loads(data) if data else {})

    def infer_reply(self, x: np.ndarray, binary: bool = False) -> dict:
        """The whole ``/infer`` reply for ``x [n, ...sample]`` (logits,
        pred, step, version), sent as JSON or, with ``binary``, as a
        ``.npy`` body."""
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
            return payload
        if status in (429, 503) and "retry_after_ms" in payload:
            raise ShedError(payload["retry_after_ms"], 0)
        raise RuntimeError(f"/infer returned {status}: {payload.get('error', payload)}")

    def infer(self, x: np.ndarray, binary: bool = False) -> np.ndarray:
        """Logits for ``x [n, ...sample]`` (:meth:`infer_reply`)."""
        return np.asarray(self.infer_reply(x, binary)["logits"], np.float32)

    def healthz(self) -> Tuple[int, dict]:
        return self.request("GET", "/healthz")

    def stats(self) -> dict:
        status, payload = self.request("GET", "/stats")
        if status != 200:
            raise RuntimeError(f"/stats returned {status}")
        return payload

    def metrics(self) -> str:
        """The ``/metrics`` Prometheus text."""
        status, data = self.request_raw("GET", "/metrics")
        if status != 200:
            raise RuntimeError(f"/metrics returned {status}")
        return data.decode()

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None


# ------------------------------------------------------------- HTTP front


class _Handler(DrainAwareHandler):
    client: ServeClient = None  # type: ignore[assignment]  # set by HttpFront

    def do_GET(self):
        client = self.client
        url = urllib.parse.urlparse(self.path)
        if self.path == "/healthz":
            fault = client.engine.fault
            alive = client.dispatcher_alive and fault is None
            err = client.dispatcher_error
            self._reply(200 if alive else 503, {
                "ok": alive,
                "draining": self.draining.is_set(),
                "buckets": list(client.engine.buckets),
                "queued_items": client.batcher.queued_items,
                "in_flight_batches": client._dispatcher.in_flight_count,
                "served_requests": client.access_log.served_requests,
                "dispatcher_heartbeat_age_s": round(
                    client.dispatcher_heartbeat_age_s, 3),
                "step": client.engine.step,
                "version": client.engine.version.label,
                "device": str(client.engine.device),
                **({"dispatcher_error": f"{type(err).__name__}: {err}"}
                   if err is not None else {}),
                **({"fanout_fault": f"{type(fault).__name__}: {fault}"}
                   if fault is not None else {}),
            })
        elif url.path == "/fanout" and isinstance(client.engine, FanoutEngine):
            query = urllib.parse.parse_qs(url.query)
            flag = lambda k: query.get(k, ["0"])[0] not in ("", "0")
            try:
                body = client.engine.report(digest=flag("digest"), shapes=flag("shapes"))
            except Exception as e:
                self._reply(503, {"error": f"{type(e).__name__}: {e}"})
                return
            self._reply(200, body)
        elif self.path == "/stats":
            self._reply(200, client.stats())
        elif self.path == "/metrics":
            # The process-wide registry's Prometheus text; the version
            # gauge is re-stamped so a swap since the last scrape shows.
            from dwt_tpu_torch.obs import prom

            client.refresh_version_metrics()
            self._reply_text(200, prom.render(), prom.CONTENT_TYPE)
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
        body = self.read_body()  # ALWAYS, even on error paths (keep-alive)
        if self.path not in ("/infer", "/v1/infer"):
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
            future = self.client.submit(x)
            logits = future.result(timeout=60.0)
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
            "version": getattr(future, "version", None),
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


def build_engine(args, plan=None) -> ServeEngine:
    """This rank's engine of ``--ckpt_dir`` (which wins) or
    ``--init_random`` under ``plan`` (:func:`build_plan`; default one
    process).  Every rank builds its own from the same source: the same
    checkpoint, or the same ``--seed``."""
    if not (args.ckpt_dir or args.init_random):
        raise SystemExit(
            "dwt_tpu_torch serve: pass --ckpt_dir (a training checkpoint "
            "directory) or --init_random for a fresh-init smoke server"
        )
    model, input_shape = build_model(args)
    kwargs = dict(buckets=[int(b) for b in args.buckets.split(",")],
                  device=args.device,
                  quantize=bool(getattr(args, "quantize_int8", False)), plan=plan)
    if args.ckpt_dir:
        return ServeEngine.from_checkpoint(args.ckpt_dir, model, input_shape,
                                           **kwargs)
    return ServeEngine(model, input_shape, **kwargs)


def build_plan(args, world_size: Optional[int] = None):
    """The run's sharding plan from ``--data_parallel``, ``--mesh_shape``
    and ``--sharding_rules`` (``parallel.plan_from_flags``: the JAX
    server's decisions and error texts), joining the process group first
    under ``--distributed``.  ``world_size`` stands in for the group's
    size without one (a plan that only describes the layout).  More than
    one rank with nothing to fan out, and int8 under a gspmd plan, are
    refused; a flag conflict raises ``SystemExit`` with JAX's text."""
    join_from_flags(args.distributed, args.device)
    try:
        plan = plan_from_flags(
            mesh_shape=args.mesh_shape, sharding_rules=args.sharding_rules,
            data_parallel=args.data_parallel, distributed=args.distributed,
            world_size=world_size, local_devices=0 if args.device == "cpu" else None)
    except ValueError as e:
        raise SystemExit(f"dwt_tpu_torch serve: {e}") from e
    world = process_count() if world_size is None else int(world_size)
    if plan.mode == "single" and world > 1:
        raise SystemExit(
            f"dwt_tpu_torch serve: {world} ranks and nothing to fan out over them: "
            "pass --data_parallel, or --mesh_shape with --sharding_rules")
    if plan.mode == "gspmd" and args.quantize_int8:
        raise SystemExit(
            "dwt_tpu_torch serve: --quantize_int8 under a gspmd plan is not ported "
            "(ROADMAP queue 1): the int8 weights' blocks would need placing under "
            "their dequant parametrization; serve int8 with --data_parallel")
    return plan


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
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 deployment format: per-tensor symmetric weight "
                        "quantization when each generation is built; the "
                        "forward dequantizes on the device.  Checkpoints on "
                        "disk stay f32, and every candidate still passes the "
                        "canary gate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--buckets", default="1,8,32,128",
                   help="comma-separated batch sizes warmed at start")
    p.add_argument("--max_batch_delay_ms", type=float, default=5.0,
                   help="longest a queued request waits for batch-mates")
    p.add_argument("--max_queue", type=int, default=1024,
                   help="queued samples past which requests are shed (429)")
    p.add_argument("--max_request_share", type=float, default=1.0,
                   help="batching fairness: a single request may occupy at "
                        "most this share of the largest bucket when sharing "
                        "a batch (1.0 = off)")
    # ---- continuous deployment (dwt_tpu_torch.fleet) ----
    p.add_argument("--watch", action="store_true",
                   help="hot reload: watch --ckpt_dir for new valid "
                        "checkpoints, canary-gate each candidate, and swap it "
                        "in atomically between dispatches (auto-rollback on "
                        "post-swap regression)")
    p.add_argument("--reload_poll_s", type=float, default=2.0,
                   help="checkpoint watch poll period (seconds)")
    p.add_argument("--canary_fixture", default=None,
                   help=".npz with arrays x [n,...sample] and optional y [n]: "
                        "the held-out batch every candidate must pass (finite "
                        "logits; with y, accuracy within --canary_max_regress "
                        "of the live version).  Default: a fixed noise batch "
                        "(finiteness gate only)")
    p.add_argument("--canary_batch", type=int, default=8,
                   help="noise-fixture batch size when no --canary_fixture "
                        "is given")
    p.add_argument("--canary_max_regress", type=float, default=5.0,
                   help="max fixture-accuracy regression (percentage points) "
                        "vs the live version before a candidate is refused")
    p.add_argument("--rollback_error_rate", type=float, default=0.1,
                   help="post-swap: error rate above this over the new "
                        "version's access window triggers auto-rollback")
    p.add_argument("--rollback_p99_factor", type=float, default=3.0,
                   help="post-swap: e2e p99 above this factor of the pre-swap "
                        "baseline triggers auto-rollback")
    p.add_argument("--rollback_min_requests", type=int, default=50,
                   help="post-swap verdict window: requests the new version "
                        "must serve before a latency verdict")
    p.add_argument("--rollback_decide_s", type=float, default=30.0,
                   help="post-swap grace period: with a thin window and no "
                        "error trip, hold the version after this long")
    p.add_argument("--rollback_rules", default=None,
                   help="SLO rules JSON replacing the two built-in post-swap "
                        "trip conditions (metrics: served, errors, "
                        "error_rate, e2e_ms_p50, e2e_ms_p99)")
    # ---- online domain adaptation (dwt_tpu_torch.serve.adapt) ----
    p.add_argument("--adapt_every", type=float, default=0.0,
                   help="online adaptation cadence (seconds): fold live "
                        "traffic's whitening/BN moments into a candidate "
                        "generation every N seconds, through the canary gate "
                        "and the post-swap monitor.  0 (default) disables it")
    p.add_argument("--no-adapt", "--no_adapt", action="store_true",
                   dest="no_adapt",
                   help="kill switch: never adapt, whatever --adapt_every says")
    p.add_argument("--adapt_min_samples", type=int, default=64,
                   help="minimum sanitized samples a window must hold before "
                        "it may fold")
    p.add_argument("--adapt_momentum", type=float, default=0.25,
                   help="EMA momentum folding the traffic window into the "
                        "live stats (clamped by --adapt_max_momentum)")
    p.add_argument("--adapt_max_momentum", type=float, default=0.5,
                   help="hard clamp on the fold momentum")
    p.add_argument("--adapt_batch", type=int, default=32,
                   help="collect-forward batch size (sanitized rows buffer "
                        "until a full batch)")
    p.add_argument("--adapt_max_abs", type=float, default=1e3,
                   help="sanitization amplitude band: a row with any |value| "
                        "beyond this never enters the accumulator")
    p.add_argument("--adapt_freeze_s", type=float, default=30.0,
                   help="adaptation freeze after a rolled-back adapted "
                        "generation; doubles per consecutive rollback")
    p.add_argument("--alert_rules", default=None,
                   help="SLO alert rules JSON evaluated against the live "
                        "registry; while any rule fires, adaptation freezes")
    p.add_argument("--access_log", default=None,
                   help="JSONL access-record file (schema: serve/metrics.py)")
    p.add_argument("--obs_trace", default=None,
                   help="span tracing: write a Chrome trace-event JSON of "
                        "the serving path's spans (admission → plan → "
                        "build_batch → stage → device → resolve, req_id-"
                        "correlated with access records) to this path at "
                        "drain; DWT_OBS_TRACE env is the flagless form")
    # ---- the fan-out over ranks (dwt_tpu_torch.serve.fanout) ----
    p.add_argument("--data_parallel", action="store_true",
                   help="shard every bucket over the ranks (replica fan-out: "
                        "every rank holds the weights whole and forwards its "
                        "block of the bucket)")
    p.add_argument("--mesh_shape", type=str, default=None,
                   help="sharding-rules mesh as 'dcn,data,model' sizes over "
                        "the ranks (see the trainer CLIs); buckets shard "
                        "over the data axes, weights per the rules table")
    p.add_argument("--sharding_rules", type=str, default="dp",
                   help="rules table preset ('dp'/'model'/'fsdp') or JSON "
                        "rules file driving weight placement for serving")
    p.add_argument("--distributed", action="store_true",
                   help="one process per device: join the process group from "
                        "the DWT_* (or torchrun) variables; rank 0 is the "
                        "front, the others follow it")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without CUDA) or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8978)
    return p


def load_canary_fixture(args, input_shape):
    """The held-out batch every candidate must pass: ``--canary_fixture``
    .npz (x + optional y) or a FIXED seeded-noise batch (finiteness gate
    only — noise labels would make the accuracy bar meaningless)."""
    if args.canary_fixture:
        data = np.load(args.canary_fixture)
        x = np.asarray(data["x"], np.float32)
        y = np.asarray(data["y"]) if "y" in data else None
        return x, y
    rng = np.random.default_rng(args.seed)
    x = rng.normal(
        size=(max(1, args.canary_batch),) + tuple(input_shape)
    ).astype(np.float32)
    return x, None


def build_deploy_controller(args, engine, access_log):
    """The shared canary-gate → swap → monitor pipeline both deploy
    producers (``--watch`` hot reload, ``--adapt_every`` online
    adaptation) submit through."""
    from dwt_tpu_torch.fleet import CanaryGate, DeployController, PostSwapMonitor

    rollback_rules = None
    if getattr(args, "rollback_rules", None):
        from dwt_tpu_torch.obs.rules import load_rules

        rollback_rules = load_rules(args.rollback_rules)
    x, y = load_canary_fixture(args, engine.input_shape)
    return DeployController(
        engine,
        access_log=access_log,
        canary=CanaryGate(engine, x, y, max_regress_pp=args.canary_max_regress),
        monitor=PostSwapMonitor(
            access_log,
            error_rate_threshold=args.rollback_error_rate,
            p99_factor=args.rollback_p99_factor,
            min_requests=args.rollback_min_requests,
            decide_after_s=args.rollback_decide_s,
            rules=rollback_rules,
        ),
    )


def build_reloader(args, engine, access_log, controller=None):
    """--watch wiring: checkpoint watcher over the shared deploy
    controller (pass ``controller=`` to share one with the adapter)."""
    from dwt_tpu_torch.fleet import HotReloader

    if controller is None:
        controller = build_deploy_controller(args, engine, access_log)
    return HotReloader(engine, args.ckpt_dir, access_log=access_log,
                       poll_s=args.reload_poll_s, controller=controller)


def adapt_enabled(args) -> bool:
    """Online adaptation runs only on an explicit cadence AND without
    the kill switch — the default is a bitwise-inert serving path."""
    return (getattr(args, "adapt_every", 0.0) or 0.0) > 0 \
        and not getattr(args, "no_adapt", False)


def build_adapter(args, engine, access_log, controller=None):
    """--adapt_every wiring: the online stat accumulator over the shared
    deploy controller, with the optional --alert_rules freeze feed."""
    from dwt_tpu_torch.serve.adapt import DomainAdapter

    if controller is None:
        controller = build_deploy_controller(args, engine, access_log)
    alert_engine = None
    if getattr(args, "alert_rules", None):
        from dwt_tpu_torch.obs.rules import AlertEngine, load_rules

        alert_engine = AlertEngine(load_rules(args.alert_rules))
    return DomainAdapter(
        engine, controller,
        access_log=access_log,
        adapt_every_s=args.adapt_every,
        min_samples=args.adapt_min_samples,
        momentum=args.adapt_momentum,
        max_momentum=args.adapt_max_momentum,
        collect_batch=args.adapt_batch,
        max_abs=args.adapt_max_abs,
        freeze_base_s=args.adapt_freeze_s,
        alert_engine=alert_engine,
    )


class ServeStack(NamedTuple):
    """One server process's parts, as :func:`build_stack` wires them.
    ``controller``, ``reloader`` and ``adapter`` are None when neither
    ``--watch`` nor adaptation asks for them; the reloader and the
    adapter are built but not started."""

    engine: ServeEngine
    access_log: AccessLog
    client: "ServeClient"
    controller: Any
    reloader: Any
    adapter: Any
    front: "HttpFront"


def build_stack(args, plan=None) -> ServeStack:
    """The server's wiring of ``args``: the engine, the ``--access_log``
    stream, the client with its batcher, one deploy controller shared by
    both producers (checkpoint reloads and adapted generations serialize
    through one canary baseline and one last-good rollback buffer), the
    reloader, the adapter attached to the client, and the HTTP front.
    ``plan`` is :func:`build_plan`'s (made here when None); across ranks
    this is the front's wiring, its engine the fan-out's, and the
    followers must be in ``fanout.follow``."""
    if args.watch and not args.ckpt_dir:
        raise SystemExit("dwt_tpu_torch serve: --watch requires --ckpt_dir")
    if plan is None:
        plan = build_plan(args)
    engine = build_engine(args, plan)
    if plan.mode != "single":
        engine = FanoutEngine(engine, host_group())
    access_log = AccessLog(args.access_log)
    client = ServeClient(
        engine,
        max_batch_delay_ms=args.max_batch_delay_ms,
        max_queue_items=args.max_queue,
        access_log=access_log,
        max_request_share=args.max_request_share,
    )
    controller = reloader = adapter = None
    if args.watch or adapt_enabled(args):
        controller = build_deploy_controller(args, engine, access_log)
    if args.watch:
        reloader = build_reloader(args, engine, access_log, controller=controller)
    if adapt_enabled(args):
        adapter = build_adapter(args, engine, access_log, controller=controller)
        client.attach_adapter(adapter)
    front = HttpFront(client, args.host, args.port)
    return ServeStack(engine, access_log, client, controller, reloader, adapter, front)


def follower_main(args, plan) -> int:
    """A follower rank: its engine, then the front's operations until the
    front stops it.  SIGTERM and SIGINT are logged and otherwise ignored:
    the front's drain stops every rank (module docstring)."""
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda signum, frame: log.info(
            "follower %d: signal %d; serving until the front stops", process_index(), signum))
    rc = follow(build_engine(args, plan), host_group())
    if rc == 0:
        shutdown_distributed()
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    plan = build_plan(args)
    if process_index() > 0:
        return follower_main(args, plan)
    obs.maybe_enable(args.obs_trace)
    engine, access_log, client, _, reloader, adapter, front = build_stack(args, plan)
    for producer in (reloader, adapter):
        if producer is not None:
            producer.start()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        # Flag-only handler; the main thread runs the drain.
        signal.signal(sig, lambda signum, frame: stop.set())
    print(json.dumps({
        "kind": "serve_ready", "host": args.host, "port": front.port,
        "buckets": list(engine.buckets), "device": str(engine.device),
        "step": engine.step, "source": engine.source,
        "version": engine.version.label,
        "watch": bool(args.watch), "adapt": adapter is not None,
        "quantize_int8": engine.quantize,
        "warmup_s": engine.warmup_s, "plan": plan.describe(),
    }), flush=True)
    # Idle on the signal; across ranks also on a lost rank, after which
    # /healthz answers 503 for FAULT_GRACE_S before the drain closes it.
    while not stop.wait(0.25):
        if engine.fault is not None:
            log.error("drain: the serving fan-out lost a rank (%s)", engine.fault)
            time.sleep(FAULT_GRACE_S)
            break
    log.info("drain: completing in-flight work")
    # Stop deploying before draining: a swap mid-drain would be harmless
    # (in-flight batches pin their snapshot) but would muddy the summary.
    if reloader is not None:
        reloader.stop()
    if adapter is not None:
        adapter.stop()
    front.close()
    print(json.dumps({"kind": "serve_summary", **client.stats()}), flush=True)
    access_log.close()
    obs.export()  # flush the serving trace inside the grace window
    if engine.fault is not None:
        return 1
    if plan.mode != "single":
        engine.close()  # the followers' stop
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
