"""Per-request serving metrics: JSONL access records + latency summary.

The port of ``dwt_tpu.serve.metrics``, line for line.

Every served (or shed) request produces ONE access record — the serving
twin of the training loops' metric stream.  Records are machine-parseable
JSON lines so the same tooling that reads training JSONL reads access
logs, and the aggregate view (p50/p95/p99 latency, imgs/s, shed rate)
is computed with the shared nearest-rank percentile helper in
``dwt_tpu_torch.utils.metrics`` — one percentile definition across training,
eval, consensus, and serving reports.

Access-record schema (all times milliseconds)::

    {"kind": "access", "status": "ok" | "shed" | "error",
     "bucket": 8,          # compiled bucket the batch dispatched into
     "batch_n": 8,         # padded batch size (== bucket)
     "real_n": 5,          # un-padded samples in the batch
     "n": 1,               # samples in THIS request
     "queue_ms": 1.9,      # enqueue -> dispatch (admission + coalescing)
     "device_ms": 3.1,     # H2D-staged dispatch -> logits fetched
     "e2e_ms": 5.4,        # enqueue -> response ready
     "version": "800-3f2a91bc",  # checkpoint step + short params digest
     "batch_seq": 17,      # dispatcher batch counter (batch identity)
     "retry_after_ms": 50} # shed responses only

``queue_ms``/``device_ms`` are batch-level quantities stamped onto every
request that rode the batch; ``e2e_ms`` is per-request.  ``version`` and
``batch_seq`` are the continuous-deployment fleet's audit trail: every
record of one ``batch_seq`` must carry the SAME version (no
mixed-version batch — asserted by tests), and per-version latency/error
windows are what the canary's post-swap rollback reads.

Fleet lifecycle events (``AccessLog.event``) ride the same JSONL stream
with their own ``kind`` (``reload``/``canary``/``swap``/``rollback`` for
the checkpoint deploy path; ``adapt_build``/``adapt_canary``/
``adapt_swap``/``adapt_rollback`` for online-adaptation generations) so
one file tells the whole watch → canary → swap → rollback story —
whichever producer drove the deploy.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from typing import IO, Optional

from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.utils.metrics import percentile_summary

log = logging.getLogger(__name__)

# Aggregation window: enough for a long sustained-load run's tail to be
# measured honestly without unbounded memory on a server that stays up
# for days.
_WINDOW = 100_000

# Per-version latency windows are smaller (rollback verdicts read recent
# behavior, not history) and the version map itself is bounded: a server
# that hot-swaps for days must not grow a dict per superseded version.
_VERSION_WINDOW = 10_000
_MAX_VERSIONS = 8


class _VersionStats:
    """Per-served-version aggregates: the post-swap rollback signal."""

    __slots__ = ("served", "errors", "e2e_ms")

    def __init__(self):
        self.served = 0
        self.errors = 0
        self.e2e_ms = collections.deque(maxlen=_VERSION_WINDOW)


class AccessLog:
    """Thread-safe access-record sink: optional JSONL file + aggregates.

    The dispatcher and front-end threads both write here; a lock (not a
    queue) suffices because records are tiny and the file write is the
    only I/O.  ``jsonl_path=None`` keeps aggregation only (the in-process
    client and the bench use the aggregates; the CLI server also writes
    the file).
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 stream: Optional[IO] = None):
        self._lock = threading.Lock()
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._stream = stream
        self._t0 = time.perf_counter()
        self.served_requests = 0
        self.served_imgs = 0
        self.shed_requests = 0
        self.error_requests = 0
        self._e2e_ms = collections.deque(maxlen=_WINDOW)
        self._queue_ms = collections.deque(maxlen=_WINDOW)
        self._device_ms = collections.deque(maxlen=_WINDOW)
        # Resolution stamps (seconds since construction, perf_counter
        # clock), parallel to _e2e_ms: the serve bench slices latency
        # windows around swap times with these — swap-window p99 vs
        # steady-state needs to know WHEN each sample resolved.
        self._resolved_t = collections.deque(maxlen=_WINDOW)
        # Per-version windows, insertion-ordered so the oldest version
        # falls off once the map is full.
        self._versions: "collections.OrderedDict[str, _VersionStats]" = \
            collections.OrderedDict()
        self._write_failed = False  # warn once, not per record
        # Disk-full drops were warn-once and then INVISIBLE: count every
        # lost record so summary()/ /stats / /metrics keep reporting the
        # hole long after the one log line scrolled away.
        self.lost_records = 0
        # Live metrics plane: request counters + per-bucket latency
        # histograms on the process-wide registry (get-or-create is
        # idempotent, so many AccessLog instances share the families;
        # children are cached per instance — the record() hot path pays
        # one dict lookup + a locked add per sample).
        reg = get_registry()
        self._m_requests = reg.counter(
            "dwt_serve_requests_total", "serving requests by outcome",
            labelnames=("status",),
        )
        self._m_imgs = reg.counter(
            "dwt_serve_imgs_total", "samples served (ok requests)"
        )
        self._m_lost = reg.counter(
            "dwt_serve_lost_log_records_total",
            "access-log records dropped by failed writes (disk full)",
        )
        self._m_lat = {
            phase: reg.histogram(
                f"dwt_serve_{phase}_ms",
                f"per-request {phase} latency by compiled bucket (ms)",
                labelnames=("bucket",),
            )
            for phase in ("e2e", "queue", "device")
        }
        self._m_req_children = {
            s: self._m_requests.labels(status=s)
            for s in ("ok", "shed", "error")
        }

    def _version_stats_locked(self, version: str) -> _VersionStats:
        vs = self._versions.get(version)
        if vs is None:
            while len(self._versions) >= _MAX_VERSIONS:
                self._versions.popitem(last=False)
            vs = self._versions[version] = _VersionStats()
        return vs

    def record(self, status: str, n: int, **fields) -> None:
        rec = {"kind": "access", "status": status, "n": int(n), **{
            k: (round(float(v), 3) if isinstance(v, float) else v)
            for k, v in fields.items()
        }}
        version = fields.get("version")
        # Registry feed outside the lock: the counters/histograms carry
        # their own per-child locks, and nothing here reads AccessLog
        # state.
        child = self._m_req_children.get(status)
        (child if child is not None
         else self._m_requests.labels(status=status)).inc()
        if status == "ok":
            self._m_imgs.inc(int(n))
            bucket = str(fields.get("bucket", ""))
            for phase in ("e2e", "queue", "device"):
                v = fields.get(f"{phase}_ms")
                if v is not None:
                    self._m_lat[phase].labels(bucket=bucket).observe(
                        float(v)
                    )
        with self._lock:
            if status == "ok":
                self.served_requests += 1
                self.served_imgs += int(n)
                if "e2e_ms" in fields:
                    self._e2e_ms.append(float(fields["e2e_ms"]))
                    self._resolved_t.append(
                        time.perf_counter() - self._t0
                    )
                if "queue_ms" in fields:
                    self._queue_ms.append(float(fields["queue_ms"]))
                if "device_ms" in fields:
                    self._device_ms.append(float(fields["device_ms"]))
                if version is not None:
                    vs = self._version_stats_locked(str(version))
                    vs.served += 1
                    if "e2e_ms" in fields:
                        vs.e2e_ms.append(float(fields["e2e_ms"]))
            elif status == "shed":
                self.shed_requests += 1
            else:
                self.error_requests += 1
                if version is not None:
                    self._version_stats_locked(str(version)).errors += 1
            self._write_locked(rec)

    def event(self, kind: str, **fields) -> None:
        """One fleet lifecycle record (``reload``/``canary``/``swap``/
        ``rollback``…) on the same JSONL stream as the access records —
        the audit trail a post-mortem reads alongside the per-version
        latency windows."""
        rec = {"kind": str(kind), **{
            k: (round(float(v), 3) if isinstance(v, float) else v)
            for k, v in fields.items()
        }}
        with self._lock:
            self._write_locked(rec)

    def _write_locked(self, rec: dict) -> None:
        # Logging is availability-decoupled: record() runs on the
        # dispatcher thread, and a full disk must degrade to lost
        # access records — not to a dead dispatcher that sheds all
        # traffic while inference itself is healthy.
        line = json.dumps(rec) + "\n"
        lost = False
        for sink in (self._file, self._stream):
            if sink is not None:
                try:
                    sink.write(line)
                except (OSError, ValueError) as e:
                    lost = True
                    if not self._write_failed:
                        self._write_failed = True
                        log.warning(
                            "access-log write failed (%s); further "
                            "records may be lost", e,
                        )
        if lost:
            # Warn once, COUNT always: the drop stays visible in
            # summary(), /stats, and the /metrics counter after the one
            # warning scrolled away.
            self.lost_records += 1
            self._m_lost.inc()

    def version_stats(self, version: str) -> dict:
        """Aggregates attributed to ONE served version: the post-swap
        window the canary's rollback verdict reads.  Empty dict when the
        version has served nothing yet."""
        with self._lock:
            vs = self._versions.get(str(version))
            if vs is None:
                return {}
            out = {
                "served": vs.served,
                "errors": vs.errors,
                "error_rate": round(
                    vs.errors / max(vs.served + vs.errors, 1), 4
                ),
            }
            window = list(vs.e2e_ms)
        out.update(percentile_summary(
            window, (50.0, 99.0), prefix="e2e_ms_p"
        ))
        return out

    def summary(self) -> dict:
        """Aggregate view over the run (latencies over the bounded
        window): the /stats response body and the drain-time footer."""
        # Snapshot under the lock, sort/aggregate OUTSIDE it: summary()
        # is a /stats poll, and the dispatcher's record() must not queue
        # behind O(window log window) percentile math on the hot path.
        with self._lock:
            seconds = time.perf_counter() - self._t0
            out = {
                "kind": "serve_summary",
                "served_requests": self.served_requests,
                "served_imgs": self.served_imgs,
                "shed_requests": self.shed_requests,
                "error_requests": self.error_requests,
                "seconds": round(seconds, 3),
                "imgs_per_s": round(
                    self.served_imgs / max(seconds, 1e-9), 1
                ),
                "lost_log_records": self.lost_records,
            }
            windows = [
                ("e2e_ms", list(self._e2e_ms)),
                ("queue_ms", list(self._queue_ms)),
                ("device_ms", list(self._device_ms)),
            ]
            version_windows = {
                v: (vs.served, vs.errors, list(vs.e2e_ms))
                for v, vs in self._versions.items()
            }
        for name, window in windows:
            out.update(percentile_summary(
                window, (50.0, 95.0, 99.0), prefix=f"{name}_p"
            ))
        if version_windows:
            out["versions"] = {
                v: {
                    "served": served,
                    "errors": errors,
                    "error_rate": round(
                        errors / max(served + errors, 1), 4
                    ),
                    **percentile_summary(
                        window, (50.0, 99.0), prefix="e2e_ms_p"
                    ),
                }
                for v, (served, errors, window) in version_windows.items()
            }
        return out

    def windows(self) -> dict:
        """Consistent snapshot of the latency windows plus the lifetime
        served-request count.  The serve bench takes one snapshot before
        and one after each offered-load run and keeps the last
        ``served_after - served_before`` samples of each window — correct
        even after the bounded deques wrap (an index diff would not be),
        so every sweep point reports only its OWN requests' tail.
        ``resolved_t`` (seconds since this log's construction, parallel
        to ``e2e_ms``) lets the bench slice swap windows out of a run."""
        with self._lock:
            return {
                "served_requests": self.served_requests,
                "e2e_ms": list(self._e2e_ms),
                "queue_ms": list(self._queue_ms),
                "device_ms": list(self._device_ms),
                "resolved_t": list(self._resolved_t),
            }

    @property
    def t0(self) -> float:
        """perf_counter origin of ``resolved_t`` stamps (the bench
        converts its swap times onto the same timebase)."""
        return self._t0

    def flush(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.flush()
                except OSError as e:
                    log.warning("access-log flush failed: %s", e)

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError as e:
                    log.warning("access-log close failed: %s", e)
                self._file = None
