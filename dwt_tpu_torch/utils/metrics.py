"""Structured metric logging — the port of ``dwt_tpu.utils.metrics``.

Emits both a human-readable line (same quantities the reference prints —
cls/entropy/MEC losses and test accuracy, ``usps_mnist.py:305-308,323-325``)
and a machine-parseable JSON record, to stdout and optionally a JSONL file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import time
from typing import IO, Callable, Iterable, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (inclusive), dependency-free.

    The ONE percentile definition every latency report in this repo uses
    — serving access records, consensus decide latencies, eval dispatch
    intervals, the serve bench — so a p99 printed by one tool is
    comparable to a p99 printed by another.  Nearest-rank (not
    interpolated): an actually-observed sample, which is what a latency
    SLO talks about.  ``values`` need not be sorted; raises on empty
    input (an absent percentile must not silently read as 0 ms).
    """
    vals = sorted(float(v) for v in values)
    return _nearest_rank(vals, q)


def _nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    if not sorted_vals:
        raise ValueError("percentile of empty sequence")
    if q == 0.0:
        return sorted_vals[0]
    # Nearest-rank: ceil(q/100 * N), 1-indexed.  The epsilon absorbs float
    # dust like 0.29*100 -> 28.999... so exact-boundary ranks stay exact.
    rank = math.ceil(q * len(sorted_vals) / 100.0 - 1e-9)
    rank = max(1, min(len(sorted_vals), rank))
    return sorted_vals[rank - 1]


def percentile_summary(
    values: Iterable[float],
    qs: Sequence[float] = (50.0, 95.0, 99.0),
    prefix: str = "p",
    round_to: int = 3,
) -> dict:
    """``{"p50": ..., "p95": ..., "p99": ...}`` over ``values``.

    Empty input returns ``{}`` — callers emit no percentile fields rather
    than fabricated zeros.  Keys drop a trailing ``.0`` (``p99`` not
    ``p99.0``); non-integral quantiles keep their decimals (``p99.9``).
    """
    vals = sorted(float(v) for v in values)  # ONE sort for all quantiles
    if not vals:
        return {}
    out = {}
    for q in qs:
        name = f"{prefix}{int(q)}" if float(q).is_integer() else f"{prefix}{q}"
        out[name] = round(_nearest_rank(vals, q), round_to)
    return out


class MetricLogger:
    """Structured record sink: stdout line + optional JSONL file.

    JSONL writes are BUFFERED (``flush_every_n`` records or
    ``flush_interval_s`` seconds, whichever first): a ``flush()`` +
    implicit disk round-trip per record was a measurable hot-path tax at
    ``--log_interval 1`` cadences.  Durability semantics are preserved
    where they matter: ``sync=True`` records (crash/preempt/rollback
    narration) flush AND fsync immediately, and ``close()`` flushes —
    only an abnormal hard kill (SIGKILL, watchdog ``os._exit``) can lose
    the trailing unsynced records, which is exactly the window the
    ``sync=True`` kinds exist to cover.
    """

    def __init__(self, jsonl_path: Optional[str] = None, stream: IO = sys.stdout,
                 flush_every_n: int = 20, flush_interval_s: float = 2.0):
        self.stream = stream
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()
        self._flush_every_n = max(1, int(flush_every_n))
        self._flush_interval_s = float(flush_interval_s)
        self._unflushed = 0
        self._last_flush = time.monotonic()

    def _flush_file(self, sync: bool = False) -> None:
        self._file.flush()
        if sync:
            os.fsync(self._file.fileno())
        self._unflushed = 0
        self._last_flush = time.monotonic()

    def log(self, kind: str, step: int, sync: bool = False,
            flush: bool = False, **values: float) -> None:
        """Emit one record.  ``sync=True`` flushes and fsyncs the JSONL
        file: records that narrate a crash/preemption/rollback (the
        resilience layer's ``preempt``/``divergence``/``rollback`` kinds)
        must survive the process dying immediately after — an OS-buffered
        line would vanish with exactly the evidence a post-mortem needs.
        ``flush=True`` flushes without the fsync — for liveness records
        (heartbeats) that must be READABLE immediately (a hang means no
        later log() ever runs the cadence flush) but need not survive an
        OS crash."""
        record = {
            "kind": kind,
            "step": int(step),
            "elapsed_s": round(time.time() - self._t0, 3),
            # bool is an int subclass (and has __float__) — keep verdict
            # flags as true/false in the JSON, not 0.0/1.0.
            **{k: (v if isinstance(v, bool)
                   else float(v) if hasattr(v, "__float__") else v)
               for k, v in values.items()},
        }
        pretty = " ".join(
            f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in record.items()
            if k not in ("kind",)
        )
        print(f"[{kind}] {pretty}", file=self.stream, flush=True)
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._unflushed += 1
            if sync:
                self._flush_file(sync=True)
            elif (
                flush
                or self._unflushed >= self._flush_every_n
                or time.monotonic() - self._last_flush >= self._flush_interval_s
            ):
                self._flush_file()

    @contextlib.contextmanager
    def timed(self, kind: str, step: int, **values):
        """Log one record with the block's wall time as ``seconds``.

        The observability seam for whole phases (stat-collection passes,
        anything without a natural per-item record): callers that need a
        rate pair the emitted ``seconds`` with a count field (e.g.
        ``imgs=...``).  The record is emitted on exit even when the block
        raises — stamped ``error: true`` then, so post-mortem records are
        distinguishable from a phase that merely finished slow.
        """
        t0 = time.perf_counter()
        try:
            yield
        except BaseException:
            self.log(
                kind, step,
                seconds=round(time.perf_counter() - t0, 3),
                error=True,
                **values,
            )
            raise
        else:
            self.log(
                kind, step,
                seconds=round(time.perf_counter() - t0, 3),
                **values,
            )

    def flush(self) -> None:
        if self._file:
            self._flush_file()

    def close(self) -> None:
        if self._file:
            self._flush_file()
            self._file.close()


def device_memory_stats() -> Optional[dict]:
    """The current CUDA device's allocator stats (bytes in use / peak /
    reserved, from ``torch.cuda.memory_stats``), or None on the CPU or
    without CUDA.  Never raises — callers are /stats handlers and
    heartbeat records, which must answer whatever the backend's mood.
    The keys are the JAX function's where the allocator has them:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``num_allocs``."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    keys = {
        "bytes_in_use": "allocated_bytes.all.current",
        "peak_bytes_in_use": "allocated_bytes.all.peak",
        "bytes_reserved": "reserved_bytes.all.current",
        "num_allocs": "allocation.all.allocated",
    }
    return {k: int(stats[v]) for k, v in keys.items() if v in stats}


def host_rss_mb() -> float:
    """Current resident set size in MB (``/proc/self/statm``; falls back
    to the peak-RSS rusage counter where /proc is unavailable)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        import resource

        # ru_maxrss is KiB on Linux (bytes on macOS); either way this is
        # the PEAK, good enough for a fallback signal.
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3


class HeartbeatEmitter:
    """Periodic cheap liveness record for the training loops.

    Every ``every`` steps emits a ``heartbeat`` record with a steps/s
    EWMA, the host RSS, and the async-checkpoint in-flight depth — the
    always-on signal an operator reads.  ``every <= 0`` disables; the per-step
    cost is then one int compare.
    """

    def __init__(self, logger: "MetricLogger", every: int,
                 in_flight_fn: Optional[Callable[[], int]] = None):
        self.every = int(every or 0)
        self._logger = logger
        self._in_flight = in_flight_fn
        self._last_step: Optional[int] = None
        self._last_t = 0.0
        self._rate: Optional[float] = None
        # Live metrics plane: the heartbeat is the train loop's gauge
        # feed (steps/s, host RSS, ckpt depth, device memory) — already
        # host-side numbers, so feeding the registry adds no syncs.
        from dwt_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._reg = reg
        self._g_rate = reg.gauge(
            "dwt_train_steps_per_s", "train steps/s EWMA (heartbeat)"
        )
        self._g_rss = reg.gauge(
            "dwt_host_rss_mb", "host resident set size (MB)"
        )
        self._g_ckpt = reg.gauge(
            "dwt_ckpt_in_flight", "async checkpoint saves in flight"
        )
        self._g_devmem = reg.gauge(
            "dwt_device_memory_bytes",
            "device 0 allocator stats where the backend reports them",
            labelnames=("stat",),
        )

    def step(self, gstep: int) -> None:
        if self.every <= 0:
            return
        if self._last_step is None:
            self._last_step, self._last_t = gstep, time.monotonic()
            return
        if gstep - self._last_step < self.every:
            return
        now = time.monotonic()
        rate = (gstep - self._last_step) / max(now - self._last_t, 1e-9)
        # EWMA over emission windows: smooth enough to read, fresh
        # enough that a slowdown shows within a couple of heartbeats.
        self._rate = rate if self._rate is None else (
            0.7 * self._rate + 0.3 * rate
        )
        self._last_step, self._last_t = gstep, now
        rss = host_rss_mb()
        values = {
            "steps_per_s": round(self._rate, 3),
            "rss_mb": round(rss, 1),
        }
        self._g_rate.set(self._rate)
        self._g_rss.set(rss)
        if self._in_flight is not None:
            depth = int(self._in_flight())
            values["ckpt_in_flight"] = depth
            self._g_ckpt.set(depth)
        # Device memory (CUDA allocator stats; absent on the CPU): growth
        # during training shows in both the JSONL heartbeat and the
        # scrape.
        mem = device_memory_stats()
        if mem:
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"):
                if key in mem:
                    values[f"device_{key}"] = mem[key]
            for key, v in mem.items():
                self._g_devmem.labels(stat=key).set(v)
        # Checkpoint-footprint feeds: cumulative bytes written
        # by the save paths (by-mode counter summed) and the live on-disk
        # size of --ckpt_dir (the _CkptPipeline's callback gauge — the
        # read here invokes it, one directory walk per heartbeat).  Both
        # absent when no checkpointing has happened in this process.
        written = self._reg.samples("dwt_ckpt_bytes_written_total")
        if written:
            values["ckpt_bytes_written"] = int(sum(v for _, v in written))
        dir_bytes = self._reg.value("dwt_ckpt_dir_bytes")
        if dir_bytes:
            values["ckpt_dir_bytes"] = int(dir_bytes)
        # Metric-harvest feeds: ring occupancy + drain
        # staleness, host-side integers the harvester's drain site
        # already set — zero new syncs.  Absent when the run has no
        # harvester (e.g. serving processes).
        for name, key in (
            ("dwt_harvest_ring_depth", "harvest_ring_depth"),
            ("dwt_harvest_lag_steps", "harvest_lag_steps"),
        ):
            v = self._reg.value(name)
            if v is not None:
                values[key] = int(v)
        # flush (no fsync): the heartbeat is the liveness signal an
        # operator greps DURING a hang — buffered, the newest one would
        # sit in userspace through exactly that window (no later log()
        # runs the cadence flush, and a watchdog os._exit skips close()).
        self._logger.log("heartbeat", gstep, flush=True, **values)
