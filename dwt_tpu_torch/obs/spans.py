"""Low-overhead span tracing: per-thread ring buffers, zero device syncs — ``dwt_tpu.obs.spans``, copied.

The port's copy keeps every name of the JAX module (the attribution
report, the flight recorder and the tests read them); it imports the
standard library only, so the torch-free fleet balancer can load it.

The repo can time whole phases (``MetricLogger.timed``, the serving
``AccessLog``) but not *where inside a step or request* the time went —
data wait vs H2D staging vs device dispatch vs host sync vs consensus vs
checkpoint snapshot.  This module is that layer: instrumented call sites
wrap their phase in ``obs.span("name")`` and a run started with
``--obs_trace`` (or ``DWT_OBS_TRACE``) collects fixed-size span records
into preallocated per-thread ring buffers, exported as Chrome
trace-event JSON (``obs.export``) and dumped by the flight recorder on
stalls/guard events (``obs.flight_dump``).

Design rules, load-bearing for the hot path:

* **zero device syncs** — a span NEVER synchronizes the card (no
  ``torch.cuda.synchronize``, no event or stream wait, no host read or
  copy of a device tensor).  Dispatch-side spans therefore
  measure *enqueue* time; device truth stays with ``torch.profiler``
  and CUDA events (``tools/torch_train_profile.py``, ``chip_smoke.py``).
  Asserted by counting shims on those calls and a source scan in
  ``tests/test_torch_obs.py``.
* **near-zero cost disabled** — the module-level :func:`span` reads one
  global; when tracing is off it returns a shared no-op context manager
  (sub-µs, no allocation beyond the call).  Helpers that would add a
  generator frame per item (:func:`traced_iter`) return their input
  UNCHANGED when disabled.
* **fixed-size records, bounded memory** — each thread owns a ring of
  rows mutated in place, starting small and growing geometrically on
  demand up to a fixed cap; a run that traces forever wraps instead of
  growing past it.  Threads that record a handful of spans (HTTP
  handler threads) never pay for a full ring, and once total retained
  rings exceed a pool cap, dead threads' rings are recycled instead of
  allocated — a traced server's per-request thread churn cannot grow
  memory without bound.  Ring writes are single-writer (the owning
  thread) and lock-free; drains from other threads (export, flight
  recorder) may read one torn in-flight row, which is acceptable for a
  diagnostic stream and irrelevant for a quiescent export.
"""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional

# Environment gates (read at configure time, not import time, except the
# auto-enable below): DWT_OBS_TRACE names the export path (or "1" for
# tracing without a default export target); DWT_OBS_BUFFER overrides the
# per-thread ring capacity.
ENV_TRACE = "DWT_OBS_TRACE"
ENV_BUFFER = "DWT_OBS_BUFFER"
DEFAULT_CAPACITY = 65536
# Rings start at this many rows and grow ×4 on demand up to the tracer
# capacity: a thread that records two spans (an HTTP handler) costs a
# few KB, not the full ring.
INIT_CAPACITY = 64
# Retained rings (live + dead threads') before dead rings are RECYCLED
# instead of allocated.  Below the cap every dead thread's spans stay
# exportable (eval-pass producers, the ckpt writer); past it — only
# reachable through per-request thread churn in a traced server — the
# oldest dead ring is reset for the new thread.
RING_POOL_MAX = 256

# Row layout (mutated in place; cursor advanced LAST so a concurrent
# drain sees either the old complete row or the new complete row in the
# common case): [t_start, dur_s, name, category, attrs-or-None].
_T0, _DUR, _NAME, _CAT, _ATTRS = range(5)


class _Ring:
    """One thread's span storage: grow-to-cap rows + wrap cursor."""

    __slots__ = ("rows", "cap", "max_cap", "i", "tid", "thread_name",
                 "owner")

    def __init__(self, cap: int, tid: int, thread_name: str,
                 owner: Optional["weakref.ref"] = None):
        self.max_cap = cap
        self.cap = min(cap, INIT_CAPACITY)
        self.rows = [[0.0, 0.0, "", "", None] for _ in range(self.cap)]
        self.i = 0  # total writes ever; row index is i % cap
        # (drop accounting is derived: Tracer.dropped_spans sums i - cap)
        self.tid = tid
        self.thread_name = thread_name
        self.owner = owner  # weakref to the owning thread (recycling)

    def write(self, t0: float, dur: float, name: str, cat: str,
              attrs: Optional[dict]) -> None:
        if self.i >= self.cap and self.cap < self.max_cap:
            # Grow instead of wrapping, ×4 up to max_cap.  Checked on
            # every write, so this is only reachable with i == cap
            # exactly: the rows are filled in order and the appended
            # block continues the sequence (i % new_cap == old cap).
            new_cap = min(self.cap * 4, self.max_cap)
            self.rows.extend(
                [0.0, 0.0, "", "", None]
                for _ in range(new_cap - self.cap)
            )
            self.cap = new_cap
        row = self.rows[self.i % self.cap]
        row[_T0] = t0
        row[_DUR] = dur
        row[_NAME] = name
        row[_CAT] = cat
        row[_ATTRS] = attrs
        self.i += 1  # cursor last (see module doc)

    def reset_for(self, t: threading.Thread) -> None:
        """Recycle this (dead thread's) ring for a new owner: the old
        rows become invisible (cursor 0) and are overwritten in place."""
        self.i = 0
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.owner = weakref.ref(t)

    def snapshot(self) -> List[list]:
        """Copy of the live rows, oldest first."""
        n = min(self.i, self.cap)
        start = self.i - n
        out = []
        for j in range(start, self.i):
            out.append(list(self.rows[j % self.cap]))
        return out


class _NullSpan:
    """The disabled path's shared context manager: every method no-ops."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: enter stamps the clock, exit writes the record."""

    __slots__ = ("_tracer", "name", "cat", "attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.attrs = attrs

    def add(self, **attrs) -> "_Span":
        """Attach attrs discovered mid-span (e.g. a request id assigned
        after admission)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tracer._ring().write(
            self._t0, t1 - self._t0, self.name, self.cat, self.attrs
        )
        return False


class Tracer:
    """Process-wide span collector (one per run; see module functions).

    ``run_id`` stamps every export so multi-host trace files merge into
    one timeline; set ``DWT_RUN_ID`` identically on every host (there is
    no collective here to agree one automatically).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 run_id: Optional[str] = None):
        self.capacity = max(int(capacity), 16)
        self.run_id = run_id or os.environ.get("DWT_RUN_ID") or (
            f"{int(time.time()):x}-{os.getpid()}"
        )
        # perf_counter is an arbitrary-epoch monotonic clock; anchor it
        # to the wall clock once so exported timestamps are absolute
        # enough for humans (and for merging multi-host files whose
        # perf_counter epochs differ).
        self.t0_perf = time.perf_counter()
        self.t0_unix = time.time()
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._rings_lock = threading.Lock()

    # ------------------------------------------------------------ recording

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            t = threading.current_thread()
            with self._rings_lock:
                ring = self._adopt_dead_ring_locked(t)
                if ring is None:
                    ring = _Ring(self.capacity, t.ident or 0, t.name,
                                 weakref.ref(t))
                    self._rings.append(ring)
            self._local.ring = ring
        return ring

    def _adopt_dead_ring_locked(self, t: threading.Thread) -> Optional[_Ring]:
        """Past RING_POOL_MAX retained rings, reuse a dead thread's ring
        instead of allocating — the bound that keeps a traced server's
        per-request handler-thread churn from growing memory forever.
        Recycling discards the dead thread's spans, which only happens
        once churn has already exceeded what one export can usefully
        attribute."""
        if len(self._rings) < RING_POOL_MAX:
            return None
        for ring in self._rings:
            owner = ring.owner() if ring.owner is not None else None
            if owner is None or not owner.is_alive():
                ring.reset_for(t)
                return ring
        return None

    def span(self, name: str, cat: str = "step",
             attrs: Optional[dict] = None) -> _Span:
        return _Span(self, name, cat, attrs)

    def record_complete(self, name: str, cat: str, dur_s: float,
                        attrs: Optional[dict] = None,
                        end: Optional[float] = None) -> None:
        """Book an already-measured duration as a span ending now (or at
        ``end``, a ``time.perf_counter`` stamp).  For phases measured on
        a different clock (e.g. the batcher's injectable clock) where
        only the duration is trustworthy."""
        t1 = time.perf_counter() if end is None else end
        self._ring().write(t1 - dur_s, dur_s, name, cat, attrs)

    # -------------------------------------------------------------- reading

    def snapshot(self, last_s: Optional[float] = None) -> List[dict]:
        """All buffered spans as dicts, sorted by start time.

        ``last_s`` keeps only spans that *ended* within the trailing
        window (the flight-recorder view).  Safe to call from any thread
        — including the watchdog's, while the main thread is wedged: the
        registry lock is only polled, never blocked on.
        """
        acquired = self._rings_lock.acquire(timeout=0.5)
        try:
            rings = list(self._rings)
        finally:
            if acquired:
                self._rings_lock.release()
        now = time.perf_counter()
        out = []
        for ring in rings:
            for row in ring.snapshot():
                t0, dur, name = row[_T0], row[_DUR], row[_NAME]
                if not name:
                    continue  # torn/unused row
                if last_s is not None and (t0 + dur) < now - last_s:
                    continue
                rec = {
                    "name": name,
                    "cat": row[_CAT],
                    "ts": t0,
                    "dur": dur,
                    "tid": ring.tid,
                    "thread": ring.thread_name,
                }
                if row[_ATTRS]:
                    rec["attrs"] = dict(row[_ATTRS])
                out.append(rec)
        out.sort(key=lambda r: r["ts"])
        return out

    def dropped_spans(self) -> int:
        acquired = self._rings_lock.acquire(timeout=0.5)
        try:
            rings = list(self._rings)
        finally:
            if acquired:
                self._rings_lock.release()
        return sum(max(r.i - r.cap, 0) for r in rings)


# --------------------------------------------------------- module-level API
#
# The gate every instrumented call site actually reads.  ``_TRACER is
# None`` IS the disabled fast path: one global load + compare.

_TRACER: Optional[Tracer] = None
_EXPORT_PATH: Optional[str] = None


def enabled() -> bool:
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def configure(path: Optional[str] = None,
              capacity: Optional[int] = None,
              run_id: Optional[str] = None) -> Tracer:
    """Enable tracing (idempotent: an already-enabled tracer is kept,
    only the export path may be filled in).  ``path`` is where
    :func:`export` writes the Chrome trace; None keeps tracing on with
    no default export target (flight recorder still works)."""
    global _TRACER, _EXPORT_PATH
    if _TRACER is None:
        cap = capacity or int(os.environ.get(ENV_BUFFER, DEFAULT_CAPACITY))
        _TRACER = Tracer(capacity=cap, run_id=run_id)
    if path:
        _EXPORT_PATH = path
    return _TRACER


def maybe_enable(path_flag: Optional[str] = None) -> bool:
    """The CLIs'/loops' one-call gate: enable when ``--obs_trace PATH``
    was passed or ``DWT_OBS_TRACE`` is set (value "1"/"true" enables
    without a default export path; anything else IS the path).
    Idempotent; returns :func:`enabled`."""
    if _TRACER is not None:
        if path_flag:
            configure(path=path_flag)
        return True
    if path_flag:
        configure(path=path_flag)
        return True
    env = os.environ.get(ENV_TRACE, "").strip()
    if env and env.lower() not in ("0", "false", "off"):
        configure(path=None if env.lower() in ("1", "true", "on") else env)
        return True
    return False


def disable() -> None:
    """Drop the tracer (tests; a fresh configure() starts clean)."""
    global _TRACER, _EXPORT_PATH
    _TRACER = None
    _EXPORT_PATH = None


def export_path() -> Optional[str]:
    return _EXPORT_PATH


def span(name: str, cat: str = "step", **attrs):
    """``with obs.span("batch_wait"): ...`` — the universal call site.

    Disabled: one global load + compare, then the shared no-op object.
    Python materializes kwargs either way, so keep attrs few (or absent)
    at per-step call sites.
    """
    t = _TRACER
    if t is None:
        return NULL_SPAN
    return t.span(name, cat, attrs or None)


def record_complete(name: str, cat: str, dur_s: float, **attrs) -> None:
    t = _TRACER
    if t is None:
        return
    t.record_complete(name, cat, dur_s, attrs or None)


def traced_iter(iterable: Iterable, name: str, cat: str = "step"):
    """Wrap an iterator so each ``next()`` wait becomes a span (the
    loops' "how long did I wait for the next prefetched batch" phase).
    Disabled: returns ``iterable`` UNCHANGED — zero added frames."""
    t = _TRACER
    if t is None:
        return iterable

    def gen():
        it = iter(iterable)
        while True:
            with t.span(name, cat, None):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item

    return gen()


def snapshot(last_s: Optional[float] = None) -> List[dict]:
    t = _TRACER
    return t.snapshot(last_s) if t is not None else []
