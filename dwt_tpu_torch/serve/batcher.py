"""Admission queue + deadline micro-batching into fixed buckets.

A copy of ``dwt_tpu.serve.batcher`` (framework-free; the port imports
nothing of ``dwt_tpu``), its tracing spans included.  The serving engine
warms one forward per bucket shape (1/8/32/128 by default), so a
batch of any other size would pay first-call set-up on the hot path.
The batcher therefore turns an arbitrary request arrival process into a
stream of bucket-shaped batches:

* **coalescing**: queued requests concatenate into the largest fillable
  bucket; a batch dispatches the moment it can fill the largest bucket,
  or when the OLDEST queued request has waited ``max_batch_delay_ms``
  (the latency/throughput knob: 0 = dispatch immediately, large = better
  bucket fill under load);
* **pad-and-mask**: a partial batch pads to the smallest bucket that
  fits by repeating the last real row — the loader's eval-path padding
  convention (``batch_iterator(pad_and_mask=True)``) — with a boolean
  mask so returned counts/logits are exact;
* **bounded queue + load shedding**: past ``max_queue_items`` queued
  samples, :meth:`MicroBatcher.submit` raises :class:`ShedError` with a
  ``retry_after_ms`` estimate instead of queueing — under overload the
  queue (and every latency percentile behind it) must stay bounded, and
  the client is told when capacity is likely back rather than left to
  hammer.

The dispatch decision is a PURE function (:func:`plan_dispatch`) of the
queue state and the clock, so deadline/coalescing behavior is unit-tested
with a fake clock (the ``test_bench_contract`` ``_FakeClock`` pattern) —
no sleeps, no timing flake.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from dwt_tpu_torch import obs

DEFAULT_BUCKETS = (1, 8, 32, 128)

# Process-wide request ids: every admitted request gets one, stamped into
# its access records AND the serving spans (``req_id`` attr), so a trace
# timeline row and an access-log line join on it.  itertools.count.next
# is atomic under the GIL — no lock needed across batcher instances.
_REQ_IDS = itertools.count(1)


class ShedError(RuntimeError):
    """Admission rejected: queue past the high-water mark.

    ``retry_after_ms`` estimates when capacity is likely back (queue
    depth over the recent drain rate); front ends map this to HTTP 429 +
    ``Retry-After``.
    """

    def __init__(self, retry_after_ms: int, queued: int):
        super().__init__(
            f"serving queue full ({queued} samples queued); "
            f"retry after ~{retry_after_ms} ms"
        )
        self.retry_after_ms = int(retry_after_ms)
        self.queued = int(queued)


# The per-request result slot is the stdlib one-shot future — identical
# set_result/set_exception/result(timeout) semantics, no second
# synchronization implementation to maintain.
from concurrent.futures import Future, InvalidStateError  # noqa: E402


def resolve_future(fut: Future, *, result=None, exc=None) -> bool:
    """Resolve a request future, tolerating client-side ``cancel()``.

    ``set_result``/``set_exception`` raise ``InvalidStateError`` on a
    cancelled future — uncaught on the dispatcher thread, one impatient
    in-process caller's ``fut.cancel()`` would kill the dispatcher and
    with it the whole server.  Returns False when the future was already
    done (cancelled); the work is simply discarded.
    """
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
        return True
    except InvalidStateError:
        return False


@dataclass
class _Request:
    x: np.ndarray  # [n, ...sample shape]
    n: int
    enqueue_t: float
    req_id: int = 0
    future: Future = field(default_factory=Future)


@dataclass
class PlannedBatch:
    """One bucket-shaped dispatch: padded input + the requests riding it.

    Consumer contract: the padded tail rows of ``x`` (``mask`` False,
    rows ``real_n:``) are REPEATED DATA, not samples.  Anything that
    aggregates over the batch — returned logits, counts, and notably the
    online-adaptation moment accumulator (``adapt.DomainAdapter.offer``
    slices ``x[:real_n]``) — must honor the mask/``real_n`` split, or
    whatever request landed last in a bucket gets double-weighted."""

    bucket: int
    x: np.ndarray          # [bucket, ...] padded
    mask: np.ndarray       # [bucket] bool — True rows are real samples
    real_n: int
    requests: List[_Request]
    slices: List[Tuple[int, int]]  # per-request [start, stop) row ranges
    dispatch_t: float


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits ``n`` real samples."""
    if n < 1:
        raise ValueError(f"need at least one sample, got {n}")
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"{n} samples exceed the largest bucket {buckets[-1]}; "
        "split the request client-side"
    )


def pad_to_bucket(x: np.ndarray, bucket: int) -> np.ndarray:
    """Pad ``[n, ...]`` to ``[bucket, ...]`` by repeating the last real
    row — the loader's eval-path pad convention (padded rows are masked
    out of every returned quantity).  The ONE padding implementation for
    both the batched dispatch path and the engine's unbatched
    convenience path, so the two cannot drift."""
    n = x.shape[0]
    if n == bucket:
        return x
    return np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)])


def plan_dispatch(
    queued_ns: Sequence[int],
    buckets: Sequence[int],
    now: float,
    oldest_t: Optional[float],
    max_delay_s: float,
    max_share: float = 1.0,
) -> int:
    """How many queued requests to dispatch NOW (0 = keep waiting).

    Pure function of the queue state — the fake-clock-testable core.
    Requests dispatch strictly in arrival order (no reordering: a
    latecomer must not starve the request the deadline clock is running
    on).  Take the longest request prefix that fits the largest bucket;
    dispatch it when either

    * it FILLS the largest bucket (more waiting cannot improve fill), or
    * the next queued request no longer fits on top of it (the prefix is
      as full as order-preserving coalescing can make it), or
    * the oldest request has waited ``max_delay_s``.

    Otherwise return 0 and let the caller sleep until the deadline.

    **Fairness cap** (``max_share`` < 1): a single request may occupy at
    most ``max_share`` of the largest bucket when sharing a batch.  A
    request past the cap is a SOLO rider — it dispatches alone in its
    own smallest-fitting bucket and never coalesces with neighbors, so
    one giant request can no longer drag small requests into (or make
    them wait behind) a largest-bucket dispatch whose device time blows
    their deadline: the smalls ride their own small, fast bucket in the
    immediately following plan.  ``max_share=1`` is bitwise the legacy
    rule (the cap equals the largest bucket, which admission already
    enforces per request).
    """
    if not queued_ns:
        return 0
    largest = buckets[-1]
    cap = largest if max_share >= 1.0 else max(1, int(largest * max_share))
    if queued_ns[0] > largest:
        # Admission should have rejected it; dispatching nothing forever
        # would wedge the queue, so fail loudly.
        raise ValueError(
            f"queued request of {queued_ns[0]} samples exceeds the "
            f"largest bucket {largest}"
        )
    if queued_ns[0] > cap:
        # Solo giant at the head: nothing may ride with it.  Dispatch it
        # NOW when anyone is waiting behind it (they must not queue
        # through its deadline), when it fills the largest bucket, or at
        # its own deadline.
        if (len(queued_ns) > 1 or queued_ns[0] == largest
                or (oldest_t is not None
                    and now - oldest_t >= max_delay_s)):
            return 1
        return 0
    take, total = 0, 0
    for n in queued_ns:
        if n > cap or total + n > largest:
            # A solo giant mid-prefix ends the batch before it (the
            # smalls ahead dispatch now via the take < len rule below).
            break
        take += 1
        total += n
    if total == largest or take < len(queued_ns):
        return take
    if oldest_t is not None and now - oldest_t >= max_delay_s:
        return take
    return 0


class MicroBatcher:
    """Thread-safe admission queue with deadline coalescing.

    ``submit`` (any thread) enqueues and returns a :class:`Future`;
    ``next_batch`` (the dispatcher thread) blocks until
    :func:`plan_dispatch` says go, then returns a padded
    :class:`PlannedBatch`.  ``clock`` is injectable for tests.
    """

    def __init__(
        self,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        max_batch_delay_ms: float = 5.0,
        max_queue_items: int = 1024,
        clock: Callable[[], float] = time.monotonic,
        sample_shape: Optional[Tuple[int, ...]] = None,
        max_request_share: float = 1.0,
    ):
        if not 0.0 < max_request_share <= 1.0:
            raise ValueError(
                f"max_request_share must be in (0, 1], got "
                f"{max_request_share!r}"
            )
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(
                f"buckets must be distinct ascending sizes, got {buckets!r}"
            )
        self.buckets = tuple(int(b) for b in buckets)
        # When set, admission enforces it — requests with mismatched
        # sample dims must be rejected AT SUBMIT (a client error), not
        # discovered by np.concatenate inside the dispatcher where the
        # failure would take down every other rider of the batch.
        self.sample_shape = (
            tuple(int(d) for d in sample_shape)
            if sample_shape is not None else None
        )
        self.max_delay_s = float(max_batch_delay_ms) / 1e3
        self.max_queue_items = int(max_queue_items)
        self.max_request_share = float(max_request_share)
        self._clock = clock
        self._cond = threading.Condition()
        self._queue: List[_Request] = []
        self._queued_items = 0
        self._draining = False
        self._closed = False
        # Recent drain rate (imgs/s EWMA, dispatcher-updated) sizes the
        # retry-after estimate; None until the first batch completes.
        self._rate: Optional[float] = None

    # ------------------------------------------------------------ admission

    @property
    def clock(self) -> Callable[[], float]:
        """The batcher's timebase — dispatch/queue timestamps must come
        off the SAME (possibly fake) clock as the enqueue stamps."""
        return self._clock

    @property
    def queued_items(self) -> int:
        with self._cond:
            return self._queued_items

    @property
    def stopping(self) -> bool:
        """Draining or closed: ``next_batch`` returning None is final
        (the queue is empty and admission never reopens), as opposed to
        a mere poll timeout.  The dispatcher's heartbeat loop keys its
        exit on this."""
        with self._cond:
            return self._draining or self._closed

    def _retry_after_ms(self) -> int:
        if self._draining:
            # Drain is permanent for THIS process: a queue-depth estimate
            # (0 once flushed -> "retry in 1 ms") would spin a well-behaved
            # client against admission that never reopens.  By 1 s the
            # process is typically gone and the client fails over.
            return 1000
        if self._rate and self._rate > 0:
            est = 1e3 * self._queued_items / self._rate
        else:
            est = 2e3 * self.max_delay_s
        # Never advise an instant retry: the queue that shed this request
        # is still full right now.
        return max(1, int(est))

    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one request (``x``: ``[n, ...sample]``); returns its
        :class:`Future`.  Raises :class:`ShedError` past the high-water
        mark or while draining, ``ValueError`` for unbucketable sizes."""
        x = np.asarray(x)
        if x.ndim < 2 or x.shape[0] < 1:
            raise ValueError(
                f"request must be [n>=1, ...sample dims]; got shape {x.shape}"
            )
        if (self.sample_shape is not None
                and tuple(x.shape[1:]) != self.sample_shape):
            raise ValueError(
                f"request sample shape {tuple(x.shape[1:])} does not match "
                f"the served model's input shape {self.sample_shape}"
            )
        n = int(x.shape[0])
        if n > self.buckets[-1]:
            raise ValueError(
                f"request of {n} samples exceeds the largest bucket "
                f"{self.buckets[-1]}; split it client-side"
            )
        # The admission span covers validation + the queue insert; its
        # req_id attr is the join key against this request's access
        # records (and the shed path's, via the raised ShedError).
        with obs.span("admission", "serve") as sp:
            with self._cond:
                if self._closed:
                    raise RuntimeError("batcher is closed")
                if (self._draining
                        or self._queued_items + n > self.max_queue_items):
                    raise ShedError(self._retry_after_ms(), self._queued_items)
                req = _Request(
                    x=x, n=n, enqueue_t=self._clock(), req_id=next(_REQ_IDS)
                )
                self._queue.append(req)
                self._queued_items += n
                self._cond.notify_all()
            sp.add(req_id=req.req_id, n=n)
            return req.future

    # ------------------------------------------------------------- dispatch

    def note_served(self, n_imgs: int, seconds: float) -> None:
        """Dispatcher feedback: fold one completed batch into the drain
        rate EWMA behind retry-after estimates."""
        if seconds <= 0:
            return
        rate = n_imgs / seconds
        with self._cond:
            self._rate = (
                rate if self._rate is None else 0.8 * self._rate + 0.2 * rate
            )

    def _plan_locked(self) -> int:
        return plan_dispatch(
            [r.n for r in self._queue],
            self.buckets,
            self._clock(),
            self._queue[0].enqueue_t if self._queue else None,
            # Drain mode: no deadline games — a zero deadline flushes the
            # order-preserving prefix immediately (same rule, same code).
            0.0 if self._draining else self.max_delay_s,
            self.max_request_share,
        )

    def _pop_locked(self, take: int) -> List[_Request]:
        reqs, self._queue = self._queue[:take], self._queue[take:]
        self._queued_items -= sum(r.n for r in reqs)
        return reqs

    def _build_batch(self, reqs: List[_Request]) -> PlannedBatch:
        # Runs WITHOUT the condition lock: the concatenate+pad is the
        # batch-sized copy (tens of MB at large buckets) and holding the
        # lock through it would stall every concurrent submit().
        with obs.span("build_batch", "serve") as sp:
            real_n = sum(r.n for r in reqs)
            bucket = bucket_for(real_n, self.buckets)
            x = pad_to_bucket(np.concatenate([r.x for r in reqs]), bucket)
            mask = np.zeros(bucket, bool)
            mask[:real_n] = True
            slices, start = [], 0
            for r in reqs:
                slices.append((start, start + r.n))
                start += r.n
            sp.add(bucket=bucket, n=real_n)
            return PlannedBatch(
                bucket=bucket, x=x, mask=mask, real_n=real_n,
                requests=reqs, slices=slices, dispatch_t=self._clock(),
            )

    def next_batch(self, timeout: Optional[float] = None) -> Optional[PlannedBatch]:
        """Block until a batch is ready (or ``timeout``); ``None`` when
        the batcher is closed and fully drained (dispatcher exits) or the
        timeout expires with nothing dispatchable."""
        deadline = None if timeout is None else self._clock() + timeout
        reqs = self._next_reqs(deadline)
        return self._build_batch(reqs) if reqs is not None else None

    def _next_reqs(self, deadline: Optional[float]) -> Optional[List[_Request]]:
        with self._cond:
            while True:
                if self._queue:
                    t_plan = time.perf_counter()
                    take = self._plan_locked()
                    if take:
                        # Only dispatching plans are recorded — the
                        # keep-waiting wakes would flood the ring with
                        # sub-µs spans under sustained load.
                        obs.record_complete(
                            "plan", "serve",
                            time.perf_counter() - t_plan, take=take,
                        )
                        return self._pop_locked(take)
                elif self._closed or self._draining:
                    return None
                # Sleep until the oldest request's deadline (it is the
                # next moment the plan can change without a new arrival),
                # a notify, or the caller's timeout.
                waits = []
                if self._queue:
                    waits.append(
                        self._queue[0].enqueue_t + self.max_delay_s
                        - self._clock()
                    )
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return None
                    waits.append(remaining)
                self._cond.wait(
                    timeout=max(1e-4, min(waits)) if waits else None
                )

    # ---------------------------------------------------------------- drain

    def drain(self) -> None:
        """Stop admitting (new submits shed with retry-after); queued
        requests keep dispatching immediately until empty.  The graceful-
        SIGTERM half-close."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    def close(self) -> None:
        """Final close: drain semantics plus ``next_batch`` returning
        None once the queue empties; subsequent submits raise."""
        with self._cond:
            self._draining = True
            self._closed = True
            self._cond.notify_all()

    def fail_pending(self, exc: BaseException) -> int:
        """Abort path: clear the queue and fail every pending future with
        ``exc``.  Queue bookkeeping stays inside the batcher — callers
        must not mutate ``_queue``/``_queued_items`` from outside its
        lock.  Returns the number of requests failed."""
        with self._cond:
            pending, self._queue = self._queue, []
            self._queued_items = 0
        for req in pending:
            resolve_future(req.future, exc=exc)
        return len(pending)
