"""The data plane — ``StreamPos``, ``DataPlane`` and ``OrderedWorkerPool`` of ``dwt_tpu.data.pipeline``, copied.

* :class:`DataPlane` — one per-run authority over every stream's seed
  lineage and position.  Each stream's epoch order is a
  :class:`~dwt_tpu_torch.data.sampler.SeekableSampler` permutation (a
  pure function of ``(seed + seed_bump, epoch)``), each stream's position
  an ``(epoch, batch_cursor)`` pair that advances in lockstep with the
  optimizer step, and :meth:`DataPlane.snapshot` is the JSON
  ``DataState`` a checkpoint records.  :meth:`load_snapshot` and
  :meth:`seek_step` re-open every stream at an exact batch cursor, with
  the batch-id sequence an uninterrupted run would have seen (the
  per-item seed tokens ``(seed, epoch, index)`` make the transforms
  deterministic too).
* :class:`OrderedWorkerPool` — the decode/augment worker pool: a bounded
  in-flight window keyed by item position, results in submission order,
  and head-of-window stall detection (a dead or wedged worker is logged
  and its item re-submitted to a fresh thread, instead of silently
  wedging the epoch).

The pool feeds the JAX pool's instruments into the registry
(``dwt_data_pipeline_depth``, ``dwt_data_worker_busy``, the
``dwt_data_decode_ms`` histogram, ``dwt_data_stalls_total``,
``dwt_data_worker_respawns_total``) and opens its ``reassembly`` span over
a stall's wait; ``DWT_DATA_TRAIL=DIR`` appends one JSONL line per batch
per stream to ``DIR/<role>.jsonl`` (role, epoch, cursor, dataset ids), as
the JAX plane does.  ``shard=(index, count)`` is a data-parallel run's
per-process split, handed to every stream's ``batch_iterator``: each
stream's cursor then counts this process's batches, the same on every
rank, and a ``data_state`` snapshot is the same on every rank.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, wait
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

from dwt_tpu_torch import obs

log = logging.getLogger(__name__)

# DataState schema version: bump if the JSON shape or the sampler's
# position function (FEISTEL_ROUNDS, key derivation) ever changes — a
# mismatched version is refused instead of silently seeking into a
# different permutation.
DATA_STATE_VERSION = 1

# Batch-id trail hook (chaos/e2e proof): a directory to append one JSONL
# line per produced batch per stream.  Off (None/empty) in production.
TRAIL_ENV = "DWT_DATA_TRAIL"

# Default head-of-window stall budget: generous enough for a cold NFS
# read, small enough that a dead worker is found within a minute.
DEFAULT_STALL_TIMEOUT_S = 60.0


# ---------------------------------------------------------------- DataState


@dataclass
class StreamPos:
    """One stream's seed lineage and position (the per-stream DataState)."""

    seed: int            # base shuffle seed (rollback bump recorded apart)
    epoch_len: int       # batches per epoch (fixed: quarantine substitutes)
    epoch: int = 0
    cursor: int = 0      # batches already consumed within ``epoch``
    quarantine_subs: int = 0  # quarantine substitutions since run start
    alias_of: Optional[str] = None  # e.g. target_aug rides target's iterator

    def advance(self, n: int) -> None:
        self.cursor += int(n)
        while self.epoch_len > 0 and self.cursor >= self.epoch_len:
            self.cursor -= self.epoch_len
            self.epoch += 1

    def seek_step(self, consumed: int) -> None:
        """Position after ``consumed`` total batches from (0, 0) — exact
        because epoch lengths are fixed."""
        consumed = max(0, int(consumed))
        if self.epoch_len > 0:
            self.epoch, self.cursor = divmod(consumed, self.epoch_len)
        else:
            self.epoch, self.cursor = 0, 0


class DataPlane:
    """Per-run stream-state authority (module doc).

    ``register`` each stream role once, ``advance`` at every step
    boundary (every stream gives one batch per optimizer step), and
    ``load_snapshot``/``seek_step`` before re-opening streams.  Iterators
    come from :meth:`epoch_iterator` (one epoch; digits) or
    :meth:`stream` (endless, epochs rolling over; OfficeHome) and start
    at the plane's current position for their role.
    """

    def __init__(self, *, num_workers: int = 0, seed_bump: int = 0,
                 quarantine_registry=None,
                 stall_timeout: float = DEFAULT_STALL_TIMEOUT_S,
                 shard: Optional[Tuple[int, int]] = None):
        self.streams: Dict[str, StreamPos] = {}
        self.shard = shard
        self.num_workers = int(num_workers)
        # The loader pools' head-of-window stall budget (--data_stall_timeout;
        # 0 disables the detection).
        self.stall_timeout = float(stall_timeout)
        self.seed_bump = int(seed_bump)
        # A loader.QuarantineRegistry, keyed by stream role; None keeps
        # quarantine in memory for the run.
        self.quarantine_registry = quarantine_registry
        self._trail_dir = os.environ.get(TRAIL_ENV) or None

    # -------------------------------------------------------- registration

    def register(self, role: str, seed: int, epoch_len: int,
                 alias_of: Optional[str] = None) -> None:
        """Declare one stream.  ``alias_of`` records a derived view (the
        OfficeHome target-augmented stream) that consumes the SAME
        iterator as its parent: it appears in the DataState (its seek
        semantics are the parent's) but opens no iterator of its own."""
        self.streams[role] = StreamPos(
            seed=int(seed), epoch_len=int(epoch_len), alias_of=alias_of
        )

    # ------------------------------------------------------------ position

    def advance(self, n: int = 1) -> None:
        for pos in self.streams.values():
            pos.advance(n)

    def seek_step(self, consumed: int) -> None:
        for pos in self.streams.values():
            pos.seek_step(consumed)

    def seek_epoch(self, epoch: int) -> None:
        """Epoch-boundary position (cursor 0)."""
        for pos in self.streams.values():
            pos.epoch = max(0, int(epoch))
            pos.cursor = 0

    def note_substitution(self, role: str) -> None:
        pos = self.streams.get(role)
        if pos is not None:
            pos.quarantine_subs += 1
            if pos.alias_of is None:
                for other in self.streams.values():
                    if other.alias_of == role:
                        other.quarantine_subs += 1

    # ------------------------------------------------------------ snapshot

    def snapshot(self) -> dict:
        """The JSON-ready DataState, as the JAX package writes it."""
        return {
            "version": DATA_STATE_VERSION,
            "seed_bump": int(self.seed_bump),
            "streams": {
                role: {
                    "seed": pos.seed,
                    "epoch_len": pos.epoch_len,
                    "epoch": pos.epoch,
                    "cursor": pos.cursor,
                    "quarantine_subs": pos.quarantine_subs,
                    **({"alias_of": pos.alias_of} if pos.alias_of else {}),
                }
                for role, pos in self.streams.items()
            },
        }

    def load_snapshot(self, state: Optional[dict]) -> bool:
        """Adopt a DataState; False when it cannot be used (absent, wrong
        version, other streams, other epoch lengths or seeds) — the caller
        then resumes at an epoch boundary.

        An ``epoch_len`` or ``seed`` mismatch means the recorded cursor
        indexes a different permutation, so seeking with it would
        silently train a wrong but plausible order."""
        if not isinstance(state, dict):
            return False
        if state.get("version") != DATA_STATE_VERSION:
            log.warning(
                "data_state version %r != %d; falling back to "
                "epoch-boundary resume", state.get("version"),
                DATA_STATE_VERSION,
            )
            return False
        streams = state.get("streams")
        if not isinstance(streams, dict) or set(streams) != set(self.streams):
            log.warning(
                "data_state streams %s do not match this run's %s; falling "
                "back to epoch-boundary resume",
                sorted(streams or ()), sorted(self.streams),
            )
            return False
        for role, rec in streams.items():
            pos = self.streams[role]
            if int(rec.get("epoch_len", -1)) != pos.epoch_len:
                log.warning(
                    "data_state %s epoch_len %s != this run's %d (dataset "
                    "or batch geometry changed); falling back to "
                    "epoch-boundary resume", role, rec.get("epoch_len"),
                    pos.epoch_len,
                )
                return False
            if int(rec.get("seed", pos.seed)) != pos.seed:
                log.warning(
                    "data_state %s seed %s != this run's %d (--seed changed "
                    "since the save); falling back to epoch-boundary "
                    "resume", role, rec.get("seed"), pos.seed,
                )
                return False
        for role, rec in streams.items():
            pos = self.streams[role]
            pos.epoch = int(rec.get("epoch", 0))
            pos.cursor = int(rec.get("cursor", 0))
            pos.quarantine_subs = int(rec.get("quarantine_subs", 0))
            pos.advance(0)  # normalize a cursor saved exactly at epoch end
        self.seed_bump = int(state.get("seed_bump", 0))
        return True

    # ----------------------------------------------------------- iterators

    def _trail_writer(self, role: str, epoch: int, start: int):
        """Per-iterator batch-id trail hook (None when disabled)."""
        if not self._trail_dir:
            return None
        os.makedirs(self._trail_dir, exist_ok=True)
        path = os.path.join(self._trail_dir, f"{role}.jsonl")
        cursor = [int(start)]

        def on_batch_ids(ids) -> None:
            with open(path, "a") as f:
                f.write(json.dumps({
                    "role": role, "epoch": int(epoch),
                    "cursor": cursor[0], "ids": [int(i) for i in ids],
                }) + "\n")
            cursor[0] += 1

        return on_batch_ids

    def epoch_iterator(self, dataset, role: str, batch_size: int, *,
                       epoch: Optional[int] = None,
                       start_batch: Optional[int] = None) -> Iterator:
        """One epoch's batches for ``role``, starting at the plane's
        current cursor (or an explicit ``epoch``/``start_batch``)."""
        from dwt_tpu_torch.data.loader import batch_iterator

        pos = self.streams[role]
        epoch = pos.epoch if epoch is None else int(epoch)
        start = pos.cursor if start_batch is None else int(start_batch)
        return batch_iterator(
            dataset, batch_size, shuffle=True,
            seed=pos.seed + self.seed_bump, epoch=epoch, shard=self.shard,
            num_workers=self.num_workers, start_batch=start,
            substitute=True,
            quarantine_registry=self.quarantine_registry,
            quarantine_key=role,
            on_substitute=lambda: self.note_substitution(role),
            stall_timeout=self.stall_timeout,
            on_batch_ids=self._trail_writer(role, epoch, start),
        )

    def stream(self, dataset, role: str, batch_size: int) -> Iterator:
        """Endless stream for ``role``: epochs roll over forever, the first
        opened at the plane's current ``(epoch, cursor)``."""
        pos = self.streams[role]

        def gen():
            epoch, start = pos.epoch, pos.cursor
            while True:
                yielded = False
                for item in self.epoch_iterator(
                    dataset, role, batch_size, epoch=epoch, start_batch=start
                ):
                    yielded = True
                    yield item
                if not yielded and start == 0:
                    raise RuntimeError(
                        f"stream {role!r}: epoch {epoch} yielded nothing"
                    )
                epoch += 1
                start = 0

        return gen()


# ------------------------------------------------- ordered worker pipeline


_metrics_lock = threading.Lock()
_metrics = None


def _pool_metrics():
    """Lazy singleton of the pool's live-registry instruments."""
    global _metrics
    if _metrics is None:
        with _metrics_lock:
            if _metrics is None:
                from dwt_tpu_torch.obs.registry import get_registry

                reg = get_registry()
                _metrics = (
                    reg.gauge(
                        "dwt_data_pipeline_depth",
                        "in-flight items in the ordered-reassembly window",
                    ),
                    reg.gauge(
                        "dwt_data_worker_busy",
                        "data worker threads currently decoding",
                    ),
                    reg.histogram(
                        "dwt_data_decode_ms",
                        "per-item decode+augment wall time (worker thread)",
                    ),
                    reg.counter(
                        "dwt_data_stalls_total",
                        "head-of-window stall detections (dead/slow worker)",
                    ),
                    reg.counter(
                        "dwt_data_worker_respawns_total",
                        "speculative re-submissions after a stalled item",
                    ),
                )
    return _metrics


class _SharedLevel:
    """Process-wide level behind a gauge.  The busy/depth gauges are
    process-global but several pools run concurrently (both train loops
    zip a source and a target stream, each with its own pool): per-pool
    ``set()`` would be last-writer-wins, under-reporting to whichever
    pool wrote last.  Contributions aggregate here instead."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total = 0

    def add(self, delta: int, gauge) -> int:
        with self._lock:
            self._total += int(delta)
            gauge.set(self._total)
            return self._total


_BUSY_LEVEL = _SharedLevel()
_DEPTH_LEVEL = _SharedLevel()


class OrderedWorkerPool:
    """Order-preserving decode pool with a bounded window and stall
    detection (module doc).

    :meth:`imap` maps ``fn`` over ``items`` on ``num_workers`` threads,
    yielding results in submission order.  The in-flight window is
    bounded, and the wait on the head-of-window item is watched: past
    ``stall_timeout`` seconds the item is logged and re-submitted to a
    fresh thread (first completion wins — item loads are deterministic
    under their seed tokens, so either result is bitwise the same).
    """

    name = "dwt-data"  # the worker threads' name prefix

    def __init__(self, num_workers: int,
                 stall_timeout: float = DEFAULT_STALL_TIMEOUT_S):
        self.num_workers = max(1, int(num_workers))
        self.stall_timeout = float(stall_timeout)
        self._busy = 0
        self._busy_lock = threading.Lock()

    def _wrap(self, fn: Callable, arg) -> Any:
        _, busy_g, decode_h, _, _ = _pool_metrics()
        with self._busy_lock:
            self._busy += 1  # per-pool count (the stall log message)
        _BUSY_LEVEL.add(1, busy_g)
        t0 = time.perf_counter()
        try:
            return fn(arg)
        finally:
            decode_h.observe((time.perf_counter() - t0) * 1e3)
            with self._busy_lock:
                self._busy -= 1
            _BUSY_LEVEL.add(-1, busy_g)

    def _run_future(self, fn: Callable, arg, fut: Future) -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(self._wrap(fn, arg))
        except BaseException as e:  # delivered through the future
            fut.set_exception(e)

    def _respawn(self, fn: Callable, arg) -> Future:
        """Run one stalled item on a dedicated fresh daemon thread, which
        makes progress even when every pool worker is wedged."""
        fut: Future = Future()
        threading.Thread(
            target=self._run_future, args=(fn, arg, fut),
            name=f"{self.name}-respawn", daemon=True,
        ).start()
        return fut

    @staticmethod
    def _pick_done(done) -> Any:
        """First completion wins; where a wedged original and its respawn
        land in the same wake, prefer the one that produced a result.
        All failed: raise the first exception."""
        ok = [f for f in done if f.exception() is None]
        return (ok[0] if ok else next(iter(done))).result()

    def _await_head(self, fn, arg, futures, spawn_worker) -> Any:
        """Wait for the head-of-window item; detect and recover stalls.

        A stall re-submits the item to a dedicated fresh thread and adds a
        replacement pool worker (capped), so a dead worker costs one
        timeout, not one per remaining item.  One respawn per item: an
        item that stalls its replacement too is wedged, and from there the
        periodic warnings are the surfacing.  Each detection counts in
        ``dwt_data_stalls_total``, the respawn in
        ``dwt_data_worker_respawns_total``, and the ``reassembly`` span
        covers the wait after the detection, so a trace attributes the
        stall to the data plane.
        """
        _, _, _, stall_c, respawn_c = _pool_metrics()
        done, _ = wait(futures, timeout=self.stall_timeout,
                       return_when=FIRST_COMPLETED)
        if done:  # fast path: no stall, no span
            return self._pick_done(done)
        waited = self.stall_timeout
        respawned = False
        with obs.span("reassembly", "data", stalled_item=str(arg)):
            while True:
                stall_c.inc()
                log.warning(
                    "data pipeline stalled %.1fs waiting for item %r "
                    "(dead or wedged %s worker; %d busy)",
                    waited, arg, self.name, self._busy,
                )
                if not respawned:
                    futures = set(futures)
                    futures.add(self._respawn(fn, arg))
                    spawn_worker(cap=3 * self.num_workers)
                    respawn_c.inc()
                    respawned = True
                done, _ = wait(futures, timeout=self.stall_timeout,
                               return_when=FIRST_COMPLETED)
                if done:
                    return self._pick_done(done)
                waited += self.stall_timeout

    def imap(self, fn: Callable, items) -> Iterator:
        """Ordered map of ``fn`` over ``items`` on the worker pool.

        The workers are daemon threads fed by a queue (not a
        ``ThreadPoolExecutor``), so a dead worker cannot block interpreter
        exit.  Closing the generator stops the live workers within one
        poll tick; only a wedged thread is abandoned.
        """
        depth_g = _pool_metrics()[0]
        window = max(2 * self.num_workers, 8)
        it = iter(items)
        tasks: "queue.SimpleQueue" = queue.SimpleQueue()
        stop = threading.Event()
        spawned = [0]

        def worker():
            while not stop.is_set():
                try:
                    task = tasks.get(timeout=0.2)
                except queue.Empty:
                    continue
                self._run_future(fn, task[0], task[1])

        def spawn_worker(cap: Optional[int] = None):
            k = spawned[0]
            if cap is not None and k >= cap:
                return
            spawned[0] += 1
            threading.Thread(
                target=worker, name=f"{self.name}-{k}", daemon=True
            ).start()

        for _ in range(self.num_workers):
            spawn_worker()

        def submit(arg) -> Future:
            fut: Future = Future()
            tasks.put((arg, fut))
            return fut

        watched = self.stall_timeout > 0
        depth_contrib = 0  # this pool's share of the process-wide depth gauge
        try:
            pending: "collections.deque" = collections.deque()
            for arg in it:
                pending.append((arg, submit(arg)))
                if len(pending) >= window:
                    break
            while pending:
                arg, fut = pending.popleft()
                _DEPTH_LEVEL.add(len(pending) - depth_contrib, depth_g)
                depth_contrib = len(pending)
                if watched:
                    item = self._await_head(fn, arg, {fut}, spawn_worker)
                else:
                    item = fut.result()
                for arg2 in it:  # top the window back up
                    pending.append((arg2, submit(arg2)))
                    break
                yield item
        finally:
            stop.set()
            _DEPTH_LEVEL.add(-depth_contrib, depth_g)
