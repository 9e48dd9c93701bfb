"""Async metric harvesting: the train records' host readback off the hot path — the port of ``dwt_tpu.train.harvest``.

A blocking readback of step *s*'s metrics cannot return before step *s*
has run on the card, so a ``float()`` per logged step (and the guard's
readback of the finite flag) keeps the launching thread in lockstep with
the device.  The loops only consume these scalars at their log and guard
cadence, so nothing requires the read to be synchronous.

:class:`AsyncMetricHarvester` is the deferred pipeline: each dispatch puts
its step-stamped device scalars into a bounded ring after starting their
copies into pinned host tensors (``non_blocking``, on the compute stream)
and recording a ``torch.cuda.Event`` behind them; entries are
materialized and emitted, with their original step stamps, once their
event has fired (``Event.query()``, which does not sync), once the ring
overflows, or at the loops' boundaries (eval, checkpoint, preemption,
rollback, the end), which drain fully.  An overflow drains the whole ring
with ONE blocking rendezvous (``Event.synchronize()``), so the
amortized host syncs per step fall from 1 to at most 1/depth.

Contracts the loops rely on:

* **exact records, nothing lost or reordered** — the ring is FIFO and
  every boundary drain flushes it; the records are byte-identical to the
  depth-0 path's, with their original step stamps.
* **depth 0 = the synchronous readback** — ``put`` waits and emits at
  once (one sync per record-bearing step), through the same emit closure.
* **bounded guard staleness** — the step's device-side ``finite`` flag
  rides the same ring; a NaN at step *s* reaches
  :meth:`~dwt_tpu_torch.resilience.guard.DivergenceGuard.observe_flags` by
  the drain at *s + depth* entries.
* **generation fencing** — after a guard recovery the ring may still hold
  entries of the poisoned trajectory; :meth:`bump_generation` makes their
  flags inert (their records still emit: those steps ran).

Tensors on the CPU are trivially ready.  ``pending`` and ``lag_steps``
also feed the registry's ``dwt_harvest_ring_depth`` and
``dwt_harvest_lag_steps`` (host integers; the heartbeat mirrors them); the
JAX package's spans wait for the span tracer (ROADMAP queue 1 item 9).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


class _Entry:
    """One dispatch's booked metrics: step range, the host copies of the
    scalars its record needs and of the optional finite flag, the event
    behind the copies (None on the CPU), the emit closure and the
    generation it was put in."""

    __slots__ = ("lo", "hi", "values", "flag", "event", "emit", "gen")

    def __init__(self, lo: int, hi: int, values: Dict[str, torch.Tensor],
                 flag: Optional[torch.Tensor], event, emit: Optional[Callable],
                 gen: int):
        self.lo = lo
        self.hi = hi
        self.values = values
        self.flag = flag
        self.event = event
        self.emit = emit
        self.gen = gen

    def ready(self) -> bool:
        """Every copy landed (``Event.query()`` polls, it does not sync)."""
        return self.event is None or self.event.query()


def _host_copies(values: Dict[str, torch.Tensor], flag: Optional[torch.Tensor]):
    """Start the copies of ``values`` and ``flag`` into pinned host tensors
    on the current stream; returns ``(values, flag, event)`` — the host
    tensors, valid once ``event`` has fired (None when every tensor lies on
    the CPU, whose tensors are taken as they are)."""
    leaves = list(values.values()) + ([] if flag is None else [flag])
    cuda = [t for t in leaves if t.is_cuda]
    if not cuda:
        return values, flag, None

    def start(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        return host

    host_values = {k: start(v) for k, v in values.items()}
    host_flag = None if flag is None else start(flag)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(cuda[0].device))
    return host_values, host_flag, event


class AsyncMetricHarvester:
    """Bounded-ring deferred metric pipeline (module docstring).

    ``flag_observer(lo, hi, host_flags)`` — the guard's ``observe_flags``
    — receives each drained entry's finite flag(s) before the entry's
    record emits, and only for entries of the current generation.

    The loop's thread only, as the loops that drive it: no locking.
    """

    def __init__(self, depth: int, flag_observer: Optional[Callable] = None):
        self.depth = max(0, int(depth))
        self._ring: "collections.deque[_Entry]" = collections.deque()
        self._observer = flag_observer
        self.generation = 0
        self.puts = 0
        self.emitted = 0
        # Staleness of the oldest pending entry at the last put or drain, in
        # steps.
        self.lag_steps = 0
        self._last_put_hi: Optional[int] = None
        # Lo stamps of the last `depth` puts: after a put returns the ring
        # holds at most `depth` entries, so a pending flag covers no step
        # older than _lo_history[0] — a bound from the puts alone, not
        # from when drains happened (the guard's prune floor).
        self._lo_history: "collections.deque[int]" = collections.deque(
            maxlen=max(self.depth, 1))
        # The metrics plane's two gauges, host-side integers the put and
        # drain sites already hold: no device read (the heartbeat mirrors
        # them).
        from dwt_tpu_torch.obs.registry import get_registry

        reg = get_registry()
        self._g_ring = reg.gauge("dwt_harvest_ring_depth",
                                 "metric-harvest entries in flight (ring occupancy)")
        self._g_lag = reg.gauge(
            "dwt_harvest_lag_steps",
            "staleness of the oldest harvested metrics at the last drain, in steps")
        self._g_ring.set(0)
        self._g_lag.set(0)

    @property
    def async_mode(self) -> bool:
        return self.depth > 0

    @property
    def pending(self) -> int:
        return len(self._ring)

    def put(self, lo: int, hi: int, values: Optional[Dict[str, torch.Tensor]] = None,
            flag: Optional[torch.Tensor] = None, emit: Optional[Callable] = None) -> None:
        """Book the metrics of steps ``[lo, hi]`` (one step per dispatch on
        the per-step paths; a chunk's range, with ``[n]``-stacked tensors,
        on the chunked path).

        ``values`` holds exactly the device scalars ``emit`` needs (None
        when the steps log nothing), ``flag`` the device-side finite
        verdict (None when no guard reads it).  Nothing to book: no
        entry, no copy."""
        if values is None and flag is None:
            return
        self.puts += 1
        self._last_put_hi = int(hi)
        host_values, host_flag, event = _host_copies(values or {}, flag)
        e = _Entry(int(lo), int(hi), host_values, host_flag, event, emit,
                   self.generation)
        if self.depth == 0:
            # The synchronous readback: wait and emit in place.
            self._emit(e, self._wait([e])[0])
            return
        self._ring.append(e)
        self._lo_history.append(e.lo)
        # Entries whose copies landed emit now, without a rendezvous; only
        # the ready prefix, so records never pass an older entry in flight.
        while self._ring and self._ring[0].ready():
            entry = self._ring.popleft()
            self._emit(entry, self._materialize(entry))
        if len(self._ring) > self.depth:
            # The device is more than `depth` record-bearing dispatches
            # behind: ONE rendezvous for every pending entry.
            self.drain()
        self._note_gauges()

    def drain(self) -> None:
        """Flush the ring: ONE blocking rendezvous for every pending entry
        (the oldest copies landed long ago; the wait is on the newest),
        then the entries emit in FIFO order.  ``put`` calls it on overflow,
        the loops at every eval, checkpoint, preemption, rollback and the
        end."""
        if not self._ring:
            return
        entries = list(self._ring)
        self._ring.clear()
        if self._last_put_hi is not None:
            self.lag_steps = self._last_put_hi - entries[0].lo
            self._g_lag.set(self.lag_steps)
        for e, host in zip(entries, self._wait(entries)):
            self._emit(e, host)
        self._note_gauges()

    def _note_gauges(self) -> None:
        self._g_ring.set(len(self._ring))
        if self._ring and self._last_put_hi is not None:
            self.lag_steps = self._last_put_hi - self._ring[0].lo
            self._g_lag.set(self.lag_steps)

    def pending_floor(self) -> Optional[int]:
        """The oldest step a still-pending flag could cover (None until
        ``depth`` puts happened): the guard prunes snapshots strictly below
        the newest one under this floor."""
        if len(self._lo_history) < max(self.depth, 1):
            return None
        return self._lo_history[0]

    def bump_generation(self) -> None:
        """Fence the pending entries' flags: after a guard recovery their
        verdicts must not re-trip the guard on the replayed segment.  Their
        records still emit."""
        self.generation += 1

    def reset_stamps(self) -> None:
        """Forget the put stamps.  The rollback handlers call this after
        their full drain: the restore rewinds the step numbering, and a
        floor from pre-rollback stamps would let the guard prune the
        snapshot the replay may need.  In-memory recoveries keep the host
        numbering monotonic and do not reset."""
        self._lo_history.clear()
        self._last_put_hi = None

    def _wait(self, entries: List[_Entry]) -> List[Tuple[dict, Any]]:
        """THE blocking rendezvous — the one countable host sync on the
        record path (tests count calls here; ready entries drained by
        ``put`` never come through it)."""
        for e in entries:
            if e.event is not None:
                e.event.synchronize()
        return [self._materialize(e) for e in entries]

    @staticmethod
    def _materialize(e: _Entry) -> Tuple[dict, Any]:
        """The entry's host tensors (its copies have landed)."""
        return e.values, e.flag

    def _emit(self, e: _Entry, host: Tuple[dict, Any]) -> None:
        host_values, host_flag = host
        if (host_flag is not None and self._observer is not None
                and e.gen == self.generation):
            self._observer(e.lo, e.hi, host_flag)
        if e.emit is not None:
            e.emit(host_values)
        self.emitted += 1


def make_harvester(cfg, guard=None) -> AsyncMetricHarvester:
    """The loops' one constructor: ``--harvest_depth`` (default 2; 0 = the
    synchronous readback) wired to the run's guard.  With a guard and a
    depth above 0 the guard reads the harvested flags (the loop calls
    ``guard.enable_harvest``); at depth 0 it keeps its own readback every
    ``--guard_interval`` steps."""
    depth = max(0, int(cfg.harvest_depth))
    observer = guard.observe_flags if guard is not None and depth > 0 else None
    return AsyncMetricHarvester(depth, flag_observer=observer)
