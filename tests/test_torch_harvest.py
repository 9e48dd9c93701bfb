"""The port's metric harvester and the guard's harvested mode, held to the JAX package's.

* The ring: ready entries drain with no rendezvous, an overflow drains the
  whole ring in ONE (``_wait``, the countable sync), depth 0 waits at
  every put, a boundary drain flushes what is pending, a put with nothing
  to book is free, the generation fence keeps stale flags from the guard,
  the pending floor follows the puts and ``reset_stamps`` forgets it —
  the cases of ``tests/test_harvest.py`` that need no ``obs``.
* The guard: a NaN's flag drained ``depth`` boundaries late still reverts
  to a snapshot strictly older than the NaN, chunked flags pick the first
  bad step, a strike that ran backed off escalates even when its flag
  drains after the scale recovered, the history prunes to the floor.
* The same puts and flags through the live JAX harvester and guard and
  through the port's give the same records and guard events.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dwt_tpu.resilience.guard import DivergenceGuard as JaxGuard
from dwt_tpu.resilience.guard import RollbackRequest as JaxRollbackRequest
from dwt_tpu.train import harvest as jax_harvest
from dwt_tpu.train.optim import with_lr_backoff
from dwt_tpu.train.state import TrainState as JaxTrainState
from dwt_tpu_torch.resilience.guard import DivergenceGuard, RollbackRequest
from dwt_tpu_torch.train import harvest
from dwt_tpu_torch.train.harvest import AsyncMetricHarvester, make_harvester
from dwt_tpu_torch.train.state import TrainState


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _count_waits(monkeypatch, cls=AsyncMetricHarvester):
    """Counting shim on the one blocking rendezvous."""
    calls = []
    real = cls._wait

    def counting(self, entries):
        calls.append(len(entries))
        return real(self, entries)

    monkeypatch.setattr(cls, "_wait", counting)
    return calls


def _put_steps(h, steps, emitted):
    for s in steps:
        h.put(s, s, values={"v": torch.tensor(float(s))},
              emit=lambda vals: emitted.append(float(vals["v"])))


# ------------------------------------------------------------ ring policy


def test_ready_entries_drain_opportunistically_without_sync(monkeypatch):
    calls = _count_waits(monkeypatch)
    monkeypatch.setattr(harvest._Entry, "ready", lambda self: True)
    emitted = []
    h = AsyncMetricHarvester(2)
    _put_steps(h, range(1, 9), emitted)
    assert calls == []
    assert emitted == [float(s) for s in range(1, 9)]
    assert h.pending == 0 and h.puts == 8 and h.emitted == 8


def test_ring_overflow_forces_one_rendezvous_per_depth(monkeypatch):
    calls = _count_waits(monkeypatch)
    monkeypatch.setattr(harvest._Entry, "ready", lambda self: False)
    emitted = []
    h = AsyncMetricHarvester(2)
    _put_steps(h, range(1, 9), emitted)
    # Overflows at puts 3 and 6: one rendezvous for 3 entries each.
    assert calls == [3, 3]
    assert emitted == [float(s) for s in range(1, 7)]
    assert h.pending == 2 and h.lag_steps == 1
    h.drain()
    assert calls == [3, 3, 2]
    assert emitted == [float(s) for s in range(1, 9)]


def test_depth0_is_synchronous_per_put(monkeypatch):
    calls = _count_waits(monkeypatch)
    emitted = []
    h = AsyncMetricHarvester(0)
    _put_steps(h, range(1, 5), emitted)
    assert calls == [1, 1, 1, 1]
    assert emitted == [1.0, 2.0, 3.0, 4.0]
    assert not h.async_mode


def test_boundary_drain_flushes_partial_ring(monkeypatch):
    calls = _count_waits(monkeypatch)
    monkeypatch.setattr(harvest._Entry, "ready", lambda self: False)
    emitted = []
    h = AsyncMetricHarvester(4)
    _put_steps(h, (1, 2, 3), emitted)
    assert emitted == [] and h.pending == 3
    h.drain()
    assert emitted == [1.0, 2.0, 3.0] and calls == [3] and h.pending == 0
    h.drain()
    assert calls == [3]


def test_put_without_payload_is_free():
    h = AsyncMetricHarvester(2)
    h.put(1, 1)
    assert h.puts == 0 and h.pending == 0


def test_cpu_entries_are_ready_and_taken_as_they_are():
    h = AsyncMetricHarvester(2)
    seen = []
    h.put(1, 3, values={"v": torch.tensor([1.0, 2.0, 3.0])},
          flag=torch.tensor([True, True, True]),
          emit=lambda vals: seen.append(vals["v"].tolist()))
    assert seen == [[1.0, 2.0, 3.0]] and h.pending == 0


def test_generation_fence_makes_stale_flags_inert(monkeypatch):
    monkeypatch.setattr(harvest._Entry, "ready", lambda self: False)
    state = _state(0.0)
    guard = DivergenceGuard("skip_step", interval=1)
    guard.prime(state)
    guard.enable_harvest(4, 0)
    emitted = []
    h = AsyncMetricHarvester(4, flag_observer=guard.observe_flags)
    h.put(1, 1, values={"v": torch.tensor(1.0)}, flag=torch.tensor(False),
          emit=lambda vals: emitted.append(float(vals["v"])))
    h.bump_generation()
    h.drain()
    assert emitted == [1.0]
    _set(state, 2.0)
    guard.check_harvested(state, 1, 2)
    assert guard.recoveries == 0 and _tag(state) == 2.0


def test_pending_floor_tracks_put_control_flow():
    h = AsyncMetricHarvester(2)
    assert h.pending_floor() is None
    _put_steps(h, (1, 2, 3), [])
    assert h.pending_floor() == 2


def test_reset_stamps_clears_floor_for_rollback_rewind():
    h = AsyncMetricHarvester(2)
    _put_steps(h, (999, 1000), [])
    assert h.pending_floor() == 999
    h.drain()
    h.reset_stamps()
    assert h.pending_floor() is None
    _put_steps(h, (501, 502), [])
    assert h.pending_floor() == 501


def test_make_harvester_wires_the_guard_only_when_harvesting():
    class Cfg:
        harvest_depth = 2

    guard = DivergenceGuard("skip_step", interval=1)
    assert make_harvester(Cfg, guard)._observer == guard.observe_flags
    Cfg.harvest_depth = 0
    h = make_harvester(Cfg, guard)
    assert h._observer is None and not h.async_mode


# ----------------------------------------------- guard: bounded staleness


def _state(tag: float) -> TrainState:
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(tag)
    return TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1),
                      [lambda s: 0.1])


def _set(state: TrainState, tag: float) -> None:
    with torch.no_grad():
        state.model.weight.fill_(tag)


def _tag(state: TrainState) -> float:
    return float(state.model.weight.detach()[0, 0])


def test_guard_detects_within_depth_and_reverts_pre_nan():
    guard = DivergenceGuard("skip_step", interval=1)
    state = _state(0.0)
    guard.prime(state)
    guard.enable_harvest(2, 0)
    for s in (1, 2):
        guard.observe_flags(s, s, np.asarray(True))
        _set(state, float(s))
        guard.check_harvested(state, 1, s)
        assert _tag(state) == float(s)
    # Step 3 goes NaN, its flag still in flight: boundaries 3 and 4 refresh
    # snapshots from poisoned states.
    for s in (3, 4):
        _set(state, float(s))
        guard.check_harvested(state, 1, s)
    guard.observe_flags(3, 3, np.asarray(False))
    _set(state, 5.0)
    guard.check_harvested(state, 1, 5)
    assert _tag(state) == 2.0  # the newest strictly pre-NaN snapshot
    assert guard.recoveries == 1 and guard.last_bad_step == 3


def test_guard_chunked_flags_pick_first_bad_step():
    guard = DivergenceGuard("rollback", interval=1)
    state = _state(0.0)
    guard.prime(state)
    guard.enable_harvest(2, 0)
    guard.observe_flags(1, 4, np.asarray([True, True, False, False]))
    with pytest.raises(RollbackRequest) as ei:
        guard.check_harvested(state, 4, 4)
    assert ei.value.step == 3


def test_late_draining_strike_during_backoff_still_escalates():
    guard = DivergenceGuard("skip_step", interval=1, lr_backoff=0.5,
                            backoff_recovery=1)
    state = _state(0.0)
    guard.prime(state)
    guard.enable_harvest(2, 0)
    guard.observe_flags(1, 1, np.asarray(False))
    guard.check_harvested(state, 1, 1)
    assert guard.in_backoff and guard.backoffs == 1 and state.lr_scale == 0.5
    guard.check_harvested(state, 1, 2)
    assert not guard.in_backoff and state.lr_scale == 1.0
    guard.observe_flags(2, 2, np.asarray(False))
    guard.check_harvested(state, 1, 3)
    assert guard.backoffs == 1  # escalated: no second backoff
    assert guard.recoveries == 2


def test_history_prunes_with_deterministic_floor():
    floor = {"v": None}
    guard = DivergenceGuard("skip_step", interval=1)
    state = _state(0.0)
    guard.prime(state)
    guard.enable_harvest(4, 0, floor_fn=lambda: floor["v"])
    for s in range(1, 10):
        floor["v"] = s - 1 if s > 1 else None
        if s > 1:
            guard.observe_flags(s - 1, s - 1, np.asarray(True))
        _set(state, float(s))
        guard.check_harvested(state, 1, s)
    assert len(guard._snaps) <= 3
    guard.observe_flags(9, 9, np.asarray(False))
    _set(state, 10.0)
    guard.check_harvested(state, 1, 10)
    assert _tag(state) == 8.0


# ------------------------------------- the same sequence, both packages


class _JaxLogger:
    def __init__(self, out):
        self.out = out

    def log(self, kind, step, sync=False, **values):
        self.out.append((kind, step, values))


def _jax_state(tag: float):
    tx = with_lr_backoff(optax.sgd(0.1))
    params = {"w": jnp.full((3,), tag)}
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats={}, opt_state=tx.init(params))


def _drive(ours: bool, monkeypatch, policy: str, lr_backoff: float):
    """Five dispatches of two steps, the fourth step non-finite, through one
    package's harvester (depth 2, copies never ready early) and guard:
    ``(records, guard events, the state's tag after each boundary)``."""
    module = harvest if ours else jax_harvest
    monkeypatch.setattr(module._Entry, "ready", lambda self: False)
    events, records, tags = [], [], []
    guard_cls = DivergenceGuard if ours else JaxGuard
    guard = guard_cls(policy, interval=2, lr_backoff=lr_backoff, backoff_recovery=1,
                      logger=(lambda k, s, **f: events.append((k, s, f))) if ours
                      else _JaxLogger(events))
    state = _state(0.0) if ours else _jax_state(0.0)
    guard.prime(state)
    h = module.AsyncMetricHarvester(2, flag_observer=guard.observe_flags)
    guard.enable_harvest(2, 0, floor_fn=h.pending_floor)
    for lo in range(1, 11, 2):
        hi = lo + 1
        flags = [s != 4 for s in (lo, hi)]
        if ours:
            _set(state, float(hi))
            values = {"v": torch.tensor([float(lo), float(hi)])}
            flag = torch.tensor(flags)
        else:
            state = _jax_state(float(hi))
            values = {"v": jnp.asarray([float(lo), float(hi)])}
            flag = jnp.asarray(flags)

        def emit(vals, lo=lo):
            records.extend((lo + j, float(vals["v"][j])) for j in range(2))

        h.put(lo, hi, values=values, flag=flag, emit=emit)
        recoveries = guard.recoveries
        try:
            out = guard.check_harvested(state, 2, hi)
        except (RollbackRequest, JaxRollbackRequest) as rb:
            events.append(("raised", rb.step, {}))
            h.bump_generation()
            break
        if guard.recoveries != recoveries:
            h.bump_generation()
        if not ours:
            state = out
        tags.append(_tag(state) if ours else float(state.params["w"][0]))
    h.drain()
    return records, events, tags


@pytest.mark.parametrize("policy,lr_backoff", [("skip_step", 0.0), ("skip_step", 0.5),
                                                ("rollback", 0.0)])
def test_same_puts_and_flags_give_the_jax_records_and_guard_events(
        monkeypatch, policy, lr_backoff):
    ours = _drive(True, monkeypatch, policy, lr_backoff)
    ref = _drive(False, monkeypatch, policy, lr_backoff)
    assert ours == ref
    records, events, _ = ours
    assert [s for s, _ in records] == list(range(1, 1 + len(records)))
    assert any(k == "divergence" and f.get("detected_at", 0) > s
               for k, s, f in events)
