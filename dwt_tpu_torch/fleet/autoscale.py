"""SLO-driven fleet autoscaling: the control loop behind the port's fleet
(``python -m dwt_tpu_torch.fleet.balancer``) — the port of
``dwt_tpu.fleet.autoscale``.

The :class:`Autoscaler` samples the fleet's OWN aggregated signals on a
``--scale_interval_s`` cadence — per-replica queue depth (carried on the
prober's ``/healthz`` bodies), balancer-side outstanding counts, the
front-door shed counter, the proxied-latency p99 against an optional
SLO, and any externally firing ``dwt_alerts_firing`` series — and
drives the replica count between ``--min_replicas`` and
``--max_replicas`` through the same spawn path the
:class:`~dwt_tpu_torch.fleet.balancer.Respawner` uses.

Design rules, each of which ``tests/test_torch_autoscale.py`` holds to
the JAX loop's decisions:

* **hysteresis, not raw samples** — the pressure/idle conditions run
  through the :class:`~dwt_tpu_torch.obs.rules.AlertEngine` pending→firing
  machinery (``for_s`` holds), so a one-tick spike neither scales up
  nor aborts an idle countdown asymmetrically; flapping load yields no
  action at all;
* **cooldown after every action** — the loop refuses to act again until
  ``cooldown_s`` has passed, so one sustained ramp produces a staircase
  of deliberate steps, not a thundering spawn;
* **respawn-budget-aware** — a crash-looping serve config inflates
  load-per-replica exactly like real traffic (the healthy denominator
  shrinks); while any replica slot's respawn budget is exhausted, or
  the autoscaler's own scale-up budget is spent (successful scale-ups
  are forgiven, crashes are not — see
  :meth:`~dwt_tpu_torch.fleet.retry.RespawnBudget.forgive`), scale-up is
  refused with ``reason="respawn_budget"``;
* **loss-free scale-down** — the victim (least queued+outstanding
  first) is marked ``retiring``, pulled from routing, and SIGTERMed;
  its own graceful drain finishes every queued request and exits 0,
  which the loop verifies before removing the slot (``scale_retired``
  event carries the rc);
* **observable** — ``scale_up``/``scale_down``/``scale_blocked``
  lifecycle events go to the JSONL event sink (the fleet's stdout),
  and the ``dwt_fleet_target_replicas`` gauge plus
  ``dwt_fleet_scale_events_total{direction,reason}`` counter ride the
  fleet's ``/metrics``;
* **fake-clock injectable** — ``clock``, ``spawn_fn``, and the event
  sink are constructor inputs and :meth:`tick` returns a
  :class:`ScaleDecision`, so the whole decision matrix is testable
  without processes, sockets, or sleeps.

The front door also asks the loop for retry advice:
:meth:`advise_eta_s` returns the expected-capacity ETA
(``scale_interval + ready-wait EWMA``) while a scale-up is in flight,
cooling down, or blocked at ``--max_replicas`` — so 503 ``Retry-After``
spreads clients across the window in which capacity actually changes,
instead of the queue-depth estimate that assumes fixed capacity and
synchronizes their retries into a thundering herd.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from dwt_tpu_torch.fleet.retry import RespawnBudget
from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.obs.rules import AlertEngine, AlertRule

__all__ = ["Autoscaler", "ScaleDecision"]

# Rule names owned by the control loop: excluded when counting
# externally firing alerts (the loop must not scale on its own echo in
# the shared dwt_alerts_firing gauge).
_OWN_RULES = ("fleet_pressure", "fleet_shed", "fleet_p99", "fleet_idle")


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """What one tick decided (and why) — the unit-test currency."""

    action: Optional[str]  # "up" | "down" | "blocked" | None
    reason: str
    target: int


class Autoscaler(threading.Thread):
    """The control loop.  ``start()`` runs it on its own thread at
    ``interval_s``; tests call :meth:`tick` directly with a fake clock.

    ``spawn_fn(rid) -> Replica`` is the whole spawn contract — the
    fleet wires :func:`~dwt_tpu_torch.fleet.balancer.spawn_replica` with its
    serve argv; unit tests return stub replicas.  Spawns run
    synchronously INSIDE the tick (the loop thread, not the prober,
    waits out the compile), with ``_spawning`` visible to the front
    door's retry advice meanwhile.
    """

    def __init__(self, rset, spawn_fn: Callable[[int], object],
                 min_replicas: int, max_replicas: int,
                 interval_s: float = 2.0,
                 pressure_hi: float = 4.0, idle_lo: float = 0.5,
                 pressure_for_s: float = 4.0, idle_for_s: float = 20.0,
                 cooldown_s: float = 15.0,
                 shed_hi_per_s: float = 0.5,
                 slo_p99_ms: float = 0.0,
                 scale_up_max: int = 8,
                 ready_wait_seed_s: float = 10.0,
                 respawner=None,
                 events: Optional[Callable[[dict], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(name="dwt-fleet-autoscale", daemon=True)
        if not (1 <= int(min_replicas) <= int(max_replicas)):
            raise ValueError(
                f"autoscale bounds need 1 <= min_replicas "
                f"({min_replicas}) <= max_replicas ({max_replicas})"
            )
        self.rset = rset
        self._spawn_fn = spawn_fn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.slo_p99_ms = float(slo_p99_ms)
        self._clock = clock
        self._events = events
        self.respawner = respawner
        self.target = len(rset.replicas)
        self._next_rid = 1 + max(
            (r.rid for r in rset.replicas), default=-1
        )
        self._budget = RespawnBudget(
            max_attempts=int(scale_up_max), backoff_s=self.interval_s,
            clock=clock,
        )
        self._cooldown_until = -float("inf")
        self._last_dir: Optional[str] = None
        self._spawning = False
        self._pressure = False
        self._retiring = None          # the replica mid-retirement
        self._pending_ok = None        # scaled-up replica awaiting health
        self._blocked_last: Optional[str] = None  # event dedupe latch
        self._last_sample_t: Optional[float] = None
        self._last_shed_total = 0.0
        self.ready_wait_ewma_s: Optional[float] = None
        self.ready_wait_seed_s = float(ready_wait_seed_s)
        # Front-door latency ring: the handler notes each proxied 200's
        # round trip; p99 over the ring is the fleet's client-felt SLO
        # signal (queueing at the replica included).
        self._lat_ms: deque = deque(maxlen=512)
        self._lat_lock = threading.Lock()
        self._stop_evt = threading.Event()

        reg = get_registry()
        self._registry = reg
        self._g_target = reg.gauge(
            "dwt_fleet_target_replicas",
            "autoscaler's desired replica count",
        )
        self._g_target.set(self.target)
        self._m_events = reg.counter(
            "dwt_fleet_scale_events_total",
            "autoscaler lifecycle events",
            labelnames=("direction", "reason"),
        )
        self._g_load = reg.gauge(
            "dwt_fleet_load_per_replica",
            "queued + outstanding requests per healthy replica",
        )
        self._g_shed = reg.gauge(
            "dwt_fleet_shed_per_s",
            "front-door shed responses per second (sampled)",
        )
        self._g_p99 = reg.gauge(
            "dwt_fleet_e2e_p99_ms",
            "p99 of proxied request round trips (front-door ring)",
        )
        rules: List[AlertRule] = [
            AlertRule("fleet_pressure", "dwt_fleet_load_per_replica",
                      ">", float(pressure_hi), for_s=float(pressure_for_s)),
            AlertRule("fleet_shed", "dwt_fleet_shed_per_s",
                      ">", float(shed_hi_per_s),
                      for_s=float(pressure_for_s)),
            AlertRule("fleet_idle", "dwt_fleet_load_per_replica",
                      "<", float(idle_lo), for_s=float(idle_for_s),
                      severity="info"),
        ]
        if self.slo_p99_ms > 0:
            rules.append(
                AlertRule("fleet_p99", "dwt_fleet_e2e_p99_ms",
                          ">", self.slo_p99_ms,
                          for_s=float(pressure_for_s))
            )
        self._engine = AlertEngine(
            rules, registry=reg, clock=clock, min_interval_s=0.0
        )

    # ------------------------------------------------------------ signals

    def note_latency(self, ms: float) -> None:
        """Handler hook: one proxied round trip completed in ``ms``."""
        with self._lat_lock:
            self._lat_ms.append(float(ms))

    def _ring_p99(self) -> Optional[float]:
        with self._lat_lock:
            vals = sorted(self._lat_ms)
        if len(vals) < 20:  # too few samples to call it a percentile
            return None
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def _counter_total(self, name: str) -> float:
        return float(sum(v for _, v in self._registry.samples(name)))

    def _external_alerts(self) -> int:
        """Non-info alerts firing that this loop does not own — e.g. a
        replica-health rule wired by an operator into this process."""
        n = 0
        for labels, value in self._registry.samples("dwt_alerts_firing"):
            if labels.get("alertname") in _OWN_RULES:
                continue
            if value and labels.get("severity") != "info":
                n += 1
        return n

    def _sample(self, now: float) -> dict:
        active = [r for r in self.rset.replicas
                  if r.healthy and not getattr(r, "retiring", False)]
        queued = sum(
            int(r.last_health.get("queued_items") or 0) for r in active
        )
        outstanding = sum(r.outstanding for r in active)
        load = (queued + outstanding) / max(1, len(active))
        shed_total = self._counter_total("dwt_fleet_shed_total")
        dt = (now - self._last_sample_t
              if self._last_sample_t is not None else None)
        shed_per_s = (
            (shed_total - self._last_shed_total) / dt
            if dt and dt > 0 else 0.0
        )
        self._last_sample_t = now
        self._last_shed_total = shed_total
        return {
            "load_per_replica": load,
            "shed_per_s": shed_per_s,
            "p99_ms": self._ring_p99(),
            "healthy": len(active),
        }

    # ----------------------------------------------------------- the loop

    def tick(self) -> ScaleDecision:
        now = self._clock()
        self._finish_retirement()
        self._forgive_if_healthy()
        ext_alerts = self._external_alerts()
        sample = self._sample(now)
        self._g_load.set(sample["load_per_replica"])
        self._g_shed.set(sample["shed_per_s"])
        if sample["p99_ms"] is not None:
            self._g_p99.set(sample["p99_ms"])
        self._engine.evaluate(now)
        firing = set(self._engine.firing())
        pressure_why = None
        for rule, why in (("fleet_pressure", "queue_pressure"),
                          ("fleet_shed", "shed"),
                          ("fleet_p99", "slo_p99")):
            if rule in firing:
                pressure_why = why
                break
        if pressure_why is None and ext_alerts > 0:
            pressure_why = "alerts_firing"
        self._pressure = pressure_why is not None
        idle = "fleet_idle" in firing and not self._pressure
        decision = self._decide(now, pressure_why, idle)
        self._apply(decision, now)
        return decision

    def _decide(self, now: float, pressure_why: Optional[str],
                idle: bool) -> ScaleDecision:
        if pressure_why is not None:
            if self.target >= self.max_replicas:
                return ScaleDecision("blocked", "at_max", self.target)
            if (self.respawner is not None
                    and self.respawner.exhausted_slots()):
                return ScaleDecision(
                    "blocked", "respawn_budget", self.target
                )
            if self._budget.exhausted("scale_up"):
                return ScaleDecision(
                    "blocked", "respawn_budget", self.target
                )
            if now < self._cooldown_until:
                return ScaleDecision("blocked", "cooldown", self.target)
            if self._retiring is not None:
                # A drain is mid-flight; adding while removing thrashes.
                return ScaleDecision("blocked", "retiring", self.target)
            if not self._budget.ready("scale_up"):
                # Backoff after a failed spawn attempt.
                return ScaleDecision(
                    "blocked", "respawn_budget", self.target
                )
            return ScaleDecision("up", pressure_why, self.target + 1)
        if idle:
            if self.target <= self.min_replicas:
                return ScaleDecision(None, "at_min", self.target)
            if now < self._cooldown_until:
                return ScaleDecision(None, "cooldown", self.target)
            if self._retiring is not None:
                return ScaleDecision(None, "retiring", self.target)
            return ScaleDecision("down", "idle", self.target - 1)
        return ScaleDecision(None, "steady", self.target)

    def _apply(self, decision: ScaleDecision, now: float) -> None:
        if decision.action == "blocked":
            # Dedupe: one scale_blocked event per episode, not per tick.
            if decision.reason != self._blocked_last:
                self._blocked_last = decision.reason
                self._m_events.labels(
                    direction="blocked", reason=decision.reason
                ).inc()
                self._emit("scale_blocked", reason=decision.reason,
                           target=self.target)
            return
        self._blocked_last = None
        if decision.action == "up":
            self._scale_up(decision.reason, now)
        elif decision.action == "down":
            self._scale_down(decision.reason, now)

    def _scale_up(self, reason: str, now: float) -> None:
        rid = self._next_rid
        self._next_rid += 1
        self._budget.begin("scale_up")
        self._spawning = True
        t0 = self._clock()
        try:
            replica = self._spawn_fn(rid)
        except Exception as e:
            self._m_events.labels(
                direction="up", reason="spawn_failed"
            ).inc()
            self._emit("scale_blocked", reason="spawn_failed", rid=rid,
                       target=self.target, error=f"{type(e).__name__}: {e}")
            return
        finally:
            self._spawning = False
        wait = max(0.0, self._clock() - t0)
        self.ready_wait_ewma_s = (
            wait if self.ready_wait_ewma_s is None
            else 0.7 * self.ready_wait_ewma_s + 0.3 * wait
        )
        self.rset.add(replica)
        self.target += 1
        self._g_target.set(self.target)
        self._pending_ok = replica
        self._cooldown_until = self._clock() + self.cooldown_s
        self._last_dir = "up"
        self._m_events.labels(direction="up", reason=reason).inc()
        self._emit("scale_up", rid=rid, target=self.target,
                   reason=reason, ready_wait_s=round(wait, 3))

    def _scale_down(self, reason: str, now: float) -> None:
        candidates = [r for r in self.rset.replicas
                      if r.healthy and not getattr(r, "retiring", False)]
        if len(candidates) <= self.min_replicas:
            return
        def load(r):
            return (r.outstanding
                    + int(r.last_health.get("queued_items") or 0)
                    + int(r.last_health.get("in_flight_batches") or 0))
        victim = min(candidates, key=lambda r: (load(r), -r.rid))
        self.rset.retire(victim)
        if victim.proc is not None and victim.proc.poll() is None:
            import signal as _signal

            victim.proc.send_signal(_signal.SIGTERM)
        self._retiring = victim
        self.target -= 1
        self._g_target.set(self.target)
        self._cooldown_until = now + self.cooldown_s
        self._last_dir = "down"
        self._m_events.labels(direction="down", reason=reason).inc()
        self._emit("scale_down", rid=victim.rid, target=self.target,
                   reason=reason, victim_load=load(victim))

    def _finish_retirement(self) -> None:
        v = self._retiring
        if v is None:
            return
        rc = 0 if v.proc is None else v.proc.poll()
        if v.proc is not None and rc is None:
            return  # still draining its queue
        self.rset.remove(v)
        self._retiring = None
        self._emit("scale_retired", rid=v.rid, rc=rc,
                   clean=bool(rc == 0))

    def _forgive_if_healthy(self) -> None:
        """A scaled-up replica that reached healthy refunds its budget
        charge — legitimate growth never exhausts the scale-up budget,
        a crash loop (spawns that die before proving themselves) does."""
        p = self._pending_ok
        if p is None:
            return
        if p.healthy and p.alive:
            self._budget.forgive("scale_up")
            self._pending_ok = None
        elif not p.alive:
            self._pending_ok = None  # died young: the charge stands

    # ------------------------------------------------------- retry advice

    def capacity_eta_s(self) -> float:
        """Expected seconds until capacity changes: one control-loop
        period plus the observed replica ready-wait."""
        wait = (self.ready_wait_ewma_s
                if self.ready_wait_ewma_s is not None
                else self.ready_wait_seed_s)
        return self.interval_s + wait

    def advise_eta_s(self) -> Optional[float]:
        """The Retry-After the front door should advise, or None when
        capacity is not in motion (the queue-depth estimate stands)."""
        if self._spawning:
            return self.capacity_eta_s()
        now = self._clock()
        if self._last_dir == "up" and now < self._cooldown_until:
            return self.capacity_eta_s()
        if self._pressure and self.target >= self.max_replicas:
            return self.capacity_eta_s()
        return None

    # ---------------------------------------------------------- lifecycle

    def _emit(self, kind: str, **fields) -> None:
        if self._events is None:
            return
        rec = {"kind": kind}
        rec.update(fields)
        try:
            self._events(rec)
        except Exception:  # an event sink must never kill the loop
            pass

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "fleet: autoscaler tick failed"
                )

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_evt.set()
        self.join(timeout)
