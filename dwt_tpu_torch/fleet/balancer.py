"""Replica fleet + front load balancer — the port of ``dwt_tpu.fleet.balancer``
(``dwt-fleet``), run as ``python -m dwt_tpu_torch.fleet.balancer``.

One balancer process fronts N ``python -m dwt_tpu_torch.serve.server``
replica subprocesses — all
serving the same model, all watching the same ``ckpt_dir`` (each replica
runs its own hot-reload loop, so a new checkpoint rolls across the fleet
replica by replica with the canary gating each one independently).

* **routing** — least-outstanding-requests: every proxied ``/infer``
  picks the healthy replica with the fewest requests currently in
  flight through the balancer (the cheapest load signal that tracks the
  replicas' actual queue depth without polling them per request); ties
  break round-robin.  With autoscaling on (the default), the pick is
  WEIGHTED by each replica's measured drain-rate EWMA so heterogeneous
  replicas take proportional traffic, and ``--session_affinity`` adds
  consistent-hash pinning on the ``X-DWT-Session`` header (see
  :class:`ReplicaSet`).
* **autoscaling** — :class:`~dwt_tpu_torch.fleet.autoscale.Autoscaler`
  samples queue depth, shed rate, and p99-vs-SLO on a
  ``--scale_interval_s`` cadence and drives the replica count between
  ``--min_replicas`` and ``--max_replicas``; ``--no-autoscale`` pins
  the legacy fixed-N fleet bit for bit.
* **health** — a prober thread polls each replica's ``/healthz`` every
  ``--health_interval_s``: a non-200 (the server answers 503 with a dead
  dispatcher), a connect failure, or a dead subprocess EJECTS the
  replica from routing; a later healthy probe RE-ADMITS it (a replica
  that answered 503 while draining or overloaded comes back by itself).
  The probe also reads ``dispatcher_heartbeat_age_s`` — a replica whose
  dispatcher is wedged (age far past the poll period with work queued)
  is ejected even though its listener still answers 200s.
* **keep-alive upstream** — proxied requests reuse pooled persistent
  connections per replica (:class:`~dwt_tpu_torch.serve.server
  .HttpServeClient` semantics); without it the balancer would pay a TCP
  connect per proxied request.
* **no CUDA here** — the balancer process imports neither torch nor the
  serving engine (its handler base is :mod:`~dwt_tpu_torch.serve.http`);
  each replica owns its CUDA context, its weights and its kernels, and
  is started by exec (``subprocess.Popen``), never forked.
* **drain** — SIGTERM/SIGINT: stop admitting (503 + Retry-After),
  forward SIGTERM to every replica, wait for each to finish its own
  graceful drain (exit 0), then exit 0 — the whole fleet honors the
  single-server drain contract.
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import http.client
import json
import logging
import os
import select
import signal
import subprocess
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import List, Optional, Sequence

from dwt_tpu_torch.obs.registry import get_registry
from dwt_tpu_torch.serve.http import DrainAwareHandler

log = logging.getLogger(__name__)


class _ConnPool:
    """Tiny per-replica pool of persistent HTTP connections.

    ``get``/``put`` bracket one proxied request; a connection that died
    mid-request is closed (not returned), so the pool self-heals after a
    replica restart.  Bounded: beyond ``cap`` idle connections are
    closed rather than kept (handler threads come and go)."""

    def __init__(self, host: str, port: int, timeout: float, cap: int = 16):
        self.host, self.port, self.timeout, self.cap = (
            host, int(port), float(timeout), int(cap)
        )
        self._lock = threading.Lock()
        self._idle: List[http.client.HTTPConnection] = []

    def get(self) -> http.client.HTTPConnection:
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return http.client.HTTPConnection(
            self.host, self.port, timeout=self.timeout
        )

    def put(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            if len(self._idle) < self.cap:
                self._idle.append(conn)
                return
        conn.close()

    def close_all(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass


class Replica:
    """One serving backend: subprocess-owned or external (tests)."""

    def __init__(self, rid: int, host: str, port: int,
                 proc: Optional[subprocess.Popen] = None,
                 timeout: float = 70.0):
        self.rid = rid
        self.host = host
        self.port = int(port)
        self.proc = proc
        self.pool = _ConnPool(host, port, timeout)
        self.healthy = True
        self.outstanding = 0
        self.served = 0
        self.failures = 0          # lifetime proxy/probe failures
        self.respawns = 0          # times this slot was re-spawned
        self.last_health: dict = {}
        # Autoscaler scale-down: a retiring replica is out of routing
        # for good (the prober neither re-admits nor respawns it) while
        # its own SIGTERM drain finishes the queue.
        self.retiring = False
        # Drain-rate EWMA (completions/s off the balancer's pooled
        # accounting) — the weighted router's signal.  None = cold.
        self.rate_ewma: Optional[float] = None
        self._last_done_t: Optional[float] = None

    def replace_process(self, proc: subprocess.Popen, port: int,
                        timeout: float = 70.0) -> None:
        """Point this slot at a freshly spawned subprocess (respawn
        policy): new port, fresh connection pool — the old pool's
        connections name a dead port and would only feed the eject
        path."""
        old_pool = self.pool
        self.proc = proc
        self.port = int(port)
        self.pool = _ConnPool(self.host, port, timeout)
        self.last_health = {}
        self.respawns += 1
        old_pool.close_all()

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    @property
    def alive(self) -> bool:
        return self.proc is None or self.proc.poll() is None

    def describe(self) -> dict:
        return {
            "rid": self.rid, "port": self.port, "pid": self.pid,
            "healthy": self.healthy, "outstanding": self.outstanding,
            "served": self.served, "failures": self.failures,
            "respawns": self.respawns, "retiring": self.retiring,
            "drain_rate": (round(self.rate_ewma, 3)
                           if self.rate_ewma is not None else None),
            "version": self.last_health.get("version"),
        }


_RING_VNODES = 64  # virtual nodes per replica on the affinity ring


def _ring_hash(key: str) -> int:
    return int(hashlib.md5(key.encode()).hexdigest()[:16], 16)


class ReplicaSet:
    """Routing + health state over the fleet's replicas.

    ``weighted=False`` (the default, and what ``--no-autoscale`` pins)
    is the fixed fleet's router: fewest outstanding, ties round-robin.

    ``weighted=True`` scores each healthy replica by
    ``(outstanding + 1) / weight`` where weight is its drain-rate EWMA
    (completions/s measured at :meth:`release` off the balancer's own
    pooled accounting — no extra polling).  A heterogeneous fleet (bf16
    next to f32, int8 next to full precision, different batch delays)
    thus takes traffic proportional to what it actually drains.  Cold
    replicas (fresh spawn, < ``cold_min_served`` completions) weigh in
    at the fleet mean so they warm up without being dogpiled; warm
    stragglers are floored at 5% of the fastest so a wedged-but-healthy
    replica cannot starve to a weight of zero and hide from the prober;
    ejected replicas are out of the healthy set entirely — weight 0 by
    construction.

    ``session_affinity=True`` adds consistent-hash pinning: a request
    carrying ``X-DWT-Session`` routes to its key's ring owner
    (``_RING_VNODES`` virtual nodes per replica, ring rebuilt only on
    membership change, so pins survive ejection/readmission cycles).
    An ejected owner degrades that key to the weighted pick until it
    returns; a retired/removed owner remaps the key's arc permanently.
    Pinned picks bypass the load score by design — affinity trades
    balance for stickiness.
    """

    def __init__(self, replicas: Sequence[Replica],
                 weighted: bool = False,
                 session_affinity: bool = False,
                 cold_min_served: int = 8,
                 clock=time.monotonic):
        self.replicas = list(replicas)
        self.weighted = bool(weighted)
        self.session_affinity = bool(session_affinity)
        self.cold_min_served = int(cold_min_served)
        self._clock = clock
        self._lock = threading.Lock()
        self._rr = 0
        self._ring: List[tuple] = []  # sorted [(hash, replica)]
        self._rebuild_ring_locked()
        # Live metrics plane: balancer-level series (the per-replica
        # serving series ride the /metrics aggregation with a replica
        # label — see _BalancerHandler).
        reg = get_registry()
        self._m_ejections = reg.counter(
            "dwt_fleet_ejections_total",
            "replica ejections from routing", labelnames=("rid",),
        )
        reg.gauge(
            "dwt_fleet_healthy_replicas", "replicas currently routable"
        ).set_function(self.healthy_count)
        self._m_outstanding = reg.gauge(
            "dwt_fleet_replica_outstanding",
            "in-flight proxied requests per replica (scrape-time)",
            labelnames=("rid",),
        )

    # ------------------------------------------------------------ routing

    def _rebuild_ring_locked(self) -> None:
        ring = []
        for r in self.replicas:
            if r.retiring:
                continue
            for v in range(_RING_VNODES):
                ring.append((_ring_hash(f"{r.rid}#{v}"), r))
        ring.sort(key=lambda t: t[0])
        self._ring = ring

    def _ring_owner_locked(self, key: str) -> Optional[Replica]:
        if not self._ring:
            return None
        h = _ring_hash(key)
        idx = bisect.bisect_right([t[0] for t in self._ring], h)
        return self._ring[idx % len(self._ring)][1]

    def _weight_locked(self, r: Replica,
                       healthy: List[Replica]) -> float:
        known = [x.rate_ewma for x in healthy
                 if x.rate_ewma is not None
                 and x.served >= self.cold_min_served]
        if r.rate_ewma is None or r.served < self.cold_min_served:
            # Cold replica: fleet-mean weight — takes a fair share to
            # warm up, neither dogpiled nor starved.
            return sum(known) / len(known) if known else 1.0
        return max(r.rate_ewma, 0.05 * max(known))

    def pick(self, session_key: Optional[str] = None) -> Optional[Replica]:
        """A healthy replica, slot reserved (caller MUST release).

        Unweighted: fewest outstanding, ties round-robin.  Weighted:
        argmin of ``(outstanding + 1) / drain-rate weight``, ties
        round-robin.  A ``session_key`` (affinity enabled) pins to the
        ring owner while that owner is healthy."""
        with self._lock:
            healthy = [r for r in self.replicas if r.healthy]
            if not healthy:
                return None
            choice = None
            if session_key is not None and self.session_affinity:
                owner = self._ring_owner_locked(session_key)
                if owner is not None and owner.healthy:
                    choice = owner
            if choice is None:
                if not self.weighted:
                    least = min(r.outstanding for r in healthy)
                    tied = [r for r in healthy
                            if r.outstanding == least]
                else:
                    w = {id(r): self._weight_locked(r, healthy)
                         for r in healthy}
                    scores = {
                        id(r): (r.outstanding + 1) / w[id(r)]
                        for r in healthy
                    }
                    best = min(scores.values())
                    tied = [r for r in healthy
                            if scores[id(r)] == best]
                choice = tied[self._rr % len(tied)]
                self._rr += 1
            choice.outstanding += 1
            return choice

    def release(self, replica: Replica, ok: bool) -> None:
        with self._lock:
            replica.outstanding = max(0, replica.outstanding - 1)
            if ok:
                replica.served += 1
                # Drain-rate EWMA off the completion stream: the gap
                # between successive completions is 1/rate regardless
                # of how many were in flight — exactly the replica's
                # measured throughput through this balancer.
                now = self._clock()
                last = replica._last_done_t
                replica._last_done_t = now
                if last is not None and now > last:
                    inst = 1.0 / (now - last)
                    replica.rate_ewma = (
                        inst if replica.rate_ewma is None
                        else 0.8 * replica.rate_ewma + 0.2 * inst
                    )

    def eject(self, replica: Replica, reason: str) -> None:
        with self._lock:
            first = replica.healthy
            replica.healthy = False
            replica.failures += 1
        if first:
            self._m_ejections.labels(rid=str(replica.rid)).inc()
            log.warning("fleet: replica %d ejected (%s)",
                        replica.rid, reason)

    def readmit(self, replica: Replica) -> None:
        with self._lock:
            if replica.healthy:
                return
            replica.healthy = True
        log.info("fleet: replica %d re-admitted", replica.rid)

    # ------------------------------------------- autoscaler membership

    def retire(self, replica: Replica) -> None:
        """Pull a replica from routing for scale-down.  NOT an eject:
        no failure charge, no ejection metric, and the prober skips it
        entirely — its exit is expected, not a health event.  Its arc
        of the affinity ring remaps now (the pin is gone for good)."""
        with self._lock:
            replica.retiring = True
            replica.healthy = False
            self._rebuild_ring_locked()
        log.info("fleet: replica %d retiring (scale-down)", replica.rid)

    def add(self, replica: Replica) -> None:
        """Admit a freshly scaled-up replica to routing."""
        with self._lock:
            self.replicas.append(replica)
            self._rebuild_ring_locked()
        log.info("fleet: replica %d added on port %d",
                 replica.rid, replica.port)

    def remove(self, replica: Replica) -> None:
        """Drop a retired replica's slot once its drain finished."""
        with self._lock:
            self.replicas = [r for r in self.replicas
                             if r is not replica]
            self._rebuild_ring_locked()
        replica.pool.close_all()

    def healthy_count(self) -> int:
        with self._lock:
            return sum(r.healthy for r in self.replicas)

    def describe(self) -> List[dict]:
        with self._lock:
            return [r.describe() for r in self.replicas]

    def refresh_metrics(self) -> None:
        """Re-stamp the per-replica gauges (scrape-time)."""
        for d in self.describe():
            self._m_outstanding.labels(rid=str(d["rid"])).set(
                d["outstanding"]
            )


class Respawner:
    """Re-spawn dead replica subprocesses with exponential backoff.

    ``--respawn_max N``: each replica SLOT may be re-spawned at most N
    times over the fleet's life (a crash-looping artifact must not burn
    CPU forever); attempts back off exponentially
    (``backoff_s × 2^(attempt-1)``) so a replica that dies on arrival
    retries gently.  A successful respawn replaces the slot's process
    and port and lets the next healthy probe re-admit it, so a SIGKILLed
    replica does not stay ejected while the fleet silently shrinks.

    The spawn itself (subprocess start + ready-line wait, bounded by
    ``ready_timeout_s``) runs on a BACKGROUND thread: the prober's pass
    must keep probing the other replicas while a replacement compiles —
    a wedged replica elsewhere must still be ejected on schedule.
    ``spawn_fn``/``clock`` are injectable and ``background=False``
    makes the spawn synchronous (unit tests drive the backoff with a
    fake clock and a fake spawner).

    The budget/backoff arithmetic lives in
    :class:`~dwt_tpu_torch.fleet.retry.RespawnBudget` — the same policy a
    sweep control plane applies to training job slots.
    """

    def __init__(self, serve_argv: List[str], host: str = "127.0.0.1",
                 max_respawns: int = 0, backoff_s: float = 1.0,
                 ready_timeout_s: float = 120.0,
                 spawn_fn=None, clock=time.monotonic,
                 background: bool = True):
        from dwt_tpu_torch.fleet.retry import RespawnBudget

        self.serve_argv = list(serve_argv)
        self.host = host
        self.max_respawns = int(max_respawns)
        self.backoff_s = float(backoff_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self._spawn_fn = spawn_fn or (
            lambda rid, argv, h: spawn_replica(
                rid, argv, h, ready_timeout_s=self.ready_timeout_s
            )
        )
        self._budget = RespawnBudget(
            max_attempts=self.max_respawns, backoff_s=self.backoff_s,
            clock=clock,
        )
        self.background = background
        self._in_progress: set = set()  # rids with a spawn thread live
        self._m_respawns = get_registry().counter(
            "dwt_fleet_respawns_total",
            "replica subprocess respawns", labelnames=("rid",),
        )

    def exhausted_slots(self) -> List[int]:
        """Replica slots whose respawn budget is spent — the
        autoscaler's crash-loop guard reads this: while any slot is
        exhausted, rising load-per-replica is a dying config, not
        demand, and scale-up is refused."""
        return sorted(self._budget.exhausted_keys())

    def maybe_respawn(self, replica: Replica) -> bool:
        """Called by the prober on a dead replica.  Quick no-op while a
        spawn is already in flight, the backoff holds, or the budget is
        exhausted; otherwise launches the respawn (background thread by
        default — the prober must not stall on a slow-compiling
        replacement).  Returns True only when a SYNCHRONOUS spawn
        completed (``background=False``)."""
        rid = replica.rid
        if rid in self._in_progress:
            return False
        if self._budget.exhausted(rid):
            if self._budget.exhausted_first_time(rid):
                log.error(
                    "fleet: replica %d dead and respawn budget (%d) "
                    "exhausted; slot stays ejected", rid,
                    self.max_respawns,
                )
            return False
        if not self._budget.ready(rid):
            return False
        attempt = self._budget.begin(rid)
        if not self.background:
            return self._spawn_into(replica, attempt)
        self._in_progress.add(rid)
        threading.Thread(
            target=self._spawn_into, args=(replica, attempt),
            name=f"dwt-fleet-respawn-{rid}", daemon=True,
        ).start()
        return False

    def _spawn_into(self, replica: Replica, attempt: int) -> bool:
        rid = replica.rid
        # _in_progress clears only AFTER the slot swap: released between
        # the spawn and replace_process, a probe tick in that window
        # would see the old dead proc and launch a duplicate spawn —
        # two fresh subprocesses racing for one slot, the loser orphaned
        # forever on a port nothing routes to.
        try:
            try:
                fresh = self._spawn_fn(rid, self.serve_argv, self.host)
            except Exception as e:
                log.warning(
                    "fleet: respawn of replica %d failed (attempt "
                    "%d/%d): %s", rid, attempt, self.max_respawns, e,
                )
                return False
            replica.replace_process(fresh.proc, fresh.port)
            self._m_respawns.labels(rid=str(rid)).inc()
            log.info(
                "fleet: replica %d respawned on port %d (attempt %d/%d)",
                rid, replica.port, attempt, self.max_respawns,
            )
            # The next healthy probe re-admits it; routing needs no help.
            return True
        finally:
            self._in_progress.discard(rid)


class HealthProber(threading.Thread):
    """Periodic /healthz probe per replica: eject on failure, re-admit
    on recovery.  A dead subprocess is ejected and — when a
    :class:`Respawner` is armed (``--respawn_max``) — re-spawned with
    exponential backoff; without one it stays ejected permanently and
    the fleet keeps serving on the survivors."""

    def __init__(self, replicas: ReplicaSet, interval_s: float = 1.0,
                 timeout_s: float = 2.0, max_heartbeat_age_s: float = 30.0,
                 respawner: Optional[Respawner] = None):
        super().__init__(name="dwt-fleet-health", daemon=True)
        self.replicas = replicas
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.max_heartbeat_age_s = float(max_heartbeat_age_s)
        self.respawner = respawner
        self._m_probe_failures = get_registry().counter(
            "dwt_fleet_probe_failures_total",
            "failed /healthz probes", labelnames=("rid",),
        )
        # NB: not `_stop` — threading.Thread has a private method of
        # that name and shadowing it breaks join().
        self._stop_evt = threading.Event()

    def probe_once(self) -> None:
        # Snapshot: the autoscaler adds/removes replicas concurrently.
        for r in list(self.replicas.replicas):
            if r.retiring:
                # A retiring replica is draining toward an EXPECTED
                # exit: not a health event, never a respawn candidate.
                continue
            if not r.alive:
                self.replicas.eject(
                    r, f"process exited rc={r.proc.returncode}"
                )
                if self.respawner is not None:
                    # Launches the spawn on a background thread: the
                    # prober keeps probing the OTHER replicas while the
                    # replacement compiles (a wedged replica elsewhere
                    # must still be ejected on schedule).
                    self.respawner.maybe_respawn(r)
                continue
            conn = None
            try:
                conn = http.client.HTTPConnection(
                    r.host, r.port, timeout=self.timeout_s
                )
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"{}")
            except (OSError, http.client.HTTPException, ValueError) as e:
                self._m_probe_failures.labels(rid=str(r.rid)).inc()
                self.replicas.eject(r, f"probe failed: {e}")
                continue
            finally:
                if conn is not None:
                    conn.close()
            r.last_health = body
            if resp.status != 200:
                self.replicas.eject(r, f"/healthz {resp.status}")
            elif body.get("draining"):
                # A draining replica answers /healthz 200 (its dispatcher
                # is fine) but sheds every /infer with 503 — routing to
                # it turns an orderly single-replica drain into
                # client-visible errors while healthy replicas idle.
                self.replicas.eject(r, "draining")
            elif (body.get("dispatcher_heartbeat_age_s", 0.0)
                    > self.max_heartbeat_age_s
                    and body.get("queued_items", 0) > 0):
                # Wedged-but-listening: alive listener, hung dispatcher.
                self.replicas.eject(
                    r,
                    "dispatcher heartbeat age "
                    f"{body['dispatcher_heartbeat_age_s']}s with work "
                    "queued",
                )
            else:
                self.replicas.readmit(r)

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            try:
                self.probe_once()
            except Exception:
                log.exception("fleet: health probe pass failed")

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        self.join(timeout)


# --------------------------------------------------------------- HTTP front

_PROXIED = None
_SHED = None


def _proxied_counter():
    global _PROXIED
    if _PROXIED is None:
        _PROXIED = get_registry().counter(
            "dwt_fleet_proxied_total",
            "requests proxied to replicas by status class",
            labelnames=("status",),
        )
    return _PROXIED


def _shed_counter():
    global _SHED
    if _SHED is None:
        _SHED = get_registry().counter(
            "dwt_fleet_shed_total",
            "front-door shed responses (replica 429/503 passthrough + "
            "no-healthy-replica 503s) — the autoscaler's shed-rate "
            "signal",
        )
    return _SHED


class _BalancerHandler(DrainAwareHandler):
    """The balancer's front end: the serve handler's keep-alive/drain
    behavior (shared :class:`~dwt_tpu_torch.serve.http.DrainAwareHandler`
    base — one implementation of the idle wait and body-draining
    replies) plus the proxy routing."""

    # Set by make_handler:
    replicas: ReplicaSet = None       # type: ignore[assignment]
    autoscaler = None                 # Optional[Autoscaler]

    def log_message(self, fmt, *args):
        log.debug("balancer http: " + fmt, *args)

    # -------------------------------------------------------------- proxy

    def _scaling_eta_s(self) -> Optional[float]:
        """Expected-capacity ETA while the autoscaler has capacity in
        motion (spawn in flight, post-scale-up cooldown, or pressure at
        --max_replicas), else None."""
        a = self.autoscaler
        if a is None:
            return None
        try:
            return a.advise_eta_s()
        except Exception:
            return None

    def _retry_after_s(self, default_s: float) -> float:
        """The Retry-After to advise on a shed.  The queue-depth
        default assumes fixed capacity; while a scale-up is the thing
        actually being waited on, advising less than its ETA
        synchronizes client retries into a thundering herd that lands
        BEFORE the new replica does — advise the larger of the two."""
        eta = self._scaling_eta_s()
        if eta is None:
            return default_s
        return max(default_s, eta)

    def _proxy(self, method: str, path: str, body: Optional[bytes],
               headers: dict,
               session_key: Optional[str] = None) -> None:
        """Forward one request to the chosen healthy replica over a
        pooled keep-alive connection; on a connect/send failure (request
        never reached the replica) eject it and retry the next one —
        bounded by the fleet size.  A failure AFTER the send is surfaced,
        not retried: ``/infer`` is not idempotent."""
        tried = 0
        total = len(self.replicas.replicas)
        while tried < total:
            replica = self.replicas.pick(session_key=session_key)
            if replica is None:
                break
            tried += 1
            conn = replica.pool.get()
            sent = False
            t0 = time.monotonic()
            try:
                conn.request(method, path, body=body, headers=headers)
                sent = True
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                try:
                    conn.close()
                except Exception:
                    pass
                self.replicas.release(replica, ok=False)
                if sent:
                    # The replica may have served it; a retry could
                    # double-apply.  Tell the client honestly.
                    self.replicas.eject(replica, f"proxy recv failed: {e}")
                    self._reply(502, {
                        "error": f"replica {replica.rid} failed "
                        f"mid-response: {e}",
                    })
                    return
                self.replicas.eject(replica, f"proxy connect failed: {e}")
                # A pinned pick that failed to connect degrades to the
                # weighted/least-outstanding retry (the eject above
                # takes the owner out of the healthy set).
                continue  # safe retry on another replica
            replica.pool.put(conn)
            self.replicas.release(replica, ok=resp.status == 200)
            _proxied_counter().labels(
                status=f"{resp.status // 100}xx"
            ).inc()
            a = self.autoscaler
            if resp.status == 200 and a is not None:
                a.note_latency((time.monotonic() - t0) * 1e3)
            retry_after = resp.getheader("Retry-After")
            if resp.status in (429, 503):
                _shed_counter().inc()
                # An upstream shed's advice also assumes fixed
                # capacity; while scaling, stretch it to the ETA.
                eta = self._scaling_eta_s()
                if eta is not None:
                    upstream = float(retry_after or 0.0)
                    retry_after = str(int(max(upstream, eta) + 0.5))
            self.send_response(resp.status)
            self.send_header("Content-Type", "application/jsonl")
            self.send_header("Content-Length", str(len(data)))
            if retry_after:
                self.send_header("Retry-After", str(retry_after))
            self.send_header("X-DWT-Replica", str(replica.rid))
            self.end_headers()
            self.wfile.write(data)
            return
        _shed_counter().inc()
        advise_s = self._retry_after_s(1.0)
        self._reply(503, {
            "error": "no healthy replica",
            "retry_after_ms": int(advise_s * 1000),
        }, headers=[("Retry-After", str(int(advise_s + 0.5)))])

    def do_POST(self):
        body = self.read_body()  # ALWAYS, even on error paths (keep-alive)
        if self.path not in ("/infer", "/v1/infer"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        if self.draining.is_set():
            self._reply(503, {
                "error": "draining", "retry_after_ms": 1000,
            }, headers=[("Retry-After", "1")])
            return
        session_key = None
        if self.replicas.session_affinity:
            session_key = self.headers.get("X-DWT-Session") or None
        self._proxy("POST", self.path, body,
                    {"Content-Type": "application/json"},
                    session_key=session_key)

    def do_GET(self):
        if self.path == "/healthz":
            healthy = self.replicas.healthy_count()
            a = self.autoscaler
            self._reply(200 if healthy > 0 else 503, {
                "ok": healthy > 0,
                "draining": bool(self.draining.is_set()),
                "healthy_replicas": healthy,
                # The autoscaler's desired count (= healthy once every
                # spawn/drain settles): the ramp bench stamps its
                # time-to-first-scale-up off this.
                "target_replicas": (a.target if a is not None
                                    else len(self.replicas.replicas)),
                "autoscale": a is not None,
                "replicas": self.replicas.describe(),
            })
        elif self.path == "/stats":
            # Aggregate: fleet-level counts + each replica's own /stats
            # (proxied with a short timeout; an unreachable replica
            # reports its describe() only).
            out = {"kind": "fleet_stats",
                   "replicas": self.replicas.describe(), "stats": {}}
            for r in self.replicas.replicas:
                if not r.healthy:
                    continue
                try:
                    conn = http.client.HTTPConnection(
                        r.host, r.port, timeout=2.0
                    )
                    conn.request("GET", "/stats")
                    resp = conn.getresponse()
                    out["stats"][str(r.rid)] = json.loads(resp.read())
                    conn.close()
                except (OSError, http.client.HTTPException, ValueError):
                    pass
            self._reply(200, out)
        elif self.path == "/metrics":
            self._reply_metrics()
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _reply_metrics(self) -> None:
        """Fleet-aggregating exposition: the balancer's own registry
        (routing, ejections, respawns, probe failures) merged with every
        HEALTHY replica's /metrics, each replica's samples re-labeled
        ``replica="<rid>"`` — one scrape tells the whole fleet's story.
        An unreachable replica contributes nothing (its absence IS the
        signal; ``dwt_fleet_healthy_replicas`` says so explicitly)."""
        import concurrent.futures

        from dwt_tpu_torch.obs import prom

        self.replicas.refresh_metrics()

        def fetch(r: Replica):
            try:
                conn = http.client.HTTPConnection(
                    r.host, r.port, timeout=2.0
                )
                conn.request("GET", "/metrics")
                resp = conn.getresponse()
                text = resp.read().decode()
                conn.close()
            except (OSError, http.client.HTTPException) as e:
                log.warning(
                    "fleet: /metrics passthrough from replica %d "
                    "failed: %s", r.rid, e,
                )
                return None
            return text if resp.status == 200 else None

        # Fetch replicas CONCURRENTLY: slow-but-listening replicas each
        # burn their full 2 s timeout, and a sequential pass over a
        # degraded fleet would blow a scraper's own deadline exactly
        # when the fleet view matters most — the scrape is bounded by
        # the slowest single replica, not the sum.
        healthy = [r for r in self.replicas.replicas if r.healthy]
        parts = [({}, prom.render())]
        if healthy:
            with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, len(healthy))
            ) as pool:
                for r, text in zip(healthy, pool.map(fetch, healthy)):
                    if text is not None:
                        parts.append(({"replica": str(r.rid)}, text))
        self._reply_text(
            200, prom.merge_expositions(parts), prom.CONTENT_TYPE
        )


def make_handler(replicas: ReplicaSet, draining: threading.Event,
                 autoscaler=None):
    return type("BalancerHandler", (_BalancerHandler,), {
        "replicas": replicas, "draining": draining,
        "autoscaler": autoscaler,
    })


# ------------------------------------------------------------ fleet spawn

def _per_replica_argv(rid: int, serve_argv: List[str]) -> List[str]:
    """Rewrite ``--access_log PATH`` to ``PATH.r<rid>`` so every replica
    owns its own access-log trail (the file opens in append mode, so a
    respawn of the same slot continues the slot's history).  Without
    this, N replicas interleave writes into one JSONL and every
    retirement-audit assertion is meaningless."""
    argv = list(serve_argv)
    for i, arg in enumerate(argv):
        if arg == "--access_log" and i + 1 < len(argv):
            argv[i + 1] = f"{argv[i + 1]}.r{rid}"
            break
        if arg.startswith("--access_log="):
            argv[i] = f"{arg}.r{rid}"
            break
    return argv


def _replica_env(rid: int) -> Optional[dict]:
    """The environment of replica ``rid``'s process: the fleet's own,
    except for the fault plan.  The straggler ``take_replica_slow(rid)``
    names runs with that plan alone (the JAX fleet's
    ``take_sweep_job_fault`` pattern); every other replica runs with the
    fleet's plan less its ``replica_slow_at``, which is the fleet's to
    hand out — inherited, it would slow every replica (the JAX fleet
    passes it on unchanged).  None: the fleet's environment as it is."""
    from dwt_tpu_torch.resilience import inject

    slow_plan = inject.take_replica_slow(rid)
    if slow_plan is not None:
        env = dict(os.environ)
        env[inject.ENV_VAR] = json.dumps(slow_plan)
        return env
    raw = os.environ.get(inject.ENV_VAR)
    if not raw:
        return None
    spec = json.loads(raw)
    if not isinstance(spec, dict) or "replica_slow_at" not in spec:
        return None
    spec.pop("replica_slow_at")
    env = dict(os.environ)
    if spec:
        env[inject.ENV_VAR] = json.dumps(spec)
    else:
        env.pop(inject.ENV_VAR)
    return env


def spawn_replica(rid: int, serve_argv: List[str],
                  host: str = "127.0.0.1",
                  ready_timeout_s: float = 300.0) -> Replica:
    """Start one ``python -m dwt_tpu_torch.serve.server`` subprocess on an
    ephemeral port and wait for its ``serve_ready`` line (which carries
    the bound port).  The server's ``--device`` (CUDA by default) comes in
    ``serve_argv``.  Stdout is read only until that line: the server
    writes one more line (``serve_summary``) when it drains, well inside
    the pipe's buffer."""
    cmd = [sys.executable, "-m", "dwt_tpu_torch.serve.server",
           "--host", host, "--port", "0",
           *_per_replica_argv(rid, serve_argv)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_replica_env(rid),
    )
    deadline = time.monotonic() + ready_timeout_s
    line = ""
    while time.monotonic() < deadline:
        # select before readline: a replica wedged BEFORE printing
        # anything (stuck restore/compile) must hit the deadline, not
        # block fleet startup forever inside a blocking readline.
        ready_fds, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready_fds:
            continue
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(
                f"replica {rid} exited before ready "
                f"(rc={proc.poll()}): {' '.join(cmd)}"
            )
        try:
            ready = json.loads(line)
        except ValueError:
            continue  # stray logging on stdout
        if ready.get("kind") == "serve_ready":
            log.info("fleet: replica %d ready on port %d (version %s, "
                     "device %s)", rid, ready["port"], ready.get("version"),
                     ready.get("device"))
            return Replica(rid, host, ready["port"], proc=proc)
    proc.kill()
    raise RuntimeError(f"replica {rid} not ready within "
                       f"{ready_timeout_s}s (last line: {line!r})")


def drain_fleet(replicas: Sequence[Replica], timeout_s: float = 120.0) -> int:
    """SIGTERM every live replica, wait for their graceful drains.
    Returns the number that exited nonzero/not-at-all (0 = clean)."""
    for r in replicas:
        if r.proc is not None and r.proc.poll() is None:
            r.proc.send_signal(signal.SIGTERM)
    bad = 0
    deadline = time.monotonic() + timeout_s
    for r in replicas:
        if r.proc is None:
            continue
        try:
            rc = r.proc.wait(max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            log.error("fleet: replica %d did not drain; killing", r.rid)
            r.proc.kill()
            bad += 1
            continue
        if rc != 0 and r.healthy:
            # An already-ejected replica (SIGKILLed, crashed) has told
            # its story; only a LIVE replica failing its drain is news.
            log.error("fleet: replica %d drain exited rc=%d", r.rid, rc)
            bad += 1
        r.pool.close_all()
    return bad


# ---------------------------------------------------------------- CLI

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="the port's fleet: N replicas of python -m "
        "dwt_tpu_torch.serve.server sharing one ckpt_dir watch behind a "
        "least-outstanding-requests load balancer",
        epilog="All arguments after '--' are passed through to every "
        "replica's server (e.g. python -m dwt_tpu_torch.fleet.balancer "
        "--replicas 2 -- --ckpt_dir runs/x --model lenet --watch); the "
        "replicas run on CUDA unless they get --device cpu.",
    )
    p.add_argument("--replicas", type=int, default=2,
                   help="serving replica subprocesses to spawn")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8979,
                   help="balancer port (0 = ephemeral)")
    p.add_argument("--health_interval_s", type=float, default=1.0,
                   help="per-replica /healthz probe period")
    p.add_argument("--max_heartbeat_age_s", type=float, default=30.0,
                   help="eject a replica whose dispatcher heartbeat age "
                        "exceeds this while work is queued (wedged-but-"
                        "listening)")
    p.add_argument("--respawn_max", type=int, default=0,
                   help=">0: re-spawn a dead (e.g. SIGKILLed) replica "
                        "subprocess up to this many times per slot, "
                        "with exponential backoff, instead of leaving "
                        "it permanently ejected.  0 = legacy behavior "
                        "(the fleet survives but shrinks)")
    p.add_argument("--respawn_backoff_s", type=float, default=1.0,
                   help="base respawn backoff; attempt k waits "
                        "backoff * 2^(k-1) after the previous attempt")
    # ------------------------------------------------- autoscaling
    p.add_argument("--no-autoscale", dest="no_autoscale",
                   action="store_true",
                   help="kill switch: fixed-N fleet with the legacy "
                        "least-outstanding round-robin-tie router (no "
                        "control loop, no weighted routing)")
    p.add_argument("--min_replicas", type=int, default=None,
                   help="autoscaler floor (default: --replicas)")
    p.add_argument("--max_replicas", type=int, default=None,
                   help="autoscaler ceiling (default: --replicas — "
                        "i.e. pinned unless raised)")
    p.add_argument("--scale_interval_s", type=float, default=2.0,
                   help="control-loop sampling cadence")
    p.add_argument("--scale_cooldown_s", type=float, default=15.0,
                   help="refractory period after every scale action")
    p.add_argument("--scale_pressure", type=float, default=4.0,
                   help="scale-up pressure threshold: queued + "
                        "outstanding requests per healthy replica")
    p.add_argument("--scale_idle", type=float, default=0.5,
                   help="scale-down idle threshold (same units)")
    p.add_argument("--scale_pressure_for_s", type=float, default=4.0,
                   help="pressure must hold this long before scale-up "
                        "(rules-engine hysteresis, not raw samples)")
    p.add_argument("--scale_idle_for_s", type=float, default=20.0,
                   help="idle must hold this long before scale-down")
    p.add_argument("--scale_shed_per_s", type=float, default=0.5,
                   help="scale-up when the front door sheds more than "
                        "this many requests/s (sustained)")
    p.add_argument("--slo_p99_ms", type=float, default=0.0,
                   help=">0: scale-up when the proxied p99 exceeds "
                        "this SLO (sustained)")
    p.add_argument("--scale_up_max", type=int, default=8,
                   help="scale-up attempt budget (successful spawns "
                        "are refunded; crash-looping ones are not)")
    p.add_argument("--session_affinity", action="store_true",
                   help="pin X-DWT-Session keys to a consistent-hash "
                        "ring owner (degrades to weighted routing "
                        "while the owner is ejected)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO)
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        own, serve_argv = argv[:split], argv[split + 1:]
    else:
        own, serve_argv = argv, []
    args = build_parser().parse_args(own)
    if args.replicas < 1:
        raise SystemExit("fleet: need at least one replica")
    min_replicas = (args.replicas if args.min_replicas is None
                    else args.min_replicas)
    max_replicas = (args.replicas if args.max_replicas is None
                    else args.max_replicas)
    if not args.no_autoscale and not (
            1 <= min_replicas <= args.replicas <= max_replicas):
        raise SystemExit(
            f"fleet: need 1 <= --min_replicas ({min_replicas}) <= "
            f"--replicas ({args.replicas}) <= --max_replicas "
            f"({max_replicas})"
        )

    replicas = []
    try:
        for rid in range(args.replicas):
            replicas.append(spawn_replica(rid, serve_argv, args.host))
    except Exception:
        for r in replicas:
            if r.proc is not None:
                r.proc.kill()
        raise
    # --no-autoscale pins the fixed fleet bit for bit: unweighted
    # least-outstanding routing, fixed N, no control loop.
    rset = ReplicaSet(
        replicas,
        weighted=not args.no_autoscale,
        session_affinity=args.session_affinity,
    )
    respawner = None
    if args.respawn_max > 0:
        respawner = Respawner(
            serve_argv, host=args.host,
            max_respawns=args.respawn_max,
            backoff_s=args.respawn_backoff_s,
        )
    prober = HealthProber(
        rset, args.health_interval_s,
        max_heartbeat_age_s=args.max_heartbeat_age_s,
        respawner=respawner,
    )
    prober.start()

    autoscaler = None
    if not args.no_autoscale:
        from dwt_tpu_torch.fleet.autoscale import Autoscaler

        autoscaler = Autoscaler(
            rset,
            spawn_fn=lambda rid: spawn_replica(rid, serve_argv, args.host),
            min_replicas=min_replicas,
            max_replicas=max_replicas,
            interval_s=args.scale_interval_s,
            pressure_hi=args.scale_pressure,
            idle_lo=args.scale_idle,
            pressure_for_s=args.scale_pressure_for_s,
            idle_for_s=args.scale_idle_for_s,
            cooldown_s=args.scale_cooldown_s,
            shed_hi_per_s=args.scale_shed_per_s,
            slo_p99_ms=args.slo_p99_ms,
            scale_up_max=args.scale_up_max,
            respawner=respawner,
            events=lambda rec: print(json.dumps(rec), flush=True),
        )
        autoscaler.start()

    draining = threading.Event()

    def _handle(signum, frame):  # flag-only (resilience handler pattern)
        draining.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _handle)

    class _Server(ThreadingHTTPServer):
        daemon_threads = False

    httpd = _Server(
        (args.host, args.port),
        make_handler(rset, draining, autoscaler=autoscaler),
    )
    http_thread = threading.Thread(
        target=httpd.serve_forever, name="dwt-fleet-http", daemon=True
    )
    http_thread.start()
    print(json.dumps({
        "kind": "fleet_ready",
        "host": args.host, "port": httpd.server_address[1],
        "autoscale": autoscaler is not None,
        "min_replicas": min_replicas, "max_replicas": max_replicas,
        "replicas": [
            {"rid": r.rid, "port": r.port, "pid": r.pid}
            for r in replicas
        ],
    }), flush=True)

    draining.wait()
    log.info("fleet drain: SIGTERM/SIGINT received")
    # Half-close order mirrors the single server: stop admitting (the
    # handler answers 503 + Retry-After), stop the control loop (a
    # fleet-wide drain must not race a scale decision), stop health
    # probes (a replica mid-drain answering nothing is not a health
    # event), drain every replica's own queue via ITS SIGTERM path,
    # then stop the front end.
    if autoscaler is not None:
        autoscaler.stop()
    prober.stop()
    # The autoscaler may have grown/shrunk the fleet: drain the LIVE
    # membership, not the boot-time list (a retired slot mid-drain is
    # still in rset until its exit is verified — SIGTERMing it again
    # is idempotent).
    bad = drain_fleet(list(rset.replicas))
    httpd.shutdown()
    http_thread.join(timeout=10)
    httpd.server_close()
    summary = {
        "kind": "fleet_summary",
        "replicas": rset.describe(),
        "unclean_drains": bad,
    }
    if autoscaler is not None:
        summary["target_replicas"] = autoscaler.target
    print(json.dumps(summary), flush=True)
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
