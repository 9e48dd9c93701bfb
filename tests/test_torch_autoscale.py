"""The port's autoscaler, respawn budget, fleet fault kinds and load generator against the JAX package.

Every case drives the live JAX module and its port with the same inputs
and compares what comes out: the same fake-clock signal trace through
both ``Autoscaler``s gives the same ``ScaleDecision`` sequence (action,
reason, target), the same lifecycle events and the same retry advice;
``RespawnBudget`` the same backoff schedule; the same bad bounds and bad
``traffic_spike``/``replica_slow_at`` plans are refused with the same
messages; ``_apply_spike`` gives bitwise-equal Poisson gaps, and the ramp
parse and schedule agree.  Nothing here starts a process (the fleet's
subprocess cases are in ``tests/test_torch_balancer.py``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import threading
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dwt_tpu.fleet import autoscale as jax_autoscale
from dwt_tpu.fleet import balancer as jax_balancer
from dwt_tpu.fleet import retry as jax_retry
from dwt_tpu.obs import registry as jax_registry
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu_torch.fleet import autoscale, balancer, retry
from dwt_tpu_torch.obs import registry
from dwt_tpu_torch.resilience import inject

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = SimpleNamespace(name="jax", balancer=jax_balancer, autoscale=jax_autoscale,
                      registry=jax_registry, inject=jax_inject, retry=jax_retry)
PORT = SimpleNamespace(name="port", balancer=balancer, autoscale=autoscale,
                       registry=registry, inject=inject, retry=retry)


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_BENCH = _load_tool("serve_bench")
PORT_BENCH = _load_tool("torch_serve_bench")


@pytest.fixture(autouse=True)
def _clean_state():
    """Each case starts with both packages' fault plans disarmed and no
    alert firing in either registry (an earlier test's engine could have
    left one, which the autoscaler reads as external pressure)."""
    for pkg in (JAX, PORT):
        pkg.inject.disarm()
        pkg.registry.get_registry().gauge(
            "dwt_alerts_firing", labelnames=("alertname", "severity")).clear()
    yield
    for pkg in (JAX, PORT):
        pkg.inject.disarm()


class _Clock:
    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _replica(pkg, rid: int, port: int = 9500):
    return pkg.balancer.Replica(rid, "127.0.0.1", port + rid)


def _scaler(pkg, rset, clock, events, spawn_fn=None, **kw):
    if spawn_fn is None:
        def spawn_fn(rid):
            return _replica(pkg, rid)
    kw.setdefault("min_replicas", 2)
    kw.setdefault("max_replicas", 4)
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("pressure_hi", 4.0)
    kw.setdefault("idle_lo", 0.5)
    kw.setdefault("pressure_for_s", 2.0)
    kw.setdefault("idle_for_s", 3.0)
    kw.setdefault("cooldown_s", 4.0)
    return pkg.autoscale.Autoscaler(rset, spawn_fn, clock=clock, events=events.append, **kw)


def _load(rset, outstanding: int) -> None:
    for r in rset.replicas:
        if r.healthy and not r.retiring:
            r.outstanding = outstanding


def _decision(d):
    return (d.action, d.reason, d.target)


# ------------------------------------------------------------ the scenarios
# Each takes a package and returns what the run produced: the decisions,
# the events, the surviving replicas, and whatever else the case reads.


def _staircase(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events)
    seq = []
    for t in range(12):
        clock.t = float(t)
        _load(rset, 10)
        seq.append(_decision(a.tick()))
    reg = pkg.registry.get_registry()
    return seq, events, [r.rid for r in rset.replicas], reg.value("dwt_fleet_target_replicas")


def _flapping(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events)
    seq = []
    for t in range(10):
        clock.t = float(t)
        _load(rset, 10 if t % 2 == 0 else 0)
        seq.append(_decision(a.tick()))
    return seq, events, a.target


def _idle_down(pkg):
    clock, events = _Clock(), []
    replicas = [_replica(pkg, i) for i in range(4)]
    replicas[0].outstanding = 1  # the busiest: never the victim
    rset = pkg.balancer.ReplicaSet(replicas, weighted=True)
    a = _scaler(pkg, rset, clock, events)
    seq = []
    for t in range(16):
        clock.t = float(t)
        seq.append(_decision(a.tick()))
    clock.t = 30.0
    seq.append(_decision(a.tick()))
    return seq, events, sorted(r.rid for r in rset.replicas), a.target


def _victim(pkg):
    clock, events = _Clock(), []
    replicas = [_replica(pkg, i) for i in range(3)]
    replicas[0].last_health = {"queued_items": 0, "in_flight_batches": 0}
    replicas[1].last_health = {"queued_items": 1, "in_flight_batches": 0}
    replicas[2].last_health = {"in_flight_batches": 1}
    rset = pkg.balancer.ReplicaSet(replicas, weighted=True)
    a = _scaler(pkg, rset, clock, events, min_replicas=2, max_replicas=4)
    seq = []
    for t in range(6):
        clock.t = float(t)
        seq.append(_decision(a.tick()))
    return seq, events


def _bad_spawn(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)

    def bad_spawn(rid):
        raise RuntimeError("boom")

    a = _scaler(pkg, rset, clock, events, spawn_fn=bad_spawn, scale_up_max=2,
                cooldown_s=0.0)
    seq = []
    for t in range(40):
        clock.t = float(t)
        _load(rset, 10)
        seq.append(_decision(a.tick()))
    return seq, events, a.target


def _forgiven(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events, scale_up_max=1, cooldown_s=1.0, max_replicas=6)
    seq = []
    for t in range(20):
        clock.t = float(t)
        _load(rset, 10)
        seq.append(_decision(a.tick()))
    return seq, events, a.target


def _exhausted_respawner(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)

    class _Respawner:
        def exhausted_slots(self):
            return [0]

    a = _scaler(pkg, rset, clock, events, respawner=_Respawner())
    seq = []
    for t in range(5):
        clock.t = float(t)
        _load(rset, 10)
        seq.append(_decision(a.tick()))
    return seq, events, a.target


def _external_alert(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events, pressure_for_s=2.0)
    g = pkg.registry.get_registry().gauge("dwt_alerts_firing",
                                          labelnames=("alertname", "severity"))
    seq = []
    for t in range(4):
        clock.t = float(t)
        g.labels(alertname="replica_dead", severity="critical").set(1)
        seq.append(_decision(a.tick()))
    g.clear()
    # The loop's own rule name echoed in the shared gauge is no pressure.
    clock2, events2 = _Clock(), []
    rset2 = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a2 = _scaler(pkg, rset2, clock2, events2)
    for t in range(4):
        clock2.t = float(t)
        g.labels(alertname="fleet_pressure", severity="warning").set(1)
        seq.append(_decision(a2.tick()))
    g.clear()
    return seq, events, events2, a.target, a2.target


def _eta(pkg):
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events, max_replicas=3, interval_s=2.0,
                ready_wait_seed_s=8.0)
    advice = [a.advise_eta_s(), a.capacity_eta_s()]
    seq = []
    for t in range(12):
        clock.t = float(t)
        _load(rset, 10)
        seq.append(_decision(a.tick()))
        advice.append(a.advise_eta_s())
    _load(rset, 0)
    clock.t = 13.0
    seq.append(_decision(a.tick()))
    advice += [a.advise_eta_s(), a.ready_wait_ewma_s]
    return seq, events, advice


def _shed_and_p99(pkg):
    """Pressure from the front door's shed counter and the proxied p99
    against an SLO (the latency ring needs 20 samples)."""
    clock, events = _Clock(), []
    rset = pkg.balancer.ReplicaSet([_replica(pkg, 0), _replica(pkg, 1)], weighted=True)
    a = _scaler(pkg, rset, clock, events, slo_p99_ms=50.0, max_replicas=6,
                cooldown_s=1.0)
    shed = pkg.registry.get_registry().counter("dwt_fleet_shed_total", "front-door sheds")
    seq = []
    for t in range(8):
        clock.t = float(t)
        shed.inc(3)  # 3/s > shed_hi_per_s 0.5
        seq.append(_decision(a.tick()))
    for _ in range(30):
        a.note_latency(120.0)
    for t in range(8, 16):
        clock.t = float(t)
        seq.append(_decision(a.tick()))
    return seq, events, a.target


SCENARIOS = {
    "staircase": _staircase, "flapping": _flapping, "idle_down": _idle_down,
    "least_loaded_victim": _victim, "spawn_failures": _bad_spawn,
    "budget_forgiven": _forgiven, "respawner_exhausted": _exhausted_respawner,
    "external_alert": _external_alert, "retry_advice": _eta,
    "shed_and_p99": _shed_and_p99,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscaler_decisions_and_events_match_jax(name):
    """The same fake-clock trace through both autoscalers: equal
    decisions (action, reason, target), lifecycle events, retry advice
    and surviving replicas."""
    ours, ref = SCENARIOS[name](PORT), SCENARIOS[name](JAX)
    assert ours == ref
    # Flapping load must never act (the hysteresis); every other scenario
    # acts or blocks at least once, or the trace would hold nothing.
    acted = any(d[0] is not None for d in ours[0])
    assert acted == (name != "flapping"), ours[0]


def test_autoscaler_metrics_follow_the_staircase():
    _staircase(PORT)
    reg = registry.get_registry()
    assert reg.value("dwt_fleet_target_replicas") == 4
    assert reg.value("dwt_fleet_scale_events_total",
                     {"direction": "up", "reason": "queue_pressure"}) >= 2


@pytest.mark.parametrize("lo,hi", [(3, 2), (0, 2), (1, 0)])
def test_autoscaler_bounds_refused_alike(lo, hi):
    def err(pkg):
        rset = pkg.balancer.ReplicaSet([_replica(pkg, 0)])
        with pytest.raises(ValueError) as e:
            _scaler(pkg, rset, _Clock(), [], min_replicas=lo, max_replicas=hi)
        return str(e.value)

    assert err(PORT) == err(JAX)


# ------------------------------------------------------------- RespawnBudget


def _budget_schedule(pkg):
    clock = _Clock()
    b = pkg.retry.RespawnBudget(max_attempts=3, backoff_s=0.5, clock=clock)
    out = []
    for t in np.arange(0.0, 8.0, 0.25):
        clock.t = float(t)
        ready = b.ready("r0")
        row = [float(t), ready, b.attempts("r0"), b.exhausted("r0"),
               b.exhausted_first_time("r0")]
        if ready:
            row.append(b.begin("r0"))
        out.append(row)
    out.append(("free", b.begin("r1", count=False), b.attempts("r1")))
    out.append(("keys", b.exhausted_keys()))
    b.forgive("r0")
    out.append(("forgiven", b.attempts("r0"), b.exhausted("r0"), b.ready("r0")))
    b.restore("r2", 5)
    out.append(("restored", b.exhausted_keys(), b.exhausted_first_time("r2"),
                b.exhausted_first_time("r2")))
    return out


def test_respawn_budget_backoff_schedule_matches_jax():
    ours = _budget_schedule(PORT)
    assert ours == _budget_schedule(JAX)
    begins = [row[0] for row in ours if isinstance(row[0], float) and len(row) == 6]
    assert begins == [0.0, 0.5, 1.5]  # backoff 0.5 × 2^(k-1)


def _respawner_trace(pkg):
    """``Respawner`` with a fake spawner and clock (synchronous): the
    attempts it makes against a replica that stays dead, and the
    exhausted slots it reports."""
    clock = _Clock()
    spawned = []

    class _Proc:
        def poll(self):
            return None

    def spawn_fn(rid, argv, host):
        spawned.append((rid, clock.t))
        return SimpleNamespace(proc=_Proc(), port=7000 + len(spawned))

    rs = pkg.balancer.Respawner(["--model", "lenet"], max_respawns=2, backoff_s=1.0,
                                spawn_fn=spawn_fn, clock=clock, background=False)
    r = _replica(pkg, 0)
    results = []
    for t in np.arange(0.0, 6.0, 0.5):
        clock.t = float(t)
        results.append(rs.maybe_respawn(r))
    return spawned, results, r.respawns, r.port, rs.exhausted_slots()


def test_respawner_backoff_matches_jax():
    ours = _respawner_trace(PORT)
    assert ours == _respawner_trace(JAX)
    assert [t for _, t in ours[0]] == [0.0, 1.0] and ours[4] == [0]


# ---------------------------------------------------------- fault-plan kinds

FLEET_PLANS = [
    {"traffic_spike": {"at_request": 10, "factor": 4.0},
     "replica_slow_at": {"rid": 1, "sleep_s": 0.05}},
    {"traffic_spike": {"factor": 2.0}},
    {"traffic_spike": {"factor": 1.0}},
    {"traffic_spike": {"factor": 0.0}},
    {"traffic_spike": {"factor": -2.0}},
    {"traffic_spike": {"factor": float("inf")}},
    {"traffic_spike": {"factor": True}},
    {"traffic_spike": {}},
    {"traffic_spike": {"factor": 2.0, "nope": 1}},
    {"traffic_spike": {"at_request": -1, "factor": 2.0}},
    {"traffic_spike": {"at_request": 1.5, "factor": 2.0}},
    {"traffic_spike": [10, 2.0]},
    {"replica_slow_at": {"rid": 0}},
    {"replica_slow_at": {"sleep_s": 0.1}},
    {"replica_slow_at": {"rid": -1, "sleep_s": 0.1}},
    {"replica_slow_at": {"rid": True, "sleep_s": 0.1}},
    {"replica_slow_at": {"rid": 0, "sleep_s": 0.0}},
    {"replica_slow_at": {"rid": 0, "sleep_s": 0.1, "x": 1}},
    {"replica_slow_at": "slow"},
]


def _plan_outcome(pkg, spec):
    try:
        plan = pkg.inject.FaultPlan.from_spec(spec)
    except ValueError as e:
        return "refused", str(e)
    return "accepted", (plan.traffic_spike, plan.replica_slow_at)


@pytest.mark.parametrize("spec", FLEET_PLANS, ids=lambda s: json.dumps(s))
def test_fleet_fault_kinds_accepted_and_refused_as_jax(spec):
    assert _plan_outcome(PORT, spec) == _plan_outcome(JAX, spec)


def _take_slow(pkg):
    pkg.inject.arm(pkg.inject.FaultPlan.from_spec(
        {"replica_slow_at": {"rid": 2, "sleep_s": 0.05}}))
    out = [pkg.inject.take_replica_slow(0), pkg.inject.take_replica_slow(2),
           pkg.inject.take_replica_slow(2)]
    pkg.inject.disarm()
    return out


def test_take_replica_slow_one_shot_and_rid_match_as_jax():
    ours = _take_slow(PORT)
    assert ours == _take_slow(JAX)
    assert ours == [None, {"replica_slow_at": {"rid": 2, "sleep_s": 0.05}}, None]


def test_maybe_replica_slow_sleeps_only_while_armed(monkeypatch):
    slept = []
    monkeypatch.setattr(inject.time, "sleep", slept.append)
    inject.maybe_replica_slow()
    inject.arm(inject.FaultPlan.from_spec({"replica_slow_at": {"rid": 0, "sleep_s": 0.25}}))
    inject.maybe_replica_slow()
    inject.maybe_replica_slow()
    assert slept == [0.25, 0.25]  # persistent inside the replica


def test_replica_env_hands_the_straggler_plan_to_its_replica_alone(monkeypatch):
    """The fleet's plan names replica 1: its spawn environment carries
    that plan alone, once; the other replicas' carry the rest of the
    fleet's plan without it (inherited, it would slow every replica)."""
    plan = {"replica_slow_at": {"rid": 1, "sleep_s": 0.05},
            "serve_drift_shift": {"at_request": 0, "offset": 0.5}}
    monkeypatch.setenv(inject.ENV_VAR, json.dumps(plan))
    inject._env_checked = False
    env0 = balancer._replica_env(0)
    env1 = balancer._replica_env(1)
    respawn1 = balancer._replica_env(1)
    assert json.loads(env0[inject.ENV_VAR]) == {"serve_drift_shift": plan["serve_drift_shift"]}
    assert json.loads(env1[inject.ENV_VAR]) == {"replica_slow_at": plan["replica_slow_at"]}
    assert inject.ENV_VAR in respawn1 and "replica_slow_at" not in respawn1[inject.ENV_VAR]
    monkeypatch.setenv(inject.ENV_VAR, json.dumps({"replica_slow_at": plan["replica_slow_at"]}))
    assert inject.ENV_VAR not in balancer._replica_env(0)
    monkeypatch.delenv(inject.ENV_VAR)
    assert balancer._replica_env(0) is None


# ------------------------------------------------------------ load generator


@pytest.mark.parametrize("spike", [None, {"at_request": 4, "factor": 2.0},
                                   {"at_request": 0, "factor": 3.5},
                                   {"at_request": 500, "factor": 0.25}])
def test_apply_spike_gives_bitwise_equal_gaps(spike):
    """The arrival process of both tools: ``default_rng(seed)`` gaps,
    then the armed spike folded in; bitwise equal."""
    def gaps(pkg, tool):
        if spike is not None:
            pkg.inject.arm(pkg.inject.FaultPlan.from_spec({"traffic_spike": spike}))
        g = np.random.default_rng(7).exponential(1.0 / 40.0, size=300)
        tool._apply_spike(g)
        pkg.inject.disarm()
        return g

    ours, ref = gaps(PORT, PORT_BENCH), gaps(JAX, JAX_BENCH)
    assert ours.tobytes() == ref.tobytes()
    if spike is not None and spike["at_request"] < 300:
        plain = np.random.default_rng(7).exponential(1.0 / 40.0, size=300)
        at = spike["at_request"]
        assert np.array_equal(ours[:at], plain[:at])
        assert np.array_equal(ours[at:], plain[at:] / spike["factor"])


@pytest.mark.parametrize("spec", ["100:400:5", "0.5:3:10", "2:2:1", "100:400",
                                  "0:400:5", "400:100:5", "100:400:0", "x:y:z"])
def test_ramp_parse_and_schedule_match_jax(spec):
    def outcome(tool):
        try:
            lo, hi, step_s = tool._parse_ramp(spec)
        except ValueError as e:
            return "refused", str(e)
        return (lo, hi, step_s), tool._ramp_schedule(lo, hi)

    assert outcome(PORT_BENCH) == outcome(JAX_BENCH)


@pytest.mark.parametrize("argv", [
    [], ["--replicas", "3", "--max_replicas", "5", "--scale_interval_s", "0.5",
         "--session_affinity"],
    ["--no-autoscale", "--respawn_max", "2", "--respawn_backoff_s", "0.2"],
    ["--min_replicas", "1", "--slo_p99_ms", "80", "--scale_up_max", "3",
     "--health_interval_s", "0.3", "--max_heartbeat_age_s", "5"],
])
def test_fleet_flags_parse_as_jax(argv):
    assert vars(balancer.build_parser().parse_args(argv)) == \
        vars(jax_balancer.build_parser().parse_args(argv))


def test_fleet_refuses_bad_replica_bounds_as_jax():
    for argv in (["--replicas", "3", "--max_replicas", "2", "--", "--device", "cpu"],
                 ["--replicas", "0"]):
        with pytest.raises(SystemExit) as ours:
            balancer.main(argv)
        with pytest.raises(SystemExit) as ref:
            jax_balancer.main(argv)
        assert str(ours.value).split(": ", 1)[1] == str(ref.value).split(": ", 1)[1]


def test_front_door_retry_after_uses_capacity_eta():
    """No healthy replica: the 503's Retry-After is the autoscaler's
    capacity ETA, and without an autoscaler the 1 s default."""
    import http.client

    class _StubScaler:
        target = 1

        def advise_eta_s(self):
            return 7.0

        def note_latency(self, ms):
            pass

    for scaler, want_ms in ((_StubScaler(), 7000), (None, 1000)):
        r = balancer.Replica(0, "127.0.0.1", 1)  # nothing listening
        rset = balancer.ReplicaSet([r])
        rset.eject(r, "test")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    balancer.make_handler(rset, threading.Event(),
                                                          autoscaler=scaler))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=10)
            conn.request("POST", "/infer", json.dumps({"inputs": [[0.0]]}).encode(),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            payload = json.loads(resp.read())
            assert resp.status == 503 and payload["retry_after_ms"] == want_ms
            assert resp.getheader("Retry-After") == str(want_ms // 1000)
            conn.request("GET", "/healthz")
            health = json.loads(conn.getresponse().read())
            assert health["autoscale"] == (scaler is not None)
            assert health["target_replicas"] == 1
            conn.close()
        finally:
            httpd.shutdown()
            httpd.server_close()


def test_bench_reload_every_swaps_the_newest_checkpoint_under_load(tmp_path, capsys):
    """``--reload_every``: the tool's swap thread force-redeploys the newest
    checkpoint (``HotReloader.reload_newest(force=True)``) during the load;
    the record counts the swaps, and no request errs or sheds."""
    from dwt_tpu_torch.cli import usps_mnist

    ckpt = str(tmp_path / "digits")
    usps_mnist.main(["--synthetic", "--synthetic_size", "32", "--source_batch_size", "16",
                     "--target_batch_size", "16", "--group_size", "4", "--epochs", "1",
                     "--num_workers", "0", "--device", "cpu", "--ckpt_dir", ckpt])
    capsys.readouterr()
    PORT_BENCH.main(["--model", "lenet", "--ckpt_dir", ckpt, "--device", "cpu",
                     "--loads", "40", "--duration_s", "1.5", "--reload_every", "0.3"])
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["kind"] == "serve_bench" and record["swaps"] >= 1
    assert record["errors"] == 0 and record["shed"] == 0 and record["served"] > 0
