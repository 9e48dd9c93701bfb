"""The port's fleet balancer (``dwt_tpu_torch.fleet.balancer``) against the JAX package's.

In process, against stub replica servers (the HTTP backends of
``tests/test_fleet.py``): least-outstanding routing, ejection on a 503
or a dead backend and readmission, the front door's proxy and its 503
when no replica is healthy, keep-alive reuse of the upstream connection.
Against the live JAX module: the same scripted arrivals and completions
give the same ``pick`` sequence in both packages — unweighted, weighted by
the drain-rate EWMA, and pinned to the session ring's owners (the ring's
hash is the JAX one, so owners match); a straggler whose batch replies
land together outweighs its peers in both routers (the drain-rate
weight's known fault), and the same completions spread over the batch do
not; ``_per_replica_argv`` agrees; the merged ``/metrics`` of a fleet
with an ejected replica is the same text (fresh registries in both).

One subprocess case runs the fleet on the CPU (``--replicas 2
--respawn_max 1 -- --model lenet --device cpu``): a SIGKILLed replica is
ejected and respawned, then SIGTERM drains everything to exit 0.  The
autoscaling and the composed-chaos cases are marked ``slow``.  The card
case (no CUDA context in the balancer) is in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import heapq
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dwt_tpu.fleet import autoscale as jax_autoscale
from dwt_tpu.fleet import balancer as jax_balancer
from dwt_tpu.obs import prom as jax_prom
from dwt_tpu.obs import registry as jax_registry
from dwt_tpu_torch.fleet import autoscale, balancer
from dwt_tpu_torch.obs import prom, registry
from dwt_tpu_torch.resilience import inject

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENET_REPLICA = ["--model", "lenet", "--init_random", "--buckets", "1,4",
                 "--max_batch_delay_ms", "2", "--device", "cpu"]


class _StubReplicaServer:
    """A tiny in-process HTTP backend standing in for a serving replica;
    it counts the requests it served and the TCP connections it took."""

    def __init__(self):
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def setup(self):
                super().setup()
                stub.connections += 1

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._reply(200 if stub.healthy else 503, {
                    "ok": stub.healthy, "queued_items": 0,
                    "dispatcher_heartbeat_age_s": 0.1, "version": "stub-1"})

            def do_POST(self):
                self.rfile.read(int(self.headers.get("Content-Length", 0)))
                stub.served += 1
                self._reply(200, {"logits": [[0.0]], "replica": stub.port})

        self.healthy = True
        self.served = 0
        self.connections = 0
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _front(rset, autoscaler=None):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                balancer.make_handler(rset, threading.Event(),
                                                      autoscaler=autoscaler))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _post(port, body, timeout=60, conn=None):
    own = conn is None
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/infer", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, resp.getheader("X-DWT-Replica"), resp.getheader("Retry-After")
    finally:
        if own:
            conn.close()


def _get_json(port, path="/healthz"):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


# ------------------------------------------------------ stub replicas, in process


def test_routing_ejection_and_readmission():
    """Least-outstanding routing over the healthy replicas; a 503 replica
    is ejected and readmitted once healthy; a dead backend is ejected."""
    a, b = _StubReplicaServer(), _StubReplicaServer()
    try:
        ra = balancer.Replica(0, "127.0.0.1", a.port)
        rb = balancer.Replica(1, "127.0.0.1", b.port)
        rset = balancer.ReplicaSet([ra, rb])
        prober = balancer.HealthProber(rset, interval_s=1000.0)  # manual probes
        prober.probe_once()
        assert rset.healthy_count() == 2
        p1, p2 = rset.pick(), rset.pick()
        assert {p1.rid, p2.rid} == {0, 1} and p1.outstanding == p2.outstanding == 1
        rset.release(p1, ok=True)
        rset.release(p2, ok=True)
        busy, idle = rset.pick(), rset.pick()
        rset.release(idle, ok=True)
        assert rset.pick().rid == idle.rid  # the busy one still has one out
        rset.release(busy, ok=True)
        rset.release(idle, ok=True)
        a.healthy = False
        prober.probe_once()
        assert not ra.healthy and rset.healthy_count() == 1
        assert rset.pick().rid == 1
        rset.release(rb, ok=True)
        a.healthy = True
        prober.probe_once()
        assert ra.healthy and rset.healthy_count() == 2
        assert ra.last_health["version"] == "stub-1"
        b.stop()
        prober.probe_once()
        assert not rb.healthy and rset.healthy_count() == 1
        assert registry.get_registry().value("dwt_fleet_ejections_total", {"rid": "1"}) >= 1
    finally:
        a.stop()
        try:
            b.stop()
        except Exception:
            pass


def test_front_proxies_stamps_replica_and_503s_when_empty():
    """The front door proxies ``/infer`` to a healthy stub (the reply
    stamped ``X-DWT-Replica``), and answers 503 with ``Retry-After`` once
    every replica is ejected; ``/healthz`` follows."""
    stub = _StubReplicaServer()
    rset = balancer.ReplicaSet([balancer.Replica(0, "127.0.0.1", stub.port)])
    httpd = _front(rset)
    port = httpd.server_address[1]
    body = json.dumps({"inputs": [[0.0]]}).encode()
    try:
        status, data, rid, _ = _post(port, body)
        assert status == 200 and "logits" in json.loads(data) and rid == "0"
        health = _get_json(port)
        assert health["ok"] and health["healthy_replicas"] == 1
        stub.healthy = False
        balancer.HealthProber(rset, interval_s=1000.0).probe_once()
        status, data, _, retry_after = _post(port, body)
        assert status == 503 and json.loads(data)["retry_after_ms"] == 1000
        assert retry_after == "1"
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        assert resp.status == 503 and not json.loads(resp.read())["ok"]
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        stub.stop()


def test_upstream_keepalive_connection_reused():
    """The balancer's pooled upstream connection is reused across proxied
    requests: five requests through the front reach the stub over one TCP
    connection (and the front's own client reuses its connection)."""
    stub = _StubReplicaServer()
    rset = balancer.ReplicaSet([balancer.Replica(0, "127.0.0.1", stub.port)])
    httpd = _front(rset)
    conn = http.client.HTTPConnection("127.0.0.1", httpd.server_address[1], timeout=10)
    try:
        for _ in range(5):
            status, _, _, _ = _post(None, json.dumps({"inputs": [[0.0]]}).encode(), conn=conn)
            assert status == 200
        assert stub.served == 5 and stub.connections == 1
    finally:
        conn.close()
        httpd.shutdown()
        httpd.server_close()
        stub.stop()


# --------------------------------------------------------- against the JAX module


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pick_sequence(mod, weighted: bool, affinity: bool, seed: int):
    """Scripted arrivals and completions on a 4-replica set: completions
    at each replica's own rate under a fake clock feed the drain-rate
    EWMAs; one replica is ejected mid-run and readmitted; with affinity,
    every third arrival carries one of five session keys."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    rs = [mod.Replica(i, "h", 100 + i) for i in range(4)]
    rset = mod.ReplicaSet(rs, weighted=weighted, session_affinity=affinity, clock=clock)
    rates = (40.0, 20.0, 10.0, 30.0)
    credit = [0.0] * 4
    seq = []
    for step in range(600):
        clock.t += 0.01
        if step == 200:
            rset.eject(rs[3], "scripted")
        if step == 400:
            rset.readmit(rs[3])
        for _ in range(int(rng.poisson(0.9))):
            key = f"user-{int(rng.integers(5))}" if affinity and step % 3 == 0 else None
            r = rset.pick(session_key=key)
            seq.append(r.rid)
        for r in rs:
            if r.outstanding:
                credit[r.rid] += rates[r.rid] * 0.01
                while credit[r.rid] >= 1.0 and r.outstanding:
                    credit[r.rid] -= 1.0
                    rset.release(r, ok=True)
    return seq, [round(r.rate_ewma, 9) if r.rate_ewma else None for r in rs]


@pytest.mark.parametrize("weighted,affinity", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("seed", [0, 1])
def test_pick_sequence_matches_jax(weighted, affinity, seed):
    ours = _pick_sequence(balancer, weighted, affinity, seed)
    assert ours == _pick_sequence(jax_balancer, weighted, affinity, seed)
    assert len(set(ours[0])) == 4  # every replica took traffic


def test_session_ring_owners_match_jax():
    keys = [f"session-{i}" for i in range(200)]
    owners = []
    for mod in (balancer, jax_balancer):
        rs = [mod.Replica(i, "h", 100 + i) for i in range(5)]
        rset = mod.ReplicaSet(rs, weighted=True, session_affinity=True)
        got = []
        for k in keys:
            r = rset.pick(session_key=k)
            rset.release(r, ok=False)
            got.append(r.rid)
        rset.retire(rs[2])
        rset.remove(rs[2])
        for k in keys:
            r = rset.pick(session_key=k)
            rset.release(r, ok=False)
            got.append(r.rid)
        owners.append(got)
    assert owners[0] == owners[1]
    assert balancer._ring_hash("x#1") == jax_balancer._ring_hash("x#1")


def _straggler_shares(mod, together: bool, seed: int):
    """A weighted set under a fake clock: replicas 0 and 1 answer one
    request at a time (0.1 s each); replica 2, added at 10 s as a scale-up
    would add it, is a straggler that takes up to 32 queued requests as
    one batch and sleeps 0.3 s before its 20 ms forward.  Its replies land
    0.1 ms apart at the batch's end (``together``, as a batch's replies
    do) or spread evenly over the batch.  24 Poisson arrivals/s for 60 s.
    Returns the pick sequence, each replica's share of the second half's
    picks, its drain-rate EWMA and its completions per second."""
    rng = np.random.default_rng(seed)
    clock = _Clock()
    rs = [mod.Replica(i, "h", 100 + i) for i in range(3)]
    rset = mod.ReplicaSet(rs[:2], weighted=True, clock=clock)
    events, order = [(10.0, -1, "join", None)], 0
    t = rng.exponential(1 / 24.0)
    while t < 60.0:
        events.append((t, order, "arrive", None))
        order += 1
        t += rng.exponential(1 / 24.0)
    heapq.heapify(events)
    queues, busy, picks = {0: [], 1: [], 2: []}, [False] * 3, []

    def start(rid, now):
        nonlocal order
        if busy[rid] or not queues[rid]:
            return
        busy[rid] = True
        if rid == 2:
            n = min(len(queues[2]), 32)
            del queues[2][:n]
            end = now + 0.3 + 0.02
            for i in range(n):
                when = end + i * 1e-4 if together else now + (i + 1) * (end - now) / n
                heapq.heappush(events, (when, order, "reply", (2, i == n - 1)))
                order += 1
        else:
            queues[rid].pop(0)
            heapq.heappush(events, (now + 0.1, order, "reply", (rid, True)))
            order += 1

    while events:
        clock.t, _, kind, data = heapq.heappop(events)
        if kind == "join":
            rset.add(rs[2])
        elif kind == "arrive":
            r = rset.pick()
            picks.append(r.rid)
            queues[r.rid].append(clock.t)
            start(r.rid, clock.t)
        else:
            rid, last = data
            rset.release(rs[rid], ok=True)
            if last:
                busy[rid] = False
                start(rid, clock.t)
    late = picks[len(picks) // 2:]
    return (picks, [late.count(i) / len(late) for i in range(3)],
            [r.rate_ewma for r in rs], [r.served / 60.0 for r in rs])


@pytest.mark.parametrize("together", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_batched_replies_inflate_the_straggler_weight(together, seed):
    """The routing fault of the drain-rate weight (``1/gap`` between
    completions), in both packages alike: when a straggler's batch
    replies land together, the gaps inside the batch read as thousands of
    completions a second, so the straggler outweighs its peers and takes
    the larger share; the same completions spread over the batch leave it
    the smaller share."""
    picks, shares, ewma, drained = _straggler_shares(balancer, together, seed)
    assert picks == _straggler_shares(jax_balancer, together, seed)[0]
    if together:
        assert shares[2] > max(shares[:2])
        assert ewma[2] > 100 * drained[2]  # the weight, not the drain, grew
    else:
        assert shares[2] < min(shares[:2])


@pytest.mark.parametrize("argv", [
    [], ["--model", "lenet"], ["--access_log", "a.jsonl", "--model", "lenet"],
    ["--access_log=runs/a.jsonl"], ["--model", "lenet", "--access_log"],
])
def test_per_replica_argv_matches_jax(argv):
    for rid in (0, 3):
        assert balancer._per_replica_argv(rid, argv) == jax_balancer._per_replica_argv(rid, argv)


class _MetricsHandler(BaseHTTPRequestHandler):
    text = ""

    def log_message(self, fmt, *args):
        pass

    def do_GET(self):
        body = (self.text if self.path == "/metrics" else '{"ok": true}').encode()
        self.send_response(200)
        self.send_header("Content-Type", prom.CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _merged_metrics(mod, scaler_mod):
    """``tests/test_metrics_plane.py``'s aggregation case through ``mod``:
    two replicas, one ejected, an autoscaler blocked at max."""
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), type("H", (_MetricsHandler,), {
        "text": f"# TYPE dwt_serve_imgs_total counter\ndwt_serve_imgs_total {n}\n"}))
        for n in (11, 99)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        r0, r1 = (mod.Replica(i, "127.0.0.1", srv.server_address[1])
                  for i, srv in enumerate(servers))
        rset = mod.ReplicaSet([r0, r1])
        rset.eject(r1, "test: down")
        scaler = scaler_mod.Autoscaler(rset, lambda rid: None, min_replicas=1,
                                       max_replicas=2, pressure_for_s=0.0, clock=_Clock())
        r0.outstanding = 50
        d = scaler.tick()
        r0.outstanding = 0
        assert (d.action, d.reason) == ("blocked", "at_max")
        front = ThreadingHTTPServer(("127.0.0.1", 0),
                                    mod.make_handler(rset, threading.Event(), autoscaler=scaler))
        threading.Thread(target=front.serve_forever, daemon=True).start()
        try:
            return urllib.request.urlopen(
                f"http://127.0.0.1:{front.server_address[1]}/metrics", timeout=10
            ).read().decode()
        finally:
            front.shutdown()
            front.server_close()
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()


def test_merged_metrics_with_an_ejected_replica_match_jax(monkeypatch):
    monkeypatch.setattr(registry, "_DEFAULT", registry.MetricsRegistry())
    monkeypatch.setattr(jax_registry, "_DEFAULT", jax_registry.MetricsRegistry())
    ours = _merged_metrics(balancer, autoscale)
    ref = _merged_metrics(jax_balancer, jax_autoscale)
    assert ours == ref
    assert prom.validate_exposition(ours) == [] == jax_prom.validate_exposition(ref)
    assert 'dwt_serve_imgs_total{replica="0"} 11' in ours
    assert 'replica="1"' not in ours
    assert "dwt_fleet_healthy_replicas 1" in ours
    assert 'dwt_fleet_ejections_total{rid="1"} 1' in ours
    assert "dwt_fleet_target_replicas 2" in ours
    assert 'dwt_fleet_scale_events_total{direction="blocked",reason="at_max"} 1' in ours


def test_balancer_imports_no_torch():
    """The balancer and the autoscaler load without torch (so without a
    CUDA context), the serving handler base too."""
    code = ("import sys, dwt_tpu_torch.fleet.balancer as b, dwt_tpu_torch.fleet.autoscale, "
            "dwt_tpu_torch.utils.repro\n"
            "b.build_parser().parse_args(['--replicas', '2'])\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ------------------------------------------------------------ the fleet process


def _start_fleet(fleet_argv, serve_argv=LENET_REPLICA, env=None):
    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.fleet.balancer", "--port", "0",
         "--health_interval_s", "0.3", *fleet_argv, "--", *serve_argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ready = json.loads(proc.stdout.readline())
    assert ready["kind"] == "fleet_ready", ready
    return proc, ready


def test_fleet_respawns_a_sigkilled_replica_and_drains_clean():
    """``--replicas 2 --respawn_max 1`` on the CPU: both replicas serve; a
    SIGKILLed one is ejected, respawned (fresh pid and port) and serves
    again, ``dwt_fleet_respawns_total{rid="0"} 1`` on the merged
    ``/metrics``; SIGTERM drains every replica and the fleet to exit 0."""
    proc, ready = _start_fleet(["--replicas", "2", "--respawn_max", "1",
                                "--respawn_backoff_s", "0.2"])
    try:
        port = ready["port"]
        body = json.dumps({"inputs": np.zeros((1, 28, 28, 1)).tolist()}).encode()
        assert {_post(port, body)[2] for _ in range(4)} == {"0", "1"}
        victim = ready["replicas"][0]["pid"]
        os.kill(victim, signal.SIGKILL)
        deadline = time.monotonic() + 90
        h = {}
        while time.monotonic() < deadline:
            h = _get_json(port)
            r0 = next(r for r in h["replicas"] if r["rid"] == 0)
            if h["healthy_replicas"] == 2 and r0["respawns"] == 1:
                break
            time.sleep(0.3)
        r0 = next(r for r in h["replicas"] if r["rid"] == 0)
        assert h["healthy_replicas"] == 2 and r0["respawns"] == 1 and r0["pid"] != victim
        statuses = [_post(port, body) for _ in range(6)]
        assert all(s[0] == 200 for s in statuses) and {s[2] for s in statuses} == {"0", "1"}
        metrics = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                         timeout=10).read().decode()
        assert prom.validate_exposition(metrics) == []
        assert 'dwt_fleet_respawns_total{rid="0"} 1' in metrics
        assert 'dwt_fleet_ejections_total{rid="0"} 1' in metrics
        assert 'replica="1"' in metrics and 'replica="0"' in metrics
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        out = proc.stdout.read()
        assert rc == 0, proc.stderr.read()[-2000:]
        summary = json.loads(out.strip().splitlines()[-1])
        assert summary["kind"] == "fleet_summary" and summary["unclean_drains"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()


# ------------------------------------------------------------------- slow tier


@pytest.mark.slow
def test_fleet_autoscales_up_and_back_down(tmp_path):
    """2 → 3 under sustained HTTP load, then back to 2 when idle: a
    ``scale_up`` and a ``scale_down`` whose ``scale_retired`` rc is 0, no
    request without an answer, every replica's access trail intact."""
    access = str(tmp_path / "access.jsonl")
    proc, ready = _start_fleet(
        ["--replicas", "2", "--min_replicas", "2", "--max_replicas", "3",
         "--scale_interval_s", "0.5", "--scale_pressure", "2",
         "--scale_pressure_for_s", "1", "--scale_idle", "0.5",
         "--scale_idle_for_s", "2", "--scale_cooldown_s", "1"],
        LENET_REPLICA + ["--access_log", access])
    events = []
    reader = threading.Thread(target=lambda: events.extend(
        json.loads(line) for line in proc.stdout if line.startswith("{")), daemon=True)
    reader.start()
    try:
        port = ready["port"]
        body = json.dumps({"inputs": np.zeros((4, 28, 28, 1)).tolist()}).encode()
        lost = []
        stop = threading.Event()

        def load():
            while not stop.is_set():
                try:
                    _post(port, body, timeout=120)
                except Exception:
                    lost.append(1)

        workers = [threading.Thread(target=load, daemon=True) for _ in range(16)]
        for w in workers:
            w.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and _get_json(port)["target_replicas"] < 3:
            time.sleep(0.3)
        stop.set()
        for w in workers:
            w.join(timeout=120)
        assert _get_json(port)["target_replicas"] == 3
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and not any(
                e.get("kind") == "scale_retired" for e in list(events)):
            time.sleep(0.3)
        assert not lost
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0
        reader.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
    kinds = [e["kind"] for e in events]
    assert "scale_up" in kinds and "scale_down" in kinds
    retired = [e for e in events if e["kind"] == "scale_retired"]
    assert retired and all(e["rc"] == 0 and e["clean"] for e in retired)
    trails = [f for f in os.listdir(tmp_path) if f.startswith("access.jsonl.r")]
    assert len(trails) >= 3
    for f in trails:
        for line in open(tmp_path / f):
            json.loads(line)


@pytest.mark.slow
def test_fleet_composed_chaos_spike_straggler_sigkill(tmp_path):
    """A straggler replica (``replica_slow_at``), an offered-rate spike
    (``traffic_spike`` through the bench's ``_apply_spike``) and a SIGKILL
    mid-load under autoscaling with respawns: every request gets an HTTP
    answer, the fleet returns to strength, the drain exits 0."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_serve_bench", os.path.join(REPO, "tools", "torch_serve_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    access = str(tmp_path / "access.jsonl")
    env = dict(os.environ)
    env[inject.ENV_VAR] = json.dumps({"replica_slow_at": {"rid": 1, "sleep_s": 0.05}})
    proc, ready = _start_fleet(
        ["--replicas", "2", "--min_replicas", "2", "--max_replicas", "3",
         "--scale_interval_s", "0.5", "--scale_pressure", "2",
         "--scale_pressure_for_s", "1", "--scale_idle", "0.05",
         "--scale_idle_for_s", "60", "--scale_cooldown_s", "1",
         "--respawn_max", "2", "--respawn_backoff_s", "0.2"],
        LENET_REPLICA + ["--access_log", access], env=env)
    try:
        port = ready["port"]
        body = json.dumps({"inputs": np.zeros((2, 28, 28, 1)).tolist()}).encode()
        inject.arm(inject.FaultPlan.from_spec(
            {"traffic_spike": {"at_request": 100, "factor": 3.0}}))
        gaps = np.random.default_rng(0).exponential(1.0 / 40.0, size=400)
        bench._apply_spike(gaps)
        inject.disarm()
        lost, threads = [], []
        t0 = time.monotonic()
        for i, t_arr in enumerate(np.cumsum(gaps)):
            delay = t0 + t_arr - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if i == 150:
                victim = next(r for r in _get_json(port)["replicas"] if r["rid"] == 1)
                os.kill(victim["pid"], signal.SIGKILL)

            def fire():
                try:
                    _post(port, body, timeout=120)
                except Exception:
                    lost.append(1)

            th = threading.Thread(target=fire, daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=180)
        assert not lost, f"{len(lost)} requests got no HTTP answer"
        deadline = time.monotonic() + 120
        h = {}
        while time.monotonic() < deadline:
            h = _get_json(port)
            if h["healthy_replicas"] >= h["target_replicas"] >= 2:
                break
            time.sleep(0.5)
        assert h["healthy_replicas"] >= 2, h
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    trails = [f for f in os.listdir(tmp_path) if f.startswith("access.jsonl.r")]
    assert len(trails) >= 2
    for f in trails:
        for line in open(tmp_path / f):
            json.loads(line)
