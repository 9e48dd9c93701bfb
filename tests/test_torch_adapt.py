"""Port online domain adaptation against the JAX package (``serve.adapt``).

Both packages serve LeNet-DWT with the same randomized weights and SPD
stats; the same numpy traffic, made from seeds, goes through both
adapters under fake clocks.  Held to the live JAX functions:

* ``make_collect_fn`` advances every running stat as JAX's does
  (``rtol=atol=1e-4`` in f32; ``1e-10`` in float64 under
  ``jax.enable_x64``);
* padded rows never count: a padded dispatch's window is bitwise the
  ragged rows' window;
* the thin-window gate, the momentum clamp (bitwise the fold formula,
  f32 tolerance against JAX's folded stats), the rollback freeze ladder
  and the alert freeze give the same verdicts and events;
* an adapted generation's logits equal JAX's adapted generation's
  (f32 tolerance), and it closes the shifted domain's drift as JAX's
  test_adapted_generation_beats_frozen_stats requires, for the
  cholesky and swbn caches.

Version digests differ between the packages (the port hashes named
parameters and stats, JAX tree paths), so events are compared by kind,
verdict and reason.  One case runs the server CLI with ``--adapt_every``
in a subprocess, scrapes ``/metrics`` and drains it with SIGTERM.
"""

from __future__ import annotations

import copy
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.fleet import CanaryGate as JaxCanaryGate
from dwt_tpu.fleet import DeployController as JaxDeployController
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu.serve import AccessLog as JaxAccessLog
from dwt_tpu.serve import ServeEngine as JaxServeEngine
from dwt_tpu.serve import adapt as jax_adapt
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.fleet import CanaryGate, DeployController, PostSwapMonitor
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.obs import prom
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.serve import AccessLog, ServeClient, ServeEngine, adapt
from dwt_tpu_torch.serve.engine import Version
from dwt_tpu_torch.serve.server import adapt_enabled, build_parser

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (28, 28, 1)
TOL = dict(rtol=1e-4, atol=1e-4)
F64_TOL = dict(rtol=1e-10, atol=1e-10)


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    inject.disarm()
    jax_inject.disarm()


def _randomize(params, stats, rng, dtype=np.float32):
    params = jax.tree.map(
        lambda a: (a + rng.normal(0, 0.1, a.shape) if a.ndim == 1 else a
                   ).astype(dtype), params)

    def leaf(path, a):
        name = getattr(path[-1], "name", str(path[-1]))
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(dtype)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(dtype)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(dtype)
        return np.asarray(a)

    return params, jax.tree_util.tree_map_with_path(leaf, stats)


def _init(whitener="cholesky", momentum=0.1, dtype=np.float32):
    model = JaxLeNetDWT(group_size=4, whitener=whitener, momentum=momentum)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((2, 2) + SHAPE), train=True))(jax.random.key(0))
    params, stats = _randomize(jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]),
                               np.random.default_rng(0), dtype)
    return model, params, stats


def _port(params, stats, whitener="cholesky", momentum=0.1, dtype=torch.float32):
    port = LeNetDWT(group_size=4, whitener=whitener, momentum=momentum).to(dtype)
    load_jax_variables(port, params, stats)
    return port


def _as_port(params, jax_stats, **kw):
    """JAX ``batch_stats`` as the port's stats dict (through the bridge)."""
    port = _port(params, jax.tree.map(np.asarray, jax_stats), **kw)
    names = {n for n, _ in port.named_parameters()}
    return {k: v.numpy() for k, v in port.state_dict().items() if k not in names}


def _host(stats):
    return {k: v.detach().cpu().numpy() for k, v in stats.items()}


def _assert_stats_close(ours, ref, tol=TOL):
    assert sorted(ours) == sorted(ref)
    for k in ours:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(ref[k], np.float64), err_msg=k, **tol)


@pytest.fixture(scope="module")
def setup():
    model, params, stats = _init()
    ours = ServeEngine(_port(params, stats), SHAPE, buckets=(1, 4, 8), device="cpu",
                       step=1, digest="seed")
    ref = JaxServeEngine(model, params, stats, SHAPE, buckets=(1, 4, 8),
                         step=1, digest="seed")
    return model, params, stats, ours, ref


@pytest.fixture()
def engines(setup):
    """Both engines, their original generations put back afterwards."""
    _, params, _, ours, ref = setup
    st, jst = ours.state, ref.state
    yield ours, ref, params
    ours.swap(st)
    ref.swap(jst)


def _adapter(mod, controller_cls, engine, *, canary=None, monitor=None,
             access_log=None, clock=None, **kw):
    controller = controller_cls(engine, access_log=access_log, canary=canary,
                                monitor=monitor)
    kw.setdefault("adapt_every_s", 1.0)
    kw.setdefault("min_samples", 16)
    kw.setdefault("collect_batch", 8)
    adapter = mod.DomainAdapter(engine, controller, access_log=access_log,
                                clock=clock or time.monotonic, **kw)
    return adapter, controller


def _pair(engines, **kw):
    """``(ours, ref)`` adapters over the two engines, each with its own
    fake clock, access-log stream and canary over the same fixture."""
    ours_engine, ref_engine, _ = engines
    fixture = kw.pop("fixture", None)
    out = []
    for mod, ctl, gate, log_cls, engine in (
            (adapt, DeployController, CanaryGate, AccessLog, ours_engine),
            (jax_adapt, JaxDeployController, JaxCanaryGate, JaxAccessLog, ref_engine)):
        buf = io.StringIO()
        clock = _FakeClock()
        canary = None if fixture is None else gate(engine, *fixture)
        a, c = _adapter(mod, ctl, engine, access_log=log_cls(stream=buf),
                        clock=clock, canary=canary, **kw)
        out.append(types.SimpleNamespace(adapter=a, controller=c, clock=clock, buf=buf,
                                         engine=engine))
    return out


def _events(side):
    keep = ("kind", "ok", "reason", "samples", "step")
    return [{k: e[k] for k in keep if k in e}
            for e in map(json.loads, side.buf.getvalue().splitlines())
            if e["kind"] != "access"]


def _traffic(n, seed, scale=1.0, offset=0.0):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n,) + SHAPE) * scale + offset).astype(np.float32)


# ------------------------------------------------------------ the collector

def test_collect_advances_stats_as_jax_in_f32(engines):
    ours, ref, params = engines
    x = _traffic(8, 11, 1.5, 0.3)
    got = adapt.make_collect_fn(ours)(ours.state, ours.state.batch_stats, x)
    want = jax_adapt.make_collect_fn(ref)(ref.state.params, ref.state.batch_stats, x)
    assert {k: v.dtype for k, v in got.items()} == \
        {k: v.dtype for k, v in ours.state.batch_stats.items()}
    _assert_stats_close(_host(got), _as_port(params, want))
    # The live generation's stats did not move.
    _assert_stats_close(_host(ours.state.batch_stats),
                        _as_port(params, ref.state.batch_stats), dict(rtol=0, atol=0))


def test_collect_advances_stats_as_jax_in_f64():
    model, params, stats = _init(dtype=np.float64)
    x = _traffic(6, 12, 1.5, 0.3).astype(np.float64)
    port64 = _port(params, stats, dtype=torch.float64)
    port64.dtype = torch.float64
    stub = types.SimpleNamespace(
        num_domains=2, device=torch.device("cpu"),
        fresh_model=lambda: copy.deepcopy(port64),
        stage_rows=lambda a: torch.from_numpy(np.asarray(a, np.float64)),
        full_params=lambda st: (st.params, st.scales))
    state = types.SimpleNamespace(params=dict(port64.named_parameters()), scales=None)
    names = {n for n, _ in port64.named_parameters()}
    live = {k: v for k, v in port64.state_dict().items() if k not in names}
    got = adapt.make_collect_fn(stub)(state, live, x)
    with jax.enable_x64(True):
        model64 = JaxLeNetDWT(group_size=4, dtype=jnp.float64)
        want = jax_adapt.make_collect_fn(types.SimpleNamespace(model=model64, quantize=False))(
            params, stats, jnp.asarray(x))
        want = jax.tree.map(np.asarray, want)
    assert all(v.dtype == torch.float64 for k, v in got.items() if "count" not in k)
    _assert_stats_close(_host(got), _as_port(params, want, dtype=torch.float64), F64_TOL)


def test_padded_rows_never_enter_the_moments(engines):
    ours, ref, params = engines
    real = _traffic(6, 7)
    padded = np.concatenate([real, np.repeat(real[-1:], 2, axis=0)])  # bucket 8
    windows = []
    for _ in range(2):
        a, _ = _adapter(adapt, DeployController, ours, collect_batch=6)
        windows.append(a)
    windows[0].offer(padded, real_n=6)
    windows[1].offer(real, real_n=6)
    for a in windows:
        a._absorb(a._drain_queue())
    assert windows[0].window_samples == windows[1].window_samples == 6
    for k, v in windows[0]._win_stats.items():
        np.testing.assert_array_equal(v.numpy(), windows[1]._win_stats[k].numpy())
    j, _ = _adapter(jax_adapt, JaxDeployController, ref, collect_batch=6)
    j.offer(padded, real_n=6)
    j._absorb(j._drain_queue())
    _assert_stats_close(_host(windows[0]._win_stats), _as_port(params, j._win_stats))


def test_dispatcher_hook_feeds_real_rows_only(engines):
    ours, _, _ = engines
    client = ServeClient(ours, max_batch_delay_ms=1.0)
    a, _ = _adapter(adapt, DeployController, ours)
    client.attach_adapter(a)
    try:
        x = _traffic(3, 3)  # pads to bucket 4
        client.infer(x)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            with a._qlock:
                if a._queue_samples >= 3:
                    break
            time.sleep(0.01)
        batches = a._drain_queue()
        np.testing.assert_array_equal(np.concatenate(batches), x)
        client.attach_adapter(None)
        assert client._dispatcher.batch_hook is None
    finally:
        client.close()


# ---------------------------------------------------------- gates and folds

def test_thin_window_then_fold_gives_jaxs_events(engines):
    sides = _pair(engines, min_samples=16)
    x = _traffic(8, 1)
    for side in sides:
        side.adapter.offer(x, real_n=8)
        side.clock.t += 2.0
        assert side.adapter.step() == "thin_window"
        assert side.adapter.window_samples == 8 and side.adapter.generation == 0
        side.adapter.offer(x, real_n=8)
        side.clock.t += 2.0
        assert side.adapter.step() == "swapped"
    assert _events(sides[0]) == _events(sides[1])
    assert [e["kind"] for e in _events(sides[0])] == ["adapt_build", "adapt_build", "adapt_swap"]
    assert sides[0].adapter.last_drift == pytest.approx(sides[1].adapter.last_drift, rel=1e-4)


def test_momentum_clamp_folds_at_the_clamp_like_jax(engines):
    ours, ref, params = engines
    sides = _pair(engines, momentum=0.9, max_momentum=0.5)
    x = _traffic(16, 2, 1.7, 0.9)
    for side in sides:
        assert side.adapter._effective_momentum() == 0.5
        side.adapter.offer(x, real_n=16)
        side.adapter._absorb(side.adapter._drain_queue())
    live = _host(ours.state.batch_stats)
    win = _host(sides[0].adapter._win_stats)
    for side in sides:
        side.clock.t += 2.0
        assert side.adapter.step() == "swapped"
        assert side.adapter.generation == 1 and side.controller.swap_count == 1
        assert side.adapter.window_samples == 0
    got = _host(ours.state.batch_stats)
    for k, a in live.items():
        expected = (a + 0.5 * (win[k].astype(np.float64) - a)).astype(a.dtype)
        np.testing.assert_array_equal(got[k], expected, err_msg=k)
    _assert_stats_close(got, _as_port(params, ref.state.batch_stats))


def test_adapted_generation_logits_equal_jaxs(engines):
    ours, ref, _ = engines
    sides = _pair(engines, momentum=0.5, fixture=(_traffic(8, 30),))
    x = _traffic(32, 4, 1.6, 0.8)
    for side in sides:
        side.adapter.offer(x, real_n=32)
        side.clock.t += 2.0
        assert side.adapter.step() == "swapped"
    assert _events(sides[0]) == _events(sides[1])
    assert ours.version.label != "1-seed" and ours.version.step == 1
    probe = _traffic(8, 31, 1.6, 0.8)
    want = ref.infer(probe)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(ours.infer(probe), want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * scale)


@pytest.mark.parametrize("whitener", ["cholesky", "swbn"])
def test_adapted_generation_beats_frozen_stats(whitener):
    """Under a shifted input domain one canary-accepted adapted generation
    closes the gap the frozen stats cannot: the drift of the same traffic
    against the adapted stats falls monotonically over three folds, to
    below 0.7 of the drift against the frozen stats — for the factorizing
    and the tracked-matrix cache, as in the JAX package's test."""
    model, params, stats = _init(whitener, momentum=0.6)
    engine = ServeEngine(_port(params, stats, whitener, momentum=0.6), SHAPE,
                         buckets=(8,), device="cpu", step=1, digest="seed")
    buf = io.StringIO()
    alog = AccessLog(stream=buf)
    clock = _FakeClock()
    controller = DeployController(engine, access_log=alog,
                                  canary=CanaryGate(engine, _traffic(8, 0)))
    adapter = adapt.DomainAdapter(engine, controller, access_log=alog, adapt_every_s=1.0,
                                  min_samples=32, collect_batch=8, momentum=0.5,
                                  clock=clock)
    v0, cache0 = engine.version.label, engine.state.cache
    adapter.offer(_traffic(64, 1, 1.6, 0.8), real_n=64)
    clock.t += 2.0
    assert adapter.step() == "swapped"
    drifts = [adapter.last_drift]
    assert drifts[0] > 0 and adapter.generation == 1 and engine.version.label != v0
    assert any(not torch.equal(cache0[k], engine.state.cache[k]) for k in cache0)
    assert np.isfinite(engine.infer(_traffic(8, 9, 1.6, 0.8))).all()
    for seed in (2, 3):
        adapter.offer(_traffic(64, seed, 1.6, 0.8), real_n=64)
        clock.t += 2.0
        assert adapter.step() in ("swapped", "refused")
        drifts.append(adapter.last_drift)
    assert drifts[1] < drifts[0] and drifts[2] < drifts[1]
    assert drifts[-1] < 0.7 * drifts[0]
    events = [json.loads(l) for l in buf.getvalue().splitlines()]
    assert [e["kind"] for e in events[:3]] == ["adapt_build", "adapt_canary", "adapt_swap"]
    assert events[2]["from_version"] == v0
    client = ServeClient(engine, max_batch_delay_ms=1.0, access_log=alog)
    client.attach_adapter(adapter)
    try:
        fields = client.stats()["adaptation"]
        assert fields["generation"] == adapter.generation and fields["frozen"] is False
        assert fields["domain_shift"] == pytest.approx(drifts[-1], abs=1e-6)
    finally:
        client.close()


def test_canary_refuses_a_degraded_adapted_candidate(engines):
    ours, ref, _ = engines
    x = _traffic(8, 5)
    sides = _pair(engines, momentum=0.5, max_momentum=1.0,
                  fixture=(x, ours.infer(x).argmax(-1)))
    for side, live in zip(sides, (_host(ours.state.batch_stats),
                                  jax.device_get(ref.state.batch_stats))):
        side.adapter._win_stats = jax.tree.map(
            lambda a: (np.asarray(a) + 1e4).astype(np.asarray(a).dtype)
            if np.issubdtype(np.asarray(a).dtype, np.floating) else np.asarray(a), live)
        side.adapter._win_samples = 64
        v0 = side.engine.version.label
        assert side.adapter.try_fold() == "refused"
        assert side.engine.version.label == v0
        assert side.adapter.generation == 0 and side.controller.swap_count == 0
        assert side.adapter.frozen_reason() is None
    assert _events(sides[0]) == _events(sides[1])


def test_post_swap_rollback_freezes_then_rearms(engines):
    ours, _, _ = engines
    buf = io.StringIO()
    alog = AccessLog(stream=buf)
    clock = _FakeClock()
    monitor = PostSwapMonitor(alog, error_rate_threshold=0.2, min_requests=8,
                              decide_after_s=1000.0, clock=clock)
    a, controller = _adapter(adapt, DeployController, ours, monitor=monitor,
                             access_log=alog, clock=clock, freeze_base_s=10.0)
    v0 = ours.version.label
    x = _traffic(16, 6) * 1.5
    a.offer(x, real_n=16)
    clock.t += 2.0
    assert a.step() == "swapped"
    v1 = ours.version.label
    assert v1 != v0 and monitor.armed and monitor.armed_origin == "adapt"
    for _ in range(8):
        alog.record("error", 1, version=v1, error="boom")
    t_rollback = clock.t
    assert a.step() is None  # poll performed the rollback
    assert ours.version.label == v0 and controller.rollback_count == 1
    assert "rollback backoff" in a.frozen_reason()
    kinds = [json.loads(l)["kind"] for l in buf.getvalue().splitlines()]
    assert "adapt_rollback" in kinds
    a.offer(x, real_n=16)
    clock.t += 2.0
    assert a.step() is None and a.generation == 1
    clock.t = t_rollback + 13.0
    assert a.frozen_reason() is None


@pytest.mark.parametrize("mod", [adapt, jax_adapt], ids=["port", "jax"])
def test_rollback_freeze_ladder(mod):
    """Base, 2x, 4x per consecutive rollback, capped; a surviving adapted
    generation resets it; checkpoint rollbacks are not the adapter's —
    the same ladder in both packages."""
    clock = _FakeClock()
    a = mod.DomainAdapter.__new__(mod.DomainAdapter)
    a._clock = clock
    a.freeze_base_s, a.max_freeze_doublings, a.alert_engine = 10.0, 2, None
    a._frozen_until, a._freeze_reason, a._consecutive_rollbacks = 0.0, None, 0
    a._win_stats, a._win_samples, a._pending_rows = object(), 5, [np.zeros((1, 2))]
    a._m_generations = types.SimpleNamespace(
        labels=lambda **kw: types.SimpleNamespace(inc=lambda *x: None))
    v = Version(1, "x")
    a._on_verdict("reload", v, "rollback: not ours")
    assert a.frozen_reason() is None
    trace = []
    for t in (0.0, 11.0, 40.0, 90.0):
        clock.t = t
        a._on_verdict("adapt", v, "rollback: p99")
        trace.append(a._frozen_until)
    assert trace == [10.0, 31.0, 80.0, 130.0]
    assert a._win_stats is None and a._win_samples == 0 and a._pending_rows == []
    a._on_verdict("adapt", v, "ok")
    assert a._consecutive_rollbacks == 0


def test_alert_firing_freezes_folding(engines):
    alerts = types.SimpleNamespace(firing_now=["serve_p99_slo"])
    alerts.maybe_evaluate = lambda: None
    alerts.firing = lambda: alerts.firing_now
    sides = _pair(engines, min_samples=8, alert_engine=alerts)
    x = _traffic(8, 4)
    for side in sides:
        side.adapter.offer(x, real_n=8)
        side.clock.t += 2.0
        assert side.adapter.step() is None
        assert "alert firing" in side.adapter.frozen_reason()
        assert side.adapter.fold_attempts == 0
    alerts.firing_now = []
    for side in sides:
        side.clock.t += 2.0
        assert side.adapter.step() == "swapped"
    assert _events(sides[0]) == _events(sides[1])


def test_no_adapt_default_is_inert(engines):
    ours, _, _ = engines
    p = build_parser()
    assert not adapt_enabled(p.parse_args([]))
    assert adapt_enabled(p.parse_args(["--adapt_every", "5"]))
    assert not adapt_enabled(p.parse_args(["--adapt_every", "5", "--no-adapt"]))
    assert not adapt_enabled(p.parse_args(["--adapt_every", "5", "--no_adapt"]))
    client = ServeClient(ours, max_batch_delay_ms=1.0)
    try:
        assert client._dispatcher.batch_hook is None
        assert "adaptation" not in client.stats()
    finally:
        client.close()


def test_chaos_poison_and_drift_composed(engines):
    """Drifted traffic with poisoned requests riding it through the real
    client and adapter: every poisoned row is sanitized out, nothing
    rolls back, serving stays healthy, the access log is intact JSONL."""
    ours, _, _ = engines
    inject.arm(inject.FaultPlan.from_spec({
        "serve_poison_requests": [3, 6, 9, 12],
        "serve_drift_shift": {"at_request": 0, "offset": 0.7, "scale": 1.4},
    }))
    buf = io.StringIO()
    alog = AccessLog(stream=buf)
    clock = _FakeClock()
    a, controller = _adapter(adapt, DeployController, ours,
                             canary=CanaryGate(ours, _traffic(8, 8)),
                             access_log=alog, clock=clock)
    client = ServeClient(ours, max_batch_delay_ms=1.0, access_log=alog)
    client.attach_adapter(a)
    try:
        base = _traffic(1, 9)
        for i in range(24):
            xi = inject.maybe_poison_request(i, inject.maybe_shift_request(i, base))
            assert client.infer(xi).shape[0] == 1
            if i % 8 == 7:
                clock.t += 2.0
                a.step()
        clock.t += 2.0
        a.step()
    finally:
        client.close()
    assert a.dropped_rows == 4
    assert controller.rollback_count == 0 and a._consecutive_rollbacks == 0
    assert a.fold_attempts >= 1
    kinds = {json.loads(line)["kind"] for line in buf.getvalue().splitlines()}
    assert "access" in kinds and not any(k.endswith("rollback") for k in kinds)


def test_stats_drift_and_sanitize_match_jax():
    rng = np.random.default_rng(3)
    live = {"a": rng.normal(size=(3, 3)), "b": np.full((2,), 2.0)}
    moved = {k: v * 1.5 + 0.1 for k, v in live.items()}
    assert adapt.stats_drift(live, live) == 0.0
    assert adapt.stats_drift(live, moved) == pytest.approx(
        jax_adapt.stats_drift(live, moved), rel=1e-12)
    x = np.ones((5, 2, 2), np.float32)
    x[1, 0, 0], x[2, 1, 1], x[3, 0, 1], x[4] = np.nan, np.inf, -np.inf, 2e3
    assert adapt.sanitize_rows(x, 1e3).tolist() == \
        jax_adapt.sanitize_rows(x, 1e3).tolist() == [True, False, False, False, False]


# ------------------------------------------------------------ the CLI

def test_server_cli_adapts_serves_metrics_and_drains(tmp_path):
    """``python -m dwt_tpu_torch.serve.server --device cpu --adapt_every``
    under traffic: ``serve_ready`` reports the adapter, an adapted
    generation goes live, ``/metrics`` is valid exposition with the
    domain-shift gauge above 0, ``/stats`` carries the adaptation block,
    and SIGTERM drains to exit 0 with an intact access log."""
    access = str(tmp_path / "access.jsonl")
    env = {**os.environ, "DWT_FAULT_PLAN": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dwt_tpu_torch.serve.server", "--device", "cpu",
         "--init_random", "--model", "lenet", "--buckets", "1,4",
         "--max_batch_delay_ms", "2", "--port", "0", "--access_log", access,
         "--adapt_every", "0.3", "--adapt_min_samples", "4", "--adapt_batch", "4",
         "--rollback_decide_s", "0.5"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["kind"] == "serve_ready" and ready["adapt"] is True
        url = f"http://127.0.0.1:{ready['port']}"

        def post(x):
            req = urllib.request.Request(
                f"{url}/infer", data=json.dumps({"inputs": x.tolist()}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())

        x = _traffic(4, 0, 1.5, 0.5)
        deadline = time.monotonic() + 60
        stats = {}
        while time.monotonic() < deadline:
            status, payload = post(x)
            assert status == 200 and len(payload["logits"]) == 4 and payload["version"]
            with urllib.request.urlopen(f"{url}/stats", timeout=30) as resp:
                stats = json.loads(resp.read())
            if stats["adaptation"]["generation"] >= 1:
                break
            time.sleep(0.1)
        assert stats["adaptation"]["generation"] >= 1, stats["adaptation"]
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as resp:
            text = resp.read().decode()
            assert resp.headers["Content-Type"] == prom.CONTENT_TYPE
        assert prom.validate_exposition(text) == []
        shift = prom.parse_exposition(text)["dwt_serve_domain_shift"].samples
        assert shift and shift[0][2] > 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == 0, proc.stderr.read()[-2000:]
        summary = json.loads(proc.stdout.read().strip().splitlines()[-1])
        assert summary["kind"] == "serve_summary"
        kinds = [json.loads(line)["kind"] for line in open(access)]
        assert {"adapt_build", "adapt_canary", "adapt_swap", "access"} <= set(kinds)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_launch_counts_are_exact_when_two_threads_launch(monkeypatch):
    """The dispatcher and the adapter launch kernels from two threads: the
    launch counters lose no increment (8 threads, a short switch
    interval)."""
    from dwt_tpu_torch.ops import cuda_whitening as cw

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    before = (cw.moments_launches, cw.apply_launches)
    per_thread, threads = 5000, []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(8):
            kernel = ("apply", "moments")[i % 2]
            threads.append(threading.Thread(
                target=lambda k=kernel: [cw._count(k) for _ in range(per_thread)]))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert (cw.moments_launches - before[0], cw.apply_launches - before[1]) == \
        (4 * per_thread, 4 * per_thread)
