"""The port's span tracer, trace export and flight recorder (``dwt_tpu_torch.obs``).

``tests/test_obs.py``'s tracer cases, run against the port's copy: the
no-op span when tracing is off, per-thread rings that grow, wrap and are
recycled, the trailing window, the ``DWT_OBS_TRACE`` gate, the
Chrome-trace contract, the flight recorder's naming and retention, the
watchdog's stall dump beside its stacks, the guard event's dump, and the
zero-sync rule — counting shims on every call that waits for the card
plus a source scan of ``dwt_tpu_torch/obs``.  Also: the serving spans'
``req_id``s against the access log, ``--obs_trace`` in every entry point's
parser, and a subprocess proving that ``dwt_tpu_torch.obs`` and the fleet
balancer load neither torch nor anything of ``dwt_tpu``.  Everything is
host-side Python; the tolerances are exact.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from dwt_tpu_torch import obs
from dwt_tpu_torch.obs import spans as spans_mod

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_tracer():
    """The tracer is process-global: every test starts and ends with it off."""
    obs.disable()
    yield
    obs.disable()


# ----------------------------------------------------------- tracer core


def test_disabled_span_is_shared_noop_and_cheap():
    assert not obs.enabled()
    s = obs.span("anything")
    assert s is obs.NULL_SPAN
    assert s.add(k=1) is s
    items = [1, 2, 3]
    assert obs.traced_iter(items, "w") is items  # unchanged, zero frames
    obs.record_complete("x", "step", 0.5)
    assert obs.snapshot() == []
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        with obs.span("s"):
            pass
    per_call = (time.perf_counter() - t0) / n
    assert per_call < 10e-6, f"disabled span cost {per_call * 1e6:.2f} µs"


def test_tracer_records_spans_across_threads():
    obs.configure(path=None)
    with obs.span("main_phase", "step", step=3):
        time.sleep(0.002)

    def worker():
        with obs.span("writer_phase", "ckpt"):
            time.sleep(0.002)

    t = threading.Thread(target=worker, name="writer-0")
    t.start()
    t.join()
    recs = obs.snapshot()
    by_name = {r["name"]: r for r in recs}
    assert by_name["main_phase"]["cat"] == "step"
    assert by_name["main_phase"]["attrs"] == {"step": 3}
    assert by_name["main_phase"]["dur"] >= 0.002
    assert by_name["writer_phase"]["thread"] == "writer-0"
    assert by_name["writer_phase"]["tid"] != by_name["main_phase"]["tid"]
    assert recs == sorted(recs, key=lambda r: r["ts"])


@pytest.mark.parametrize("capacity,writes,first_kept,grows", [
    (16, 50, 34, False),      # fixed-size: wraps at the cap, keeps the newest
    (1024, 2000, 976, True),  # starts small, grows ×4 to the cap, then wraps
])
def test_ring_grows_to_its_cap_then_wraps(capacity, writes, first_kept, grows):
    tracer = obs.Tracer(capacity=capacity)
    tracer.record_complete("s", "step", 1e-6, attrs={"i": 0})
    ring = tracer._ring()
    assert ring.cap == min(capacity, spans_mod.INIT_CAPACITY)
    for i in range(1, writes):
        tracer.record_complete("s", "step", 1e-6, attrs={"i": i})
    assert ring.cap == capacity
    recs = tracer.snapshot()
    assert [r["attrs"]["i"] for r in recs] == list(range(first_kept, writes))
    assert tracer.dropped_spans() == first_kept
    assert (capacity > spans_mod.INIT_CAPACITY) == grows


def test_dead_thread_rings_recycled_past_pool_cap(monkeypatch):
    monkeypatch.setattr(spans_mod, "RING_POOL_MAX", 8)
    tracer = obs.Tracer(capacity=64)

    def worker(k):
        tracer.record_complete("req", "serve", 1e-6, attrs={"k": k})

    for k in range(20):
        t = threading.Thread(target=worker, args=(k,), name=f"h-{k}")
        t.start()
        t.join()
    assert len(tracer._rings) <= 8
    ks = {r["attrs"]["k"] for r in tracer.snapshot()}
    assert 19 in ks and len(ks) <= 8


def test_snapshot_trailing_window_filters_old_spans():
    obs.configure(path=None)
    tracer = obs.get_tracer()
    now = time.perf_counter()
    tracer.record_complete("old", "step", 0.001, end=now - 60.0)
    tracer.record_complete("fresh", "step", 0.001, end=now)
    assert [r["name"] for r in obs.snapshot(last_s=5.0)] == ["fresh"]
    assert {r["name"] for r in obs.snapshot()} == {"old", "fresh"}


def test_maybe_enable_env_gate(monkeypatch, tmp_path):
    monkeypatch.setenv(obs.spans.ENV_TRACE, "0")
    assert not obs.maybe_enable(None) and not obs.enabled()
    monkeypatch.setenv(obs.spans.ENV_TRACE, "1")
    assert obs.maybe_enable(None) and obs.enabled()
    assert obs.export_path() is None  # "1" = tracing without a target
    obs.disable()
    p = str(tmp_path / "t.json")
    monkeypatch.setenv(obs.spans.ENV_TRACE, p)
    assert obs.maybe_enable(None)
    assert obs.export_path() == p
    obs.disable()
    monkeypatch.delenv(obs.spans.ENV_TRACE)
    assert obs.maybe_enable(str(tmp_path / "f.json"))  # the flag alone
    assert obs.export_path() == str(tmp_path / "f.json")


# -------------------------------------------------------- export contract


def test_export_validates_as_chrome_trace(tmp_path):
    obs.configure(path=str(tmp_path / "trace.json"))
    with obs.span("phase_a", "step", step=1):
        time.sleep(0.001)
    with obs.span("phase_b", "eval"):
        pass
    path = obs.export()
    assert path == str(tmp_path / "trace.json")
    trace = json.load(open(path))
    assert obs.validate_chrome_trace(trace) == []
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in events} == {"phase_a", "phase_b"}
    for ev in events:
        assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        assert ev["ts"] >= 0 and ev["dur"] >= 0
        assert ev["args"]["run_id"] == obs.get_tracer().run_id
        assert ev["pid"] == 0  # no process group: rank 0
    assert events[0]["ts"] / 1e6 == pytest.approx(time.time(), abs=300)
    ts = [e["ts"] for e in events]
    assert ts == sorted(ts)
    meta_names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "M"]
    assert "process_name" in meta_names and "thread_name" in meta_names


def test_validate_chrome_trace_catches_malformed():
    assert obs.validate_chrome_trace({}) == ["traceEvents missing or not a list"]
    bad = {"traceEvents": [
        {"ph": "X", "name": "a", "cat": "c", "ts": -1.0, "dur": "x",
         "pid": "zero", "tid": 0},
        {"ph": "Q"},
    ]}
    problems = obs.validate_chrome_trace(bad)
    assert any("bad ts" in p for p in problems)
    assert any("bad dur" in p for p in problems)
    assert any("pid not int" in p for p in problems)
    assert any("unexpected phase" in p for p in problems)


def test_export_without_path_or_tracer_returns_none(tmp_path):
    assert obs.export() is None  # disabled
    obs.configure(path=None)
    assert obs.export() is None  # enabled but no target
    assert obs.export(str(tmp_path / "explicit.json")) is not None


def test_export_and_validation_are_the_jax_packages(tmp_path):
    """The same records give the same Chrome trace in both packages (but
    for the producer tag), and both validators agree on it."""
    import importlib

    jax_export = importlib.import_module("dwt_tpu.obs.export")
    tracer = obs.Tracer(capacity=64, run_id="r")
    tracer.record_complete("a", "step", 0.002, attrs={"step": 1})
    tracer.record_complete("b", "eval", 0.001)
    recs = tracer.snapshot()
    ours = obs.to_chrome_trace(recs, tracer, pid=0)
    ref = jax_export.to_chrome_trace(recs, tracer, pid=0)
    assert ours["otherData"].pop("producer") == "dwt_tpu_torch.obs"
    assert ref["otherData"].pop("producer") == "dwt_tpu.obs"
    assert ours == ref
    assert obs.validate_chrome_trace(ours) == jax_export.validate_chrome_trace(ours) == []


# ------------------------------------------------------------- zero syncs


def test_tracing_makes_zero_device_syncs(monkeypatch, tmp_path):
    """Spans, snapshots, exports and flight dumps never wait for the card:
    counting shims on every call that would, plus a source scan of
    ``dwt_tpu_torch/obs`` (which may not even import torch)."""
    calls = []

    def shim(owner, name):
        real = getattr(owner, name)

        def counting(*a, **k):
            calls.append(f"{owner.__name__}.{name}")
            return real(*a, **k)

        monkeypatch.setattr(owner, name, counting)

    shim(torch.cuda, "synchronize")
    shim(torch.cuda.Event, "synchronize")
    shim(torch.cuda.Stream, "synchronize")
    for name in ("item", "cpu", "tolist", "numpy"):
        shim(torch.Tensor, name)
    obs.configure(path=str(tmp_path / "t.json"))
    x = torch.ones(4)
    with obs.span("s", "step", n=4):
        x = x * 2
    for _ in obs.traced_iter(iter([x, x]), "w"):
        pass
    obs.record_complete("r", "serve", 1e-3)
    obs.snapshot(last_s=1.0)
    assert obs.export()
    assert obs.flight_dump(str(tmp_path / "wd"), "test")
    assert calls == [], f"tracing waited for the device: {calls}"
    banned = ("synchronize(", ".item(", ".cpu(", ".tolist(", ".numpy(")
    imports = re.compile(r"^\s*(import|from)\s+(torch|jax|dwt_tpu)\b", re.M)
    obs_dir = os.path.join(REPO, "dwt_tpu_torch", "obs")
    for fname in sorted(os.listdir(obs_dir)):
        if not fname.endswith(".py"):
            continue
        src = open(os.path.join(obs_dir, fname)).read()
        for word in banned:
            assert word not in src, (fname, word)
        assert not imports.findall(src), (fname, imports.findall(src))


def test_obs_and_the_balancer_import_no_torch_and_no_jax_package():
    code = ("import sys, dwt_tpu_torch.obs, dwt_tpu_torch.fleet.balancer\n"
            "print(sorted(m for m in sys.modules if m in ('torch', 'jax', 'dwt_tpu')\n"
            "             or m.startswith(('torch.', 'jax.', 'dwt_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# --------------------------------------------------------- flight recorder


def test_flight_dump_writes_trailing_window_only(tmp_path):
    obs.configure(path=None)
    tracer = obs.get_tracer()
    now = time.perf_counter()
    tracer.record_complete("ancient", "step", 0.01, end=now - 120.0)
    tracer.record_complete("recent", "step", 0.01, end=now)
    path = obs.flight_dump(str(tmp_path / "wd"), "unit_reason")
    assert path and os.path.exists(path)
    trace = json.load(open(path))
    assert obs.validate_chrome_trace(trace) == []
    assert trace["otherData"]["flight_reason"] == "unit_reason"
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert "recent" in names and "ancient" not in names


def test_flight_dump_disabled_is_none(tmp_path):
    assert obs.flight_dump(str(tmp_path), "r") is None
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("dumps,keep,left", [(2, 10, 2), (8, 3, 3)])
def test_flight_dump_names_and_retention(tmp_path, dumps, keep, left):
    """Same-second dumps get distinct names; ``keep`` caps the directory."""
    obs.configure(path=None)
    obs.get_tracer().record_complete("x", "step", 1e-3)
    d = str(tmp_path / "wd")
    paths = [obs.flight_dump(d, f"r{i}", keep=keep) for i in range(dumps)]
    assert all(paths)
    if keep >= dumps:  # nothing pruned: every same-second dump kept its own name
        assert len(set(paths)) == dumps
    kept = [n for n in os.listdir(d) if n.startswith("spans-") and n.endswith(".json")]
    assert len(kept) == left
    assert json.load(open(paths[-1]))["otherData"]["flight_reason"] == f"r{dumps - 1}"


def _fire_watchdog(tmp_path):
    from dwt_tpu_torch.resilience.watchdog import HangWatchdog

    exits = []
    wd = HangWatchdog(timeout_s=0.2, ckpt_dir=str(tmp_path), _exit=exits.append)
    with wd:
        deadline = time.monotonic() + 10.0
        while not wd.fired and time.monotonic() < deadline:
            time.sleep(0.05)  # no heartbeat: a stall
    assert wd.fired and exits
    return wd, os.listdir(os.path.join(str(tmp_path), "watchdog"))


def test_watchdog_stall_dumps_spans_beside_stacks(tmp_path):
    obs.configure(path=None)
    with obs.span("doomed_phase", "step"):
        time.sleep(0.005)
    wd, files = _fire_watchdog(tmp_path)
    assert any(f.startswith("stacks-") for f in files)
    assert wd.spans_path and os.path.basename(wd.spans_path) in files
    trace = json.load(open(wd.spans_path))
    assert obs.validate_chrome_trace(trace) == []
    assert "watchdog_stall" in trace["otherData"]["flight_reason"]
    assert "doomed_phase" in [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]


def test_watchdog_stall_without_tracing_still_exits(tmp_path):
    wd, files = _fire_watchdog(tmp_path)
    assert wd.spans_path is None
    assert any(f.startswith("stacks-") for f in files)
    assert not any(f.startswith("spans-") for f in files)


def test_guard_event_triggers_flight_dump(tmp_path):
    """A divergence-guard event dumps the trailing spans before the
    recovery or halt path runs, under the watchdog's retention."""
    from dwt_tpu_torch.resilience.guard import DivergenceError
    from dwt_tpu_torch.train.loop import _StepBoundary

    obs.configure(path=None)

    class _Guard:
        recoveries = 0

        def step(self, state, metrics, n, gstep):
            raise DivergenceError("injected non-finite loss")

    class _Preempt:
        should_stop = False

    class _Notice:
        noticed = False

    class _Wd:
        keep = 5

        def heartbeat(self):
            pass

    with obs.span("pre_event_phase", "step"):
        time.sleep(0.002)
    boundary = _StepBoundary(_Guard(), _Preempt(), _Wd(), _Notice(),
                             flight_dir=str(tmp_path / "watchdog"))
    with pytest.raises(DivergenceError):
        boundary(object(), {}, 1, gstep=7)
    dumps = os.listdir(tmp_path / "watchdog")
    assert len(dumps) == 1 and dumps[0].startswith("spans-")
    trace = json.load(open(tmp_path / "watchdog" / dumps[0]))
    assert trace["otherData"]["flight_reason"] == "guard_event_step7"
    names = [e["name"] for e in trace["traceEvents"] if e["ph"] == "X"]
    assert "pre_event_phase" in names and "guard_check" in names


# ------------------------------------------------------------ serve spans


def test_serve_spans_join_the_access_log(tmp_path):
    """admission → plan → build_batch → stage → device → resolve record
    with bucket attrs; each served request's ``req_id`` is on its
    admission span and on its batch's stage, device and resolve spans."""
    import argparse

    from dwt_tpu_torch.serve.metrics import AccessLog
    from dwt_tpu_torch.serve.server import ServeClient, build_engine

    obs.configure(path=None)
    ns = argparse.Namespace(
        model="lenet", group_size=4, num_classes=10, image_size=28,
        whitener="cholesky", bf16=False, serve_dtype="f32", seed=0, buckets="1,4",
        ckpt_dir=None, init_random=True, quantize_int8=False, device="cpu")
    engine = build_engine(ns)
    access_path = str(tmp_path / "access.jsonl")
    client = ServeClient(engine, max_batch_delay_ms=2.0, access_log=AccessLog(access_path))
    try:
        x = np.zeros((1, 28, 28, 1), np.float32)
        for _ in range(3):
            assert client.infer(x).shape == (1, 10)
        futures = [client.submit(np.zeros((2, 28, 28, 1), np.float32)) for _ in range(2)]
        for f in futures:
            assert f.result(timeout=60).shape == (2, 10)
    finally:
        client.close(drain=True)
        client.access_log.close()
    by_name = {}
    for r in obs.snapshot():
        by_name.setdefault(r["name"], []).append(r)
    for phase in ("admission", "plan", "build_batch", "stage", "device", "resolve"):
        assert phase in by_name, f"missing serve span {phase}"
        assert all(r["cat"] == "serve" for r in by_name[phase])
    for r in by_name["device"]:
        assert r["attrs"]["bucket"] in (1, 4)
    access = [json.loads(line) for line in open(access_path)]
    ok = [r for r in access if r["status"] == "ok"]
    assert len(ok) == 5
    assert {r["req_id"] for r in ok} <= {r["attrs"]["req_id"] for r in by_name["admission"]}
    for phase in ("stage", "device", "resolve"):
        spans = by_name[phase]
        assert len(spans) == len({r["batch_seq"] for r in ok})
        ids = sorted(i for r in spans for i in r["attrs"]["req_ids"])
        assert ids == sorted(r["req_id"] for r in ok), phase
    # A batch's spans and its access records name the same requests.
    for r in by_name["device"]:
        batch = [a for a in ok if a["req_id"] in r["attrs"]["req_ids"]]
        assert {a["batch_seq"] for a in batch} == {batch[0]["batch_seq"]}
        assert {a["bucket"] for a in batch} == {r["attrs"]["bucket"]}


def test_obs_trace_is_accepted_by_every_entry_point():
    from dwt_tpu_torch.cli import officehome, usps_mnist, visda
    from dwt_tpu_torch.serve import server

    for cli, to_cfg in ((usps_mnist, usps_mnist.config_from_args),
                        (officehome, officehome.config_from_args),
                        (visda, officehome.config_from_args)):
        cfg = to_cfg(cli.build_parser().parse_args(["--obs_trace", "t.json", "--device", "cpu"]))
        assert cfg.obs_trace == "t.json"
    args = server.build_parser().parse_args(["--init_random", "--obs_trace", "t.json"])
    assert args.obs_trace == "t.json"
    assert server.build_plan(args).mode == "single"  # tracing is not refused


# ------------------------------------------------- checkpoint byte counters


@pytest.mark.parametrize("fmt", ["full", "delta"])
def test_checkpoint_writes_feed_the_byte_counter_and_the_heartbeat(tmp_path, fmt):
    """Every save adds its bytes to ``dwt_ckpt_bytes_written_total{mode}``
    (as the JAX savers count them: a full save's files, a delta save's new
    blobs and manifest — the ``checkpoint`` record's ``bytes``), the
    ``dwt_ckpt_dir_bytes`` gauge reads the tree on disk, and the
    heartbeats after the first save carry both."""
    from dwt_tpu_torch.ckpt.store import tree_bytes
    from dwt_tpu_torch.cli import usps_mnist
    from dwt_tpu_torch.obs.registry import get_registry

    reg = get_registry()

    def written():
        return {m: reg.value("dwt_ckpt_bytes_written_total", {"mode": m}) or 0.0
                for m in ("full", "delta")}

    before = written()
    ck, jsonl = tmp_path / "ck", tmp_path / "run.jsonl"
    usps_mnist.main(["--synthetic", "--synthetic_size", "32", "--source_batch_size", "8",
                     "--target_batch_size", "8", "--test_batch_size", "16",
                     "--group_size", "4", "--epochs", "3", "--num_workers", "0",
                     "--heartbeat_every", "2", "--ckpt_every_epochs", "1",
                     "--ckpt_format", fmt, "--ckpt_dir", str(ck),
                     "--metrics_jsonl", str(jsonl), "--device", "cpu"])
    records = [json.loads(line) for line in open(jsonl)]
    saves = [r for r in records if r["kind"] == "checkpoint"]
    after = written()
    grown = {m: after[m] - before[m] for m in after}
    assert len(saves) == 3 and sum(grown.values()) == sum(r["bytes"] for r in saves)
    if fmt == "full":
        assert grown["delta"] == 0
    else:  # the first save of a chain is a full one, then deltas
        assert grown["full"] > 0 and grown["delta"] > 0
    assert reg.value("dwt_ckpt_dir_bytes") == tree_bytes(str(ck))
    first_save = min(r["step"] for r in saves)
    beats = [r for r in records if r["kind"] == "heartbeat" and r["step"] > first_save]
    assert beats and all(b["ckpt_bytes_written"] > 0 and b["ckpt_dir_bytes"] > 0
                         for b in beats)


def test_the_serve_bench_exports_its_trace(tmp_path, capsys):
    """``tools/torch_serve_bench.py --obs_trace``: the bench's in-process
    server traces its load and exports the trace when it closes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_torch_serve_bench_obs", os.path.join(REPO, "tools", "torch_serve_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    path = str(tmp_path / "bench.trace.json")
    assert bench.main(["--model", "lenet", "--init_random", "--device", "cpu",
                       "--buckets", "1,8", "--loads", "40", "--duration_s", "0.5",
                       "--warmup_requests", "2", "--obs_trace", path]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    trace = json.load(open(path))
    assert obs.validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"admission", "plan", "build_batch", "stage", "device", "resolve"} <= names
    admitted = sum(1 for e in trace["traceEvents"] if e.get("name") == "admission")
    assert admitted >= record["served"] + 2  # the load and the warm-up
