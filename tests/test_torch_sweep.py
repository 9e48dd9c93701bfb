"""The port's sweep control plane against the JAX package's: the journal and
its adoption policy, the supervisor over framework-free fake jobs, the three
sweep fault kinds, and both CLIs' parsing, refusals and verdict gate.

Scheduling policy does not depend on what a job computes, so the jobs here
are ``python -c`` scripts that write a result, crash, park once with a
``preempt`` record, or wedge (the kinds of ``tests/test_sweep_supervisor.py``),
and each case runs the same jobs under both packages' ``SweepSupervisor``.
The supervisor's end-to-end runs over real training jobs are in
``tests/test_torch_sweep_e2e.py`` and ``tests/test_torch_sweep_chaos.py``.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from dwt_tpu.cli import officehome as jax_oh
from dwt_tpu.cli import officehome_sweep as jax_oh_sweep
from dwt_tpu.obs import registry as jax_registry
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu.sweep import cli as jax_cli
from dwt_tpu.sweep import journal as jax_jnl
from dwt_tpu.sweep import supervisor as jax_sup
from dwt_tpu_torch.cli import officehome as oh
from dwt_tpu_torch.cli import officehome_sweep as oh_sweep
from dwt_tpu_torch.obs import registry
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.sweep import cli
from dwt_tpu_torch.sweep import journal as jnl
from dwt_tpu_torch.sweep import supervisor as sup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"ours": (sup, jnl, registry, inject), "jax": (jax_sup, jax_jnl, jax_registry,
                                                         jax_inject)}
FAST = dict(poll_interval_s=0.02, backoff_s=0.01)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh metric registries, no armed plan, and the signal handlers the
    supervisors install put back."""
    monkeypatch.setattr(registry, "_DEFAULT", registry.MetricsRegistry())
    monkeypatch.setattr(jax_registry, "_DEFAULT", jax_registry.MetricsRegistry())
    monkeypatch.delenv(inject.ENV_VAR, raising=False)
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    yield
    for s, h in handlers.items():
        signal.signal(s, h)
    inject.disarm()
    jax_inject.disarm()


# ------------------------------------------------------------- journal


def _masked(path):
    """A journal file with its pids masked (they differ between runs)."""
    payload = json.load(open(path))
    for e in payload["pairs"].values():
        e["pid"] = None if e["pid"] is None else "pid"
    return payload


def test_journal_sequence_writes_the_jax_json(tmp_path):
    out = {}
    for name, (_, j_mod, _, _) in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        path = str(root / j_mod.JOURNAL_NAME)
        j = j_mod.SweepJournal(path)
        j.ensure_pairs([("A", "B"), ("B", "A"), ("A", "C")], lambda tag: f"/runs/{tag}")
        j.update("A2B", status=j_mod.RUNNING, pid=os.getpid(), attempts=1)
        j.update("B2A", status=j_mod.QUARANTINED, crashes=2, reason="crashed rc=3")
        j.update("A2C", status=j_mod.DONE, accuracy=51.5, pid=None)
        j.save()
        assert [n for n in os.listdir(root) if ".tmp-" in n] == []
        reread = j_mod.SweepJournal.load(path)
        assert reread.pairs == j.pairs and not reread.all_settled()
        assert [e["tag"] for e in reread.by_status(j_mod.RUNNING)] == ["A2B"]
        out[name] = _masked(path)
    assert out["ours"] == out["jax"]


@pytest.mark.parametrize("status", ["pending", "running", "done", "quarantined"])
@pytest.mark.parametrize("process", ["alive", "dead", "recycled", "never_spawned"])
@pytest.mark.parametrize("token", ["run_dir", "none"])
def test_decide_adoption_agrees_with_jax(status, process, token):
    run_dir = "/runs/A2B"
    entry = {"status": status, "pid": None if process == "never_spawned" else 4242,
             "run_dir": run_dir if token == "run_dir" else None}

    def alive(pid, tok):
        if process in ("dead", "never_spawned") or not pid:
            return False
        # A recycled pid is live but carries another command line.
        return process == "alive" or tok is None

    ours = jnl.decide_adoption(dict(entry), alive=alive)
    assert ours == jax_jnl.decide_adoption(dict(entry), alive=alive)
    assert ours == ("keep" if status != "running" else
                    "adopt" if process == "alive" or (process == "recycled" and token == "none")
                    else "reschedule")


def test_job_process_alive_checks_the_cmdline_token_as_jax(tmp_path):
    token = str(tmp_path / "some_run_dir")
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)", token])
    try:
        deadline = time.monotonic() + 5
        while not jnl.job_process_alive(proc.pid, token) and time.monotonic() < deadline:
            time.sleep(0.05)
        for mod in (jnl, jax_jnl):
            assert mod.job_process_alive(proc.pid, token)
            assert mod.job_process_alive(proc.pid)
            assert not mod.job_process_alive(proc.pid, "/definitely/not/there")
            assert not mod.job_process_alive(None, token)
    finally:
        proc.kill()
        proc.wait()
    assert not jnl.job_process_alive(proc.pid, token)
    assert not jax_jnl.job_process_alive(proc.pid, token)


@pytest.mark.parametrize("case", ["unreadable", "stale_matrix", "unknown_tag"])
def test_journal_refusals_match_jax(tmp_path, case):
    errors = {}
    for name, (_, j_mod, _, _) in PACKAGES.items():
        root = tmp_path / name
        root.mkdir()
        path = str(root / "sweep.json")
        try:
            if case == "unreadable":
                open(path, "w").write("{not json")
                j_mod.SweepJournal.load(path)
            elif case == "stale_matrix":
                j_mod.SweepJournal(path).ensure_pairs([("A", "B")], lambda t: t)
                j_mod.SweepJournal.load(path).ensure_pairs([("X", "Y")], lambda t: t)
            else:
                j = j_mod.SweepJournal(path)
                j.ensure_pairs([("A", "B")], lambda t: t)
                j.update("A2C", status=j_mod.DONE)
        except Exception as e:  # noqa: BLE001 — the class is the assertion
            errors[name] = (type(e), str(e).replace(str(root), "ROOT"))
    assert errors["ours"] == errors["jax"]
    assert errors["ours"][0] is (KeyError if case == "unknown_tag" else RuntimeError)


# ------------------------------------------- supervisor with fake jobs


def _ok_job(spec):
    code = ("import json, sys\n"
            "json.dump({'pairs': {sys.argv[2]: 1.0}}, open(sys.argv[1], 'w'))\n")
    return [sys.executable, "-c", code, spec.result_json, spec.pair_key, spec.run_dir]


def _crash_job(spec):
    return [sys.executable, "-c", "import sys; sys.exit(3)", spec.run_dir]


def _preempt_once_job(spec):
    """First spawn: a ``preempt`` record and exit 0; the second finishes."""
    code = ("import json, os, sys\n"
            "run, res, key, metrics = sys.argv[1:5]\n"
            "marker = os.path.join(run, 'preempted_once')\n"
            "if not os.path.exists(marker):\n"
            "    open(marker, 'w').close()\n"
            "    with open(metrics, 'a') as f:\n"
            "        f.write(json.dumps({'kind': 'preempt', 'step': 1}) + '\\n')\n"
            "    sys.exit(0)\n"
            "json.dump({'pairs': {key: 0.5}}, open(res, 'w'))\n")
    return [sys.executable, "-c", code, spec.run_dir, spec.result_json, spec.pair_key,
            spec.metrics_jsonl]


def _wedged_job(spec):
    return [sys.executable, "-c", "import time; time.sleep(600)", spec.run_dir]


def _mixed(spec):
    return {"A2B": _crash_job, "B2A": _preempt_once_job}.get(spec.tag, _ok_job)(spec)


MATRICES = {
    "ok_over_two_slots": ([("A", "B"), ("B", "A"), ("A", "C")], _ok_job, dict(slots=2)),
    "crash_quarantined": ([("A", "B"), ("B", "A")],
                          lambda s: _crash_job(s) if s.tag == "A2B" else _ok_job(s),
                          dict(slots=2, job_max_respawns=2)),
    "preempt_is_free": ([("A", "B")], _preempt_once_job, dict(slots=1, job_max_respawns=1)),
    "wedged_stalls": ([("A", "B")], _wedged_job,
                      dict(slots=1, job_max_respawns=1, stall_timeout_s=0.3)),
    "mixed_one_slot": ([("A", "B"), ("B", "A"), ("A", "C")], _mixed,
                       dict(slots=1, job_max_respawns=2)),
}


def _run_both(tmp_path, pairs, argv_fn, **kw):
    out = {}
    for name, (s_mod, _, reg, _) in PACKAGES.items():
        s = s_mod.SweepSupervisor(pairs, str(tmp_path / name), argv_fn, **FAST, **kw)
        summary = s.run()
        adopted = reg.get_registry().value("dwt_sweep_adopted_total")
        out[name] = (summary, adopted, s)
    return out


@pytest.mark.parametrize("matrix", sorted(MATRICES))
def test_supervisor_summary_matches_jax(tmp_path, matrix):
    pairs, argv_fn, kw = MATRICES[matrix]
    t0 = time.monotonic()
    out = _run_both(tmp_path, pairs, argv_fn, **kw)
    assert time.monotonic() - t0 < 60
    (ours, ours_adopted, s), (ref, ref_adopted, _) = out["ours"], out["jax"]
    assert ours == ref and ours_adopted == ref_adopted == 0
    if matrix == "crash_quarantined":
        assert ours["quarantined"] == {"A2B": "crashed rc=3 (2 crash(es), budget 2)"}
        assert ours["respawns"] == {"A2B": 2} and ours["pairs"] == {"B->A": 1.0}
    if matrix == "preempt_is_free":
        assert ours["preempt_resumes"] == {"A2B": 1} and ours["respawns"] == {}
    if matrix == "wedged_stalls":
        assert "stalled" in ours["quarantined"]["A2B"]
    # The journal on disk is the result of record.
    assert _masked(s.journal.path)["pairs"].keys() == {f"{a}2{b}" for a, b in pairs}


def _orphan(spec, acc=0.9, sleep_s=0.4):
    code = ("import json, sys, time\n"
            "json.dump({'pairs': {sys.argv[2]: %r}}, open(sys.argv[1], 'w'))\n"
            "time.sleep(%r)\n" % (acc, sleep_s))
    os.makedirs(spec.run_dir, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", code, spec.result_json, spec.pair_key,
                             spec.run_dir])


def test_relaunch_adopts_a_live_job_and_reschedules_a_dead_one_as_jax(tmp_path):
    """The predecessor's wake: A2B's job still runs (its run dir on its
    cmdline), B2A's died with the predecessor before it spawned."""
    pairs = [("A", "B"), ("B", "A")]
    out = {}
    for name, (s_mod, j_mod, reg, _) in PACKAGES.items():
        root = tmp_path / name
        specs = {f"{s}2{t}": s_mod.JobSpec(s, t, str(root / f"{s}2{t}")) for s, t in pairs}
        orphan = _orphan(specs["A2B"])
        try:
            j = j_mod.SweepJournal(str(root / j_mod.JOURNAL_NAME))
            j.ensure_pairs(pairs, lambda tag: specs[tag].run_dir)
            j.update("A2B", status=j_mod.RUNNING, pid=orphan.pid, attempts=1)
            j.update("B2A", status=j_mod.RUNNING, pid=None, attempts=1)
            summary = s_mod.SweepSupervisor(pairs, str(root), _ok_job, slots=2,
                                            **FAST).run()
        finally:
            if orphan.poll() is None:
                orphan.kill()
            orphan.wait()
        out[name] = (summary, reg.get_registry().value("dwt_sweep_adopted_total"))
    assert out["ours"] == out["jax"]
    summary, adopted = out["ours"]
    # The adopted job's own result stands (a respawn would have written 1.0).
    assert summary["pairs"] == {"A->B": 0.9, "B->A": 1.0} and adopted == 1


def test_relaunch_frees_a_job_preempted_while_unsupervised_as_jax(tmp_path):
    """A journaled running job that parked (exit 0, a new ``preempt``
    record) while no supervisor watched is rescheduled free, not done."""
    pairs = [("A", "B")]
    out = {}
    for name, (s_mod, j_mod, _, _) in PACKAGES.items():
        root = tmp_path / name
        spec = s_mod.JobSpec("A", "B", str(root / "A2B"))
        os.makedirs(spec.run_dir)
        with open(spec.metrics_jsonl, "w") as f:
            f.write(json.dumps({"kind": "preempt", "step": 3}) + "\n")
        json.dump({"pairs": {spec.pair_key: 12.5}}, open(spec.result_json, "w"))
        j = j_mod.SweepJournal(str(root / j_mod.JOURNAL_NAME))
        j.ensure_pairs(pairs, lambda tag: spec.run_dir)
        j.update("A2B", status=j_mod.RUNNING, pid=None, attempts=1, preempt_baseline=0)
        out[name] = s_mod.SweepSupervisor(pairs, str(root), _ok_job, slots=1, **FAST).run()
    assert out["ours"] == out["jax"]
    assert out["ours"]["pairs"] == {"A->B": 1.0}
    assert out["ours"]["preempt_resumes"] == {"A2B": 1}


def test_injected_preemption_and_job_fault_reach_the_jobs_as_jax(tmp_path):
    """``sweep_preempt_pairs``: notice file, then SIGTERM; the fake job
    parks on the SIGTERM with a ``preempt`` record and finishes on its
    resume.  ``sweep_job_kill_mid_save``: the pair's first spawn sees
    ``{"kill_mid_delta_promote": true}`` in ``DWT_FAULT_PLAN``, its respawn
    none (the fake job records what it saw and crashes on the plan)."""
    code = ("import json, os, signal, sys, time\n"
            "run, res, key, metrics, notice, wait_s = sys.argv[1:7]\n"
            "plan = os.environ.get('DWT_FAULT_PLAN')\n"
            "open(os.path.join(run, 'plans'), 'a').write(repr(plan) + '\\n')\n"
            "if plan: sys.exit(9)\n"
            "parked = []\n"
            "signal.signal(signal.SIGTERM, lambda *a: parked.append(1))\n"
            "with open(metrics, 'a') as f:\n"
            "    f.write(json.dumps({'kind': 'train', 'step': 1}) + '\\n')\n"
            "marker = os.path.join(run, 'preempted_once')\n"
            "deadline = time.monotonic() + (0 if os.path.exists(marker) else float(wait_s))\n"
            "while time.monotonic() < deadline and not parked:\n"
            "    time.sleep(0.01)\n"
            "if parked:\n"
            "    open(marker, 'w').write(str(os.path.exists(notice)))\n"
            "    with open(metrics, 'a') as f:\n"
            "        f.write(json.dumps({'kind': 'preempt', 'step': 1}) + '\\n')\n"
            "    sys.exit(0)\n"
            "json.dump({'pairs': {key: 0.25}}, open(res, 'w'))\n")

    def argv_fn(spec):
        os.makedirs(spec.run_dir, exist_ok=True)
        # Only the preempted pair waits for its SIGTERM.
        return [sys.executable, "-c", code, spec.run_dir, spec.result_json, spec.pair_key,
                spec.metrics_jsonl, spec.notice_file, "20" if spec.tag == "B2A" else "0"]

    plan = {"sweep_preempt_pairs": ["B2A"], "sweep_job_kill_mid_save": ["A2B"]}
    out = {}
    for name, (s_mod, _, _, i_mod) in PACKAGES.items():
        i_mod.arm(i_mod.FaultPlan.from_spec(plan))
        root = tmp_path / name
        summary = s_mod.SweepSupervisor([("A", "B"), ("B", "A")], str(root), argv_fn,
                                        slots=2, job_max_respawns=2, **FAST).run()
        i_mod.disarm()
        seen = {tag: open(root / tag / "plans").read().splitlines()
                for tag in ("A2B", "B2A")}
        out[name] = (summary, seen, open(root / "B2A" / "preempted_once").read())
    assert out["ours"] == out["jax"]
    summary, seen, notice_seen = out["ours"]
    assert summary["respawns"] == {"A2B": 1} and summary["preempt_resumes"] == {"B2A": 1}
    assert seen["A2B"] == ["'{\"kill_mid_delta_promote\": true}'", "None"]
    assert seen["B2A"] == ["None", "None"] and notice_seen == "True"


def test_supervisor_metrics_carry_each_job_under_a_pair_label(tmp_path):
    """The aggregated exposition: the supervisor's registry, then a running
    job's own ``/metrics`` under ``pair`` (an exporter record names its
    port), valid and equal to the JAX supervisor's render."""
    from dwt_tpu.obs import prom as jax_prom
    from dwt_tpu_torch.obs import prom

    job_reg = registry.MetricsRegistry()
    job_reg.counter("dwt_train_steps_total", "steps").inc(7)
    exporter = prom.start_exporter(0, render_fn=lambda: prom.render(job_reg))
    try:
        rendered = {}
        for name, (s_mod, _, _, _) in PACKAGES.items():
            s = s_mod.SweepSupervisor([("A", "B")], str(tmp_path / name), _ok_job, slots=1,
                                      **FAST)
            spec = s.specs["A2B"]
            os.makedirs(spec.run_dir)
            with open(spec.metrics_jsonl, "w") as f:
                f.write(json.dumps({"kind": "metrics_exporter", "step": 0,
                                    "port": exporter.server_address[1]}) + "\n")
            s.running["A2B"] = s_mod._RunningJob(spec=spec, proc=None, pid=os.getpid(),
                                                 spawned_at=0.0, preempts_at_spawn=0)
            rendered[name] = s._render_metrics()
            s.running.clear()
    finally:
        # stop_exporter also forgets the process's exporter, so a later
        # test's start_exporter does not get this closed one back.
        prom.stop_exporter()
    ours = rendered["ours"]
    assert ours == rendered["jax"]
    assert prom.validate_exposition(ours) == [] == jax_prom.validate_exposition(ours)
    assert 'dwt_train_steps_total{pair="A2B"} 7' in ours
    assert 'dwt_sweep_pairs{state="pending"} 1' in ours


def test_gc_shared_store_refcounts_every_run_as_jax(tmp_path):
    """Cross-run GC: a blob only a sibling run references stays; an aged
    orphan goes; a young one stays."""
    import numpy as np

    from dwt_tpu.ckpt import store as jax_store

    out = {}
    for name, (s_mod, _, _, _) in PACKAGES.items():
        root = tmp_path / name
        s = s_mod.SweepSupervisor([("A", "B"), ("B", "A")], str(root), _ok_job,
                                  blob_store=str(root / "blobs"), gc_min_age_s=60, **FAST)
        for i, tag in enumerate(("A2B", "B2A")):
            jax_store.save_delta(s.specs[tag].ckpt_tree, 1,
                                 {"params": {"w": np.full((4,), i, np.float32)}},
                                 store_root=str(root / "blobs"), gc=False)
        for digest, age in (("ab" * 32, 3600), ("cd" * 32, 0)):
            os.makedirs(root / "blobs" / digest[:2], exist_ok=True)
            p = root / "blobs" / digest[:2] / (digest + ".bin")
            p.write_bytes(b"x")
            os.utime(p, (time.time() - age, time.time() - age))
        out[name] = (s.gc_shared_store(), sorted(
            n for d in os.listdir(root / "blobs") for n in os.listdir(root / "blobs" / d)))
    assert out["ours"][0] == out["jax"][0] == (1, 1)
    assert out["ours"][1] == out["jax"][1] and len(out["ours"][1]) == 3


# ---------------------------------------------------------- fault kinds


SWEEP_SPECS = [
    {"kill_supervisor_at_schedule": 3},
    {"kill_supervisor_at_schedule": 0},
    {"kill_supervisor_at_schedule": True},
    {"kill_supervisor_at_schedule": "3"},
    {"sweep_preempt_pairs": ["Art2Clipart", "Clipart2Art"]},
    {"sweep_preempt_pairs": "Art2Clipart"},
    {"sweep_preempt_pairs": []},
    {"sweep_preempt_pairs": ["A2B", "A2B"]},
    {"sweep_preempt_pairs": [""]},
    {"sweep_preempt_pairs": [3]},
    {"sweep_job_kill_mid_save": ["Art2Clipart"]},
    {"sweep_job_kill_mid_save": "Art2Clipart"},
    {"sweep_job_kill_mid_save": []},
    {"sweep_job_kill_mid_save": ["A2B", "A2B"]},
    {"sweep_job_kill_mid_save": ["Art2Clipart"], "sweep_preempt_pairs": ["Clipart2Art"],
     "kill_supervisor_at_schedule": 3},
]


def _outcome(build, spec):
    try:
        plan = build(spec)
    except ValueError as e:
        return "refused", str(e)
    return "accepted", {k: getattr(plan, k) for k in spec}


@pytest.mark.parametrize("spec", SWEEP_SPECS, ids=lambda s: json.dumps(s))
def test_sweep_fault_kinds_accepted_and_refused_as_jax(spec):
    ours = _outcome(inject.FaultPlan.from_spec, spec)
    ref = _outcome(jax_inject.FaultPlan.from_spec, spec)
    assert ours[0] == ref[0], (ours, ref)
    if ours[0] == "accepted":
        assert ours[1] == ref[1]
    else:
        assert ours[1] == ref[1].replace("dwt_tpu", "dwt_tpu_torch") or ours[1] == ref[1]


def test_take_sweep_hooks_return_what_jax_returns_once_per_tag():
    spec = {"sweep_preempt_pairs": ["A2B", "C2D"], "sweep_job_kill_mid_save": ["A2B"]}
    calls = [("preempt", "B2A"), ("preempt", "A2B"), ("preempt", "A2B"), ("job", "C2D"),
             ("job", "A2B"), ("job", "A2B"), ("preempt", "C2D"), ("preempt", "C2D")]
    got = {}
    for name, mod in (("ours", inject), ("jax", jax_inject)):
        mod.arm(mod.FaultPlan.from_spec(spec))
        got[name] = [mod.take_sweep_preempt(t) if kind == "preempt"
                     else mod.take_sweep_job_fault(t) for kind, t in calls]
        assert mod.current().sweep_preempt_pairs is None
        assert mod.current().sweep_job_kill_mid_save is None
        mod.disarm()
    assert got["ours"] == got["jax"] == [False, True, False, None,
                                         {"kill_mid_delta_promote": True}, None, True, False]
    # Without a plan every hook is a no-op.
    assert inject.take_sweep_preempt("A2B") is False
    assert inject.take_sweep_job_fault("A2B") is None
    inject.maybe_kill_supervisor_at_schedule(1)


def test_kill_supervisor_at_schedule_sigkills_at_the_armed_event_only(tmp_path):
    code = ("import sys\n"
            "from dwt_tpu_torch.resilience import inject\n"
            "for event in range(1, 6):\n"
            "    inject.maybe_kill_supervisor_at_schedule(event)\n"
            "    print(event, flush=True)\n")
    env = {**os.environ, inject.ENV_VAR: json.dumps({"kill_supervisor_at_schedule": 3})}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == -signal.SIGKILL
    assert out.stdout.split() == ["1", "2"]
    env.pop(inject.ENV_VAR)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.split() == ["1", "2", "3", "4", "5"]


# ------------------------------------------------------------------ CLIs


@pytest.mark.parametrize("domains,pairs", [
    ("A,B,C", None), ("Art,Clipart,Product,RealWorld", None), ("A,B", "A:B, B:A"),
    ("A,B", "A:B,,B:A"), ("A,B", "A-B"), ("A,B", "A:B,A:B"), ("", None), ("A", None)])
def test_parse_pairs_agrees_with_jax(domains, pairs):
    def outcome(fn):
        try:
            return fn(domains, pairs)
        except SystemExit as e:
            return ("exit", str(e))

    assert outcome(cli.parse_pairs) == outcome(jax_cli.parse_pairs)


@pytest.mark.parametrize("blob_store", [None, "/sweep/blobs"])
def test_make_argv_fn_agrees_with_jax_but_the_module(tmp_path, blob_store):
    spec = sup.JobSpec("Art", "Clipart", str(tmp_path / "Art2Clipart"))
    jax_spec = jax_sup.JobSpec("Art", "Clipart", str(tmp_path / "Art2Clipart"))
    job = ["--synthetic", "--device", "cpu"]
    ours = cli.make_argv_fn(job, blob_store, python="PY")(spec)
    ref = jax_cli.make_argv_fn(job, blob_store, python="PY")(jax_spec)
    assert ours[:3] == ["PY", "-m", "dwt_tpu_torch.cli.officehome_sweep"]
    assert ref[:3] == ["PY", "-m", "dwt_tpu.cli.officehome_sweep"]
    assert ours[3:] == ref[3:]
    assert ours.count("--ckpt_dir") == 1 and spec.notice_file in ours
    # The path contract, property by property.
    for prop in ("tag", "pair_key", "result_json", "ckpt_base", "ckpt_tree", "metrics_base",
                 "metrics_jsonl", "notice_file", "log_file"):
        assert getattr(spec, prop) == getattr(jax_spec, prop)


@pytest.mark.parametrize("flag", ["--ckpt_dir", "--metrics_jsonl", "--results_json",
                                  "--preempt_notice_file", "--blob_store", "--metrics_port",
                                  "--pairs", "--expect_table", "--expect_accuracy"])
def test_sweep_cli_refuses_the_flags_it_owns(tmp_path, flag):
    assert flag in cli._RESERVED_JOB_FLAGS and flag in jax_cli._RESERVED_JOB_FLAGS
    argv = ["--sweep_root", str(tmp_path), "--pairs", "A:B", "--", "--synthetic", flag, "x"]
    for mod in (cli, jax_cli):
        with pytest.raises(SystemExit, match="owns"):
            mod.main(argv)
    assert not os.path.exists(tmp_path / "sweep.json")


def _verdict_run(tmp_path, mod, name, table, accuracies, monkeypatch):
    """The sweep CLI end to end, its jobs fake ones that write the canned
    accuracy of their pair."""
    def argv_fn(job_argv, blob_store, python=sys.executable):
        def build(spec):
            code = ("import json, sys\n"
                    "json.dump({'pairs': {sys.argv[2]: float(sys.argv[3])}}, "
                    "open(sys.argv[1], 'w'))\n")
            return [sys.executable, "-c", code, spec.result_json, spec.pair_key,
                    str(accuracies[spec.tag]), spec.run_dir]
        return build

    monkeypatch.setattr(mod, "make_argv_fn", argv_fn)
    root = tmp_path / name
    argv = ["--sweep_root", str(root), "--pairs", "Art:Clipart,Clipart:Art",
            "--poll_interval_s", "0.02", "--tolerance", "0.5"]
    if table is not None:
        (tmp_path / "expect.json").write_text(json.dumps(table))
        argv += ["--expect_table", str(tmp_path / "expect.json")]
    try:
        rc = mod.main(argv + ["--", "--synthetic"])
    except SystemExit as e:
        return ("exit", str(e).replace("dwt_tpu_torch", "dwt_tpu")), None
    return rc, json.load(open(root / "results.json"))


@pytest.mark.parametrize("table,rc", [
    ({"Art->Clipart": 50.0, "Clipart->Art": None}, 0),
    ({"Art->Clipart": 60.0, "Clipart->Art": 47.5}, 1),
    ({"Art->Porduct": 50.0}, None),
    (None, 0)])
def test_sweep_cli_verdict_gate_as_jax(tmp_path, monkeypatch, table, rc):
    accuracies = {"Art2Clipart": 50.1, "Clipart2Art": 47.7}
    ours = _verdict_run(tmp_path, cli, "ours", table, accuracies, monkeypatch)
    ref = _verdict_run(tmp_path, jax_cli, "jax", table, accuracies, monkeypatch)
    assert ours == ref
    if rc is None:
        assert ours[0][0] == "exit" and "match no planned pair" in ours[0][1]
        assert not os.path.exists(tmp_path / "ours" / "sweep.json")
    else:
        assert ours[0] == rc and ours[1]["completed"] == 2
        assert ("verdicts" in ours[1]) == (table is not None)


# --------------------------------------------- officehome_sweep (stubbed)


@pytest.fixture
def stub_runs(monkeypatch):
    """Per-pair training in both packages' sweeps replaced by canned
    accuracies, keyed by the metrics filename tag the sweep gives each pair."""
    calls = []

    def install(accuracies):
        def fake_run(args):
            tag = args.metrics_jsonl or f"pair{len(calls)}"
            calls.append(tag)
            for key, acc in accuracies.items():
                if key in tag:
                    return acc
            raise AssertionError(f"unexpected pair invocation: {tag}")

        monkeypatch.setattr(oh, "run_from_args", fake_run)
        monkeypatch.setattr(jax_oh, "run_from_args", fake_run)
        return calls

    return install


def _sweep_main(mod, tmp_path, name, extra, capsys):
    results = tmp_path / f"{name}.json"
    argv = ["--synthetic", "--pairs", "Art:Clipart,Clipart:Art",
            "--metrics_jsonl", str(tmp_path / "m.jsonl"), "--results_json", str(results),
            *extra]
    try:
        out = ("mean", mod.main(argv))
    except SystemExit as e:
        out = ("exit", e.code if isinstance(e.code, int) else str(e.code))
    printed = capsys.readouterr().out
    payload = json.loads(results.read_text()) if results.exists() else None
    return out, printed, payload


@pytest.mark.parametrize("table,code", [
    ({"Art->Clipart": 50.0, "Clipart->Art": None}, None),
    ({"Art->Clipart": 60.0, "Clipart->Art": 47.5}, 1)])
def test_officehome_sweep_verdicts_as_jax(tmp_path, stub_runs, capsys, table, code):
    (tmp_path / "expect.json").write_text(json.dumps(table))
    stub_runs({"Art2Clipart": 50.1, "Clipart2Art": 47.7})
    extra = ["--expect_table", str(tmp_path / "expect.json")]
    ours = _sweep_main(oh_sweep, tmp_path, "ours", extra, capsys)
    ref = _sweep_main(jax_oh_sweep, tmp_path, "jax", extra, capsys)
    assert ours == ref
    (kind, value), printed, payload = ours
    if code is None:
        assert kind == "mean" and value == pytest.approx((50.1 + 47.7) / 2)
        assert "checked=1 skipped=1 all_ok=True" in printed
        assert payload["verdicts"]["all_ok"] is True
    else:
        assert (kind, value) == ("exit", 1) and "all_ok=False" in printed
        assert payload["verdicts"]["pairs"]["Art->Clipart"]["ok"] is False


@pytest.mark.parametrize("extra,match", [
    (["--expect_accuracy", "50.0"], "expect_table"),
    (["--expect_table", "TABLE"], "match no planned pair"),
    (["--pairs", "Art:Clipart,Art:Clipart"], "duplicates"),
    (["--dataset_root", "ROOT", "--pairs", "Art:Clipart,Art:Porduct"], "domain dirs not found"),
    (["--pairs", "Art-Clipart"], "Source:Target"),
])
def test_officehome_sweep_refusals_as_jax(tmp_path, stub_runs, extra, match):
    (tmp_path / "table.json").write_text(json.dumps({"Art->Porduct": 50.0}))
    for d in ("Art", "Clipart"):
        (tmp_path / "data" / d).mkdir(parents=True)
    extra = [str(tmp_path / "table.json") if a == "TABLE" else
             str(tmp_path / "data") if a == "ROOT" else a for a in extra]
    calls = stub_runs({})
    for mod in (oh_sweep, jax_oh_sweep):
        argv = (["--synthetic"] if "--dataset_root" not in extra else []) + [
            "--pairs", "Art:Clipart,Clipart:Art", *extra]
        with pytest.raises(SystemExit, match=match):
            mod.main(argv)
    assert calls == []


def test_sweep_cli_imports_no_torch():
    """``python -m dwt_tpu_torch.sweep.cli`` loads no torch (so no CUDA
    context), nor JAX, nor the JAX package."""
    code = ("import runpy, sys\n"
            "sys.argv = ['sweep', '--help']\n"
            "try:\n"
            "    runpy.run_module('dwt_tpu_torch.sweep.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "import dwt_tpu_torch.sweep, dwt_tpu_torch.ckpt.layout\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'dwt_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
