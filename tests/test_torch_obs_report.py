"""The port's digits spans held to the JAX package's, and the port's attribution report.

One traced digits run (``tests/test_obs.py``'s fixture flags) goes
through both packages' CLIs.  Per span category the two traces must have
the same span names, the same parent→child pairs (by containment on one
thread) and the same count of each span on the loop's thread
(:func:`assert_spans_match`, which ``tests/test_torch_obs_officehome.py``
applies to an OfficeHome run).  A JAX span may be missing from the port
only if its module waits for multi-process training (``ITEM8_SPANS``).
Both harvesters treat their copies as not landed at ``put`` (as the JAX
harvester on the CPU finds them), so the drain spans fall where the JAX
run's fall.  ``tools/torch_obs_report.py`` and ``tools/obs_report.py``
give the same report of the same trace, each accounting for 100% of the
loop's wall time, and ``tools/obs_diff.py`` self-diffs a port report with
exit 0.
"""

from __future__ import annotations

import collections
import json
import os
import sys

import pytest
import torch

from dwt_tpu import obs as jax_obs
from dwt_tpu.cli import usps_mnist as jax_usps_mnist
from dwt_tpu.train import harvest as jax_harvest
from dwt_tpu_torch import obs
from dwt_tpu_torch.cli import usps_mnist
from dwt_tpu_torch.train import harvest

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import obs_diff  # noqa: E402
import obs_report  # noqa: E402
import torch_obs_report  # noqa: E402

sys.path.pop(0)

# Spans the JAX package opens in modules the port has not got yet: the
# sharded placement and gather of parallel/plan.py, the sharded restore
# and the multi-host shard writer — all multi-process (ROADMAP queue 1
# item 8).  Nothing else may be missing from the port.
ITEM8_SPANS = {"shard_put", "gather", "restore_place", "shard_write"}

DIGITS_ARGS = ["--synthetic", "--synthetic_size", "32",
               "--source_batch_size", "8", "--target_batch_size", "8",
               "--test_batch_size", "16", "--group_size", "4",
               "--epochs", "2", "--log_interval", "2", "--heartbeat_every", "2"]
LOOP_SPANS = {"batch_wait", "step_dispatch", "boundary", "eval_pass", "eval_dispatch",
              "batch_build", "h2d_stage", "metric_copy_start", "harvest_drain",
              "metric_host_fetch"}


def copies_in_flight(mp: pytest.MonkeyPatch) -> None:
    """Both harvesters find their copies still in flight at ``put``: the
    JAX harvester's are on the CPU (asynchronous dispatch); the port's CPU
    tensors would be ready at once."""
    mp.setattr(jax_harvest._Entry, "ready", lambda self: False)
    mp.setattr(harvest._Entry, "ready", lambda self: False)


def traced(main, argv, package_obs):
    """One CLI run with tracing on; its spans, as the tracer holds them."""
    package_obs.disable()
    try:
        main(argv)
        return package_obs.snapshot()
    finally:
        package_obs.disable()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_runs")
    mp = pytest.MonkeyPatch()
    copies_in_flight(mp)
    out = {}
    try:
        for name, main, extra, package_obs in (
                ("jax", jax_usps_mnist.main, [], jax_obs),
                ("port", usps_mnist.main, ["--device", "cpu"], obs)):
            trace, jsonl = str(tmp / f"{name}.trace.json"), str(tmp / f"{name}.jsonl")
            spans = traced(main, DIGITS_ARGS + extra + ["--obs_trace", trace,
                                                        "--metrics_jsonl", jsonl],
                           package_obs)
            out[name] = {"spans": spans, "trace": trace, "jsonl": jsonl}
    finally:
        mp.undo()
    return out


def _structure(spans):
    """Per category: span names, (parent, child) pairs by containment on
    one thread, and the loop thread's span counts."""
    names = collections.defaultdict(set)
    pairs = collections.defaultdict(set)
    counts = collections.defaultdict(collections.Counter)
    loop_tid = next(s["tid"] for s in spans if s["name"] == "step_dispatch")
    by_tid = collections.defaultdict(list)
    for s in spans:
        if s["name"] in ITEM8_SPANS:
            continue
        names[s["cat"]].add(s["name"])
        by_tid[s["tid"]].append(s)
        if s["tid"] == loop_tid:
            counts[s["cat"]][s["name"]] += 1
    for group in by_tid.values():
        stack = []
        for s in sorted(group, key=lambda s: (s["ts"], -s["dur"])):
            end = s["ts"] + s["dur"]
            while stack and not (s["ts"] >= stack[-1]["ts"]
                                 and end <= stack[-1]["ts"] + stack[-1]["dur"]):
                stack.pop()
            pairs[s["cat"]].add((stack[-1]["name"] if stack else None, s["name"]))
            stack.append(s)
    return names, pairs, counts


def assert_spans_match(ours_spans, ref_spans, expected):
    """Per category: the names, parent→child pairs and loop-thread counts
    of the port's spans are the JAX run's; ``expected`` names are there."""
    ours, ref = _structure(ours_spans), _structure(ref_spans)
    for what, a, b in zip(("names", "parent-child pairs", "loop-thread counts"), ours, ref):
        assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
        for cat in b:
            assert a[cat] == b[cat], (what, cat, a[cat], b[cat])
    assert expected <= {n for cat in ours[0].values() for n in cat}


def test_span_names_nesting_and_counts_match_jax(runs):
    assert_spans_match(runs["port"]["spans"], runs["jax"]["spans"], LOOP_SPANS)


def test_traced_cli_run_exports_a_valid_trace(runs):
    trace = json.load(open(runs["port"]["trace"]))
    assert obs.validate_chrome_trace(trace) == []
    assert trace["otherData"]["producer"] == "dwt_tpu_torch.obs"
    exported = collections.Counter(e["name"] for e in trace["traceEvents"] if e["ph"] == "X")
    assert exported == collections.Counter(s["name"] for s in runs["port"]["spans"])


def _report(module, run):
    return module.build_report([run["trace"]], [run["jsonl"]])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_both_report_tools_agree_and_account_for_all_the_wall_time(runs, package):
    run = runs[package]
    ours, ref = _report(torch_obs_report, run), _report(obs_report, run)
    assert ours == ref
    tb = ours["processes"]["0"]["train"]
    assert tb["n_steps"] == 2 * (32 // 8)
    attributed = sum(p["self_s"] for p in tb["phases"].values())
    # Exact but for the report's rounding of each row to the microsecond.
    rows = len(tb["phases"]) + 1
    assert attributed + tb["unattributed_s"] == pytest.approx(tb["wall_s"], abs=5e-7 * rows)
    shares = sum(p["share"] for p in tb["phases"].values())
    assert shares + tb["unattributed_share"] == pytest.approx(1.0, abs=1e-4)
    assert {"step_dispatch", "batch_wait", "harvest_drain"} <= set(tb["phases"])
    assert ours["metrics"]["heartbeat"]["count"] >= 1


def test_the_port_report_prints_100_percent_and_self_diffs(runs, tmp_path, capsys):
    run = runs["port"]
    report = str(tmp_path / "report.json")
    assert torch_obs_report.main([run["trace"], "--metrics", run["jsonl"],
                                  "--json", report]) == 0
    out = capsys.readouterr().out
    assert "unattributed" in out and "100.0%" in out
    assert json.load(open(report))["kind"] == "obs_report"
    assert obs_diff.main([report, report]) == 0
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert torch_obs_report.main([str(empty)]) == 2
