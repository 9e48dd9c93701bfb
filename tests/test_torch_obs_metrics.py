"""Port metrics plane against the JAX package: registry, exposition, rules, access log.

The same sequence of registry operations, run on a fresh registry of
each package, must render byte-equal Prometheus text; the exposition
parser and validator, the alert rules (``rule_fires`` and
``AlertEngine`` under a fake clock), the nearest-rank percentile
helpers and the serving access log's summaries must agree on shared
inputs.  All of it is host-side Python — the tolerance is exact
equality throughout.
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest

from dwt_tpu.obs import prom as jax_prom
from dwt_tpu.obs import rules as jax_rules
from dwt_tpu.obs.registry import MetricsRegistry as JaxRegistry
from dwt_tpu.serve.metrics import AccessLog as JaxAccessLog
from dwt_tpu.utils import metrics as jax_metrics
from dwt_tpu_torch.obs import prom, rules
from dwt_tpu_torch.obs.registry import MetricsRegistry
from dwt_tpu_torch.serve.metrics import AccessLog
from dwt_tpu_torch.utils import metrics


def _drive(reg) -> None:
    """One fixed sequence of registry operations: every kind, labels
    that need escaping, a callback gauge, histogram edges and +Inf."""
    c = reg.counter("dwt_t_requests_total", "requests by outcome",
                    labelnames=("status",))
    c.labels(status="ok").inc(3)
    c.labels(status="shed").inc()
    c.labels("error").inc(2.5)
    g = reg.gauge("dwt_t_depth", "queue depth\nwith a newline")
    g.set(7)
    g.dec(2)
    g.inc(0.25)
    reg.gauge("dwt_t_cb", "callback gauge").set_function(lambda: 41.5)
    reg.gauge("dwt_t_dead_cb", "a raising callback reads 0").set_function(
        lambda: 1 / 0)
    info = reg.gauge("dwt_t_version", "info gauge", labelnames=("version",))
    info.labels(version='1-"ab\\c"').set(1)
    info.clear()
    info.labels(version="2-deadbeef").set(1)
    h = reg.histogram("dwt_t_latency_ms", "latency", labelnames=("bucket",))
    for v in (0.5, 1.0, 2.4, 2.5, 99.0, 1e5, float("inf")):
        h.labels(bucket="8").observe(v)
    reg.histogram("dwt_t_sizes", "custom buckets", buckets=(1, 4, 16)).observe(4)
    reg.counter("dwt_t_empty_total", "never incremented")


def test_same_operations_render_byte_equal_exposition():
    ours, ref = MetricsRegistry(), JaxRegistry()
    _drive(ours)
    _drive(ref)
    text = prom.render(ours)
    assert text == jax_prom.render(ref)
    assert prom.validate_exposition(text) == [] == jax_prom.validate_exposition(text)
    assert prom.CONTENT_TYPE == jax_prom.CONTENT_TYPE
    # The read path the rules engine uses agrees too.
    for name in ("dwt_t_requests_total", "dwt_t_depth", "dwt_t_cb", "dwt_t_latency_ms"):
        assert ours.samples(name) == ref.samples(name)
    assert ours.value("dwt_t_depth") == ref.value("dwt_t_depth") == 5.25


def test_registry_refuses_what_the_jax_registry_refuses():
    for build in (MetricsRegistry, JaxRegistry):
        reg = build()
        reg.counter("x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x_total", labelnames=("a",))
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("1bad")
        with pytest.raises(ValueError, match="reserved"):
            reg.histogram("h", labelnames=("le",))
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("y_total").inc(-1)


BAD_EXPOSITIONS = [
    "# TYPE a counter\na 1\n# TYPE a gauge\n",
    "a{x=\"1\" 2\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 3\nh_bucket{le=\"+Inf\"} 2\n"
    "h_count 2\nh_sum 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_count 1\nh_sum 1\n",
    "# HELP a x\n# TYPE a summary\na 1\n",
    "a notanumber\n",
    "",
]


@pytest.mark.parametrize("text", BAD_EXPOSITIONS, ids=range(len(BAD_EXPOSITIONS)))
def test_parser_and_validator_agree_on_shared_text(text):
    assert prom.validate_exposition(text) == jax_prom.validate_exposition(text)

    def parsed(mod):
        try:
            fams = mod.parse_exposition(text)
        except ValueError as e:
            return "raised", str(e)
        return {k: (f.kind, f.help, f.samples) for k, f in fams.items()}

    assert parsed(prom) == parsed(jax_prom)


def test_merge_expositions_agrees():
    a, b = MetricsRegistry(), JaxRegistry()
    _drive(a)
    _drive(b)
    own = "# HELP dwt_fleet_up replicas up\n# TYPE dwt_fleet_up gauge\ndwt_fleet_up 2\n"
    parts = [({}, own), ({"replica": "0"}, prom.render(a)),
             ({"replica": "1"}, jax_prom.render(b)), ({"replica": "2"}, "garbage{\n")]
    merged = prom.merge_expositions(parts)
    assert merged == jax_prom.merge_expositions(parts)
    assert prom.validate_exposition(merged) == []


RULES_DOC = [
    {"name": "shedding", "metric": "dwt_r_requests_total",
     "labels": {"status": "shed"}, "op": ">", "threshold": 2, "for_s": 10,
     "severity": "critical"},
    {"name": "shallow", "metric": "dwt_r_depth", "op": "<=", "threshold": 1},
    {"name": "absent", "metric": "dwt_r_nothing", "op": ">", "threshold": 0},
]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _alert_trace(reg_cls, rules_mod):
    reg = reg_cls()
    c = reg.counter("dwt_r_requests_total", labelnames=("status",))
    depth = reg.gauge("dwt_r_depth")
    depth.set(5)
    clock = _Clock()
    engine = rules_mod.AlertEngine(rules_mod.parse_rules(RULES_DOC),
                                   registry=reg, clock=clock)
    trace = []
    for t, shed, d in ((0, 1, 5), (1, 2, 1), (5, 0, 1), (12, 0, 3), (14, 1, 3), (40, 0, 0)):
        clock.t = float(t)
        c.labels(status="shed").inc(shed)
        c.labels(status="ok").inc()
        depth.set(d)
        events = engine.maybe_evaluate()
        trace.append(([e.record_fields() for e in events], engine.firing()))
    trace.append(jax_prom.render(reg) if reg_cls is JaxRegistry else prom.render(reg))
    return trace


def test_alert_engine_transitions_agree_under_a_fake_clock():
    ours = _alert_trace(MetricsRegistry, rules)
    ref = _alert_trace(JaxRegistry, jax_rules)
    assert ours == ref
    assert any(fired for fired, _ in ours[:-1])  # the trace does fire


@pytest.mark.parametrize("rule,values,baselines", [
    ({"name": "p99", "metric": "e2e_ms_p99", "op": ">", "baseline_factor": 3.0},
     {"e2e_ms_p99": 31.0}, {"e2e_ms_p99": 10.0}),
    ({"name": "p99", "metric": "e2e_ms_p99", "op": ">", "baseline_factor": 3.0},
     {"e2e_ms_p99": 29.0}, {"e2e_ms_p99": 10.0}),
    ({"name": "p99", "metric": "e2e_ms_p99", "op": ">", "baseline_factor": 3.0},
     {"e2e_ms_p99": 31.0}, {}),
    ({"name": "err", "metric": "error_rate", "op": ">=", "threshold": 0.1},
     {"error_rate": 0.1}, {}),
    ({"name": "err", "metric": "error_rate", "op": ">=", "threshold": 0.1},
     {"served": 3}, {}),
])
def test_rule_fires_agrees(rule, values, baselines):
    (ours,) = rules.parse_rules([rule])
    (ref,) = jax_rules.parse_rules([rule])
    assert rules.rule_fires(ours, values, baselines) == \
        jax_rules.rule_fires(ref, values, baselines)


@pytest.mark.parametrize("doc", [
    [{"name": "a", "metric": "m", "op": "~", "threshold": 1}],
    [{"name": "a", "metric": "m", "op": ">", "threshold": 1, "typo": 2}],
    [{"name": "a", "metric": "m", "op": ">"}],
    {"rulez": []},
    [{"name": "a", "metric": "m", "op": ">", "threshold": 1},
     {"name": "a", "metric": "m", "op": "<", "threshold": 1}],
])
def test_parse_rules_refuses_what_the_jax_parser_refuses(doc):
    for mod in (rules, jax_rules):
        with pytest.raises(ValueError):
            mod.parse_rules(doc)


def test_load_rules_reads_a_file(tmp_path):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": RULES_DOC}))
    assert [dataclass_fields(r) for r in rules.load_rules(str(path))] == \
        [dataclass_fields(r) for r in jax_rules.load_rules(str(path))]


def dataclass_fields(rule):
    return (rule.name, rule.metric, rule.op, rule.threshold, rule.for_s,
            rule.severity, rule.labels, rule.baseline_factor)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_agree(seed):
    vals = np.random.default_rng(seed).exponential(size=257).tolist()
    qs = (0.0, 1.0, 50.0, 95.0, 99.0, 99.9, 100.0)
    assert metrics.percentile_summary(vals, qs) == jax_metrics.percentile_summary(vals, qs)
    for q in qs:
        assert metrics.percentile(vals, q) == jax_metrics.percentile(vals, q)
    assert metrics.percentile_summary([]) == {} == jax_metrics.percentile_summary([])
    with pytest.raises(ValueError):
        metrics.percentile([], 50)


def _access_story(cls):
    buf = io.StringIO()
    alog = cls(stream=buf)
    for i in range(20):
        alog.record("ok", 1 + i % 3, bucket=8, version="v1", batch_seq=i,
                    e2e_ms=float(i), queue_ms=0.5 * i, device_ms=2.0)
    alog.record("error", 2, version="v1", error="boom")
    alog.record("shed", 4, retry_after_ms=50, queued=9)
    alog.event("swap", version="v2", from_version="v1", step=2)
    for i in range(5):
        alog.record("ok", 1, bucket=1, version="v2", e2e_ms=1.0 + i)
    summary = alog.summary()
    for key in ("seconds", "imgs_per_s"):
        summary.pop(key)
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    return summary, alog.version_stats("v1"), alog.version_stats("v2"), lines


def test_access_log_agrees_with_the_jax_access_log():
    assert _access_story(AccessLog) == _access_story(JaxAccessLog)


def test_metric_logger_records_match(tmp_path):
    def records(cls, path):
        out = io.StringIO()
        logger = cls(str(path), stream=out)
        logger.log("train", 3, loss=np.float32(0.5), ok=True, note="x")
        with logger.timed("collect", 4, imgs=8):
            pass
        logger.close()
        recs = [json.loads(l) for l in open(path)]
        for r in recs:
            r.pop("elapsed_s")
            r.pop("seconds", None)
        return recs

    assert records(metrics.MetricLogger, tmp_path / "a.jsonl") == \
        records(jax_metrics.MetricLogger, tmp_path / "b.jsonl")


def test_device_memory_stats_is_none_on_the_cpu():
    assert metrics.device_memory_stats() is None
    assert metrics.host_rss_mb() > 0
