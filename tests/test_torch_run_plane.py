"""The trainers' run plane of the port against the JAX CLIs.

Tiny digits and OfficeHome runs through both packages' CLI entries, from
the same initial weights (the JAX model's, loaded into the port's),
with ``--metrics_jsonl``, ``--heartbeat_every``, ``--metrics_port 0`` and
``--alert_rules``: the JSONL files hold the same kinds at the same steps,
every field the JAX record has (less ``KNOWN_DIFFERENCES``), the train
losses within ``LOSS_TOL`` and the eval accuracies and counts equal;
heartbeats fall at the same steps; a ``/metrics`` scrape during the port's
run is valid exposition and ``dwt_train_steps_total`` grows by exactly the
steps run; the always-true alert rule fires once in both.  Also: the
``--expect_accuracy`` exit codes for a met and a missed target, the inert
flags in both parsers, ``--debug_nans``, ``--data_stall_timeout`` reaching
the loader pool, and the checkpoint and guard counters.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.cli import officehome as jax_officehome
from dwt_tpu.cli import usps_mnist as jax_usps_mnist
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu_torch.cli import officehome, usps_mnist
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data import pipeline
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.obs import prom, registry
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.train import loop

torch.set_num_threads(2)

LOSS_TOL = 1e-4       # train losses, relative (tests/test_torch_dispatch.py)
EVAL_LOSS_TOL = 1e-2  # eval losses, relative (tests/test_torch_dispatch.py)
# Fields and kinds the packages' records differ in, all from earlier
# slices: the port's train records also carry ``loss`` and ``grad_norm``
# and its eval records ``forwards`` (extra fields are allowed); its eval
# records have no ``eval_imgs_per_s``; its ``stat_collection`` records
# count ``forwards`` where JAX's count ``imgs``; the port logs
# ``params_digest`` (a hash, not JAX's float checksum) only with
# ``--ckpt_dir``.  A JAX heartbeat carries ``ckpt_bytes_written`` and
# ``ckpt_dir_bytes`` once any JAX checkpoint was written in the process
# (process-wide counters), which the port's checkpoints do not feed yet.
KNOWN_DIFFERENCES = {"test": {"eval_imgs_per_s"}, "final_test": {"eval_imgs_per_s"},
                     "stat_collection": {"imgs"},
                     "heartbeat": {"ckpt_bytes_written", "ckpt_dir_bytes"}}
JAX_ONLY_KINDS = {"params_digest"}
ALWAYS_RULE = [{"name": "train_started", "metric": "dwt_train_steps_total",
                "op": ">", "threshold": 0, "severity": "info"}]

DIGITS_ARGS = ["--synthetic", "--synthetic_size", "64", "--source_batch_size", "16",
               "--target_batch_size", "16", "--test_batch_size", "16", "--group_size", "4",
               "--epochs", "2", "--log_interval", "1", "--seed", "1", "--num_workers", "0",
               "--heartbeat_every", "2"]
OFFICEHOME_ARGS = ["--synthetic", "--arch", "tiny", "--num_classes", "4",
                   "--synthetic_size", "32", "--img_crop_size", "32",
                   "--source_batch_size", "8", "--test_batch_size", "10", "--num_iters", "2",
                   "--check_acc_step", "2", "--stat_collection_passes", "0",
                   "--log_interval", "1", "--seed", "1", "--num_workers", "0",
                   "--resnet_path", "", "--heartbeat_every", "1"]


def _lenet_from_jax():
    variables = jax.jit(lambda k: JaxLeNetDWT(group_size=4).init(
        k, jnp.zeros((2, 16, 28, 28, 1)), train=True))(jax.random.key(1))
    return load_jax_variables(LeNetDWT(group_size=4),
                              jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))


def _tiny_from_jax():
    variables = jax.jit(lambda k: JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=4).init(
        k, jnp.zeros((3, 8, 32, 32, 3)), train=True))(jax.random.key(1))
    return load_jax_variables(ResNetDWT.tiny(num_classes=4),
                              jax.tree.map(np.asarray, variables["params"]),
                              jax.tree.map(np.asarray, variables["batch_stats"]))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _steps_total() -> float:
    return registry.get_registry().value("dwt_train_steps_total") or 0.0


def _run(main, argv, expect_exit=None):
    try:
        return main(argv)
    except SystemExit as e:
        assert e.code == expect_exit, e
        return None


@pytest.fixture(scope="module")
def digits_runs(tmp_path_factory):
    """Both digits CLIs, same weights, with the whole run plane on and a
    missed ``--expect_accuracy`` (exit 1 after the ``accuracy_check``
    record); the port's run scraped while it trains."""
    tmp = tmp_path_factory.mktemp("digits")
    rules = tmp / "rules.json"
    rules.write_text(json.dumps(ALWAYS_RULE))
    common = DIGITS_ARGS + ["--metrics_port", "0", "--alert_rules", str(rules),
                            "--expect_accuracy", "101"]
    _run(jax_usps_mnist.main, common + ["--metrics_jsonl", str(tmp / "jax.jsonl")],
         expect_exit=1)
    steps0 = _steps_total()
    scrapes = []
    done = threading.Event()

    def scrape():
        while not done.is_set():
            port = prom.exporter_port()
            if port is not None:
                try:
                    text = urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                                  timeout=5).read().decode()
                    if "dwt_train_loss" in text:
                        scrapes.append(text)
                except OSError:
                    pass
            time.sleep(0.02)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "build_digits_model", lambda cfg: _lenet_from_jax())
    try:
        _run(usps_mnist.main, common + ["--metrics_jsonl", str(tmp / "port.jsonl"),
                                        "--device", "cpu"], expect_exit=1)
    finally:
        mp.undo()
        done.set()
        scraper.join(timeout=10)
    return {"jax": _records(tmp / "jax.jsonl"), "port": _records(tmp / "port.jsonl"),
            "scrapes": scrapes, "steps": _steps_total() - steps0}


@pytest.fixture(scope="module")
def officehome_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("officehome")
    jax_officehome.main(OFFICEHOME_ARGS + ["--metrics_jsonl", str(tmp / "jax.jsonl")])
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "build_model", lambda cfg: _tiny_from_jax())
    try:
        officehome.main(OFFICEHOME_ARGS + ["--metrics_jsonl", str(tmp / "port.jsonl"),
                                           "--device", "cpu"])
    finally:
        mp.undo()
    return {"jax": _records(tmp / "jax.jsonl"), "port": _records(tmp / "port.jsonl")}


def _by_kind(records):
    out = {}
    for r in records:
        out.setdefault(r["kind"], []).append(r)
    return out


def _compare_jsonl(ours, ref, loss_keys):
    """Per kind: the same steps in order (the harvest ring orders train
    records against heartbeats by when copies land, so kinds are compared
    one by one), every JAX field present, the values to the tolerances."""
    a, b = _by_kind(ours), _by_kind(ref)
    assert set(a) == set(b) - JAX_ONLY_KINDS, (sorted(a), sorted(b))
    for kind, recs in a.items():
        assert [r["step"] for r in recs] == [r["step"] for r in b[kind]], kind
        for x, y in zip(recs, b[kind]):
            missing = set(y) - set(x) - KNOWN_DIFFERENCES.get(kind, set())
            assert not missing, (kind, missing)
            if kind == "train":
                for key in loss_keys:
                    np.testing.assert_allclose(x[key], y[key], rtol=LOSS_TOL,
                                               err_msg=f"{key} at step {x['step']}")
                assert {k: x[k] for k in ("epoch", "iter") if k in y} == \
                    {k: y[k] for k in ("epoch", "iter") if k in y}
            elif kind in ("test", "final_test"):
                assert (x["accuracy"], x["count"]) == (y["accuracy"], y["count"])
                np.testing.assert_allclose(x["loss"], y["loss"], rtol=EVAL_LOSS_TOL)
            elif kind == "accuracy_check":
                assert {k: x[k] for k in ("expected", "tolerance", "ok")} == \
                    {k: y[k] for k in ("expected", "tolerance", "ok")}
            elif kind in ("alert", "alert_rules"):
                skip = {"elapsed_s", "value", "path"}
                assert {k: v for k, v in x.items() if k not in skip} == \
                    {k: v for k, v in y.items() if k not in skip}


def test_digits_jsonl_matches_the_jax_cli(digits_runs):
    ours, ref = digits_runs["port"], digits_runs["jax"]
    _compare_jsonl(ours, ref, ("cls_loss", "entropy_loss"))
    kinds = {r["kind"] for r in ours}
    assert {"metrics_exporter", "alert_rules", "alert", "train", "heartbeat", "test",
            "accuracy_check"} <= kinds
    # Heartbeats every 2 steps from the first boundary: 8 steps.
    assert [r["step"] for r in ours if r["kind"] == "heartbeat"] == [3, 5, 7]
    for hb in (r for r in ours if r["kind"] == "heartbeat"):
        assert hb["steps_per_s"] > 0 and hb["rss_mb"] > 0 and hb["ckpt_in_flight"] == 0
    # The exit path: the verdict record is the last, after the accuracy.
    check = ours[-1]
    assert check["kind"] == "accuracy_check" and not check["ok"]
    assert check["actual"] == [r for r in ours if r["kind"] == "test"][-1]["accuracy"]


def test_officehome_jsonl_matches_the_jax_cli(officehome_runs):
    ours, ref = officehome_runs["port"], officehome_runs["jax"]
    _compare_jsonl(ours, ref, ("cls_loss", "mec_loss"))
    assert [r["kind"] for r in ours if r["kind"] != "heartbeat"] == \
        ["train", "train", "test", "stat_collection", "final_test"]
    assert [r["step"] for r in ours if r["kind"] == "heartbeat"] == [2]


def test_metrics_scrape_during_the_run_and_the_step_counter(digits_runs):
    scrapes = digits_runs["scrapes"]
    assert scrapes, "no /metrics scrape while the run trained"
    text = scrapes[0]
    assert prom.validate_exposition(text) == []
    for family in ("dwt_train_steps_total", "dwt_train_loss", "dwt_harvest_ring_depth",
                   "dwt_harvest_lag_steps", "dwt_alerts_firing"):
        assert family in text, family
    assert all(prom.validate_exposition(t) == [] for t in scrapes[-3:])
    assert "dwt_train_steps_per_s" in scrapes[-1] and "dwt_eval_accuracy" in scrapes[-1]
    # 2 epochs of 64 / 16 = 4 steps: the counter moved by exactly the steps.
    assert digits_runs["steps"] == 8
    assert [r["port"] for r in digits_runs["port"] if r["kind"] == "metrics_exporter"]


def test_the_always_true_alert_fires_once_in_both(digits_runs):
    for recs in (digits_runs["port"], digits_runs["jax"]):
        alerts = [r for r in recs if r["kind"] == "alert"]
        assert [(a["alert"], a["state"], a["step"]) for a in alerts] == \
            [("train_started", "firing", 1)]
        assert [r["rules"] for r in recs if r["kind"] == "alert_rules"] == [1]


@pytest.mark.parametrize("expect,exit_code", [(50.0, None), (50.3, None), (49.65, 1),
                                              (101.0, 1), (None, None)])
def test_expect_accuracy_exit_codes_match_jax(tmp_path, monkeypatch, expect, exit_code):
    """The CLI plumbing over a run that returns 50%: met within the band
    (edges included) returns, a miss exits 1 after the verdict record, in
    both packages."""
    def stub(cfg, logger=None, **kw):
        logger("test", 1, accuracy=50.0)
        return 50.0

    monkeypatch.setattr(loop, "run_digits", stub)
    monkeypatch.setattr(jax_loop, "run_digits",
                        lambda cfg, logger=None: stub(cfg, logger.log))
    flags = ["--synthetic"] + ([] if expect is None else ["--expect_accuracy", str(expect)])
    outcomes = []
    for name, main in (("port", usps_mnist.main), ("jax", jax_usps_mnist.main)):
        path = tmp_path / f"{name}.jsonl"
        try:
            main(flags + ["--metrics_jsonl", str(path)])
            code = None
        except SystemExit as e:
            code = e.code
        recs = [{k: v for k, v in r.items() if k != "elapsed_s"} for r in _records(path)]
        outcomes.append((code, recs))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == exit_code
    assert (outcomes[0][1][-1]["kind"] == "accuracy_check") == (expect is not None)


INERT = ["--pallas_whiten", "--apply_lowering", "grouped", "--data_stall_timeout", "3"]


@pytest.mark.parametrize("ours,ref,extra", [
    (usps_mnist, jax_usps_mnist, []),
    (officehome, jax_officehome, ["--target_batch_size", "9", "--lr_change_step", "5"]),
])
def test_inert_flags_parse_in_both_and_are_noted(ours, ref, extra, caplog):
    argv = INERT + extra
    a = ours.config_from_args(ours.build_parser().parse_args(argv + ["--device", "cpu"]))
    b = ref.config_from_args(ref.build_parser().parse_args(argv))
    names = ("pallas_whiten", "apply_lowering", "data_stall_timeout", "target_batch_size",
             "lr_change_step", "heartbeat_every", "metrics_port", "alert_rules")
    for name in names:
        if hasattr(b, name):
            assert getattr(a, name) == getattr(b, name), name
    with caplog.at_level(logging.WARNING, logger=loop.__name__):
        loop._note_inert(a)
    noted = sorted(m.split("=")[0].lstrip("-") for m in caplog.messages)
    assert noted == sorted(["pallas_whiten", "apply_lowering"]
                           + ([] if ours is usps_mnist else ["target_batch_size",
                                                             "lr_change_step"]))
    assert all("changes nothing in the port" in m for m in caplog.messages)


def test_data_stall_timeout_reaches_the_loader_pool(monkeypatch):
    """The train streams' pools take ``--data_stall_timeout``; the eval
    pass keeps the pool's default, as the JAX loops' eval does."""
    seen = []
    init = pipeline.OrderedWorkerPool.__init__

    def spy(self, num_workers, stall_timeout=pipeline.DEFAULT_STALL_TIMEOUT_S):
        seen.append(stall_timeout)
        init(self, num_workers, stall_timeout)

    monkeypatch.setattr(pipeline.OrderedWorkerPool, "__init__", spy)
    from dwt_tpu_torch.data import loader

    monkeypatch.setattr(loader, "OrderedWorkerPool", pipeline.OrderedWorkerPool)
    usps_mnist.main(DIGITS_ARGS[:-2] + ["--epochs", "1", "--num_workers", "2",
                                        "--data_stall_timeout", "7.5", "--device", "cpu"])
    assert seen == [7.5, 7.5, pipeline.DEFAULT_STALL_TIMEOUT_S]  # source, target; eval


def test_debug_nans_fails_at_the_module_and_refuses_graphs(monkeypatch):
    """``--debug_nans``: a run without NaN gives the records of a run
    without the flag and leaves no hook behind; poisoned parameters fail
    at the first module whose output holds a NaN; ``--steps_per_dispatch
    > 1`` is refused with the reason."""
    monkeypatch.setattr(loop, "build_digits_model", lambda cfg: _lenet_from_jax())
    argv = DIGITS_ARGS[:-2] + ["--epochs", "1", "--device", "cpu"]

    def records(extra):
        got = []
        monkeypatch.setattr(loop, "_log_record", lambda *a, **f: None)
        cfg = usps_mnist.config_from_args(usps_mnist.build_parser().parse_args(argv + extra))
        from dwt_tpu_torch.cli import debug_nans

        with debug_nans(cfg, "--debug_nans" in extra):
            loop.run_digits(cfg, lambda kind, step, **f: got.append(
                (kind, step, {k: v for k, v in f.items() if k != "eval_s"})))
        return got

    assert records(["--debug_nans"]) == records([])
    assert not torch.nn.modules.module._global_forward_hooks
    assert not torch.is_anomaly_enabled()
    inject.arm(inject.FaultPlan.from_spec({"nan_at_step": 2}))
    try:
        with pytest.raises(FloatingPointError, match="NaN in the output of"):
            usps_mnist.main(argv + ["--debug_nans"])
    finally:
        inject.disarm()
    assert not torch.nn.modules.module._global_forward_hooks
    with pytest.raises(SystemExit, match="--steps_per_dispatch 1"):
        usps_mnist.main(argv + ["--debug_nans", "--steps_per_dispatch", "2"])


def test_checkpoint_and_guard_counters(tmp_path):
    """Saves count in ``dwt_ckpt_saves_total{mode}`` and their stall in
    ``dwt_ckpt_stall_ms``; a guard recovery in
    ``dwt_guard_events_total{event="recovered"}``."""
    reg = registry.get_registry()
    saves0 = reg.value("dwt_ckpt_saves_total", {"mode": "async"}) or 0.0
    stalls0 = reg.value("dwt_ckpt_stall_ms") or 0.0
    recovered0 = reg.value("dwt_guard_events_total", {"event": "recovered"}) or 0.0
    inject.arm(inject.FaultPlan.from_spec({"nan_at_step": 3}))
    try:
        usps_mnist.main(DIGITS_ARGS + ["--device", "cpu", "--ckpt_dir", str(tmp_path / "ck"),
                                       "--ckpt_every_epochs", "1", "--guard_policy",
                                       "skip_step", "--guard_interval", "1",
                                       "--harvest_depth", "0"])
    finally:
        inject.disarm()
    assert reg.value("dwt_ckpt_saves_total", {"mode": "async"}) - saves0 == 2
    assert reg.value("dwt_ckpt_stall_ms") - stalls0 == 2  # observations
    assert reg.value("dwt_guard_events_total", {"event": "recovered"}) - recovered0 == 1
