"""The port's OfficeHome spans and data-plane instruments, held to the JAX package's.

One tiny OfficeHome run (``tests/test_torch_run_plane.py``'s
``OFFICEHOME_ARGS`` on test-made image folders, with one stat-collection
pass and two loader threads) goes through both packages' CLIs with
``--obs_trace`` and ``DWT_DATA_TRAIL``.  The spans must match per
category (``test_torch_obs_report.assert_spans_match``: names,
parent→child pairs, loop-thread counts), the batch-id trail must equal
the JAX run's line for line, and the loader pool must feed its gauges
and its decode histogram.  At ``--eval_steps_per_dispatch 1`` every pass
dispatches two chunks, so the eval records carry ``dispatch_ms_p50`` and
``dispatch_ms_p99`` beside ``eval_imgs_per_s`` in both packages, and the
stat-collection record counts ``imgs``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from dwt_tpu import obs as jax_obs
from dwt_tpu.cli import officehome as jax_officehome
from dwt_tpu_torch import obs
from dwt_tpu_torch.cli import officehome
from dwt_tpu_torch.obs import prom
from dwt_tpu_torch.obs.registry import get_registry
from test_torch_obs_report import LOOP_SPANS, assert_spans_match, copies_in_flight, traced

torch.set_num_threads(2)

OFFICEHOME_ARGS = ["--arch", "tiny", "--num_classes", "4", "--img_resize", "36",
                   "--img_crop_size", "32", "--source_batch_size", "8",
                   "--test_batch_size", "10", "--num_iters", "2", "--check_acc_step", "2",
                   "--stat_collection_passes", "1", "--log_interval", "1", "--seed", "1",
                   "--num_workers", "2", "--resnet_path", "", "--heartbeat_every", "1",
                   "--eval_steps_per_dispatch", "1"]


def _write_folders(root, rng, classes=4, per_class=4):
    for domain in ("src", "tgt"):
        for k in range(classes):
            d = root / domain / f"class_{k}"
            d.mkdir(parents=True)
            for i in range(per_class):
                h, w = rng.integers(36, 60, size=2)
                arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                arr[: h // 4] = 60 * k  # a class signal
                Image.fromarray(arr).save(d / f"im{i}.jpg", quality=90)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("obs_officehome")
    _write_folders(tmp, np.random.default_rng(0))
    folders = ["--s_dset_path", str(tmp / "src"), "--t_dset_path", str(tmp / "tgt")]
    mp = pytest.MonkeyPatch()
    copies_in_flight(mp)
    out = {"decodes": get_registry().value("dwt_data_decode_ms") or 0.0}
    try:
        for name, main, extra, package_obs in (
                ("jax", jax_officehome.main, [], jax_obs),
                ("port", officehome.main, ["--device", "cpu"], obs)):
            trail = tmp / f"trail_{name}"
            mp.setenv("DWT_DATA_TRAIL", str(trail))
            jsonl = tmp / f"{name}.jsonl"
            spans = traced(main, OFFICEHOME_ARGS + folders + extra
                           + ["--obs_trace", str(tmp / f"{name}.json"),
                              "--metrics_jsonl", str(jsonl)], package_obs)
            out[name] = {"spans": spans, "trail": trail,
                         "records": [json.loads(line) for line in open(jsonl)]}
    finally:
        mp.undo()
    out["decodes"] = (get_registry().value("dwt_data_decode_ms") or 0.0) - out["decodes"]
    return out


def test_span_names_nesting_and_counts_match_jax(runs):
    assert_spans_match(runs["port"]["spans"], runs["jax"]["spans"], LOOP_SPANS | {
        "stat_collection", "collect_dispatch", "collect_batch_wait"})


def test_the_data_trail_matches_jax_line_for_line(runs):
    ours, ref = runs["port"]["trail"], runs["jax"]["trail"]
    assert sorted(os.listdir(ours)) == sorted(os.listdir(ref)) == ["source.jsonl",
                                                                  "target.jsonl"]
    for name in os.listdir(ref):
        a = open(ours / name).read().splitlines()
        b = open(ref / name).read().splitlines()
        assert len(b) >= 2 and a == b, name
        assert json.loads(a[0])["role"] == name.split(".")[0]


def test_the_pool_feeds_its_gauges_and_decode_histogram(runs):
    reg = get_registry()
    assert runs["decodes"] > 0  # the decode histogram's observations
    assert reg.value("dwt_data_pipeline_depth") == 0  # every pool drained
    assert reg.value("dwt_data_worker_busy") == 0
    exposition = prom.render(reg)
    assert prom.validate_exposition(exposition) == []
    for family in ("dwt_data_pipeline_depth", "dwt_data_worker_busy", "dwt_data_decode_ms",
                   "dwt_data_stalls_total", "dwt_data_worker_respawns_total"):
        assert family in exposition, family


def test_eval_and_collection_records_carry_the_jax_fields(runs):
    """The fields of the JAX loop's eval, stat-collection and digest
    records are in the port's (which may carry more), at the same steps."""
    for kind in ("test", "final_test", "stat_collection", "params_digest"):
        ours = [r for r in runs["port"]["records"] if r["kind"] == kind]
        ref = [r for r in runs["jax"]["records"] if r["kind"] == kind]
        assert [r["step"] for r in ours] == [r["step"] for r in ref] != [], kind
        for a, b in zip(ours, ref):
            assert set(b) <= set(a), (kind, set(b) - set(a))
    for r in runs["port"]["records"]:
        if r["kind"] in ("test", "final_test"):
            assert r["eval_imgs_per_s"] > 0 and r["dispatch_ms_p99"] >= r["dispatch_ms_p50"]
        if r["kind"] == "stat_collection":
            assert (r["imgs"], r["pass_index"]) == (16, 0)
