"""Port serving path: engine, batcher client and HTTP front end on the CPU.

``ServeEngine(device="cpu")`` on the ``tiny`` ResNet-DWT at 32×32 (full
widths, one block per stage), freshly initialized from a seed.  Fresh
whitening stats (all-ones covariance) amplify activations by ~1/sqrt(eps)
per whitened site, so logits are compared with a relative tolerance.
The port's parity with the JAX package is in ``test_torch_resnet.py``;
this file checks the serving mechanics around the forward, and that the
package imports neither ``jax`` nor ``dwt_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.serve import server
from dwt_tpu_torch.serve.batcher import bucket_for, pad_to_bucket, plan_dispatch
from dwt_tpu_torch.serve.engine import ServeEngine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
BUCKETS = (1, 8)


def _close(a, b):
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def engine():
    model = build_resnet("tiny", num_classes=7, seed=0)
    return ServeEngine(model, SHAPE, buckets=BUCKETS, device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n,) + SHAPE).astype(np.float32)


def test_infer_equals_padded_bucket_forward(engine):
    x = _images(3)
    out = engine.infer(x)
    assert out.shape == (3, 7) and np.isfinite(out).all()
    padded = pad_to_bucket(x, 8)
    np.testing.assert_array_equal(padded[3:], np.repeat(x[-1:], 5, axis=0))
    full = engine.forward(engine.stage(padded), 8).numpy()
    np.testing.assert_array_equal(out, full[:3])
    assert engine.warmup_s.keys() == set(BUCKETS)


def test_engine_rejects_unwarmed_bucket_and_oversize(engine):
    with pytest.raises(ValueError, match="bucket 4"):
        engine.forward(engine.stage(_images(4)), 4)
    with pytest.raises(ValueError, match="largest bucket"):
        engine.infer(_images(9))


def test_engine_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_resnet("tiny", num_classes=7, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, SHAPE, buckets=(1,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, SHAPE, buckets=(1,), device="cuda")


def test_client_concurrent_requests_match_engine(engine):
    client = server.ServeClient(engine, max_batch_delay_ms=20.0)
    sizes = [1, 2, 3, 1]
    inputs = [_images(n, seed=10 + i) for i, n in enumerate(sizes)]
    results = [None] * len(sizes)
    try:
        def run(i):
            results[i] = client.infer(inputs[i], timeout=60)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        client.close()
    for x, out in zip(inputs, results):
        assert out.shape == (x.shape[0], 7)
        _close(out, engine.infer(x))
    stats = client.stats()
    assert stats["ok_requests"] == len(sizes)
    assert stats["served_images"] == sum(sizes)


def test_http_server_healthz_and_infer(engine):
    client = server.ServeClient(engine, max_batch_delay_ms=1.0)
    front = server.HttpFront(client, "127.0.0.1", 0)
    http = server.HttpServeClient("127.0.0.1", front.port, timeout=60)
    try:
        status, health = http.healthz()
        assert status == 200 and health["ok"] and health["buckets"] == list(BUCKETS)
        x = _images(2, seed=3)
        as_json = http.infer(x)
        as_npy = http.infer(x, binary=True)
        assert as_json.shape == (2, 7)
        _close(as_json, engine.infer(x))
        np.testing.assert_array_equal(as_json, as_npy)
        status, bad = http.request("POST", "/infer", b'{"inputs": [[1, 2]]}')
        assert status == 400 and "shape" in bad["error"]
        stats = http.stats()
        assert stats["ok_requests"] == 2 and stats["device"] == "cpu"
    finally:
        http.close()
        front.close()
    assert not client.dispatcher_alive


def test_build_engine_from_cli_flags():
    args = server.build_parser().parse_args([
        "--model", "tiny", "--image_size", "32", "--num_classes", "5",
        "--buckets", "1,8", "--init_random", "--seed", "3", "--device", "cpu",
    ])
    engine = server.build_engine(args)
    assert engine.buckets == (1, 8) and engine.input_shape == SHAPE
    assert engine.infer(_images(1)).shape == (1, 5)
    # Neither --ckpt_dir nor --init_random: refused, naming both.
    args = server.build_parser().parse_args(["--model", "tiny", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--ckpt_dir .* or --init_random"):
        server.build_engine(args)


def test_seeded_init_is_reproducible():
    a = build_resnet("tiny", num_classes=5, seed=7).state_dict()
    b = build_resnet("tiny", num_classes=5, seed=7).state_dict()
    c = build_resnet("tiny", num_classes=5, seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    # Flax's kaiming fan_out truncated normal: std sqrt(2 / fan_out).
    w = build_resnet("resnet50", seed=0).layer3_0.conv2.weight.detach()
    assert float(w.std()) == pytest.approx((2.0 / (256 * 9)) ** 0.5, rel=0.05)


def test_batcher_copy_plans_like_the_reference():
    assert bucket_for(5, (1, 8, 32)) == 8
    with pytest.raises(ValueError):
        bucket_for(33, (1, 8, 32))
    # Fills the largest bucket → dispatch now; a partial prefix waits
    # for its deadline.
    assert plan_dispatch([4, 4], (1, 8), 0.0, 0.0, 0.005) == 2
    assert plan_dispatch([3], (1, 8), 0.001, 0.0, 0.005) == 0
    assert plan_dispatch([3], (1, 8), 0.006, 0.0, 0.005) == 1


def test_port_imports_no_jax_and_no_dwt_tpu():
    code = r"""
import importlib, importlib.util, json, pkgutil, sys
import dwt_tpu_torch
for mod in pkgutil.walk_packages(dwt_tpu_torch.__path__, "dwt_tpu_torch."):
    importlib.import_module(mod.name)
# The digits slice by name: the model, the trainer's CLI and the loaders.
from dwt_tpu_torch.nn.lenet import LeNetDWT
from dwt_tpu_torch.cli.usps_mnist import main
from dwt_tpu_torch.data.datasets import load_mnist, load_usps
from dwt_tpu_torch.train.loop import run_digits
# The data plane by name: the sampler, the pool, prefetch and the native passes.
from dwt_tpu_torch.data.sampler import SeekableSampler
from dwt_tpu_torch.data.pipeline import DataPlane, OrderedWorkerPool
from dwt_tpu_torch.data.loader import batch_iterator, prefetch_to_device
from dwt_tpu_torch.data.datasets import ImageFolderDataset
from dwt_tpu_torch.native import normalize_from_u8
# Checkpoints by name: the store, the converter and its CLI.
from dwt_tpu_torch.utils.checkpoint import restore_newest, read_host_shard_tree
from dwt_tpu_torch.convert import convert_resnet_state_dict
from dwt_tpu_torch.cli.convert import main
# The resilience plane by name: the fault plans, the guard, the writer, the
# delta store, preemption, the notice, the watchdog and the coordinator.
from dwt_tpu_torch.resilience.inject import FaultPlan, maybe_nan
from dwt_tpu_torch.resilience.guard import DivergenceGuard
from dwt_tpu_torch.resilience.async_ckpt import AsyncCheckpointer, DeltaAsyncCheckpointer
from dwt_tpu_torch.ckpt.store import save_delta, restore_cas_tree, gc_blobs
from dwt_tpu_torch.resilience.preemption import PreemptionHandler
from dwt_tpu_torch.resilience.notice import NoticeWatcher
from dwt_tpu_torch.resilience.watchdog import HangWatchdog
from dwt_tpu_torch.resilience.coord import Coordinator
# The serving deployment plane by name: the metrics plane, the fleet and
# online adaptation.
from dwt_tpu_torch.obs import get_registry
from dwt_tpu_torch.obs.prom import render, validate_exposition
from dwt_tpu_torch.obs.rules import AlertEngine, rule_fires
from dwt_tpu_torch.utils.metrics import percentile_summary, device_memory_stats
from dwt_tpu_torch.fleet import CanaryGate, DeployController, HotReloader, PostSwapMonitor
from dwt_tpu_torch.fleet.watcher import CheckpointWatcher
from dwt_tpu_torch.serve.adapt import DomainAdapter, make_collect_fn
from dwt_tpu_torch.serve.quant import quantize_int8
# The trainers' run plane and the replica fleet by name, and the port's load
# generator.
from dwt_tpu_torch.fleet.balancer import HealthProber, ReplicaSet, Respawner, main
from dwt_tpu_torch.fleet.autoscale import Autoscaler, ScaleDecision
from dwt_tpu_torch.fleet.retry import RespawnBudget
from dwt_tpu_torch.utils.repro import check_cli_accuracy, sweep_verdicts
from dwt_tpu_torch.cli import run_cli, debug_nans
spec = importlib.util.spec_from_file_location("torch_serve_bench", "tools/torch_serve_bench.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from dwt_tpu_torch.serve.metrics import AccessLog
from dwt_tpu_torch.serve.engine import EngineState, Version
# The sweep control plane, its job and the port's checkpoint auditor.
from dwt_tpu_torch.sweep import JobSpec, SweepJournal, SweepSupervisor
from dwt_tpu_torch.sweep.cli import make_argv_fn
from dwt_tpu_torch.cli import officehome_sweep
spec = importlib.util.spec_from_file_location("torch_ckpt_fsck", "tools/torch_ckpt_fsck.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
# The data-parallel slice: the parallel package and the multi-process
# checkpoint plane.
from dwt_tpu_torch.parallel import (Mesh, ShardingPlan, initialize_distributed,
                                    make_mesh, plan_from_flags, shard_batch)
from dwt_tpu_torch.parallel import dp, mesh, plan
from dwt_tpu_torch.resilience.async_ckpt import (MultiHostAsyncCheckpointer,
                                                 MultiHostDeltaAsyncCheckpointer)
from dwt_tpu_torch.utils.checkpoint import promote_host_shards, save_host_shard
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "dwt_tpu" or n.startswith("dwt_tpu."))
print(json.dumps(bad))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
