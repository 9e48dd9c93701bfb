"""The port's content-addressed delta store (``dwt_tpu_torch.ckpt.store``) against the JAX package's.

* One sequence of states through both stores (``delta_max_chain = 3``)
  gives the same full/delta pattern and the same changed-leaf counts.
* A port delta chain restores bitwise the state it saved (parameters,
  stats, optimizer buffers, step, ``lr_scale``), as ``state.pt`` does.
* A chain the JAX package wrote for the tiny ResNet-DWT serves in the
  port as the JAX engine serves it (logits at ``rtol = atol = 1e-4``, the
  frameworks' convolutions summing in other orders, as
  ``tests/test_torch_checkpoint.py``) and starts a trainer
  (``--init_ckpt``) with its parameters and stats, bitwise.
* ``missing_parent_blob`` makes both walks fall back to the last full
  save; ``kill_mid_delta_promote`` (a real SIGKILL, in a subprocess)
  leaves the previous step authoritative; blob GC keeps every referenced
  blob and every blob younger than its age guard; pruning keeps a kept
  manifest's ancestors.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.ckpt import store as jax_store
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.resilience import inject as jax_inject
from dwt_tpu.serve.engine import ServeEngine as JaxServeEngine
from dwt_tpu.train import create_train_state
from dwt_tpu.train import optim as jax_optim
from dwt_tpu.utils import checkpoint as jax_ckpt
from dwt_tpu_torch.ckpt import store
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.nn.resnet import ResNetDWT, build_resnet
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_officehome_train_step
from dwt_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
CLASSES = 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    inject.disarm()
    jax_inject.disarm()


def _leaves(step):
    """The sequence's state at ``step``: four leaves, of which ``a`` moves
    at steps 2, 3, 5 and 7, ``b`` at 3 and ``c`` at 6 and 7."""
    moves = {"a": (2, 3, 5, 7), "b": (3,), "c": (6, 7), "d": ()}
    return {k: np.full((3, 4), sum(s <= step for s in at), np.float32) + 10 * i
            for i, (k, at) in enumerate(moves.items())}


def _host(arrays, step):
    payload = {"model": {k: torch.from_numpy(v.copy()) for k, v in arrays.items()},
               "optimizer": {"state": {}, "param_groups": [{"lr": 0.1, "params": []}]},
               "step": step, "lr_scale": 1.0}
    return ckpt.HostState(payload, tuple(arrays))


def test_delta_pattern_and_changed_leaves_match_the_jax_store(tmp_path):
    ours, ref = [], []
    for step in range(1, 9):
        arrays = _leaves(step)
        path = store.save_delta(str(tmp_path / "ours"), step, _host(arrays, step),
                                delta_max_chain=3)
        jpath = jax_store.save_delta(str(tmp_path / "jax"), step, {"params": arrays},
                                     delta_max_chain=3)
        for out, p in ((ours, path), (ref, jpath)):
            m = json.load(open(os.path.join(p, "manifest.json")))
            out.append((m["mode"], len(m["leaves"]), m["parent_step"]))
    assert ours == ref
    assert [m for m, _, _ in ours] == ["full", "delta", "delta", "delta",
                                       "full", "delta", "delta", "delta"]
    assert ckpt.valid_steps(str(tmp_path / "ours")) == list(range(1, 9))


def _trained_state(steps=2):
    model = build_resnet("tiny", num_classes=CLASSES, seed=1)
    model.to(memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    state = TrainState(model, optimizer, schedules)
    step = make_officehome_train_step(state.model)
    g = torch.Generator().manual_seed(0)
    for _ in range(steps):
        x = lambda: torch.randn(2, SIZE, SIZE, 3, generator=g)
        step(state, {"source_x": x(), "source_y": torch.tensor([0, 3]),
                     "target_x": x(), "target_aug_x": x()})
    return state


def test_a_port_delta_chain_restores_the_state_it_saved(tmp_path):
    state = _trained_state(1)
    root = str(tmp_path / "ck")
    store.save_delta(root, 1, state, data_state={"k": 1})
    step = make_officehome_train_step(state.model)
    g = torch.Generator().manual_seed(5)
    x = lambda: torch.randn(2, SIZE, SIZE, 3, generator=g)
    step(state, {"source_x": x(), "source_y": torch.tensor([1, 2]),
                 "target_x": x(), "target_aug_x": x()})
    state.lr_scale = 0.5
    store.save_delta(root, 2, state, data_state={"k": 2})
    m = json.load(open(os.path.join(root, "2", "manifest.json")))
    assert m["mode"] == "delta" and m["parent_step"] == 1
    full = json.load(open(os.path.join(root, "1", "manifest.json")))
    # Weights, stats and momentum all moved; the BN counts too.
    assert 0 < len(m["leaves"]) <= len(full["leaves"])
    assert ckpt.load_data_state(os.path.join(root, "2")) == {"k": 2}
    # The manifest's digest is the full format's.
    ckpt.save_state(str(tmp_path / "full"), 2, state)
    assert m["params_digest"] == json.load(open(
        tmp_path / "full" / "2" / "manifest.json"))["params_digest"]
    other = _trained_state(0)
    restored = ckpt.restore_state(root, other)
    assert (restored.step, other.step, other.lr_scale) == (2, 2, 0.5)
    want, got = state.state_dict(), other.state_dict()
    assert all(torch.equal(want["model"][k], got["model"][k]) for k in want["model"])
    for i, buffers in want["optimizer"]["state"].items():
        for name, v in buffers.items():
            assert torch.equal(v, got["optimizer"]["state"][i][name])
    assert other.model.conv1.weight.is_contiguous(memory_format=torch.channels_last)


def _jax_tiny_state(rng):
    """A tiny JAX ResNet-DWT ``TrainState`` at step 7 with perturbed
    affines and plausible random stats (``tests/test_torch_checkpoint.py``)."""
    model = JaxResNetDWT(stage_sizes=(1, 1, 1, 1), num_classes=CLASSES)
    tx = jax_optim.sgd_two_group(1e-2, 1e-3)
    state = create_train_state(model, jax.random.key(0),
                               jnp.zeros((3, 1, SIZE, SIZE, 3)), tx)

    def stat(path, a):
        name = path[-1].name if hasattr(path[-1], "name") else str(path[-1])
        a = np.asarray(a)
        if name == "cov":
            m = rng.normal(size=a.shape)
            return (m @ np.swapaxes(m, -1, -2) / 4 + 0.5 * np.eye(4)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, size=a.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.2, size=a.shape).astype(np.float32)
        return a

    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.1, a.shape).astype(np.float32) if a.ndim == 1 else np.asarray(a),
        state.params)
    stats = jax.tree_util.tree_map_with_path(stat, state.batch_stats)
    return model, state.replace(step=jnp.asarray(7), params=params, batch_stats=stats)


def test_a_jax_delta_chain_serves_and_starts_a_trainer(tmp_path):
    rng = np.random.default_rng(0)
    model, state = _jax_tiny_state(rng)
    root = str(tmp_path / "jax")
    jax_store.save_delta(root, 6, jax_ckpt.host_fetch(state.replace(step=jnp.asarray(6))))
    # The delta at 7 moves the head only; the chain resolves the rest.
    head = jax.tree.map(lambda a: np.asarray(a) * 1.5, state.params["fc_out"])
    state = state.replace(params={**state.params, "fc_out": head})
    jax_store.save_delta(root, 7, jax_ckpt.host_fetch(state))
    m = json.load(open(os.path.join(root, "7", "manifest.json")))
    assert m["mode"] == "delta" and ckpt.valid_steps(root) == [6, 7]
    images = rng.normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    ref = JaxServeEngine.from_checkpoint(root, model, (SIZE, SIZE, 3),
                                         buckets=(4,)).infer(images)
    engine = ServeEngine.from_checkpoint(root, ResNetDWT.tiny(num_classes=CLASSES),
                                         (SIZE, SIZE, 3), buckets=(4,), device="cpu")
    assert (engine.step, engine.source) == (7, "checkpoint")
    np.testing.assert_allclose(engine.infer(images), ref, **TOL)
    # It does not resume a port run (optax state), but it starts one.
    with pytest.raises(FileNotFoundError, match="does not resume"):
        ckpt.restore_state(root, _trained_state(0))
    records = []
    cfg = OfficeHomeConfig(synthetic=True, arch="tiny", num_classes=CLASSES,
                           img_crop_size=SIZE, source_batch_size=2, synthetic_size=8,
                           num_iters=1, check_acc_step=100, stat_collection_passes=0,
                           log_interval=1, init_ckpt=root, device="cpu")
    net = loop.build_model(cfg)
    first = {}

    def logger(kind, step, **fields):
        records.append((kind, step))
        if kind == "init_ckpt":
            first.update({k: v.detach().clone() for k, v in net.state_dict().items()})

    loop.run_officehome(cfg, logger, model=net)
    assert records[:2] == [("init_ckpt", 0), ("train", 1)]
    want = ResNetDWT.tiny(num_classes=CLASSES)
    ckpt.restore_model(os.path.join(root, "7"), want)
    assert all(torch.equal(first[k], v) for k, v in want.state_dict().items())


def test_a_missing_parent_blob_falls_back_to_the_full_save_in_both(tmp_path):
    for name, mod, save in (
            ("ours", inject, lambda d, s, a: store.save_delta(d, s, _host(a, s))),
            ("jax", jax_inject, lambda d, s, a: jax_store.save_delta(d, s, {"params": a}))):
        mod.arm(mod.FaultPlan(missing_parent_blob=3))
        root = str(tmp_path / name)
        for step in (1, 2, 3):
            save(root, step, _leaves(step + 1))
        mod.disarm()
        valid = (ckpt.valid_steps if name == "ours" else jax_ckpt.valid_steps)(root)
        assert valid == [1], name
    # The walk's fallback is the full save, whole.
    assert store.resolve_leaves(str(tmp_path / "ours" / "1")).manifest["mode"] == "full"
    payload = store.read_torch_payload(str(tmp_path / "ours" / "1"))
    assert all(torch.equal(payload["model"][k], torch.from_numpy(v))
               for k, v in _leaves(2).items())


def test_a_kill_mid_promote_leaves_the_previous_step(tmp_path):
    root = str(tmp_path / "ck")
    code = f"""
import numpy as np, torch
from dwt_tpu_torch.ckpt import store
from dwt_tpu_torch.resilience import inject
from dwt_tpu_torch.utils.checkpoint import HostState
def host(v, s):
    return HostState({{"model": {{"w": torch.full((4,), float(v))}},
                      "optimizer": {{"state": {{}}, "param_groups": []}},
                      "step": s, "lr_scale": 1.0}}, ("w",))
inject.arm(inject.FaultPlan(kill_mid_delta_promote=2))
store.save_delta({root!r}, 1, host(1, 1))
store.save_delta({root!r}, 2, host(2, 2))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == -9, out.stderr
    assert ckpt.valid_steps(root) == [1]
    assert any(d.startswith(".tmp-cas-2") for d in os.listdir(root))
    assert store.read_torch_payload(os.path.join(root, "1"))["step"] == 1


def test_gc_keeps_referenced_and_young_blobs_and_prune_keeps_ancestors(tmp_path):
    root = str(tmp_path / "ck")
    for step in (1, 2, 3):
        store.save_delta(root, step, _host(_leaves(step + 1), step))
    blobs = store.blob_store_root(root)
    referenced = {e["digest"] for s in (1, 2, 3) for e in json.load(
        open(os.path.join(root, str(s), "manifest.json")))["leaves"]}
    # An orphan (a stage that never promoted), old, and one just written.
    old, young = ("ab" * 32, "cd" * 32)
    for digest in (old, young):
        os.makedirs(os.path.join(blobs, digest[:2]), exist_ok=True)
        open(os.path.join(blobs, digest[:2], digest + ".bin"), "wb").write(b"x")
    past = time.time() - 2 * store.GC_MIN_AGE_S
    for s in (1, 2, 3):
        for e in json.load(open(os.path.join(root, str(s), "manifest.json")))["leaves"]:
            p = os.path.join(blobs, e["digest"][:2], e["digest"] + ".bin")
            os.utime(p, (past, past))
    os.utime(os.path.join(blobs, old[:2], old + ".bin"), (past, past))
    assert store.gc_blobs(blobs) == (1, 1)
    on_disk = {n[:-4] for d in os.listdir(blobs) for n in os.listdir(os.path.join(blobs, d))}
    assert referenced | {young} == on_disk
    # Keeping the newest step keeps its whole chain (1 is its full base).
    assert ckpt.prune_checkpoints(root, 1) == 0
    assert ckpt.valid_steps(root) == [1, 2, 3]
    store.save_delta(root, 4, _host(_leaves(5), 4), delta_max_chain=2)  # a full save
    assert ckpt.prune_checkpoints(root, 1) == 3 and ckpt.valid_steps(root) == [4]
