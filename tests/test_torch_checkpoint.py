"""The port's checkpoints (``dwt_tpu_torch.utils.checkpoint``): atomic saves, validation, the newest-valid walk, and the JAX host-shard read.

Held exactly (``torch.equal``, bitwise): a ``TrainState`` round trip and
the updates that follow it, the fallbacks of the walk, pruning and
anchors, the quarantine registry.  A JAX host-shard checkpoint served by
the port is held to the JAX engine's logits at ``rtol = atol = 1e-4``
(the convolutions sum in other orders in XLA and in PyTorch's CPU
kernels, as in ``tests/test_torch_resnet.py``).
"""

from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dwt_tpu.data import loader as jax_loader
from dwt_tpu.data import pipeline as jax_pipeline
from dwt_tpu.data import transforms as jax_tf
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.serve.engine import ServeEngine as JaxServeEngine
from dwt_tpu.train import create_train_state
from dwt_tpu.train import optim as jax_optim
from dwt_tpu.utils import checkpoint as jax_ckpt
from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.data import loader, pipeline
from dwt_tpu_torch.data import transforms as tf
from dwt_tpu_torch.nn.norms import install_eval_matrix, whitening_sites
from dwt_tpu_torch.nn.resnet import ResNetDWT, build_resnet
from dwt_tpu_torch.serve.engine import ServeEngine
from dwt_tpu_torch.train import loop
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_officehome_train_step
from dwt_tpu_torch.utils import checkpoint as ckpt

SIZE = 32
CLASSES = 4
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs six test processes on the
    box's cores, and small models gain nothing from more."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _state(seed=1):
    """A tiny ResNet-DWT on the CPU, channels_last, with the OfficeHome
    optimizer."""
    model = build_resnet("tiny", num_classes=CLASSES, seed=seed)
    model.to(memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, OfficeHomeConfig())
    return TrainState(model, optimizer, schedules)


def _batch(seed):
    g = torch.Generator().manual_seed(seed)
    x = lambda: torch.randn(2, SIZE, SIZE, 3, generator=g)
    return {"source_x": x(), "source_y": torch.tensor([0, 3]),
            "target_x": x(), "target_aug_x": x()}


def _trained_state(steps=2):
    state = _state()
    step = make_officehome_train_step(state.model)
    for i in range(steps):
        step(state, _batch(i))
    return state


def _assert_same_state(a: TrainState, b: TrainState):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for k, buffers in oa["state"].items():
        for name, v in buffers.items():
            assert torch.equal(v, ob["state"][k][name]), (k, name)


def test_train_state_round_trip_is_bitwise_and_digest_verified(tmp_path):
    state = _trained_state()
    path = ckpt.save_state(str(tmp_path), state.step, state)
    manifest = json.load(open(os.path.join(path, ckpt.MANIFEST)))
    assert manifest["format"] == "torch_full" and manifest["step"] == 2
    assert manifest["params_digest"] == ckpt.params_digest(
        state.model.named_parameters())
    assert manifest["files"] == {"state.pt": os.path.getsize(
        os.path.join(path, "state.pt"))}

    fresh = _state(seed=5)
    restored = ckpt.restore_state(str(tmp_path), fresh)
    assert restored.step == 2 and restored.source == "checkpoint"
    _assert_same_state(state, fresh)
    # Momentum restored beside a channels_last weight takes its layout,
    # and the next updates are bitwise the uninterrupted run's.
    conv = fresh.model.conv1.weight
    assert conv.is_contiguous(memory_format=torch.channels_last)
    buf = fresh.optimizer.state[conv]["momentum_buffer"]
    assert buf.is_contiguous(memory_format=torch.channels_last)
    for s in (state, fresh):
        make_officehome_train_step(s.model)(s, _batch(7))
    _assert_same_state(state, fresh)


def test_load_clears_the_eval_cache_and_restores_the_lr_step():
    state = _trained_state(steps=1)
    site = next(iter(whitening_sites(state.model).values()))
    install_eval_matrix(site, torch.eye(4).repeat(site.features // 4, 1, 1))
    payload = state.state_dict()
    assert "dn1.eval_matrix" not in payload["model"]
    state.load_state_dict(payload)
    assert site.eval_matrix is None and state.step == 1
    # Host copies: saving never aliases the live tensors.
    assert payload["model"]["conv1.weight"].data_ptr() != \
        state.model.conv1.weight.data_ptr()


class _Killed(BaseException):
    """A kill: no ``except OSError`` handler runs."""


def test_a_crash_before_the_finalize_keeps_the_previous_step(tmp_path, monkeypatch):
    root = str(tmp_path)
    state = _trained_state(steps=1)
    ckpt.save_state(root, 1, state)
    real = os.replace

    def crash(src, dst):
        if dst == os.path.join(root, "2"):
            raise _Killed
        return real(src, dst)

    monkeypatch.setattr(os, "replace", crash)
    with pytest.raises(_Killed):
        ckpt.save_state(root, 2, state)
    monkeypatch.setattr(os, "replace", real)
    assert os.path.isdir(os.path.join(root, ".tmp-2"))
    assert ckpt.valid_steps(root) == [1]
    assert ckpt.restore_state(root, _state(seed=3)).step == 1
    # A failing write (not a kill) removes its own tmp directory.
    monkeypatch.setattr(os, "replace", lambda s, d: (_ for _ in ()).throw(
        OSError("disk gone")) if d == os.path.join(root, "3") else real(s, d))
    with pytest.raises(OSError):
        ckpt.save_state(root, 3, state)
    monkeypatch.setattr(os, "replace", real)
    assert not os.path.exists(os.path.join(root, ".tmp-3"))
    # The next save sweeps the stale tmp directory of the dead writer.
    old = os.path.getmtime(os.path.join(root, ".tmp-2")) - 2 * ckpt.STALE_TMP_AGE_S
    os.utime(os.path.join(root, ".tmp-2"), (old, old))
    ckpt.save_state(root, 4, state)
    assert sorted(os.listdir(root)) == ["1", "4"]
    # A same-step re-save replaces the step in place.
    first = json.load(open(os.path.join(root, "4", ckpt.MANIFEST)))["timestamp"]
    ckpt.save_state(root, 4, state)
    assert sorted(os.listdir(root)) == ["1", "4"]
    assert json.load(open(os.path.join(root, "4", ckpt.MANIFEST)))["timestamp"] > first


def test_a_torn_step_falls_back_and_an_explicit_step_refuses(tmp_path):
    root = str(tmp_path)
    state = _trained_state(steps=1)
    for s in (1, 2, 3):
        state.step = s
        ckpt.save_state(root, s, state)
    # Step 3 truncated: invalid without reading its bytes.
    with open(os.path.join(root, "3", "state.pt"), "r+b") as f:
        f.truncate(1000)
    assert ckpt.checkpoint_invalid_reason(os.path.join(root, "3")).startswith(
        "manifest-listed file state.pt truncated")
    # Step 2 bit-flipped in a parameter's bytes: same size, wrong digest.
    blob = bytearray(open(os.path.join(root, "2", "state.pt"), "rb").read())
    weight = state.model.fc_out.weight.detach().contiguous().numpy().tobytes()
    at = bytes(blob).find(weight)
    assert at > 0
    blob[at + 1] ^= 0xFF
    open(os.path.join(root, "2", "state.pt"), "wb").write(bytes(blob))
    assert ckpt.valid_steps(root) == [1, 2]
    fresh = _state(seed=9)
    restored = ckpt.restore_newest(root, fresh)
    assert (restored.step, restored.source) == (1, "checkpoint") and fresh.step == 1
    with pytest.raises(ValueError, match="digest"):
        ckpt.restore_state(root, _state(), step=2)
    with pytest.raises(FileNotFoundError, match="missing, unfinalized, or truncated"):
        ckpt.restore_state(root, _state(), step=3)


def test_keep_prunes_the_main_directory_and_anchors_rank_by_step(tmp_path):
    root = str(tmp_path / "run")
    state = _trained_state(steps=1)
    for s in (1, 2, 3):
        state.step = s
        ckpt.save_state(root, s, state, keep=2)
    for s in (1, 4):
        state.step = s
        ckpt.save_state(ckpt.anchor_dir(root), s, state)
    assert ckpt.valid_steps(root) == [2, 3]
    assert ckpt.valid_steps(ckpt.anchor_dir(root)) == [1, 4]
    assert [(s, src) for s, _, src, _ in ckpt.ranked_checkpoints(root)] == [
        (4, "anchor"), (3, "checkpoint"), (2, "checkpoint"), (1, "anchor")]
    assert ckpt.restore_newest(root, _state()).source == "anchor"
    os.remove(os.path.join(ckpt.anchor_dir(root), "4", "state.pt"))
    restored = ckpt.restore_newest(root, _state())
    assert (restored.step, restored.source) == (3, "checkpoint")
    # A model whose structure differs does not restore from any step.
    with pytest.raises(FileNotFoundError, match="the model expects"):
        ckpt.restore_newest(root, build_resnet("tiny", num_classes=CLASSES + 1))


def test_require_finite_refuses_nan_params_and_writes_no_best_record(tmp_path):
    state = _trained_state(steps=1)
    with torch.no_grad():
        state.model.fc_out.bias[0] = float("nan")
    assert ckpt.save_state(str(tmp_path / "a"), 1, state) is None
    assert not os.path.exists(tmp_path / "a" / "1")
    # In the loop: parameters poisoned after the last step before the
    # eval — the best save is refused, so no best_gr_4/ and no best.json.
    cfg = OfficeHomeConfig(synthetic=True, arch="tiny", num_classes=CLASSES,
                           img_crop_size=SIZE, source_batch_size=2,
                           synthetic_size=8, num_iters=2, check_acc_step=2,
                           stat_collection_passes=0, log_interval=1,
                           num_workers=0, ckpt_dir=str(tmp_path / "run"),
                           ckpt_every_iters=1, device="cpu")
    model = loop.build_model(cfg)
    kinds = []

    def logger(kind, step, **fields):
        kinds.append(kind)
        if kind == "train" and step == 2:
            with torch.no_grad():
                model.fc_out.bias.fill_(float("nan"))

    loop.run_officehome(cfg, logger, model=model)
    assert "best" not in kinds and kinds.count("checkpoint") == 1
    assert sorted(os.listdir(tmp_path / "run")) == ["1"]


def test_channels_last_digests_as_its_nchw_copy():
    model = build_resnet("tiny", num_classes=CLASSES, seed=2)
    nchw = copy.deepcopy(model)
    model.to(memory_format=torch.channels_last)
    assert model.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert not nchw.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    assert ckpt.params_digest(model.named_parameters()) == ckpt.params_digest(
        nchw.named_parameters())


class _Flaky:
    """Items at ``bad`` always raise; counts every access per index."""

    def __init__(self, n, rng, bad=()):
        self.images = np.random.default_rng(0).normal(
            size=(n, 4, 4, 2)).astype(np.float32)
        self.rng = rng
        self.bad = set(bad)
        self.loads = {}

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        self.loads[i] = self.loads.get(i, 0) + 1
        if i in self.bad:
            raise OSError(f"corrupt item {i}")
        img = self.images[i]
        return img, (img * self.rng.random()).astype(np.float32), i % 3


def _epoch(mod, tfm, ckpt_dir, bad):
    """One epoch of the ``source`` stream of a plane with a registry under
    ``ckpt_dir``: the dataset, the batches and the batch ids."""
    ds = _Flaky(23, tfm.ThreadLocalRng(7), bad)
    plane = mod.DataPlane(quarantine_registry=(
        loader if mod is pipeline else jax_loader).QuarantineRegistry.for_ckpt_dir(
            ckpt_dir))
    plane.register("source", seed=3, epoch_len=4)
    batches = list(plane.epoch_iterator(ds, "source", 5))
    return ds, batches


def test_the_quarantine_registry_persists_and_a_resume_skips_its_items(tmp_path):
    bad = (4, 17)
    ds, first = _epoch(pipeline, tf, str(tmp_path / "ours"), bad)
    assert all(ds.loads.get(i) == 2 for i in bad)  # a try and a retry
    _, ref = _epoch(jax_pipeline, jax_tf, str(tmp_path / "jax"), bad)
    ours = json.load(open(tmp_path / "ours" / "quarantine.json"))
    assert ours == json.load(open(tmp_path / "jax" / "quarantine.json"))
    assert ours == {"source": sorted(bad)}
    # The resumed run reads the registry and never touches the bad items,
    # with the same substituted batches.
    ds, again = _epoch(pipeline, tf, str(tmp_path / "ours"), bad)
    assert not any(i in ds.loads for i in bad)
    for a, b in zip(first, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(first, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _jax_tiny_state(rng):
    """A tiny JAX ResNet-DWT ``TrainState`` at step 7 with perturbed
    affines and plausible random stats (SPD covariances, positive
    variances), so no site runs on its init values."""
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
    return model, state.replace(step=jnp.asarray(7), params=params,
                                batch_stats=stats)


def test_a_jax_host_shard_checkpoint_serves_as_the_jax_engine(tmp_path):
    rng = np.random.default_rng(0)
    model, state = _jax_tiny_state(rng)
    root = str(tmp_path / "host_shards")
    host = jax_ckpt.host_fetch(state)
    assert jax_ckpt.save_host_shard(root, 7, host, 0, data_state=None)
    jax_ckpt.promote_host_shards(root, 7, 1)
    images = rng.normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    ref = JaxServeEngine.from_checkpoint(root, model, (SIZE, SIZE, 3),
                                         buckets=(4,)).infer(images)
    engine = ServeEngine.from_checkpoint(
        root, ResNetDWT.tiny(num_classes=CLASSES), (SIZE, SIZE, 3),
        buckets=(4,), device="cpu")
    assert (engine.step, engine.source) == (7, "checkpoint")
    np.testing.assert_allclose(engine.infer(images), ref, **TOL)
    # A model of another width does not restore from it.
    with pytest.raises(FileNotFoundError, match="shape"):
        ServeEngine.from_checkpoint(root, ResNetDWT.tiny(num_classes=CLASSES + 1),
                                    (SIZE, SIZE, 3), buckets=(1,), device="cpu")
    # Orbax directories are recognized and refused, naming ROADMAP.
    orbax = str(tmp_path / "orbax")
    jax_ckpt.save_state(orbax, 7, state)
    with pytest.raises(FileNotFoundError, match="Orbax.*ROADMAP"):
        ServeEngine.from_checkpoint(orbax, ResNetDWT.tiny(num_classes=CLASSES),
                                    (SIZE, SIZE, 3), buckets=(1,), device="cpu")
