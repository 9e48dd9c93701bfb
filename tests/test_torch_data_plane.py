"""Port parity: the data plane of ``dwt_tpu_torch`` and the two trainers' streams, against the live JAX package.

``batch_iterator`` (train path: batch ids and arrays at two cursors and
two worker counts, with quarantine substitution and the prefix walk;
eval path: ``pad_and_mask``), ``DataPlane`` (snapshots, refusals of
mismatched snapshots, streams across epoch boundaries),
``prefetch_to_device`` on the CPU, and both trainers end to end from the
JAX loop's initial state: ``run_digits`` on synthetic data and
``run_officehome`` on a test-made image folder must give the JAX loop's
losses on every train record (``rtol = 1e-4``), the same accuracies and
counts, and eval losses within ``1e-2`` (``EVAL_LOSS_TOL``).  Every array
of the data path is held bitwise.
"""

from __future__ import annotations

import io
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dwt_tpu.config import DigitsConfig as JaxDigitsConfig
from dwt_tpu.config import OfficeHomeConfig as JaxOfficeHomeConfig
from dwt_tpu.data import datasets as jax_datasets
from dwt_tpu.data import loader as jax_loader
from dwt_tpu.data import pipeline as jax_pipeline
from dwt_tpu.data import transforms as jax_tf
from dwt_tpu.nn import LeNetDWT as JaxLeNetDWT
from dwt_tpu.nn import ResNetDWT as JaxResNetDWT
from dwt_tpu.train import loop as jax_loop
from dwt_tpu.utils.metrics import MetricLogger
from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.convert import load_jax_variables
from dwt_tpu_torch.data import datasets, loader, pipeline
from dwt_tpu_torch.data import transforms as tf
from dwt_tpu_torch.nn import LeNetDWT
from dwt_tpu_torch.nn.resnet import ResNetDWT
from dwt_tpu_torch.train import loop

LOSS_TOL = 1e-4
# Eval losses come from near-singular eval whitening: two steps move the
# running covariances only a tenth of the way from their all-ones init, so
# the step's rounding differences reach the logits amplified (readings
# 4.2e-4 digits, 3.3e-3 OfficeHome; ROADMAP queue 3 item 4).  The
# accuracies and counts are held exactly.
EVAL_LOSS_TOL = 1e-2


class _Flaky:
    """A dataset whose items at ``bad`` always raise; every other item is
    an image drawn through ``rng`` (a ``ThreadLocalRng``) and its label."""

    def __init__(self, n, rng, bad=()):
        self.images = np.random.default_rng(0).normal(
            size=(n, 4, 4, 2)).astype(np.float32)
        self.rng = rng
        self.bad = set(bad)
        self.loads = 0

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        self.loads += 1
        if i in self.bad:
            raise OSError(f"corrupt item {i}")
        img = self.images[i]
        aug = (img * self.rng.random() + self.rng.normal(size=img.shape)).astype(np.float32)
        return img, aug, i % 3


def _both(n, bad=(), **kw):
    """The port's and JAX's ``batch_iterator`` over twin datasets: each
    batch's ids and arrays, and the substitution count."""
    out = []
    for mod, tfm in ((loader, tf), (jax_loader, jax_tf)):
        ids, subs = [], []
        ds = _Flaky(n, tfm.ThreadLocalRng(7), bad)
        batches = list(mod.batch_iterator(
            ds, 5, seed=3, epoch=2, on_batch_ids=ids.append,
            on_substitute=lambda: subs.append(1), **kw))
        out.append((ids, batches, len(subs)))
    return out


def _assert_same_batches(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("num_workers", [0, 4])
@pytest.mark.parametrize("start_batch", [0, 3])
def test_batch_iterator_matches_jax(start_batch, num_workers):
    (ids, ours, _), (ref_ids, ref, _) = _both(
        23, start_batch=start_batch, num_workers=num_workers)
    assert ids == ref_ids and len(ids) == 4 - start_batch
    _assert_same_batches(ours, ref)
    full = jax_loader.SeekableSampler(23, seed=3, epoch=2).positions()
    assert sum(ids, []) == full[5 * start_batch: 20].tolist()
    # Bitwise the suffix of the epoch opened at 0, and the same at any
    # worker count.
    (_, whole, _), _ = _both(23, num_workers=2)
    _assert_same_batches(ours, whole[start_batch:])


@pytest.mark.parametrize("num_workers", [0, 4])
@pytest.mark.parametrize("start_batch", [0, 3])
def test_substitution_and_the_prefix_walk_match_jax(start_batch, num_workers):
    order = jax_loader.SeekableSampler(23, seed=3, epoch=2).positions()
    # The first two items of the epoch, one in the middle, and the item
    # at cursor 3 (position 15), whose substitute lies before the cursor.
    bad = {int(order[0]), int(order[1]), int(order[9]), int(order[15])}
    (ids, ours, subs), (ref_ids, ref, ref_subs) = _both(
        23, bad=bad, start_batch=start_batch, num_workers=num_workers,
        substitute=True)
    assert ids == ref_ids and subs == ref_subs > 0
    assert len(ids) == 4 - start_batch and not bad & set(sum(ids, []))
    _assert_same_batches(ours, ref)
    (_, whole, _), _ = _both(23, bad=bad, substitute=True)
    _assert_same_batches(ours, whole[start_batch:])
    # Without substitution a quarantined item is dropped; fail-fast raises.
    (ids, ours, _), (ref_ids, ref, _) = _both(23, bad=bad, num_workers=num_workers)
    assert ids == ref_ids and len(ids) == 3
    _assert_same_batches(ours, ref)
    with pytest.raises(OSError, match="corrupt item"):
        list(loader.batch_iterator(_Flaky(23, tf.ThreadLocalRng(7), bad), 5,
                                   quarantine=False))


def test_a_retry_loads_the_same_item_as_a_first_try():
    """A load that fails after drawing restarts its draws on the retry,
    so the item is bitwise JAX's first-try item (the JAX package's own
    retry on the same thread continues the stream instead)."""
    class Once(_Flaky):
        failed = False

        def __getitem__(self, i):
            if i == 4 and not self.failed:
                self.failed = True
                self.rng.normal(size=7)  # draws, then fails
                raise OSError("transient")
            return super().__getitem__(i)

    once = Once(10, tf.ThreadLocalRng(7))
    ours = list(loader.batch_iterator(once, 5))
    assert once.failed
    ref = list(jax_loader.batch_iterator(_Flaky(10, jax_tf.ThreadLocalRng(7)), 5))
    _assert_same_batches(ours, ref)


@pytest.mark.parametrize("n,bad", [(23, ()), (20, ()), (23, (22,)), (3, (1,))])
def test_pad_and_mask_matches_jax(n, bad):
    """Ids and masks equal JAX's, and every unmasked sample bitwise.  A
    padded slot reloads the last item: the port draws it afresh (bitwise
    the same at any worker count), the JAX package continues the stream
    of the thread that loaded it, so masked slots are not compared."""
    (ids, ours, _), (ref_ids, ref, _) = _both(
        n, bad=bad, shuffle=False, drop_last=False, pad_and_mask=True,
        num_workers=3)
    assert ids == ref_ids and len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a[-1], b[-1])
        for x, y in zip(a[:-1], b[:-1]):
            np.testing.assert_array_equal(x[a[-1]], y[b[-1]])
    (_, sequential, _), _ = _both(
        n, bad=bad, shuffle=False, drop_last=False, pad_and_mask=True)
    _assert_same_batches(ours, sequential)
    masks = np.concatenate([b[-1] for b in ours])
    assert len(masks) % 5 == 0 and int(masks.sum()) == n - len(bad)
    with pytest.raises(ValueError, match="eval-path contract"):
        list(loader.batch_iterator(_Flaky(4, None), 2, pad_and_mask=True))
    with pytest.raises(ValueError, match="resume cursor"):
        list(loader.batch_iterator(_Flaky(4, None), 2, shuffle=False,
                                   drop_last=False, pad_and_mask=True,
                                   start_batch=1))


def test_the_pool_keeps_order_and_resubmits_a_stalled_item():
    """A worker wedged on an item past the stall budget: the item is
    re-submitted to a fresh thread and the results stay in order."""
    release = threading.Event()
    attempts = []

    def load(i):
        attempts.append(i)
        if i == 3 and attempts.count(3) == 1:
            release.wait(timeout=30)  # the first attempt wedges
        time.sleep(0.001 * (i % 3))
        return i * i

    pool = pipeline.OrderedWorkerPool(2, stall_timeout=0.2)
    try:
        assert list(pool.imap(load, range(20))) == [i * i for i in range(20)]
    finally:
        release.set()
    assert attempts.count(3) == 2 and sorted(set(attempts)) == list(range(20))


def _plane_moves(plane):
    plane.register("source", seed=1, epoch_len=10)
    plane.register("target", seed=2, epoch_len=4)
    plane.register("target_aug", seed=2, epoch_len=4, alias_of="target")
    plane.advance(1)
    plane.advance(6)
    plane.note_substitution("target")
    plane.note_substitution("source")
    snaps = [plane.snapshot()]
    plane.seek_step(13)
    snaps.append(plane.snapshot())
    plane.seek_epoch(2)
    snaps.append(plane.snapshot())
    plane.advance(3)
    snaps.append(plane.snapshot())
    return snaps


def test_snapshots_match_jax():
    ours = _plane_moves(pipeline.DataPlane(seed_bump=2))
    ref = _plane_moves(jax_pipeline.DataPlane(seed_bump=2))
    assert ours == ref
    assert ours[1]["streams"]["target"] == {
        "seed": 2, "epoch_len": 4, "epoch": 3, "cursor": 1, "quarantine_subs": 1}


@pytest.mark.parametrize("change", [
    "none", "absent", "version", "streams", "epoch_len", "seed", "epoch_end"])
def test_load_snapshot_refuses_what_jax_refuses(change):
    snap = _plane_moves(jax_pipeline.DataPlane())[0]
    if change == "absent":
        snap = None
    elif change == "version":
        snap["version"] = 2
    elif change == "streams":
        del snap["streams"]["target_aug"]
    elif change == "epoch_len":
        snap["streams"]["source"]["epoch_len"] = 11
    elif change == "seed":
        snap["streams"]["target"]["seed"] = 5
    elif change == "epoch_end":
        snap["streams"]["source"]["cursor"] = 10  # saved exactly at epoch end
    results = []
    for mod in (pipeline, jax_pipeline):
        plane = mod.DataPlane()
        for role, seed, n, alias in (("source", 1, 10, None), ("target", 2, 4, None),
                                     ("target_aug", 2, 4, "target")):
            plane.register(role, seed=seed, epoch_len=n, alias_of=alias)
        results.append((plane.load_snapshot(snap), plane.snapshot()))
    assert results[0] == results[1]
    assert results[0][0] is (change in ("none", "epoch_end"))


def test_plane_streams_match_jax_across_epochs_and_seeks():
    datasets_ = {}
    for name, mod, tfm in (("ours", pipeline, tf), ("ref", jax_pipeline, jax_tf)):
        plane = mod.DataPlane(num_workers=3)
        plane.register("source", seed=1, epoch_len=4)
        plane.seek_step(6)  # epoch 1, cursor 2
        ds = _Flaky(21, tfm.ThreadLocalRng(2), bad={5})
        stream = plane.stream(ds, "source", 5)
        datasets_[name] = [next(stream) for _ in range(7)]  # crosses 2 epochs
        stream.close()
        first = list(plane.epoch_iterator(ds, "source", 5, epoch=0))
        datasets_[name + "_epoch"] = first
        assert plane.snapshot()["streams"]["source"]["quarantine_subs"] >= 1
    _assert_same_batches(datasets_["ours"], datasets_["ref"])
    _assert_same_batches(datasets_["ours_epoch"], datasets_["ref_epoch"])
    # The stream opened at step 6 is the continuation of one opened at 0.
    plane = pipeline.DataPlane()
    plane.register("source", seed=1, epoch_len=4)
    stream = plane.stream(_Flaky(21, tf.ThreadLocalRng(2), bad={5}), "source", 5)
    whole = [next(stream) for _ in range(13)]
    _assert_same_batches(datasets_["ours"], whole[6:])


def test_prefetch_on_the_cpu_yields_the_batches_and_stops_cleanly():
    rng = np.random.default_rng(0)
    src = [{"x": rng.normal(size=(3, 4)).astype(np.float32),
            "y": np.arange(3), "m": np.array([True, False, True])}
           for _ in range(5)]
    got = list(loader.prefetch_to_device(iter(src), size=2))
    assert len(got) == 5
    for a, b in zip(got, src):
        for k in b:
            assert isinstance(a[k], torch.Tensor) and a[k].device.type == "cpu"
            np.testing.assert_array_equal(a[k].numpy(), b[k])
    tuples = list(loader.prefetch_to_device(((b["x"], b["y"]) for b in src)))
    assert isinstance(tuples[0], tuple) and len(tuples) == 5

    def failing():
        yield src[0]
        raise OSError("decode failed")

    it = loader.prefetch_to_device(failing())
    next(it)
    with pytest.raises(OSError, match="decode failed"):
        next(it)

    pulled = []

    def endless():
        for i in range(10_000):
            pulled.append(i)
            yield src[i % 5]

    it = loader.prefetch_to_device(endless(), size=2)
    next(it)
    it.close()  # joins the producer
    assert not [t for t in threading.enumerate() if t.name == "dwt-prefetch"]
    assert len(pulled) <= 5  # bounded: the queue, the producer's item, one more


# ----------------------------------------------------------- the two loops


class _Records(MetricLogger):
    def __init__(self):
        super().__init__(stream=io.StringIO())
        self.records = []

    def log(self, kind, step, sync=False, flush=False, **values):
        self.records.append((kind, step, values))


def _compare_records(ours, ref, loss_keys):
    ours = [(k, f) for k, _, f in ours]
    ref = [(k, f) for k, _, f in ref if k in {k for k, _ in ours}]
    assert [k for k, _ in ours] == [k for k, _ in ref]
    for (kind, a), (_, b) in zip(ours, ref):
        if kind == "train":
            for key in loss_keys:
                np.testing.assert_allclose(a[key], b[key], rtol=LOSS_TOL,
                                           err_msg=key)
        elif kind in ("test", "final_test"):
            assert (a["accuracy"], a["count"]) == (b["accuracy"], b["count"])
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=EVAL_LOSS_TOL)


def test_run_digits_streams_the_jax_loops_batches():
    flags = dict(synthetic=True, synthetic_size=64, epochs=1, log_interval=1,
                 group_size=4, seed=1)
    ref = _Records()
    jax_loop.run_digits(JaxDigitsConfig(**flags), ref)
    # The JAX loop's initial state (create_train_state from key(seed)).
    variables = jax.jit(lambda k: JaxLeNetDWT(group_size=4).init(
        k, jnp.zeros((2, 32, 28, 28, 1)), train=True))(jax.random.key(1))
    model = load_jax_variables(LeNetDWT(group_size=4),
                               jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    ours = []
    loop.run_digits(DigitsConfig(**flags, device="cpu"),
                    lambda kind, step, **f: ours.append((kind, step, f)),
                    model=model)
    assert [k for k, _, _ in ours] == ["train", "train", "test", "params_digest"]
    _compare_records(ours, ref.records, ("cls_loss", "entropy_loss"))


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


def test_run_officehome_trains_from_image_folders_as_the_jax_loop(tmp_path, monkeypatch):
    _write_folders(tmp_path, np.random.default_rng(0))
    flags = dict(s_dset_path=str(tmp_path / "src"), t_dset_path=str(tmp_path / "tgt"),
                 arch="tiny", num_classes=4, img_resize=36, img_crop_size=32,
                 source_batch_size=8, test_batch_size=10, num_iters=2,
                 check_acc_step=2, stat_collection_passes=1, log_interval=1,
                 num_workers=2, seed=1)
    ref = _Records()
    jax_loop.run_officehome(JaxOfficeHomeConfig(**flags, resnet_path=""), ref)
    variables = jax.jit(lambda k: JaxResNetDWT(stage_sizes=(1, 1, 1, 1),
                                               num_classes=4).init(
        k, jnp.zeros((3, 8, 32, 32, 3)), train=True))(jax.random.key(1))
    model = load_jax_variables(ResNetDWT.tiny(num_classes=4),
                               jax.tree.map(np.asarray, variables["params"]),
                               jax.tree.map(np.asarray, variables["batch_stats"]))
    ours = []
    loop.run_officehome(OfficeHomeConfig(**flags, resnet_path="", device="cpu"),
                        lambda kind, step, **f: ours.append((kind, step, f)),
                        model=model)
    assert [k for k, _, _ in ours] == [
        "train", "train", "test", "stat_collection", "final_test", "params_digest"]
    assert ours[2][2]["count"] == 16 and ours[3][2]["forwards"] == 2
    _compare_records(ours, ref.records, ("cls_loss", "mec_loss"))
    # The CLI on the same folders, through --device cpu.
    from dwt_tpu_torch.cli import officehome

    args = ["--s_dset_path", flags["s_dset_path"], "--t_dset_path",
            flags["t_dset_path"], "--arch", "tiny", "--num_classes", "4",
            "--img_resize", "36", "--img_crop_size", "32",
            "--source_batch_size", "8", "--num_iters", "1",
            "--stat_collection_passes", "0", "--num_workers", "3",
            "--device", "cpu"]
    assert 0.0 <= officehome.main(args) <= 100.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        officehome.main(args[:-2])  # without --device cpu
    cfg = officehome.config_from_args(officehome.build_parser().parse_args([]))
    jax_cfg = JaxOfficeHomeConfig()
    assert (cfg.num_workers, cfg.img_resize, cfg.s_dset_path, cfg.t_dset_path) == (
        jax_cfg.num_workers, jax_cfg.img_resize, jax_cfg.s_dset_path,
        jax_cfg.t_dset_path)


def test_the_target_view_pairs_match_jax(tmp_path):
    """The folder datasets of both loops give the same item triples."""
    _write_folders(tmp_path, np.random.default_rng(1), classes=2, per_class=3)
    flags = dict(s_dset_path=str(tmp_path / "src"), t_dset_path=str(tmp_path / "tgt"),
                 img_resize=36, img_crop_size=32, seed=4)
    ours = loop._officehome_datasets(OfficeHomeConfig(**flags))
    ref = jax_loop._officehome_datasets(JaxOfficeHomeConfig(**flags))
    for a, b in zip(ours, ref):
        assert isinstance(a, datasets.ImageFolderDataset)
        assert isinstance(b, jax_datasets.ImageFolderDataset)
        _assert_same_batches(list(loader.batch_iterator(a, 3, seed=4)),
                             list(jax_loader.batch_iterator(b, 3, seed=4)))
    synth = dict(synthetic=True, synthetic_size=6, img_crop_size=16, num_classes=3)
    ours = loop._officehome_datasets(OfficeHomeConfig(**synth))[1]
    ref = jax_loop._officehome_datasets(JaxOfficeHomeConfig(**synth))[1]
    a = list(loader.batch_iterator(ours, 3, seed=2, num_workers=2))
    b = list(jax_loader.batch_iterator(ref, 3, seed=2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[2], y[2])
        if jax_tf._HAS_CV2:  # the augmented view: scipy against cv2
            assert float(np.abs(x[1] - y[1]).max()) <= 2e-4
