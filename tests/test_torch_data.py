"""Port parity: the data path's pieces of ``dwt_tpu_torch`` against the live JAX package.

The seekable sampler, the PIL transforms under an item's seed token, the
two fused transforms and the native library behind them, the scipy
``warp_affine`` against the JAX package's cv2 path, and the image-folder
dataset.  Everything but ``warp_affine`` is held bitwise: the port runs
the same numpy, PIL and C++ code on the same inputs.  ``warp_affine``
computes in floats through scipy where the JAX package takes cv2 (which
steps its coordinates in 1/32 of a pixel): held at ``2e-4`` absolute on
N(0, 1) images (readings ≤ 7.6e-5 at 224×224×3 and ≤ 6.4e-6 at 28×28×1).
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from dwt_tpu import native as jax_native
from dwt_tpu.data import datasets as jax_datasets
from dwt_tpu.data import sampler as jax_sampler
from dwt_tpu.data import transforms as jax_tf
from dwt_tpu_torch import native
from dwt_tpu_torch.data import datasets, sampler
from dwt_tpu_torch.data import transforms as tf

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
WARP_TOL = 2e-4


@pytest.mark.parametrize("n", [0, 1, 2, 18, 256, 4097])
def test_sampler_matches_jax(n):
    rng = np.random.default_rng(n)
    for seed in (0, 1, 12345):
        for epoch in (0, 3):
            ours = sampler.SeekableSampler(n, seed, epoch)
            ref = jax_sampler.SeekableSampler(n, seed, epoch)
            np.testing.assert_array_equal(ours.positions(), ref.positions())
            if n:
                picks = rng.integers(0, n, size=7)
                np.testing.assert_array_equal(ours.take(picks), ref.take(picks))
                assert ours[n - 1] == ref[n - 1]
                np.testing.assert_array_equal(ours.positions(n // 3, n),
                                              ref.positions(n // 3, n))
            assert sorted(ours.positions().tolist()) == list(range(n))
    np.testing.assert_array_equal(
        sampler.SeekableSampler(n, 1, 0, shuffle=False).positions(), np.arange(n))
    for bs in (1, 7, 18):
        for drop_last in (True, False):
            assert (sampler.epoch_batch_count(n, bs, drop_last)
                    == jax_sampler.epoch_batch_count(n, bs, drop_last))
    assert sampler.FEISTEL_ROUNDS == jax_sampler.FEISTEL_ROUNDS == 4


def _image(rng, h, w):
    return Image.fromarray(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))


def _pair(name, pkg, rng):
    """The transform ``name`` of ``pkg`` (the port's or JAX's), on ``rng``."""
    return {
        "resize": lambda: pkg.Resize(40),
        "random_crop": lambda: pkg.RandomCrop(24, rng=rng),
        "random_hflip": lambda: pkg.RandomHorizontalFlip(rng=rng),
        "to_array": lambda: pkg.ToArray(),
        "to_array_normalize": lambda: pkg.Compose([pkg.ToArray(),
                                                  pkg.Normalize(MEAN, STD)]),
        "fused_to_array_normalize": lambda: pkg.FusedToArrayNormalize(MEAN, STD),
        "fused_affine_blur_normalize": lambda: pkg.FusedAffineBlurNormalize(
            MEAN, STD, rng=rng),
        "base_view": lambda: pkg.Compose([
            pkg.Resize(36), pkg.RandomCrop(32, rng=rng),
            pkg.FusedToArrayNormalize(MEAN, STD)]),
        "augmented_view": lambda: pkg.Compose([
            pkg.Resize(36), pkg.RandomCrop(32, rng=rng),
            pkg.RandomHorizontalFlip(rng=rng),
            pkg.FusedAffineBlurNormalize(MEAN, STD, rng=rng)]),
    }[name]()


@pytest.mark.parametrize("name", [
    "resize", "random_crop", "random_hflip", "to_array", "to_array_normalize",
    "fused_to_array_normalize", "fused_affine_blur_normalize", "base_view",
    "augmented_view"])
def test_transforms_match_jax_bitwise_under_an_item_token(name):
    ours = _pair(name, tf, tf.ThreadLocalRng(5))
    ref = _pair(name, jax_tf, jax_tf.ThreadLocalRng(5))
    rng = np.random.default_rng(1)
    for i, (h, w) in enumerate([(37, 53), (60, 41), (24, 24), (45, 45)]):
        img = _image(rng, h, w)
        outs = []
        for set_seed, t in ((tf.set_item_seed, ours), (jax_tf.set_item_seed, ref)):
            set_seed((1, 0, i))
            try:
                outs.append(np.asarray(t(img)))
            finally:
                set_seed(None)
        a, b = outs
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_thread_local_rng_follows_the_token_on_any_thread():
    import threading

    rng = tf.ThreadLocalRng(3)
    ref = jax_tf.ThreadLocalRng(3)
    draws = {}

    def draw(key, r, set_seed, token):
        set_seed(token)
        try:
            draws[key] = (r.integers(0, 1000, size=4).tolist(), r.random(),
                          r.normal(), r.permutation(5).tolist())
        finally:
            set_seed(None)

    threads = [threading.Thread(target=draw, args=(k, r, s, (1, 2, 7)))
               for k, r, s in (("a", rng, tf.set_item_seed),
                               ("b", ref, jax_tf.set_item_seed))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    draw("c", rng, tf.set_item_seed, (1, 2, 7))
    draw("d", rng, tf.set_item_seed, (1, 2, 8))
    assert draws["a"] == draws["b"] == draws["c"] != draws["d"]


def test_native_source_and_flags_are_the_jax_packages():
    with open(jax_native._SRC, "rb") as f:
        assert native.SRC.read_bytes() == f.read()
    assert native.GXX_FLAGS == ("-O3", "-shared", "-fPIC", "-std=c++17")
    assert native.library_path().parent.name == "native"
    assert native.library_path().parent.parent.name == "build"


@pytest.mark.parametrize("c", [1, 3, 16])
def test_native_passes_match_jax_native_bitwise(c):
    assert jax_native.available()
    rng = np.random.default_rng(c)
    for h, w in [(32, 32), (17, 45), (224, 224)]:
        a = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
        mean = rng.uniform(0.3, 0.6, size=c).astype(np.float32)
        std = rng.uniform(0.2, 0.3, size=c).astype(np.float32)
        np.testing.assert_array_equal(native.normalize_from_u8(a, mean, std),
                                      jax_native.normalize_from_u8(a, mean, std))
        m = jax_tf.draw_affine_matrix(rng)
        np.testing.assert_array_equal(
            native.warp_affine_normalize_from_u8(a, m, mean, std),
            jax_native.warp_affine_normalize_from_u8(a, m, mean, std))
    with pytest.raises(ValueError, match="1..16 channels"):
        native.normalize_from_u8(np.zeros((4, 4, 17), np.uint8), 0.5, 0.5)
    with pytest.raises(ValueError, match="uint8 HWC"):
        native.normalize_from_u8(np.zeros((4, 4, 3), np.float32), 0.5, 0.5)


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "augment.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    img = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="failed for augment.cpp"):
        tf.FusedToArrayNormalize(MEAN, STD)(img)
    with pytest.raises(RuntimeError, match="failed for augment.cpp"):
        tf.FusedAffineBlurNormalize(MEAN, STD, rng=np.random.default_rng(0))(img)
    assert not list((tmp_path / "build").glob("*"))  # no partial library
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load()
    # A float image never needs the library: the numpy steps.
    x = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(tf.FusedToArrayNormalize(MEAN, STD)(x),
                                  jax_tf.FusedToArrayNormalize(MEAN, STD)(x))


@pytest.mark.parametrize("shape", [(224, 224, 3), (28, 28, 1)])
def test_warp_affine_matches_the_jax_cv2_path(shape):
    if not jax_tf._HAS_CV2:
        pytest.skip("cv2 does not import here, so the JAX package has no cv2 "
                    "path to hold the port's scipy warp to")
    for seed in range(3):
        rng = np.random.default_rng(seed)
        a = rng.normal(size=shape).astype(np.float32)
        m = jax_tf.draw_affine_matrix(rng)
        ours, ref = tf.warp_affine(a, m), jax_tf.warp_affine(a, m)
        assert ours.shape == ref.shape == shape and ours.dtype == np.float32
        assert float(np.abs(ours - ref).max()) <= WARP_TOL
        # Through the rng as the synthetic augmented view draws it.
        ours = tf.gaussian_blur(tf.random_affine(a, rng=np.random.default_rng(seed)))
        ref = jax_tf.gaussian_blur(jax_tf.random_affine(
            a, rng=np.random.default_rng(seed)))
        assert float(np.abs(ours - ref).max()) <= WARP_TOL
    # A real blur kernel (sigma 1: ksize 9) goes through scipy in the port.
    blurred = tf.gaussian_blur(a, 1.0)
    assert blurred.shape == shape and np.isfinite(blurred).all()


def _write_folder(root, rng):
    """3 classes of 6 images each, JPEG and PNG of mixed sizes, a stray
    text file and a nested directory."""
    for k, cls in enumerate(("bird", "cat", "dog")):
        d = root / cls
        (d / "more").mkdir(parents=True)
        for i in range(6):
            h, w = rng.integers(20, 70, size=2)
            img = Image.fromarray(rng.integers(0, 256, size=(h, w, 3),
                                               dtype=np.uint8))
            if i % 2:
                img.save(d / f"im{i}.jpg", quality=90)
            elif i == 4:
                img.convert("L").save(d / "more" / f"im{i}.PNG")
            else:
                img.save(d / f"im{i}.png")
        (d / "notes.txt").write_text("not an image")
    (root / "stray.jpg").write_bytes(b"")  # not in a class directory


def test_image_folder_dataset_matches_jax(tmp_path):
    _write_folder(tmp_path, np.random.default_rng(0))
    rng, jrng = tf.ThreadLocalRng(1), jax_tf.ThreadLocalRng(1)
    ours = datasets.ImageFolderDataset(
        str(tmp_path), transform=_pair("base_view", tf, rng),
        transform_aug=_pair("augmented_view", tf, rng))
    ref = jax_datasets.ImageFolderDataset(
        str(tmp_path), transform=_pair("base_view", jax_tf, jrng),
        transform_aug=_pair("augmented_view", jax_tf, jrng))
    assert ours.classes == ref.classes == ["bird", "cat", "dog"]
    assert ours.samples == ref.samples and len(ours) == 18
    assert ours.targets == ref.targets
    assert datasets.IMG_EXTENSIONS == jax_datasets.IMG_EXTENSIONS
    for i in range(len(ours)):
        tf.set_item_seed((1, 0, i))
        jax_tf.set_item_seed((1, 0, i))
        try:
            a, b = ours[i], ref[i]
        finally:
            tf.set_item_seed(None)
            jax_tf.set_item_seed(None)
        assert len(a) == len(b) == 3 and a[2] == b[2]
        for x, y in zip(a[:2], b[:2]):
            assert x.shape == (32, 32, 3) and x.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    plain = datasets.ImageFolderDataset(str(tmp_path))
    img, label = plain[0]
    assert img.mode == "RGB" and label == 0
    (tmp_path / "empty" / "x").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="Found 0 images"):
        datasets.ImageFolderDataset(str(tmp_path / "empty"))
