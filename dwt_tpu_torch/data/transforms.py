"""Image transforms — ``dwt_tpu.data.transforms``, copied: PIL for geometry, numpy, scipy and the native passes for the pixel math.

The OfficeHome stacks of the reference
(``resnet50_dwt_mec_officehome.py:481-492,527-543``): resize → random
crop → normalize for the source, test and base target view, and resize →
random crop → hflip → random affine → (near-no-op) gaussian blur →
normalize for the augmented target view.  Callables map ``img -> img``,
where ``img`` is a PIL Image until ``ToArray`` and an HWC float32 array
after.  The PIL calls, the rng calls and the order of the draws are the
JAX package's, so an item's pixels are the same in both packages.

Where the JAX package takes cv2 (``warp_affine``, ``gaussian_blur`` with
a real kernel), the port takes scipy: ``warp_affine`` matches cv2's
bilinear warp with a zero border to float rounding.  The ``Fused*``
transforms always take the native pass (``dwt_tpu_torch.native``) for a
uint8 HWC image of up to 16 channels, and raise when it cannot be built.

Stochastic transforms draw from a :class:`ThreadLocalRng`: while the
loader loads an item it declares the item's token with
:func:`set_item_seed`, and the draws then depend only on (seed, token),
never on the thread or the worker count.
"""

from __future__ import annotations

import itertools
import threading
from typing import Sequence

import numpy as np

from dwt_tpu_torch import native

_ITEM_SEED = threading.local()
_ENTRIES = itertools.count()  # one number per item context entered


def set_item_seed(token) -> None:
    """Declare the (hashable, int-tuple) identity of the item being loaded
    on THIS thread; ``ThreadLocalRng`` derives its stream from it, so an
    item's augmentations depend only on (rng seed, item token).
    ``batch_iterator`` sets it around every ``dataset[i]`` call; ``None``
    clears it.

    Every call opens a new context, in which each ``ThreadLocalRng``
    starts its stream afresh, also for a token this thread loaded before
    (a retry, the repeated last item of a padded eval batch).  The JAX
    package keeps the stream running then, so those loads there depend
    on which thread ran them; for every other load the draws are its."""
    _ITEM_SEED.token = token
    _ITEM_SEED.entry = None if token is None else next(_ENTRIES)


class ThreadLocalRng:
    """``np.random.Generator`` facade that is thread-safe and item-deterministic.

    While an item is being loaded (``set_item_seed`` active), draws come
    from a generator seeded by ``(seed, *item_token)`` at the start of
    the item's context: the same whether the item loads sequentially, on
    any pool size, or on any thread.
    Outside an item each thread draws from its own spawned stream (valid
    draws, no races, no promise across runs).
    """

    def __init__(self, seed: int = 0):
        self._entropy = int(seed)
        self._seq = np.random.SeedSequence(self._entropy)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _gen(self) -> np.random.Generator:
        token = getattr(_ITEM_SEED, "token", None)
        if token is not None:
            if getattr(self._local, "entry", None) != _ITEM_SEED.entry:
                self._local.item_gen = np.random.default_rng(
                    np.random.SeedSequence((self._entropy,) + tuple(token))
                )
                self._local.entry = _ITEM_SEED.entry
            return self._local.item_gen
        gen = getattr(self._local, "gen", None)
        if gen is None:
            with self._lock:  # SeedSequence.spawn mutates internal state
                child = self._seq.spawn(1)[0]
            gen = np.random.default_rng(child)
            self._local.gen = gen
        return gen

    def integers(self, *args, **kwargs):
        return self._gen().integers(*args, **kwargs)

    def random(self, *args, **kwargs):
        return self._gen().random(*args, **kwargs)

    def normal(self, *args, **kwargs):
        return self._gen().normal(*args, **kwargs)

    def permutation(self, *args, **kwargs):
        return self._gen().permutation(*args, **kwargs)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class Resize:
    """Resize to ``(size, size)`` with PIL's bilinear filter, as
    ``transforms.Resize((s, s))`` in the reference."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img):
        from PIL import Image

        return img.resize((self.size, self.size), Image.BILINEAR)


class RandomCrop:
    def __init__(self, size: int, rng: np.random.Generator | None = None):
        self.size = size
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        w, h = img.size
        if (w, h) == (self.size, self.size):
            return img
        left = int(self.rng.integers(0, w - self.size + 1))
        top = int(self.rng.integers(0, h - self.size + 1))
        return img.crop((left, top, left + self.size, top + self.size))


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, rng: np.random.Generator | None = None):
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, img):
        from PIL import Image

        if self.rng.random() < self.p:
            return img.transpose(Image.FLIP_LEFT_RIGHT)
        return img


class ToArray:
    """PIL (or numpy) → HWC float32 in [0, 1]: torch's ``ToTensor`` without
    the NCHW permute.  Integer input always divides by 255; float input
    only when it looks 255-ranged."""

    def __call__(self, img) -> np.ndarray:
        raw = np.asarray(img)
        a = raw.astype(np.float32)
        if a.ndim == 2:
            a = a[:, :, None]
        if raw.dtype.kind in "ui":
            a = a / 255.0
        elif a.max() > 1.5:  # 255-ranged float input
            a = a / 255.0
        return a


class Normalize:
    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, a: np.ndarray) -> np.ndarray:
        return (a - self.mean) / self.std


def draw_affine_matrix(
    rng: np.random.Generator, sigma: float = 0.1
) -> np.ndarray:
    """The reference's random 2x3 matrix: identity with N(0, sigma)
    perturbations, zero translation.  The native and the array paths
    both draw it here, so they consume the same draws in the same order."""
    return np.float32(
        [
            [1 + rng.normal(0, sigma), rng.normal(0, sigma), 0],
            [rng.normal(0, sigma), 1 + rng.normal(0, sigma), 0],
        ]
    )


def random_affine(
    a: np.ndarray, sigma: float = 0.1, rng: np.random.Generator | None = None
) -> np.ndarray:
    """The reference's ``_random_affine_augmentation`` on HWC arrays."""
    rng = rng or np.random.default_rng()
    return warp_affine(a, draw_affine_matrix(rng, sigma))


def warp_affine(a: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.warpAffine(a, m, (w, h))`` default semantics (bilinear, zero
    border, ``m`` inverted internally) through ``scipy.ndimage``.

    ``mode='grid-constant'`` blends a tap that falls outside the image
    with the zero border, as cv2 does; scipy's default ``'constant'``
    zeroes every output pixel whose bilinear footprint crosses the edge."""
    from scipy import ndimage

    full = np.eye(3, dtype=np.float32)
    full[:2] = m[[1, 0]][:, [1, 0, 2]]  # swap x/y convention
    inv = np.linalg.inv(full)
    out = np.stack(
        [
            ndimage.affine_transform(
                a[..., c], inv[:2, :2], offset=inv[:2, 2], order=1,
                mode="grid-constant",
            )
            for c in range(a.shape[-1])
        ],
        axis=-1,
    )
    return out.astype(np.float32)


def gaussian_blur(a: np.ndarray, sigma: float = 0.1) -> np.ndarray:
    """The reference's ``_gaussian_blur``: ``ksize = int(sigma + 0.5)·8 + 1``,
    which is 1 at the default sigma, i.e. deliberately a no-op there."""
    ksize = int(sigma + 0.5) * 8 + 1
    if ksize <= 1:
        return a
    from scipy import ndimage

    out = np.stack(
        [ndimage.gaussian_filter(a[..., c], sigma) for c in range(a.shape[-1])],
        axis=-1,
    )
    return out.astype(np.float32)


class FusedToArrayNormalize:
    """``ToArray() → Normalize(mean, std)`` as one native pass over a
    uint8 HWC image (``native.normalize_from_u8``); any other input takes
    the two numpy steps."""

    def __init__(self, mean: Sequence[float], std: Sequence[float]):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._unfused = Compose([ToArray(), Normalize(mean, std)])

    def __call__(self, img) -> np.ndarray:
        a = np.asarray(img)
        if native.takes(a):
            return native.normalize_from_u8(a, self.mean, self.std)
        return self._unfused(a)


class FusedAffineBlurNormalize:
    """The augmented view's tail ``ToArray → random_affine → gaussian_blur
    → Normalize``, as one native pass (``warp_affine_normalize_from_u8``)
    for a uint8 HWC image when the blur is its reference-default no-op
    (``ksize = int(sigma+0.5)*8+1 <= 1``); otherwise the unfused chain.
    The affine matrix is drawn first either way, with the same rng calls
    as :func:`random_affine`."""

    def __init__(
        self,
        mean: Sequence[float],
        std: Sequence[float],
        affine_sigma: float = 0.1,
        blur_sigma: float = 0.1,
        rng=None,
    ):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.affine_sigma = affine_sigma
        self.blur_sigma = blur_sigma
        self.rng = rng or np.random.default_rng()
        self.normalize = Normalize(mean, std)
        self.to_array = ToArray()

    def __call__(self, img) -> np.ndarray:
        a = np.asarray(img)
        m = draw_affine_matrix(self.rng, self.affine_sigma)
        blur_is_noop = int(self.blur_sigma + 0.5) * 8 + 1 <= 1
        if blur_is_noop and native.takes(a):
            return native.warp_affine_normalize_from_u8(a, m, self.mean, self.std)
        x = warp_affine(self.to_array(a), m)
        return self.normalize(gaussian_blur(x, self.blur_sigma))
