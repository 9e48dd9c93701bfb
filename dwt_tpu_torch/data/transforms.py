"""The target view's augmentation math — the scipy paths of ``dwt_tpu.data.transforms``, copied.

The OfficeHome target-view augmentation perturbs each image with a
random affine warp and a (near-no-op) gaussian blur
(``resnet50_dwt_mec_officehome.py:481-492``).  The JAX package uses
``cv2`` where it is installed; the port takes the scipy fallbacks, which
compute the same warps (bilinear, zero border).  Arrays are HWC float32.
"""

from __future__ import annotations

import numpy as np


def draw_affine_matrix(
    rng: np.random.Generator, sigma: float = 0.1
) -> np.ndarray:
    """The reference's random 2x3 matrix: identity with N(0, sigma)
    perturbations, zero translation."""
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
    border, ``m`` inverted internally) through ``scipy.ndimage``."""
    from scipy import ndimage

    full = np.eye(3, dtype=np.float32)
    full[:2] = m[[1, 0]][:, [1, 0, 2]]  # swap x/y convention
    inv = np.linalg.inv(full)
    out = np.stack(
        [
            ndimage.affine_transform(
                a[..., c], inv[:2, :2], offset=inv[:2, 2], order=1
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
