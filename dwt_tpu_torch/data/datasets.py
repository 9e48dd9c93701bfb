"""In-memory dataset — ``ArrayDataset`` of ``dwt_tpu.data.datasets``, copied.

Items are ``(img, label)`` or — when a second ``transform_aug`` view is
configured — ``(img, img_aug, label)``, the reference's dual-view triple
protocol.  The USPS/MNIST loaders and the ImageFolder walker are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


class ArrayDataset:
    """In-memory dataset over (images, labels) with optional dual view."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        transform: Optional[Callable] = None,
        transform_aug: Optional[Callable] = None,
    ):
        if len(images) != len(labels):
            raise ValueError(
                f"{len(images)} images but {len(labels)} labels")
        self.images = images
        self.labels = labels
        self.transform = transform
        self.transform_aug = transform_aug

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int):
        img = self.images[i]
        label = int(self.labels[i])
        out = self.transform(img) if self.transform else img
        if self.transform_aug is not None:
            return out, self.transform_aug(img), label
        return out, label
