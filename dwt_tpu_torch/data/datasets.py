"""Datasets — the USPS and MNIST loaders, ``ArrayDataset`` and ``ImageFolderDataset`` of ``dwt_tpu.data.datasets``, copied.

Items are ``(img, label)`` or — when a second ``transform_aug`` view is
configured — ``(img, img_aug, label)``, the reference's dual-view triple
protocol.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)

# Training-set replication factor for USPS (reference
# ``usps_mnist.py:24``: usps_dataset_multiplier = 6).
USPS_MULTIPLIER = 6


def load_usps(
    root: str,
    train: bool = True,
    multiplier: int = USPS_MULTIPLIER,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load ``usps_28x28.pkl`` → (images ``[N,28,28,1]`` float32 [0,1], labels).

    The reference loader (``usps_mnist.py:106-120``): a gzip pickle of
    ``[[train_x, train_y], [test_x, test_y]]`` in NCHW; the training split
    is replicated ×6 and shuffled with a generator seeded by ``seed``
    (``:48-55``).  There is no download path: the file must exist.  Read
    only a file of this dataset: unpickling runs whatever the file says.
    """
    path = root if root.endswith(".pkl") else os.path.join(root, "usps_28x28.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"USPS pickle not found at {path}; place usps_28x28.pkl there "
            "(the reference downloads it from the CoGAN repo)"
        )
    with gzip.open(path, "rb") as f:
        dataset = pickle.load(f, encoding="bytes")
    images, labels = dataset[0 if train else 1]
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int64).reshape(-1)
    if train and multiplier > 1:
        n = labels.shape[0]
        images = np.repeat(images, multiplier, axis=0)
        labels = np.repeat(labels, multiplier, axis=0)
        idx = np.random.default_rng(seed).permutation(multiplier * n)
        images, labels = images[idx], labels[idx]
    return images.transpose(0, 2, 3, 1), labels  # NCHW → NHWC


def load_mnist(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Load MNIST → (images ``[N,28,28,1]`` float32 [0,1], labels).

    Reads the torchvision-processed ``processed/training.pt`` /
    ``test.pt`` that the reference consumes (``usps_mnist.py:139-153``;
    two uint8/int64 tensors, loaded with ``weights_only=True``) or the raw
    idx files (``train-images-idx3-ubyte`` etc.) in ``root``.  There is no
    download path.
    """
    name = "training.pt" if train else "test.pt"
    pt_path = os.path.join(root, "processed", name)
    if os.path.exists(pt_path):
        data, targets = torch.load(pt_path, weights_only=True)
        images = np.asarray(data.numpy(), np.float32) / 255.0
        labels = np.asarray(targets.numpy(), np.int64)
        return images[..., None], labels

    prefix = "train" if train else "t10k"
    img_path = os.path.join(root, f"{prefix}-images-idx3-ubyte")
    lbl_path = os.path.join(root, f"{prefix}-labels-idx1-ubyte")
    if not os.path.exists(img_path):
        raise FileNotFoundError(
            f"MNIST not found under {root} (neither processed/{name} nor "
            f"{prefix}-images-idx3-ubyte)"
        )
    with open(img_path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
    with open(lbl_path, "rb") as f:
        struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
    return images.astype(np.float32)[..., None] / 255.0, labels


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


def _find_classes(root: str) -> Tuple[List[str], dict]:
    classes = sorted(
        entry.name for entry in os.scandir(root) if entry.is_dir()
    )
    return classes, {c: i for i, c in enumerate(classes)}


def make_dataset(
    root: str, class_to_idx: dict, extensions: Sequence[str] = IMG_EXTENSIONS
) -> List[Tuple[str, int]]:
    """Sorted ``(path, class_index)`` walk — reference ``folder.py:40-55``."""
    samples = []
    root = os.path.expanduser(root)
    for cls in sorted(class_to_idx):
        d = os.path.join(root, cls)
        if not os.path.isdir(d):
            continue
        for sub, _, files in sorted(os.walk(d)):
            for name in sorted(files):
                if name.lower().endswith(tuple(extensions)):
                    samples.append((os.path.join(sub, name), class_to_idx[cls]))
    return samples


class ImageFolderDataset:
    """``root/class_x/*.jpg`` walker with the dual-view protocol.

    The reference's vendored folder dataset (``utils/folder.py:58-190``):
    sorted class discovery, a recursive sorted walk of the samples, an RGB
    PIL load, and the ``transform_aug`` second view that makes items
    ``(img, img_aug, label)`` triples (``:138-147``).
    """

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        transform_aug: Optional[Callable] = None,
        extensions: Sequence[str] = IMG_EXTENSIONS,
    ):
        classes, class_to_idx = _find_classes(root)
        samples = make_dataset(root, class_to_idx, extensions)
        if not samples:
            raise RuntimeError(
                f"Found 0 images in subfolders of {root} "
                f"(extensions: {','.join(extensions)})"
            )
        self.root = root
        self.classes = classes
        self.class_to_idx = class_to_idx
        self.samples = samples
        self.targets = [t for _, t in samples]
        self.transform = transform
        self.transform_aug = transform_aug

    def __len__(self) -> int:
        return len(self.samples)

    def _load(self, path: str):
        from PIL import Image

        with open(path, "rb") as f:
            return Image.open(f).convert("RGB")

    def __getitem__(self, i: int):
        path, label = self.samples[i]
        img = self._load(path)
        out = self.transform(img) if self.transform else img
        if self.transform_aug is not None:
            return out, self.transform_aug(img), label
        return out, label
