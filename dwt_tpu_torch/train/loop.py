"""The two training loops — the cores of ``dwt_tpu.train.loop.run_digits`` and ``run_officehome``.

* :func:`run_digits` trains LeNet-DWT with the entropy loss and Adam:
  seeded source and target streams zipped into epochs, a ``train`` record
  every ``log_interval`` steps of an epoch and a ``test`` record after
  each epoch.  Data: ``--synthetic``, or the USPS pickle and the MNIST
  files under ``data_root`` (there is no download path).
* :func:`run_officehome` trains ResNet-DWT with MEC: seeded source and
  target streams (the target carrying its augmented view), ``num_iters``
  steps, an eval every ``check_acc_step``, then the post-training
  protocol — ``stat_collection_passes`` gradient-free train-mode passes
  over the target test set, and the final eval.  Only its
  ``--synthetic`` data is ported.

Both return the final target accuracy (%).  A trainer runs on CUDA unless
the config asks for the CPU, and raises when CUDA is absent rather than
choosing the CPU itself.  It turns TF32 off for cuDNN convolutions and
cuBLAS matmuls, process-wide: the JAX reference's f32 train step is full
f32.  The loops read values back to the host only at their log interval
and once per eval pass.

Not ported yet, in either loop (ROADMAP): checkpoints and resume, the
divergence guard, metric harvesting, the watchdog, preemption, the data
plane and prefetch, scanned dispatch, bf16 compute and multi-host runs.
"""

from __future__ import annotations

import itertools
import json
import logging
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.data.datasets import ArrayDataset, load_mnist, load_usps
from dwt_tpu_torch.data.loader import batch_iterator
from dwt_tpu_torch.data.transforms import gaussian_blur, random_affine
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.serve.engine import resolve_device
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_digits_train_step, make_officehome_train_step

log = logging.getLogger(__name__)

# ``logger(kind, step, **fields)`` receives every record of a run.
Logger = Callable[..., None]


def _log_record(kind: str, step: int, **fields) -> None:
    log.info(json.dumps({"kind": kind, "step": step, **fields}))


def _synthetic_classification_arrays(
    n: int, shape: Tuple[int, ...], num_classes: int, seed: int, shift: float = 0.0
):
    """Class-structured random images: class k brightens a k-dependent
    stripe, so a real signal exists for the loss to learn.  Numpy only:
    the arrays equal the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(n,))
    images = rng.normal(scale=0.3, size=(n,) + shape).astype(np.float32) + shift
    rows = shape[0]
    band = max(rows // (2 * num_classes), 1)
    for i, k in enumerate(labels):
        r = (k * rows) // num_classes
        images[i, r : r + band, :, :] += 1.5
    return images, labels.astype(np.int64)


def _digits_datasets(cfg: DigitsConfig):
    """``(source train, target train, target test)`` datasets."""
    if cfg.synthetic:
        n = cfg.synthetic_size
        shape = (28, 28, 1)
        src = _synthetic_classification_arrays(n, shape, 10, cfg.seed)
        tgt = _synthetic_classification_arrays(n, shape, 10, cfg.seed + 1, 0.5)
        tgt_test = _synthetic_classification_arrays(
            n // 2, shape, 10, cfg.seed + 2, 0.5
        )
        return ArrayDataset(*src), ArrayDataset(*tgt), ArrayDataset(*tgt_test)

    # Normalizations per the reference loaders (usps_mnist.py:356-388):
    # MNIST (0.1307, 0.3081); USPS (0.5, 0.5).
    def load(name: str, train: bool) -> ArrayDataset:
        if name == "mnist":
            x, y = load_mnist(f"{cfg.data_root}/mnist", train=train)
            x = (x - 0.1307) / 0.3081
        elif name == "usps":
            x, y = load_usps(f"{cfg.data_root}/usps", train=train, seed=cfg.seed)
            x = (x - 0.5) / 0.5
        else:
            raise ValueError(f"unknown digits dataset {name!r}")
        return ArrayDataset(x.astype(np.float32), y)

    return load(cfg.source, True), load(cfg.target, True), load(cfg.target, False)


def build_digits_model(cfg: DigitsConfig) -> nn.Module:
    """The config's LeNet-DWT, freshly initialized from ``cfg.seed``."""
    return build_lenet(group_size=cfg.group_size, seed=cfg.seed,
                       momentum=cfg.running_momentum)


def run_digits(
    cfg: DigitsConfig,
    logger: Optional[Logger] = None,
    model: Optional[nn.Module] = None,
) -> float:
    """Train LeNet-DWT with the entropy loss; returns the target test
    accuracy (%) after the last epoch.

    ``model`` (default :func:`build_digits_model`) is trained in place: it
    is moved to the device, its convs to channels_last memory format."""
    logger = logger or _log_record
    if cfg.group_size == 32:
        # The reference's argparse default (usps_mnist.py:348), kept; every
        # published digits accuracy uses 4 (its README), and 32 does not
        # divide the 48 channels of conv2's site.
        logger("warning", 0,
               message="group_size=32 is the reference's argparse default, "
                       "but all published digits results use --group_size 4")
    if cfg.source == cfg.target:
        raise ValueError("source and target datasets can not be the same")
    if cfg.source_batch_size != cfg.target_batch_size:
        raise ValueError(
            "domain-split training needs equal source/target batch sizes")
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    source_ds, target_ds, test_ds = _digits_datasets(cfg)
    bs = cfg.source_batch_size
    steps_per_epoch = min(len(source_ds), len(target_ds)) // bs
    if steps_per_epoch == 0:
        raise ValueError("datasets smaller than one batch")
    if model is None:
        model = build_digits_model(cfg)
    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = digits_tx(model, cfg, steps_per_epoch)
    state = TrainState(model, optimizer, schedules)
    train_step = make_digits_train_step(model, cfg.lambda_entropy_loss)
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=2)

    acc = 0.0
    for epoch in range(cfg.epochs):
        # Both streams shuffle anew each epoch, from their own seeds; the
        # zip ends with the shorter one.
        source = batch_iterator(source_ds, bs, seed=cfg.seed, epoch=epoch)
        target = batch_iterator(target_ds, bs, seed=cfg.seed + 1, epoch=epoch)
        for i, ((sx, sy), (tx_img, _)) in enumerate(zip(source, target)):
            batch = {
                "source_x": _stage(np.asarray(sx, np.float32), device),
                "source_y": _stage(np.asarray(sy, np.int64), device),
                "target_x": _stage(np.asarray(tx_img, np.float32), device),
            }
            metrics = train_step(state, batch)
            if i % cfg.log_interval == 0:
                keys = ("loss", "cls_loss", "entropy_loss", "grad_norm")
                values = torch.stack([metrics[k].double() for k in keys]).tolist()
                logger("train", state.step, epoch=epoch, **dict(zip(keys, values)))
        result = evalp.evaluate(state, test_ds)
        acc = result["accuracy"]
        logger("test", state.step, epoch=epoch, **result)
    return acc


def _officehome_datasets(cfg: OfficeHomeConfig):
    """``(source, target with its augmented view, test)`` datasets."""
    if not cfg.synthetic:
        raise NotImplementedError(
            "only --synthetic data is ported; the OfficeHome image folders "
            "(ImageFolder, resize/crop/normalize) are ROADMAP queue 1, item 4"
        )
    n = cfg.synthetic_size
    shape = (cfg.img_crop_size, cfg.img_crop_size, 3)
    src = _synthetic_classification_arrays(n, shape, cfg.num_classes, cfg.seed)
    tgt_x, tgt_y = _synthetic_classification_arrays(
        n, shape, cfg.num_classes, cfg.seed + 1, 0.5
    )
    # One generator, drawn in load order: the loader is sequential, so
    # the augmented views are a function of the seed.
    rng = np.random.default_rng(cfg.seed + 9)
    aug = lambda a: gaussian_blur(random_affine(a, rng=rng))
    source_ds = ArrayDataset(*src)
    target_ds = ArrayDataset(tgt_x, tgt_y, transform_aug=aug)
    test_ds = ArrayDataset(
        *_synthetic_classification_arrays(
            n // 2, shape, cfg.num_classes, cfg.seed + 2, 0.5
        )
    )
    return source_ds, target_ds, test_ds


def _stream(dataset, batch_size: int, seed: int) -> Iterator[tuple]:
    """Endless shuffled batches, a new order every epoch."""
    if len(dataset) < batch_size:
        raise ValueError("datasets smaller than one batch")
    for epoch in itertools.count():
        yield from batch_iterator(dataset, batch_size, shuffle=True,
                                  drop_last=True, seed=seed, epoch=epoch)


def _stage(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def build_model(cfg: OfficeHomeConfig) -> nn.Module:
    """The config's ResNet-DWT, freshly initialized from ``cfg.seed``."""
    return build_resnet(
        cfg.arch, num_classes=cfg.num_classes, group_size=cfg.group_size,
        seed=cfg.seed, momentum=cfg.running_momentum,
    )


def run_officehome(
    cfg: OfficeHomeConfig,
    logger: Optional[Logger] = None,
    model: Optional[nn.Module] = None,
) -> float:
    """Train ResNet-DWT with MEC; returns the final target test accuracy (%).

    ``model`` (default :func:`build_model`) is trained in place: it is
    moved to the device, its convs to channels_last memory format."""
    logger = logger or _log_record
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    source_ds, target_ds, test_ds = _officehome_datasets(cfg)
    bs = cfg.source_batch_size  # the target stream uses the source's too
    if model is None:
        model = build_model(cfg)
    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    train_step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=3)

    source = _stream(source_ds, bs, cfg.seed)
    target = _stream(target_ds, bs, cfg.seed + 1)
    acc = 0.0
    for it in range(cfg.num_iters):
        sx, sy = next(source)
        tx_img, tx_aug, _ = next(target)
        batch = {
            "source_x": _stage(np.asarray(sx, np.float32), device),
            "source_y": _stage(np.asarray(sy, np.int64), device),
            "target_x": _stage(np.asarray(tx_img, np.float32), device),
            "target_aug_x": _stage(np.asarray(tx_aug, np.float32), device),
        }
        metrics = train_step(state, batch)
        if it % cfg.log_interval == 0:
            values = torch.stack([metrics[k].double() for k in (
                "loss", "cls_loss", "mec_loss", "grad_norm")]).tolist()
            logger("train", state.step, iter=it, **dict(zip(
                ("loss", "cls_loss", "mec_loss", "grad_norm"), values)))
        if (it + 1) % cfg.check_acc_step == 0:
            result = evalp.evaluate(state, test_ds)
            acc = result["accuracy"]
            logger("test", state.step, iter=it, **result)

    # Post-training protocol: passes over the target TEST set with the
    # batch tiled into every domain slot re-estimate the target stats
    # (resnet50…py:380-389).
    for p in range(cfg.stat_collection_passes):
        t0 = time.perf_counter()
        forwards = evalp.collect_stats(state, test_ds)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logger("stat_collection", state.step, pass_index=p, forwards=forwards,
               seconds=round(time.perf_counter() - t0, 3))
    result = evalp.evaluate(state, test_ds)
    acc = result["accuracy"]
    logger("final_test", state.step, **result)
    return acc
