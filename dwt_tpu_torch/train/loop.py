"""The OfficeHome training loop — the core of ``dwt_tpu.train.loop.run_officehome``.

Train ResNet-DWT with MEC: seeded source and target streams (the target
carrying its augmented view), ``num_iters`` steps, an eval every
``check_acc_step``, then the post-training protocol — ``
stat_collection_passes`` gradient-free train-mode passes over the target
test set, and the final eval.  Returns the final target accuracy (%).

The trainer runs on CUDA unless the config asks for the CPU, and raises
when CUDA is absent rather than choosing the CPU itself.  It turns TF32
off for cuDNN convolutions and cuBLAS matmuls, process-wide: the JAX
reference's f32 train step is full f32.  The loop reads values back to
the host only at its log interval and once per eval pass.

Only the ``--synthetic`` data is ported.  Checkpoints, the divergence
guard, metric harvesting, the watchdog, the data plane and multi-host
runs are not ported yet (ROADMAP).
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

from dwt_tpu_torch.config import OfficeHomeConfig
from dwt_tpu_torch.data.datasets import ArrayDataset
from dwt_tpu_torch.data.loader import batch_iterator
from dwt_tpu_torch.data.transforms import gaussian_blur, random_affine
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.serve.engine import resolve_device
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_officehome_train_step

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
