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
  over the target test set, and the final eval.  Data: ``--synthetic``,
  or the two image folders ``s_dset_path`` and ``t_dset_path``.

Both return the final target accuracy (%).  A trainer runs on CUDA unless
the config asks for the CPU, and raises when CUDA is absent rather than
choosing the CPU itself.  It turns TF32 off for cuDNN convolutions and
cuBLAS matmuls, process-wide: the JAX reference's f32 train step is full
f32.  The loops read values back to the host only at their log interval
and once per eval pass.

Both loops read their streams through a ``DataPlane`` registered as the
JAX loops register theirs, so they train on the JAX package's batches,
item for item, and take them through ``prefetch_to_device``.

With ``ckpt_dir``, both loops save and resume as the JAX loops do
(``dwt_tpu_torch.utils.checkpoint``): a save after each
``ckpt_every_epochs``-th epoch and the last (digits) or every
``ckpt_every_iters`` steps (OfficeHome), an anchor every
``anchor_every`` into ``anchors/``, ``keep_ckpts`` pruning the main
directory only; OfficeHome also keeps the best-accuracy state in
``best_gr_{group_size}/`` with ``best.json``, and saves the
post-collection state last, the run's deployable artifact.  A run whose
``ckpt_dir`` holds a valid checkpoint (main or anchors) resumes from the
newest, its data plane at the manifest's ``data_state``, and continues
with the batches, draws and learning rates of the uninterrupted run.
Every save logs a ``checkpoint`` record (its seconds and bytes), a
resume a ``resume`` record.  Quarantined items are recorded in
``ckpt_dir/quarantine.json`` and skipped on resume.  OfficeHome starts,
when it does not resume, from ``init_ckpt`` (its step reset to 0), else
from the reference checkpoint at ``resnet_path`` (not with
``synthetic``), else from fresh weights.

Not ported yet, in either loop (ROADMAP): the background checkpoint
writer and the delta format (queue 1 item 3), the divergence guard,
metric harvesting, the watchdog, preemption (item 4), scanned dispatch,
bf16 compute and multi-host runs.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dwt_tpu_torch.config import DigitsConfig, OfficeHomeConfig
from dwt_tpu_torch.data.datasets import (
    ArrayDataset,
    ImageFolderDataset,
    load_mnist,
    load_usps,
)
from dwt_tpu_torch.convert import convert_resnet_state_dict, load_pytorch_checkpoint
from dwt_tpu_torch.data.loader import QuarantineRegistry, prefetch_to_device
from dwt_tpu_torch.data.pipeline import DataPlane
from dwt_tpu_torch.data.sampler import epoch_batch_count
from dwt_tpu_torch.data.transforms import (
    Compose,
    FusedAffineBlurNormalize,
    FusedToArrayNormalize,
    RandomCrop,
    RandomHorizontalFlip,
    Resize,
    ThreadLocalRng,
    gaussian_blur,
    random_affine,
)
from dwt_tpu_torch.nn.lenet import build_lenet
from dwt_tpu_torch.nn.resnet import build_resnet
from dwt_tpu_torch.serve.engine import resolve_device
from dwt_tpu_torch.train.evalpipe import EvalPipeline
from dwt_tpu_torch.train.optim import digits_tx, officehome_tx
from dwt_tpu_torch.train.state import TrainState
from dwt_tpu_torch.train.steps import make_digits_train_step, make_officehome_train_step
from dwt_tpu_torch.utils.checkpoint import (
    STATE_FILE,
    Restored,
    anchor_dir,
    load_data_state,
    params_digest,
    ranked_checkpoints,
    restore_newest,
    restore_state,
    save_state,
)

log = logging.getLogger(__name__)

# ``logger(kind, step, **fields)`` receives every record of a run.
Logger = Callable[..., None]


def _log_record(kind: str, step: int, **fields) -> None:
    log.info(json.dumps({"kind": kind, "step": step, **fields}))


def _keep_kwargs(cfg) -> dict:
    """``save_state`` kwargs of main-directory saves: ``keep_ckpts``
    prunes there only — anchors and best_* never get a ``keep``."""
    return {"keep": cfg.keep_ckpts} if cfg.keep_ckpts > 0 else {}


def _save(logger: Logger, ckpt_dir: str, state: TrainState, **kwargs
          ) -> Optional[str]:
    """``save_state`` at ``state.step``, logged as a ``checkpoint`` record
    (the save's wall seconds, device-to-host copy and fsync included,
    and the bytes of its state file) when it wrote an artifact."""
    t0 = time.perf_counter()
    path = save_state(ckpt_dir, state.step, state, **kwargs)
    if path is not None:
        logger("checkpoint", state.step, dir=ckpt_dir,
               seconds=time.perf_counter() - t0,
               bytes=os.path.getsize(os.path.join(path, STATE_FILE)))
    return path


def _resume(cfg, state: TrainState, plane: DataPlane, ranked,
            fallback_epoch) -> Tuple[Restored, str, float]:
    """Restore the newest valid checkpoint of ``cfg.ckpt_dir`` (main or
    anchors) into ``state`` and re-open the data plane where the saved
    run stood: at the manifest's ``data_state`` (``"exact"``), else at the
    epoch boundary ``fallback_epoch(step)``, logged as a downgrade.
    Returns the restore, the data mode and the restore's seconds."""
    t0 = time.perf_counter()
    restored = restore_newest(cfg.ckpt_dir, state, ranked)
    seconds = time.perf_counter() - t0
    if plane.load_snapshot(load_data_state(restored.path)):
        return restored, "exact", seconds
    plane.seek_epoch(fallback_epoch(state.step))
    log.warning(
        "checkpoint %s has no usable data_state: resuming the data streams "
        "at the epoch boundary; the position within the epoch is lost",
        restored.path)
    return restored, "epoch_boundary", seconds


def _quarantine_registry(cfg) -> Optional[QuarantineRegistry]:
    """The run's quarantine record under ``ckpt_dir``; None keeps it in
    memory."""
    return QuarantineRegistry.for_ckpt_dir(cfg.ckpt_dir) if cfg.ckpt_dir else None


def _best_record_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "best.json")


def _write_best_record(ckpt_dir: str, accuracy: float, step: int) -> None:
    """Persist the best accuracy, so a resumed run cannot regress the
    best-accuracy artifact by restarting its comparison from -1."""
    path = _best_record_path(ckpt_dir)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"accuracy": accuracy, "step": step}, f)
    os.replace(tmp, path)


def _read_best_record(ckpt_dir: str) -> float:
    try:
        with open(_best_record_path(ckpt_dir)) as f:
            return float(json.load(f)["accuracy"])
    except (OSError, ValueError, TypeError, KeyError):
        return -1.0


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
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=2,
                         num_workers=cfg.num_workers)
    # Both streams roll over at the zip's length, so a stream's position
    # is a function of the step.
    plane = DataPlane(num_workers=cfg.num_workers,
                      quarantine_registry=_quarantine_registry(cfg))
    plane.register("source", seed=cfg.seed, epoch_len=steps_per_epoch)
    plane.register("target", seed=cfg.seed + 1, epoch_len=steps_per_epoch)

    start_epoch = 0
    ranked = ranked_checkpoints(cfg.ckpt_dir) if cfg.ckpt_dir else []
    if ranked:
        restored, data_mode, seconds = _resume(
            cfg, state, plane, ranked, lambda step: step // steps_per_epoch)
        start_epoch = plane.streams["source"].epoch
        logger("resume", state.step, epoch=start_epoch, source=restored.source,
               data=data_mode, cursor=plane.streams["source"].cursor,
               restore_s=seconds)
    if start_epoch >= cfg.epochs:
        # Resumed from a finished run: report the restored model's
        # accuracy instead of training.
        result = evalp.evaluate(state, test_ds)
        logger("test", state.step, epoch=start_epoch, **result)
        logger("params_digest", state.step,
               digest=params_digest(model.named_parameters()))
        return result["accuracy"]

    acc = 0.0
    for epoch in range(start_epoch, cfg.epochs):
        # Each stream opens at the plane's position and shuffles anew each
        # epoch, from its own seed; the zip ends with the shorter one.
        source = plane.epoch_iterator(source_ds, "source", bs)
        target = plane.epoch_iterator(target_ds, "target", bs)
        batches = prefetch_to_device(({
            "source_x": np.asarray(sx, np.float32),
            "source_y": np.asarray(sy, np.int64),
            "target_x": np.asarray(tx_img, np.float32),
        } for (sx, sy), (tx_img, _) in zip(source, target)), device=device)
        try:
            for i, batch in enumerate(batches):
                metrics = train_step(state, batch)
                plane.advance(1)
                if i % cfg.log_interval == 0:
                    keys = ("loss", "cls_loss", "entropy_loss", "grad_norm")
                    values = torch.stack([metrics[k].double() for k in keys]).tolist()
                    logger("train", state.step, epoch=epoch, **dict(zip(keys, values)))
        finally:
            batches.close()
            source.close()
            target.close()
        result = evalp.evaluate(state, test_ds)
        acc = result["accuracy"]
        logger("test", state.step, epoch=epoch, **result)
        if cfg.ckpt_dir:
            data_state = plane.snapshot()
            if (epoch + 1) % cfg.ckpt_every_epochs == 0 or epoch == cfg.epochs - 1:
                _save(logger, cfg.ckpt_dir, state, data_state=data_state,
                      **_keep_kwargs(cfg))
            if cfg.anchor_every and (epoch + 1) % cfg.anchor_every == 0:
                _save(logger, anchor_dir(cfg.ckpt_dir), state,
                      data_state=data_state)
    if cfg.ckpt_dir:
        logger("params_digest", state.step,
               digest=params_digest(model.named_parameters()))
    return acc


def _officehome_datasets(cfg: OfficeHomeConfig):
    """``(source, target with its augmented view, test)`` datasets: the
    synthetic arrays, or the two image folders."""
    if cfg.synthetic:
        n = cfg.synthetic_size
        shape = (cfg.img_crop_size, cfg.img_crop_size, 3)
        src = _synthetic_classification_arrays(n, shape, cfg.num_classes, cfg.seed)
        tgt_x, tgt_y = _synthetic_classification_arrays(
            n, shape, cfg.num_classes, cfg.seed + 1, 0.5
        )
        rng = ThreadLocalRng(cfg.seed + 9)  # reseeded per item by the loader
        aug = lambda a: gaussian_blur(random_affine(a, rng=rng))
        source_ds = ArrayDataset(*src)
        target_ds = ArrayDataset(tgt_x, tgt_y, transform_aug=aug)
        test_ds = ArrayDataset(
            *_synthetic_classification_arrays(
                n // 2, shape, cfg.num_classes, cfg.seed + 2, 0.5
            )
        )
        return source_ds, target_ds, test_ds

    mean = [0.485, 0.456, 0.406]
    std = [0.229, 0.224, 0.225]
    rng = ThreadLocalRng(cfg.seed)
    # The source and test transform (resnet50…py:527-532) and the target's
    # augmented view (:535-543), each ending in one native pass over the
    # uint8 crop.
    base_tf = Compose([
        Resize(cfg.img_resize),
        RandomCrop(cfg.img_crop_size, rng=rng),
        FusedToArrayNormalize(mean, std),
    ])
    aug_tf = Compose([
        Resize(cfg.img_resize),
        RandomCrop(cfg.img_crop_size, rng=rng),
        RandomHorizontalFlip(rng=rng),
        FusedAffineBlurNormalize(mean, std, rng=rng),
    ])
    source_ds = ImageFolderDataset(cfg.s_dset_path, transform=base_tf)
    target_ds = ImageFolderDataset(
        cfg.t_dset_path, transform=base_tf, transform_aug=aug_tf
    )
    test_ds = ImageFolderDataset(cfg.t_dset_path, transform=base_tf)
    return source_ds, target_ds, test_ds


def officehome_batches(plane: DataPlane, source_ds, target_ds, batch_size: int,
                       steps: int):
    """``steps`` train batches of the three streams, from the plane's
    position: the target stream carries its augmented view."""
    source = plane.stream(source_ds, "source", batch_size)
    target = plane.stream(target_ds, "target", batch_size)
    try:
        for _ in range(steps):
            sx, sy = next(source)
            tx_img, tx_aug, _ = next(target)
            yield {
                "source_x": np.asarray(sx, np.float32),
                "source_y": np.asarray(sy, np.int64),
                "target_x": np.asarray(tx_img, np.float32),
                "target_aug_x": np.asarray(tx_aug, np.float32),
            }
    finally:
        source.close()
        target.close()


def officehome_plane(cfg: OfficeHomeConfig, source_ds, target_ds) -> DataPlane:
    """The run's data plane: the source at ``seed``, the target at
    ``seed + 1`` and its augmented view as an alias of the target, each
    rolling over at its own dataset's batch count; with ``ckpt_dir``,
    quarantined items are recorded there."""
    bs = cfg.source_batch_size  # the target stream uses the source's too
    source_len = epoch_batch_count(len(source_ds), bs)
    target_len = epoch_batch_count(len(target_ds), bs)
    if min(source_len, target_len) == 0:
        raise ValueError("datasets smaller than one batch")
    plane = DataPlane(num_workers=cfg.num_workers,
                      quarantine_registry=_quarantine_registry(cfg))
    plane.register("source", seed=cfg.seed, epoch_len=source_len)
    plane.register("target", seed=cfg.seed + 1, epoch_len=target_len)
    plane.register("target_aug", seed=cfg.seed + 1, epoch_len=target_len,
                   alias_of="target")
    return plane


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
    moved to the device, its convs to channels_last memory format, and
    a resume, ``init_ckpt`` or ``resnet_path`` loads into it."""
    logger = logger or _log_record
    device = resolve_device(cfg.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    source_ds, target_ds, test_ds = _officehome_datasets(cfg)
    plane = officehome_plane(cfg, source_ds, target_ds)
    if model is None:
        model = build_model(cfg)
    model.to(device, memory_format=torch.channels_last)
    optimizer, schedules = officehome_tx(model, cfg)
    state = TrainState(model, optimizer, schedules)
    train_step = make_officehome_train_step(model, cfg.lambda_mec_loss)
    evalp = EvalPipeline(cfg.test_batch_size, device, num_domains=3,
                         num_workers=cfg.num_workers)

    # The initial state: a resume beats init_ckpt, which beats the
    # reference checkpoint, which beats fresh init.
    ranked = ranked_checkpoints(cfg.ckpt_dir) if cfg.ckpt_dir else []
    if cfg.init_ckpt and not ranked:
        restore_state(cfg.init_ckpt, state)
        state.step = 0
        logger("init_ckpt", 0, detail=cfg.init_ckpt)
    elif cfg.resnet_path and not cfg.synthetic and not ranked:
        if os.path.exists(cfg.resnet_path):
            _, report = convert_resnet_state_dict(
                load_pytorch_checkpoint(cfg.resnet_path), model, num_domains=3)
            logger("checkpoint_convert", 0, detail=report.summary())
        else:
            logger("checkpoint_convert", 0,
                   detail="resnet_path missing; training from fresh init")
    start_iter, best_acc = 0, -1.0
    if ranked:
        restored, data_mode, seconds = _resume(cfg, state, plane, ranked,
                                               lambda step: 0)
        start_iter = state.step
        # Only a resume inherits the best record: a fresh run in a used
        # directory would otherwise never beat a dead run's best.
        best_acc = _read_best_record(cfg.ckpt_dir)
        logger("resume", start_iter, source=restored.source, data=data_mode,
               cursor=plane.streams["target"].cursor, restore_s=seconds)

    def save_targets(it):
        targets = []
        if cfg.ckpt_dir and (it + 1) % cfg.ckpt_every_iters == 0:
            targets.append((cfg.ckpt_dir, _keep_kwargs(cfg)))
        if cfg.ckpt_dir and cfg.anchor_every and (it + 1) % cfg.anchor_every == 0:
            targets.append((anchor_dir(cfg.ckpt_dir), {}))
        return targets

    acc = 0.0
    produce = officehome_batches(plane, source_ds, target_ds,
                                 cfg.source_batch_size, cfg.num_iters - start_iter)
    batches = prefetch_to_device(produce, device=device)
    try:
        for it, batch in enumerate(batches, start=start_iter):
            metrics = train_step(state, batch)
            # The plane's position is the next batch the loop trains on,
            # whatever the prefetch thread has built: what a save records.
            plane.advance(1)
            if it % cfg.log_interval == 0:
                values = torch.stack([metrics[k].double() for k in (
                    "loss", "cls_loss", "mec_loss", "grad_norm")]).tolist()
                logger("train", state.step, iter=it, **dict(zip(
                    ("loss", "cls_loss", "mec_loss", "grad_norm"), values)))
            if (it + 1) % cfg.check_acc_step == 0:
                result = evalp.evaluate(state, test_ds)
                acc = result["accuracy"]
                logger("test", state.step, iter=it, **result)
                if cfg.ckpt_dir and acc > best_acc:
                    # The reference's model_best_gr_N: the highest target
                    # accuracy's state.  best.json names only an artifact
                    # that was written (a refused, non-finite save is not).
                    best = _save(logger, os.path.join(
                        cfg.ckpt_dir, f"best_gr_{cfg.group_size}"), state,
                        keep=1, data_state=plane.snapshot())
                    if best is not None:
                        best_acc = acc
                        _write_best_record(cfg.ckpt_dir, acc, state.step)
                        logger("best", state.step, accuracy=acc)
            for directory, kwargs in save_targets(it):
                _save(logger, directory, state, data_state=plane.snapshot(),
                      **kwargs)
    finally:
        batches.close()
        produce.close()

    # Post-training protocol: passes over the target TEST set with the
    # batch tiled into every domain slot re-estimate the target stats
    # (resnet50…py:380-389).
    for p in range(cfg.stat_collection_passes):
        t0 = time.perf_counter()
        forwards = evalp.collect_stats(state, test_ds, seed=cfg.seed, epoch=p)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logger("stat_collection", state.step, pass_index=p, forwards=forwards,
               seconds=round(time.perf_counter() - t0, 3))
    result = evalp.evaluate(state, test_ds)
    acc = result["accuracy"]
    logger("final_test", state.step, **result)
    if cfg.ckpt_dir:
        # The post-collection state is the run's deployable artifact.
        logger("params_digest", state.step,
               digest=params_digest(model.named_parameters()))
        _save(logger, cfg.ckpt_dir, state, data_state=plane.snapshot(),
              **_keep_kwargs(cfg))
    return acc
