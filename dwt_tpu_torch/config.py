"""Typed configs of the two trainers — the ported subsets of ``dwt_tpu.config``'s ``DigitsConfig`` and ``OfficeHomeConfig``.

Every default is the JAX package's (which are the reference's); ``device``
is the port's own.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class DigitsConfig:
    """USPS↔MNIST experiment — reference ``usps_mnist.py:331-349``."""

    source: str = "usps"
    target: str = "mnist"
    source_batch_size: int = 32
    target_batch_size: int = 32
    test_batch_size: int = 100
    num_workers: int = 2  # item-loading worker threads (reference :332)
    epochs: int = 120
    lr: float = 1e-3
    weight_decay: float = 5e-4
    sgd_momentum: float = 0.5  # dead in the reference (Adam is used, :389)
    running_momentum: float = 0.1
    lambda_entropy_loss: float = 0.1
    log_interval: int = 100
    seed: int = 1
    group_size: int = 32  # the reference's argparse default; its README uses 4
    lr_milestones: Tuple[int, ...] = (50, 80)  # epochs; MultiStepLR γ=0.1
    lr_gamma: float = 0.1
    data_root: str = "../data"
    synthetic: bool = False
    synthetic_size: int = 256
    device: str = "cuda"  # "cpu" only when asked for


@dataclasses.dataclass
class OfficeHomeConfig:
    """OfficeHome experiment — reference ``resnet50…py:498-519``."""

    source_batch_size: int = 18
    test_batch_size: int = 10
    num_workers: int = 2  # item-loading worker threads (reference :499)
    s_dset_path: str = "../data/OfficeHomeDataset_10072016/Art"
    t_dset_path: str = "../data/OfficeHomeDataset_10072016/Clipart"
    img_resize: int = 256
    img_crop_size: int = 224
    num_iters: int = 10_000
    check_acc_step: int = 100
    lr: float = 1e-2
    lr_milestones: Tuple[int, ...] = (6000,)
    lr_gamma: float = 0.1
    backbone_lr_scale: float = 0.1  # rest-of-net at lr*0.1 (:587-590)
    sgd_momentum: float = 0.9  # the one actually used (:590)
    weight_decay: float = 5e-4
    running_momentum: float = 0.1
    lambda_mec_loss: float = 0.1
    num_classes: int = 65
    group_size: int = 4
    log_interval: int = 10
    seed: int = 1
    stat_collection_passes: int = 10  # eval_pass_collect_stats (:384)
    arch: str = "resnet50"
    synthetic: bool = False
    synthetic_size: int = 64
    device: str = "cuda"  # "cpu" only when asked for
