"""Typed configs of the two trainers — the ported subsets of ``dwt_tpu.config``'s ``DigitsConfig`` and ``OfficeHomeConfig``.

Every default is the JAX package's (which are the reference's); ``device``
is the port's own.  The divergence guard is the JAX package's at
``harvest_depth = 0`` (a synchronous readback every ``guard_interval``
steps); the harvested guard waits for ``train/harvest.py`` (ROADMAP
queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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
    ckpt_dir: Optional[str] = None
    ckpt_every_epochs: int = 10
    # >0: prune the MAIN ckpt_dir to the newest N steps after each save
    # (anchors are exempt).
    keep_ckpts: int = 0
    # >0: every N epochs also save an anchor under ckpt_dir/anchors,
    # never pruned.
    anchor_every: int = 0
    # Background checkpoint writer (resilience/async_ckpt.py); --no-async_ckpt
    # saves on the loop's thread.
    async_ckpt: bool = True
    # "full" (state.pt) or "delta" (the content-addressed store, ckpt/store.py).
    ckpt_format: str = "full"
    delta_max_chain: int = 8
    blob_store: Optional[str] = None  # a blob store shared across runs (no GC)
    # Divergence guard (resilience/guard.py): none | halt | skip_step | rollback.
    guard_policy: str = "none"
    guard_interval: int = 50
    guard_max_rollbacks: int = 3
    guard_lr_backoff: float = 0.0  # rung 1's lr factor in (0, 1); 0 = off
    guard_backoff_recovery: int = 3
    # >0: hang watchdog — no step-boundary heartbeat for this many seconds
    # dumps every thread's stack under ckpt_dir/watchdog/ and exits 113.
    watchdog_timeout: float = 0.0
    watchdog_keep: int = 5
    preempt_notice_file: Optional[str] = None  # notice = this file exists
    preempt_notice_metadata: bool = False  # poll the GCE preempted key
    device: str = "cuda"  # "cpu" only when asked for


@dataclasses.dataclass
class OfficeHomeConfig:
    """OfficeHome experiment — reference ``resnet50…py:498-519``."""

    source_batch_size: int = 18
    test_batch_size: int = 10
    num_workers: int = 2  # item-loading worker threads (reference :499)
    s_dset_path: str = "../data/OfficeHomeDataset_10072016/Art"
    t_dset_path: str = "../data/OfficeHomeDataset_10072016/Clipart"
    resnet_path: str = "../data/models/model_best_gr_4.pth.tar"
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
    init_ckpt: Optional[str] = None  # a port checkpoint dir (cli/convert.py)
    ckpt_dir: Optional[str] = None
    ckpt_every_iters: int = 1000
    keep_ckpts: int = 0  # as DigitsConfig.keep_ckpts
    anchor_every: int = 0  # as DigitsConfig.anchor_every, in iterations
    # Background checkpoint writer (resilience/async_ckpt.py); --no-async_ckpt
    # saves on the loop's thread.
    async_ckpt: bool = True
    # "full" (state.pt) or "delta" (the content-addressed store, ckpt/store.py).
    ckpt_format: str = "full"
    delta_max_chain: int = 8
    blob_store: Optional[str] = None  # a blob store shared across runs (no GC)
    # Divergence guard (resilience/guard.py): none | halt | skip_step | rollback.
    guard_policy: str = "none"
    guard_interval: int = 50
    guard_max_rollbacks: int = 3
    guard_lr_backoff: float = 0.0  # rung 1's lr factor in (0, 1); 0 = off
    guard_backoff_recovery: int = 3
    # >0: hang watchdog — no step-boundary heartbeat for this many seconds
    # dumps every thread's stack under ckpt_dir/watchdog/ and exits 113.
    watchdog_timeout: float = 0.0
    watchdog_keep: int = 5
    preempt_notice_file: Optional[str] = None  # notice = this file exists
    preempt_notice_metadata: bool = False  # poll the GCE preempted key
    device: str = "cuda"  # "cpu" only when asked for
