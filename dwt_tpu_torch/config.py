"""Typed configs of the two trainers — the ported subsets of ``dwt_tpu.config``'s ``DigitsConfig`` and ``OfficeHomeConfig``.

Every default is the JAX package's (which are the reference's); ``device``
is the port's own.  ``steps_per_dispatch`` and ``eval_steps_per_dispatch``
are the train and eval batches per dispatch (on the card at k ≥ 2, replays
of a captured CUDA graph); ``harvest_depth`` the ring of
``train/harvest.py`` (0: a synchronous readback per record, and the
divergence guard's own readback every ``guard_interval`` steps; above 0 the
guard reads the harvested finite flags).  ``whitener``, ``compute_dtype``
(``bf16`` its legacy alias, :func:`resolve_compute_dtype`) and
OfficeHome's ``remat`` are the JAX configs' numerics knobs; OfficeHome's
``backbone`` (a registry name that wins over ``arch``) and
``pad_classes_to`` its model knobs.  The run plane's knobs are the JAX
configs': ``obs_trace`` (span tracing's Chrome-trace path),
``heartbeat_every`` (a ``heartbeat`` record every N steps),
``metrics_port`` (the ``/metrics`` exporter) and ``alert_rules`` (the
rules the step boundary evaluates), ``data_stall_timeout`` (the loader
pools' stall budget).  ``data_parallel``, ``distributed``,
``dcn_slices``, ``mesh_shape`` and ``sharding_rules`` are the JAX
configs' parallel knobs (``dwt_tpu_torch.parallel``).  ``pallas_whiten`` and ``apply_lowering`` select JAX
lowerings and OfficeHome's ``target_batch_size`` and ``lr_change_step``
are dead in the reference: the port accepts them and logs that they
change nothing (``INERT_FIELDS``).
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
    # Loader pools' head-of-window stall budget, seconds: a worker silent
    # past it is logged and its item re-submitted to a fresh thread; 0 off.
    data_stall_timeout: float = 60.0
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
    # Dispatch and harvesting: train steps per dispatch (k ≥ 2 on the card:
    # replays of one captured step), eval and collection batches per
    # dispatch, the metric harvest ring's depth (0: synchronous readback).
    steps_per_dispatch: int = 1
    eval_steps_per_dispatch: int = 8
    harvest_depth: int = 2
    # Whitening numerics backend: cholesky (the reference), newton_schulz
    # (fixed-K iteration of batched matmuls), swbn (online whitening-matrix
    # tracking).
    whitener: str = "cholesky"
    bf16: bool = False  # legacy alias for compute_dtype="bf16"
    # "f32" | "bf16": params, optimizer state and running stats stay f32;
    # bf16 runs activations, backprop traffic and the whitening apply in
    # bf16, each whitener factorizing in its precision policy's dtype.
    compute_dtype: str = "f32"
    # The JAX package's lowering switches (the Pallas kernels, the apply's
    # matmul lowering): accepted, inert in the port.
    pallas_whiten: bool = False
    apply_lowering: str = "auto"
    # Span tracing (dwt_tpu_torch.obs): write the run's spans as a Chrome
    # trace-event JSON to this path (tools/torch_obs_report.py reads it).
    # None = off unless DWT_OBS_TRACE is set; disabled spans are near-free.
    obs_trace: Optional[str] = None
    # The run plane: a heartbeat record every N steps (0 off), the /metrics
    # exporter's port (0 = ephemeral, None = off), SLO alert rules (JSON).
    heartbeat_every: int = 100
    metrics_port: Optional[int] = None
    alert_rules: Optional[str] = None
    # Data parallelism (dwt_tpu_torch.parallel): one process per rank over
    # torch.distributed (--distributed joins the group from the DWT_* or
    # torchrun variables); --data_parallel runs the replica step over every
    # rank; --dcn_slices S > 1 the 2-D (dcn, data) rank grid; --mesh_shape
    # "dcn,data[,model]" sizes; --sharding_rules "dp" (replicate the state),
    # or "model", "fsdp" or a JSON rules file: the gspmd mode, each state
    # tensor placed by its rule over the (dcn, data, model) rank mesh.
    data_parallel: bool = False
    distributed: bool = False
    dcn_slices: int = 0
    mesh_shape: Optional[str] = None
    sharding_rules: str = "dp"
    device: str = "cuda"  # "cpu" only when asked for


@dataclasses.dataclass
class OfficeHomeConfig:
    """OfficeHome experiment — reference ``resnet50…py:498-519``."""

    source_batch_size: int = 18
    target_batch_size: int = 18  # dead in the reference (its loader uses source's)
    test_batch_size: int = 10
    num_workers: int = 2  # item-loading worker threads (reference :499)
    data_stall_timeout: float = 60.0  # as DigitsConfig.data_stall_timeout
    s_dset_path: str = "../data/OfficeHomeDataset_10072016/Art"
    t_dset_path: str = "../data/OfficeHomeDataset_10072016/Clipart"
    resnet_path: str = "../data/models/model_best_gr_4.pth.tar"
    img_resize: int = 256
    img_crop_size: int = 224
    num_iters: int = 10_000
    check_acc_step: int = 100
    lr_change_step: int = 1000  # dead in the reference (milestone at 6000)
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
    arch: str = "resnet50"  # or "resnet101" (VisDA), "tiny"
    # Backbone-registry name (dwt_tpu_torch.nn.registry.BACKBONES): when
    # set, wins over arch.
    backbone: Optional[str] = None
    # >1: the fc_out head's out dim padded up to a multiple of this; the
    # padded logit columns are sliced off inside the forward, so losses
    # and counters are those of the unpadded head.
    pad_classes_to: int = 0
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
    # Dispatch and harvesting: train steps per dispatch (k ≥ 2 on the card:
    # replays of one captured step), eval and collection batches per
    # dispatch, the metric harvest ring's depth (0: synchronous readback).
    steps_per_dispatch: int = 1
    eval_steps_per_dispatch: int = 8
    harvest_depth: int = 2
    # Whitening backend — see DigitsConfig.whitener; "swbn" also makes
    # --stat_collection_passes 0 the intended cadence.
    whitener: str = "cholesky"
    bf16: bool = False
    compute_dtype: str = "f32"  # see DigitsConfig.compute_dtype
    remat: bool = False  # recompute each bottleneck in the backward
    pallas_whiten: bool = False  # as DigitsConfig.pallas_whiten (inert)
    apply_lowering: str = "auto"  # as DigitsConfig.apply_lowering (inert)
    obs_trace: Optional[str] = None  # as DigitsConfig: span tracing
    heartbeat_every: int = 100  # as DigitsConfig: the run plane
    metrics_port: Optional[int] = None
    alert_rules: Optional[str] = None
    # Data parallelism (dwt_tpu_torch.parallel): one process per rank over
    # torch.distributed (--distributed joins the group from the DWT_* or
    # torchrun variables); --data_parallel runs the replica step over every
    # rank; --dcn_slices S > 1 the 2-D (dcn, data) rank grid; --mesh_shape
    # "dcn,data[,model]" sizes; --sharding_rules "dp" (replicate the state),
    # or "model", "fsdp" or a JSON rules file: the gspmd mode, each state
    # tensor placed by its rule over the (dcn, data, model) rank mesh.
    data_parallel: bool = False
    distributed: bool = False
    dcn_slices: int = 0
    mesh_shape: Optional[str] = None
    sharding_rules: str = "dp"
    device: str = "cuda"  # "cpu" only when asked for


# Fields accepted for the JAX CLIs' sake that change nothing in the port:
# the name and why, per config class.
INERT_FIELDS = {
    "pallas_whiten": "selects the JAX package's Pallas whitening kernels; the "
                     "port always runs its CUDA kernels",
    "apply_lowering": "selects the JAX apply's matmul lowering; the port's "
                      "apply is one hand-written kernel",
    "target_batch_size": "dead in the reference: the target loader uses "
                         "--source_batch_size",
    "lr_change_step": "dead in the reference: the lr milestone is "
                      "--lr_milestones",
}


COMPUTE_DTYPES = ("f32", "bf16")


def resolve_compute_dtype(cfg) -> str:
    """The run's compute dtype name ("f32" | "bf16") from the config:
    ``compute_dtype``, with the legacy ``bf16`` boolean an alias for
    "bf16" (``bf16=True`` turns the default "f32" into "bf16").  An
    unknown name raises."""
    name = getattr(cfg, "compute_dtype", "f32") or "f32"
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}: choose from {COMPUTE_DTYPES}")
    if getattr(cfg, "bf16", False) and name == "f32":
        name = "bf16"
    return name


def model_dtype(name: str):
    """The models' ``dtype=`` for a compute dtype name: ``None`` for f32
    (compute in the parameters' own dtype, no cast), ``torch.bfloat16``
    for bf16."""
    import torch

    return {"f32": None, "bf16": torch.bfloat16}[name]
