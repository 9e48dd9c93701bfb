"""OfficeHome trainer entry point — the ported subset of ``dwt_tpu.cli.officehome``.

    python -m dwt_tpu_torch.cli.officehome --s_dset_path DIR --t_dset_path DIR [flags]
    python -m dwt_tpu_torch.cli.officehome --synthetic [flags]

Runs on CUDA; ``--device cpu`` runs on the CPU (without it, a machine
with no CUDA raises).  Defaults are the JAX package's.  The initial state
is, first to last: the newest valid checkpoint of ``--ckpt_dir`` (a
resume), ``--init_ckpt``, the reference checkpoint at ``--resnet_path``
(not with ``--synthetic``; a JAX package's checkpoint gives its
parameters and stats), fresh weights from ``--seed``.  Saves run on a
writer thread (``--no-async_ckpt``: blocking), in the ``full`` or the
``delta`` format; the guard, watchdog and preemption flags are the JAX
CLI's, and a SIGTERM ends the run with a final save and exit 0.
``--steps_per_dispatch`` (1), ``--eval_steps_per_dispatch`` (8) and
``--harvest_depth`` (2) are the JAX CLI's too: on CUDA, k ≥ 2 replays a
captured graph per step, and the train records and the guard's finite
flags reach the host through the harvest ring.
``--whitener``, ``--compute_dtype`` (``--bf16``) and ``--remat`` are the
JAX CLI's numerics flags; ``--backbone`` (a registry name, which wins over
``--arch``) and ``--pad_classes_to`` its model flags.  The run plane's
flags are the JAX CLI's: ``--metrics_jsonl``, ``--heartbeat_every``,
``--metrics_port``, ``--alert_rules``, ``--expect_accuracy``/
``--tolerance`` (exit 1 on a miss), ``--debug_nans`` and
``--data_stall_timeout``; ``--pallas_whiten``, ``--apply_lowering``,
``--target_batch_size`` and ``--lr_change_step`` are accepted and change
nothing.  Data parallelism: one process per device with ``--distributed
--data_parallel`` (the DWT_* variables or torchrun); ``--dcn_slices``,
``--mesh_shape`` and ``--sharding_rules`` are the JAX CLI's: with
``--distributed --mesh_shape D,A,M --sharding_rules model|fsdp|<rules.json>``
each rank holds its block of every sharded tensor (the gspmd mode; under
``fsdp`` the head shards too, so pass ``--pad_classes_to M``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from dwt_tpu_torch.cli import (
    add_dispatch_args,
    add_numerics_args,
    add_parallel_args,
    add_resilience_args,
    add_run_plane_args,
    run_cli,
)
from dwt_tpu_torch.config import OfficeHomeConfig


def build_parser() -> argparse.ArgumentParser:
    d = OfficeHomeConfig()
    p = argparse.ArgumentParser(
        description="DWT-MEC OfficeHome trainer (PyTorch/CUDA port)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data instead of the image folders")
    p.add_argument("--synthetic_size", type=int, default=d.synthetic_size)
    p.add_argument("--arch", choices=["resnet50", "resnet101", "tiny"],
                   default=d.arch)
    p.add_argument("--backbone", type=str, default=d.backbone,
                   help="backbone-registry entry (wins over --arch): "
                        "resnet50|resnet101|resnet152|tiny|vit_dwt|vit_tiny "
                        "(dwt_tpu_torch.nn.registry)")
    p.add_argument("--pad_classes_to", type=int, default=d.pad_classes_to,
                   help=">1: pad the classifier head's out dim up to a "
                        "multiple of this; the padded logit columns are "
                        "sliced off inside the forward, so the counters "
                        "stay exact")
    p.add_argument("--num_classes", type=int, default=d.num_classes)
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="item-loading worker threads (decode+augment)")
    p.add_argument("--source_batch_size", type=int, default=d.source_batch_size)
    p.add_argument("--target_batch_size", type=int, default=d.target_batch_size,
                   help="accepted for parity; the loaders use --source_batch_size, "
                        "as the reference's (:565)")
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--s_dset_path", type=str, default=d.s_dset_path,
                   help="source domain: one directory of images per class")
    p.add_argument("--t_dset_path", type=str, default=d.t_dset_path,
                   help="target domain, as --s_dset_path")
    p.add_argument("--img_resize", type=int, default=d.img_resize)
    p.add_argument("--img_crop_size", type=int, default=d.img_crop_size)
    p.add_argument("--num_iters", type=int, default=d.num_iters)
    p.add_argument("--check_acc_step", type=int, default=d.check_acc_step)
    p.add_argument("--lr_change_step", type=int, default=d.lr_change_step,
                   help="accepted for parity; the milestone is --lr_milestones, "
                        "as the reference's hardcoded 6000 (:398)")
    p.add_argument("--log_interval", type=int, default=d.log_interval)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--lr_milestones", type=int, nargs="+",
                   default=list(d.lr_milestones),
                   help="iterations at which the lr decays by --lr_gamma "
                        "(each one step early, as the reference's)")
    p.add_argument("--lr_gamma", type=float, default=d.lr_gamma)
    p.add_argument("--backbone_lr_scale", type=float,
                   default=d.backbone_lr_scale,
                   help="everything but the fc_out head trains at lr times this")
    p.add_argument("--sgd_momentum", type=float, default=None,
                   help="the reference's flag default 0.5 is unused there; "
                        "its optimizer runs at 0.9, used when the flag is "
                        "not given")
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--running_momentum", type=float, default=d.running_momentum)
    p.add_argument("--lambda_mec_loss", type=float, default=d.lambda_mec_loss)
    p.add_argument("--group_size", type=int, default=d.group_size)
    p.add_argument("--stat_collection_passes", type=int,
                   default=d.stat_collection_passes)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--resnet_path", type=str, default=d.resnet_path,
                   help="the reference's PyTorch checkpoint, converted at "
                        "start (not with --synthetic, --init_ckpt or a "
                        "resume); a missing file trains from fresh init")
    p.add_argument("--init_ckpt", type=str, default=None,
                   help="a port checkpoint directory (python -m "
                        "dwt_tpu_torch.cli.convert) to start from, at step "
                        "0; read only, and skipped when --ckpt_dir resumes")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="checkpoint directory: saved into, resumed from")
    p.add_argument("--ckpt_every_iters", type=int, default=d.ckpt_every_iters)
    p.add_argument("--keep_ckpts", type=int, default=d.keep_ckpts,
                   help=">0: prune the main --ckpt_dir to the newest N steps "
                        "after each save; anchors and best_* are exempt")
    p.add_argument("--anchor_every", type=int, default=d.anchor_every,
                   help=">0: every N iters also save an anchor checkpoint "
                        "under ckpt_dir/anchors, never pruned")
    add_resilience_args(p, d)
    add_dispatch_args(p, d)
    add_numerics_args(p, d, remat=True)
    add_run_plane_args(p, d)
    add_parallel_args(p, d)
    p.add_argument("--device", default=d.device,
                   help="cuda (default; fails without CUDA) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> OfficeHomeConfig:
    kwargs = {f.name: getattr(args, f.name)
              for f in OfficeHomeConfig.__dataclass_fields__.values()}
    kwargs["lr_milestones"] = tuple(kwargs["lr_milestones"])
    if kwargs["sgd_momentum"] is None:
        kwargs["sgd_momentum"] = 0.9
    return OfficeHomeConfig(**kwargs)


def run_from_args(args: argparse.Namespace) -> float:
    """Train with the parsed flags (the run plane: :func:`~dwt_tpu_torch.
    cli.run_cli`); prints and returns the final target accuracy (%)."""
    from dwt_tpu_torch.train.loop import run_officehome

    return run_cli(run_officehome, config_from_args(args), args)


def main(argv: Optional[Sequence[str]] = None) -> float:
    return run_from_args(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
