"""Digits (USPS↔MNIST) trainer entry point — the ported subset of ``dwt_tpu.cli.usps_mnist``.

    python -m dwt_tpu_torch.cli.usps_mnist --synthetic --group_size 4 [flags]

Runs on CUDA; ``--device cpu`` runs on the CPU (without it, a machine
with no CUDA raises).  Defaults are the JAX package's, the reference's
``--group_size 32`` included (it does not divide conv2's 48 channels;
every published digits result uses 4).  ``--ckpt_dir`` saves every
``--ckpt_every_epochs`` and at the end, and a rerun with the same
directory resumes from its newest valid checkpoint.  Saves run on a
writer thread (``--no-async_ckpt``: blocking), in the ``full`` or the
``delta`` format; ``--guard_policy``, ``--watchdog_timeout`` and the
preemption notice flags are the JAX CLI's, and a SIGTERM ends the run
with a final save and exit 0.  ``--steps_per_dispatch`` (1),
``--eval_steps_per_dispatch`` (8) and ``--harvest_depth`` (2) are the JAX
CLI's: on CUDA, k ≥ 2 replays a captured graph per step, and the train
records and the guard's finite flags reach the host through the harvest
ring.
``--whitener`` and ``--compute_dtype`` (``--bf16``) are the JAX CLI's
numerics flags.  The run plane's flags are the JAX CLI's too:
``--metrics_jsonl``, ``--heartbeat_every``, ``--metrics_port``,
``--alert_rules``, ``--expect_accuracy``/``--tolerance`` (exit 1 on a
miss), ``--debug_nans`` and ``--data_stall_timeout``; ``--pallas_whiten``
and ``--apply_lowering`` are accepted and change nothing.  Data
parallelism: launch one process per device with ``--distributed
--data_parallel`` (``DWT_COORDINATOR_ADDRESS``, ``DWT_NUM_PROCESSES``,
``DWT_PROCESS_ID``, or torchrun); ``--dcn_slices``, ``--mesh_shape`` and
``--sharding_rules`` are the JAX CLI's (``--distributed --mesh_shape
D,A,M --sharding_rules model|fsdp|<rules.json>``: the gspmd mode, each
rank holding its block of every sharded tensor; LeNet's ``fc5`` head stays
whole under ``model``).
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
from dwt_tpu_torch.config import DigitsConfig


def build_parser() -> argparse.ArgumentParser:
    d = DigitsConfig()
    p = argparse.ArgumentParser(
        description="DWT digits trainer, USPS↔MNIST (PyTorch/CUDA port)")
    p.add_argument("--num_workers", type=int, default=d.num_workers,
                   help="item-loading worker threads")
    p.add_argument("--source", default=d.source, help="usps or mnist")
    p.add_argument("--target", default=d.target, help="usps or mnist")
    p.add_argument("--source_batch_size", type=int, default=d.source_batch_size)
    p.add_argument("--target_batch_size", type=int, default=d.target_batch_size)
    p.add_argument("--test_batch_size", type=int, default=d.test_batch_size)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--sgd_momentum", type=float, default=d.sgd_momentum,
                   help="accepted for parity; unused (Adam), as in the reference")
    p.add_argument("--running_momentum", type=float, default=d.running_momentum)
    p.add_argument("--lambda_entropy_loss", type=float,
                   default=d.lambda_entropy_loss)
    p.add_argument("--log_interval", type=int, default=d.log_interval)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--group_size", type=int, default=d.group_size)
    p.add_argument("--data_root", default=d.data_root,
                   help="holds usps/usps_28x28.pkl and mnist/ (no download)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated data instead of the files")
    p.add_argument("--synthetic_size", type=int, default=d.synthetic_size)
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="checkpoint directory: saved into, resumed from")
    p.add_argument("--ckpt_every_epochs", type=int, default=d.ckpt_every_epochs)
    p.add_argument("--keep_ckpts", type=int, default=d.keep_ckpts,
                   help=">0: prune the main --ckpt_dir to the newest N steps "
                        "after each save; anchors are exempt")
    p.add_argument("--anchor_every", type=int, default=d.anchor_every,
                   help=">0: every N epochs also save an anchor checkpoint "
                        "under ckpt_dir/anchors, never pruned")
    add_resilience_args(p, d)
    add_dispatch_args(p, d)
    add_numerics_args(p, d)
    add_run_plane_args(p, d)
    add_parallel_args(p, d)
    p.add_argument("--device", default=d.device,
                   help="cuda (default; fails without CUDA) or cpu")
    return p


def config_from_args(args: argparse.Namespace) -> DigitsConfig:
    fields = DigitsConfig.__dataclass_fields__
    return DigitsConfig(**{k: v for k, v in vars(args).items() if k in fields})


def main(argv: Optional[Sequence[str]] = None) -> float:
    from dwt_tpu_torch.train.loop import run_digits

    args = build_parser().parse_args(argv)
    return run_cli(run_digits, config_from_args(args), args)


if __name__ == "__main__":
    main()
