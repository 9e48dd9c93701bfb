"""The reference's PyTorch checkpoint → a step-0 port checkpoint — the port of ``dwt_tpu.cli.convert``.

A reference user arrives with ``model_best_gr_4.pth.tar``; the OfficeHome
trainer converts it inline at every start (``--resnet_path``).  This
converts it once, into a checkpoint directory that the trainer's
``--init_ckpt`` starts from::

    python -m dwt_tpu_torch.cli.convert --torch_ckpt .../model_best_gr_4.pth.tar \\
        --out_dir /ckpts/resnet50_dwt_init [--arch resnet50|resnet101] \\
        [--num_classes 65] [--group_size 4]

The model and its optimizer are built as ``run_officehome`` builds them
(3 domain branches, the two-group SGD of ``officehome_tx``), so the
checkpoint restores into the trainer's state.  Conversion is host-only by
design and takes no ``--device``: it is a key map and a file write with no
device compute, and the checkpoint it writes holds CPU tensors that load
on any device.  The archive is read
with ``weights_only=False``, which runs its pickle: convert only archives
you trust.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert a reference PyTorch DWT checkpoint to a "
        "step-0 checkpoint of the PyTorch/CUDA port")
    p.add_argument("--torch_ckpt", required=True,
                   help="path to model_best_gr_*.pth.tar")
    p.add_argument("--out_dir", required=True,
                   help="checkpoint directory, written at step 0; pass it "
                        "to the trainer as --init_ckpt")
    p.add_argument("--arch", choices=["resnet50", "resnet101"], default="resnet50")
    p.add_argument("--num_classes", type=int, default=65)
    p.add_argument("--group_size", type=int, default=4)
    return p


def convert(args: argparse.Namespace) -> str:
    from dwt_tpu_torch.config import OfficeHomeConfig
    from dwt_tpu_torch.convert import convert_resnet_state_dict, load_pytorch_checkpoint
    from dwt_tpu_torch.nn.resnet import build_resnet
    from dwt_tpu_torch.train.optim import officehome_tx
    from dwt_tpu_torch.train.state import TrainState
    from dwt_tpu_torch.utils.checkpoint import save_state

    cfg = OfficeHomeConfig(arch=args.arch, num_classes=args.num_classes,
                           group_size=args.group_size)
    # The trainers train 3 streams (source, target, augmented target); a
    # checkpoint of any other width would restore into no trainer.
    model = build_resnet(cfg.arch, num_classes=cfg.num_classes,
                         group_size=cfg.group_size, seed=cfg.seed,
                         momentum=cfg.running_momentum)
    _, report = convert_resnet_state_dict(
        load_pytorch_checkpoint(args.torch_ckpt), model, num_domains=3)
    print(report.summary(), flush=True)
    optimizer, schedules = officehome_tx(model, cfg)
    path = save_state(args.out_dir, 0, TrainState(model, optimizer, schedules))
    if path is None:
        raise SystemExit(f"{args.torch_ckpt}: non-finite parameters; nothing written")
    print(f"wrote {path}", flush=True)
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    convert(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
