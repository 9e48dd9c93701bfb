"""VisDA-2017 trainer entry point — the port of ``dwt_tpu.cli.visda`` (``BASELINE.json`` ``configs[4]``, ResNet101-DWT).

    python -m dwt_tpu_torch.cli.visda --s_dset_path DIR --t_dset_path DIR [flags]
    python -m dwt_tpu_torch.cli.visda --synthetic [flags]

The OfficeHome trainer (``dwt_tpu_torch.cli.officehome``: MEC training on
three streams, the stat-collection passes) with VisDA's defaults: the
ResNet101 backbone, 12 classes, the ``train`` and ``validation`` folders
of ``visda-2017``, and no reference checkpoint (the OfficeHome default is
a ResNet50 state dict, whose keys would load partly into a ResNet101 under
``strict=False`` semantics; pass a ResNet101 checkpoint explicitly).
Every OfficeHome flag stays available.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from dwt_tpu_torch.cli import officehome as _oh

_VISDA_DEFAULTS = {
    "arch": "resnet101",
    "num_classes": 12,
    "s_dset_path": "../data/visda-2017/train",
    "t_dset_path": "../data/visda-2017/validation",
    "resnet_path": "",
}


def build_parser() -> argparse.ArgumentParser:
    p = _oh.build_parser()
    p.description = "DWT-MEC VisDA-2017 trainer, ResNet101-DWT (PyTorch/CUDA port)"
    p.set_defaults(**_VISDA_DEFAULTS)
    return p


def main(argv: Optional[Sequence[str]] = None) -> float:
    return _oh.run_from_args(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
