"""Backbone registry — the port of ``dwt_tpu.nn.registry``: one name, one constructor.

The trainer, the eval pipeline, the serving engine and the checkpoints
touch a model only through its forward (train ``[D, N, H, W, C]``, eval
``[N, H, W, C]``), its norm sites and its ``fc_out`` head.  This registry
is the one place a backbone name is read: ``--backbone resnet152`` or
``--backbone vit_dwt`` goes through :func:`build_backbone`, and nothing
downstream special-cases the architecture.

Every entry takes the same keyword arguments: ``num_classes``,
``group_size``, ``momentum``, ``dtype``, ``whitener``, ``remat``,
``pad_classes_to``, ``image_size`` (the ViTs size ``pos_embed`` from it;
the ResNets pool globally and take any size), ``seed`` (fresh weights
from it; ``None`` leaves the constructor's, for weights a checkpoint
replaces) and ``group`` (the process group of a data-parallel run, which
every norm site reduces its moments over).  :func:`register_backbone` adds an entry, for example a test's
stub.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from torch import nn

from dwt_tpu_torch.nn.norms import set_group
from dwt_tpu_torch.nn.resnet import ResNetDWT, init_weights
from dwt_tpu_torch.nn.vit import ViTDWT, init_vit_weights


def _resnet(ctor: Callable[..., ResNetDWT]) -> Callable[..., nn.Module]:
    def build(*, seed: Optional[int] = None, image_size: Optional[int] = None,
              **kwargs) -> nn.Module:
        del image_size  # any input size: the head pools globally
        model = ctor(**kwargs)
        return model if seed is None else init_weights(model, seed)
    return build


def _vit(ctor: Callable[..., ViTDWT]) -> Callable[..., nn.Module]:
    def build(*, seed: Optional[int] = None, image_size: int = 224,
              **kwargs) -> nn.Module:
        model = ctor(image_size=image_size, **kwargs)
        return model if seed is None else init_vit_weights(model, seed)
    return build


# name -> ctor(**kwargs) -> nn.Module, every ctor on the surface above.
BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "resnet50": _resnet(ResNetDWT.resnet50),
    "resnet101": _resnet(ResNetDWT.resnet101),
    "resnet152": _resnet(ResNetDWT.resnet152),
    # Full channel widths, one block per stage: the CI miniature, under
    # its --arch name.
    "tiny": _resnet(ResNetDWT.tiny),
    "vit_dwt": _vit(ViTDWT.vit_dwt),
    "vit_tiny": _vit(ViTDWT.vit_tiny),
}


def build_backbone(name: str, group=None, **kwargs) -> nn.Module:
    """Construct the named backbone, or raise listing what is registered;
    its norm sites reduce their train-mode moments over ``group`` (the JAX
    models' ``axis_name``; None: one process)."""
    try:
        ctor = BACKBONES[name]
    except KeyError:
        raise ValueError(
            f"unknown backbone {name!r}; registered: "
            f"{', '.join(sorted(BACKBONES))}"
        ) from None
    return set_group(ctor(**kwargs), group)


def register_backbone(name: str, ctor: Callable[..., nn.Module]) -> None:
    """Add or override an entry (test stubs, experiment forks)."""
    BACKBONES[name] = ctor
