"""The reference's PyTorch ResNet50-DWT checkpoint → the port's ``ResNetDWT`` — the port of ``dwt_tpu.convert.torch_resnet``.

Reproduces the reference's loading pipeline (``resnet50_dwt_mec_officehome
.py:365-378``) for the published ``model_best_gr_4.pth.tar``:

* the archive is ``{'state_dict': {...}}`` with ``module.``-prefixed keys
  (a DataParallel artifact), the prefix stripped (``:370-373``);
* whitening sites keep ``…bn{k}.wh.running_mean`` (``[1,C,1,1]``) and
  ``…bn{k}.wh.running_variance`` (``[G,g,g]``), their affines at
  ``…bn{k}.gamma/beta`` (``[C,1,1]``); BN sites ``…bn{k}.running_mean/
  running_var/num_batches_tracked`` and ``…bn{k}.weight/bias``;
* downsample norms live at ``layer{L}.0.downsample_bn.*`` and the
  shortcut conv at ``layer{L}.0.downsample.0.weight``;
* every domain branch is seeded from the same checkpoint stats (tiled
  along the leading domain axis) and diverges only through its EMA;
* ``strict=False`` semantics (``:376``): a key with no destination, or
  one of another shape (the ImageNet ``fc [1000, 2048]`` head), is
  skipped and reported; what the dict does not cover keeps its fresh
  init.

In the port this is a key map, not a layout change: the port's module
names are the Flax scope names, and its weights are PyTorch's layouts
(conv OIHW, linear ``[out, in]``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from dwt_tpu_torch.nn.norms import DomainBatchNorm, DomainWhiten


@dataclass
class ConversionReport:
    """What ``strict=False`` would have told you, made explicit."""

    loaded: List[str] = field(default_factory=list)
    skipped_unexpected: List[str] = field(default_factory=list)
    skipped_shape_mismatch: List[Tuple[str, tuple, tuple]] = field(
        default_factory=list
    )

    def summary(self) -> str:
        return (
            f"loaded={len(self.loaded)} "
            f"unexpected={len(self.skipped_unexpected)} "
            f"shape_mismatch={len(self.skipped_shape_mismatch)}"
        )


def load_pytorch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth(.tar)`` archive's state dict onto the CPU, unwrapping
    ``state_dict`` and stripping ``module.``.

    The archive is read with ``weights_only=False``, as the JAX reader
    does: this runs the archive's pickle, so read only archives you
    trust (the published checkpoint stores more than tensors)."""
    archive = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = archive.get("state_dict", archive)
    out = {}
    for key, value in state_dict.items():
        if key.startswith("module."):
            key = key[len("module."):]
        out[key] = torch.as_tensor(value).detach().cpu()
    return out


_CONV_RE = re.compile(r"^layer(\d+)\.(\d+)\.conv(\d)\.weight$")
_DOWNSAMPLE_CONV_RE = re.compile(r"^layer(\d+)\.(\d+)\.downsample\.0\.weight$")
_NORM_RE = re.compile(r"^(?:layer(\d+)\.(\d+)\.)?(bn\d|downsample_bn)\.(.+)$")

# norm-key suffix → (site kind, the site's tensor, transform); kind None
# is the shared affine, which both kinds carry.
_NORM_LEAVES = {
    "wh.running_mean": (DomainWhiten, "mean", "squeeze_tile"),
    "wh.running_variance": (DomainWhiten, "cov", "tile"),
    "gamma": (None, "gamma", "squeeze"),
    "beta": (None, "beta", "squeeze"),
    "running_mean": (DomainBatchNorm, "mean", "tile"),
    "running_var": (DomainBatchNorm, "var", "tile"),
    "weight": (None, "gamma", "squeeze"),
    "bias": (None, "beta", "squeeze"),
    "num_batches_tracked": (DomainBatchNorm, "count", "tile"),
}


def _site_name(bn_name: str) -> str:
    """Reference norm-site name → the port's (``bn1`` → ``dn1``)."""
    if bn_name == "downsample_bn":
        return "downsample_dn"
    return "dn" + bn_name[len("bn"):]


def _resolve(key: str, model: nn.Module) -> Optional[Tuple[str, str]]:
    """One reference key → ``(the model's state-dict key, transform)``, or
    None when the model has no such tensor."""
    if key == "conv1.weight":
        return "conv1.weight", "none"
    m = _CONV_RE.match(key)
    if m:
        stage, block, k = m.groups()
        return f"layer{stage}_{block}.conv{k}.weight", "none"
    m = _DOWNSAMPLE_CONV_RE.match(key)
    if m:
        stage, block = m.groups()
        return f"layer{stage}_{block}.downsample_conv.weight", "none"
    if key in ("fc_out.weight", "fc.weight"):
        return "fc_out.weight", "none"
    if key in ("fc_out.bias", "fc.bias"):
        return "fc_out.bias", "none"
    m = _NORM_RE.match(key)
    if m is None:
        return None
    stage, block, bn_name, leaf = m.groups()
    resolved = _NORM_LEAVES.get(leaf)
    if resolved is None:
        return None
    kind, tensor, transform = resolved
    site = _site_name(bn_name)
    if stage is not None:
        site = f"layer{stage}_{block}.{site}"
    try:
        module = model.get_submodule(site)
    except AttributeError:
        return None
    if not isinstance(module, kind or (DomainWhiten, DomainBatchNorm)):
        return None
    return f"{site}.{tensor}", transform


def _transform(value: torch.Tensor, tag: str, num_domains: int) -> torch.Tensor:
    if tag == "squeeze":  # [C,1,1] / [1,C] → [C]
        return value.reshape(-1)
    if tag == "squeeze_tile":  # [1,C,1,1] → [D, C]
        return value.reshape(-1).expand(num_domains, -1)
    if tag == "tile":  # a stat of any shape → [D, ...]
        return value.expand((num_domains,) + tuple(value.shape))
    return value


@torch.no_grad()
def convert_resnet_state_dict(
    state_dict: Dict[str, torch.Tensor],
    model: nn.Module,
    num_domains: int = 3,
) -> Tuple[nn.Module, ConversionReport]:
    """Load a reference DWT state dict into ``model`` (a port
    ``ResNetDWT``) in place, with ``strict=False`` semantics; returns
    ``(model, report)``.  Each tensor keeps its device, dtype and memory
    format."""
    report = ConversionReport()
    targets = model.state_dict()  # detached views of the live tensors
    for key, raw in state_dict.items():
        resolved = _resolve(key, model)
        if resolved is None or resolved[0] not in targets:
            report.skipped_unexpected.append(key)
            continue
        name, tag = resolved
        target = targets[name]
        value = _transform(torch.as_tensor(raw), tag, num_domains)
        if tuple(value.shape) != tuple(target.shape):
            report.skipped_shape_mismatch.append(
                (key, tuple(value.shape), tuple(target.shape)))
            continue
        target.copy_(value.to(target.dtype))
        report.loaded.append(key)
    return model, report
