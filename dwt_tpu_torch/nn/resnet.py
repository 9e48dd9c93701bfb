"""ResNet-DWT — ``dwt_tpu.nn.resnet`` in PyTorch, train and eval.

Same architecture and submodule names as the Flax model (``conv1``,
``dn1``, ``layer1_0``, ``downsample_conv``, ``downsample_dn``,
``fc_out``, …), so the weight bridge maps scope paths one to one:

* the stem norm and every stage-1 norm site are grouped whitening
  (:class:`DomainWhiten`); stages 2-4 use domain BN;
* the bottleneck's 3×3 conv pads (1, 1) explicitly, at stride 2 too;
* downsample shortcuts are a bare 1×1 conv followed by a norm site;
* three domain branches (source, target, augmented target); train mode
  normalizes each domain with its own branch, eval goes through branch
  ``eval_domain``.

The public forward takes NHWC images like the JAX model: ``[D, N, H, W,
3]`` in train mode (merged to ``[D·N, …]`` for the convs, logits split
back to ``[D, N, K]``), ``[N, H, W, 3]`` in eval mode.  Inside, convs run
on ``[N, C, H, W]`` tensors in ``torch.channels_last`` memory format, so
every norm site sees a contiguous ``[N·H·W, C]`` view of its input.

``dtype`` is the compute dtype (``--compute_dtype``), as Flax's ``dtype=``:
the parameters stay f32, each conv and dense casts its input and its
parameters to ``dtype`` (:func:`cast_forward`), the norm sites keep f32
statistics and return ``dtype``, and the logits come out in ``dtype``.
``None`` (the default) computes in the parameters' own dtype, casting
nothing (a model moved to float64 computes in float64).
``whitener`` is every whitening site's backend; ``remat`` recomputes each
bottleneck's activations in the backward (``nn.norms.remat``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dwt_tpu_torch.nn.norms import (
    DomainBatchNorm,
    DomainWhiten,
    merge_domains,
    remat,
    split_domains,
)


def cast_forward(mod: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``mod(x)`` for a conv or dense ``mod`` with ``x`` and its parameters
    cast to ``dtype`` — Flax's ``dtype=``; the parameters themselves stay
    as they are, and their gradients come back in their own dtype.  At the
    parameters' dtype, or ``dtype=None``, it is ``mod(x)``."""
    if dtype is None or mod.weight.dtype == dtype:
        return mod(x)
    weight = mod.weight.to(dtype)
    bias = None if mod.bias is None else mod.bias.to(dtype)
    if isinstance(mod, nn.Conv2d):
        return mod._conv_forward(x.to(dtype), weight, bias)
    return F.linear(x.to(dtype), weight, bias)


class BottleneckDWT(nn.Module):
    """1x1 → 3x3 → 1x1 bottleneck, every norm a domain site."""

    expansion = 4

    def __init__(
        self,
        inplanes: int,
        planes: int,
        stride: int = 1,
        use_whitening: bool = False,
        has_downsample: bool = False,
        group_size: int = 4,
        num_domains: int = 3,
        eval_domain: int = 1,
        momentum: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        whitener: str = "cholesky",
    ):
        super().__init__()
        out_ch = planes * self.expansion
        self.dtype = dtype

        def norm(features: int) -> nn.Module:
            if use_whitening:
                return DomainWhiten(features, group_size, num_domains,
                                    eval_domain, momentum, whitener=whitener)
            return DomainBatchNorm(features, num_domains, eval_domain, momentum)

        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.dn1 = norm(planes)
        # Explicit symmetric padding (1, 1), as the Flax model pads.
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.dn2 = norm(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.dn3 = norm(out_ch)
        if has_downsample:
            self.downsample_conv = nn.Conv2d(inplanes, out_ch, 1, stride=stride,
                                             bias=False)
            self.downsample_dn = norm(out_ch)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        identity = x
        h = F.relu(self.dn1(cast_forward(self.conv1, x, dt)))
        h = F.relu(self.dn2(cast_forward(self.conv2, h, dt)))
        h = self.dn3(cast_forward(self.conv3, h, dt))
        if self.downsample_conv is not None:
            identity = self.downsample_dn(cast_forward(self.downsample_conv, x, dt))
        return F.relu(h + identity)


class ResNetDWT(nn.Module):
    """ResNet-50 with domain whitening (stem + stage 1) and domain BN.

    Train input ``[3, N, H, W, 3]`` (source, target, augmented target)
    → logits ``[3, N, num_classes]``, every branch's running stats
    advanced; eval input ``[N, H, W, 3]`` through the target branches
    only → logits ``[N, num_classes]``.  ``momentum`` is the EMA weight
    of every norm site; ``dtype``, ``whitener`` and ``remat`` as in the
    module docstring.
    """

    def __init__(
        self,
        stage_sizes: Sequence[int],
        num_classes: int = 65,
        group_size: int = 4,
        num_domains: int = 3,
        eval_domain: int = 1,
        pad_classes_to: int = 0,
        momentum: float = 0.1,
        dtype: Optional[torch.dtype] = None,
        whitener: str = "cholesky",
        remat: bool = False,
    ):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.num_classes = num_classes
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.dtype = dtype
        self.remat = remat

        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.dn1 = DomainWhiten(64, group_size, num_domains, eval_domain,
                                momentum, whitener=whitener)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes = 64
        for stage, num_blocks in enumerate(self.stage_sizes, start=1):
            planes = 64 * 2 ** (stage - 1)
            for block in range(num_blocks):
                stride = 2 if (stage > 1 and block == 0) else 1
                self.add_module(f"layer{stage}_{block}", BottleneckDWT(
                    inplanes, planes, stride=stride,
                    # Stage 1 whitens; deeper stages batch-normalize.
                    use_whitening=(stage == 1),
                    has_downsample=(block == 0),
                    group_size=group_size,
                    num_domains=num_domains,
                    eval_domain=eval_domain,
                    momentum=momentum,
                    dtype=dtype,
                    whitener=whitener,
                ))
                inplanes = planes * BottleneckDWT.expansion
        self.fc_out = nn.Linear(
            inplanes, padded_num_classes(num_classes, pad_classes_to)
        )

    @classmethod
    def resnet50(cls, **kw) -> "ResNetDWT":
        """[3,4,6,3] — the reference ``resnet50()``."""
        return cls(stage_sizes=(3, 4, 6, 3), **kw)

    @classmethod
    def tiny(cls, **kw) -> "ResNetDWT":
        """Full channel widths, one block per stage — the server's
        ``--model tiny``."""
        return cls(stage_sizes=(1, 1, 1, 1), **kw)

    def blocks(self):
        for stage, num_blocks in enumerate(self.stage_sizes, start=1):
            for block in range(num_blocks):
                yield getattr(self, f"layer{stage}_{block}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if x.dim() != 5 or x.shape[0] != self.num_domains:
                raise ValueError(
                    f"train input must be [domains={self.num_domains}, N, H, "
                    f"W, C]; got {tuple(x.shape)}"
                )
            x = merge_domains(x)
        # NHWC in; the permuted view IS channels_last memory for a
        # contiguous NHWC input.
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.dn1(cast_forward(self.conv1, x, self.dtype)))
        x = self.maxpool(x)
        checkpointed = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks():
            x = remat(block, x) if checkpointed else block(x)
        x = x.mean(dim=(2, 3))  # global average pool → [N, C]
        x = cast_forward(self.fc_out, x, self.dtype)
        x = x[:, : self.num_classes]  # no-op unless the head is padded
        if self.training:
            x = split_domains(x, self.num_domains)
        return x


def padded_num_classes(num_classes: int, pad_to: int) -> int:
    """Head out-dim under pad-to-divisible: ``num_classes`` rounded up to
    a multiple of ``pad_to`` (0/1 = unpadded)."""
    if pad_to and pad_to > 1:
        return -(-num_classes // pad_to) * pad_to
    return num_classes


# Flax's variance_scaling(..., "truncated_normal") draws from a normal
# truncated at ±2σ and rescales σ by this constant so the variance is
# exactly ``scale / fan``.
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_(w: torch.Tensor, scale: float, fan: int,
                       generator: torch.Generator) -> None:
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fresh weights from ``seed``, with the Flax model's initializers:
    convs kaiming-normal fan_out (``variance_scaling(2, fan_out)``), the
    head lecun-normal with a zero bias, norm affines γ=1, β=0, and the
    fresh running stats the norm modules are built with.  The numbers
    differ from ``jax.random``'s; the distributions are the same."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            out_ch, _, kh, kw = mod.weight.shape
            _variance_scaling_(mod.weight, 2.0, out_ch * kh * kw, gen)
        elif isinstance(mod, nn.Linear):
            _variance_scaling_(mod.weight, 1.0, mod.in_features, gen)
            mod.bias.zero_()
    return model


def build_resnet(
    name: str, *, num_classes: int = 65, group_size: int = 4,
    seed: Optional[int] = None, momentum: float = 0.1,
    dtype: Optional[torch.dtype] = None, whitener: str = "cholesky",
    remat: bool = False,
) -> ResNetDWT:
    """``resnet50`` or ``tiny`` by name, freshly initialized from ``seed``
    when one is given."""
    ctors = {"resnet50": ResNetDWT.resnet50, "tiny": ResNetDWT.tiny}
    if name not in ctors:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(ctors)}")
    model = ctors[name](num_classes=num_classes, group_size=group_size,
                        momentum=momentum, dtype=dtype, whitener=whitener,
                        remat=remat)
    if seed is not None:
        init_weights(model, seed)
    return model
