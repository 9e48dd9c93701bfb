"""LeNet-DWT — ``dwt_tpu.nn.lenet`` in PyTorch, train and eval: the digits (USPS↔MNIST) model.

Same architecture and submodule names as the Flax model (``conv1``,
``dn1``, ``conv2``, ``dn2``, ``fc3``, ``dn3``, ``fc4``, ``dn4``, ``fc5``,
``dn5``), so the weight bridge maps scope paths one to one:

* two 5×5 conv blocks, 1→32→48 channels with SAME padding (``padding=2``),
  each followed by a grouped-whitening site (:class:`DomainWhiten`, C = 32
  and 48), ReLU and a 2×2 max pool of stride 2;
* three dense layers 2352→100→100→10, each followed by a domain BN site;
  ``dn5`` normalizes the logits;
* two domain branches (source, target); eval goes through branch
  ``eval_domain``.

The public forward takes NHWC images like the JAX model: ``[2, N, 28, 28,
1]`` in train mode (merged to ``[2·N, …]`` for the convs, logits split back
to ``[2, N, 10]``), ``[N, 28, 28, 1]`` in eval mode.  Inside, convs run on
``[N, C, H, W]`` tensors in ``torch.channels_last`` memory format, so every
whitened site sees a contiguous ``[N·H·W, C]`` view of its input.
``dtype`` and ``whitener`` are ResNet-DWT's (``nn.resnet``).  The
flatten between the conv and dense stacks reads the ``[N, 7, 7, 48]``
(NHWC) view, as the JAX model flattens, so ``fc3``'s weight is the Flax
kernel transposed and nothing else.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dwt_tpu_torch.nn.norms import (
    DomainBatchNorm,
    DomainWhiten,
    merge_domains,
    set_group,
    split_domains,
)
from dwt_tpu_torch.nn.resnet import _variance_scaling_, cast_forward

INPUT_SHAPE = (28, 28, 1)  # per image, NHWC


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` in channels_last memory format — a no-op for the conv outputs
    of a channels_last model; a conv over one input channel (``conv1``) may
    return either layout, and the whitened sites take only this one."""
    return x.contiguous(memory_format=torch.channels_last)


class LeNetDWT(nn.Module):
    """Dual-branch whitened LeNet for unsupervised domain adaptation.

    Train input ``[num_domains, N, 28, 28, 1]`` → logits ``[num_domains,
    N, num_classes]``, every branch's running stats advanced; eval input
    ``[N, 28, 28, 1]`` through branch ``eval_domain`` → ``[N,
    num_classes]``.  ``momentum`` is the EMA weight of every norm site.
    """

    def __init__(
        self,
        group_size: int = 4,
        num_classes: int = 10,
        num_domains: int = 2,
        eval_domain: int = 1,
        momentum: float = 0.1,
        whiten_eps: float = 1e-3,
        dtype: Optional[torch.dtype] = None,
        whitener: str = "cholesky",
    ):
        super().__init__()
        self.num_classes = num_classes
        self.num_domains = num_domains
        self.eval_domain = eval_domain
        self.dtype = dtype
        norm_kw = dict(num_domains=num_domains, eval_domain=eval_domain,
                       momentum=momentum)
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.dn1 = DomainWhiten(32, group_size, eps=whiten_eps,
                                whitener=whitener, **norm_kw)
        self.conv2 = nn.Conv2d(32, 48, 5, padding=2)
        self.dn2 = DomainWhiten(48, group_size, eps=whiten_eps,
                                whitener=whitener, **norm_kw)
        self.fc3 = nn.Linear(7 * 7 * 48, 100)
        self.dn3 = DomainBatchNorm(100, **norm_kw)
        self.fc4 = nn.Linear(100, 100)
        self.dn4 = DomainBatchNorm(100, **norm_kw)
        self.fc5 = nn.Linear(100, num_classes)
        self.dn5 = DomainBatchNorm(num_classes, **norm_kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            if x.dim() != 5 or x.shape[0] != self.num_domains:
                raise ValueError(
                    f"train input must be [domains={self.num_domains}, N, 28, "
                    f"28, 1]; got {tuple(x.shape)}"
                )
            x = merge_domains(x)
        # Conv block: conv → whiten → affine → relu → maxpool (the
        # reference's order, usps_mnist.py:238).
        dt = self.dtype
        x = _channels_last((x if dt is None else x.to(dt)).permute(0, 3, 1, 2))
        x = F.max_pool2d(F.relu(self.dn1(_channels_last(cast_forward(self.conv1, x, dt)))), 2)
        x = F.max_pool2d(F.relu(self.dn2(_channels_last(cast_forward(self.conv2, x, dt)))), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC: [B, 2352]
        x = F.relu(self.dn3(cast_forward(self.fc3, x, dt)))
        x = F.relu(self.dn4(cast_forward(self.fc4, x, dt)))
        x = self.dn5(cast_forward(self.fc5, x, dt))
        if self.training:
            x = split_domains(x, self.num_domains)
        return x


@torch.no_grad()
def init_lenet_weights(model: LeNetDWT, seed: int = 0) -> LeNetDWT:
    """Fresh weights from ``seed`` with the Flax defaults the JAX model
    keeps: every conv and dense kernel lecun-normal (``variance_scaling(1,
    fan_in)``, truncated), every bias zero, norm affines γ=1, β=0 and the
    fresh running stats the norm modules are built with.  The numbers
    differ from ``jax.random``'s; the distributions are the same."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            _variance_scaling_(mod.weight, 1.0, fan_in, gen)
            mod.bias.zero_()
    return model


def build_lenet(
    *, group_size: int = 4, seed: Optional[int] = None, momentum: float = 0.1,
    dtype: Optional[torch.dtype] = None, whitener: str = "cholesky",
    group=None,
) -> LeNetDWT:
    """LeNet-DWT, freshly initialized from ``seed`` when one is given; its
    norm sites reduce their train-mode moments over ``group`` (the JAX
    model's ``axis_name``; None: one process)."""
    model = LeNetDWT(group_size=group_size, momentum=momentum, dtype=dtype,
                     whitener=whitener)
    if seed is not None:
        init_lenet_weights(model, seed)
    return set_group(model, group)
