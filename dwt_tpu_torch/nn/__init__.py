"""Models and norm modules of the port (``dwt_tpu.nn`` counterparts)."""

from dwt_tpu_torch.nn.lenet import LeNetDWT, build_lenet, init_lenet_weights
from dwt_tpu_torch.nn.norms import (
    DomainBatchNorm,
    DomainWhiten,
    apply_domain_norm,
    merge_domains,
    split_domains,
)
from dwt_tpu_torch.nn.resnet import BottleneckDWT, ResNetDWT, init_weights, padded_num_classes
from dwt_tpu_torch.nn.vit import TransformerBlockDWT, ViTDWT, init_vit_weights
from dwt_tpu_torch.nn.registry import BACKBONES, build_backbone, register_backbone

__all__ = [
    "BACKBONES",
    "BottleneckDWT",
    "DomainBatchNorm",
    "DomainWhiten",
    "LeNetDWT",
    "ResNetDWT",
    "TransformerBlockDWT",
    "ViTDWT",
    "apply_domain_norm",
    "build_backbone",
    "build_lenet",
    "init_lenet_weights",
    "init_vit_weights",
    "init_weights",
    "merge_domains",
    "padded_num_classes",
    "register_backbone",
    "split_domains",
]
