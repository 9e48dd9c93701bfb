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

__all__ = [
    "BottleneckDWT",
    "DomainBatchNorm",
    "DomainWhiten",
    "LeNetDWT",
    "ResNetDWT",
    "apply_domain_norm",
    "build_lenet",
    "init_lenet_weights",
    "init_weights",
    "merge_domains",
    "padded_num_classes",
    "split_domains",
]
