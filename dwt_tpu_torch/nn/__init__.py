"""Models and norm modules of the port (``dwt_tpu.nn`` counterparts)."""

from dwt_tpu_torch.nn.norms import DomainBatchNorm, DomainWhiten, merge_domains, split_domains
from dwt_tpu_torch.nn.resnet import BottleneckDWT, ResNetDWT, init_weights, padded_num_classes

__all__ = [
    "BottleneckDWT",
    "DomainBatchNorm",
    "DomainWhiten",
    "ResNetDWT",
    "init_weights",
    "merge_domains",
    "padded_num_classes",
    "split_domains",
]
