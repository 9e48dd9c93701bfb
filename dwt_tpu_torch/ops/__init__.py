"""Channels-last ``[..., C]`` ops of the port (``dwt_tpu.ops`` counterparts)."""

from dwt_tpu_torch.ops.batch_norm import BatchNormStats, batch_norm, init_batch_norm_stats
from dwt_tpu_torch.ops.whitening import (
    WHITEN_CACHE_COL,
    WhiteningStats,
    build_whiten_cache,
    group_whiten,
    init_whitening_stats,
    whitening_matrix,
)

__all__ = [
    "BatchNormStats",
    "WHITEN_CACHE_COL",
    "WhiteningStats",
    "batch_norm",
    "build_whiten_cache",
    "group_whiten",
    "init_batch_norm_stats",
    "init_whitening_stats",
    "whitening_matrix",
]
