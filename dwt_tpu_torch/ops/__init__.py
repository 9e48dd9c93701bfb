"""Channels-last ``[..., C]`` ops of the port (``dwt_tpu.ops`` counterparts)."""

from dwt_tpu_torch.ops.batch_norm import (
    BatchNormStats,
    batch_norm,
    domain_batch_norm,
    init_batch_norm_stats,
)
from dwt_tpu_torch.ops.whitening import (
    WHITEN_CACHE_COL,
    WHITENER_NAMES,
    CholeskyWhitener,
    NewtonSchulzWhitener,
    SWBNStats,
    SWBNWhitener,
    Whitener,
    WhiteningStats,
    build_whiten_cache,
    get_whitener,
    group_cov,
    group_whiten,
    init_whitening_stats,
    newton_schulz_inverse_sqrt,
    whitening_matrix,
)

__all__ = [
    "BatchNormStats",
    "CholeskyWhitener",
    "NewtonSchulzWhitener",
    "SWBNStats",
    "SWBNWhitener",
    "WHITENER_NAMES",
    "WHITEN_CACHE_COL",
    "Whitener",
    "WhiteningStats",
    "batch_norm",
    "build_whiten_cache",
    "domain_batch_norm",
    "get_whitener",
    "group_cov",
    "group_whiten",
    "init_batch_norm_stats",
    "init_whitening_stats",
    "newton_schulz_inverse_sqrt",
    "whitening_matrix",
]
