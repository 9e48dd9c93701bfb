"""dwt_tpu_torch.utils — metrics logging, repro verdicts, checkpoints
(``dwt_tpu_torch.utils.checkpoint``, which needs torch; import it by name)."""

from dwt_tpu_torch.utils.metrics import (
    HeartbeatEmitter,
    MetricLogger,
    host_rss_mb,
    percentile,
    percentile_summary,
)
from dwt_tpu_torch.utils.repro import (
    accuracy_verdict,
    check_cli_accuracy,
    load_expect_table,
    sweep_verdicts,
)

__all__ = [
    "HeartbeatEmitter",
    "MetricLogger",
    "host_rss_mb",
    "percentile",
    "percentile_summary",
    "accuracy_verdict",
    "check_cli_accuracy",
    "load_expect_table",
    "sweep_verdicts",
]
