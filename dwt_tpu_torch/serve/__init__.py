"""dwt_tpu_torch.serve — inference serving for the deployment forward.

The port of ``dwt_tpu.serve``: the target-branch eval forward with frozen
running stats and test-time domain whitening, served as one immutable
generation at a time (:mod:`~dwt_tpu_torch.serve.engine`, int8 weights
through :mod:`~dwt_tpu_torch.serve.quant`), deadline micro-batching with
bounded queues and load shedding (:mod:`~dwt_tpu_torch.serve.batcher`),
in-process and HTTP front ends with graceful SIGTERM drain
(:mod:`~dwt_tpu_torch.serve.server`), per-request JSONL access metrics
(:mod:`~dwt_tpu_torch.serve.metrics`) and guarded online adaptation of
the whitening statistics to live traffic
(:mod:`~dwt_tpu_torch.serve.adapt`).
"""

from dwt_tpu_torch.serve.adapt import DomainAdapter
from dwt_tpu_torch.serve.batcher import (
    DEFAULT_BUCKETS,
    Future,
    MicroBatcher,
    PlannedBatch,
    ShedError,
    bucket_for,
    plan_dispatch,
)
from dwt_tpu_torch.serve.engine import EngineState, ServeEngine, Version
from dwt_tpu_torch.serve.metrics import AccessLog
from dwt_tpu_torch.serve.server import HttpServeClient, ServeClient

__all__ = [
    "DomainAdapter",
    "DEFAULT_BUCKETS",
    "Future",
    "MicroBatcher",
    "PlannedBatch",
    "ShedError",
    "bucket_for",
    "plan_dispatch",
    "EngineState",
    "ServeEngine",
    "Version",
    "AccessLog",
    "HttpServeClient",
    "ServeClient",
]
