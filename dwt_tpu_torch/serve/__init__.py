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

The names are exported lazily (:func:`~dwt_tpu_torch._lazy.lazy_exports`),
so that :mod:`~dwt_tpu_torch.serve.http`, the handler base the fleet's
balancer shares, imports without torch.
"""

from dwt_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "DomainAdapter": "adapt",
    "DEFAULT_BUCKETS": "batcher",
    "Future": "batcher",
    "MicroBatcher": "batcher",
    "PlannedBatch": "batcher",
    "ShedError": "batcher",
    "bucket_for": "batcher",
    "plan_dispatch": "batcher",
    "EngineState": "engine",
    "ServeEngine": "engine",
    "Version": "engine",
    "AccessLog": "metrics",
    "HttpServeClient": "server",
    "ServeClient": "server",
}

__all__ = list(_EXPORTS)

__getattr__ = lazy_exports(__name__, _EXPORTS)
