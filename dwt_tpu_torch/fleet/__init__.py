"""dwt_tpu_torch.fleet — continuous deployment and the replica fleet.

The port of ``dwt_tpu.fleet``: the training loop keeps writing
checkpoints; every serving replica watches the same ``ckpt_dir``
(:mod:`~dwt_tpu_torch.fleet.watcher` — the checkpoint layer's own
newest-valid ranked walk, so unpromoted and torn steps are invisible by
construction), gates each candidate through a fixture eval
(:mod:`~dwt_tpu_torch.fleet.canary`), hot-swaps it into the live engine
as one reference assignment between dispatches
(:mod:`~dwt_tpu_torch.fleet.reload` + ``ServeEngine.swap`` — in-flight
batches finish on the old generation), and rolls back to the last-good
generation when the post-swap access-log windows regress.  The online
adapter (``dwt_tpu_torch.serve.adapt``) submits its generations through
the same pipeline.  :mod:`~dwt_tpu_torch.fleet.balancer` (``python -m
dwt_tpu_torch.fleet.balancer``) fronts N server subprocesses with a
least-outstanding-requests load balancer: per-replica health off
``/healthz``, ejection and re-admission, respawns within a budget
(:mod:`~dwt_tpu_torch.fleet.retry`), SIGTERM → drain every replica →
exit 0.  :mod:`~dwt_tpu_torch.fleet.autoscale` scales the replica count
between ``--min_replicas`` and ``--max_replicas`` off the fleet's own
signals, and the router weights picks by each replica's drain rate.

Every name is exported lazily
(:func:`~dwt_tpu_torch._lazy.lazy_exports`): the canary and the reloader
import torch, and the balancer process, which imports this package, must
hold no CUDA context and pays for no torch import.
"""

from dwt_tpu_torch._lazy import lazy_exports

_EXPORTS = {
    "Candidate": "watcher",
    "CheckpointWatcher": "watcher",
    "CanaryGate": "canary",
    "CanaryVerdict": "canary",
    "PostSwapMonitor": "canary",
    "DeployController": "reload",
    "HotReloader": "reload",
    "Autoscaler": "autoscale",
    "ScaleDecision": "autoscale",
}

__all__ = list(_EXPORTS)

__getattr__ = lazy_exports(__name__, _EXPORTS)
