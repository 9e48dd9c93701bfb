"""dwt_tpu_torch.fleet — continuous deployment for one serving process.

The port of the single-replica half of ``dwt_tpu.fleet``: the training
loop keeps writing checkpoints; the server watches the same
``ckpt_dir`` (:mod:`~dwt_tpu_torch.fleet.watcher` — the checkpoint
layer's own newest-valid ranked walk, so unpromoted and torn steps are
invisible by construction), gates each candidate through a fixture eval
(:mod:`~dwt_tpu_torch.fleet.canary`), hot-swaps it into the live engine
as one reference assignment between dispatches
(:mod:`~dwt_tpu_torch.fleet.reload` + ``ServeEngine.swap`` — in-flight
batches finish on the old generation), and rolls back to the last-good
generation when the post-swap access-log windows regress.  The online
adapter (``dwt_tpu_torch.serve.adapt``) submits its generations through
the same pipeline.  The multi-replica balancer, the autoscaler and the
respawn budget (``dwt_tpu.fleet.balancer``, ``autoscale``, ``retry``)
are not ported yet (ROADMAP queue 1 item 7).
"""

from dwt_tpu_torch.fleet.canary import CanaryGate, CanaryVerdict, PostSwapMonitor
from dwt_tpu_torch.fleet.reload import DeployController, HotReloader
from dwt_tpu_torch.fleet.watcher import Candidate, CheckpointWatcher

__all__ = [
    "Candidate",
    "CheckpointWatcher",
    "CanaryGate",
    "CanaryVerdict",
    "PostSwapMonitor",
    "DeployController",
    "HotReloader",
]
