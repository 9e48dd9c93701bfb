"""Run-wide telemetry of the port: span tracing, flight recorder, trace export, and the live metrics plane.

The span tracer (:mod:`~dwt_tpu_torch.obs.spans`) and its Chrome-trace
export and flight recorder (:mod:`~dwt_tpu_torch.obs.export`) are the
JAX package's ``dwt_tpu.obs.spans`` and ``dwt_tpu.obs.export``, copied
with every name; the registry, its Prometheus exposition and the alert
engine (:mod:`~dwt_tpu_torch.obs.registry`, :mod:`~dwt_tpu_torch.obs.prom`,
:mod:`~dwt_tpu_torch.obs.rules`) are the JAX package's too.  Every module
here imports the standard library only: the fleet balancer imports this
package and must load no torch.

Usage at call sites (always safe, near-free when tracing is off)::

    from dwt_tpu_torch import obs

    with obs.span("step_dispatch"):
        metrics = train_step(state, batch)

Gate: ``--obs_trace PATH`` on the CLIs / ``DWT_OBS_TRACE`` env
(``obs.maybe_enable``).  Export: ``obs.export()`` writes Chrome
trace-event JSON (Perfetto/TensorBoard loadable).  Flight recorder:
``obs.flight_dump(dir, reason)`` writes the last few seconds of spans —
wired into the hang watchdog and divergence-guard event paths.

Span categories (the report tool groups by these):

* ``step`` — top-level phases of the TRAIN loop's main thread; their
  self-time sum vs the loop wall time is the attribution table.  The
  metric-harvest pipeline contributes ``metric_copy_start``
  (non-blocking device→host copy enqueue), ``harvest_drain`` (the
  drain site), and the nested ``metric_host_fetch`` — the one
  genuinely BLOCKING materialization (the harvester's event wait).
* ``eval`` — eval/stat-collection pipeline internals.
* ``ckpt`` — checkpoint pipeline (writer-thread writes; the
  multi-process writers' ``ckpt_host_fetch``, ``shard_write``,
  ``ckpt_promote`` and ``ckpt_barrier``).
* ``shard`` — the gspmd mode's state placement (``shard_put``), the
  gather before a save (``gather``) and the restore to spec
  (``restore_place``).
* ``data`` — prefetch producer thread (batch assembly, H2D staging).
* ``serve`` — serving path (admission → plan → build → stage → device →
  resolve), spans carrying ``bucket``/``req_id`` attrs that correlate
  with ``AccessLog`` records.
* ``fleet`` — continuous-deployment lifecycle (reload_restore →
  build_state → canary → swap), version-attributed; joins the
  ``reload``/``canary``/``swap``/``rollback`` JSONL events and the
  per-version access windows.
* ``detail`` — nested sub-phases (guard check, consensus decide) inside
  a ``step`` span; excluded from the top-level sum.
"""

from dwt_tpu_torch.obs.spans import (  # noqa: F401
    NULL_SPAN,
    Tracer,
    configure,
    disable,
    enabled,
    export_path,
    get_tracer,
    maybe_enable,
    record_complete,
    snapshot,
    span,
    traced_iter,
)
from dwt_tpu_torch.obs.export import (  # noqa: F401
    FLIGHT_WINDOW_S,
    export,
    flight_dump,
    to_chrome_trace,
    validate_chrome_trace,
)
from dwt_tpu_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
)
