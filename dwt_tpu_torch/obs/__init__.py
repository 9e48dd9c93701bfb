"""Run-wide telemetry of the port — the live metrics plane.

The always-on registry every serving subsystem feeds (counters, gauges,
histograms: :mod:`~dwt_tpu_torch.obs.registry`), its Prometheus text
exposition and exporter (:mod:`~dwt_tpu_torch.obs.prom`, the server's
``/metrics``) and the SLO alert engine (:mod:`~dwt_tpu_torch.obs.rules`,
``--alert_rules`` and ``--rollback_rules``).  The JAX package's span
tracer and trace export (``dwt_tpu.obs.spans``, ``dwt_tpu.obs.export``)
are not ported yet (ROADMAP queue 1 item 9).
"""

from dwt_tpu_torch.obs.registry import (  # noqa: F401
    MetricsRegistry,
    get_registry,
)
