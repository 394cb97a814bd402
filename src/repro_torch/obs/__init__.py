"""Observability for the port's serving stack: a dependency-free metrics
registry (obs/metrics.py) and engine step/request tracing (obs/tracing.py),
copies of the reference's.

The import surface is torch-free: the host-only scheduler hooks into
``EngineObs`` and must stay importable without a device runtime.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     hist_quantile, label_str,
                                     merge_snapshots, parse_prometheus,
                                     render_prometheus, snapshot_quantile)
from repro_torch.obs.tracing import (PHASES, EngineObs, RequestSpan,
                                     StepTrace, format_statusz)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry",
    "hist_quantile", "label_str", "merge_snapshots", "parse_prometheus",
    "render_prometheus", "snapshot_quantile",
    "PHASES", "EngineObs", "RequestSpan", "StepTrace", "format_statusz",
]
