"""Unified observability layer: metrics registry, per-query trace
spans, exposition endpoints, and runtime logging (port of ``repro.obs``,
kept as the port's own copy: it holds no device code).

One import surface for the four pieces (see API.md "Observability"):

  * :class:`MetricsRegistry` / :func:`get_registry` — counters, gauges,
    fixed-bucket histograms; Prometheus text + JSON snapshot export;
  * :class:`Tracer` / :data:`NULL_TRACER` — per-query spans with
    explicit parent/child causality, Chrome ``trace_event`` export;
  * :class:`StatsServer` — ``/metrics`` (Prometheus) + ``/stats``
    (JSON) HTTP endpoint;
  * :func:`get_logger` — the logging tree all CLI output routes
    through.
"""
from repro_torch.obs.logs import get_logger
from repro_torch.obs.registry import (LATENCY_BUCKETS, Counter, Gauge,
                                      Histogram, MetricsRegistry,
                                      get_registry)
from repro_torch.obs.stats_server import StatsServer
from repro_torch.obs.trace import (NULL_TRACER, Span, Tracer,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS",
    "MetricsRegistry", "NULL_TRACER", "Span", "StatsServer", "Tracer",
    "get_logger", "get_registry", "validate_chrome_trace",
]
