"""Observability: the process-local metrics registry, the request tracer
and the fleet export (copies of the reference's pure-Python ``obs``
modules).

- :mod:`repro_torch.obs.metrics` — thread-safe registry of counters,
  gauges and log2 histograms with pre-bound handles; ``snapshot()``,
  ``merge()``;
- :mod:`repro_torch.obs.trace` — per-request spans in a bounded ring,
  exported as JSON or Chrome ``trace_event``;
- :mod:`repro_torch.obs.export` — one snapshot/merge/dump path and the
  registry-backed ``cache_stats_view``.

``set_enabled(False)`` turns metrics and tracing into cheap no-ops.
"""

from repro_torch.obs import export, metrics, trace
from repro_torch.obs.export import cache_stats_view, chrome_events, dump, \
    snapshot, traces_of
from repro_torch.obs.metrics import Counter, Gauge, Histogram, Registry, \
    counter_total, gauge_total
from repro_torch.obs.trace import Span, TraceContext, Tracer


def set_enabled(enabled: bool) -> None:
    """Master switch for the process-local default registry + tracer."""
    metrics.set_enabled(enabled)
    trace.set_enabled(enabled)


def reset() -> None:
    """Zero the default registry and clear the default tracer's ring."""
    metrics.reset()
    trace.DEFAULT.clear()
    trace.DEFAULT.close_open_spans(status="error", error="obs_reset")


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "TraceContext",
    "Tracer",
    "cache_stats_view",
    "chrome_events",
    "counter_total",
    "dump",
    "export",
    "gauge_total",
    "metrics",
    "reset",
    "set_enabled",
    "snapshot",
    "trace",
    "traces_of",
]
