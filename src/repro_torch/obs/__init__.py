"""Observability: the process-local metrics registry and request tracer
(copies of the reference's pure-Python ``obs.metrics`` and ``obs.trace``)."""

from repro_torch.obs import metrics, trace
