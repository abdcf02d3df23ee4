"""Observability: the process-local metrics registry and span tracer.

Copies of ``edl_tpu.obs.metrics`` and ``edl_tpu.obs.trace`` (both
stdlib-only), emitting the same ``edl_*`` metric names and Chrome-trace
span format, so the JAX package's tools read a port process as they read
their own.
"""

from edl_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    bind_gauges,
    counter,
    default_registry,
    gauge,
    histogram,
)
from edl_tpu_torch.obs.trace import SpanTracer, get_tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "bind_gauges", "counter",
    "default_registry", "gauge", "histogram", "SpanTracer", "get_tracer",
    "span",
]
