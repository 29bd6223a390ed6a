"""repro_torch.obs — the serving path's counters, histograms and spans.

Stdlib only. The names match the reference's, so a dashboard reads both.
"""

from repro_torch.obs.metrics import REGISTRY, Counter, Histogram, MetricsRegistry
from repro_torch.obs.trace import TRACER, TraceContext, Tracer

__all__ = [
    "REGISTRY",
    "Counter",
    "Histogram",
    "MetricsRegistry",
    "TRACER",
    "TraceContext",
    "Tracer",
]
