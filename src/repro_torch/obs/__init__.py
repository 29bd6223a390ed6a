"""repro_torch.obs — the serving path's counters, histograms and spans, and
the surfaces that export them: Prometheus text and trace dumps over HTTP
(:func:`start_metrics_server`, a shard server's ``--metrics-port``), and the
scrape side that reads them back (:func:`parse_prometheus`).

Stdlib only. The names, the snapshot and the text are the reference's, so a
dashboard reads both packages.
"""

from repro_torch.obs.http import MetricsServer, start_metrics_server
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     MetricsRegistry,
                                     default_latency_buckets_us,
                                     diff_hist_states, get_registry,
                                     merge_hist_states, render_prometheus,
                                     summarize_hist_state)
from repro_torch.obs.scrape import (fetch_metrics, fetch_traces, find_series,
                                    hist_state_from_rows, parse_prometheus)
from repro_torch.obs.trace import (TRACER, TraceContext, Tracer, new_trace_id,
                                   trace_dump)

__all__ = [
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricsServer",
    "TRACER",
    "TraceContext",
    "Tracer",
    "default_latency_buckets_us",
    "diff_hist_states",
    "fetch_metrics",
    "fetch_traces",
    "find_series",
    "get_registry",
    "hist_state_from_rows",
    "merge_hist_states",
    "new_trace_id",
    "parse_prometheus",
    "render_prometheus",
    "start_metrics_server",
    "summarize_hist_state",
    "trace_dump",
]
