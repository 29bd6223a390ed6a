"""SLO gating: server-side truth, merged across shards, diffed to the run.

The driver's own latencies include client scheduling noise; the gate
instead reads each shard server's ``repro_service_request_latency_us``
histogram — snapshotted before and after the run, bucket-diffed
(:func:`diff_hist_states`) so only *this run's* traffic is judged, then
pooled across shards (:func:`merge_hist_states`) into one exact
distribution. Collection rides whichever surface the deployment offers:
the ``stats`` RPC metrics extension for live shard connections, or the
``--metrics-port`` Prometheus scrape for anything that can reach HTTP.

On violation the report carries a ``trace_dump`` excerpt from the worst
shard — the gate doesn't just say "p99 blew the budget", it shows the
slowest requests' span trees from the server that served them.

The series names are the reference's, so the same collection reads shard
servers of either package; the in-process fallback reads the port's
:data:`repro_torch.obs.REGISTRY`.
"""

from __future__ import annotations

import json
import os

from repro_torch.loadgen.driver import RunResult
from repro_torch.loadgen.spec import WorkloadSpec
from repro_torch.obs import (REGISTRY, diff_hist_states, fetch_metrics,
                             fetch_traces, hist_state_from_rows,
                             merge_hist_states, parse_prometheus,
                             summarize_hist_state)

SERVER_HIST = "repro_service_request_latency_us"


# --------------------------------------------------------------- collection
def shard_clients(client) -> list | None:
    """The per-shard RPC clients under a connected ``StoreClient``, or
    ``None`` for in-process backends (no server to ask)."""
    backend = getattr(client, "backend", client)
    clients = getattr(backend, "clients", None)
    if clients and all(hasattr(c, "stats") for c in clients):
        return list(clients)
    return None


def _rows_from_stats(stats: dict) -> list[dict]:
    m = stats.get("metrics") or {}
    return m.get("metrics", m if isinstance(m, list) else [])


def collect_rpc_states(clients, name: str = SERVER_HIST) -> list[dict | None]:
    """Per-shard histogram states via the ``stats`` RPC metrics extension."""
    out = []
    for c in clients:
        try:
            rows = _rows_from_stats(c.stats(metrics=True))
            out.append(hist_state_from_rows(rows, name))
        except (OSError, ConnectionError):
            out.append(None)
    return out


def collect_scrape_states(metrics_addrs, name: str = SERVER_HIST,
                          timeout: float = 5.0) -> list[dict | None]:
    """Per-shard states via ``--metrics-port`` Prometheus scrape
    (``metrics_addrs``: ``[(host, port), ...]``)."""
    out = []
    for host, port in metrics_addrs:
        try:
            rows = parse_prometheus(fetch_metrics(host, port, timeout=timeout))
            out.append(hist_state_from_rows(rows, name))
        except (OSError, ConnectionError):
            out.append(None)
    return out


def collect_local_state(name: str = SERVER_HIST) -> list[dict | None]:
    """In-process fallback: the same series from this process's registry
    (shard:// and file:// backends run their service locally)."""
    rows = REGISTRY.snapshot()["metrics"]
    return [hist_state_from_rows(rows, name)]


def snapshot_server_states(client, metrics_addrs=None) -> list[dict | None]:
    """One before/after snapshot: RPC extension when the backend is remote,
    HTTP scrape when only metrics ports are known, local registry otherwise."""
    clients = shard_clients(client)
    if clients is not None:
        return collect_rpc_states(clients)
    if metrics_addrs:
        return collect_scrape_states(metrics_addrs)
    return collect_local_state()


# ------------------------------------------------------------------- gating
def fraction_under(state: dict | None, threshold_us: float) -> float:
    """Fraction of recorded samples at or under ``threshold_us`` (linear
    interpolation inside the straddling bucket, like the percentile read)."""
    if not state:
        return 0.0
    bounds, counts = state["bounds"], state["counts"]
    total = sum(counts)
    if total == 0:
        return 0.0
    under, lo = 0.0, 0.0
    for i, c in enumerate(counts):
        hi = bounds[i] if i < len(bounds) else float("inf")
        if hi <= threshold_us:
            under += c
        elif lo < threshold_us < hi:
            under += c * (threshold_us - lo) / (hi - lo)
            break
        else:
            break
        lo = hi
    return under / total


def _trace_excerpt(clients, worst_shard: int, metrics_addrs=None,
                   n: int = 5) -> list[dict]:
    try:
        if clients is not None:
            return clients[worst_shard].trace_dump(n)
        if metrics_addrs:
            host, port = metrics_addrs[worst_shard]
            return fetch_traces(host, port, n)
    except (OSError, ConnectionError, IndexError):
        pass
    return []


def build_report(spec: WorkloadSpec, result: RunResult,
                 before: list[dict | None], after: list[dict | None],
                 client=None, metrics_addrs=None) -> dict:
    """The run verdict: merged server percentiles, goodput under the SLO,
    per-shard breakdown, violations (each with a trace excerpt from the
    worst shard), and the client-side view for cross-checking."""
    slo = spec.slo
    deltas = [diff_hist_states(a, b)
              for a, b in zip(after, before)] if after else []
    merged = merge_hist_states(deltas)
    server = summarize_hist_state(merged)

    per_shard = []
    worst_shard, worst_p99 = 0, -1.0
    for k, d in enumerate(deltas):
        s = summarize_hist_state(d)
        per_shard.append({"shard": k, **{key: round(v, 1) if isinstance(v, float)
                                         else v for key, v in s.items()}})
        if s["p99_us"] > worst_p99:
            worst_shard, worst_p99 = k, s["p99_us"]

    goodput_frac = (fraction_under(merged, slo.p99_ms * 1e3)
                    if slo.p99_ms is not None else 1.0)
    goodput_rps = goodput_frac * result.achieved_rate

    violations = []
    for attr, pct in (("p50_ms", "p50_us"), ("p99_ms", "p99_us"),
                      ("p999_ms", "p999_us")):
        limit_ms = getattr(slo, attr)
        if limit_ms is not None and server[pct] > limit_ms * 1e3:
            violations.append({
                "slo": attr, "limit_ms": limit_ms,
                "observed_ms": round(server[pct] / 1e3, 3),
                "worst_shard": worst_shard})
    if goodput_frac < slo.min_goodput:
        violations.append({"slo": "min_goodput", "limit": slo.min_goodput,
                           "observed": round(goodput_frac, 4),
                           "worst_shard": worst_shard})
    if result.error_rate > slo.max_error_rate:
        violations.append({"slo": "max_error_rate",
                           "limit": slo.max_error_rate,
                           "observed": round(result.error_rate, 6),
                           "worst_shard": worst_shard})

    if violations:
        excerpt = _trace_excerpt(shard_clients(client) if client else None,
                                 worst_shard, metrics_addrs)
        for v in violations:
            v["trace_excerpt"] = excerpt

    return {
        "spec": spec.to_dict(),
        "run": result.summary(),
        "server_latency": {k: round(v, 1) if isinstance(v, float) else v
                           for k, v in server.items()},
        "per_shard": per_shard,
        "goodput": {"fraction_under_slo": round(goodput_frac, 4),
                    "rps_under_slo": round(goodput_rps, 1)},
        "slo": slo.to_dict(),
        "violations": violations,
        "passed": not violations,
    }


def write_report(path: str, report: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2, sort_keys=False)
        fh.write("\n")
    os.replace(tmp, path)
