"""Process-wide serving metrics: counters and bucketed latency histograms.

One :class:`MetricsRegistry` per process (module-level ``REGISTRY``) collects
every serving-layer metric under one naming scheme
(``repro_kernel_decode_batches_total{path="cuda"}`` …) and exports them as a
JSON snapshot in which instruments sharing a ``(name, labels)`` identity are
summed, exactly like scraping N collectors. Each store owns its *own*
instruments (per-instance stats stay meaningful) and attaches them with
:meth:`MetricsRegistry.register`.

A :class:`Counter` increment takes one uncontended per-counter lock; a
:class:`Histogram` record is a bisect into fixed bucket bounds plus two adds
under a per-histogram lock. No per-sample list ever grows. Stdlib only.
"""

from __future__ import annotations

import math
import threading
from bisect import bisect_left


def default_latency_buckets_us() -> tuple[float, ...]:
    """Geometric microsecond buckets 1us..~67s (factor 2, 27 bounds)."""
    return tuple(float(1 << k) for k in range(27))


def _check_labels(labels: dict | None) -> tuple[tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared identity: ``name`` + frozen ``labels`` key."""

    def __init__(self, name: str, labels: dict | None = None):
        self.name = str(name)
        self.labels = _check_labels(labels)

    @property
    def key(self) -> tuple:
        return (self.name, self.labels)


class Counter(_Instrument):
    """Monotonic event count, exact under concurrent threads."""

    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None):
        super().__init__(name, labels)
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def state(self) -> dict:
        return {"value": self.value}


class Histogram(_Instrument):
    """Fixed-bucket latency histogram: percentiles within bucket resolution,
    constant memory. ``bounds`` are ascending finite upper bucket edges; one
    implicit overflow bucket catches everything above the last edge. Values
    are recorded in the unit the name declares (``*_us`` → microseconds —
    use :meth:`record_seconds` from ``perf_counter`` deltas)."""

    kind = "histogram"

    def __init__(self, name: str, labels: dict | None = None,
                 bounds: tuple[float, ...] | None = None):
        super().__init__(name, labels)
        self.bounds: tuple[float, ...] = tuple(
            float(b) for b in (bounds or default_latency_buckets_us()))
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly ascending")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: overflow bucket
        self.sum = 0.0
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        idx = bisect_left(self.bounds, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value

    def record_seconds(self, seconds: float) -> None:
        self.record(seconds * 1e6)

    def summary(self) -> dict:
        """p50/p99/p999, count and mean, in microseconds."""
        return summarize_hist_state(self.state())

    def state(self) -> dict:
        """JSON-serializable snapshot (the overflow bucket is ``counts[-1]``)."""
        with self._lock:
            return {"bounds": list(self.bounds), "counts": list(self.counts),
                    "sum": self.sum}


def _state_percentile(state: dict, p: float) -> float:
    bounds, counts = state["bounds"], state["counts"]
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = max(1.0, math.ceil(total * min(max(p, 0.0), 100.0) / 100.0))
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= rank:
            lo = bounds[i - 1] if i else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1] * 2
            return lo + (hi - lo) * (rank - cum) / c
        cum += c
    return bounds[-1] * 2  # unreachable; overflow upper estimate


def summarize_hist_state(state: dict | None) -> dict:
    """Snapshot -> the unified latency summary dict (us units)."""
    if not state or not sum(state["counts"]):
        return {"p50_us": 0.0, "p99_us": 0.0, "p999_us": 0.0,
                "count": 0, "mean_us": 0.0}
    n = sum(state["counts"])
    return {"p50_us": _state_percentile(state, 50.0),
            "p99_us": _state_percentile(state, 99.0),
            "p999_us": _state_percentile(state, 99.9),
            "count": n,
            "mean_us": state["sum"] / n}


class MetricsRegistry:
    """Process-wide collection of caller-owned instruments."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: list[_Instrument] = []

    def register(self, instrument: _Instrument) -> _Instrument:
        with self._lock:
            self._instruments.append(instrument)
        return instrument

    def snapshot(self) -> dict:
        """JSON-safe dump, one entry per ``(kind, name, labels)`` series:
        counters sum, histograms add their bucket counts."""
        with self._lock:
            instruments = list(self._instruments)
        series: dict[tuple, dict] = {}
        for inst in instruments:
            key = (inst.kind,) + inst.key
            state = inst.state()
            prev = series.get(key)
            if prev is None:
                series[key] = state
            elif inst.kind == "histogram":
                prev["counts"] = [a + b for a, b in
                                  zip(prev["counts"], state["counts"])]
                prev["sum"] += state["sum"]
            else:
                prev["value"] += state["value"]
        return {"metrics": [{"type": kind, "name": name, "labels": dict(labels),
                             **state}
                            for (kind, name, labels), state in series.items()]}


#: the process-wide registry every serving module exports through
REGISTRY = MetricsRegistry()
