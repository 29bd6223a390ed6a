"""Process-wide serving metrics: counters, gauges and bucketed latency histograms.

One :class:`MetricsRegistry` per process (module-level ``REGISTRY``) collects
every serving-layer metric under one naming scheme
(``repro_kernel_decode_batches_total{path="cuda"}`` …) and exports it as
Prometheus text exposition (:func:`render_prometheus`, served by
:mod:`repro_torch.obs.http`) and as a JSON snapshot (the ``stats`` RPC's
metrics extension). The names, the snapshot and the text are the
reference's, byte for byte, so one dashboard and one scraper read both.

* **Cheap on the hot path.** A :class:`Counter` increment takes one
  uncontended per-counter lock; a :class:`Histogram` record is a bisect into
  fixed bucket bounds plus two adds under a per-histogram lock. No
  per-sample list ever grows.
* **Mergeable across processes and shards.** Histograms are fixed-bucket:
  two snapshots with the same bounds merge by summing counts
  (:func:`merge_hist_states`), so per-shard latency distributions pool into
  one exact histogram.
* **Instance-isolated, process-aggregated.** Each store, service and server
  owns its *own* instruments (per-instance stats stay meaningful) and
  attaches them with :meth:`MetricsRegistry.register`; export sums
  instruments sharing a ``(name, labels)`` identity, exactly like scraping
  N collectors.

Stdlib only.
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

    def label_dict(self) -> dict:
        return dict(self.labels)


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


class Gauge(_Instrument):
    """Point-in-time value (resident bytes of a tier, queue depth)."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, dv: float) -> None:
        self.value += float(dv)

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

    @property
    def count(self) -> int:
        return sum(self.counts)

    def percentile(self, p: float) -> float:
        """Value at percentile ``p`` (0..100), linearly interpolated inside
        the bucket the rank falls in."""
        return _state_percentile(self.state(), p)

    def summary(self) -> dict:
        """p50/p99/p999, count and mean, in microseconds."""
        return summarize_hist_state(self.state())

    def state(self) -> dict:
        """JSON-serializable snapshot (the overflow bucket is ``counts[-1]``),
        the merge and transport format."""
        with self._lock:
            return {"bounds": list(self.bounds), "counts": list(self.counts),
                    "sum": self.sum}

    def merge_state(self, state: dict) -> None:
        """Fold another snapshot (same bounds) into this histogram."""
        if list(state["bounds"]) != list(self.bounds):
            raise ValueError("cannot merge histograms with different bounds")
        with self._lock:
            for i, c in enumerate(state["counts"]):
                self.counts[i] += int(c)
            self.sum += float(state["sum"])

    @classmethod
    def from_state(cls, state: dict, name: str = "",
                   labels: dict | None = None) -> "Histogram":
        h = cls(name, labels, bounds=tuple(state["bounds"]))
        h.counts = [int(c) for c in state["counts"]]
        h.sum = float(state["sum"])
        return h


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


def merge_hist_states(states) -> dict | None:
    """Pool histogram snapshots (same bounds) into one; exact — the merged
    counts equal a histogram of the pooled samples. ``None`` when no state
    was supplied."""
    merged: dict | None = None
    for state in states:
        if not state:
            continue
        if merged is None:
            merged = {"bounds": list(state["bounds"]),
                      "counts": [int(c) for c in state["counts"]],
                      "sum": float(state["sum"])}
        else:
            if list(state["bounds"]) != merged["bounds"]:
                raise ValueError(
                    "cannot merge histograms with different bounds")
            for i, c in enumerate(state["counts"]):
                merged["counts"][i] += int(c)
            merged["sum"] += float(state["sum"])
    return merged


def diff_hist_states(after: dict | None, before: dict | None) -> dict | None:
    """Bucket-wise ``after - before`` for two snapshots of the same growing
    histogram. Negative deltas (a restarted server) clamp to zero;
    ``before=None`` passes the after state through."""
    if not after:
        return None
    if not before:
        return {"bounds": list(after["bounds"]),
                "counts": [int(c) for c in after["counts"]],
                "sum": float(after["sum"])}
    if list(after["bounds"]) != list(before["bounds"]):
        raise ValueError("cannot diff histograms with different bounds")
    counts = [max(0, int(a) - int(b))
              for a, b in zip(after["counts"], before["counts"])]
    return {"bounds": list(after["bounds"]), "counts": counts,
            "sum": max(0.0, float(after["sum"]) - float(before["sum"]))}


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
    """Process-wide instrument collection: :meth:`counter` / :meth:`gauge` /
    :meth:`histogram` get or create a shared series by ``(name, labels)``;
    :meth:`register` attaches a caller-owned instrument."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: list[_Instrument] = []
        self._shared: dict[tuple, _Instrument] = {}

    def _get_or_create(self, cls, name: str, labels: dict | None, **kw):
        """The registry's one instrument of ``name`` and ``labels``, made on
        first use; the same identity as another kind raises TypeError."""
        key = (name, _check_labels(labels))
        with self._lock:
            inst = self._shared.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._shared[key] = inst
                self._instruments.append(inst)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r}{dict(key[1])} already "
                                f"registered as {inst.kind}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, bounds: tuple[float, ...] | None = None,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, bounds=bounds)

    def register(self, instrument: _Instrument) -> _Instrument:
        with self._lock:
            self._instruments.append(instrument)
        return instrument

    def unregister(self, instrument: _Instrument) -> None:
        with self._lock:
            try:
                self._instruments.remove(instrument)
            except ValueError:
                pass

    def _merged(self) -> list[tuple[str, str, tuple, dict]]:
        """(kind, name, labels, merged state) per series, in first-seen
        order: counters and gauges sum, histograms add their counts."""
        with self._lock:
            instruments = list(self._instruments)
        series: dict[tuple, dict] = {}
        for inst in instruments:
            key = (inst.kind,) + inst.key
            prev = series.get(key)
            if inst.kind == "histogram":
                series[key] = merge_hist_states([prev, inst.state()])
            elif prev is None:
                series[key] = inst.state()
            else:
                series[key] = {"value": prev["value"] + inst.value}
        return [(kind, name, labels, state)
                for (kind, name, labels), state in series.items()]

    def snapshot(self) -> dict:
        """JSON-safe dump, one entry per ``(kind, name, labels)`` series."""
        return {"metrics": [{"type": kind, "name": name, "labels": dict(labels),
                             **state}
                            for kind, name, labels, state in self._merged()]}

    def render_prometheus(self) -> str:
        return render_prometheus(self)

    def clear(self) -> None:
        """Drop every instrument (tests only — live code never resets)."""
        with self._lock:
            self._instruments.clear()
            self._shared.clear()


def _fmt_labels(labels: tuple, extra: tuple[tuple[str, str], ...] = ()) -> str:
    pairs = tuple(labels) + tuple(extra)
    if not pairs:
        return ""

    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in pairs) + "}"


def _fmt_value(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def render_prometheus(registry: MetricsRegistry) -> str:
    """Prometheus text exposition (format 0.0.4) of every series.

    Histograms emit the cumulative ``_bucket{le=...}`` series plus
    ``_sum``/``_count``; the ``le="+Inf"`` bucket equals the count.
    """
    lines: list[str] = []
    typed: set[str] = set()
    for kind, name, labels, state in registry._merged():
        if name not in typed:
            lines.append(f"# TYPE {name} {kind}")
            typed.add(name)
        if kind == "histogram":
            cum = 0
            for bound, c in zip(state["bounds"], state["counts"]):
                cum += c
                lines.append(
                    f"{name}_bucket"
                    f"{_fmt_labels(labels, (('le', _fmt_value(bound)),))}"
                    f" {cum}")
            cum += state["counts"][-1]
            lines.append(
                f"{name}_bucket{_fmt_labels(labels, (('le', '+Inf'),))} {cum}")
            lines.append(f"{name}_sum{_fmt_labels(labels)}"
                         f" {_fmt_value(state['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {cum}")
        else:
            lines.append(f"{name}{_fmt_labels(labels)}"
                         f" {_fmt_value(state['value'])}")
    return "\n".join(lines) + "\n"


#: the process-wide registry every serving module exports through
REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
