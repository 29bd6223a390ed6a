"""Scrape side: read a ``--metrics-port`` endpoint back into states.

A shard server exports its registry as Prometheus text
(:mod:`repro_torch.obs.http`); a caller that checks counts or merges
latency needs the *states* back, as the ``stats`` RPC's metrics extension
gives them. The text is lossless for that: cumulative ``_bucket{le=...}``
counts de-cumulate to exact per-bucket counts and ``_sum`` rides along, so
a scraped histogram equals the server's own ``Histogram.state()``.

Stdlib only.
"""

from __future__ import annotations

import json
import re
import urllib.request

_SERIES_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')


def fetch_text(url: str, timeout: float = 5.0) -> str:
    """GET one exposition or trace endpoint (``http://host:port/metrics``)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8")


def fetch_metrics(host: str, port: int, timeout: float = 5.0) -> str:
    return fetch_text(f"http://{host}:{port}/metrics", timeout=timeout)


def fetch_traces(host: str, port: int, n: int = 16,
                 timeout: float = 5.0) -> list[dict]:
    """The server's slow-request log over HTTP (what OP_TRACE_DUMP gives)."""
    return json.loads(fetch_text(f"http://{host}:{port}/traces?n={int(n)}",
                                 timeout=timeout))


def _unescape(v: str) -> str:
    return v.replace("\\n", "\n").replace('\\"', '"').replace("\\\\", "\\")


def _parse_labels(raw: str | None) -> dict:
    if not raw:
        return {}
    return {m.group("k"): _unescape(m.group("v"))
            for m in _LABEL_RE.finditer(raw)}


def parse_prometheus(text: str) -> list[dict]:
    """Exposition text -> the registry ``snapshot()`` row shape.

    Counters and gauges become ``{"type", "name", "labels", "value"}`` rows;
    a histogram's ``_bucket``/``_sum``/``_count`` lines become one
    ``{"type": "histogram", "name", "labels", "bounds", "counts", "sum"}``
    row whose de-cumulated counts (overflow bucket included) equal the
    exporting server's ``Histogram.state()``.
    """
    typed: dict[str, str] = {}
    scalars: list[dict] = []
    hists: dict[tuple, dict] = {}  # keyed on (name, sorted non-le labels)
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                typed[parts[2]] = parts[3]
            continue
        m = _SERIES_RE.match(line)
        if not m:
            continue
        name, labels = m.group("name"), _parse_labels(m.group("labels"))
        value = float(m.group("value")) if m.group("value") != "+Inf" else 0.0
        base, _, suffix = name.rpartition("_")
        if suffix in ("bucket", "sum", "count") and typed.get(base) == "histogram":
            le = labels.pop("le", None)
            h = hists.setdefault((base, tuple(sorted(labels.items()))),
                                 {"buckets": [], "sum": 0.0})
            if suffix == "bucket":
                h["buckets"].append((le, value))
            elif suffix == "sum":
                h["sum"] = value
            continue
        scalars.append({"type": typed.get(name, "counter"), "name": name,
                        "labels": labels, "value": value})
    out = list(scalars)
    for (name, labels), h in hists.items():
        finite = sorted(((float(le), int(c)) for le, c in h["buckets"]
                         if le not in (None, "+Inf")), key=lambda bc: bc[0])
        inf = [int(c) for le, c in h["buckets"] if le == "+Inf"]
        total = inf[0] if inf else (finite[-1][1] if finite else 0)
        counts, prev = [], 0
        for _, cum in finite:
            counts.append(cum - prev)
            prev = cum
        counts.append(total - prev)  # overflow bucket
        out.append({"type": "histogram", "name": name, "labels": dict(labels),
                    "bounds": [b for b, _ in finite], "counts": counts,
                    "sum": h["sum"]})
    return out


def find_series(rows: list[dict], name: str,
                labels: dict | None = None) -> list[dict]:
    """Rows matching ``name`` whose labels contain every ``labels`` pair."""
    want = (labels or {}).items()
    return [r for r in rows
            if r["name"] == name and all(r["labels"].get(k) == str(v)
                                         for k, v in want)]


def hist_state_from_rows(rows: list[dict], name: str,
                         labels: dict | None = None) -> dict | None:
    """First matching histogram row as a mergeable ``state`` dict."""
    for r in find_series(rows, name, labels):
        if r["type"] == "histogram":
            return {"bounds": list(r["bounds"]), "counts": list(r["counts"]),
                    "sum": float(r["sum"])}
    return None
