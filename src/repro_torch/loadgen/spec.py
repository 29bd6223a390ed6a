"""Declarative workload specs and the deterministic op schedule they expand to.

A :class:`WorkloadSpec` is the whole experiment on one page: the op mix,
the key-popularity distribution, the loop discipline (closed = fixed
concurrency, open = target arrival rate), and the :class:`SLO` the run is
gated on. Same spec + same seed ⇒ byte-identical schedule — reruns are
comparable and regressions are attributable to the code, not the dice.

The schedule is materialised up front (:func:`build_schedule`) rather than
sampled on the fly so the driver's issue loop does no RNG work on the hot
path and the determinism contract is a pure-function property that a test
can assert directly.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import NamedTuple

import numpy as np

OP_KINDS = ("get", "multiget", "scan", "locate", "scan_prefix", "append",
            "extend")
LOOPS = ("closed", "open")
DISTRIBUTIONS = ("zipf", "uniform", "sequential")

#: multiplicative scatter (Knuth's 2^32/phi) so zipf-hot ranks don't all
#: land on shard 0 — popularity stays skewed, placement becomes uniform
_SCATTER = 2654435761


class Op(NamedTuple):
    """One scheduled operation.

    ``at_s`` is the intended arrival time (open loop paces to it; closed
    loop ignores it). ``ids`` carries the target ids for reads / the scan
    ``[lo, hi)`` pair; ``n_payload`` the string count for writes.
    """

    at_s: float
    kind: str
    ids: tuple
    n_payload: int


@dataclass
class SLO:
    """The gate: merged *server-side* latency targets + delivery floors."""

    p50_ms: float | None = None
    p99_ms: float | None = 50.0
    p999_ms: float | None = None
    #: minimum fraction of requests under ``p99_ms`` (goodput floor)
    min_goodput: float = 0.0
    #: maximum fraction of errored ops
    max_error_rate: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SLO":
        return cls(**{k: d[k] for k in d if k in cls.__dataclass_fields__})


@dataclass
class WorkloadSpec:
    """Everything a run needs besides the target URL and the wall clock."""

    #: op kind -> relative weight; zero/missing kinds never issue
    mix: dict = field(default_factory=lambda: {"get": 0.7, "multiget": 0.3})
    #: key popularity over ``[0, n_strings)``
    distribution: str = "zipf"
    zipf_s: float = 1.1           # zipf exponent (>1); ignored otherwise
    multiget_fanout: int = 16
    scan_span: int = 256
    #: reverse-lookup ops: prefix length for scan_prefix queries, per-query
    #: hit cap, and the fraction of locate ops aimed at absent strings
    prefix_len: int = 4
    prefix_limit: int = 64
    locate_miss_fraction: float = 0.1
    #: tiering knobs: redirect this fraction of read keys into the coldest
    #: ``cold_band`` tail of the id space, so a tiered store sees a long
    #: tail of demoted-segment hits instead of a pure zipf head
    cold_fraction: float = 0.0
    cold_band: float = 0.5
    append_bytes: int = 64        # synthetic payload size per written string
    extend_batch: int = 32
    read_preference: str | None = None
    #: hedge point reads after this many ms; ``None`` disables hedging
    hedge_ms: float | None = None
    loop: str = "closed"
    concurrency: int = 64         # closed loop: in-flight op cap
    rate: float = 1000.0          # open loop: target arrivals per second
    seed: int = 0
    slo: SLO = field(default_factory=SLO)

    def __post_init__(self) -> None:
        if self.loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}: {self.loop!r}")
        if self.distribution not in DISTRIBUTIONS:
            raise ValueError(
                f"distribution must be one of {DISTRIBUTIONS}: "
                f"{self.distribution!r}")
        bad = [k for k in self.mix if k not in OP_KINDS]
        if bad:
            raise ValueError(f"unknown op kinds in mix: {bad}")
        if not any(w > 0 for w in self.mix.values()):
            raise ValueError("mix needs at least one positive weight")
        if not 0.0 <= self.cold_fraction <= 1.0:
            raise ValueError(
                f"cold_fraction must be in [0, 1]: {self.cold_fraction!r}")
        if not 0.0 < self.cold_band <= 1.0:
            raise ValueError(
                f"cold_band must be in (0, 1]: {self.cold_band!r}")
        if isinstance(self.slo, dict):
            self.slo = SLO.from_dict(self.slo)

    # ------------------------------------------------------------- round-trip
    def to_dict(self) -> dict:
        d = asdict(self)
        d["slo"] = self.slo.to_dict()
        return d

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        known = {k: v for k, v in d.items() if k in cls.__dataclass_fields__}
        return cls(**known)

    @classmethod
    def from_json(cls, s: str) -> "WorkloadSpec":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "WorkloadSpec":
        with open(path, encoding="utf-8") as fh:
            return cls.from_json(fh.read())


def _popularity_ids(spec: WorkloadSpec, rng: np.random.Generator,
                    n_strings: int, count: int) -> np.ndarray:
    """``count`` key ids drawn from the spec's popularity distribution."""
    if count == 0:
        return np.empty(0, dtype=np.int64)
    if spec.distribution == "uniform":
        ids = rng.integers(0, n_strings, size=count, dtype=np.int64)
    elif spec.distribution == "sequential":
        ids = np.arange(count, dtype=np.int64) % n_strings
    else:
        # zipf over ranks 1..n via the truncated CDF (exact, no rejection),
        # then rank -> id scatter so hot keys spread across shards
        ranks = min(n_strings, 1 << 20)
        pmf = 1.0 / np.power(np.arange(1, ranks + 1, dtype=np.float64),
                             spec.zipf_s)
        cdf = np.cumsum(pmf)
        cdf /= cdf[-1]
        drawn = np.searchsorted(cdf, rng.random(count), side="left")
        ids = (drawn.astype(np.int64) * _SCATTER) % n_strings
    # cold-skew redirect, drawn only when the knob is on so older specs
    # keep byte-identical schedules (same guard discipline as locate miss)
    if spec.cold_fraction > 0.0:
        band0 = int(n_strings * (1.0 - spec.cold_band))
        pick = rng.random(count) < float(spec.cold_fraction)
        k = int(pick.sum())
        if k:
            ids = ids.copy()
            ids[pick] = rng.integers(band0, n_strings, size=k,
                                     dtype=np.int64)
    return ids


def build_schedule(spec: WorkloadSpec, n_strings: int,
                   n_ops: int) -> list[Op]:
    """Expand a spec into ``n_ops`` concrete operations.

    Pure in ``(spec, n_strings, n_ops)``: one seeded generator drives kind
    choice, key choice, and (open loop) arrival jitter, so two calls with
    equal inputs return equal schedules — the reproducibility contract the
    determinism test pins down.
    """
    if n_strings <= 0:
        raise ValueError("n_strings must be positive")
    rng = np.random.default_rng(spec.seed)
    kinds = [k for k in OP_KINDS if spec.mix.get(k, 0) > 0]
    weights = np.array([spec.mix[k] for k in kinds], dtype=np.float64)
    weights /= weights.sum()
    chosen = rng.choice(len(kinds), size=n_ops, p=weights)

    # arrival times: open loop gets a deterministic exponential (Poisson)
    # schedule at the target rate; closed loop issues as fast as the
    # concurrency window drains, so arrivals are all-zero
    if spec.loop == "open":
        gaps = rng.exponential(1.0 / max(spec.rate, 1e-9), size=n_ops)
        arrivals = np.cumsum(gaps)
    else:
        arrivals = np.zeros(n_ops)

    # locate miss flags, drawn only when the mix asks for locate so specs
    # predating reverse lookup keep byte-identical schedules
    miss = np.empty(0, dtype=bool)
    if "locate" in kinds:
        n_locate = int(np.sum(chosen == kinds.index("locate")))
        miss = rng.random(n_locate) < float(spec.locate_miss_fraction)

    # reads vastly outnumber writes; draw one popularity pool and slice it
    fanout = max(1, int(spec.multiget_fanout))
    need = int(np.sum(chosen == kinds.index("get")) if "get" in kinds else 0)
    if "multiget" in kinds:
        need += fanout * int(np.sum(chosen == kinds.index("multiget")))
    for k in ("scan", "locate", "scan_prefix"):
        if k in kinds:
            need += int(np.sum(chosen == kinds.index(k)))
    pool = _popularity_ids(spec, rng, n_strings, need)

    schedule: list[Op] = []
    cursor = 0
    mcursor = 0
    span = max(1, int(spec.scan_span))
    for i, ki in enumerate(chosen):
        kind = kinds[ki]
        at = float(arrivals[i])
        if kind == "get":
            schedule.append(Op(at, kind, (int(pool[cursor]),), 0))
            cursor += 1
        elif kind == "multiget":
            ids = tuple(int(x) for x in pool[cursor:cursor + fanout])
            cursor += fanout
            schedule.append(Op(at, kind, ids, 0))
        elif kind == "scan":
            lo = int(pool[cursor]) % max(1, n_strings - span)
            cursor += 1
            schedule.append(Op(at, kind, (lo, lo + span), 0))
        elif kind == "locate":
            # ids = the stored string the driver queries with; n_payload=1
            # flags a deliberate miss (driver perturbs the query string)
            schedule.append(Op(at, kind, (int(pool[cursor]),),
                               1 if miss[mcursor] else 0))
            cursor += 1
            mcursor += 1
        elif kind == "scan_prefix":
            schedule.append(Op(at, kind, (int(pool[cursor]),), 0))
            cursor += 1
        elif kind == "append":
            schedule.append(Op(at, kind, (), 1))
        else:  # extend
            schedule.append(Op(at, kind, (), max(1, int(spec.extend_batch))))
    return schedule


def payload_strings(spec: WorkloadSpec, rng: np.random.Generator,
                    count: int) -> list[bytes]:
    """Synthetic write payloads (driver-side; not part of the schedule so
    the schedule stays cheap to build and compare)."""
    raw = rng.integers(97, 123, size=count * spec.append_bytes,
                       dtype=np.uint8)
    body = raw.tobytes()
    k = spec.append_bytes
    return [body[i * k:(i + 1) * k] for i in range(count)]
