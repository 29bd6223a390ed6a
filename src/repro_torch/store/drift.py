"""Compression-ratio drift monitoring for writable stores.

A frozen dictionary keeps compressing incoming strings well only while they
look like the data it was trained on. :class:`DriftMonitor` watches the
achieved ratio of appended strings against the ratio at train time and
answers one question, ``should_compact()``, which the writable store turns
into a re-train and rewrite
(:meth:`repro_torch.store.mutable.MutableStringStore.compact`).

Drift is the fractional degradation of the ratio::

    drift = max(0, 1 - observed_ratio / baseline_ratio)

so ``threshold=0.2`` means "compact when appended data compresses 20% worse
than the training-time corpus did". A minimum observed-bytes floor keeps a
handful of unlucky strings from triggering a full rewrite.
"""

from __future__ import annotations

from time import perf_counter as _perf_counter

import numpy as np


class DriftMonitor:
    """Achieved-vs-train-time compression ratio tracker.

    ``observe(raw, compressed)`` is called once per appended batch;
    observations accumulate until :meth:`reset`, so they cover everything
    parsed against the current dictionary since the last (re)train. When no
    train-time ratio is known (a store that started empty), the first
    ``min_bytes`` of observations seed the baseline.

    It also keeps each sealed segment's read rate, an exponentially decayed
    count of its reads: the temperature that the cold tier
    (:mod:`repro_torch.store.tier`) demotes and promotes by.
    """

    def __init__(self, threshold: float = 0.2,
                 baseline_ratio: float | None = None,
                 min_bytes: int = 1 << 14,
                 read_halflife_s: float = 30.0):
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must be in (0, 1), got {threshold}")
        self.threshold = float(threshold)
        self.baseline_ratio = baseline_ratio
        self.min_bytes = int(min_bytes)
        self.raw_bytes = 0
        self.compressed_bytes = 0
        self.observations = 0
        # segment index -> [decayed read count, time of its last update]
        self.read_halflife_s = float(read_halflife_s)
        self._read_ewma: dict[int, list[float]] = {}

    def observe(self, raw_bytes: int, compressed_bytes: int) -> None:
        self.raw_bytes += int(raw_bytes)
        self.compressed_bytes += int(compressed_bytes)
        self.observations += 1
        if self.baseline_ratio is None and self.raw_bytes >= self.min_bytes:
            # no train-time ratio was known (the store started empty): the
            # first min_bytes of appends seed the baseline, so a later shift
            # still trips should_compact()
            self.baseline_ratio = self.observed_ratio
            self.raw_bytes = 0
            self.compressed_bytes = 0
            self.observations = 0

    def reset(self, baseline_ratio: float | None = None) -> None:
        """Start a fresh observation window (after a compaction). The read
        rates reset too: segment indexes belong to the rewritten generation."""
        self.baseline_ratio = baseline_ratio
        self.raw_bytes = 0
        self.compressed_bytes = 0
        self.observations = 0
        self._read_ewma.clear()

    # The decayed count C halves every ``read_halflife_s`` idle seconds; the
    # steady rate it converges to is ``C * ln2 / halflife`` reads/s.
    _LN2 = 0.6931471805599453

    def note_reads(self, counts: dict[int, int],
                   now: float | None = None) -> None:
        """Fold ``{segment_index: reads}`` from one batched lookup into the
        per-segment rates. ``now`` is a ``time.perf_counter()`` timestamp
        (tests pass their own clock)."""
        if now is None:
            now = _perf_counter()
        for seg, c in counts.items():
            ent = self._read_ewma.get(seg)
            if ent is None:
                self._read_ewma[seg] = [float(c), now]
            else:
                dt = max(0.0, now - ent[1])
                ent[0] = ent[0] * 0.5 ** (dt / self.read_halflife_s) + c
                ent[1] = now

    def read_rate(self, seg: int, now: float | None = None) -> float:
        """Decay-weighted reads/s of one segment (0.0 if never read)."""
        ent = self._read_ewma.get(seg)
        if ent is None:
            return 0.0
        if now is None:
            now = _perf_counter()
        decayed = ent[0] * 0.5 ** (max(0.0, now - ent[1])
                                   / self.read_halflife_s)
        return decayed * self._LN2 / self.read_halflife_s

    def read_rates(self, now: float | None = None) -> dict[int, float]:
        """Read rate of every segment that has ever been read."""
        if now is None:
            now = _perf_counter()
        return {seg: self.read_rate(seg, now=now) for seg in self._read_ewma}

    @property
    def observed_ratio(self) -> float | None:
        if self.compressed_bytes == 0:
            return None
        return self.raw_bytes / self.compressed_bytes

    @property
    def drift(self) -> float:
        """Fractional ratio degradation vs the baseline (0.0 = no drift)."""
        obs = self.observed_ratio
        if obs is None or not self.baseline_ratio:
            return 0.0
        return max(0.0, 1.0 - obs / self.baseline_ratio)

    def should_compact(self) -> bool:
        """True once enough appended bytes compress badly enough."""
        return self.raw_bytes >= self.min_bytes and self.drift > self.threshold

    def snapshot(self) -> dict:
        return {"baseline_ratio": self.baseline_ratio,
                "observed_ratio": self.observed_ratio,
                "drift": round(self.drift, 4),
                "threshold": self.threshold,
                "observed_raw_bytes": self.raw_bytes,
                "observed_compressed_bytes": self.compressed_bytes,
                "observations": self.observations,
                "should_compact": self.should_compact()}


def segment_ratio(entry_lens: np.ndarray, segment) -> float:
    """Achieved compression ratio of one sealed segment, from its token
    stream alone (decoded length = sum of its tokens' entry lengths)."""
    if segment.payload_bytes == 0:
        return 1.0
    tokens = np.asarray(segment.tokens(), dtype=np.int64)
    raw = int(np.asarray(entry_lens)[tokens].astype(np.int64).sum())
    return raw / segment.payload_bytes


def segment_report(store) -> list[dict]:
    """Per-segment achieved ratios of a store, and each one's drift from the
    writable store's baseline: which sealed segments a compaction would
    rewrite most profitably."""
    drift = getattr(store, "drift", None)
    base = drift.baseline_ratio if drift is not None else None
    lens = store._device.host_lens
    rows = []
    for seg in store.segments.segments:
        r = segment_ratio(lens, seg)
        rows.append({"segment": seg.index, "base_id": seg.base_id,
                     "n_strings": seg.n_strings, "ratio": round(r, 4),
                     "drift": round(max(0.0, 1.0 - r / base), 4)
                     if base else 0.0})
    return rows
