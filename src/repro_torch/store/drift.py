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


class DriftMonitor:
    """Achieved-vs-train-time compression ratio tracker.

    ``observe(raw, compressed)`` is called once per appended batch;
    observations accumulate until :meth:`reset`, so they cover everything
    parsed against the current dictionary since the last (re)train. When no
    train-time ratio is known (a store that started empty), the first
    ``min_bytes`` of observations seed the baseline.
    """

    def __init__(self, threshold: float = 0.2,
                 baseline_ratio: float | None = None,
                 min_bytes: int = 1 << 14):
        if not 0.0 < threshold < 1.0:
            raise ValueError(f"threshold must be in (0, 1), got {threshold}")
        self.threshold = float(threshold)
        self.baseline_ratio = baseline_ratio
        self.min_bytes = int(min_bytes)
        self.raw_bytes = 0
        self.compressed_bytes = 0
        self.observations = 0

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
        """Start a fresh observation window (after a compaction)."""
        self.baseline_ratio = baseline_ratio
        self.raw_bytes = 0
        self.compressed_bytes = 0
        self.observations = 0

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
