"""Paper metrics: token gain (§3.2.2), length/frequency distributions,
cumulative coverage (Fig. 3/6/8/9/10 inputs), and the serving-metric
helpers shared by the store and the smoke run."""

from __future__ import annotations

import numpy as np

from repro_torch.core.packed import PackedDictionary


def token_gain(length: int, freq: int) -> int:
    """token_gain(t) = (l(t) - 2) * f(t) - l(t)   (paper §3.2.2).

    First term: bytes saved replacing the raw substring with a 2-byte ID;
    second term: dictionary space holding the token's content.
    """
    return (length - 2) * freq - length


def token_frequencies(tokens: np.ndarray, num_entries: int) -> np.ndarray:
    """Occurrence count per token id over a compressed stream."""
    return np.bincount(np.asarray(tokens, dtype=np.int64), minlength=num_entries)


def gain_by_token(dictionary: PackedDictionary, tokens: np.ndarray) -> np.ndarray:
    freq = token_frequencies(tokens, dictionary.num_entries)
    lens = dictionary.lens.astype(np.int64)
    return (lens - 2) * freq - lens


def gain_by_length(dictionary: PackedDictionary, tokens: np.ndarray,
                   max_len: int | None = None) -> dict[int, dict[str, int]]:
    """Cumulative gain and frequency by token length (paper Fig. 3)."""
    gains = gain_by_token(dictionary, tokens)
    freq = token_frequencies(tokens, dictionary.num_entries)
    lens = dictionary.lens.astype(np.int64)
    if max_len is None:
        max_len = int(lens.max())
    out: dict[int, dict[str, int]] = {}
    for L in range(1, max_len + 1):
        sel = lens == L
        out[L] = {"gain": int(gains[sel].sum()), "freq": int(freq[sel].sum())}
    return out


def bucket_size_histogram(dictionary: PackedDictionary) -> dict[int, int]:
    """Distribution of long-pattern bucket sizes (paper Fig. 6)."""
    sizes = dictionary.bucket_size
    if dictionary.p_len.max(initial=0) == 0:
        return {}
    uniq, cnt = np.unique(sizes, return_counts=True)
    return {int(u): int(c) for u, c in zip(uniq, cnt)}


def avg_token_length(dictionary: PackedDictionary, tokens: np.ndarray) -> float:
    """Average decoded length per token in a compressed stream (Table 1)."""
    if len(tokens) == 0:
        return 0.0
    return float(dictionary.lens[np.asarray(tokens, dtype=np.int64)].mean())


# --------------------------------------------------------- serving metrics
def latency_summary(samples_s, percentiles=(50.0, 99.0)) -> dict[str, float]:
    """Summarise a latency sample set (seconds) into mean/percentile stats
    (linear-interpolated percentiles over the observed samples)."""
    arr = np.asarray(list(samples_s), dtype=np.float64)
    if arr.size == 0:
        out = {f"p{p:g}_us": 0.0 for p in percentiles}
        out.update(count=0, mean_us=0.0)
        return out
    out = {f"p{p:g}_us": float(np.percentile(arr, p)) * 1e6
           for p in percentiles}
    out.update(count=int(arr.size), mean_us=float(arr.mean()) * 1e6)
    return out


def throughput_mib_s(nbytes: int, seconds: float) -> float:
    return nbytes / float(1 << 20) / max(seconds, 1e-12)


class LatencyReservoir:
    """Bounded latency sample store: append until full, then overwrite the
    oldest (ring)."""

    def __init__(self, max_samples: int = 65536):
        self.max_samples = int(max_samples)
        self._samples: list[float] = []
        self._pos = 0

    def record(self, seconds: float) -> None:
        if len(self._samples) < self.max_samples:
            self._samples.append(seconds)
        else:
            self._samples[self._pos % self.max_samples] = seconds
            self._pos += 1

    def summary(self, percentiles=(50.0, 99.0)) -> dict[str, float]:
        return latency_summary(self._samples, percentiles)


def cumulative_coverage(dictionary: PackedDictionary, tokens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(dictionary bytes, cumulative token coverage) sorted by frequency desc
    (paper Fig. 10): how much of the compressed stream is served by the top-k
    most frequent tokens, vs the dictionary bytes needed to hold them."""
    freq = token_frequencies(tokens, dictionary.num_entries)
    order = np.argsort(-freq, kind="stable")
    mem = np.cumsum(dictionary.lens.astype(np.int64)[order])
    cov = np.cumsum(freq[order]) / max(1, len(tokens))
    return mem, cov
