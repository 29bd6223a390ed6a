"""OnPair16 training — the paper's core contribution (§3).

Training phase (§3.2): a *single sequential pass* over a shuffled random
sample. The sample is tokenised with the current dictionary via longest
prefix matching; adjacent token-pair frequencies are counted in a local hash
map, and when a pair's count reaches the threshold the pair is merged into a
new token. The new token immediately replaces the last parsed token so that
subsequent pair counting continues with it (Figure 1), and it becomes
matchable for the rest of the pass. Training halts when the dictionary
reaches 65,536 tokens or the sample is exhausted.

OnPair16 (§3.2.2, §3.4.4): entries bounded to 16 bytes and long-pattern
buckets bounded to 128 suffixes, enabling the fixed-size-copy decoder.

Host-side and sequential by nature; the same seed gives the same entries as
the reference trainer.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.core.lpm import DynamicLPM

MAX_TOKENS = 65536  # 2-byte token IDs (paper §3.1)


@dataclass
class OnPairConfig:
    max_tokens: int = MAX_TOKENS
    #: maximum dictionary entry length; 16 = OnPair16 (§3.2.2).
    max_entry_len: int | None = None
    #: maximum suffixes per long-pattern bucket; 128 = OnPair16 (§3.4.4).
    max_bucket: int | None = None
    #: pair-frequency threshold; None = auto max(2, floor(log2(S_MiB))) (§3.2.1).
    threshold: int | None = None
    #: training-sample budget in bytes; the paper trains on a small random
    #: sample and stops early once the dictionary is full.
    sample_bytes: int = 8 << 20
    seed: int = 0

    @staticmethod
    def onpair16(**kw) -> "OnPairConfig":
        kw.setdefault("max_entry_len", 16)
        kw.setdefault("max_bucket", 128)
        return OnPairConfig(**kw)


def auto_threshold(dataset_bytes: int) -> int:
    """threshold = max(2, floor(log2(S))) with S in MiB (§3.2.1)."""
    mib = dataset_bytes / float(1 << 20)
    if mib <= 1.0:
        return 2
    return max(2, int(math.floor(math.log2(mib))))


@dataclass
class TrainResult:
    entries: list[bytes]
    lpm: DynamicLPM
    scanned_bytes: int
    scanned_strings: int
    threshold: int
    merges_attempted: int
    merges_accepted: int


def train_dictionary(strings: list[bytes], cfg: OnPairConfig,
                     dataset_bytes: int | None = None) -> TrainResult:
    """Single-pass OnPair dictionary construction (§3.2, Figure 1)."""
    if dataset_bytes is None:
        dataset_bytes = sum(len(s) for s in strings)
    threshold = cfg.threshold if cfg.threshold is not None else auto_threshold(dataset_bytes)

    # Randomly selected, shuffled sample (§3.2): expose the trainer to global
    # rather than local patterns, since construction halts when the dict fills.
    sample_order = np.random.default_rng(cfg.seed).permutation(len(strings))

    entries: list[bytes] = [bytes([b]) for b in range(256)]
    entry_index: set[bytes] = set(entries)
    lpm = DynamicLPM()
    for tid, e in enumerate(entries):
        lpm.insert(e, tid)

    # Local pair-frequency map: (prev_token, cur_token) -> count.
    # A count of -1 marks a pair as finalised (already merged, or rejected by
    # the OnPair16 bounds) so it is never re-attempted.
    counts: dict[tuple[int, int], int] = {}
    max_entry = cfg.max_entry_len
    max_bucket = cfg.max_bucket

    scanned = 0
    scanned_strings = 0
    attempted = accepted = 0
    full = len(entries) >= cfg.max_tokens
    search = lpm.search

    for idx in sample_order:
        if full or scanned >= cfg.sample_bytes:
            break
        s = strings[int(idx)]
        if not s:
            continue
        scanned += len(s)
        scanned_strings += 1
        prev = -1
        pos = 0
        n = len(s)
        while pos < n:
            tid, length = search(s, pos)
            pos += length
            if prev >= 0 and not full:
                key = (prev, tid)
                c = counts.get(key, 0)
                if c >= 0:
                    c += 1
                    if c >= threshold:
                        attempted += 1
                        new_bytes = entries[prev] + entries[tid]
                        ok = True
                        if max_entry is not None and len(new_bytes) > max_entry:
                            ok = False
                        elif new_bytes in entry_index:
                            ok = False
                        elif (max_bucket is not None and len(new_bytes) > 8
                              and lpm.bucket_size(new_bytes) >= max_bucket):
                            ok = False
                        if ok:
                            new_tid = len(entries)
                            entries.append(new_bytes)
                            entry_index.add(new_bytes)
                            lpm.insert(new_bytes, new_tid)
                            accepted += 1
                            # Figure 1: the last parsed token is replaced by
                            # the merged token; pair counting continues with it.
                            tid = new_tid
                            if len(entries) >= cfg.max_tokens:
                                full = True
                        counts[key] = -1
                    else:
                        counts[key] = c
            prev = tid

    return TrainResult(entries=entries, lpm=lpm, scanned_bytes=scanned,
                       scanned_strings=scanned_strings, threshold=threshold,
                       merges_attempted=attempted, merges_accepted=accepted)
