"""Byte-Pair Encoding baseline (paper §2.2) — the compression-quality anchor.

Classic corpus-level BPE: iteratively merge the globally most frequent
adjacent token pair until the dictionary holds 65,536 tokens (2-byte IDs, the
same budget as OnPair) or no pair occurs twice. This implementation is the
*efficient* classical algorithm — linked-list token stream, incremental pair
counts, a lazy max-heap, and a full pair→positions index — i.e. exactly the
"substantial computational effort … maintaining a complete record of pair
positions also demands considerable memory" cost structure the paper
contrasts OnPair against. We keep it honest: the positions index and global
statistics are real, so measured training time/memory exhibit BPE's true
profile rather than a strawman.

Encoding uses the same greedy longest-prefix-match parser as OnPair (shared
harness; the paper's field-level compressors all parse against a static
dictionary), and decoding uses the same packed-dictionary decoder.
"""

from __future__ import annotations

import heapq
import time

import numpy as np

from repro_torch.core.api import CompressedCorpus, StringCompressor, TrainStats, pack_corpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.lpm import lpm_from_entries
from repro_torch.core.packed import PackedDictionary

_SEP = -1  # string separator: pairs never span strings


def _initial_positions(keys: np.ndarray) -> dict[int, list]:
    """Group positions by pair key with one argsort (no Python-loop build)."""
    order = np.argsort(keys, kind="stable")
    sorted_keys = keys[order]
    boundaries = np.nonzero(np.diff(sorted_keys))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [len(sorted_keys)]])
    out: dict[int, list] = {}
    for s, e in zip(starts, ends):
        out[int(sorted_keys[s])] = [order[s:e]]
    return out


def train_bpe(strings: list[bytes], max_tokens: int = 65536,
              sample_bytes: int = 4 << 20, seed: int = 0,
              min_count: int = 2) -> list[bytes]:
    """Train a BPE vocabulary; returns the entry list (ids = positions)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(strings))

    # Build the token stream (sample) with separators.
    chunks: list[np.ndarray] = []
    budget = 0
    sep = np.array([_SEP], dtype=np.int32)
    for idx in order:
        s = strings[int(idx)]
        if not s:
            continue
        chunks.append(np.frombuffer(s, dtype=np.uint8).astype(np.int32))
        chunks.append(sep)
        budget += len(s)
        if budget >= sample_bytes:
            break
    if not chunks:
        return [bytes([b]) for b in range(256)]
    seq = np.concatenate(chunks)
    n = len(seq)
    nxt = np.arange(1, n + 1, dtype=np.int64)
    prv = np.arange(-1, n - 1, dtype=np.int64)

    entries: list[bytes] = [bytes([b]) for b in range(256)]

    def key_of(a: int, b: int) -> int:
        return (a << 32) | b

    # Global pair statistics + full positions index (BPE's memory cost).
    a_ids = seq[:-1]
    b_ids = seq[1:]
    valid = (a_ids >= 0) & (b_ids >= 0)
    keys = (a_ids.astype(np.int64) << 32) | b_ids.astype(np.int64)
    keys = np.where(valid, keys, -1)
    uniq, cnt = np.unique(keys[valid], return_counts=True)
    counts: dict[int, int] = {int(k): int(c) for k, c in zip(uniq, cnt)}
    positions = _initial_positions(np.where(valid, keys, np.int64(-(1 << 62))))
    positions.pop(-(1 << 62), None)

    heap: list[tuple[int, int]] = [(-c, int(k)) for k, c in counts.items() if c >= min_count]
    heapq.heapify(heap)

    def dec(a: int, b: int) -> None:
        if a < 0 or b < 0:
            return
        k = key_of(a, b)
        c = counts.get(k)
        if c:
            counts[k] = c - 1

    def inc(a: int, b: int, pos: int) -> None:
        if a < 0 or b < 0:
            return
        k = key_of(a, b)
        c = counts.get(k, 0) + 1
        counts[k] = c
        plist = positions.get(k)
        if plist is None:
            positions[k] = plist = []
        plist.append(pos)
        if c >= min_count:
            heapq.heappush(heap, (-c, k))

    while len(entries) < max_tokens and heap:
        negc, k = heapq.heappop(heap)
        c = counts.get(k, 0)
        if c < min_count:
            continue
        if -negc != c:           # stale heap entry: reinsert with true count
            heapq.heappush(heap, (-c, k))
            continue
        a, b = k >> 32, k & 0xFFFFFFFF
        new_id = len(entries)
        entries.append(entries[a] + entries[b])
        plists = positions.pop(k, [])
        counts.pop(k, None)
        for pl in plists:
            # elements are either a numpy chunk (initial index) or single ints
            it = pl.tolist() if isinstance(pl, np.ndarray) else (pl,)
            for p in it:
                if seq[p] != a:
                    continue
                q = nxt[p]
                if q >= n or seq[q] != b:
                    continue
                # merge [p]=a,[q]=b -> [p]=new_id
                left = int(prv[p])
                r = int(nxt[q])
                la = int(seq[left]) if left >= 0 else _SEP
                rb = int(seq[r]) if r < n else _SEP
                dec(la, a)
                dec(b, rb)
                seq[p] = new_id
                seq[q] = _SEP  # tombstone
                nxt[p] = r
                if r < n:
                    prv[r] = p
                inc(la, new_id, int(left))
                inc(new_id, rb, int(p))
    return entries


class BPECompressor(StringCompressor):
    name = "bpe"

    def __init__(self, max_tokens: int = 65536, sample_bytes: int = 4 << 20,
                 seed: int = 0):
        self.max_tokens = max_tokens
        self.sample_bytes = sample_bytes
        self.seed = seed
        self.dictionary: PackedDictionary | None = None
        self._lpm = None

    def to_artifact(self) -> DictArtifact:
        assert self.dictionary is not None, "train() first"
        cfg = {"max_tokens": self.max_tokens, "sample_bytes": self.sample_bytes,
               "seed": self.seed}
        return DictArtifact.from_entries("bpe", self.dictionary.entries,
                                         config=cfg)

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "BPECompressor":
        comp = cls(**artifact.config) if artifact.config else cls()
        comp.dictionary = PackedDictionary.build(artifact.entries)
        return comp

    def _parser(self):
        if self._lpm is None:
            assert self.dictionary is not None, "train() first"
            self._lpm = lpm_from_entries(self.dictionary.entries)
        return self._lpm

    def train(self, strings, dataset_bytes=None) -> TrainStats:
        t0 = time.perf_counter()
        entries = train_bpe(strings, self.max_tokens, self.sample_bytes, self.seed)
        self._lpm = lpm_from_entries(entries)
        self.dictionary = PackedDictionary.build(entries)
        return TrainStats(
            train_seconds=time.perf_counter() - t0,
            sample_bytes=min(self.sample_bytes, dataset_bytes or self.sample_bytes),
            dict_entries=len(entries),
            dict_data_bytes=self.dictionary.data_bytes,
            dict_total_bytes=self.dictionary.total_bytes,
        )

    def compress(self, strings) -> CompressedCorpus:
        parse = self._parser().parse
        parts, raw = [], 0
        for s in strings:
            raw += len(s)
            parts.append(np.asarray(parse(s), dtype="<u2").tobytes())
        return pack_corpus(parts, raw, compressor=self.name)

    def decompress_all(self, corpus) -> bytes:
        assert self.dictionary is not None
        return self.dictionary.decode_tokens(np.asarray(corpus.payload.view("<u2")))

    def access(self, corpus, i) -> bytes:
        assert self.dictionary is not None
        o0, o1 = int(corpus.offsets[i]), int(corpus.offsets[i + 1])
        tokens = corpus.payload[o0:o1].view("<u2")
        entries = self.dictionary.entries
        return b"".join(entries[t] for t in tokens)
