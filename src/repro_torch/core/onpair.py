"""OnPair / OnPair16 — the paper's core contribution (§3).

Training phase (§3.2): a *single sequential pass* over a shuffled random
sample. The sample is tokenised with the current dictionary via longest
prefix matching; adjacent token-pair frequencies are counted in a local hash
map, and when a pair's count reaches the threshold the pair is merged into a
new token. The new token immediately replaces the last parsed token so that
subsequent pair counting continues with it (Figure 1), and it becomes
matchable for the rest of the pass. Training halts when the dictionary
reaches 65,536 tokens or the sample is exhausted.

Parsing phase (§3.3): every string is independently greedily tokenised into
2-byte token IDs — this per-string independence is what gives O(1) random
access with no block overhead.

OnPair16 (§3.2.2, §3.4.4): entries bounded to 16 bytes and long-pattern
buckets bounded to 128 suffixes, enabling the fixed-size-copy decoder that
the device kernels run. Unbounded OnPair (the paper's higher-ratio row) has
no kernel: :class:`OnPairCompressor` runs both variants on the host, as the
reference does.

Training is host-side and sequential by nature; the same seed gives the
same entries as the reference trainer, and the codec the same payloads.
"""

from __future__ import annotations

import math
import time
from dataclasses import asdict, dataclass

import numpy as np

from repro_torch.core.api import (CompressedCorpus, StringCompressor,
                                  TrainStats, pack_corpus)
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.lpm import DynamicLPM, lpm_from_entries, parse_batch
from repro_torch.core.packed import PackedDictionary

MAX_TOKENS = 65536  # 2-byte token IDs (paper §3.1)


@dataclass
class OnPairConfig:
    max_tokens: int = MAX_TOKENS
    #: maximum dictionary entry length; None = unbounded (OnPair),
    #: 16 = OnPair16 (§3.2.2).
    max_entry_len: int | None = None
    #: maximum suffixes per long-pattern bucket; None = unbounded (OnPair),
    #: 128 = OnPair16 (§3.4.4).
    max_bucket: int | None = None
    #: pair-frequency threshold; None = auto max(2, floor(log2(S_MiB))) (§3.2.1).
    threshold: int | None = None
    #: training-sample budget in bytes; the paper trains on a small random
    #: sample and stops early once the dictionary is full.
    sample_bytes: int = 8 << 20
    seed: int = 0

    @staticmethod
    def onpair(**kw) -> "OnPairConfig":
        return OnPairConfig(**kw)

    @staticmethod
    def onpair16(**kw) -> "OnPairConfig":
        kw.setdefault("max_entry_len", 16)
        kw.setdefault("max_bucket", 128)
        return OnPairConfig(**kw)

    @property
    def codec_name(self) -> str:
        return "onpair16" if self.max_entry_len == 16 else "onpair"


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
                     dataset_bytes: int | None = None,
                     sample_order: np.ndarray | None = None) -> TrainResult:
    """Single-pass OnPair dictionary construction (§3.2, Figure 1)."""
    if dataset_bytes is None:
        dataset_bytes = sum(len(s) for s in strings)
    threshold = cfg.threshold if cfg.threshold is not None else auto_threshold(dataset_bytes)

    # Randomly selected, shuffled sample (§3.2): expose the trainer to global
    # rather than local patterns, since construction halts when the dict fills.
    if sample_order is None:
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


class OnPairCompressor(StringCompressor):
    """Field-level compressor API over the OnPair training/parsing phases."""

    def __init__(self, cfg: OnPairConfig | None = None, variant16: bool = False):
        if cfg is None:
            cfg = OnPairConfig.onpair16() if variant16 else OnPairConfig.onpair()
        self.cfg = cfg
        self.name = cfg.codec_name
        self.dictionary: PackedDictionary | None = None
        self._lpm: DynamicLPM | None = None
        self.train_result: TrainResult | None = None
        self._train_stats: TrainStats | None = None

    # ---------------------------------------------------------------- artifact
    def to_artifact(self) -> DictArtifact:
        """Freeze the trained dictionary into a serializable artifact."""
        assert self.dictionary is not None, "train() first"
        stats = asdict(self._train_stats) if self._train_stats else {}
        return DictArtifact.from_entries(self.name, self.dictionary.entries,
                                         config=asdict(self.cfg), stats=stats)

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "OnPairCompressor":
        """Ready-to-use codec from an artifact — rebuilds the decode layout;
        the parsing LPM is rebuilt lazily on first compress()."""
        cfg = OnPairConfig(**artifact.config) if artifact.config else (
            OnPairConfig.onpair16() if artifact.codec == "onpair16"
            else OnPairConfig.onpair())
        comp = cls(cfg)
        comp.dictionary = PackedDictionary.build(artifact.entries)
        return comp

    def _parser(self) -> DynamicLPM:
        """The greedy-parse LPM; rebuilt from the frozen dictionary when this
        codec was reconstructed from an artifact (decode-only paths never
        pay this cost)."""
        if self._lpm is None:
            assert self.dictionary is not None, "train() first"
            self._lpm = lpm_from_entries(self.dictionary.entries)
        return self._lpm

    # ------------------------------------------------------------------ train
    def train(self, strings: list[bytes], dataset_bytes: int | None = None) -> TrainStats:
        t0 = time.perf_counter()
        result = train_dictionary(strings, self.cfg, dataset_bytes=dataset_bytes)
        self.train_result = result
        self._lpm = result.lpm
        self.dictionary = PackedDictionary.build(result.entries)
        dt = time.perf_counter() - t0
        self._train_stats = TrainStats(
            train_seconds=dt,
            sample_bytes=result.scanned_bytes,
            dict_entries=len(result.entries),
            dict_data_bytes=self.dictionary.data_bytes,
            dict_total_bytes=self.dictionary.total_bytes,
        )
        return self._train_stats

    # --------------------------------------------------------------- compress
    def compress(self, strings: list[bytes]) -> CompressedCorpus:
        # Batch-first: one vectorised table walk over the frozen dictionary
        # for the whole batch (paper §3.3 parse, shared across strings).
        # Only bounded dictionaries take it: the <=16-byte entry bound keeps
        # the match loop rectangular (no per-hit tail verification). Single
        # strings and unbounded dictionaries stay on the per-string dynamic
        # parser.
        if (self.dictionary is not None and self.dictionary.variant16
                and len(strings) >= 2):
            payload, counts = parse_batch(self.dictionary, strings)
            offsets = np.zeros(len(strings) + 1, dtype=np.int64)
            np.cumsum(counts * 2, out=offsets[1:])
            return CompressedCorpus(payload=payload.view(np.uint8),
                                    offsets=offsets,
                                    raw_bytes=sum(map(len, strings)),
                                    meta={"compressor": self.name})
        parse = self._parser().parse
        parts: list[bytes] = []
        raw = 0
        for s in strings:
            raw += len(s)
            ids = parse(s)
            parts.append(np.asarray(ids, dtype="<u2").tobytes())
        return pack_corpus(parts, raw, compressor=self.name)

    def compress_string(self, s: bytes) -> bytes:
        return np.asarray(self._parser().parse(s), dtype="<u2").tobytes()

    # ------------------------------------------------------------- decompress
    def decompress_all(self, corpus: CompressedCorpus) -> bytes:
        """Full-corpus decode. Strings are independent token streams of u16
        IDs, so the concatenated payload is itself one token stream — decoded
        with the vectorised Algorithm 3 (PackedDictionary.decode_tokens)."""
        assert self.dictionary is not None
        tokens = corpus.payload.view("<u2")
        return self.dictionary.decode_tokens(np.asarray(tokens))

    def access(self, corpus: CompressedCorpus, i: int) -> bytes:
        """Random access: one string's token slice through the vectorised
        Algorithm 3 decoder (no per-token Python loop)."""
        assert self.dictionary is not None
        return self.dictionary.decode_tokens(corpus.string_tokens(i))


def make_onpair(sample_bytes: int = 8 << 20, seed: int = 0,
                threshold: int | None = None, max_tokens: int = MAX_TOKENS) -> OnPairCompressor:
    return OnPairCompressor(OnPairConfig.onpair(
        sample_bytes=sample_bytes, seed=seed, threshold=threshold, max_tokens=max_tokens))


def make_onpair16(sample_bytes: int = 8 << 20, seed: int = 0,
                  threshold: int | None = None, max_tokens: int = MAX_TOKENS) -> OnPairCompressor:
    return OnPairCompressor(OnPairConfig.onpair16(
        sample_bytes=sample_bytes, seed=seed, threshold=threshold, max_tokens=max_tokens))
