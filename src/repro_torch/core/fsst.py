"""FSST-like baseline (paper §2.4, Boncz et al. VLDB'20).

Fast Static Symbol Table: up to 255 substrings of <= 8 bytes mapped to 1-byte
codes; code 255 is an escape followed by one literal byte. The table is built
bottom-up over a sample in a few generations: (1) parse the sample with the
current table selecting longest matches, (2) re-select the 255 symbols with
the highest apparent gain (frequency x length) among current symbols and
concatenations of adjacent matches.

This mirrors FSST's published construction closely enough to reproduce its
trade-off (very fast, table fits L1, but <= 8-byte symbols cap the ratio);
AVX-512 encode and lossy perfect hashing are CPU-specific mechanics not
emulated here — the decode fast path is the vectorised analogue (grouped fixed-size row copies out of a (256, 8) table).
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from repro_torch.core.api import CompressedCorpus, StringCompressor, TrainStats, pack_corpus
from repro_torch.core.artifact import DictArtifact

ESCAPE = 255
_ARANGE8 = np.arange(8, dtype=np.int64)


class _Matcher:
    """Greedy longest-match over <= 8-byte symbols, with escape fallback."""

    def __init__(self, table: list[bytes]):
        # (packed u64 LE value, length) -> code
        self.map: dict[tuple[int, int], int] = {}
        for code, sym in enumerate(table):
            self.map[(int.from_bytes(sym, "little"), len(sym))] = code

    def parse(self, s: bytes) -> bytearray:
        out = bytearray()
        get = self.map.get
        pos, n = 0, len(s)
        while pos < n:
            max_len = n - pos
            if max_len > 8:
                max_len = 8
            val = int.from_bytes(s[pos : pos + max_len], "little")
            length = max_len
            while length > 0:
                code = get((val, length))
                if code is not None:
                    out.append(code)
                    pos += length
                    break
                length -= 1
                val &= (1 << (8 * length)) - 1
            else:
                out.append(ESCAPE)
                out.append(s[pos])
                pos += 1
        return out

    def parse_symbols(self, s: bytes) -> list[bytes]:
        """Like parse but yields the matched substrings (training use)."""
        syms: list[bytes] = []
        pos, n = 0, len(s)
        while pos < n:
            max_len = min(8, n - pos)
            val = int.from_bytes(s[pos : pos + max_len], "little")
            length = max_len
            while length > 0:
                if (val, length) in self.map:
                    syms.append(s[pos : pos + length])
                    pos += length
                    break
                length -= 1
                val &= (1 << (8 * length)) - 1
            else:
                syms.append(s[pos : pos + 1])
                pos += 1
        return syms


def train_fsst(strings: list[bytes], sample_bytes: int = 1 << 20,
               generations: int = 5, seed: int = 0) -> list[bytes]:
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(strings))
    sample: list[bytes] = []
    budget = 0
    for idx in order:
        s = strings[int(idx)]
        if not s:
            continue
        sample.append(s)
        budget += len(s)
        if budget >= sample_bytes:
            break

    table: list[bytes] = []
    for _ in range(generations):
        matcher = _Matcher(table)
        freq: Counter[bytes] = Counter()
        pair_freq: Counter[bytes] = Counter()
        for s in sample:
            syms = matcher.parse_symbols(s)
            freq.update(syms)
            for a, b in zip(syms, syms[1:]):
                if len(a) + len(b) <= 8:
                    pair_freq[a + b] += 1
        gains: Counter[bytes] = Counter()
        for sym, f in freq.items():
            gains[sym] = f * len(sym)
        for sym, f in pair_freq.items():
            gains[sym] += f * len(sym)
        table = [sym for sym, _ in gains.most_common(255)]
    return table


def _build_decode_tables(table: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    mat8 = np.zeros((256, 8), dtype=np.uint8)
    lens = np.ones(256, dtype=np.int64)
    for code, sym in enumerate(table):
        mat8[code, : len(sym)] = np.frombuffer(sym, dtype=np.uint8)
        lens[code] = len(sym)
    return mat8, lens


def _unit_starts(codes: np.ndarray) -> np.ndarray:
    """Boolean mask of unit starts (symbol codes or escape codes).

    A maximal run of ESCAPE bytes always begins at a unit boundary (an
    encoded string never ends with a dangling escape, so end-of-string runs
    have even length and concatenation preserves parity); within a run, even
    offsets are escapes and odd offsets are escaped literal 255 bytes. A
    non-255 byte is a unit start iff it is not the literal of an odd-offset
    terminating escape.
    """
    n = codes.size
    is_esc_byte = codes == ESCAPE
    starts = np.ones(n, dtype=bool)
    if not is_esc_byte.any():
        return starts
    idx = np.nonzero(is_esc_byte)[0]
    run_break = np.empty(idx.size, dtype=bool)
    run_break[0] = True
    run_break[1:] = np.diff(idx) != 1
    run_id = np.cumsum(run_break) - 1
    run_start = idx[run_break][run_id]
    offset = idx - run_start
    literal_255 = idx[offset % 2 == 1]          # escaped literal 255 bytes
    starts[literal_255] = False
    # escapes consume their next byte: mark pos+1 of every escape as non-start
    escapes = idx[offset % 2 == 0]
    consumed = escapes + 1
    consumed = consumed[consumed < n]
    starts[consumed] = False
    return starts


class FSSTCompressor(StringCompressor):
    name = "fsst"

    def __init__(self, sample_bytes: int = 1 << 20, generations: int = 5, seed: int = 0):
        self.sample_bytes = sample_bytes
        self.generations = generations
        self.seed = seed
        self.table: list[bytes] | None = None
        self._matcher: _Matcher | None = None
        self._mat8: np.ndarray | None = None
        self._lens: np.ndarray | None = None

    def to_artifact(self) -> DictArtifact:
        assert self.table is not None, "train() first"
        cfg = {"sample_bytes": self.sample_bytes,
               "generations": self.generations, "seed": self.seed}
        return DictArtifact.from_entries("fsst", self.table, config=cfg)

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "FSSTCompressor":
        comp = cls(**artifact.config) if artifact.config else cls()
        comp.table = artifact.entries
        comp._matcher = _Matcher(comp.table)
        comp._mat8, comp._lens = _build_decode_tables(comp.table)
        return comp

    def train(self, strings, dataset_bytes=None) -> TrainStats:
        t0 = time.perf_counter()
        self.table = train_fsst(strings, self.sample_bytes, self.generations, self.seed)
        self._matcher = _Matcher(self.table)
        self._mat8, self._lens = _build_decode_tables(self.table)
        data = sum(len(s) for s in self.table)
        return TrainStats(
            train_seconds=time.perf_counter() - t0,
            sample_bytes=min(self.sample_bytes, dataset_bytes or self.sample_bytes),
            dict_entries=len(self.table),
            dict_data_bytes=data,
            dict_total_bytes=data + 4 * (len(self.table) + 1),
        )

    def compress(self, strings) -> CompressedCorpus:
        assert self._matcher is not None
        parse = self._matcher.parse
        parts, raw = [], 0
        for s in strings:
            raw += len(s)
            parts.append(bytes(parse(s)))
        return pack_corpus(parts, raw, compressor=self.name)

    def decompress_all(self, corpus) -> bytes:
        """Vectorised decode: resolve escape structure, then grouped
        fixed-size row copies (the SIMD-store analogue)."""
        assert self._mat8 is not None and self._lens is not None
        codes = corpus.payload
        if codes.size == 0:
            return b""
        starts_mask = _unit_starts(codes)
        unit_pos = np.nonzero(starts_mask)[0]
        toks = codes[unit_pos].astype(np.int64)
        is_esc = toks == ESCAPE
        lens = np.where(is_esc, 1, self._lens[toks])
        rows = self._mat8[toks]
        if is_esc.any():
            lit_pos = unit_pos[is_esc] + 1
            rows[is_esc, 0] = codes[lit_pos]
        ends = np.cumsum(lens)
        outpos = ends - lens
        out = np.zeros(int(ends[-1]) + 8, dtype=np.uint8)
        for length in np.unique(lens):
            L = int(length)
            sel = np.nonzero(lens == L)[0]
            idx = outpos[sel, None] + _ARANGE8[None, :L]
            out[idx.reshape(-1)] = rows[sel, :L].reshape(-1)
        return out[: int(ends[-1])].tobytes()

    def decode_string(self, payload: bytes) -> bytes:
        """Scalar reference decoder (oracle for the vectorised path)."""
        assert self.table is not None
        out = bytearray()
        i, n = 0, len(payload)
        while i < n:
            c = payload[i]
            if c == ESCAPE:
                out.append(payload[i + 1])
                i += 2
            else:
                out += self.table[c]
                i += 1
        return bytes(out)

    def access(self, corpus, i) -> bytes:
        return self.decode_string(corpus.string_payload(i))
