"""Frozen OnPair/OnPair16 dictionary: decode layout + static LPM arrays
(paper §3.4.3, §3.5, Fig. 5/7).

After training, the dictionary is frozen into:

* the decode layout of Figure 7 — a contiguous byte blob + offsets, plus the
  OnPair16 fast-decode matrix: a ``(N, 16)`` u8 table so every token decodes
  with one fixed-size row copy (Algorithm 3's unconditional 16-byte copy);

* the static LPM layout of Figure 5 as flat parallel arrays with
  open-addressing hash tables, so lookups are plain loads and probing is a
  bounded loop. Packed u64 values are stored as (lo, hi) u32 pairs.

Every array is bit-identical to the reference's ``PackedDictionary``, for
bounded (OnPair16) and unbounded (OnPair, BPE) dictionaries alike (the tests
pin that field by field). The device kernels read the decode matrix and the
short and prefix tiers of OnPair16 dictionaries; the host codecs read the
rest: the suffix masks and the exact long-entry table feed the host batch
parse (:func:`repro_torch.core.lpm.parse_batch`), and ``decode_tokens`` /
``decode_string`` are the host decode, which also serves entries longer
than 16 bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.artifact import DictArtifact

_ARANGE16 = np.arange(16, dtype=np.int64)

U32 = np.uint32
_M32 = 0xFFFFFFFF


def mix32(x: int) -> int:
    """32-bit finaliser (murmur3-style); the kernels compute it identically."""
    x &= _M32
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def hash_key(lo: int, hi: int, length: int) -> int:
    """Hash of a packed (lo, hi, len) key; the kernels must match it exactly."""
    return mix32(lo ^ mix32(hi ^ mix32(length)))


def hash_key_long(lo: int, hi: int, lo2: int, hi2: int, length: int) -> int:
    """Hash of a full 16-byte packed key (bounded long entries); must match
    the vectorised probe in core.lpm exactly."""
    return mix32(lo ^ mix32(hi ^ mix32(lo2 ^ mix32(hi2 ^ mix32(length)))))


def split_u64(value: int) -> tuple[int, int]:
    return value & _M32, (value >> 32) & _M32


def _pack_lo_hi(entry: bytes) -> tuple[int, int]:
    return split_u64(int.from_bytes(entry[:8], "little"))


def _build_table(keys: list[tuple[int, int, int]], payloads: list[int],
                 empty_payload: int) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                              np.ndarray, int]:
    """Open-addressing (linear probe) table over (lo, hi, len) keys.

    Returns (tbl_lo, tbl_hi, tbl_len, tbl_payload, max_probes). The size is a
    power of two; empty slots have len == 0 (real entries have len >= 1).
    """
    n = len(keys)
    size = 16
    while size < 2 * max(n, 1):
        size *= 2
    tbl_lo = np.zeros(size, dtype=U32)
    tbl_hi = np.zeros(size, dtype=U32)
    tbl_len = np.zeros(size, dtype=np.int32)
    tbl_payload = np.full(size, empty_payload, dtype=np.int32)
    mask = size - 1
    max_probes = 1
    for (lo, hi, length), payload in zip(keys, payloads):
        slot = hash_key(lo, hi, length) & mask
        probes = 1
        while tbl_len[slot] != 0:
            slot = (slot + 1) & mask
            probes += 1
        tbl_lo[slot] = lo
        tbl_hi[slot] = hi
        tbl_len[slot] = length
        tbl_payload[slot] = payload
        max_probes = max(max_probes, probes)
    return tbl_lo, tbl_hi, tbl_len, tbl_payload, max_probes


def _build_table_long(keys: list[tuple[int, int, int, int, int]],
                      payloads: list[int]):
    """Open-addressing table over full 16-byte packed keys (long entries)."""
    n = len(keys)
    size = 16
    while size < 2 * max(n, 1):
        size *= 2
    tbl = [np.zeros(size, dtype=U32) for _ in range(4)]
    tbl_len = np.zeros(size, dtype=np.int32)
    tbl_payload = np.full(size, -1, dtype=np.int32)
    mask = size - 1
    max_probes = 1
    for (lo, hi, lo2, hi2, length), payload in zip(keys, payloads):
        slot = hash_key_long(lo, hi, lo2, hi2, length) & mask
        probes = 1
        while tbl_len[slot] != 0:
            slot = (slot + 1) & mask
            probes += 1
        tbl[0][slot], tbl[1][slot], tbl[2][slot], tbl[3][slot] = lo, hi, lo2, hi2
        tbl_len[slot] = length
        tbl_payload[slot] = payload
        max_probes = max(max_probes, probes)
    return tbl[0], tbl[1], tbl[2], tbl[3], tbl_len, tbl_payload, max_probes


@dataclass
class PackedDictionary:
    """Frozen OnPair/OnPair16 dictionary with decode + static-LPM layouts."""

    entries: list[bytes]
    variant16: bool

    # --- decode layout (Figure 7 + Algorithm 3) ---
    blob: np.ndarray          # u8[total_data_bytes]
    offsets: np.ndarray       # u32[n+1]
    lens: np.ndarray          # i32[n]
    mat16: np.ndarray         # u8[n, 16]  (first 16 bytes, zero padded)

    # --- static LPM: short tier (<= 8 bytes) ---
    s_lo: np.ndarray
    s_hi: np.ndarray
    s_len: np.ndarray         # 0 = empty slot
    s_tok: np.ndarray
    s_probe_max: int

    # --- static LPM: long tier (> 8 bytes), bucketed by 8-byte prefix ---
    p_lo: np.ndarray
    p_hi: np.ndarray
    p_len: np.ndarray         # 0 = empty, 8 = occupied (prefix keys are 8 B)
    p_bucket: np.ndarray      # index into bucket arrays, -1 on empty slots
    p_probe_max: int
    bucket_start: np.ndarray  # i32[num_buckets]
    bucket_size: np.ndarray   # i32[num_buckets]
    max_bucket_size: int
    suf_lo: np.ndarray        # u32[M]  first 8 suffix bytes, packed LE
    suf_hi: np.ndarray
    suf_len: np.ndarray       # i32[M]  full suffix length (may exceed 8 for OnPair)
    suf_tok: np.ndarray       # i32[M]
    # byte masks selecting each suffix's live bytes of (suf_lo, suf_hi), so
    # the batch parse compares without per-call mask math
    suf_mlo: np.ndarray       # u32[M]
    suf_mhi: np.ndarray       # u32[M]

    # --- static LPM: exact long-entry table (9..16-byte entries) ---
    # Every long entry of a bounded dictionary fits one 16-byte window, so
    # the batch parse replaces the bucket *scan* with 8 exact hash probes
    # (lengths 16 down to 9). Only consulted when ``variant16`` (unbounded
    # entries still need the bucket scan).
    l_lo: np.ndarray          # u32  entry bytes 0..3, packed LE
    l_hi: np.ndarray          # u32  entry bytes 4..7
    l_lo2: np.ndarray         # u32  entry bytes 8..11 (zero padded)
    l_hi2: np.ndarray         # u32  entry bytes 12..15 (zero padded)
    l_len: np.ndarray         # i32  0 = empty slot
    l_tok: np.ndarray         # i32
    l_probe_max: int

    @classmethod
    def build(cls, entries: list[bytes]) -> "PackedDictionary":
        n = len(entries)
        lens = np.array([len(e) for e in entries], dtype=np.int32)
        offsets = np.zeros(n + 1, dtype=np.uint32)
        np.cumsum(lens, out=offsets[1:])
        blob = np.frombuffer(b"".join(entries), dtype=np.uint8).copy()
        mat16 = np.zeros((n, 16), dtype=np.uint8)
        for i, e in enumerate(entries):
            head = e[:16]
            mat16[i, : len(head)] = np.frombuffer(head, dtype=np.uint8)
        variant16 = bool((lens <= 16).all())

        # short tier
        short_keys, short_payloads = [], []
        for tid, e in enumerate(entries):
            if len(e) <= 8:
                lo, hi = _pack_lo_hi(e)
                short_keys.append((lo, hi, len(e)))
                short_payloads.append(tid)
        s_lo, s_hi, s_len, s_tok, s_probe_max = _build_table(
            short_keys, short_payloads, empty_payload=-1)

        # long tier: group by 8-byte prefix, suffixes sorted descending length
        buckets: dict[tuple[int, int], list[tuple[bytes, int]]] = {}
        for tid, e in enumerate(entries):
            if len(e) > 8:
                buckets.setdefault(_pack_lo_hi(e[:8]), []).append((e[8:], tid))
        prefix_keys, bucket_ids = [], []
        bucket_start_l, bucket_size_l = [], []
        suf_lo_l, suf_hi_l, suf_len_l, suf_tok_l = [], [], [], []
        for (lo, hi), items in buckets.items():
            items.sort(key=lambda it: -len(it[0]))  # stable: ties keep id order
            prefix_keys.append((lo, hi, 8))
            bucket_ids.append(len(bucket_start_l))
            bucket_start_l.append(len(suf_lo_l))
            bucket_size_l.append(len(items))
            for suffix, tid in items:
                sl, sh = _pack_lo_hi(suffix)
                suf_lo_l.append(sl)
                suf_hi_l.append(sh)
                suf_len_l.append(len(suffix))
                suf_tok_l.append(tid)
        p_lo, p_hi, p_len, p_bucket, p_probe_max = _build_table(
            prefix_keys, bucket_ids, empty_payload=-1)

        suf_len_arr = np.array(suf_len_l or [0], dtype=np.int32)
        mlo_n = np.clip(suf_len_arr, 0, 4).astype(np.uint64)
        mhi_n = np.clip(suf_len_arr - 4, 0, 4).astype(np.uint64)
        one = np.uint64(1)
        eight = np.uint64(8)

        # exact long-entry table: every 9..16-byte entry keyed by its full
        # packed bytes (>16-byte entries cannot use it and are left out)
        long_keys, long_payloads = [], []
        for tid, e in enumerate(entries):
            if 8 < len(e) <= 16:
                lo, hi = _pack_lo_hi(e)
                lo2, hi2 = _pack_lo_hi(e[8:])
                long_keys.append((lo, hi, lo2, hi2, len(e)))
                long_payloads.append(tid)
        l_lo, l_hi, l_lo2, l_hi2, l_len, l_tok, l_probe_max = \
            _build_table_long(long_keys, long_payloads)

        return cls(
            entries=entries, variant16=variant16,
            blob=blob, offsets=offsets, lens=lens, mat16=mat16,
            s_lo=s_lo, s_hi=s_hi, s_len=s_len, s_tok=s_tok,
            s_probe_max=s_probe_max,
            p_lo=p_lo, p_hi=p_hi, p_len=p_len, p_bucket=p_bucket,
            p_probe_max=p_probe_max,
            bucket_start=np.array(bucket_start_l or [0], dtype=np.int32),
            bucket_size=np.array(bucket_size_l or [0], dtype=np.int32),
            max_bucket_size=int(max(bucket_size_l, default=0)),
            suf_lo=np.array(suf_lo_l or [0], dtype=U32),
            suf_hi=np.array(suf_hi_l or [0], dtype=U32),
            suf_len=suf_len_arr,
            suf_tok=np.array(suf_tok_l or [0], dtype=np.int32),
            suf_mlo=((one << (mlo_n * eight)) - one).astype(U32),
            suf_mhi=((one << (mhi_n * eight)) - one).astype(U32),
            l_lo=l_lo, l_hi=l_hi, l_lo2=l_lo2, l_hi2=l_hi2, l_len=l_len,
            l_tok=l_tok, l_probe_max=l_probe_max,
        )

    # ------------------------------------------------------------- accounting
    @property
    def num_entries(self) -> int:
        return len(self.entries)

    @property
    def data_bytes(self) -> int:
        """Paper Table 4 'Data' column: raw bytes of all entries."""
        return int(self.blob.size)

    @property
    def total_bytes(self) -> int:
        """Paper Table 4 'Total': data region + 4-byte offset array."""
        return self.data_bytes + 4 * (len(self.offsets))

    @property
    def resident_bytes(self) -> int:
        """In-memory footprint: paper accounting plus the decode matrix and
        the static-LPM hash/bucket/suffix arrays (which Table 4 excludes)."""
        arrays = (self.lens, self.mat16, self.s_lo, self.s_hi, self.s_len,
                  self.s_tok, self.p_lo, self.p_hi, self.p_len, self.p_bucket,
                  self.bucket_start, self.bucket_size, self.suf_lo,
                  self.suf_hi, self.suf_len, self.suf_tok)
        return self.total_bytes + sum(a.nbytes for a in arrays)

    # ----------------------------------------------------------------- decode
    def decode_tokens(self, tokens: np.ndarray) -> bytes:
        """Vectorised Algorithm 3 over a full token stream, on the host.

        Every token writes its (zero-padded) first 16 bytes through a masked
        scatter (the numpy form of the unconditional 16-byte copy); the
        entries longer than 16 bytes (unbounded OnPair and BPE only) then
        write their tails.
        """
        tokens = np.asarray(tokens, dtype=np.int64)
        if tokens.size == 0:
            return b""
        if tokens.size <= 64:
            # one string: a plain join beats the vectorised passes' fixed
            # numpy cost
            return b"".join(map(self.entries.__getitem__, tokens.tolist()))
        if self.variant16:
            # every entry fits one mat16 row, so a row-major select of each
            # row's first len(t) bytes IS the concatenated output
            rows = self.mat16[tokens]
            mask = _ARANGE16[None, :] < self.lens[tokens, None]
            return rows[mask].tobytes()
        lens = self.lens[tokens].astype(np.int64)
        ends = np.cumsum(lens)
        starts = ends - lens
        total = int(ends[-1])
        out = np.zeros(total + 16, dtype=np.uint8)  # +16: the row overhang
        rows = self.mat16[tokens]                   # (T, 16)
        clamped = np.minimum(lens, 16)
        # one exact vectorised write per distinct clamped length (<= 16)
        for length in np.unique(clamped):
            L = int(length)
            sel = np.nonzero(clamped == L)[0]
            idx = starts[sel, None] + _ARANGE16[None, :L]
            out[idx.reshape(-1)] = rows[sel, :L].reshape(-1)
        # the >16-byte entries' tails, one by one
        for t in np.nonzero(lens > 16)[0]:
            tid = tokens[t]
            o = int(self.offsets[tid])
            tail = self.blob[o + 16 : o + int(self.lens[tid])]
            s = int(starts[t]) + 16
            out[s : s + tail.size] = tail
        return out[:total].tobytes()

    def decode_string(self, compressed: bytes) -> bytes:
        """Random-access decode of one independently-compressed string."""
        tokens = np.frombuffer(compressed, dtype="<u2")
        parts = self.entries
        return b"".join(parts[t] for t in tokens)

    # -------------------------------------------------------------- serialise
    # The persistent form of a dictionary is a DictArtifact (table + codec
    # name + format version); every other array is derived from the entries
    # at build() time, so only the table ships.
    def to_artifact(self, codec: str | None = None) -> DictArtifact:
        return DictArtifact.from_entries(
            codec or ("onpair16" if self.variant16 else "onpair"), self.entries)

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "PackedDictionary":
        return cls.build(artifact.entries)

    def save(self, path: str) -> None:
        self.to_artifact().save(path)

    @classmethod
    def load(cls, path: str) -> "PackedDictionary":
        return cls.from_artifact(DictArtifact.load(path))

    def to_bytes(self) -> bytes:
        return self.to_artifact().to_bytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "PackedDictionary":
        return cls.from_artifact(DictArtifact.from_bytes(data))
