"""Two-tier Longest Prefix Matching used during training (paper §3.4).

* short patterns (<= 8 bytes): hash map keyed by ``(packed u64, length)``.
* long patterns  (>  8 bytes): hash map keyed by the packed 8-byte prefix;
  each value is a *bucket* — a list of ``(suffix bytes, token_id)`` kept in
  descending suffix-length order so the scan can stop at the first match
  (Algorithm 1, lines 2-12).

The static flattening into parallel arrays lives in
:mod:`repro_torch.core.packed`; the encode kernel reads it on the card, and
:func:`parse_batch` below walks it on the host for a whole batch at once
(the host codecs' parse, byte-identical to :meth:`DynamicLPM.parse`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.packing import pack_u64


@dataclass
class DynamicLPM:
    """Insertable two-tier LPM used by the OnPair training phase."""

    #: (packed u64 value, length) -> token id, for entries of length 1..8.
    short_map: dict[tuple[int, int], int] = field(default_factory=dict)
    #: packed 8-byte prefix -> [(suffix bytes, token id)] sorted by len desc.
    long_buckets: dict[int, list[tuple[bytes, int]]] = field(default_factory=dict)

    def insert(self, entry: bytes, token_id: int) -> None:
        n = len(entry)
        if n <= 8:
            self.short_map[(pack_u64(entry, 0, n), n)] = token_id
            return
        prefix = pack_u64(entry, 0, 8)
        suffix = entry[8:]
        bucket = self.long_buckets.setdefault(prefix, [])
        # Keep descending length order; ties keep insertion order (older first,
        # matching "return the first match found" semantics for equal lengths).
        pos = 0
        slen = len(suffix)
        while pos < len(bucket) and len(bucket[pos][0]) >= slen:
            pos += 1
        bucket.insert(pos, (suffix, token_id))

    def bucket_size(self, entry: bytes) -> int:
        """Current size of the bucket the (long) entry would land in."""
        if len(entry) <= 8:
            return 0
        return len(self.long_buckets.get(pack_u64(entry, 0, 8), ()))

    def search(self, data: bytes, pos: int) -> tuple[int, int]:
        """Algorithm 1: longest dictionary match at ``data[pos:]``.

        Returns ``(token_id, match_length)``. Because the dictionary is seeded
        with all 256 single bytes, a 1-byte match always exists.
        """
        rem = len(data) - pos
        # --- long pattern matching (lines 2-12) ---
        if rem > 8:
            prefix = pack_u64(data, pos, 8)
            bucket = self.long_buckets.get(prefix)
            if bucket is not None:
                after = pos + 8
                for suffix, token_id in bucket:  # sorted by descending length
                    if data.startswith(suffix, after):
                        return token_id, 8 + len(suffix)
        # --- short pattern matching (lines 13-19) ---
        max_len = rem if rem < 8 else 8
        val = pack_u64(data, pos, max_len)
        for length in range(max_len, 0, -1):
            token_id = self.short_map.get((val, length))
            if token_id is not None:
                return token_id, length
            # Little-endian packing: a length-1 prefix is the *low* bytes, so
            # shorten by masking off the current highest byte.
            val &= (1 << (8 * (length - 1))) - 1
        raise AssertionError("dictionary must contain all single bytes")

    def parse(self, data: bytes) -> list[int]:
        """Greedy longest-prefix tokenisation of one string (paper §3.3)."""
        out: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            token_id, length = self.search(data, pos)
            out.append(token_id)
            pos += length
        return out


def lpm_from_entries(entries: list[bytes]) -> DynamicLPM:
    """Build a dynamic LPM over a full entry list (ids = list positions)."""
    lpm = DynamicLPM()
    for tid, entry in enumerate(entries):
        lpm.insert(entry, tid)
    return lpm


# ---------------------------------------------------------------------------
# Vectorised batch parsing over the static PackedDictionary arrays
# ---------------------------------------------------------------------------
# One shared table walk across a whole batch of strings: each outer iteration
# advances every still-active string by one token, with both LPM tiers probed
# as flat numpy gathers over the frozen open-addressing tables (the host
# analogue of the encode kernel's per-string loop). Semantics are pinned
# byte-identical to DynamicLPM.parse.

_ARANGE16 = np.arange(16, dtype=np.int64)
_LENS8 = np.arange(8, 0, -1, dtype=np.int32)  # short-tier lengths, longest first


def _len_mask32(n: np.ndarray) -> np.ndarray:
    """Mask selecting the low ``clip(n, 0, 4)`` bytes of a packed u32."""
    nb = np.clip(n, 0, 4).astype(np.uint64)
    return ((np.uint64(1) << (nb * np.uint64(8))) - np.uint64(1)).astype(np.uint32)


_MLO8 = _len_mask32(_LENS8)       # low-word mask for each short length
_MHI8 = _len_mask32(_LENS8 - 4)   # high-word mask for each short length


def _mix32_vec(x: np.ndarray) -> np.ndarray:
    """Vectorised murmur-style finaliser; bit-identical to packed.mix32."""
    x = np.asarray(x, dtype=np.uint32).copy()
    np.multiply(x, np.uint32(0x85EBCA6B), out=x)
    np.bitwise_xor(x, x >> np.uint32(13), out=x)
    np.multiply(x, np.uint32(0xC2B2AE35), out=x)
    np.bitwise_xor(x, x >> np.uint32(16), out=x)
    return x


_MIXL8 = _mix32_vec(_LENS8.astype(np.uint32))  # pre-mixed short lengths
_MIXP = _MIXL8[0]                              # pre-mixed prefix length (8)

_U64_LO32 = np.uint64(0xFFFFFFFF)
_SHIFT32 = np.uint64(32)
# combined u64 masks: low u32 word = packed bytes 0..3, high = bytes 4..7
_M64S8 = _MLO8.astype(np.uint64) | (_MHI8.astype(np.uint64) << _SHIFT32)


def _k64_tables(pd):
    """u64-packed probe tables, built once per dictionary and cached on it:
    each probe round then gathers one u64 key word per 8 key bytes instead
    of two u32 halves. Key comparisons and hashes stay bit-identical — the
    u32 words are recovered by splitting before mixing."""
    t = getattr(pd, "_lpm_k64", None)
    if t is None:
        t = (pd.s_lo.astype(np.uint64) | (pd.s_hi.astype(np.uint64) << _SHIFT32),
             pd.p_lo.astype(np.uint64) | (pd.p_hi.astype(np.uint64) << _SHIFT32),
             pd.l_lo.astype(np.uint64) | (pd.l_hi.astype(np.uint64) << _SHIFT32),
             pd.l_lo2.astype(np.uint64) | (pd.l_hi2.astype(np.uint64) << _SHIFT32))
        pd._lpm_k64 = t
    return t


#: live-lane count below which a probe loop finishes scalar: a vector round
#: costs ~15 fixed-size numpy calls regardless of width, and measured round
#: traces show ~70% of rounds run under this width (collision tails)
_SCALAR_TAIL = 48


def _probe_flat(k, ln, mixlen, t_k, t_len, t_pay, probe_max: int):
    """Vectorised open-addressing lookup of many (key64, len) keys at once.

    Mirrors the scalar probe in packed._build_table: start at
    hash_key(lo, hi, len), walk linearly, stop on an empty slot (len == 0).
    Keys resolve independently; resolved lanes are compacted away each round
    so later probe rounds only touch the colliding tail, and once that tail
    is narrow the walk finishes as a per-lane scalar loop. Returns int32
    payloads, -1 where the key is absent.
    """
    n = k.size
    out = np.full(n, -1, dtype=np.int32)
    if n == 0:
        return out
    mask = np.uint32(t_len.size - 1)
    lo = (k & _U64_LO32).astype(np.uint32)
    hi = (k >> _SHIFT32).astype(np.uint32)
    slot = _mix32_vec(lo ^ _mix32_vec(hi ^ mixlen)) & mask
    idx = None  # None = all key positions still live
    for _ in range(probe_max):
        sl = t_len.take(slot)
        hit = (sl == ln) & (t_k.take(slot) == k)
        out[hit if idx is None else idx[hit]] = t_pay.take(slot[hit])
        keep = ~hit & (sl != 0)
        if not keep.any():
            break
        idx = np.nonzero(keep)[0] if idx is None else idx[keep]
        slot = (slot[keep] + np.uint32(1)) & mask
        k = k[keep]
        if isinstance(ln, np.ndarray) and ln.ndim:
            ln = ln[keep]
        if k.size <= _SCALAR_TAIL:
            ln_v = ln.tolist() if isinstance(ln, np.ndarray) and ln.ndim \
                else [int(ln)] * k.size
            m = int(mask)
            for j, (s, kk, lnj) in enumerate(
                    zip(slot.tolist(), k.tolist(), ln_v)):
                while True:
                    sl_j = int(t_len[s])
                    if sl_j == 0:
                        break
                    if sl_j == lnj and int(t_k[s]) == kk:
                        out[idx[j]] = t_pay[s]
                        break
                    s = (s + 1) & m
            return out
    return out


_LLEN8 = np.arange(16, 8, -1, dtype=np.int32)  # long lengths, longest first
_ML2 = _len_mask32(_LLEN8 - 8)    # window word 2 (bytes 8..11) mask per length
_MH2 = _len_mask32(_LLEN8 - 12)   # window word 3 (bytes 12..15) mask per length
_MIXLL8 = _mix32_vec(_LLEN8.astype(np.uint32))
_M64L2 = _ML2.astype(np.uint64) | (_MH2.astype(np.uint64) << _SHIFT32)


def _probe_flat_long(k1, k2, ln, mixlen, pd, t_k1, t_k2):
    """Open-addressing lookup of full 16-byte packed keys (long entries)."""
    n = k1.size
    out = np.full(n, -1, dtype=np.int32)
    if n == 0:
        return out
    t_len, t_pay = pd.l_len, pd.l_tok
    mask = np.uint32(t_len.size - 1)
    lo = (k1 & _U64_LO32).astype(np.uint32)
    hi = (k1 >> _SHIFT32).astype(np.uint32)
    lo2 = (k2 & _U64_LO32).astype(np.uint32)
    hi2 = (k2 >> _SHIFT32).astype(np.uint32)
    slot = _mix32_vec(
        lo ^ _mix32_vec(hi ^ _mix32_vec(lo2 ^ _mix32_vec(hi2 ^ mixlen)))) & mask
    idx = None
    for _ in range(pd.l_probe_max):
        sl = t_len.take(slot)
        hit = ((sl == ln) & (t_k1.take(slot) == k1) & (t_k2.take(slot) == k2))
        out[hit if idx is None else idx[hit]] = t_pay.take(slot[hit])
        keep = ~hit & (sl != 0)
        if not keep.any():
            break
        idx = np.nonzero(keep)[0] if idx is None else idx[keep]
        slot = (slot[keep] + np.uint32(1)) & mask
        k1 = k1[keep]
        k2 = k2[keep]
        ln = ln[keep]
        if k1.size <= _SCALAR_TAIL:
            m = int(mask)
            for j, (s, ka, kb, lnj) in enumerate(
                    zip(slot.tolist(), k1.tolist(), k2.tolist(), ln.tolist())):
                while True:
                    sl_j = int(t_len[s])
                    if sl_j == 0:
                        break
                    if sl_j == lnj and int(t_k1[s]) == ka \
                            and int(t_k2[s]) == kb:
                        out[idx[j]] = t_pay[s]
                        break
                    s = (s + 1) & m
            return out
    return out


def _long_exact(k1, k2, rem, pd, t_k1, t_k2):
    """Longest 9..16-byte match per row via 8 exact probes (variant16 only).

    Equivalent to the bucket scan: equal-length suffixes in a bucket are
    distinct byte strings, so at most one entry matches a given window at
    each length, and the longest valid length is the greedy answer."""
    A = k1.size
    k1_c = np.repeat(k1, 8)
    k2_c = (k2[:, None] & _M64L2[None, :]).ravel()
    ln = np.broadcast_to(_LLEN8, (A, 8)).ravel()
    mix = np.broadcast_to(_MIXLL8, (A, 8)).ravel()
    found = _probe_flat_long(k1_c, k2_c, ln, mix, pd, t_k1,
                             t_k2).reshape(A, 8)
    valid = (found >= 0) & (_LLEN8[None, :] <= rem[:, None])
    pick = np.argmax(valid, axis=1)
    ar = np.arange(A)
    ok = valid[ar, pick]
    tok = np.where(ok, found[ar, pick], np.int32(-1))
    ml = np.where(ok, _LLEN8[pick], 0).astype(np.int64)
    return tok, ml


def _short_tier(k1, rem, pd, t_s):
    """Longest short-tier match per row: all 8 candidate lengths probed as
    one flat key batch, then the longest valid one picked per row."""
    A = k1.size
    k_c = (k1[:, None] & _M64S8[None, :]).ravel()
    ln = np.broadcast_to(_LENS8, (A, 8)).ravel()
    mix = np.broadcast_to(_MIXL8, (A, 8)).ravel()
    found = _probe_flat(k_c, ln, mix, t_s, pd.s_len,
                        pd.s_tok, pd.s_probe_max).reshape(A, 8)
    valid = (found >= 0) & (_LENS8[None, :] <= rem[:, None])
    pick = np.argmax(valid, axis=1)  # first True along descending lengths
    ar = np.arange(A)
    if not valid[ar, pick].all():
        raise AssertionError("dictionary must contain all single bytes")
    return found[ar, pick], _LENS8[pick].astype(np.int64)


def _bucket_scan(pd, data, rows, pos, rem, lo2, hi2, bkt):
    """Find each row's first fitting suffix in its long-tier bucket.

    Every (row, bucket-slot) candidate pair is compared at once with masked
    packed equality; buckets store suffixes in descending length (ties in
    insertion order), so the first hit per row IS the DynamicLPM answer.
    Returns (token, match_len) with token == -1 where no suffix fits.
    """
    A = bkt.size
    start = pd.bucket_start[bkt].astype(np.int64)
    size = pd.bucket_size[bkt].astype(np.int64)
    tok = np.full(A, -1, dtype=np.int32)
    ml = np.zeros(A, dtype=np.int64)
    total = int(size.sum())
    if total == 0:
        return tok, ml
    prow = np.repeat(np.arange(A, dtype=np.int64), size)
    boff = np.zeros(A, dtype=np.int64)
    np.cumsum(size[:-1], out=boff[1:])
    psi = np.arange(total, dtype=np.int64) - boff[prow] + start[prow]
    sl = pd.suf_len[psi]
    eq = (((lo2[prow] ^ pd.suf_lo[psi]) & pd.suf_mlo[psi]) == 0) \
        & (((hi2[prow] ^ pd.suf_hi[psi]) & pd.suf_mhi[psi]) == 0) \
        & (sl <= rem[prow] - 8)
    if not pd.variant16:
        # unbounded OnPair: suffixes longer than the packed 8 bytes must
        # verify their tails against the raw entry bytes (rare)
        for j in np.nonzero(eq & (sl > 8))[0].tolist():
            t = int(pd.suf_tok[psi[j]])
            o = int(pd.offsets[t])
            ln_e = int(pd.lens[t])
            r = int(prow[j])
            q = int(pos[r])
            if not np.array_equal(data[rows[r], q + 16 : q + ln_e],
                                  pd.blob[o + 16 : o + ln_e]):
                eq[j] = False
    hits = np.nonzero(eq)[0]
    if hits.size:
        # hits ascend and pairs are grouped by row, so unique() yields each
        # row's first (= longest, tie-correct) hit
        got, firsti = np.unique(prow[hits], return_index=True)
        w = hits[firsti]
        tok[got] = pd.suf_tok[psi[w]]
        ml[got] = 8 + sl[w]
    return tok, ml


def _parse_chunk(pd, strings: list[bytes], lens: np.ndarray):
    """Parse one (length-homogeneous) chunk; returns the chunk's token stream
    flattened in chunk order ('<u2') plus per-string token counts."""
    B = len(strings)
    Lmax = int(lens.max())
    counts = np.zeros(B, dtype=np.int64)
    if Lmax == 0:
        return np.zeros(0, dtype="<u2"), counts
    # one blob -> (B, Lmax + 16) matrix; the +16 columns stay zero so every
    # 16-byte window gather is in bounds
    data = np.zeros((B, Lmax + 16), dtype=np.uint8)
    blob = np.frombuffer(b"".join(strings), dtype=np.uint8)
    fill = np.arange(Lmax, dtype=np.int64)[None, :] < lens[:, None]
    data[:, :Lmax][fill] = blob
    toks = np.zeros((B, Lmax), dtype=np.int32)  # <= 1 token per input byte
    tflat = toks.reshape(-1)
    dflat = data.reshape(-1)
    W = data.shape[1]
    has_long = pd.max_bucket_size > 0
    t_s, t_p, t_l1, t_l2 = _k64_tables(pd)
    # live rows carried as compacted parallel arrays: finished rows drop out
    # wholesale each round, so no per-round fancy gather/scatter on (B,)
    # state — only the (shrinking) live set is touched
    row = np.nonzero(lens > 0)[0]
    p = np.zeros(row.size, dtype=np.int64)
    rlen = lens[row]
    cnt = np.zeros(row.size, dtype=np.int64)
    dbase = row * np.int64(W)
    tbase = row * np.int64(Lmax)
    while row.size:
        rem = rlen - p
        win = dflat.take((dbase + p)[:, None] + _ARANGE16)
        w64 = win.view("<u8")  # (A, 2): the 16-byte window as 2 LE u64 words
        k1 = w64[:, 0]
        k2 = w64[:, 1]
        tok = np.full(row.size, -1, dtype=np.int32)
        mlen = np.zeros(row.size, dtype=np.int64)
        if has_long:
            cand = np.nonzero(rem > 8)[0]
            if cand.size:
                bkt = _probe_flat(k1[cand], np.int32(8), _MIXP, t_p,
                                  pd.p_len, pd.p_bucket, pd.p_probe_max)
                hitb = np.nonzero(bkt >= 0)[0]
                if hitb.size:
                    li = cand[hitb]
                    if pd.variant16:
                        t, m = _long_exact(k1[li], k2[li], rem[li], pd,
                                           t_l1, t_l2)
                    else:
                        w32 = win.view("<u4")
                        t, m = _bucket_scan(pd, data, row[li], p[li],
                                            rem[li], w32[li, 2], w32[li, 3],
                                            bkt[hitb])
                    tok[li] = t
                    mlen[li] = m
        # short tier only where the long tier found nothing (Algorithm 1:
        # a long match, being >= 9 bytes, always beats the short tier)
        short = np.nonzero(tok < 0)[0]
        if short.size:
            stok, sml = _short_tier(k1[short], rem[short], pd, t_s)
            tok[short] = stok
            mlen[short] = sml
        tflat[tbase + cnt] = tok
        cnt += 1
        p += mlen
        keep = p < rlen
        if not keep.all():
            done = ~keep
            counts[row[done]] = cnt[done]
            row = row[keep]
            p = p[keep]
            rlen = rlen[keep]
            cnt = cnt[keep]
            dbase = dbase[keep]
            tbase = tbase[keep]
    keep = np.arange(Lmax, dtype=np.int64)[None, :] < counts[:, None]
    return toks[keep].astype("<u2"), counts


def parse_batch(dictionary, strings: list[bytes],
                chunk: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised greedy LPM parse of a whole batch (paper §3.3).

    One shared static-table walk across all strings instead of a per-string
    Python loop. Returns ``(payload, counts)``: the concatenated '<u2' token
    stream in input order and per-string token counts. Byte-identical to
    ``DynamicLPM.parse`` on every string (pinned by tests).
    """
    n = len(strings)
    counts = np.zeros(n, dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype="<u2"), counts
    lens = np.fromiter(map(len, strings), dtype=np.int64, count=n)
    # Length-sorted chunks keep each chunk's token loop rectangular: the
    # active set drains together instead of idling on one long straggler.
    order = np.argsort(lens, kind="stable")
    parts: list[np.ndarray] = []
    sorted_counts = np.zeros(n, dtype=np.int64)
    for c0 in range(0, n, chunk):
        sel = order[c0 : c0 + chunk]
        flat, cnt = _parse_chunk(dictionary, [strings[i] for i in sel],
                                 lens[sel])
        parts.append(flat)
        sorted_counts[c0 : c0 + sel.size] = cnt
    flat_sorted = parts[0] if len(parts) == 1 else np.concatenate(parts)
    counts[order] = sorted_counts
    total = int(flat_sorted.size)
    if total == 0:
        return flat_sorted, counts
    # gather sorted-order tokens back into input order
    src_off = np.zeros(n, dtype=np.int64)
    np.cumsum(sorted_counts[:-1], out=src_off[1:])
    starts = np.empty(n, dtype=np.int64)
    starts[order] = src_off  # per input string: its span start in flat_sorted
    out_off = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=out_off[1:])
    gather = np.repeat(starts - out_off, counts) + np.arange(total,
                                                             dtype=np.int64)
    return flat_sorted[gather], counts
