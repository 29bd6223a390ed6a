"""Relative Lempel-Ziv factorization against a shared reference.

The cold-tier codec behind :mod:`repro_torch.store.tier`: a sealed segment's
decoded strings are factorized against the trained dictionary's entry blob
(the Hoobin/Puglisi/Zobel RLZ construction with the OnPair dictionary as the
reference — the dictionary was trained on exactly this data, so it is a
dense source of long matches). Every string records its own factor range,
so random access stays O(factors-per-string): decoding string ``i`` gathers
only the copy/literal runs in ``starts[i]:starts[i+1]``, never a block.

Factor layout — four parallel arrays, container- and mmap-friendly::

    starts    i64[n + 1]   per-string factor boundaries
    offs      u32[F]       source offset; top bit set = literals-blob offset
    lens      u32[F]       run length in bytes
    literals  u8[L]        byte runs no reference window covered

Factor search is a vectorised numpy scan: the reference's 4-byte grams are
key-sorted once at codec construction, each string's grams are looked up in
bulk with two ``searchsorted`` passes, and the greedy left-to-right walk
only pays per *factor* (match extension compares 64-byte windows), not per
byte — literal gaps jump straight to the next gram hit.

This is the JAX package's codec, unchanged: a cold container written by
either package is read by the other, so both must factorize every string
into the same arrays.
"""

from __future__ import annotations

import numpy as np

#: top bit of ``offs``: the run copies from ``literals``, not the reference
LIT_FLAG = np.uint32(1 << 31)
OFF_MASK = np.uint32((1 << 31) - 1)

#: gram width the reference index is built over (also the match floor)
_GRAM = 4
#: match extension compares windows of this many bytes at a time
_EXTEND_CHUNK = 64


def _as_u8(buf) -> np.ndarray:
    """Coerce a reference (ndarray / memmap / bytes-like) to a u8 array."""
    if isinstance(buf, np.ndarray):
        return buf if buf.dtype == np.uint8 else buf.astype(np.uint8)
    return np.frombuffer(bytes(buf), dtype=np.uint8)


def _grams(a: np.ndarray) -> np.ndarray:
    """u32 big-endian packing of every 4-byte window of ``a``."""
    a32 = a.astype(np.uint32)
    return (a32[:-3] << 24) | (a32[1:-2] << 16) | (a32[2:-1] << 8) | a32[3:]


class RLZCodec:
    """Greedy RLZ factorizer over a fixed ``reference`` byte array.

    ``min_match`` is the shortest copy factor worth emitting (shorter runs
    become literals — a copy factor costs 8 bytes of ``offs``+``lens``, so
    sub-8-byte matches rarely pay). ``max_candidates`` bounds how many
    reference positions sharing a query's gram are extended per factor.
    """

    def __init__(self, reference, *, min_match: int = 8,
                 max_candidates: int = 4):
        if min_match < _GRAM:
            raise ValueError(f"min_match must be >= {_GRAM}, got {min_match}")
        self.reference = np.ascontiguousarray(_as_u8(reference))
        self.min_match = int(min_match)
        self.max_candidates = int(max_candidates)
        if self.reference.size >= _GRAM:
            keys = _grams(self.reference)
            order = np.argsort(keys, kind="stable").astype(np.int64)
            self._keys = keys[order]
            self._order = order
        else:
            self._keys = np.zeros(0, dtype=np.uint32)
            self._order = np.zeros(0, dtype=np.int64)

    # ---------------------------------------------------------------- encode
    def _best_match(self, s: np.ndarray, pos: int,
                    lo: int, hi: int) -> tuple[int, int]:
        """Longest extension among the candidate reference positions whose
        gram equals ``s[pos:pos+4]`` (guaranteed by the key-sorted lookup
        that produced ``[lo, hi)``)."""
        ref = self.reference
        limit_s = s.size - pos
        best_len, best_off = 0, 0
        for c in self._order[lo:min(hi, lo + self.max_candidates)]:
            c = int(c)
            limit = min(ref.size - c, limit_s)
            m = _GRAM
            while m < limit:
                step = min(_EXTEND_CHUNK, limit - m)
                neq = np.flatnonzero(
                    ref[c + m:c + m + step] != s[pos + m:pos + m + step])
                if neq.size:
                    m += int(neq[0])
                    break
                m += step
            if m > best_len:
                best_len, best_off = m, c
        return best_len, best_off

    def factorize(self, strings) -> dict[str, np.ndarray]:
        """Factor arrays (``starts``/``offs``/``lens``/``literals``) for
        ``strings``, decodable per string by :func:`decode_ids`."""
        starts = np.zeros(len(strings) + 1, dtype=np.int64)
        offs: list[int] = []
        lens: list[int] = []
        lit_parts: list[bytes] = []
        lit_total = 0
        lit_flag = int(LIT_FLAG)
        for k, s in enumerate(strings):
            a = np.frombuffer(bytes(s), dtype=np.uint8)
            n = a.size
            if n >= _GRAM and self._keys.size:
                grams = _grams(a)
                ls = np.searchsorted(self._keys, grams, side="left")
                rs = np.searchsorted(self._keys, grams, side="right")
                has = rs > ls
                # next position at/after p holding a candidate (n = none)
                hidx = np.where(has, np.arange(has.size, dtype=np.int64), n)
                next_hit = np.minimum.accumulate(hidx[::-1])[::-1]
            else:
                has = np.zeros(0, dtype=bool)
                ls = rs = next_hit = np.zeros(0, dtype=np.int64)
            pos, lit0 = 0, -1
            while pos < n:
                blen = 0
                if pos < has.size and has[pos]:
                    blen, boff = self._best_match(
                        a, pos, int(ls[pos]), int(rs[pos]))
                if blen >= self.min_match:
                    if lit0 >= 0:
                        offs.append(lit_flag | lit_total)
                        lens.append(pos - lit0)
                        lit_parts.append(a[lit0:pos].tobytes())
                        lit_total += pos - lit0
                        lit0 = -1
                    offs.append(boff)
                    lens.append(blen)
                    pos += blen
                else:
                    if lit0 < 0:
                        lit0 = pos
                    nxt = pos + 1
                    if nxt >= has.size:
                        nxt = n            # no grams left: rest is literal
                    elif not has[nxt]:
                        nxt = int(next_hit[nxt])
                    pos = max(nxt, pos + 1)
            if lit0 >= 0:
                offs.append(lit_flag | lit_total)
                lens.append(n - lit0)
                lit_parts.append(a[lit0:n].tobytes())
                lit_total += n - lit0
            starts[k + 1] = len(offs)
        return {
            "starts": starts,
            "offs": np.asarray(offs, dtype=np.uint32),
            "lens": np.asarray(lens, dtype=np.uint32),
            "literals": (np.frombuffer(b"".join(lit_parts), dtype=np.uint8)
                         if lit_parts else np.zeros(0, dtype=np.uint8)),
        }


# -------------------------------------------------------------------- decode
def decode_ids(reference, arrays: dict[str, np.ndarray], ids) -> list[bytes]:
    """Decode the strings named by ``ids`` (local to the factorized batch).

    One vectorised gather per call, independent of batch composition: the
    requested factor ranges concatenate (repeat/cumsum trick), every output
    byte resolves its source position in bulk, and copy vs literal runs are
    split by the ``offs`` top bit. Work is O(factors + decoded bytes) for
    exactly the requested strings — the random-access contract.
    """
    ids = np.asarray(ids, dtype=np.int64)
    if ids.size == 0:
        return []
    starts = np.asarray(arrays["starts"], dtype=np.int64)
    f0 = starts[ids]
    fcnt = starts[ids + 1] - f0
    total_f = int(fcnt.sum())
    if total_f == 0:
        return [b""] * len(ids)
    fbase = np.cumsum(fcnt) - fcnt
    fidx = (np.repeat(f0, fcnt)
            + np.arange(total_f, dtype=np.int64) - np.repeat(fbase, fcnt))
    o = np.asarray(arrays["offs"])[fidx]
    fl = np.asarray(arrays["lens"])[fidx].astype(np.int64)
    nbytes = int(fl.sum())
    bstart = np.cumsum(fl) - fl
    src = ((o & OFF_MASK).astype(np.int64).repeat(fl)
           + np.arange(nbytes, dtype=np.int64) - np.repeat(bstart, fl))
    is_lit = np.repeat((o & LIT_FLAG) != 0, fl)
    out = np.empty(nbytes, dtype=np.uint8)
    if is_lit.any():
        out[is_lit] = np.asarray(arrays["literals"])[src[is_lit]]
        hot = ~is_lit
        out[hot] = _as_u8(reference)[src[hot]]
    else:
        out = _as_u8(reference)[src]
    # per-string byte bounds via the factor-boundary positions of the
    # gathered length cumsum (reduceat would trip on empty strings)
    cs = np.concatenate((np.zeros(1, dtype=np.int64), np.cumsum(fl)))
    fend = np.cumsum(fcnt)
    b1 = cs[fend]
    b0 = cs[fend - fcnt]
    buf = out.tobytes()
    return [buf[int(b0[k]):int(b1[k])] for k in range(len(ids))]


def decode_range(reference, arrays: dict[str, np.ndarray],
                 lo: int, hi: int) -> list[bytes]:
    """Decode the contiguous local id range ``[lo, hi)``."""
    return decode_ids(reference, arrays, np.arange(lo, hi, dtype=np.int64))


def rlz_nbytes(arrays: dict[str, np.ndarray]) -> int:
    """Total encoded size of a factorization (all four arrays)."""
    return int(sum(np.asarray(a).nbytes for a in arrays.values()))
