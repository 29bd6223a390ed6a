"""Reverse-lookup index over *compressed* string forms (queryable dictionary).

OnPair compresses every string independently against a shared frozen
dictionary, so the greedy LPM parse is deterministic: for a given dictionary
generation each raw string has exactly one encoded byte form.  That makes the
inverse direction — ``locate(string) -> id`` — cheap: encode the query once
and compare *compressed* bytes, no decompression anywhere (Arz/Fischer's
``locate`` operation from LZ-compressed string dictionaries).

Two per-segment structures, both built at seal/compact time:

* an open-addressing hash table over u64 fingerprints of the encoded
  payload bytes (the flat-array idiom of :mod:`repro_torch.core.packed`):
  ``table_fp`` holds fingerprints, ``table_loc`` the segment-local string
  id, ``-1`` marking empty slots.  Collisions are resolved by linear
  probing; candidate hits are verified against the actual payload bytes, so
  fingerprint quality affects speed only, never correctness.  Local ids are
  inserted in ascending order, which means probe-chain order equals
  insertion order and the first byte-verified hit is the *lowest* local id
  for duplicate strings.
* a sorted sidecar: ``perm`` is the permutation of local ids ordered by
  *raw* string bytes (stable, so ties keep ascending-id order).  Binary
  search over ``perm`` plus independent per-hit decode gives
  ``scan_prefix(prefix, limit)`` without materialising the segment.

Both persist into a single ``index.npz`` sidecar per store version; loaders
validate per-segment string counts and fall back to lazy rebuild on any
mismatch rather than serve stale ids.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

#: FNV-1a 64-bit prime, used as the polynomial base for payload hashing.
_POLY_BASE = np.uint64(0x100000001B3)
#: Golden-ratio odd constant mixed with the length so equal-content
#: prefixes of different lengths fingerprint apart.
_LEN_SALT = np.uint64(0x9E3779B97F4A7C15)

_U64 = np.uint64


def _fmix64(h: np.ndarray) -> np.ndarray:
    """Murmur3 64-bit finaliser: avalanche a u64 array in place-ish."""
    h = h.copy()
    h ^= h >> _U64(33)
    h *= _U64(0xFF51AFD7ED558CCD)
    h ^= h >> _U64(33)
    h *= _U64(0xC4CEB9FE1A85EC53)
    h ^= h >> _U64(33)
    return h


def fingerprints(payload: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """u64 fingerprint per string of a concatenated byte payload.

    ``payload`` is a flat u8 array, ``offsets`` the i64 ``[n+1]`` prefix
    starts (the segment layout).  Computes a polynomial hash of each
    string's bytes — vectorised with a single ``np.add.reduceat`` over
    per-byte terms — then avalanches with the length mixed in.  All u64
    arithmetic wraps mod 2**64 (C semantics), which is exactly what we
    want for a polynomial rolling hash.
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    total = int(offsets[-1] - offsets[0])
    base = int(offsets[0])
    sums = np.zeros(n, dtype=np.uint64)
    if total > 0:
        data = np.asarray(payload[base : base + total], dtype=np.uint64)
        # exponent of each byte position, counted from the *end* of its
        # string: exp[i] = (string end - 1) - i
        ends = np.repeat(offsets[1:] - base, lens)
        exp = ends - np.int64(1) - np.arange(total, dtype=np.int64)
        # power table up to the longest string
        max_len = int(lens.max())
        pw = np.ones(max_len, dtype=np.uint64)
        if max_len > 1:
            np.cumprod(np.full(max_len - 1, _POLY_BASE, dtype=np.uint64), out=pw[1:])
        terms = data * pw[exp]
        # reduceat misreads zero-length strings (repeated indices yield the
        # single element, not 0) — only reduce over nonempty starts.
        nz = lens > 0
        if nz.any():
            sums[nz] = np.add.reduceat(terms, (offsets[:-1] - base)[nz])
    with np.errstate(over="ignore"):
        mixed = sums ^ (lens.astype(np.uint64) * _LEN_SALT)
    return _fmix64(mixed)


def fingerprint_one(encoded: bytes) -> int:
    """Fingerprint of a single encoded byte string (query-side helper)."""
    payload = np.frombuffer(encoded, dtype=np.uint8)
    offsets = np.array([0, len(encoded)], dtype=np.int64)
    return int(fingerprints(payload, offsets)[0])


def _table_size(n: int) -> int:
    """Power-of-two table size with load factor <= 0.5 (min 8 slots)."""
    size = 8
    while size < 2 * n:
        size *= 2
    return size


@dataclass
class SegmentIndex:
    """Exact-match + prefix index for one sealed segment.

    ``table_fp``/``table_loc`` form the open-addressing fingerprint table
    over *encoded* payload bytes; ``perm`` is the raw-string sort
    permutation of local ids.  ``n`` is the number of strings indexed —
    callers validate it against the live segment before trusting the index
    (segment indexes can be rebuilt, re-segmented, or loaded from an older
    layout).
    """

    n: int
    table_fp: np.ndarray  # u64[size]
    table_loc: np.ndarray  # i32[size], -1 == empty
    perm: np.ndarray  # i32[n], local ids in raw-string order

    @classmethod
    def build(
        cls,
        payload: np.ndarray,
        offsets: np.ndarray,
        raw_strings: list[bytes],
    ) -> "SegmentIndex":
        """Build from a segment's encoded layout plus its decoded strings."""
        n = len(offsets) - 1
        fps = fingerprints(payload, offsets)
        size = _table_size(n)
        mask = size - 1
        table_fp = np.zeros(size, dtype=np.uint64)
        table_loc = np.full(size, -1, dtype=np.int32)
        for loc in range(n):
            slot = int(fps[loc]) & mask
            while table_loc[slot] != -1:
                slot = (slot + 1) & mask
            table_fp[slot] = fps[loc]
            table_loc[slot] = loc
        perm = np.asarray(
            sorted(range(n), key=raw_strings.__getitem__), dtype=np.int32
        )
        return cls(n=n, table_fp=table_fp, table_loc=table_loc, perm=perm)

    def locate(
        self,
        encoded: bytes,
        payload: np.ndarray,
        offsets: np.ndarray,
    ) -> int | None:
        """Segment-local id of the string whose encoded form is ``encoded``.

        Probes the fingerprint table linearly; every fingerprint hit is
        verified by comparing actual payload bytes, so a false positive
        costs one memcmp and can never return a wrong id.  Duplicate
        strings resolve to the lowest local id (insertion order == probe
        order).  Returns ``None`` on miss.
        """
        size = len(self.table_loc)
        mask = size - 1
        fp = _U64(fingerprint_one(encoded))
        slot = int(fp) & mask
        for _ in range(size):
            loc = int(self.table_loc[slot])
            if loc == -1:
                return None
            if self.table_fp[slot] == fp:
                o0 = int(offsets[loc])
                o1 = int(offsets[loc + 1])
                if o1 - o0 == len(encoded) and (
                    bytes(payload[o0:o1]) == encoded
                ):
                    return loc
            slot = (slot + 1) & mask
        return None

    def locate_many(
        self,
        fps: np.ndarray,
        encoded: list[bytes],
        payload: np.ndarray,
        offsets: np.ndarray,
    ) -> np.ndarray:
        """:meth:`locate` of many queries at once: ``encoded[q]`` with
        fingerprint ``fps[q]`` (:func:`fingerprints` of the queries).

        Returns int64 segment-local ids, ``-1`` on a miss. Every query walks
        its own probe chain in the order :meth:`locate` walks it and stops
        where that would, so each answer is :meth:`locate`'s; the walks
        advance together, one vectorised step per probe.
        """
        fps = np.asarray(fps, dtype=np.uint64)
        out = np.full(fps.size, -1, dtype=np.int64)
        mask = len(self.table_loc) - 1
        slot = (fps & _U64(mask)).astype(np.int64)
        active = np.arange(fps.size)
        for _ in range(len(self.table_loc)):
            if not active.size:
                break
            at = slot[active]
            loc = self.table_loc[at]
            go_on = loc != -1
            for k in np.flatnonzero(go_on & (self.table_fp[at] == fps[active])):
                q, cand = int(active[k]), int(loc[k])
                o0, o1 = int(offsets[cand]), int(offsets[cand + 1])
                if o1 - o0 == len(encoded[q]) and (
                    bytes(payload[o0:o1]) == encoded[q]
                ):
                    out[q] = cand
                    go_on[k] = False
            active = active[go_on]
            slot[active] = (slot[active] + 1) & mask
        return out

    def scan_prefix(
        self,
        prefix: bytes,
        limit: int | None,
        fetch,
        after: tuple[bytes, int] | None = None,
    ) -> list[tuple[int, bytes]]:
        """Segment-local prefix scan: ``[(local_id, string), ...]``.

        Results come back in ``(string, local_id)`` order — the global
        merge relies on this.  ``fetch(local_id) -> bytes`` decodes one
        string on demand (the index stores no raw text).  ``after`` is an
        exclusive ``(string, local_id)`` resume cursor for pagination.
        ``limit=None`` means unbounded.
        """
        n = self.n
        if n == 0:
            return []
        perm = self.perm
        # lower bound: first perm position whose (string, local) key is
        # > after (when resuming) or whose string is >= prefix.
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            loc = int(perm[mid])
            s = fetch(loc)
            if after is not None:
                before = (s, loc) <= after
            else:
                before = s < prefix
            if before:
                lo = mid + 1
            else:
                hi = mid
        out: list[tuple[int, bytes]] = []
        pos = lo
        while pos < n and (limit is None or len(out) < limit):
            loc = int(perm[pos])
            s = fetch(loc)
            if not s.startswith(prefix):
                break
            out.append((loc, s))
            pos += 1
        return out


def dump_indexes(indexes: dict[int, tuple[int, SegmentIndex]]) -> bytes:
    """Serialise per-segment indexes to ``.npz`` bytes.

    ``indexes`` maps segment position (``Segment.index``) to
    ``(base_id, SegmentIndex)``.  Arrays are stored flat under
    ``<pos>_fp`` / ``<pos>_loc`` / ``<pos>_perm`` names with a parallel
    ``layout`` table ``[[pos, base_id, n], ...]`` for load-time
    validation: a reopened corpus may re-segment on different boundaries
    (force-sealed short segments shift every later base), so count alone
    is not enough to prove an index describes the same strings.
    """
    arrays: dict[str, np.ndarray] = {}
    layout = []
    for pos in sorted(indexes):
        base, idx = indexes[pos]
        arrays[f"{pos}_fp"] = idx.table_fp
        arrays[f"{pos}_loc"] = idx.table_loc
        arrays[f"{pos}_perm"] = idx.perm
        layout.append((pos, base, idx.n))
    arrays["layout"] = np.asarray(layout, dtype=np.int64).reshape(-1, 3)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def load_indexes(
    data: bytes, segment_layout: dict[int, tuple[int, int]]
) -> dict[int, SegmentIndex]:
    """Deserialise ``dump_indexes`` output, validating against live segments.

    ``segment_layout`` maps segment position -> ``(base_id, n_strings)``
    of the *live* segmentation.  Any persisted segment whose position,
    base id, or count disagrees (or that no longer exists) is dropped —
    the store lazily rebuilds it — so a stale or re-segmented sidecar can
    never serve wrong ids.  Returns ``{}`` for unreadable payloads.
    """
    try:
        with np.load(io.BytesIO(data)) as zf:
            out: dict[int, SegmentIndex] = {}
            for pos, base, n in zf["layout"]:
                pos, base, n = int(pos), int(base), int(n)
                if segment_layout.get(pos) != (base, n):
                    continue
                out[pos] = SegmentIndex(
                    n=n,
                    table_fp=zf[f"{pos}_fp"],
                    table_loc=zf[f"{pos}_loc"],
                    perm=zf[f"{pos}_perm"],
                )
            return out
    except Exception:
        return {}
