"""Two-tier Longest Prefix Matching used during training (paper §3.4).

* short patterns (<= 8 bytes): hash map keyed by ``(packed u64, length)``.
* long patterns  (>  8 bytes): hash map keyed by the packed 8-byte prefix;
  each value is a *bucket* — a list of ``(suffix bytes, token_id)`` kept in
  descending suffix-length order so the scan can stop at the first match
  (Algorithm 1, lines 2-12).

The static flattening into parallel arrays that the kernels read lives in
:mod:`repro_torch.core.packed`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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
