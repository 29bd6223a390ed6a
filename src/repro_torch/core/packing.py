"""Byte -> u64 packing used by the training-time LPM.

The paper packs up to 8 bytes little-endian into a 64-bit integer so that
prefix comparison reduces to ``count_trailing_zeros(a ^ b) / 8`` (Algorithm 2).
Strings shorter than 8 bytes are zero-padded at the most-significant end, so
the *low-order* bytes always hold the actual prefix.
"""

from __future__ import annotations


def pack_u64(data: bytes, start: int = 0, length: int | None = None) -> int:
    """Pack ``data[start:start+length]`` (length <= 8) little-endian into an int."""
    if length is None:
        length = min(8, len(data) - start)
    chunk = data[start : start + length]
    return int.from_bytes(chunk, "little")
