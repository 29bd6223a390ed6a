"""The compressed-corpus layout every codec produces."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CompressedCorpus:
    """Concatenated compressed strings + offsets (random-access layout).

    For OnPair16 each string's slice of ``payload`` is a stream of
    little-endian u16 token IDs, so every per-string slice has even length.
    """

    payload: np.ndarray            # u8[total_compressed_bytes]
    offsets: np.ndarray            # i64[n+1], byte offsets into payload
    raw_bytes: int                 # original corpus size (payload only)
    meta: dict = field(default_factory=dict)

    @property
    def n_strings(self) -> int:
        return len(self.offsets) - 1

    @property
    def compressed_bytes(self) -> int:
        return int(self.payload.size)

    @property
    def ratio(self) -> float:
        """Compression ratio (raw payload / compressed payload), as in the
        paper's tables: both layouts need an offset array, so offsets cancel
        and dictionaries are reported separately (Table 4)."""
        return self.raw_bytes / max(1, self.compressed_bytes)

    def string_tokens(self, i: int) -> np.ndarray:
        """u16 token IDs of string ``i`` — a zero-copy view of the payload."""
        o0, o1 = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.payload[o0:o1].view("<u2")

    def token_counts(self) -> np.ndarray:
        """Tokens per string, i64[n_strings] (2 bytes per token ID)."""
        return ((self.offsets[1:] - self.offsets[:-1]) // 2).astype(np.int64)
