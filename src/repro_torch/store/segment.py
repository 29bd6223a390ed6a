"""Multi-segment layout for a compressed corpus.

A :class:`SegmentedCorpus` splits one :class:`~repro_torch.core.api.CompressedCorpus`
into fixed-size segments of consecutive strings. Each segment carries a
zero-copy payload view plus *segment-local* byte offsets, and global string
ids route as ``gid -> (segment, local)`` by bisecting the segments' base ids.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.api import CompressedCorpus


@dataclass
class Segment:
    """A contiguous run of compressed strings with local offsets."""

    index: int
    base_id: int              # global id of local string 0
    payload: np.ndarray       # u8 view into the corpus payload
    offsets: np.ndarray       # i64[n_local + 1], local byte offsets

    @property
    def n_strings(self) -> int:
        return len(self.offsets) - 1

    @property
    def payload_bytes(self) -> int:
        return int(self.payload.size)

    def string_tokens(self, local: int) -> np.ndarray:
        """u16 token IDs of local string ``local`` (zero-copy view)."""
        o0, o1 = int(self.offsets[local]), int(self.offsets[local + 1])
        return self.payload[o0:o1].view("<u2")

    def token_counts(self) -> np.ndarray:
        return ((self.offsets[1:] - self.offsets[:-1]) // 2).astype(np.int64)


@dataclass
class SegmentedCorpus:
    """Fixed-size segmentation of a compressed corpus + global routing."""

    segments: list[Segment]
    strings_per_segment: int
    n_strings: int
    raw_bytes: int
    _base_ids: list[int] = field(default_factory=list, repr=False)

    def __post_init__(self) -> None:
        self._base_ids = [s.base_id for s in self.segments]

    @classmethod
    def from_corpus(cls, corpus: CompressedCorpus,
                    strings_per_segment: int = 4096) -> "SegmentedCorpus":
        if strings_per_segment < 1:
            raise ValueError("strings_per_segment must be >= 1")
        n = corpus.n_strings
        segments: list[Segment] = []
        for base in range(0, n, strings_per_segment):
            hi = min(base + strings_per_segment, n)
            b0, b1 = int(corpus.offsets[base]), int(corpus.offsets[hi])
            segments.append(Segment(
                index=len(segments), base_id=base,
                payload=corpus.payload[b0:b1],
                offsets=(corpus.offsets[base : hi + 1] - b0).astype(np.int64)))
        return cls(segments=segments, strings_per_segment=strings_per_segment,
                   n_strings=n, raw_bytes=corpus.raw_bytes)

    def route(self, gid: int) -> tuple[Segment, int]:
        """Global string id -> (segment, local id). Raises IndexError when
        out of range (negative ids included — the store is an id-addressed
        service, not a Python sequence)."""
        if not 0 <= gid < self.n_strings:
            raise IndexError(
                f"string id {gid} out of range [0, {self.n_strings})")
        seg = self.segments[bisect.bisect_right(self._base_ids, gid) - 1]
        return seg, gid - seg.base_id

    def string_tokens(self, gid: int) -> np.ndarray:
        seg, local = self.route(gid)
        return seg.string_tokens(local)

    def token_counts(self) -> np.ndarray:
        """Tokens per string over the whole corpus, in global id order."""
        if self.n_strings == 0:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate([s.token_counts() for s in self.segments])

    @property
    def n_segments(self) -> int:
        return len(self.segments)
