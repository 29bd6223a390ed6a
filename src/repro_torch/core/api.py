"""The interface every codec implements, the compressed-corpus layout they
all produce, and its file form.

A *corpus* is a list of independent byte strings (paper: rows of a string
column). Codecs turn it into a :class:`CompressedCorpus` — one payload blob
plus per-string byte offsets (per-block for the block codecs) — so ratio,
compression speed, decompression speed and random access are measured the
same way across OnPair/OnPair16/BPE/FSST/LZ-block/RAW.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.artifact import (DictArtifact, dump_container,
                                       load_container, read_container,
                                       write_container)


@dataclass
class CompressedCorpus:
    """Concatenated compressed strings + offsets (random-access layout).

    For the token-stream codecs (OnPair, OnPair16, BPE) each string's slice
    of ``payload`` is a stream of little-endian u16 token IDs, so every
    per-string slice has even length. The block codecs' offsets index
    blocks, and their meta maps strings to blocks.
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

    def string_payload(self, i: int) -> bytes:
        return self.payload[int(self.offsets[i]) : int(self.offsets[i + 1])].tobytes()

    def string_tokens(self, i: int) -> np.ndarray:
        """u16 token IDs of string ``i`` — a zero-copy view of the payload."""
        o0, o1 = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.payload[o0:o1].view("<u2")

    def token_counts(self) -> np.ndarray:
        """Tokens per string, i64[n_strings] (2 bytes per token ID)."""
        return ((self.offsets[1:] - self.offsets[:-1]) // 2).astype(np.int64)

    def slice_strings(self, lo: int, hi: int) -> "CompressedCorpus":
        """Sub-corpus covering string ids [lo, hi) with rebased offsets.

        raw_bytes is pro-rated by payload share (exact per-string raw sizes
        are not stored), as the reference pro-rates it."""
        meta = dict(self.meta)
        if "str_block" in meta:
            raise ValueError("slice_strings: block-layout corpora cannot be "
                             "sliced on string boundaries")
        b0, b1 = int(self.offsets[lo]), int(self.offsets[hi])
        share = ((b1 - b0) / self.payload.size if self.payload.size
                 else (hi - lo) / max(1, self.n_strings))
        return CompressedCorpus(
            payload=self.payload[b0:b1],
            offsets=(self.offsets[lo : hi + 1] - b0).astype(np.int64),
            raw_bytes=int(round(self.raw_bytes * share)), meta=meta)

    # ------------------------------------------------------------- persistence
    # The reference's container and header, byte for byte: a corpus saved by
    # either package loads in the other.
    def _split_meta(self) -> tuple[dict, dict]:
        """meta -> (json-able scalars, ndarray sections); drops caches."""
        scalars, arrays = {}, {}
        for k, v in self.meta.items():
            if k.startswith("_"):
                continue  # transient (e.g. a block decode cache)
            if isinstance(v, np.ndarray):
                arrays[f"meta.{k}"] = v
            else:
                scalars[k] = v
        return scalars, arrays

    def _header_arrays(self) -> tuple[dict, dict]:
        scalars, meta_arrays = self._split_meta()
        header = {"kind": "compressed_corpus", "format_version": 1,
                  "raw_bytes": int(self.raw_bytes), "meta": scalars}
        return header, {"payload": self.payload, "offsets": self.offsets,
                        **meta_arrays}

    def save(self, path: str) -> None:
        """Persist payload + offsets + meta in the shared artifact container."""
        write_container(path, *self._header_arrays())

    def to_bytes(self) -> bytes:
        return dump_container(*self._header_arrays())

    @classmethod
    def _from_parsed(cls, header: dict, arrays: dict) -> "CompressedCorpus":
        if header.get("kind") != "compressed_corpus":
            raise ValueError(f"container holds {header.get('kind')!r}, "
                             "not a compressed_corpus")
        meta = dict(header.get("meta", {}))
        for k, v in arrays.items():
            if k.startswith("meta."):
                meta[k[len("meta."):]] = v
        return cls(payload=np.asarray(arrays["payload"], dtype=np.uint8),
                   offsets=np.asarray(arrays["offsets"], dtype=np.int64),
                   raw_bytes=int(header["raw_bytes"]), meta=meta)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "CompressedCorpus":
        """Load a saved corpus; with ``mmap=True`` payload and offsets are
        read-only maps of the file (copy before writing or handing them to
        torch)."""
        header, arrays = read_container(path, mmap=mmap)
        return cls._from_parsed(header, arrays)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompressedCorpus":
        return cls._from_parsed(*load_container(data))


@dataclass
class TrainStats:
    train_seconds: float = 0.0
    sample_bytes: int = 0
    dict_entries: int = 0
    dict_data_bytes: int = 0
    dict_total_bytes: int = 0


class StringCompressor(abc.ABC):
    """Train-once, compress/decompress-many string codec on the host.

    The trained state freezes into an immutable :class:`DictArtifact`
    (``to_artifact`` / ``from_artifact``), so a dictionary trained on one
    host reopens on another without retraining.
    """

    name: str = "base"

    @abc.abstractmethod
    def train(self, strings: list[bytes], dataset_bytes: int | None = None) -> TrainStats:
        """Build the dictionary/model from (a sample of) the corpus."""

    @abc.abstractmethod
    def compress(self, strings: list[bytes]) -> CompressedCorpus:
        """Compress every string independently (field-level) or in blocks."""

    @abc.abstractmethod
    def decompress_all(self, corpus: CompressedCorpus) -> bytes:
        """Sequentially decode the full corpus; returns concatenated strings."""

    @abc.abstractmethod
    def access(self, corpus: CompressedCorpus, i: int) -> bytes:
        """Random access: materialise string ``i`` alone."""

    def to_artifact(self) -> DictArtifact:
        """Freeze the trained state into a serializable artifact."""
        raise NotImplementedError(f"{self.name}: to_artifact not implemented")

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "StringCompressor":
        """Reconstruct a ready codec from an artifact (no retraining)."""
        raise NotImplementedError(f"{cls.__name__}: from_artifact not implemented")


def pack_corpus(parts: list[bytes], raw_bytes: int, **meta) -> CompressedCorpus:
    """Per-string payloads -> one corpus: each part is copied once, straight
    into the payload array."""
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offsets[1:])
    payload = np.empty(int(offsets[-1]), dtype=np.uint8)
    view = memoryview(payload.data)
    pos = 0
    for p in parts:
        view[pos : pos + len(p)] = p
        pos += len(p)
    return CompressedCorpus(payload=payload, offsets=offsets,
                            raw_bytes=raw_bytes, meta=dict(meta))


class RawCompressor(StringCompressor):
    """Uncompressed baseline (paper's RAW row)."""

    name = "raw"

    def train(self, strings, dataset_bytes=None) -> TrainStats:
        return TrainStats()

    def compress(self, strings):
        return pack_corpus(strings, sum(len(s) for s in strings),
                           compressor=self.name)

    def decompress_all(self, corpus):
        return corpus.payload.tobytes()

    def access(self, corpus, i):
        return corpus.string_payload(i)

    def to_artifact(self) -> DictArtifact:
        return DictArtifact.from_config("raw")

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "RawCompressor":
        return cls()
