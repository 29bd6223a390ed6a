"""Block-based baselines (paper §2.1, §4.4): zstd / zlib over 64 KiB blocks.

Strings are grouped into fixed-size blocks before compression so the LZ77
window can exploit cross-string redundancy; random access to string ``i``
requires decompressing its whole block. A one-block cache mirrors the paper's
setup ("when a string is requested, the entire 64 KiB block containing it is
decompressed and stored in memory") — under uniformly random queries the hit
rate is low, which is exactly the trade-off the paper measures.
"""

from __future__ import annotations

import zlib

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # optional: the zstd-block codec is then unavailable
    _zstd = None

from repro_torch.core.api import CompressedCorpus, StringCompressor, TrainStats
from repro_torch.core.artifact import DictArtifact


class BlockCompressor(StringCompressor):
    """Shared block machinery; subclasses provide codec_compress/decompress."""

    block_bytes = 64 * 1024

    def __init__(self, block_bytes: int = 64 * 1024):
        self.block_bytes = block_bytes

    # codec hooks -----------------------------------------------------------
    def codec_compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def codec_decompress(self, data: bytes) -> bytes:
        raise NotImplementedError

    # API -------------------------------------------------------------------
    def train(self, strings, dataset_bytes=None) -> TrainStats:
        return TrainStats()  # block codecs are trained per-block implicitly

    def to_artifact(self) -> DictArtifact:
        """Config-only artifact: block codecs carry no trained table."""
        return DictArtifact.from_config(self.name,
                                        {"block_bytes": self.block_bytes})

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "BlockCompressor":
        return cls(**artifact.config) if artifact.config else cls()

    def compress(self, strings) -> CompressedCorpus:
        blocks: list[bytes] = []
        # per-string: block id + offset inside the (uncompressed) block
        str_block = np.zeros(len(strings), dtype=np.int32)
        str_off = np.zeros(len(strings) + 1, dtype=np.int64)
        cur: list[bytes] = []
        cur_len = 0
        raw = 0
        block_payloads: list[bytes] = []
        for i, s in enumerate(strings):
            raw += len(s)
            if cur_len + len(s) > self.block_bytes and cur:
                block_payloads.append(self.codec_compress(b"".join(cur)))
                cur, cur_len = [], 0
            str_block[i] = len(block_payloads)
            str_off[i] = cur_len
            cur.append(s)
            cur_len += len(s)
        if cur:
            block_payloads.append(self.codec_compress(b"".join(cur)))
        # string end offsets: next string's start or block end; store lengths
        lens = np.array([len(s) for s in strings], dtype=np.int64)
        payload = np.frombuffer(b"".join(block_payloads), dtype=np.uint8).copy()
        boff = np.zeros(len(block_payloads) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in block_payloads], out=boff[1:])
        return CompressedCorpus(
            payload=payload,
            offsets=boff,  # block offsets (field-level offsets don't apply)
            raw_bytes=raw,
            meta=dict(compressor=self.name, str_block=str_block,
                      str_off=str_off[: len(strings)], str_len=lens),
        )

    def decompress_all(self, corpus) -> bytes:
        raw = corpus.payload.tobytes()
        parts = []
        for b in range(len(corpus.offsets) - 1):
            o0, o1 = int(corpus.offsets[b]), int(corpus.offsets[b + 1])
            parts.append(self.codec_decompress(raw[o0:o1]))
        return b"".join(parts)

    def access(self, corpus, i) -> bytes:
        blk = int(corpus.meta["str_block"][i])
        cache = corpus.meta.get("_cache")
        if cache is None or cache[0] != blk:
            o0, o1 = int(corpus.offsets[blk]), int(corpus.offsets[blk + 1])
            data = self.codec_decompress(corpus.payload[o0:o1].tobytes())
            corpus.meta["_cache"] = cache = (blk, data)
        off = int(corpus.meta["str_off"][i])
        return cache[1][off : off + int(corpus.meta["str_len"][i])]


class ZstdBlockCompressor(BlockCompressor):
    name = "zstd-block"

    def __init__(self, level: int = 3, block_bytes: int = 64 * 1024):
        super().__init__(block_bytes)
        assert _zstd is not None, "zstandard not available"
        self.level = level
        self._c = _zstd.ZstdCompressor(level=level)
        self._d = _zstd.ZstdDecompressor()

    def to_artifact(self) -> DictArtifact:
        return DictArtifact.from_config(
            self.name, {"level": self.level, "block_bytes": self.block_bytes})

    def codec_compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def codec_decompress(self, data: bytes) -> bytes:
        return self._d.decompress(data)


class ZlibBlockCompressor(BlockCompressor):
    """Stands in for the paper's LZ4 row (stdlib DEFLATE at low level)."""

    name = "zlib-block"

    def __init__(self, level: int = 1, block_bytes: int = 64 * 1024):
        super().__init__(block_bytes)
        self.level = level

    def to_artifact(self) -> DictArtifact:
        return DictArtifact.from_config(
            self.name, {"level": self.level, "block_bytes": self.block_bytes})

    def codec_compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def codec_decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)
