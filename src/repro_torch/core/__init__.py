"""The paper's codecs — OnPair / OnPair16 and the baselines it is evaluated
against (BPE, FSST-like, block-based zlib/zstd, RAW) — the frozen
dictionary layouts, the codec API and the files they are saved in.

  artifact — DictArtifact: the trained dictionary as an immutable,
             serializable value (the reference's container, byte for byte)
  api      — CompressedCorpus (payload + offsets, save/load), the
             StringCompressor interface, RawCompressor
  onpair   — OnPairConfig, train_dictionary (the paper's training pass),
             OnPairCompressor for both variants
  bpe, fsst, blockcomp — the baselines of the paper's Table 3
  registry — every codec by name, with its capabilities
  packed   — PackedDictionary: decode + static-LPM layouts
  lpm      — the training LPM and the host batch parse
  codec    — Encoder / Decoder: OnPair16 on the kernels, every other codec
             on the host
  index    — SegmentIndex: the reverse-lookup index of a sealed segment

Only ``"onpair16"`` is ``device_decodable``; the other codecs run on the
host, as in the reference, which has no device kernel for them. The
reference's deprecated ``ALL_COMPRESSORS`` facade is not ported: use
``registry.create(name)`` and ``registry.names()``.
"""

from repro_torch.core import registry
from repro_torch.core.api import (CompressedCorpus, RawCompressor, TrainStats,
                                  pack_corpus)
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.blockcomp import ZlibBlockCompressor, ZstdBlockCompressor
from repro_torch.core.bpe import BPECompressor
from repro_torch.core.fsst import FSSTCompressor
from repro_torch.core.index import SegmentIndex
from repro_torch.core.onpair import (MAX_TOKENS, OnPairCompressor, OnPairConfig,
                                     auto_threshold, make_onpair,
                                     make_onpair16, train_dictionary)
from repro_torch.core.packed import PackedDictionary
from repro_torch.core.registry import CodecCaps, CodecSpec


def __getattr__(name: str):
    """Encoder and Decoder load on first use: ``codec`` imports the kernel
    bridge, which imports modules of this package."""
    if name in ("Encoder", "Decoder"):
        from repro_torch.core import codec
        return getattr(codec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BPECompressor", "CodecCaps", "CodecSpec", "CompressedCorpus",
           "Decoder", "DictArtifact", "Encoder", "FSSTCompressor",
           "MAX_TOKENS", "OnPairCompressor", "OnPairConfig",
           "PackedDictionary", "RawCompressor", "SegmentIndex", "TrainStats",
           "ZlibBlockCompressor", "ZstdBlockCompressor", "auto_threshold",
           "make_onpair", "make_onpair16", "pack_corpus", "registry",
           "train_dictionary"]
