"""OnPair16 training, the frozen dictionary layouts, the codec API and the
files they are saved in.

  artifact — DictArtifact: the trained dictionary as an immutable,
             serializable value (the reference's container, byte for byte)
  api      — CompressedCorpus: payload + offsets, save/load
  onpair   — OnPairConfig, train_dictionary (the paper's training pass)
  packed   — PackedDictionary: decode + static-LPM layouts
  codec    — Encoder / Decoder on the kernels
  index    — SegmentIndex: the reverse-lookup index of a sealed segment
"""

from repro_torch.core.api import CompressedCorpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.index import SegmentIndex
from repro_torch.core.onpair import (MAX_TOKENS, OnPairConfig, auto_threshold,
                                     train_dictionary)
from repro_torch.core.packed import PackedDictionary


def __getattr__(name: str):
    """Encoder and Decoder load on first use: ``codec`` imports the kernel
    bridge, which imports modules of this package."""
    if name in ("Encoder", "Decoder"):
        from repro_torch.core import codec
        return getattr(codec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CompressedCorpus", "DictArtifact", "Decoder", "Encoder",
           "MAX_TOKENS", "OnPairConfig", "PackedDictionary", "SegmentIndex",
           "auto_threshold", "train_dictionary"]
