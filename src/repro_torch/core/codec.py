"""Encoder / Decoder over a frozen OnPair16 dictionary, on one device.

    dictionary = PackedDictionary.build(train_dictionary(strings, cfg).entries)
    corpus = Encoder(dictionary).encode(strings)          # encode kernel
    Decoder(dictionary).multiget(corpus, [17, 3])         # decode kernel

``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the kernels' plain
PyTorch versions. Both give byte-identical results.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import CompressedCorpus
from repro_torch.core.packed import PackedDictionary
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict


class Encoder:
    """Per-string encoder: every string is compressed on its own."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict,
                 device: str | torch.device = "cuda"):
        self._device = OnPairDevice(dictionary, device)

    def encode(self, strings: list[bytes]) -> CompressedCorpus:
        """Compress every string independently into one corpus."""
        toks = self._device.encode_bucketed(strings)
        counts = np.fromiter((t.size for t in toks), dtype=np.int64,
                             count=len(toks))
        offsets = np.zeros(len(toks) + 1, dtype=np.int64)
        np.cumsum(counts * 2, out=offsets[1:])
        payload = (np.concatenate(toks).astype("<u2").view(np.uint8)
                   if len(toks) else np.zeros(0, dtype=np.uint8))
        return CompressedCorpus(payload=payload, offsets=offsets,
                                raw_bytes=sum(len(s) for s in strings),
                                meta={"compressor": "onpair16"})

    def encode_one(self, s: bytes) -> bytes:
        """Compressed payload of a single string."""
        return self._device.encode_to_bytes([s])[0]


class Decoder:
    """Random-access decoder over a compressed corpus."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict,
                 device: str | torch.device = "cuda"):
        self._device = OnPairDevice(dictionary, device)

    def access(self, corpus: CompressedCorpus, i: int) -> bytes:
        """Random access: string ``i`` alone."""
        return self.multiget(corpus, [i])[0]

    def multiget(self, corpus: CompressedCorpus, ids) -> list[bytes]:
        """Batched random access; one kernel launch."""
        lists = [np.asarray(corpus.string_tokens(int(i)), dtype=np.int32)
                 for i in ids]
        return self._device.multiget_decode(lists)
