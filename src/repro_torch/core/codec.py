"""Encoder / Decoder over a frozen OnPair16 dictionary, on one device.

    dictionary = PackedDictionary.build(train_dictionary(strings, cfg).entries)
    corpus = Encoder(dictionary).encode(strings)          # encode kernel
    Encoder(DictArtifact.load("dict.rpa"))                # or a saved artifact
    Decoder(dictionary).multiget(corpus, [17, 3])         # decode kernel
    Decoder(dictionary).decode_all(corpus)                # stream kernel

``device`` defaults to ``"cuda"``; ``device="cpu"`` runs the kernels' plain
PyTorch versions. Both give byte-identical results. ``Encoder`` also takes
an :class:`~repro_torch.kernels.ops.OnPairDevice`, used as it is on its own
device (a store's query and tail encoders share the store's: no second
upload of the tables).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import CompressedCorpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.packed import PackedDictionary
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict


class Encoder:
    """Per-string encoder: every string is compressed on its own."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact
                 | OnPairDevice, device: str | torch.device = "cuda"):
        self._device = (dictionary if isinstance(dictionary, OnPairDevice)
                        else OnPairDevice(dictionary, device))

    def encode(self, strings: list[bytes]) -> CompressedCorpus:
        """Compress every string independently into one corpus."""
        tokens, counts = self._device.encode_flat(strings)
        offsets = np.zeros(len(strings) + 1, dtype=np.int64)
        np.cumsum(counts * 2, out=offsets[1:])
        payload = tokens.astype("<u2").view(np.uint8)
        return CompressedCorpus(payload=payload, offsets=offsets,
                                raw_bytes=sum(map(len, strings)),
                                meta={"compressor": "onpair16"})

    def encode_one(self, s: bytes) -> bytes:
        """Compressed payload of a single string."""
        return self._device.encode_to_bytes([s])[0]


class Decoder:
    """Random-access decoder over a compressed corpus."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact,
                 device: str | torch.device = "cuda"):
        self._device = OnPairDevice(dictionary, device)

    @property
    def dictionary(self) -> PackedDictionary | None:
        """The frozen host dictionary, or None when the decoder was built
        over device tables alone."""
        return self._device.dictionary

    def decode_all(self, corpus: CompressedCorpus) -> bytes:
        """Full decompression: every string of the corpus, concatenated, in
        one call of the stream kernel."""
        return self._device.decode_stream(corpus.payload.view("<u2"))

    def access(self, corpus: CompressedCorpus, i: int) -> bytes:
        """Random access: string ``i`` alone."""
        return self.multiget(corpus, [i])[0]

    def multiget(self, corpus: CompressedCorpus, ids) -> list[bytes]:
        """Batched random access: the strings' tokens go up back to back,
        unpadded, and decode in one kernel launch."""
        lists = [np.asarray(corpus.string_tokens(int(i)), dtype=np.int32)
                 for i in ids]
        return self._device.multiget_decode(lists)
