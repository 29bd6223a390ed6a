"""Encoder / Decoder over a frozen dictionary: on the device for OnPair16, on
the host for every other codec of the registry.

    dictionary = PackedDictionary.build(train_dictionary(strings, cfg).entries)
    corpus = Encoder(dictionary).encode(strings)          # encode kernel
    Encoder(DictArtifact.load("dict.rpa"))                # or a saved artifact
    Decoder(dictionary).multiget(corpus, [17, 3])         # decode kernel
    Decoder(dictionary).decode_all(corpus)                # stream kernel
    Decoder(registry.train("bpe", strings)).access(corpus, 3)   # host codec

The codec's registry capability decides where it runs, and nothing else
does. A ``device_decodable`` codec (``"onpair16"``; a bare
:class:`PackedDictionary` or :class:`DeviceDict` counts as one) runs on
:class:`~repro_torch.kernels.ops.OnPairDevice`: ``device`` defaults to
``"cuda"``, and ``device="cpu"`` runs the kernels' plain PyTorch versions,
byte-identical. Any other codec runs its host codec
(``registry.codec_from_artifact``), as the reference's ``numpy`` backend
does; passing it a ``device`` raises ValueError. ``Encoder`` also takes an
:class:`OnPairDevice`, used as it is on its own device (a store's query and
tail encoders share the store's: no second upload of the tables).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.api import CompressedCorpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.packed import PackedDictionary
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict


def refuse_device(codec: str, device) -> None:
    """A codec with no kernel runs on the host: asking for a ``device`` for
    it raises ValueError, so nothing moves between host and device quietly."""
    if device is not None:
        raise ValueError(f"codec {codec!r} is not device-decodable "
                         "(registry capability); it runs on the host: pass "
                         "no device=")


def host_codec_for(artifact: DictArtifact, device=None, codec=None):
    """The ready host codec of an artifact whose codec has no kernel (``codec``
    where the caller already built it), or None for a ``device_decodable``
    one (see :func:`refuse_device`)."""
    if registry.capabilities(artifact.codec).device_decodable:
        return None
    refuse_device(artifact.codec, device)
    return codec if codec is not None else registry.codec_from_artifact(artifact)


def _open(dictionary, device, codec):
    """(device codec, None) or (None, host codec) for a dictionary source."""
    if isinstance(dictionary, OnPairDevice):
        return dictionary, None
    if isinstance(dictionary, DictArtifact):
        host = host_codec_for(dictionary, device, codec)
        if host is not None:
            return None, host
    return OnPairDevice(dictionary, "cuda" if device is None else device), None


class Encoder:
    """Per-string encoder: every string is compressed on its own. ``codec``
    optionally supplies the already-built host codec of a host artifact (a
    store's), so its tables are not rebuilt."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact
                 | OnPairDevice, device: str | torch.device | None = None,
                 codec=None):
        self._device, self._codec = _open(dictionary, device, codec)
        #: "numpy" on the host codec, else the device's type
        self.backend = ("numpy" if self._device is None
                        else self._device.device.type)

    def encode(self, strings: list[bytes]) -> CompressedCorpus:
        """Compress every string independently into one corpus."""
        if self._device is None:
            return self._codec.compress(strings)
        tokens, counts = self._device.encode_flat(strings)
        offsets = np.zeros(len(strings) + 1, dtype=np.int64)
        np.cumsum(counts * 2, out=offsets[1:])
        payload = tokens.astype("<u2").view(np.uint8)
        return CompressedCorpus(payload=payload, offsets=offsets,
                                raw_bytes=sum(map(len, strings)),
                                meta={"compressor": "onpair16"})

    def encode_one(self, s: bytes) -> bytes:
        """Compressed payload of a single string."""
        if self._device is None:
            return self._codec.compress([s]).string_payload(0)
        return self._device.encode_to_bytes([s])[0]


class Decoder:
    """Random-access decoder over a compressed corpus."""

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact,
                 device: str | torch.device | None = None):
        self._device, self._codec = _open(dictionary, device, None)
        self.backend = ("numpy" if self._device is None
                        else self._device.device.type)

    @property
    def dictionary(self) -> PackedDictionary | None:
        """The frozen host dictionary (token-stream codecs), or None when the
        decoder was built over device tables alone or the codec has none."""
        if self._device is not None:
            return self._device.dictionary
        return getattr(self._codec, "dictionary", None)

    def decode_all(self, corpus: CompressedCorpus) -> bytes:
        """Full decompression: every string of the corpus, concatenated; on
        the device in one call of the stream kernel."""
        if self._device is None:
            return self._codec.decompress_all(corpus)
        return self._device.decode_stream(corpus.payload.view("<u2"))

    def access(self, corpus: CompressedCorpus, i: int) -> bytes:
        """Random access: string ``i`` alone."""
        if self._device is None:
            return self._codec.access(corpus, i)
        return self.multiget(corpus, [i])[0]

    def multiget(self, corpus: CompressedCorpus, ids) -> list[bytes]:
        """Batched random access: on the device the strings' tokens go up
        back to back, unpadded, and decode in one kernel launch."""
        if self._device is None:
            return [self._codec.access(corpus, int(i)) for i in ids]
        lists = [np.asarray(corpus.string_tokens(int(i)), dtype=np.int32)
                 for i in ids]
        return self._device.multiget_decode(lists)
