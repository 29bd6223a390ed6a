"""OnPair as a byte-level subword tokenizer for LM training/serving.

The paper (§2.2) notes BPE's dual life as a compressor and an NLP subword
tokenizer; OnPair's dictionary has exactly the same shape (65,536 substrings,
2-byte IDs) but trains orders of magnitude faster. This module turns a
trained OnPair16 dictionary into the framework's tokenizer: the LM vocabulary
IS the compression dictionary, so the data pipeline's compressed corpus can
be fed to the model *without ever materialising raw text* — token IDs come
straight out of the stored compressed payload.

The port's copy of ``repro.core.tokenizer``: the same ids, byte for byte,
from the port's own OnPair trainer and host parser.

Special IDs live in a small reserved band appended after the dictionary
(65536..65536+n_special), so vocab_size = 65536 + n_special (still << typical
LM vocab sizes; configs may also round up for shardability).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.artifact import DictArtifact
from repro_torch.core.onpair import OnPairCompressor, OnPairConfig
from repro_torch.core.packed import PackedDictionary

PAD_ID = 65536
BOS_ID = 65537
EOS_ID = 65538
N_SPECIAL = 3
VOCAB_SIZE = 65536 + N_SPECIAL


@dataclass
class OnPairTokenizer:
    compressor: OnPairCompressor

    @property
    def dictionary(self) -> PackedDictionary:
        assert self.compressor.dictionary is not None
        return self.compressor.dictionary

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    @classmethod
    def train(cls, strings: list[bytes], sample_bytes: int = 8 << 20,
              seed: int = 0, threshold: int | None = None) -> "OnPairTokenizer":
        comp = OnPairCompressor(OnPairConfig.onpair16(
            sample_bytes=sample_bytes, seed=seed, threshold=threshold))
        comp.train(strings)
        return cls(comp)

    @classmethod
    def from_dictionary(cls, dictionary: PackedDictionary) -> "OnPairTokenizer":
        comp = OnPairCompressor(OnPairConfig.onpair16())
        comp.dictionary = dictionary
        return cls(comp)

    @classmethod
    def from_artifact(cls, artifact: DictArtifact) -> "OnPairTokenizer":
        return cls(OnPairCompressor.from_artifact(artifact))

    def to_artifact(self) -> DictArtifact:
        return self.compressor.to_artifact()

    # ----------------------------------------------------------------- encode
    def encode(self, text: bytes, bos: bool = False, eos: bool = False) -> np.ndarray:
        ids = self.compressor._parser().parse(text)
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return np.asarray(ids, dtype=np.int32)

    def encode_batch(self, texts: list[bytes], **kw) -> list[np.ndarray]:
        return [self.encode(t, **kw) for t in texts]

    # ----------------------------------------------------------------- decode
    def decode(self, ids: np.ndarray) -> bytes:
        entries = self.dictionary.entries
        out = []
        for t in np.asarray(ids).reshape(-1):
            t = int(t)
            if t < 65536 and t < len(entries):
                out.append(entries[t])
        return b"".join(out)

    def decode_fast(self, ids: np.ndarray) -> bytes:
        """Vectorised decode (Algorithm 3 path) for non-special streams."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        ids = ids[ids < len(self.dictionary.entries)]
        return self.dictionary.decode_tokens(ids)

    def save(self, path: str) -> None:
        self.dictionary.save(path)

    @classmethod
    def load(cls, path: str) -> "OnPairTokenizer":
        return cls.from_dictionary(PackedDictionary.load(path))
