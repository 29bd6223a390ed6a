"""OnPair-compressed in-memory corpus store — the paper's workload as the
framework's data plane.

The training corpus lives in host DRAM *compressed* (one CompressedCorpus:
payload blob + per-string offsets). Because OnPair compresses every string
independently, the global-shuffle sampler random-accesses single documents
exactly like the paper's 1M-point-query benchmark — no block decompression,
no order constraints. And because the compression dictionary doubles as the
tokenizer vocabulary (repro_torch.core.tokenizer), a stored compressed document's
u16 payload IS its LM token sequence: sampling a document costs a slice, not
a decode.

The port's copy of ``repro.data.corpus``: it compresses on the host, with
the port's own OnPair trainer and parser.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.api import CompressedCorpus
from repro_torch.core.tokenizer import OnPairTokenizer


@dataclass
class CompressedCorpusStore:
    tokenizer: OnPairTokenizer
    corpus: CompressedCorpus

    @classmethod
    def build(cls, strings: list[bytes], sample_bytes: int = 8 << 20,
              seed: int = 0) -> "CompressedCorpusStore":
        tok = OnPairTokenizer.train(strings, sample_bytes=sample_bytes, seed=seed)
        corpus = tok.compressor.compress(strings)
        return cls(tokenizer=tok, corpus=corpus)

    @property
    def n_docs(self) -> int:
        return self.corpus.n_strings

    @property
    def compression_ratio(self) -> float:
        return self.corpus.ratio

    @property
    def memory_bytes(self) -> int:
        return (self.corpus.compressed_bytes + self.corpus.offsets.nbytes
                + self.tokenizer.dictionary.total_bytes)

    def doc_tokens(self, i: int) -> np.ndarray:
        """Token IDs of document ``i`` — a pure slice of the stored payload."""
        return np.asarray(self.corpus.string_tokens(i), dtype=np.int32)

    def doc_bytes(self, i: int) -> bytes:
        """Random-access decode of document ``i`` (the paper's point query)."""
        comp = self.tokenizer.compressor
        return comp.access(self.corpus, i)

    def doc_lengths_tokens(self) -> np.ndarray:
        return ((self.corpus.offsets[1:] - self.corpus.offsets[:-1]) // 2).astype(np.int64)
