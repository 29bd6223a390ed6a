"""Deterministic, host-sharded token batch pipeline.

Design (1000+ node posture):

* **Global shuffle, random access** — documents are sampled by a seeded
  permutation over the compressed store (OnPair's per-string independence is
  what makes random-access sampling free; block-compressed corpora would pay
  a block decode per draw).
* **Host sharding** — host ``h`` of ``H`` owns rows ``[h*B/H, (h+1)*B/H)`` of
  every global batch; no host ever materialises another host's shard.
* **Deterministic resume** — batch ``k`` is a pure function of
  (seed, k, host): after a restart the loop continues from the checkpointed
  step with identical data order. No iterator state needs checkpointing.
* **Sequence packing** — documents are concatenated (EOS-separated) into a
  per-row stream and sliced into fixed (seq_len + 1) windows; targets are the
  usual one-token shift. A per-row document cursor derived from the step
  index keeps packing deterministic without global coordination.

The port's copy of ``repro.data.pipeline`` (numpy only): its batches equal
the reference's token for token on the same store.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.tokenizer import EOS_ID, PAD_ID
from repro_torch.data.corpus import CompressedCorpusStore


@dataclass
class BatchSpec:
    global_batch: int
    seq_len: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class TokenPipeline:
    """Maps (step, row) -> token window, deterministically."""

    def __init__(self, store: CompressedCorpusStore, spec: BatchSpec):
        self.store = store
        self.spec = spec
        # Document order: one global permutation per epoch, derived from seed.
        self._n_docs = store.n_docs
        self._doc_lens = store.doc_lengths_tokens() + 1  # +1 for EOS

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng((self.spec.seed, epoch))
        return rng.permutation(self._n_docs)

    def _row_stream(self, row: int, need: int, start_doc: int, epoch: int) -> np.ndarray:
        """Concatenate EOS-separated docs from the permuted order until
        ``need`` tokens are available, starting at document ``start_doc``."""
        perm = self._epoch_perm(epoch)
        out = np.empty(need + 4096, dtype=np.int32)
        n = 0
        d = start_doc
        while n < need:
            doc = self.store.doc_tokens(int(perm[d % self._n_docs]))
            take = doc.size + 1
            if n + take > out.size:
                out = np.concatenate([out, np.empty(need + take, np.int32)])
            out[n : n + doc.size] = doc
            out[n + doc.size] = EOS_ID
            n += take
            d += 1
        return out[:need]

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Host-local slice of global batch ``step``.

        Returns {"tokens": (host_batch, seq_len) int32,
                 "targets": (host_batch, seq_len) int32}.
        """
        spec = self.spec
        need = spec.seq_len + 1
        hb = spec.host_batch
        tokens = np.empty((hb, need), dtype=np.int32)
        # Row r of the global batch advances through its own document lane:
        # lane = global_row, cursor = step * docs_per_step_estimate. Using a
        # per-(step,row) seeded draw keeps rows independent and resumable.
        avg_len = max(8.0, float(self._doc_lens.mean()))
        docs_per_window = int(np.ceil(need / avg_len)) + 1
        for r in range(hb):
            grow = spec.host_id * hb + r
            lane_offset = grow * 1_000_003  # de-correlate lanes
            start_doc = lane_offset + step * docs_per_window
            epoch = (step * docs_per_window * spec.global_batch) // max(1, self._n_docs)
            tokens[r] = self._row_stream(grow, need, start_doc, epoch)
        return {"tokens": tokens[:, :-1].copy(),
                "targets": tokens[:, 1:].copy()}

    def padded_eval_batch(self, texts: list[bytes], seq_len: int) -> dict[str, np.ndarray]:
        """Tokenize + pad raw strings (serving/eval path)."""
        ids = self.store.tokenizer.encode_batch(texts, bos=True)
        out = np.full((len(texts), seq_len), PAD_ID, dtype=np.int32)
        for i, seq in enumerate(ids):
            n = min(seq.size, seq_len)
            out[i, :n] = seq[:n]
        return {"tokens": out,
                "lengths": np.array([min(len(s), seq_len) for s in ids],
                                    dtype=np.int32)}
