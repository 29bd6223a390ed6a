"""CompressedStringStore — batched random-access serving over an OnPair16 corpus.

A frozen dictionary plus a :class:`~repro_torch.core.api.CompressedCorpus`
become a store answering ``get(i)`` / ``multiget(ids)``.

Hot path (``multiget``): cache misses are routed through the segment layer
to their token streams, *length-bucketed* into a small set of padded
``(batch_size, cap)`` shapes, and decoded by the per-string decode kernel
(:func:`repro_torch.kernels.onpair_decode.decode_compact` via
``OnPairDevice.multiget_decode``). The bucket capacities come from quantiles
of the corpus's token counts, as in the reference store, so a batch pads
its rows to a nearby length rather than to the longest string.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.api import CompressedCorpus
from repro_torch.core.codec import Encoder
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict
from repro_torch.obs import TRACER
from repro_torch.store.cache import LRUCache
from repro_torch.store.segment import SegmentedCorpus
from repro_torch.store.stats import StoreStats

#: quantiles of the corpus token-count distribution that seed the bucket
#: capacities (the last one is stretched to cover the true maximum).
_BUCKET_QUANTILES = (0.5, 0.9, 0.99, 1.0)


def _ceil8(x: int) -> int:
    return max(8, (int(x) + 7) // 8 * 8)


class CompressedStringStore:
    """Queryable in-memory store over one compressed corpus.

    ``dictionary`` is the frozen :class:`PackedDictionary` the corpus was
    encoded with, or its tables already on ``device`` as a
    :class:`DeviceDict` (see :mod:`repro_torch.convert`).
    """

    def __init__(self, dictionary: PackedDictionary | DeviceDict,
                 corpus: CompressedCorpus, *,
                 device: str | torch.device = "cuda",
                 strings_per_segment: int = 4096,
                 cache_bytes: int = 8 << 20, batch_size: int = 256,
                 num_buckets: int = 4):
        if num_buckets < 1 or num_buckets > len(_BUCKET_QUANTILES):
            raise ValueError(f"num_buckets must be in 1..{len(_BUCKET_QUANTILES)}")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._device = OnPairDevice(dictionary, device)
        self.backend = self._device.device.type
        self.corpus = corpus
        self.segments = SegmentedCorpus.from_corpus(corpus, strings_per_segment)
        self.cache = LRUCache(cache_bytes)
        self.batch_size = int(batch_size)
        self.num_buckets = int(num_buckets)
        self._lock = threading.Lock()
        self.stats = StoreStats(backend=self.backend)
        self._set_bucket_caps(corpus.token_counts())

    def _set_bucket_caps(self, counts: np.ndarray) -> None:
        """Length buckets: token capacities from corpus quantiles."""
        if counts.size == 0:
            caps = [8]
        else:
            qs = _BUCKET_QUANTILES[-self.num_buckets:]
            caps = sorted({_ceil8(np.quantile(counts, q)) for q in qs})
            max_count = int(counts.max())
            if caps[-1] < max_count:
                caps.append(_ceil8(max_count))
                if len(caps) > self.num_buckets:
                    caps = caps[-self.num_buckets:]
        self.bucket_caps = np.asarray(caps, dtype=np.int64)

    @classmethod
    def build(cls, strings: list[bytes], *, sample_bytes: int = 4 << 20,
              seed: int = 0, device: str | torch.device = "cuda",
              **store_kw) -> "CompressedStringStore":
        """Train an OnPair16 dictionary on ``strings``, encode them through
        the encode kernel, and open a store over the result."""
        device = resolve_device(device)
        result = train_dictionary(
            strings, OnPairConfig.onpair16(sample_bytes=sample_bytes, seed=seed))
        dictionary = PackedDictionary.build(result.entries)
        corpus = Encoder(dictionary, device=device).encode(strings)
        return cls(dictionary, corpus, device=device, **store_kw)

    # ---------------------------------------------------------------- queries
    @property
    def n_strings(self) -> int:
        return self.segments.n_strings

    def __len__(self) -> int:
        return self.n_strings

    @property
    def memory_bytes(self) -> int:
        """Resident footprint: compressed payload + offsets on the host, the
        dictionary tables on the device, and the decoded-string cache."""
        seg_bytes = sum(s.payload_bytes + s.offsets.nbytes
                        for s in self.segments.segments)
        return seg_bytes + self._device.dd.nbytes + self.cache.current_bytes

    def get(self, i: int) -> bytes:
        """Point lookup of string ``i``."""
        return self.multiget([i])[0]

    def multiget(self, ids) -> list[bytes]:
        """Batched point lookup; duplicates decode once, order is preserved.

        Raises IndexError if any id is out of ``[0, n_strings)`` (before any
        decode work happens).
        """
        t0 = time.perf_counter()
        ids = [int(i) for i in ids]
        n = self.n_strings
        for i in ids:
            if not 0 <= i < n:
                raise IndexError(f"string id {i} out of range [0, {n})")
        with self._lock:
            results: dict[int, bytes] = {}
            misses: list[int] = []
            for i in ids:  # unique-preserving cache probe: duplicates decode once
                if i in results:
                    continue
                hit = self.cache.get(i)
                if hit is not None:
                    results[i] = hit
                else:
                    results[i] = b""  # claimed; overwritten by decode below
                    misses.append(i)
            if misses:
                with TRACER.span("store.decode", batch=len(misses),
                                 backend=self.backend):
                    self._decode_misses(misses, results)
            out = [results[i] for i in ids]
        self.stats.record_multiget(len(ids), time.perf_counter() - t0)
        return out

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot(self.cache.stats())
        snap.update(backend=self.backend, n_strings=self.n_strings,
                    n_segments=self.segments.n_segments,
                    bucket_caps=[int(c) for c in self.bucket_caps],
                    memory_bytes=self.memory_bytes)
        return snap

    # --------------------------------------------------------------- internals
    def _decode_misses(self, misses: list[int], results: dict[int, bytes]) -> None:
        token_lists = [np.asarray(self.segments.string_tokens(i), dtype=np.int32)
                       for i in misses]
        counts = np.asarray([t.size for t in token_lists], dtype=np.int64)
        if int(counts.max()) > int(self.bucket_caps[-1]):
            # a string longer than every bucket grows a new top bucket instead
            # of indexing past the table; growth is geometric (at least 2x the
            # previous top) so longer and longer strings mint O(log) shapes
            self.bucket_caps = np.append(
                self.bucket_caps,
                max(_ceil8(int(counts.max())), 2 * int(self.bucket_caps[-1])))
        buckets = np.searchsorted(self.bucket_caps, counts, side="left")
        for b in np.unique(buckets):
            cap = int(self.bucket_caps[int(b)])
            members = np.flatnonzero(buckets == b)
            for c0 in range(0, len(members), self.batch_size):
                chunk = members[c0 : c0 + self.batch_size]
                t0 = time.perf_counter()
                decoded = self._device.multiget_decode(
                    [token_lists[k] for k in chunk], pad_tokens=cap,
                    pad_batch=self.batch_size)
                dt = time.perf_counter() - t0
                for k, val in zip(chunk, decoded):
                    results[misses[k]] = val
                self.stats.record_decode_batch(
                    (self.batch_size, cap), len(chunk),
                    sum(len(v) for v in decoded), dt)
        for i in misses:
            self.cache.put(i, results[i])
