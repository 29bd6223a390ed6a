"""CompressedStringStore — batched random-access serving over an OnPair16 corpus.

A frozen dictionary plus a :class:`~repro_torch.core.api.CompressedCorpus`
become a store answering ``get(i)`` / ``multiget(ids)`` / ``scan(lo, hi)``.

Hot path (``multiget``): the sealed segments live on the device too
(:class:`~repro_torch.store.resident.ResidentSegments`), so a multiget
dedupes its ids with numpy, probes the cache, and decodes every sealed miss
in one launch of the per-string decode kernel
(:func:`repro_torch.kernels.onpair_decode.decode_rows` via
``OnPairDevice.decode_ids``), sending up only ids and output offsets and
bringing down only the decoded bytes. Misses in a writable store's unsealed
tail take a second launch with their tokens sent from the host.

Range path (``scan``): the sealed strings of a range are one slice of the
device mirror's token buffer, decoded by one call of the stream kernel
(:func:`repro_torch.kernels.onpair_decode.decode_tokens` via
``OnPairDevice.decode_span``), with no token upload; the mirror's host copy
of the decoded lengths sizes the output and splits it per string. A
writable store's tail takes a second call.
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
from repro_torch.store.resident import ResidentSegments
from repro_torch.store.segment import SegmentedCorpus
from repro_torch.store.stats import StoreStats

#: quantiles of the corpus token-count distribution that seed the bucket
#: capacities (the last one is stretched to cover the true maximum).
_BUCKET_QUANTILES = (0.5, 0.9, 0.99, 1.0)
#: the most mirror tokens one stream call of a scan decodes (a longer string
#: takes a call of its own): bounds a call's output (16 B a token at most, so
#: 1 GiB), its pinned host copy and the kernel's 2**31-token limit, and keeps
#: a store of fewer tokens at one call a range
_SCAN_MAX_TOKENS = 2**26


def _ceil8(x: int) -> int:
    return max(8, (int(x) + 7) // 8 * 8)


def _id_array(ids) -> np.ndarray:
    """Requested ids as int64, converted in C where they are integers
    already (a list of ints, a range, an integer array)."""
    if not isinstance(ids, (np.ndarray, list, tuple, range)):
        ids = list(ids)
    arr = np.asarray(ids)
    if arr.dtype.kind not in "iu":
        arr = np.asarray([int(i) for i in arr.ravel()], dtype=np.int64)
    return arr.ravel().astype(np.int64, copy=False)


class CompressedStringStore:
    """Queryable in-memory store over one compressed corpus.

    ``dictionary`` is the frozen :class:`PackedDictionary` the corpus was
    encoded with, or its tables already on ``device`` as a
    :class:`DeviceDict` (see :mod:`repro_torch.convert`). ``config`` is the
    training configuration the dictionary came from, where it is known
    (``build`` passes its own); the writable store retrains with it.
    """

    def __init__(self, dictionary: PackedDictionary | DeviceDict,
                 corpus: CompressedCorpus, *,
                 config: OnPairConfig | None = None,
                 device: str | torch.device = "cuda",
                 strings_per_segment: int = 4096,
                 cache_bytes: int = 8 << 20, batch_size: int = 256,
                 num_buckets: int = 4):
        if num_buckets < 1 or num_buckets > len(_BUCKET_QUANTILES):
            raise ValueError(f"num_buckets must be in 1..{len(_BUCKET_QUANTILES)}")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._device = OnPairDevice(dictionary, device)
        self.config = config
        self.backend = self._device.device.type
        self.corpus = corpus
        self.segments = SegmentedCorpus.from_corpus(corpus, strings_per_segment)
        self.resident = ResidentSegments(self._device)
        self.resident.append(corpus.payload, corpus.offsets)
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
        config = OnPairConfig.onpair16(sample_bytes=sample_bytes, seed=seed)
        dictionary = PackedDictionary.build(
            train_dictionary(strings, config).entries)
        corpus = Encoder(dictionary, device=device).encode(strings)
        return cls(dictionary, corpus, config=config, device=device, **store_kw)

    # -------------------------------------------------------------- tail hooks
    # A store may hold strings beyond its sealed segments: the writable
    # subclass (repro_torch.store.mutable) keeps an open tail of appended
    # strings. The read path goes through these hooks so multiget, scan and
    # stats answer across sealed and tail strings; this store has no tail.
    def _tail_n(self) -> int:
        return 0

    def _tail_payload_bytes(self) -> int:
        return 0

    def _tail_token_lists(self, local: np.ndarray) -> list[np.ndarray]:
        raise IndexError("a read-only store has no tail strings")

    def _tail_scan(self, lo: int, hi: int) -> list[bytes]:
        return []

    # ---------------------------------------------------------------- queries
    @property
    def n_sealed(self) -> int:
        """Strings living in sealed (immutable) segments."""
        return self.segments.n_strings

    @property
    def n_strings(self) -> int:
        return self.segments.n_strings + self._tail_n()

    def __len__(self) -> int:
        return self.n_strings

    @property
    def resident_device_bytes(self) -> int:
        """Bytes the device mirror of the sealed segments holds (payload and
        token starts, spare room included); not part of ``memory_bytes``,
        which counts what the reference counts."""
        return self.resident.device_bytes

    @property
    def memory_bytes(self) -> int:
        """Resident footprint, the reference's quantity: compressed payload +
        offsets of every sealed segment, the dictionary's
        ``resident_bytes`` (decode matrix and LPM tables included; over bare
        device tables the same count taken from them, see
        :attr:`OnPairDevice.resident_bytes`), the decoded-string cache, and
        any unsealed tail payload. The tables' bytes on the device are
        ``stats_snapshot()["device_dict_bytes"]``."""
        seg_bytes = sum(s.payload_bytes + s.offsets.nbytes
                        for s in self.segments.segments)
        return (seg_bytes + self._device.resident_bytes
                + self.cache.current_bytes + self._tail_payload_bytes())

    def get(self, i: int) -> bytes:
        """Point lookup of string ``i``."""
        return self.multiget([i])[0]

    def multiget(self, ids) -> list[bytes]:
        """Batched point lookup; duplicates decode once, order is preserved.

        Raises IndexError if any id is out of ``[0, n_strings)`` (before any
        decode work happens). The ids are deduplicated in first-seen order
        and, where the cache has capacity, probed one by one in that order,
        as the reference does; a cache of no capacity counts every unique id
        as a miss at once.
        """
        t0 = time.perf_counter()
        arr = _id_array(ids)
        n = self.n_strings
        bad = (arr < 0) | (arr >= n)
        if bad.any():
            raise IndexError(f"string id {int(arr[bad.argmax()])} out of range [0, {n})")
        with self._lock:
            uniq, first, inverse = np.unique(arr, return_index=True,
                                             return_inverse=True)
            order = np.argsort(first)
            uniq = uniq[order]                      # first-seen order
            rank = np.empty_like(order)
            rank[order] = np.arange(order.size)
            vals = np.empty(uniq.size, dtype=object)
            if self.cache.capacity_bytes > 0:
                vals[:] = [self.cache.get(i) for i in uniq.tolist()]
                miss = np.equal(vals, None)
            else:
                self.cache.misses += uniq.size      # every probe would miss
                miss = np.ones(uniq.size, dtype=bool)
            misses = uniq[miss]
            if misses.size:
                with TRACER.span("store.decode", batch=int(misses.size),
                                 backend=self.backend):
                    decoded = self._decode_misses(misses)
                vals[miss] = decoded
                if self.cache.capacity_bytes > 0:
                    for i, val in zip(misses.tolist(), decoded):
                        self.cache.put(i, val)
            out = vals[rank[inverse.ravel()]].tolist()
        self.stats.record_multiget(arr.size, time.perf_counter() - t0)
        return out

    def scan(self, lo: int, hi: int) -> list[bytes]:
        """Decode the contiguous id range [lo, hi): its sealed strings in one
        call of the stream kernel over the device mirror (one per
        ``_SCAN_MAX_TOKENS`` tokens), split on per-string byte boundaries. Ranges may extend past the sealed
        segments into an unsealed tail, which takes one more call."""
        n = self.n_strings
        if not (0 <= lo <= hi <= n):
            raise IndexError(f"scan range [{lo}, {hi}) not within [0, {n}]")
        with self._lock:
            out = self._scan_locked(lo, hi)
            self.stats.scan_strings += hi - lo
        return out

    def _scan_locked(self, lo: int, hi: int) -> list[bytes]:
        out: list[bytes] = []
        sealed = self.resident.n_strings
        s_hi = min(hi, sealed)
        if lo < s_hi:
            starts = self.resident.host_starts
            tokens, _ = self.resident.on_device()
            a = lo
            while a < s_hi:
                # the strings from a whose tokens fit in one call, at least one
                b = int(np.searchsorted(starts, starts[a] + _SCAN_MAX_TOKENS,
                                        "right")) - 1
                b = min(max(b, a + 1), s_hi)
                out.extend(self._device.decode_span(
                    tokens[int(starts[a]) : int(starts[b])],
                    self.resident.raw_lens[a:b]))
                a = b
        if hi > sealed:
            out.extend(self._tail_scan(max(lo, sealed) - sealed, hi - sealed))
        return out

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot(self.cache.stats())
        snap.update(backend=self.backend, n_strings=self.n_strings,
                    n_sealed_strings=self.n_sealed,
                    n_tail_strings=self._tail_n(),
                    n_segments=self.segments.n_segments,
                    bucket_caps=[int(c) for c in self.bucket_caps],
                    memory_bytes=self.memory_bytes,
                    device_dict_bytes=self._device.dd.nbytes)
        return snap

    # --------------------------------------------------------------- internals
    def _decode_misses(self, misses: np.ndarray) -> np.ndarray:
        """Decode the missed ids (unique, in first-seen order) into an object
        array of bytes: every sealed one in one launch from the device
        mirror (per ``_DECODE_MAX_ROWS`` ids), every tail one in a second
        launch with host tokens.

        The stats keep the reference's accounting, which launched a padded
        ``(batch_size, cap)`` batch per chunk of ``batch_size`` misses of
        each length bucket: ``batches``, ``padded_rows`` and ``jit_shapes``
        count those chunks, computed from the misses' token counts, and so
        equal the reference's after the same multigets. The port's own
        launches (one or two a call) are what ``decode_compact.launches``,
        ``repro_kernel_decode_batches_total`` and the ``kernel.decode_batch``
        spans count.
        """
        t0 = time.perf_counter()
        sealed = self.resident.n_strings
        in_tail = misses >= sealed
        head = misses[~in_tail]
        tail_local = misses[in_tail] - sealed
        tail_lists = self._tail_token_lists(tail_local) if tail_local.size else []
        counts = np.empty(misses.size, dtype=np.int64)
        counts[~in_tail] = self.resident.token_counts(head)
        counts[in_tail] = np.fromiter(map(len, tail_lists), dtype=np.int64,
                                      count=len(tail_lists))
        decoded = np.empty(misses.size, dtype=object)
        if head.size:
            tokens, starts = self.resident.on_device()
            decoded[~in_tail] = self._device.decode_ids(
                tokens, starts, head, self.resident.raw_lens[head])
        if tail_lists:
            decoded[in_tail] = self._device.multiget_decode(tail_lists)
        if int(counts.max()) > int(self.bucket_caps[-1]):
            # a string longer than every bucket grows a new top bucket instead
            # of indexing past the table; growth is geometric (at least 2x the
            # previous top) so longer and longer strings mint O(log) shapes
            self.bucket_caps = np.append(
                self.bucket_caps,
                max(_ceil8(int(counts.max())), 2 * int(self.bucket_caps[-1])))
        per_bucket = np.bincount(np.searchsorted(self.bucket_caps, counts,
                                                 side="left"))
        chunks = {(self.batch_size, int(self.bucket_caps[b])): -(-int(k) // self.batch_size)
                  for b, k in enumerate(per_bucket) if k}
        self.stats.record_decode(chunks, misses.size, sum(map(len, decoded)),
                                 time.perf_counter() - t0)
        return decoded
