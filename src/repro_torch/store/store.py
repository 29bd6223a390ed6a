"""CompressedStringStore — batched random-access serving over a compressed
corpus of any token-stream codec (OnPair16 on the card, OnPair and BPE on
the host).

A frozen dictionary plus a :class:`~repro_torch.core.api.CompressedCorpus`
become a store answering ``get(i)`` / ``multiget(ids)`` / ``scan(lo, hi)``.
The codec's registry capability decides where it serves, and nothing else
does: a ``device_decodable`` codec (``"onpair16"``) serves from the device
as set out below; any other token-stream codec (``"onpair"``, ``"bpe"``)
serves on the host, as the reference's numpy backend does — one vectorised
``PackedDictionary.decode_tokens`` a multiget and a segment's range a scan,
queries encoded by its host codec — with no device mirror and no device
codec, and reports ``backend == "numpy"``. Non-token-stream codecs (FSST,
the block codecs, raw) are refused, as the reference refuses them.

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

Reverse lookup (``locate``, ``scan_prefix``): the reference's per-segment
:class:`~repro_torch.core.index.SegmentIndex`, built on first use from the
segment's strings read through the stream kernel; queries encode through
the encode kernel and compare in compressed form.

Persistence (``save``/``open``): the reference's directory layout and
bytes (``dictionary.rpa``, ``corpus.rpc``, ``store.json`` and the optional
``index.npz`` and ``cold-NNNN.rlz``), so a store saved by either package
opens in the other. The device mirror is not saved: ``open`` rebuilds it
from the corpus, as a build does, and takes the cold segments back off it.

Tiering (``enable_tiering``, :mod:`repro_torch.store.tier`): a demoted
segment's strings leave the device mirror and are served from RLZ factors
on the host; multiget splits its misses into cold and hot first (the hot
ones keep their one launch), and scan splits its range at cold segments
(one stream call per hot run).
"""

from __future__ import annotations

import heapq
import json
import os
import threading
import time
from dataclasses import asdict
from itertools import islice

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.api import CompressedCorpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.codec import Encoder, refuse_device
from repro_torch.core.index import (SegmentIndex, dump_indexes, fingerprints,
                                    load_indexes)
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.device import resolve_device, same_device
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict
from repro_torch.obs import TRACER
from repro_torch.store.cache import LRUCache
from repro_torch.store.resident import ResidentSegments
from repro_torch.store.segment import SegmentedCorpus
from repro_torch.store.stats import StoreStats
from repro_torch.store.tier import TierManager

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


def write_json_atomic(path: str, obj: dict) -> None:
    """Write JSON via temp-file + rename so readers never see a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


def _split_by_lengths(decoded: bytes, raw_lens) -> list[bytes]:
    """One decoded byte run split into strings of the given lengths."""
    b = np.concatenate(([0], np.cumsum(raw_lens, dtype=np.int64))).tolist()
    return [decoded[lo:hi] for lo, hi in zip(b, b[1:])]


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

    ``dictionary`` is the source of the corpus's dictionary:

    * an OnPair16 dictionary for the device: the frozen
      :class:`PackedDictionary` the corpus was encoded with, its tables
      already on ``device`` as a :class:`DeviceDict` (see
      :mod:`repro_torch.convert`), or an :class:`OnPairDevice`: the store
      saves that codec's artifact and decodes and encodes on it, with no
      upload of its own, so several stores (the shards of
      :mod:`repro_torch.distributed`) share one copy of the tables on the
      card. ``device`` then defaults to the codec's and must name the same
      device;
    * a saved :class:`DictArtifact` of any token-stream codec, or a trained
      host codec (``registry.create(name)`` after ``train``), or an
      ``(artifact, host codec)`` pair already loaded (the shards of a host
      codec share one). An ``"onpair16"`` one goes to the device
      (``device`` defaults to ``"cuda"``); any other serves on the host, and
      an explicit ``device`` for it raises ValueError.

    ``config`` is the OnPair16 training configuration the dictionary came
    from, where it is known (``build`` passes its own, an artifact carries
    one); the writable store retrains with it, and ``save`` writes it into
    the artifact. A host codec carries its own.
    """

    #: bumped by a writable store's compact(); locate re-encodes its queries
    #: when a swap lands between their encode and the probe
    version_id = 0

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact
                 | OnPairDevice,
                 corpus: CompressedCorpus, *,
                 config: OnPairConfig | None = None,
                 device: str | torch.device | None = None,
                 strings_per_segment: int = 4096,
                 cache_bytes: int = 8 << 20, batch_size: int = 256,
                 num_buckets: int = 4):
        if num_buckets < 1 or num_buckets > len(_BUCKET_QUANTILES):
            raise ValueError(f"num_buckets must be in 1..{len(_BUCKET_QUANTILES)}")
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._artifact: DictArtifact | None = None
        #: the host codec of a codec with no kernel; None on the device path
        self.compressor = None
        #: the device codec; None on the host path
        self._device: OnPairDevice | None = None
        dictionary = self._open_source(dictionary, device)
        if isinstance(dictionary, DictArtifact):
            self._artifact = dictionary
            if config is None and dictionary.config and self._device is not None:
                config = OnPairConfig(**dictionary.config)
        self.config = config if self._device is not None else None
        self.backend = "numpy" if self._device is None else self._device.device.type
        self.corpus = corpus
        self.segments = SegmentedCorpus.from_corpus(corpus, strings_per_segment)
        #: the device mirror of the sealed segments; None on the host path
        self.resident: ResidentSegments | None = None
        if self._device is not None:
            self.resident = ResidentSegments(self._device)
            self.resident.append(corpus.payload, corpus.offsets)
        self.cache = LRUCache(cache_bytes)
        self.batch_size = int(batch_size)
        self.num_buckets = int(num_buckets)
        self._lock = threading.Lock()
        # reverse-lookup state: per-segment indexes (built on the first
        # locate/scan_prefix, at seal time once anyone has located) and the
        # query encoder (built on first use: most stores never locate)
        self._seg_indexes: dict[int, SegmentIndex] = {}
        self._locate_encoder: Encoder | None = None
        #: the directory the store was opened from (the cold tier's default
        #: home); None for a store built in memory
        self._home: str | None = None
        self.stats = StoreStats(backend=self.backend)
        self._set_bucket_caps(corpus.token_counts())
        #: hot/cold tiering; None until enable_tiering()
        self.tier: TierManager | None = None

    def _open_source(self, source, device):
        """Set ``_device`` or ``compressor`` from the dictionary source; the
        artifact it carries (or None) comes back for ``__init__``."""
        if isinstance(source, OnPairDevice):
            if device is not None and not same_device(torch.device(device),
                                                      source.device):
                raise ValueError(f"the shared device codec is on "
                                 f"{source.device}, not {device}")
            self._device = source
            return source.artifact
        if isinstance(source, (PackedDictionary, DeviceDict)):
            self._device = OnPairDevice(source, "cuda" if device is None else device)
            return None
        if isinstance(source, tuple):          # (artifact, its host codec)
            artifact, codec = source
        elif isinstance(source, DictArtifact):
            artifact, codec = source, None
        else:                                  # a trained codec
            artifact, codec = None, source
        name = artifact.codec if artifact is not None else codec.name
        on_device = registry.capabilities(name).device_decodable
        if codec is None and not on_device:
            codec = registry.codec_from_artifact(artifact)
        # the reference's checks, in its order and wording
        if codec is not None and getattr(codec, "dictionary", None) is None:
            raise ValueError("source must be a trained token-stream codec "
                             "or a DictArtifact (train() first)")
        if on_device:
            if artifact is None:
                artifact = codec.to_artifact()
            self._device = OnPairDevice(
                codec.dictionary if codec is not None else artifact,
                "cuda" if device is None else device)
            return artifact
        if not registry.capabilities(codec.name).token_stream:
            raise ValueError("store requires a token-stream codec "
                             f"(registry capability), got {codec.name!r}")
        refuse_device(name, device)
        self.compressor = codec
        return artifact

    @property
    def dictionary(self) -> PackedDictionary | None:
        """The frozen host dictionary: the host codec's, or the device
        codec's where it was built from one (None over bare device tables)."""
        if self._device is None:
            return self.compressor.dictionary
        return self._device.dictionary

    @property
    def codec_name(self) -> str:
        """The registry name of the store's codec."""
        return "onpair16" if self._device is not None else self.compressor.name

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
    def build(cls, strings: list[bytes], *, codec: str | None = None,
              variant16: bool = True, sample_bytes: int = 4 << 20,
              seed: int = 0, device: str | torch.device | None = None,
              **store_kw) -> "CompressedStringStore":
        """Train a dictionary on ``strings``, compress them, open a store.

        ``codec`` is any registered token-stream codec name; ``variant16``
        maps to ``"onpair16"``/``"onpair"`` when ``codec`` is None, as in
        the reference. OnPair16 trains here and encodes through the encode
        kernel on ``device`` (default ``"cuda"``); any other codec trains
        and compresses on the host, and takes no ``device``."""
        if codec is None:
            codec = "onpair16" if variant16 else "onpair"
        caps = registry.capabilities(codec)
        if not caps.token_stream:
            raise ValueError("store requires a token-stream codec "
                             f"(registry capability), got {registry.resolve(codec)!r}")
        if not caps.device_decodable:
            refuse_device(codec, device)
            comp = registry.create(codec, sample_bytes=sample_bytes, seed=seed)
            comp.train(strings)
            return cls(comp, comp.compress(strings), **store_kw)
        device = resolve_device("cuda" if device is None else device)
        config = OnPairConfig.onpair16(sample_bytes=sample_bytes, seed=seed)
        dictionary = PackedDictionary.build(
            train_dictionary(strings, config).entries)
        corpus = Encoder(dictionary, device=device).encode(strings)
        return cls(dictionary, corpus, config=config, device=device, **store_kw)

    # ------------------------------------------------------------- persistence
    #: directory layout written by save() / read by open(), the reference's
    _DICT_FILE = "dictionary.rpa"
    _CORPUS_FILE = "corpus.rpc"
    _META_FILE = "store.json"
    #: optional reverse-lookup sidecar; open() validates it against the live
    #: segmentation and drops a segment's index on any mismatch
    _INDEX_FILE = "index.npz"
    #: manifest of the versioned (writable-store) directory layout
    _CURRENT_FILE = "current.json"
    #: construction params persisted in store.json and restored by open()
    _STORE_KW = ("strings_per_segment", "cache_bytes", "batch_size",
                 "num_buckets")

    @property
    def artifact(self) -> DictArtifact:
        """The store's dictionary as an immutable, serializable artifact:
        the host codec's, or codec ``"onpair16"`` with the training config
        where known. Over bare device tables the entries are read back from
        them."""
        if self._artifact is None and self.compressor is not None:
            self._artifact = self.compressor.to_artifact()
        if self._artifact is None:
            d = self._device.dictionary
            entries = d.entries if d is not None else self._device.dd.entries()
            self._artifact = DictArtifact.from_entries(
                "onpair16", entries,
                config=asdict(self.config) if self.config is not None else None)
        return self._artifact

    def snapshot_corpus(self) -> CompressedCorpus:
        """The store's full compressed payload as one corpus. The writable
        store flattens its sealed segments and tail instead."""
        return self.corpus

    def store_meta(self, **extra) -> dict:
        """The store.json payload: codec + construction params (+ extras)."""
        meta = {"format_version": 1, "codec": self.artifact.codec,
                "n_strings": self.n_strings,
                "strings_per_segment": self.segments.strings_per_segment,
                "cache_bytes": self.cache.capacity_bytes,
                "batch_size": self.batch_size,
                "num_buckets": self.num_buckets}
        meta.update(extra)
        return meta

    def save(self, dir_path: str) -> None:
        """Persist dictionary artifact + compressed corpus + store config
        (and the reverse-lookup indexes built so far) so :meth:`open` serves
        identical results without retraining."""
        os.makedirs(dir_path, exist_ok=True)
        self.artifact.save(os.path.join(dir_path, self._DICT_FILE))
        self.corpus.save(os.path.join(dir_path, self._CORPUS_FILE))
        with self._lock:
            blob = self._dump_index_locked()
            tier_meta = self._tier_meta_locked()
        write_json_atomic(os.path.join(dir_path, self._META_FILE),
                          self.store_meta(**tier_meta))
        if blob is not None:
            with open(os.path.join(dir_path, self._INDEX_FILE), "wb") as f:
                f.write(blob)
        if tier_meta:
            self.tier.copy_cold_files(tier_meta["cold_segments"], dir_path)

    @classmethod
    def _read_meta(cls, dir_path: str) -> dict:
        """A saved store's ``store.json``."""
        with open(os.path.join(dir_path, cls._META_FILE)) as f:
            return json.load(f)

    @classmethod
    def open_corpus_dir(cls, dir_path: str, source,
                        mmap: bool = True, **overrides) -> "CompressedStringStore":
        """Open a directory holding corpus.rpc + store.json against an
        already-loaded artifact, or a codec opened from one that several
        stores share (the shards of one sharded directory): an
        :class:`OnPairDevice`, or an ``(artifact, host codec)`` pair."""
        meta = cls._read_meta(dir_path)
        corpus = CompressedCorpus.load(
            os.path.join(dir_path, cls._CORPUS_FILE), mmap=mmap)
        kw = {k: meta[k] for k in cls._STORE_KW}
        kw.update(overrides)
        store = cls(source, corpus, **kw)
        store._home = dir_path
        store._load_index(dir_path)
        store._attach_tier(dir_path, meta)
        return store

    @classmethod
    def _resolve_current(cls, dir_path: str) -> str:
        """Follow a versioned directory's ``current.json`` manifest to its
        current generation subdirectory; a plain flat store directory
        resolves to itself."""
        cur = os.path.join(dir_path, cls._CURRENT_FILE)
        if os.path.exists(cur):
            with open(cur) as f:
                return os.path.join(dir_path, json.load(f)["current"])
        return dir_path

    @classmethod
    def open(cls, dir_path: str, mmap: bool = True,
             device: str | torch.device | None = None, source=None,
             **overrides) -> "CompressedStringStore":
        """Open a saved store (either package's): map the artifact and
        corpus, no retraining; for OnPair16 the dictionary's tables and the
        device mirror are built from them as at build (``device`` defaults
        to ``"cuda"``), any other codec serves on the host. ``source``, a
        codec already opened from this store's dictionary (see
        :meth:`open_corpus_dir`), is used instead of the saved artifact.
        ``overrides`` replace saved construction params. A versioned
        (writable-store) directory opens read-only at its current
        generation."""
        dir_path = cls._resolve_current(dir_path)
        if source is None:
            source = DictArtifact.load(
                os.path.join(dir_path, cls._DICT_FILE), mmap=mmap)
        return cls.open_corpus_dir(dir_path, source, mmap=mmap, device=device,
                                   **overrides)

    # ----------------------------------------------------------------- tiering
    def enable_tiering(self, **params) -> TierManager:
        """Get-or-create the store's :class:`TierManager`. Parameters apply
        on first creation; a later call with thresholds updates them."""
        if self.tier is None:
            self.tier = TierManager(self, **params)
        elif params:
            for k in ("demote_below", "promote_above", "halflife_s"):
                if k in params:
                    setattr(self.tier, k, float(params[k]))
        return self.tier

    def _tier_home(self) -> str | None:
        """Where the cold tier writes when given no ``workdir``: the
        directory this store was opened from, None for one built in memory.
        The writable store names its current generation instead."""
        return self._home

    def _tier_meta_locked(self) -> dict:
        """store.json extras describing the tier state (``{}`` when the tier
        is off or empty, so an untiered save stays as it was)."""
        if self.tier is None or not self.tier.cold:
            return {}
        return {"tier_params": self.tier.params(),
                "cold_segments": self.tier.cold_items_locked()}

    def _attach_tier(self, dir_path: str, meta: dict) -> None:
        """Re-adopt the cold segments a save listed (after ``_load_index``,
        so both sidecars validate against the same live segmentation)."""
        cold = meta.get("cold_segments")
        if not cold:
            return
        self.enable_tiering(**meta.get("tier_params", {})).attach(dir_path, cold)

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

    def _tail_locate(self, payload: bytes) -> int | None:
        """Tail-local id of the string whose encoded form is ``payload``.
        Call under ``self._lock``; the read-only store has no tail."""
        return None

    def _tail_prefix_hits(self, prefix: bytes,
                          after: tuple[bytes, int] | None
                          ) -> list[tuple[bytes, int]]:
        """Sorted ``(string, gid)`` tail matches of ``prefix`` past the
        ``after`` cursor. Call under ``self._lock``."""
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
        token starts, spare room included; cold segments' tokens are not
        there; 0 on the host path); not part of ``memory_bytes``, which
        counts what the reference counts."""
        return self.resident.device_bytes if self.resident is not None else 0

    @property
    def memory_bytes(self) -> int:
        """Resident footprint, the reference's quantity: compressed payload +
        offsets of every sealed segment, the dictionary's
        ``resident_bytes`` (decode matrix and LPM tables included; over bare
        device tables the same count taken from them, see
        :attr:`OnPairDevice.resident_bytes`), the decoded-string cache, and
        any unsealed tail payload. Cold segments do not count: their
        payload and offsets are ``np.memmap`` views over their ``cold-*.rlz``
        container. The tables' bytes on the device are
        ``stats_snapshot()["device_dict_bytes"]``."""
        cold = self.tier.cold if self.tier is not None else ()
        seg_bytes = sum(s.payload_bytes + s.offsets.nbytes
                        for s in self.segments.segments if s.index not in cold)
        dict_bytes = (self._device.resident_bytes if self._device is not None
                      else self.dictionary.resident_bytes)
        return (seg_bytes + dict_bytes
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
            if self.tier is not None:
                self.tier.note_reads_locked(arr)
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
        ``_SCAN_MAX_TOKENS`` tokens, and one per run of hot segments between
        cold ones, whose strings decode from RLZ), split on per-string byte
        boundaries. Ranges may extend past the sealed segments into an
        unsealed tail, which takes one more call."""
        n = self.n_strings
        if not (0 <= lo <= hi <= n):
            raise IndexError(f"scan range [{lo}, {hi}) not within [0, {n}]")
        with self._lock:
            out = self._scan_locked(lo, hi)
            self.stats.scan_strings += hi - lo
        return out

    def _scan_locked(self, lo: int, hi: int) -> list[bytes]:
        out: list[bytes] = []
        sealed = self.segments.n_strings
        s_hi = min(hi, sealed)
        for seg, a, b in self._scan_parts_locked(lo, s_hi):
            if seg is None and self._device is None:
                out.extend(self._scan_host_locked(a, b))
            elif seg is None:
                out.extend(self._scan_mirror_locked(a, b))
            else:
                out.extend(self.tier.decode_range_locked(
                    seg.index, a - seg.base_id, b - seg.base_id))
        if hi > sealed:
            out.extend(self._tail_scan(max(lo, sealed) - sealed, hi - sealed))
        return out

    def _scan_parts_locked(self, lo: int, hi: int) -> list[tuple]:
        """The sealed range [lo, hi) in id order as ``(segment, a, b)``
        parts: a cold segment's strings, or (``segment`` None) a run of hot
        strings, whose tokens lie back to back in the mirror."""
        if lo >= hi:
            return []
        if self.tier is None or not self.tier.cold:
            return [(None, lo, hi)]
        parts: list[tuple] = []
        for seg in self.segments.overlapping(lo, hi):
            a, b = max(lo, seg.base_id), min(hi, seg.base_id + seg.n_strings)
            if a >= b:
                continue
            if seg.index in self.tier.cold:
                parts.append((seg, a, b))
            elif parts and parts[-1][0] is None:
                parts[-1] = (None, parts[-1][1], b)
            else:
                parts.append((None, a, b))
        return parts

    def _scan_host_locked(self, lo: int, hi: int) -> list[bytes]:
        """Host path: hot sealed strings [lo, hi), each segment's covered
        slice one token stream through ``decode_tokens``, split on the
        strings' byte boundaries (the reference's numpy scan)."""
        out: list[bytes] = []
        for seg in self.segments.overlapping(lo, hi):
            l0 = max(lo, seg.base_id) - seg.base_id
            l1 = min(hi, seg.base_id + seg.n_strings) - seg.base_id
            if l0 >= l1:
                continue
            tokens = np.asarray(seg.tokens(l0, l1), dtype=np.int64)
            out.extend(self._split_decoded(self.dictionary.decode_tokens(tokens),
                                           tokens, seg.token_counts()[l0:l1]))
        return out

    def _split_decoded(self, decoded: bytes, tokens: np.ndarray,
                       counts: np.ndarray) -> list[bytes]:
        """Split one decoded byte run back into per-string slices (host
        path), the strings' lengths summed from the entry lengths."""
        tok_lens = self.dictionary.lens[tokens].astype(np.int64)
        byte_cum = np.zeros(tokens.size + 1, dtype=np.int64)
        np.cumsum(tok_lens, out=byte_cum[1:])
        return _split_by_lengths(
            decoded, np.diff(byte_cum[np.concatenate(([0], np.cumsum(counts)))]))

    def _scan_mirror_locked(self, lo: int, hi: int) -> list[bytes]:
        """Hot sealed strings [lo, hi), back to back in the mirror, in one
        stream call per ``_SCAN_MAX_TOKENS`` tokens."""
        out: list[bytes] = []
        starts = self.resident.host_starts
        tokens, _ = self.resident.on_device()
        a = lo
        while a < hi:
            # the strings from a whose tokens fit in one call, at least one
            b = int(np.searchsorted(starts, starts[a] + _SCAN_MAX_TOKENS,
                                    "right")) - 1
            b = min(max(b, a + 1), hi)
            out.extend(self._device.decode_span(
                tokens[int(starts[a]) : int(starts[b])],
                self.resident.raw_lens[a:b]))
            a = b
        return out

    # ---------------------------------------------------------- reverse lookup
    #: optimistic encode attempts before locate takes the store lock for the
    #: whole encode+probe: a compact() swapping the dictionary between the
    #: query parse and the probe would compare encodings of two generations
    _MAX_LOCATE_RETRIES = 3

    def locate(self, s: bytes) -> int | None:
        """Exact-match reverse lookup: the id whose ``get`` returns ``s``.

        The query is encoded once against the store's dictionary (the encode
        kernel) and compared in *compressed* form. Duplicated strings
        resolve to their lowest id; absent strings return ``None``.
        """
        return self.locate_batch([s])[0]

    def locate_batch(self, strings) -> list[int | None]:
        """Batched :meth:`locate`; one encode pass, order preserved."""
        strings = [bytes(s) for s in strings]
        if not strings:
            return []
        t0 = time.perf_counter()
        out = None
        for _ in range(self._MAX_LOCATE_RETRIES):
            version = self.version_id
            queries = self._encode_queries(strings)
            with self._lock:
                if self.version_id == version:
                    out = self._locate_corpus_locked(queries)
                    break
            # compact() swapped generations mid-parse: re-encode and retry
        if out is None:
            # retries exhausted: encode under the store lock itself, where no
            # swap can interleave
            with self._lock:
                out = self._locate_corpus_locked(
                    self._query_encoder().encode(strings))
        n_hits = sum(1 for r in out if r is not None)
        self.stats.record_locate(len(strings), n_hits, time.perf_counter() - t0)
        return out

    def scan_prefix(self, prefix: bytes, limit: int | None = 100,
                    after: tuple[bytes, int] | None = None
                    ) -> list[tuple[int, bytes]]:
        """Strings starting with ``prefix``: ``[(id, string), ...]`` in
        ``(string, id)`` order.

        Served from the per-segment sorted sidecars (binary search + one
        independent decode per probed entry, each a launch of the decode
        kernel unless the cache holds it) merged with a linear filter over
        the unsealed tail. ``after`` is an exclusive ``(string, id)`` resume
        cursor for pagination; ``limit=None`` returns every match.
        """
        prefix = bytes(prefix)
        with self._lock:
            runs: list[list[tuple[bytes, int]]] = []
            for seg in self.segments.segments:
                if seg.n_strings == 0:
                    continue
                idx = self._segment_index_locked(seg)
                base = seg.base_id
                seg_after = ((after[0], after[1] - base)
                             if after is not None else None)
                hits = idx.scan_prefix(
                    prefix, limit,
                    lambda loc, b=base: self._decode_one_locked(b + loc),
                    after=seg_after)
                if hits:
                    runs.append([(s, base + loc) for loc, s in hits])
            tail_hits = self._tail_prefix_hits(prefix, after)
            if tail_hits:
                runs.append(tail_hits)
            merged = heapq.merge(*runs)
            if limit is not None:
                merged = islice(merged, limit)
            out = [(gid, s) for s, gid in merged]
        self.stats.prefix_scans += 1
        self.stats.scan_strings += len(out)
        return out

    def _query_encoder(self) -> Encoder:
        """Encoder for query strings over the store's device tables. The
        writable store returns its tail encoder instead (the same
        generation's tables)."""
        if self._locate_encoder is None:
            self._locate_encoder = (
                Encoder(self._device) if self._device is not None
                else Encoder(self.artifact, codec=self.compressor))
        return self._locate_encoder

    def _encode_queries(self, strings: list[bytes]) -> CompressedCorpus:
        """The queries in compressed form, current dictionary generation."""
        return self._query_encoder().encode(strings)

    def _locate_corpus_locked(self, queries: CompressedCorpus) -> list[int | None]:
        """Probe sealed segments in id order, then the tail: each query's
        first byte-verified hit is its lowest global id. The queries'
        fingerprints are taken once, and each segment's table is probed for
        every query still unanswered at once."""
        buf = queries.payload.tobytes()
        off = queries.offsets.tolist()
        payloads = [buf[a:b] for a, b in zip(off, off[1:])]
        fps = fingerprints(queries.payload, queries.offsets)
        out = np.full(len(payloads), -1, dtype=np.int64)
        pending = np.arange(len(payloads))
        for seg in self.segments.segments:
            if not pending.size:
                break
            if seg.n_strings == 0:
                continue
            idx = self._segment_index_locked(seg)
            loc = idx.locate_many(fps[pending], [payloads[q] for q in pending],
                                  seg.payload, seg.offsets)
            hit = loc >= 0
            out[pending[hit]] = seg.base_id + loc[hit]
            pending = pending[~hit]
        sealed = self.segments.n_strings
        for q in pending.tolist():
            loc = self._tail_locate(payloads[q])
            if loc is not None:
                out[q] = sealed + loc
        return [None if v < 0 else v for v in out.tolist()]

    def _segment_index_locked(self, seg) -> SegmentIndex:
        """The segment's reverse-lookup index, built on first use from its
        strings read through the stream kernel. The count re-check guards
        against segment-slot reuse."""
        idx = self._seg_indexes.get(seg.index)
        if idx is not None and idx.n == seg.n_strings:
            return idx
        raw = self._scan_locked(seg.base_id, seg.base_id + seg.n_strings)
        idx = SegmentIndex.build(seg.payload, seg.offsets, raw)
        self._seg_indexes[seg.index] = idx
        return idx

    def _decode_one_locked(self, gid: int) -> bytes:
        """One string through the LRU cache (scan_prefix's probe path)."""
        hit = self.cache.get(gid)
        if hit is not None:
            return hit
        val = self._decode_misses(np.asarray([gid], dtype=np.int64))[0]
        self.cache.put(gid, val)
        return val

    def _dump_index_locked(self) -> bytes | None:
        """Serialised sidecar of every up-to-date segment index, or None
        when nothing is built (a lazy rebuild is cheaper than a forced
        decode of segments nobody has located in)."""
        live: dict[int, tuple[int, SegmentIndex]] = {}
        for seg in self.segments.segments:
            idx = self._seg_indexes.get(seg.index)
            if idx is not None and seg.n_strings and idx.n == seg.n_strings:
                live[seg.index] = (seg.base_id, idx)
        return dump_indexes(live) if live else None

    def _load_index(self, dir_path: str) -> None:
        """Adopt a persisted index sidecar if it matches the live
        segmentation (position + base id + count); mismatches are dropped
        per segment and rebuilt lazily."""
        path = os.path.join(dir_path, self._INDEX_FILE)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        with self._lock:
            layout = {seg.index: (seg.base_id, seg.n_strings)
                      for seg in self.segments.segments if seg.n_strings}
            self._seg_indexes.update(load_indexes(data, layout))

    def stats_snapshot(self) -> dict:
        snap = self.stats.snapshot(self.cache.stats())
        snap.update(backend=self.backend, n_strings=self.n_strings,
                    n_sealed_strings=self.n_sealed,
                    n_tail_strings=self._tail_n(),
                    n_segments=self.segments.n_segments,
                    bucket_caps=[int(c) for c in self.bucket_caps],
                    memory_bytes=self.memory_bytes,
                    device_dict_bytes=(self._device.dd.nbytes
                                       if self._device is not None else 0))
        if self.tier is not None:
            snap["tier"] = self.tier.snapshot()
        return snap

    # --------------------------------------------------------------- internals
    def _decode_misses(self, misses: np.ndarray) -> np.ndarray:
        """Decode the missed ids (unique, in first-seen order) into an object
        array of bytes: those in cold segments from RLZ on the host (they
        count in ``cold_lookups``), the others on the device (see
        :meth:`_decode_hot`)."""
        if self.tier is None or not self.tier.cold:
            return self._decode_hot(misses)
        is_cold, groups = self.tier.split_misses_locked(misses)
        decoded = np.empty(misses.size, dtype=object)
        if groups:
            self.tier.decode_misses_locked(misses, groups, decoded)
        hot = ~is_cold
        if hot.any():
            decoded[hot] = self._decode_hot(misses[hot])
        return decoded

    def _decode_hot(self, misses: np.ndarray) -> np.ndarray:
        """Decode missed ids outside cold segments: every sealed one in one
        launch from the device mirror (per ``_DECODE_MAX_ROWS`` ids), every
        tail one in a second launch with host tokens.

        The stats keep the reference's accounting, which launched a padded
        ``(batch_size, cap)`` batch per chunk of ``batch_size`` misses of
        each length bucket: ``batches``, ``padded_rows`` and ``jit_shapes``
        count those chunks, computed from the misses' token counts, and so
        equal the reference's after the same multigets. The port's own
        launches (one or two a call) are what ``decode_compact.launches``,
        ``repro_kernel_decode_batches_total`` and the ``kernel.decode_batch``
        spans count.
        """
        if self._device is None:
            return self._decode_host(misses)
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

    def _decode_host(self, misses: np.ndarray) -> np.ndarray:
        """Host path (the reference's numpy decode): every miss's tokens,
        sealed and tail, concatenate into one token stream, decoded by
        ``decode_tokens`` in one vectorised pass and split per string; the
        stats count one unpadded batch, as the reference's do."""
        t0 = time.perf_counter()
        sealed = self.segments.n_strings
        lists = []
        for gid in misses.tolist():
            if gid < sealed:
                seg, local = self.segments.route(gid)
                o0, o1 = int(seg.offsets[local]), int(seg.offsets[local + 1])
                lists.append(np.asarray(seg.payload[o0:o1]).view("<u2"))
            else:
                lists.extend(self._tail_token_lists(np.asarray([gid - sealed])))
        counts = np.fromiter(map(len, lists), dtype=np.int64, count=len(lists))
        tokens = (np.concatenate(lists).astype(np.int64) if lists
                  else np.zeros(0, dtype=np.int64))
        raw = self.dictionary.decode_tokens(tokens)
        decoded = np.empty(misses.size, dtype=object)
        decoded[:] = self._split_decoded(raw, tokens, counts)
        self.stats.record_decode(
            {(misses.size, int(counts.max()) if counts.size else 0): 1},
            misses.size, len(raw), time.perf_counter() - t0, jitted=False)
        return decoded
