"""MutableStringStore — the write path of the port's store.

OnPair compresses every string on its own against a trained dictionary, so
new strings can be parsed against a frozen dictionary without retraining.
The writable store layers that lifecycle over
:class:`~repro_torch.store.store.CompressedStringStore`:

* ``append``/``extend`` parse incoming strings through the encode kernel
  (the port's :class:`~repro_torch.core.codec.Encoder`, sharing the store's
  device tables) into an open tail of per-string token-stream payloads; a
  store of a host codec (OnPair, BPE) parses them on that codec, decodes
  on the host, and keeps no device mirror;
* once the tail reaches ``strings_per_segment`` strings it is sealed into a
  new immutable segment, off-thread by default, and mirrored on the
  device; ``multiget`` (the decode kernel) and ``scan`` (the stream
  kernel, over the mirror and the tail's own tokens) answer across sealed
  segments and the tail the whole time;
* a :class:`~repro_torch.store.drift.DriftMonitor` watches the achieved
  ratio of appended data against the train-time ratio; ``compact()``
  re-trains a dictionary on the live data (with the store's
  :class:`~repro_torch.core.onpair.OnPairConfig`, or for a host codec
  through ``registry.codec_from_artifact``), re-encodes every string
  (through the encode kernel for OnPair16) and swaps the store's state under
  its lock
  (and, when the store is backed by a directory, writes a new versioned
  generation there).

On disk a writable store is the reference's *versioned* directory, which
either package opens::

    <dir>/current.json     atomic manifest: {"current": "v0000", ...}
    <dir>/v0000/           one flat store layout per dictionary generation
        dictionary.rpa       (the artifact, with the training config)
        corpus.rpc           (sealed segments + unsealed tail strings)
        store.json           (construction params + n_tail + drift state
                              + the cold set, when segments are demoted)
        index.npz            (reverse-lookup indexes, once anyone located)
        cold-NNNN.rlz        (the cold tier's demoted segments)
    <dir>/v0001/           written by compact(); the manifest swap is atomic

``open()`` also accepts a plain read-only store directory (no manifest).
"""

from __future__ import annotations

import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.core import registry
from repro_torch.core.api import CompressedCorpus
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.codec import Encoder
from repro_torch.core.index import SegmentIndex
from repro_torch.core.onpair import OnPairConfig, train_dictionary
from repro_torch.core.packed import PackedDictionary
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.kernels.ref import DeviceDict
from repro_torch.store.drift import DriftMonitor
from repro_torch.store.resident import ResidentSegments
from repro_torch.store.segment import SegmentedCorpus
from repro_torch.store.store import (CompressedStringStore, _split_by_lengths,
                                     write_json_atomic)


def _empty_corpus() -> CompressedCorpus:
    return CompressedCorpus(payload=np.zeros(0, dtype=np.uint8),
                            offsets=np.zeros(1, dtype=np.int64), raw_bytes=0)


def _corpus_payloads(corpus: CompressedCorpus) -> list[bytes]:
    """Per-string payload bytes via one buffer copy and slicing."""
    buf = corpus.payload.tobytes()
    off = corpus.offsets
    return [buf[off[i]:off[i + 1]] for i in range(corpus.n_strings)]


class MutableStringStore(CompressedStringStore):
    """Appendable store over a frozen dictionary, with drift-triggered
    compaction.

    ``corpus`` may be ``None`` to start an empty store that appends fill.
    ``config`` is the OnPair16 training configuration ``compact()`` retrains
    with: ``build`` passes the one it trained with, an artifact carries one,
    and a store opened over a dictionary without one defaults to
    ``OnPairConfig.onpair16()``. A host codec retrains with its own. Other
    keywords are the read store's; the codec must be token-stream.
    """

    #: optimistic encode attempts before extend() takes the store lock for
    #: the whole encode+ingest; bounds the compact-race retry (a compact()
    #: swapping the dictionary between parse and ingest invalidates the batch)
    _MAX_ENCODE_RETRIES = 3

    def __init__(self, dictionary: PackedDictionary | DeviceDict | DictArtifact
                 | OnPairDevice,
                 corpus: CompressedCorpus | None = None, *,
                 config: OnPairConfig | None = None,
                 drift_threshold: float = 0.2, auto_compact: bool = False,
                 train_ratio: float | None = None, async_seal: bool = True,
                 **store_kw):
        self._check_token_stream(dictionary)
        # tail state exists before the base constructor, which reads n_strings
        self._tail: list[bytes] = []       # compressed payload per string
        self._tail_raw: list[int] = []     # decoded byte length per string
        self._tail_bytes = 0
        self._n_total = 0
        # reverse-lookup tail map: compressed payload -> lowest tail-local
        # id; None until the first tail locate builds it, then kept by
        # ingest and seal, so the write path pays nothing before anyone
        # queries
        self._tail_map: dict[bytes, int] | None = None
        if corpus is None:
            corpus = _empty_corpus()
        super().__init__(dictionary, corpus, config=config, **store_kw)
        if self._device is not None:
            if self.config is None:
                self.config = OnPairConfig.onpair16()
            if self.config.max_entry_len is None or self.config.max_entry_len > 16:
                raise ValueError("compact() retrains for the device kernels, "
                                 "which decode OnPair16: max_entry_len must "
                                 "be <= 16")
        self._n_total = self.segments.n_strings
        self._encoder = self._make_encoder(
            self._device, None if self._device is not None else self.artifact,
            self.compressor)
        # serialises encoder use between extend() callers (the bucketed
        # encode grows its shape list on demand)
        self._encode_lock = threading.Lock()
        self._io_lock = threading.RLock()   # serialises save/swap/prune
        self._dirty = False                 # unsaved appends or compactions
        self._dir: str | None = None        # set by save()/open(): compact() target
        base = train_ratio if train_ratio is not None else (
            corpus.ratio if corpus.compressed_bytes else None)
        self.drift = DriftMonitor(threshold=drift_threshold,
                                  baseline_ratio=base)
        self.auto_compact = auto_compact
        self.version_id = 0          # bumped by every compact()
        self.compactions = 0
        # off-thread seals: a sealing extend() only requests a seal; a worker
        # builds the segment and commits under the lock iff the tail it
        # snapshotted is still current (the _tail_gen and version_id guards)
        self.async_seal = bool(async_seal)
        self._sealing = False
        self._tail_gen = 0           # bumped when the tail's prefix changes
        self._seal_done_cv = threading.Condition(self._lock)

    @staticmethod
    def _check_token_stream(source) -> None:
        """Refuse a codec that is not token-stream before anything is built:
        the tail files per-string u16 token payloads."""
        if isinstance(source, OnPairDevice):
            name = source.artifact.codec if source.artifact is not None else None
        elif isinstance(source, DictArtifact):
            name = source.codec
        else:
            obj = source[1] if isinstance(source, tuple) else source
            name = getattr(obj, "name", None)          # a trained codec
        if name is None:
            return  # the base constructor gives the right error
        try:
            caps = registry.capabilities(name)
        except Exception:
            return  # unknown codec: the base constructor gives the right error
        if not caps.token_stream:
            raise ValueError(
                f"MutableStringStore requires a token-stream codec: appends "
                f"file per-string u16 token payloads into the tail, but "
                f"{name!r} is not token_stream (registry capability); "
                "use a read-only CompressedStringStore for block codecs")

    @staticmethod
    def _make_encoder(device: OnPairDevice | None, artifact: DictArtifact | None,
                      compressor) -> Encoder:
        """The tail encoder for a dictionary generation: the encode kernel on
        ``device``'s tables, with the kernel library built now so the first
        extend() pays no ``nvcc``; or, with no device, the host codec.
        compact() calls this outside the lock."""
        if device is None:
            return Encoder(artifact, codec=compressor)
        device.warm_encode()
        return Encoder(device)

    # -------------------------------------------------------------- tail hooks
    def _tail_n(self) -> int:
        return len(self._tail)

    def _tail_payload_bytes(self) -> int:
        return self._tail_bytes

    def _tail_token_lists(self, local: np.ndarray) -> list[np.ndarray]:
        return [np.frombuffer(self._tail[i], dtype="<u2") for i in local.tolist()]

    def _tail_scan(self, lo: int, hi: int) -> list[bytes]:
        if lo >= hi:
            return []
        return self._decode_payloads(self._decoder(), self._tail[lo:hi],
                                     self._tail_raw[lo:hi])

    def _decoder(self) -> OnPairDevice | PackedDictionary:
        """What decodes this generation's payloads: the device codec, or the
        host codec's dictionary. Call under the lock."""
        return self._device if self._device is not None else self.dictionary

    @staticmethod
    def _decode_payloads(decoder: OnPairDevice | PackedDictionary,
                         parts: list[bytes], raw_lens: list[int]) -> list[bytes]:
        """Tail payloads decoded in one call of the stream kernel on a
        device codec, or in one ``decode_tokens`` pass of a host dictionary
        (the seal worker passes the one it captured under the lock)."""
        tokens = np.frombuffer(bytearray().join(parts), dtype="<u2")
        if isinstance(decoder, PackedDictionary):
            return _split_by_lengths(decoder.decode_tokens(tokens), raw_lens)
        return decoder.decode_span(decoder.upload_tokens(tokens), raw_lens)

    def _tail_locate(self, payload: bytes) -> int | None:
        if self._tail_map is None:
            # first tail locate: build the map once; ingest keeps it after
            self._map_tail_locked()
        return self._tail_map.get(payload)

    def _map_tail_locked(self) -> None:
        """The tail map anew: each payload's lowest tail-local id."""
        m: dict[bytes, int] = {}
        for local, p in enumerate(self._tail):
            m.setdefault(p, local)
        self._tail_map = m

    def _tail_prefix_hits(self, prefix, after):
        n = len(self._tail)
        if n == 0:
            return []
        sealed = self.segments.n_strings
        hits = []
        for local, s in enumerate(self._tail_scan(0, n)):
            if not s.startswith(prefix):
                continue
            gid = sealed + local
            if after is not None and (s, gid) <= after:
                continue
            hits.append((s, gid))
        hits.sort()
        return hits

    @property
    def n_strings(self) -> int:
        # a plain int read: monotonic for unlocked readers even while a seal
        # moves strings from the tail into a new segment under the lock
        return self._n_total

    # ---------------------------------------------------------- reverse lookup
    def _query_encoder(self) -> Encoder:
        # queries parse against the generation the tail was encoded with
        return self._encoder

    def _encode_queries(self, strings: list[bytes]) -> CompressedCorpus:
        with self._encode_lock:  # as extend() uses the encoder
            return super()._encode_queries(strings)

    # ----------------------------------------------------------------- writes
    def append(self, s: bytes) -> int:
        """Parse one string against the frozen dictionary and append it.
        Returns the new string's global id (ids are assigned contiguously)."""
        return self.extend([s])[0]

    def extend(self, strings: list[bytes]) -> list[int]:
        """Batched append: one encode pass, then one locked tail update."""
        strings = [bytes(s) for s in strings]
        if not strings:
            return []
        raw_lens = [len(s) for s in strings]
        ids = None
        for _ in range(self._MAX_ENCODE_RETRIES):
            with self._encode_lock:
                version = self.version_id
                corpus = self._encoder.encode(strings)
            payloads = _corpus_payloads(corpus)
            with self._lock:
                if version == self.version_id:
                    ids = self._ingest_locked(payloads, raw_lens)
                    break
            # a compact() swapped the dictionary while we were parsing: the
            # payloads reference the old token table, so parse again
        if ids is None:
            # retries exhausted: encode under the store lock itself, where
            # compact()'s swap cannot interleave
            with self._lock:
                corpus = self._encoder.encode(strings)
                ids = self._ingest_locked(_corpus_payloads(corpus), raw_lens)
        if self.auto_compact and self.drift.should_compact():
            self.compact()
        return ids

    def seal(self) -> None:
        """Seal the current tail into a (possibly short) segment. Waits for
        any background seal first; on return the tail is empty."""
        with self._seal_done_cv:
            while self._sealing:
                self._seal_done_cv.wait()
            self._seal_tail_locked()

    def seal_barrier(self) -> None:
        """Block until no background seal is pending: afterwards the tail is
        shorter than ``strings_per_segment`` (until the next sealing
        extend). compact() calls this so its snapshot never races a
        half-built segment."""
        with self._seal_done_cv:
            while self._sealing:
                self._seal_done_cv.wait()

    def _ingest_locked(self, payloads: list[bytes], raw_lens: list[int],
                       assign_ids: bool = True) -> list[int]:
        """Append a batch to the tail with one drift observation.
        ``assign_ids=False`` re-files payloads whose ids are already
        published (compact's delta) without moving ``_n_total``. Crossing a
        seal boundary requests a background seal (or seals inline when
        ``async_seal`` is off)."""
        self._dirty = True
        n = len(payloads)
        ids = list(range(self._n_total, self._n_total + n)) if assign_ids else []
        if self._tail_map is not None:
            start = len(self._tail)
            for j, p in enumerate(payloads):
                self._tail_map.setdefault(p, start + j)
        self._tail.extend(payloads)
        self._tail_raw.extend(raw_lens)
        comp = sum(map(len, payloads))
        self._tail_bytes += comp
        self.drift.observe(sum(raw_lens), comp)
        if assign_ids:
            self._n_total += n
        spc = self.segments.strings_per_segment
        if len(self._tail) >= spc:
            if self.async_seal:
                self._request_seal_locked()
            else:
                while len(self._tail) >= spc:
                    self._seal_tail_locked(spc)
        return ids

    @staticmethod
    def _build_segment(parts: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
        """(payload u8, local offsets i64) of a run of tail payloads."""
        offsets = np.zeros(len(parts) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in parts], out=offsets[1:])
        return np.frombuffer(b"".join(parts), dtype=np.uint8), offsets

    def _seal_tail_locked(self, k: int | None = None) -> None:
        """Seal the first ``k`` tail strings (all when None) inline."""
        k = len(self._tail) if k is None else min(k, len(self._tail))
        if k == 0:
            return
        payload, offsets = self._build_segment(self._tail[:k])
        # once anyone has located, keep the index current: the new segment's
        # index is built at seal time from its strings (decoded before the
        # tail drops them); stores nobody locates in never pay this decode
        raw = (self._tail_scan(0, k)
               if self._seg_indexes or self._tail_map is not None else None)
        self._commit_seal_locked(k, payload, offsets, sum(self._tail_raw[:k]),
                                 raw)

    def _commit_seal_locked(self, k: int, payload: np.ndarray,
                            offsets: np.ndarray, raw_bytes: int,
                            raw: list[bytes] | None) -> None:
        """Append the built segment, to the device mirror too, and drop the
        first ``k`` tail strings; index it when ``raw`` (its strings) is
        given. Bumps ``_tail_gen``: any other in-flight snapshot of the old
        tail prefix is now stale and must not commit."""
        if self.resident is not None:
            self.resident.append(payload, offsets)  # checks the tokens first
        seg = self.segments.append_segment(payload, offsets, raw_bytes=raw_bytes)
        if raw is not None:
            self._seg_indexes[seg.index] = SegmentIndex.build(
                seg.payload, seg.offsets, raw)
        del self._tail[:k]
        del self._tail_raw[:k]
        self._tail_bytes -= int(offsets[-1])
        if self._tail_map is not None:
            self._map_tail_locked()  # the seal shifted every tail-local id
        self._tail_gen += 1

    def _request_seal_locked(self) -> None:
        if self._sealing:
            return  # the worker is draining; it re-checks the boundary
        self._sealing = True
        threading.Thread(target=self._seal_worker, daemon=True,
                         name="repro-torch-seal").start()

    def _seal_worker(self) -> None:
        """Drain the tail below the seal boundary, one segment a round. Each
        round snapshots the first ``spc`` payloads under the lock, builds
        the segment off the lock, and commits only if neither a compaction
        (version_id) nor another seal (_tail_gen) changed the tail since.
        Once anyone has located, the commit also decodes the segment's
        strings for its index, under the lock: every stream launch of the
        seal and demotion workers holds it, so one launch at a time uses the
        stream kernel's scratch and launch counts."""
        while True:
            with self._lock:
                spc = self.segments.strings_per_segment
                if len(self._tail) < spc:
                    self._sealing = False
                    self._seal_done_cv.notify_all()
                    return
                version, gen = self.version_id, self._tail_gen
                parts = self._tail[:spc]
                raw_lens = self._tail_raw[:spc]
                decoder = self._decoder()
            payload, offsets = self._build_segment(parts)
            with self._lock:
                if self.version_id != version or self._tail_gen != gen:
                    continue  # the snapshot went stale: start the round again
                need_raw = bool(self._seg_indexes) or self._tail_map is not None
                raw = (self._decode_payloads(decoder, parts, raw_lens)
                       if need_raw else None)
                self._commit_seal_locked(spc, payload, offsets, sum(raw_lens),
                                         raw)

    # ------------------------------------------------------------- compaction
    def compact(self, *, sample_strings: int | None = None,
                dir_path: str | None = None, prune_old: bool = True) -> dict:
        """Re-train the dictionary on (a sample of) the live data, re-encode
        every live string (through the encode kernel for OnPair16, on the
        host codec otherwise), and swap the store's state under its lock.

        The live strings are read back through ``scan`` (the stream kernel;
        cold segments from RLZ) in per-segment lock windows; training, the table upload and the bulk
        re-encode run outside the lock, so reads and appends keep being
        served from the old state. Strings appended meanwhile are re-parsed
        against the new dictionary during the locked swap. When the store is
        directory-backed (``dir_path``, or the directory of the last
        ``save``/``open``), the new generation is saved as ``v{n+1}/``, the
        ``current.json`` manifest swapped, and the old generation pruned
        (``prune_old=False`` keeps it).
        """
        t0 = time.perf_counter()
        self.seal_barrier()  # never snapshot a half-built background segment
        n0 = self.n_strings
        # ids < n0 are immutable, so chunked reads see the same bytes as one
        # scan while reads and appends interleave between the chunks
        live: list[bytes] = []
        chunk = max(1, self.segments.strings_per_segment)
        for lo in range(0, n0, chunk):
            with self._lock:
                live.extend(self._scan_locked(lo, min(lo + chunk, n0)))
        if not live:
            return {"n_strings": 0, "ratio_before": 0.0, "ratio_after": 0.0,
                    "train_s": 0.0, "total_s": 0.0,
                    "version": self._version_name(), "dir": self._dir}
        raw = sum(len(s) for s in live)
        with self._lock:
            compressed_before = self.segments.payload_bytes + self._tail_bytes
        ratio_before = raw / max(1, compressed_before)

        sample = live
        if sample_strings is not None and sample_strings < len(live):
            step = max(1, len(live) // sample_strings)
            sample = live[::step][:sample_strings]
        t_train0 = time.perf_counter()
        if self._device is not None:
            trained = train_dictionary(sample, self.config)
            train_s = time.perf_counter() - t_train0
            dictionary = PackedDictionary.build(trained.entries)
            new_device = OnPairDevice(dictionary, self._device.device)
            new_encoder = self._make_encoder(new_device, None, None)
        else:
            # the host codec retrains through the registry with its own config
            dictionary = registry.codec_from_artifact(self.artifact)
            dictionary.train(sample)
            train_s = time.perf_counter() - t_train0
            new_device = None
            new_encoder = self._make_encoder(None, dictionary.to_artifact(),
                                             dictionary)
        new_corpus = new_encoder.encode(live)

        with self._lock:
            # strings appended while we were retraining: decode them from the
            # old state, then re-parse against the new dictionary; their ids
            # are already published, so _n_total does not move
            delta = self._scan_locked(n0, self._n_total)
            self._swap_state_locked(dictionary, new_corpus, new_device,
                                    new_encoder)
            if delta:
                d_corpus = new_encoder.encode(delta)
                self._ingest_locked(_corpus_payloads(d_corpus),
                                    [len(s) for s in delta], assign_ids=False)
            compressed_after = self.segments.payload_bytes + self._tail_bytes
        self.compactions += 1

        target = dir_path or self._dir
        old_version = f"v{self.version_id - 1:04d}"
        if target is not None:
            # one holder writes the directory at a time: a concurrent save()
            # must not recreate (or point the manifest at) the generation
            # this prune deletes
            with self._io_lock:
                self.save(target)  # writes v{id}/ then swaps current.json
                if prune_old:
                    shutil.rmtree(os.path.join(target, old_version),
                                  ignore_errors=True)
        raw_total = raw + sum(len(s) for s in delta)
        return {"n_strings": self.n_strings,
                "ratio_before": round(ratio_before, 4),
                "ratio_after": round(raw_total / max(1, compressed_after), 4),
                "train_s": round(train_s, 4),
                "total_s": round(time.perf_counter() - t0, 4),
                "version": f"v{self.version_id:04d}", "dir": target}

    def _swap_state_locked(self, dictionary, corpus: CompressedCorpus,
                           device: OnPairDevice | None = None,
                           encoder: Encoder | None = None) -> None:
        """Replace dictionary, corpus and segments in one locked step. The
        decoded strings are unchanged, but cached entries belong to the old
        generation's token streams, so the cache is dropped. ``dictionary``
        is the new OnPair16 :class:`PackedDictionary` (or device tables) of
        a device store, or the retrained host codec of a host one. Pass the
        ``device`` and ``encoder`` built outside the lock so the swap only
        assigns."""
        self.corpus = corpus
        self.segments = SegmentedCorpus.from_corpus(
            corpus, self.segments.strings_per_segment)
        self._artifact = None  # frozen anew from the new tables on demand
        if self._device is not None:
            self._device = (device if device is not None
                            else OnPairDevice(dictionary, self._device.device))
            self.resident = ResidentSegments(self._device)
            self.resident.append(corpus.payload, corpus.offsets)
        else:
            self.compressor = dictionary
        self._set_bucket_caps(corpus.token_counts())
        self._encoder = (encoder if encoder is not None else self._make_encoder(
            self._device, None if self._device is not None else self.artifact,
            self.compressor))
        self._dirty = True
        self._tail = []
        self._tail_raw = []
        self._tail_bytes = 0
        # reverse-lookup state belongs to a generation: fingerprints index
        # the encoded forms, which the rewrite just changed
        self._seg_indexes = {}
        self._tail_map = None
        self._locate_encoder = None
        # _n_total is not reset: acknowledged ids never un-publish, and the
        # caller re-files any delta beyond the corpus
        self.cache.clear()
        self.drift.reset(corpus.ratio if corpus.compressed_bytes else None)
        if self.tier is not None:
            # the rewrite folded every cold segment back into the new, hot
            # generation, and the mirror above holds every segment
            self.tier.clear_locked()
        self._tail_gen += 1   # in-flight seal snapshots are now stale
        self.version_id += 1

    # --------------------------------------------------------------- snapshot
    def _version_name(self) -> str:
        return f"v{self.version_id:04d}"

    def snapshot_corpus(self) -> CompressedCorpus:
        with self._lock:
            return self._to_corpus_locked()

    def _to_corpus_locked(self) -> CompressedCorpus:
        """One flat corpus over the sealed segments and the unsealed tail."""
        parts = [s.payload for s in self.segments.segments]
        parts += [np.frombuffer(p, dtype=np.uint8) for p in self._tail]
        payload = (np.concatenate(parts) if parts
                   else np.zeros(0, dtype=np.uint8))
        offs = [np.zeros(1, dtype=np.int64)]
        base = 0
        for seg in self.segments.segments:
            if seg.n_strings:
                offs.append(seg.offsets[1:] + base)
            base += seg.payload_bytes
        for p in self._tail:
            base += len(p)
            offs.append(np.asarray([base], dtype=np.int64))
        raw = self.segments.raw_bytes + sum(self._tail_raw)
        return CompressedCorpus(payload=payload, offsets=np.concatenate(offs),
                                raw_bytes=int(raw),
                                meta={"compressor": self.codec_name})

    def save(self, dir_path: str) -> None:
        """Write the current dictionary generation as ``<dir>/v{id}/`` (the
        flat store layout, tail included in the corpus) and atomically point
        the ``current.json`` manifest at it.

        Dictionary, corpus, version name, meta and index blob are snapshotted
        in one locked section, after any background seal, so a compact()
        landing mid-save never pairs one generation's dictionary with
        another's corpus; the whole snapshot and write hold the IO lock, so
        they serialise against compact()'s own save and prune.
        """
        self.seal_barrier()  # the snapshot below must see a settled tail
        with self._io_lock:
            self._save_io_locked(dir_path)

    def _save_io_locked(self, dir_path: str) -> None:
        with self._lock:
            vname = self._version_name()
            artifact = self.artifact
            corpus = self._to_corpus_locked()
            # encode_backend is the reference's key: "numpy" is the value it
            # accepts on every host; the port encodes OnPair16 on its kernel
            meta = self.store_meta(
                mutable=True, n_tail=len(self._tail),
                version_id=self.version_id, encode_backend="numpy",
                async_seal=self.async_seal,
                train_ratio=self.drift.baseline_ratio,
                drift_raw_bytes=self.drift.raw_bytes,
                drift_compressed_bytes=self.drift.compressed_bytes,
                drift_observations=self.drift.observations,
                drift_threshold=self.drift.threshold,
                **self._tier_meta_locked())
            manifest = {"format_version": 1, "current": vname,
                        "codec": artifact.codec, "n_strings": self.n_strings,
                        "compactions": self.compactions}
            # the sidecar must describe exactly the segments it sits next to
            index_blob = self._dump_index_locked()
            # cleared inside the snapshot: an append landing while the files
            # below are written marks the store dirty again
            self._dirty = False
        sub = os.path.join(dir_path, vname)
        os.makedirs(sub, exist_ok=True)
        artifact.save(os.path.join(sub, self._DICT_FILE))
        corpus.save(os.path.join(sub, self._CORPUS_FILE))
        write_json_atomic(os.path.join(sub, self._META_FILE), meta)
        if index_blob is not None:
            with open(os.path.join(sub, self._INDEX_FILE), "wb") as f:
                f.write(index_blob)
        if meta.get("cold_segments"):
            # the cold containers are immutable once written, so copying
            # them after the snapshot's lock dropped cannot tear
            self.tier.copy_cold_files(meta["cold_segments"], sub)
        write_json_atomic(os.path.join(dir_path, self._CURRENT_FILE), manifest)
        # upgrading a plain (flat) store directory to the versioned layout:
        # drop the superseded flat files, so a reader never finds two
        # generations that disagree in one directory
        stale_names = [self._DICT_FILE, self._CORPUS_FILE, self._META_FILE,
                       self._INDEX_FILE]
        stale_names += [n for n in os.listdir(dir_path)
                        if n.startswith("cold-") and n.endswith(".rlz")]
        for name in stale_names:
            stale = os.path.join(dir_path, name)
            if os.path.exists(stale):
                os.remove(stale)
        self._dir = dir_path

    @classmethod
    def open(cls, dir_path: str, mmap: bool = True,
             device: str | torch.device | None = None, source=None,
             **overrides) -> "MutableStringStore":
        """Reopen a writable store, either package's: the versioned layout
        (``current.json``) or a plain read-only store directory. An unsealed
        tail saved with the corpus is split back out so appends keep sealing
        on the same boundaries, and the drift window is restored as saved.
        ``device`` and ``source`` are the read store's (see
        :meth:`CompressedStringStore.open`). ``overrides`` beat every saved
        param; the saved ``encode_backend`` is ignored (the port encodes
        OnPair16 on its kernel, every other codec on the host)."""
        sub = cls._resolve_current(dir_path)
        meta = cls._read_meta(sub)
        if source is None:
            source = DictArtifact.load(os.path.join(sub, cls._DICT_FILE),
                                       mmap=mmap)
        corpus = CompressedCorpus.load(os.path.join(sub, cls._CORPUS_FILE),
                                       mmap=mmap)
        n, n_tail = corpus.n_strings, int(meta.get("n_tail", 0))
        sealed = corpus.slice_strings(0, n - n_tail) if n_tail else corpus
        kw = {k: meta[k] for k in cls._STORE_KW}
        kw["train_ratio"] = meta.get("train_ratio")
        kw["drift_threshold"] = meta.get("drift_threshold", 0.2)
        kw["async_seal"] = meta.get("async_seal", True)
        kw.update(overrides)
        store = cls(source, sealed, device=device, **kw)
        if n_tail:
            # each tail string's decoded length, from the entry lengths
            lens = (store._device.host_lens if store._device is not None
                    else store.dictionary.lens.astype(np.int64))
            payloads = [corpus.string_payload(i) for i in range(n - n_tail, n)]
            raws = [int(lens[np.frombuffer(p, dtype="<u2")].sum())
                    for p in payloads]
            with store._lock:
                store._ingest_locked(payloads, raws)
        # the tail's re-ingest observed only the tail: restore the window
        if "drift_raw_bytes" in meta:
            store.drift.raw_bytes = int(meta["drift_raw_bytes"])
            store.drift.compressed_bytes = int(meta["drift_compressed_bytes"])
            store.drift.observations = int(meta["drift_observations"])
        store.version_id = int(meta.get("version_id", 0))
        store._load_index(sub)
        store._attach_tier(sub, meta)
        store._dir = dir_path
        store._dirty = False  # the tail's restore is not an unsaved append
        return store

    def _tier_home(self) -> str | None:
        # the current generation's directory: attach reads cold files there,
        # and save() writes the generation there
        if self._dir is None:
            return None
        return os.path.join(self._dir, self._version_name())

    def stats_snapshot(self) -> dict:
        snap = super().stats_snapshot()
        snap.update(drift=self.drift.snapshot(), compactions=self.compactions,
                    version=self._version_name())
        return snap
