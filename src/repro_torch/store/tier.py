"""Tiered storage: an mmap'd RLZ cold tier behind the hot segments.

A store's sealed segments split into two temperature tiers behind one
unchanged read API, as in the JAX package, whose files this module reads
and writes.

* **hot** — the segment's OnPair token payload lives in the store's device
  mirror (:mod:`repro_torch.store.resident`) and in host memory; multiget
  decodes it with the per-string decode kernel, scan with the stream
  kernel. A store of a host codec (OnPair, BPE) has no mirror: its hot
  segments decode on the host, and a demotion has nothing to evict.
* **cold** — the segment's strings, read once through the stream kernel,
  are re-encoded with :mod:`repro_torch.core.rlz` against the dictionary's
  entry blob and written as a ``cold-<seg>.rlz`` container; the RLZ factor
  arrays *and* the original OnPair payload/offsets are reopened with
  ``np.memmap`` and the segment's tokens leave the device mirror
  (:meth:`ResidentSegments.evict`), so none of its bytes stay resident,
  on the host or on the card. Point reads and scans decode from the RLZ
  factors on the host (the reference has no device path for them); the
  mapped OnPair payload keeps ``locate``/``scan_prefix`` working unchanged
  and makes a later promotion byte-exact (:meth:`ResidentSegments.restore`
  puts the tokens back in id order).

Temperature is the per-segment read-rate EWMA kept by
:class:`~repro_torch.store.drift.DriftMonitor`: :meth:`TierManager.tick`
demotes segments whose rate fell to ``demote_below`` on a background worker,
and a read burst above ``promote_above`` promotes a cold segment straight
back. ``demote``/``promote`` are also explicit operations (:func:`tier_op`).

State machine per sealed segment::

    hot --(rate <= demote_below at tick, off-thread re-encode)--> cold
    cold --(rate >= promote_above, or explicit promote)---------> hot

Every kernel launch of a demotion (the stream read) and every eviction or
restore of the mirror runs under the store's lock.

Cold files go to ``workdir`` when one is given; else next to the files the
store was opened from (its directory, or the current generation of a
writable one), where ``attach`` finds them on reopen; else, for a store
built in memory, to a fresh temporary directory.

Obs: ``repro_store_tier_bytes{tier=hot|cold}`` gauges and the
``repro_store_cold_get_latency_us`` histogram.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.artifact import read_container, write_container
from repro_torch.core.rlz import RLZCodec, decode_ids, rlz_nbytes
from repro_torch.obs import REGISTRY
from repro_torch.store.drift import DriftMonitor

#: container header ``kind`` of a cold-segment file
COLD_KIND = "rlz_segment"


def cold_file_name(seg_index: int) -> str:
    return f"cold-{seg_index:04d}.rlz"


@dataclass
class ColdSegment:
    """Bookkeeping for one demoted segment (all arrays are memmap views)."""

    index: int
    base_id: int
    n_strings: int
    path: str
    arrays: dict = field(repr=False)          # RLZ factor arrays (mmap)
    rlz_bytes: int = 0                        # encoded factor-array size
    payload_bytes: int = 0                    # original OnPair payload size


class TierManager:
    """Hot/cold tier control for one store's sealed segments.

    Created via :meth:`CompressedStringStore.enable_tiering`; every change
    to ``self.cold``, to segment payloads and to the device mirror happens
    under the store's lock, so the read path consults it without more
    locking.
    """

    def __init__(self, store, *, demote_below: float = 0.05,
                 promote_above: float = 1.0, halflife_s: float = 30.0,
                 min_match: int = 8, workdir: str | None = None):
        self.store = store
        self.demote_below = float(demote_below)
        self.promote_above = float(promote_above)
        self.halflife_s = float(halflife_s)
        self.min_match = int(min_match)
        #: segment index -> ColdSegment for every currently-cold segment
        self.cold: dict[int, ColdSegment] = {}
        self.demotions = 0
        self.promotions = 0
        self._workdir = workdir
        #: whether the caller chose the workdir; else a compaction, which
        #: starts a new generation directory, lets it follow the store
        self._workdir_given = workdir is not None
        # temperature signal: the writable store's DriftMonitor when it has
        # one, a private monitor for read-only stores
        drift = getattr(store, "drift", None)
        self._drift: DriftMonitor = drift if drift is not None \
            else DriftMonitor()
        self._drift.read_halflife_s = self.halflife_s
        # per-generation RLZ codec and reference CRC
        self._codec: RLZCodec | None = None
        self._codec_version = -1
        self._crc: tuple[int, int] | None = None
        # off-thread demotion worker (started lazily, one at a time)
        self._jobs: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._gauge_hot = REGISTRY.gauge("repro_store_tier_bytes", tier="hot")
        self._gauge_cold = REGISTRY.gauge("repro_store_tier_bytes",
                                          tier="cold")
        self._cold_lat = REGISTRY.histogram("repro_store_cold_get_latency_us")
        self._update_gauges_locked()

    # ------------------------------------------------------------ temperature
    def note_reads_locked(self, ids: np.ndarray) -> None:
        """Update per-segment read rates from one multiget's ids, duplicates
        included (called under the store lock), and promote any cold segment
        whose rate just crossed ``promote_above``: the read-burst path."""
        segs = self.store.segments
        ids = np.asarray(ids, dtype=np.int64)
        sealed = ids[ids < segs.n_strings]
        if not sealed.size:
            return
        # a segment's index is its position in the list
        ks = np.searchsorted(np.asarray(segs._base_ids, dtype=np.int64),
                             sealed, side="right") - 1
        uk, uc = np.unique(ks, return_counts=True)
        now = time.perf_counter()
        counts = {int(k): int(c) for k, c in zip(uk, uc)}
        self._drift.note_reads(counts, now=now)
        for si in counts:
            if si in self.cold and \
                    self._drift.read_rate(si, now=now) >= self.promote_above:
                self._promote_locked(si)

    def tick(self, now: float | None = None) -> list[int]:
        """Schedule off-thread demotion of every hot sealed segment whose
        read rate is at or below ``demote_below``. Returns the scheduled
        segment indexes (call :meth:`join` to wait for them)."""
        now = time.perf_counter() if now is None else now
        cands = []
        with self.store._lock:
            for seg in self.store.segments.segments:
                if seg.n_strings == 0 or seg.index in self.cold:
                    continue
                if self._drift.read_rate(seg.index, now=now) \
                        <= self.demote_below:
                    cands.append(seg.index)
        for si in cands:
            self.schedule_demote(si)
        return cands

    def schedule_demote(self, seg_index: int) -> None:
        """Queue one segment for off-thread demotion."""
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, daemon=True, name="repro-torch-tier")
            self._worker.start()
        self._jobs.put(int(seg_index))

    def join(self) -> None:
        """Block until every queued demotion has been processed."""
        self._jobs.join()

    def _worker_loop(self) -> None:
        while True:
            si = self._jobs.get()
            try:
                self.demote(si)
            except Exception:  # best effort, as the reference's worker
                pass
            finally:
                self._jobs.task_done()

    # --------------------------------------------------------- demote/promote
    def demote(self, seg_index: int) -> dict | None:
        """Re-encode one sealed segment as RLZ, swap its arrays to mmap views
        and take its tokens off the device mirror. The segment's strings are
        read through the stream kernel under the store lock; factorization
        and the container write run outside it; the adoption re-checks that
        no compaction swapped the generation meanwhile. Returns a report
        dict (with the seconds of each step), or None when the segment is
        absent, empty, or already cold."""
        store = self.store
        t0 = time.perf_counter()
        with store._lock:
            segs = store.segments.segments
            if not 0 <= seg_index < len(segs):
                return None
            seg = segs[seg_index]
            if seg.index in self.cold or seg.n_strings == 0:
                return None
            version = getattr(store, "version_id", 0)
            raw = store._scan_locked(seg.base_id, seg.base_id + seg.n_strings)
            payload = np.asarray(seg.payload, dtype=np.uint8)
            offsets = np.asarray(seg.offsets, dtype=np.int64)
            codec = self._codec_for_locked(version)
            ref_crc = self._ref_crc_locked(version)
        t1 = time.perf_counter()
        arrays = codec.factorize(raw)
        encoded = rlz_nbytes(arrays)
        t2 = time.perf_counter()
        arrays["payload"] = payload
        arrays["offsets"] = offsets
        header = {"kind": COLD_KIND, "segment": int(seg.index),
                  "base_id": int(seg.base_id),
                  "n_strings": int(seg.n_strings),
                  "raw_bytes": int(sum(len(s) for s in raw)),
                  "min_match": codec.min_match, "ref_crc": ref_crc,
                  "payload_bytes": int(payload.size)}
        path = os.path.join(self._ensure_workdir(),
                            cold_file_name(seg.index))
        write_container(path, header, arrays)
        t3 = time.perf_counter()
        with store._lock:
            current = store.segments.segments
            if getattr(store, "version_id", 0) != version \
                    or seg_index >= len(current) \
                    or current[seg_index] is not seg \
                    or seg.index in self.cold:
                return None  # generation swapped mid-encode: abandon
            self._adopt_locked(seg, path)
            self.demotions += 1
        return {"segment": seg.index,
                "payload_bytes": header["payload_bytes"],
                "rlz_bytes": encoded,
                "raw_bytes": header["raw_bytes"],
                "read_s": t1 - t0, "factorize_s": t2 - t1,
                "write_s": t3 - t2, "adopt_s": time.perf_counter() - t3}

    def _adopt_locked(self, seg, path: str,
                      opened: tuple[dict, dict] | None = None) -> None:
        """Take ``seg``'s tokens off the device mirror, point it at the cold
        container's mmap arrays and register the ColdSegment. ``opened``
        passes an already-read container. A failed eviction raises before
        anything else changes."""
        header, arrays = opened if opened is not None \
            else read_container(path, mmap=True)
        rlz = {k: arrays[k] for k in ("starts", "offs", "lens", "literals")}
        if self.store.resident is not None:
            self.store.resident.evict(seg.base_id, seg.base_id + seg.n_strings)
        seg.payload = arrays["payload"]
        seg.offsets = arrays["offsets"]
        self.cold[seg.index] = ColdSegment(
            index=seg.index, base_id=seg.base_id, n_strings=seg.n_strings,
            path=path, arrays=rlz,
            rlz_bytes=int(sum(np.asarray(a).nbytes for a in rlz.values())),
            payload_bytes=int(header.get("payload_bytes", seg.payload.size)))
        self._update_gauges_locked()

    def promote(self, seg_index: int) -> bool:
        """Put a cold segment's tokens back in the device mirror and copy its
        OnPair arrays back onto the heap (byte-exact: the mapped payload IS
        the original encoding). The container file stays on disk; only
        segments listed cold at save time are re-attached on open."""
        with self.store._lock:
            return self._promote_locked(seg_index)

    def _promote_locked(self, seg_index: int) -> bool:
        cold = self.cold.get(seg_index)
        if cold is None:
            return False
        seg = self.store.segments.segments[seg_index]
        # a failed restore raises with the segment still cold
        if self.store.resident is not None:
            self.store.resident.restore(seg.base_id, seg.base_id + seg.n_strings,
                                        seg.payload, seg.offsets)
        del self.cold[seg_index]
        seg.payload = np.array(seg.payload, dtype=np.uint8, copy=True)
        seg.offsets = np.array(seg.offsets, dtype=np.int64, copy=True)
        self.promotions += 1
        self._update_gauges_locked()
        return True

    # -------------------------------------------------------------- cold read
    def split_misses_locked(self, misses: np.ndarray
                            ) -> tuple[np.ndarray, dict[int, np.ndarray]]:
        """(a mask of the misses that lie in cold segments, ``{segment:
        positions of its misses in misses}``) for multiget's unique misses."""
        segs = self.store.segments
        misses = np.asarray(misses, dtype=np.int64)
        sealed = misses < segs.n_strings
        # a segment's index is its position in the list
        seg_of = np.full(misses.size, -1, dtype=np.int64)
        seg_of[sealed] = np.searchsorted(
            np.asarray(segs._base_ids, dtype=np.int64), misses[sealed],
            side="right") - 1
        is_cold = np.isin(seg_of, np.fromiter(self.cold, np.int64,
                                              len(self.cold)))
        groups = {int(si): np.flatnonzero(is_cold & (seg_of == si))
                  for si in np.unique(seg_of[is_cold]).tolist()}
        return is_cold, groups

    def decode_misses_locked(self, misses: np.ndarray,
                             groups: dict[int, np.ndarray],
                             out: np.ndarray) -> int:
        """Decode cold misses from their RLZ factor arrays on the host into
        ``out`` at their positions; records the cold-get latency and the
        store's ``cold_lookups``."""
        t0 = time.perf_counter()
        ref = self._reference()
        n = 0
        for si, pos in groups.items():
            cs = self.cold[si]
            out[pos] = decode_ids(ref, cs.arrays, misses[pos] - cs.base_id)
            n += pos.size
        self._cold_lat.record_seconds(time.perf_counter() - t0)
        stats = getattr(self.store, "stats", None)
        if stats is not None:
            stats.cold_lookups += n
        return n

    def decode_range_locked(self, seg_index: int,
                            lo: int, hi: int) -> list[bytes]:
        """Scan path: decode a cold segment's local range from RLZ."""
        cs = self.cold[seg_index]
        return decode_ids(self._reference(), cs.arrays,
                          np.arange(lo, hi, dtype=np.int64))

    def _reference(self) -> np.ndarray:
        """The RLZ reference: the dictionary's entries back to back, byte for
        byte the JAX package's ``dictionary.blob``."""
        if self.store._device is None:
            return np.asarray(self.store.dictionary.blob, dtype=np.uint8)
        return self.store._device.blob

    # ------------------------------------------------------------ persistence
    def params(self) -> dict:
        return {"demote_below": self.demote_below,
                "promote_above": self.promote_above,
                "halflife_s": self.halflife_s,
                "min_match": self.min_match}

    def cold_items_locked(self) -> list[dict]:
        """Snapshot of the cold set for a save (call under the store lock):
        the container files are immutable once written, so copying them
        after the lock drops is safe."""
        return [{"segment": cs.index, "file": cold_file_name(cs.index),
                 "base_id": cs.base_id, "n_strings": cs.n_strings,
                 "path": cs.path}
                for cs in self.cold.values()]

    def copy_cold_files(self, items: list[dict], dir_path: str) -> None:
        """Materialise a save snapshot's cold containers in ``dir_path``."""
        for it in items:
            dst = os.path.join(dir_path, it["file"])
            if os.path.abspath(it["path"]) != os.path.abspath(dst):
                shutil.copyfile(it["path"], dst)

    def attach(self, dir_path: str, cold_meta: list[dict]) -> int:
        """Re-adopt persisted cold segments on open (their tokens leave the
        mirror the open built). Every entry is validated against the live
        segmentation (position, base id, count) and the dictionary
        generation (reference CRC); mismatches are left hot, as the index
        sidecar's are. Future demotions write next to the attached files."""
        store = self.store
        self._workdir = dir_path
        adopted = 0
        with store._lock:
            version = getattr(store, "version_id", 0)
            ref_crc = self._ref_crc_locked(version)
            segs = store.segments.segments
            for item in cold_meta:
                si = int(item["segment"])
                path = os.path.join(dir_path, item["file"])
                if si >= len(segs) or si in self.cold \
                        or not os.path.exists(path):
                    continue
                seg = segs[si]
                if seg.n_strings == 0 \
                        or seg.base_id != int(item.get("base_id", -1)) \
                        or seg.n_strings != int(item.get("n_strings", -1)):
                    continue
                try:
                    header, arrays = read_container(path, mmap=True)
                except Exception:  # any unreadable container stays hot
                    continue
                if header.get("kind") != COLD_KIND \
                        or header.get("ref_crc") != ref_crc \
                        or header.get("n_strings") != seg.n_strings:
                    continue
                self._adopt_locked(seg, path, opened=(header, arrays))
                adopted += 1
        return adopted

    def clear_locked(self) -> None:
        """Drop all tier state (compaction swapped the segments and the
        mirror out from under it; the rewrite folded cold data back into hot
        segments)."""
        self.cold.clear()
        if not self._workdir_given:
            self._workdir = None  # the next demotion writes to the new generation
        self._codec = None
        self._codec_version = -1
        self._crc = None
        self._drift._read_ewma.clear()
        self._update_gauges_locked()

    # -------------------------------------------------------------- reporting
    def hot_bytes_locked(self) -> int:
        return sum(s.payload_bytes + s.offsets.nbytes
                   for s in self.store.segments.segments
                   if s.index not in self.cold)

    def cold_bytes_locked(self) -> int:
        return sum(s.payload_bytes + s.offsets.nbytes
                   for s in self.store.segments.segments
                   if s.index in self.cold)

    def snapshot(self) -> dict:
        now = time.perf_counter()
        return {"cold_segments": sorted(self.cold),
                "n_cold": len(self.cold),
                "n_segments": self.store.segments.n_segments,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "cold_payload_bytes": sum(cs.payload_bytes
                                          for cs in self.cold.values()),
                "rlz_bytes": sum(cs.rlz_bytes for cs in self.cold.values()),
                "read_rates": {int(k): round(v, 4) for k, v in
                               self._drift.read_rates(now=now).items()},
                "params": self.params(),
                "cold_latency": self._cold_lat.summary()}

    # --------------------------------------------------------------- internal
    def _ensure_workdir(self) -> str:
        if self._workdir is None:
            self._workdir = (self.store._tier_home()
                             or tempfile.mkdtemp(prefix="repro-tier-"))
        os.makedirs(self._workdir, exist_ok=True)
        return self._workdir

    def _codec_for_locked(self, version: int) -> RLZCodec:
        if self._codec is None or self._codec_version != version:
            self._codec = RLZCodec(self._reference(), min_match=self.min_match)
            self._codec_version = version
        return self._codec

    def _ref_crc_locked(self, version: int) -> int:
        if self._crc is None or self._crc[0] != version:
            blob = np.ascontiguousarray(self._reference())
            self._crc = (version, int(zlib.crc32(blob.tobytes())))
        return self._crc[1]

    def _update_gauges_locked(self) -> None:
        self._gauge_hot.set(float(self.hot_bytes_locked()))
        self._gauge_cold.set(float(self.cold_bytes_locked()))


def tier_op(store, action: str = "stats", segment: int | None = None,
            params: dict | None = None) -> dict:
    """One tier control operation against a single store, the reference's
    ``OP_TIER`` semantics.

    ``stats`` never enables tiering (``{"enabled": False}`` when off);
    ``demote``/``promote`` enable it on first use, act on one segment, or —
    with ``segment=None`` — on every eligible segment (demote: every hot
    sealed segment; promote: every cold one).
    """
    if action == "stats":
        tier = getattr(store, "tier", None)
        if tier is None:
            return {"enabled": False}
        return {"enabled": True, **tier.snapshot()}
    if action not in ("demote", "promote"):
        raise ValueError(f"unknown tier action {action!r} "
                         "(one of 'stats', 'demote', 'promote')")
    tier = store.enable_tiering(**(params or {}))
    if action == "demote":
        if segment is None:
            idxs = [s.index for s in store.segments.segments if s.n_strings]
        else:
            idxs = [int(segment)]
        done = [r["segment"] for r in map(tier.demote, idxs)
                if r is not None]
        return {"enabled": True, "demoted": done, "n_cold": len(tier.cold)}
    idxs = sorted(tier.cold) if segment is None else [int(segment)]
    done = [si for si in idxs if tier.promote(si)]
    return {"enabled": True, "promoted": done, "n_cold": len(tier.cold)}
