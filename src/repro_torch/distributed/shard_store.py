"""Segment-sharded store persistence: one compressed corpus served as N
shards that share one dictionary.

The train-once :class:`~repro_torch.core.artifact.DictArtifact` is written
**once** and shared by every shard (the paper's dictionary is global state;
only payloads shard), while the corpus is split on *segment* boundaries,
the store's unit of scan decoding and routing, into N contiguous shards,
each an independently openable
:class:`~repro_torch.store.store.CompressedStringStore` directory. The
layout is the reference's, file for file, so a sharded directory written by
either package opens in the other.

On the card the shared dictionary is one upload: :func:`open_shard` and
:meth:`ShardedStringStore.open` build one
:class:`~repro_torch.kernels.ops.OnPairDevice` on the requested device and
open every shard against it, so N shards hold one copy of the tables, not N.
A shard saved after appends keeps the shared dictionary, byte for byte, and
reopens on the shared codec too; only a shard that retrained (``compact``)
builds a device codec of its own. A sharded store of a host codec (OnPair,
BPE) shares one host codec across its shards the same way.

:class:`ShardRouter` holds the routing arithmetic (global id -> (shard,
local id) via contiguous bounds, order-preserving per-shard ``multiget``
partitioning, tail-owned append bounds), and :class:`ShardedStringStore`
serves every shard in this process.
"""

from __future__ import annotations

import heapq
import json
import os
import threading
from itertools import islice

import torch

from repro_torch.core import registry
from repro_torch.core.artifact import DictArtifact
from repro_torch.core.codec import host_codec_for
from repro_torch.kernels.ops import OnPairDevice
from repro_torch.store.mutable import MutableStringStore
from repro_torch.store.store import CompressedStringStore, write_json_atomic
from repro_torch.store.tier import tier_op

MANIFEST = "shards.json"
DICT_FILE = "dictionary.rpa"

#: the read-routing policies every router (and the client layer) understands
READ_PREFERENCES = ("primary", "replica", "any")


def check_read_preference(pref: str) -> str:
    if pref not in READ_PREFERENCES:
        raise ValueError(f"read_preference must be one of {READ_PREFERENCES},"
                         f" got {pref!r}")
    return pref


def plan_shards(n_strings: int, strings_per_segment: int,
                n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) string-id ranges, split on segment boundaries.

    Segments are never split across shards (they are the routing/decode
    unit); shard sizes differ by at most one segment.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    n_segments = max(1, -(-n_strings // strings_per_segment))
    n_shards = min(n_shards, n_segments)
    bounds: list[tuple[int, int]] = []
    per, extra = divmod(n_segments, n_shards)
    seg = 0
    for k in range(n_shards):
        take = per + (1 if k < extra else 0)
        lo = min(seg * strings_per_segment, n_strings)
        seg += take
        hi = min(seg * strings_per_segment, n_strings)
        bounds.append((lo, hi))
    return bounds


def save_sharded(store: CompressedStringStore, dir_path: str,
                 n_shards: int) -> list[tuple[int, int]]:
    """Write ``store`` as one shared dictionary + N shard corpora.

    Layout::

        <dir>/dictionary.rpa     shared train-once artifact
        <dir>/shards.json        manifest: codec, id ranges, store params
        <dir>/shard-0000/        corpus.rpc + store.json (openable alone)
        ...
    """
    caps = registry.capabilities(store.artifact.codec)
    if not caps.token_stream:
        raise ValueError("sharding slices corpora on string boundaries; "
                         f"codec {store.artifact.codec!r} is not token_stream")
    os.makedirs(dir_path, exist_ok=True)
    store.artifact.save(os.path.join(dir_path, DICT_FILE))
    sps = store.segments.strings_per_segment
    # snapshot the live corpus: a writable store's construction-time corpus
    # does not cover appended strings (sealed-tail segments or open tail)
    corpus = store.snapshot_corpus()
    n = corpus.n_strings
    bounds = plan_shards(n, sps, n_shards)
    for k, (lo, hi) in enumerate(bounds):
        sub = corpus.slice_strings(lo, hi)
        shard_dir = os.path.join(dir_path, f"shard-{k:04d}")
        os.makedirs(shard_dir, exist_ok=True)
        sub.save(os.path.join(shard_dir, CompressedStringStore._CORPUS_FILE))
        write_json_atomic(
            os.path.join(shard_dir, CompressedStringStore._META_FILE),
            store.store_meta(base_id=lo, n_strings=hi - lo))
    write_json_atomic(
        os.path.join(dir_path, MANIFEST),
        {"format_version": 1, "codec": store.artifact.codec,
         "n_shards": len(bounds), "n_strings": n,
         "bounds": [list(b) for b in bounds],
         "strings_per_segment": sps})
    return bounds


def record_replicas(dir_path: str,
                    replicas: dict[int, list[tuple[str, int]]]) -> dict:
    """Publish replica server addresses into the cluster manifest.

    Whatever starts read-only replica servers records them here, so a
    client that opens the directory finds them without wiring of its own.
    The manifest key is the reference's, so either package reads it.
    Addresses replace any prior entry for the same shard; an empty list
    clears it. Returns the full replica map.
    """
    path = os.path.join(dir_path, MANIFEST)
    with open(path) as f:
        manifest = json.load(f)
    current = manifest.get("replicas", {})
    for shard, addrs in replicas.items():
        key = str(int(shard))
        addrs = [[str(h), int(p)] for h, p in addrs]
        if addrs:
            current[key] = addrs
        else:
            current.pop(key, None)
    manifest["replicas"] = current
    write_json_atomic(path, manifest)
    return {int(k): [(h, p) for h, p in v] for k, v in current.items()}


def manifest_replicas(dir_path: str) -> dict[int, list[tuple[str, int]]]:
    """The manifest's replica map: ``{shard: [(host, port), ...]}`` (empty
    when the manifest has none or the directory is not a sharded layout)."""
    path = os.path.join(dir_path, MANIFEST)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        manifest = json.load(f)
    return {int(k): [(str(h), int(p)) for h, p in v]
            for k, v in manifest.get("replicas", {}).items()}


def _shared_codec(dir_path: str, mmap: bool, device):
    """The sharded directory's dictionary, loaded once, as the ``source``
    every shard opens against: for OnPair16 an :class:`OnPairDevice` with
    its tables uploaded once to ``device`` (default ``"cuda"``), for a host
    codec the ``(artifact, host codec)`` pair, built once."""
    artifact = DictArtifact.load(os.path.join(dir_path, DICT_FILE), mmap=mmap)
    host = host_codec_for(artifact, device)
    if host is not None:
        return artifact, host
    return OnPairDevice.from_artifact(artifact,
                                      "cuda" if device is None else device)


def _same_file_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def open_shard(dir_path: str, shard: int, mmap: bool = True,
               source=None, writable: bool = False,
               device: str | torch.device | None = None,
               **overrides) -> CompressedStringStore:
    """What one serving host does: shared dictionary + its shard's corpus.
    Pass ``source`` (what ``_shared_codec`` opens from the directory's
    artifact: an :class:`OnPairDevice`, or an ``(artifact, host codec)``
    pair) when opening several shards so the dictionary loads, and its
    tables go up to the card, once. ``device`` defaults to ``"cuda"`` for
    OnPair16 and must be left out for a host codec. ``writable=True`` opens
    the shard as a :class:`MutableStringStore` so it accepts appends
    against the shared frozen dictionary. Once a writable shard has been
    saved or compacted it owns a *versioned* layout, which takes precedence
    on reopen: a generation whose ``dictionary.rpa`` holds the directory's
    shared artifact byte for byte (a save of appends) opens on the shared
    codec; a compacted one on a codec of its own."""
    shard_dir = os.path.join(dir_path, f"shard-{shard:04d}")
    current = CompressedStringStore._resolve_current(shard_dir)
    if current != shard_dir:
        if not _same_file_bytes(os.path.join(current, DICT_FILE),
                                os.path.join(dir_path, DICT_FILE)):
            source = None  # a compacted generation: its own dictionary
        elif source is None:
            source = _shared_codec(dir_path, mmap, device)
        store_cls = MutableStringStore if writable else CompressedStringStore
        # read-only opens take the shard's current generation
        return store_cls.open(shard_dir, mmap=mmap, device=device,
                              source=source, **overrides)
    if source is None:
        source = _shared_codec(dir_path, mmap, device)
    store_cls = MutableStringStore if writable else CompressedStringStore
    store = store_cls.open_corpus_dir(shard_dir, source, mmap=mmap,
                                      device=device, **overrides)
    if writable:
        store._dir = shard_dir  # compact() rewrites land in the shard dir
    return store


class ShardRouter:
    """Routing/bounds arithmetic over contiguous per-shard id ranges.

    Deployment-agnostic: subclasses provide the per-shard data plane
    (``_shard_multiget`` / ``_shard_scan`` / ``_shard_stats`` /
    ``_tail_extend``) while this base owns the global contract every
    deployment shape must honour — order-preserving multiget
    reassembly, segment-respecting scans, and append bounds that only ever
    grow the LAST shard (the owner of the global id space's tail).

    Every read takes a ``read_preference`` (``"primary"`` | ``"replica"`` |
    ``"any"``; None = the router's default) that flows through to the
    per-shard data plane. The base router has no replicas, so every
    preference resolves to the primary; a router over replicated shards
    overrides the resolution. Accepting the option here keeps the client
    surface identical across deployment shapes.
    """

    def __init__(self, bounds: list[tuple[int, int]],
                 dir_path: str | None = None,
                 read_preference: str = "primary"):
        self.bounds = [tuple(b) for b in bounds]
        self.n_strings = self.bounds[-1][1] if self.bounds else 0
        self.read_preference = check_read_preference(read_preference)
        self._dir = dir_path
        self._write_lock = threading.Lock()  # serialises bound updates

    @property
    def n_shards(self) -> int:
        return len(self.bounds)

    def __len__(self) -> int:
        return self.n_strings

    # ------------------------------------------------------------- data plane
    def _shard_multiget(self, k: int, local_ids: list[int],
                        read_preference: str | None = None) -> list[bytes]:
        raise NotImplementedError

    def _shard_scan(self, k: int, lo: int, hi: int,
                    read_preference: str | None = None) -> list[bytes]:
        raise NotImplementedError

    def _shard_stats(self, k: int) -> dict:
        raise NotImplementedError

    def _shard_locate(self, k: int, strings: list[bytes],
                      read_preference: str | None = None
                      ) -> list[int | None]:
        """Shard-local ids of ``strings`` (None per miss)."""
        raise NotImplementedError

    def _shard_scan_prefix(self, k: int, prefix: bytes, limit: int | None,
                           after: tuple[bytes, int] | None,
                           read_preference: str | None = None
                           ) -> list[tuple[int, bytes]]:
        """Shard-local ``[(local_id, string), ...]`` prefix matches in
        (string, local_id) order; ``after`` is a shard-local cursor."""
        raise NotImplementedError

    def _shard_tier(self, k: int, action: str = "stats",
                    segment: int | None = None,
                    params: dict | None = None) -> dict:
        """One tier-control op against shard ``k`` (see
        :func:`repro_torch.store.tier.tier_op` for the action contract)."""
        raise NotImplementedError

    def _tail_extend(self, strings: list[bytes]) -> tuple[list[int], int]:
        """Append to the tail shard; returns (local ids, new local count)."""
        raise NotImplementedError

    def _fanout_multiget(self, jobs: list[tuple[int, list[int]]],
                         read_preference: str | None = None
                         ) -> list[list[bytes]]:
        """Answer one multiget job per shard, one after another (a router
        whose shards answer over the network fans out concurrently)."""
        return [self._shard_multiget(k, local_ids, read_preference)
                for k, local_ids in jobs]

    # ---------------------------------------------------------------- routing
    def route(self, gid: int) -> tuple[int, int]:
        if not 0 <= gid < self.n_strings:
            raise IndexError(f"string id {gid} out of range "
                             f"[0, {self.n_strings})")
        for k, (lo, hi) in enumerate(self.bounds):
            if lo <= gid < hi:
                return k, gid - lo
        raise IndexError(f"string id {gid} not covered by any shard")

    def get(self, gid: int, *, read_preference: str | None = None) -> bytes:
        k, local = self.route(gid)
        return self._shard_multiget(k, [local], read_preference)[0]

    def multiget(self, ids, *,
                 read_preference: str | None = None) -> list[bytes]:
        """Order-preserving batched lookup: ids partition per shard, each
        shard answers with ONE batched decode, answers reassemble into
        request order."""
        routed = [self.route(int(i)) for i in ids]
        per_shard: dict[int, list[int]] = {}
        for pos, (k, _) in enumerate(routed):
            per_shard.setdefault(k, []).append(pos)
        jobs = [(k, [routed[p][1] for p in positions])
                for k, positions in per_shard.items()]
        out: list[bytes | None] = [None] * len(routed)
        for (_, positions), got in zip(per_shard.items(),
                                       self._fanout_multiget(
                                           jobs, read_preference)):
            for p, v in zip(positions, got):
                out[p] = v
        return out  # type: ignore[return-value]

    def scan(self, lo: int, hi: int, *,
             read_preference: str | None = None) -> list[bytes]:
        """Decode the contiguous global id range [lo, hi): each shard scans
        its covered sub-range, results concatenate in id order."""
        if not (0 <= lo <= hi <= self.n_strings):
            raise IndexError(
                f"scan range [{lo}, {hi}) not within [0, {self.n_strings}]")
        out: list[bytes] = []
        for k, (s_lo, s_hi) in enumerate(self.bounds):
            a, b = max(lo, s_lo), min(hi, s_hi)
            if a < b:
                out.extend(self._shard_scan(k, a - s_lo, b - s_lo,
                                            read_preference))
        return out

    def locate(self, s: bytes, *,
               read_preference: str | None = None) -> int | None:
        """Exact-match reverse lookup across every shard (lowest id wins)."""
        return self.locate_batch([s], read_preference=read_preference)[0]

    def locate_batch(self, strings, *,
                     read_preference: str | None = None) -> list[int | None]:
        """Batched reverse lookup. Shards are probed in id order and each
        query drops out at its first hit — shard order IS gid order
        (bounds are contiguous), so the first hit is the lowest global id
        and fully-resolved batches skip the remaining shards."""
        strings = [bytes(s) for s in strings]
        out: list[int | None] = [None] * len(strings)
        pending = list(range(len(strings)))
        for k, (lo, hi) in enumerate(self.bounds):
            if not pending:
                break
            if hi <= lo:
                continue
            got = self._shard_locate(k, [strings[p] for p in pending],
                                     read_preference)
            still: list[int] = []
            for p, loc in zip(pending, got):
                if loc is None:
                    still.append(p)
                else:
                    out[p] = lo + loc
            pending = still
        return out

    def scan_prefix(self, prefix: bytes, limit: int | None = 100,
                    after: tuple[bytes, int] | None = None, *,
                    read_preference: str | None = None
                    ) -> list[tuple[int, bytes]]:
        """Prefix enumeration across every shard, order-merged into global
        ``(string, id)`` order. Each shard returns at most ``limit`` hits
        (any more could never survive the merge); the shard-local cursor
        subtracts the shard's base, which preserves the (string, id)
        ordering the per-segment binary search needs."""
        prefix = bytes(prefix)
        runs: list[list[tuple[bytes, int]]] = []
        for k, (lo, hi) in enumerate(self.bounds):
            if hi <= lo:
                continue
            sh_after = ((after[0], after[1] - lo)
                        if after is not None else None)
            hits = self._shard_scan_prefix(k, prefix, limit, sh_after,
                                           read_preference)
            if hits:
                runs.append([(s, lo + local) for local, s in hits])
        merged = heapq.merge(*runs)
        if limit is not None:
            merged = islice(merged, limit)
        return [(gid, s) for s, gid in merged]

    def stats_snapshot(self) -> dict:
        """Aggregate per-shard stats under global routing metadata."""
        shards = [self._shard_stats(k) for k in range(self.n_shards)]
        return {"n_shards": self.n_shards, "n_strings": self.n_strings,
                "bounds": [list(b) for b in self.bounds],
                "shards": shards}

    # ---------------------------------------------------------------- tiering
    def tier(self, action: str = "stats", segment: int | None = None,
             shard: int | None = None,
             params: dict | None = None) -> list[dict]:
        """Tier control across the cluster: one per-shard report list.
        ``shard=None`` fans the op out to every shard; ``segment`` (when
        given) is shard-local and requires an explicit ``shard``."""
        if segment is not None and shard is None:
            raise ValueError("segment is shard-local: pass shard= with it")
        targets = range(self.n_shards) if shard is None else [shard]
        return [self._shard_tier(k, action, segment=segment, params=params)
                for k in targets]

    def demote(self, shard: int | None = None, segment: int | None = None,
               **params) -> list[dict]:
        """Demote segments to the RLZ cold tier (all eligible segments of
        the targeted shards when ``segment`` is None)."""
        return self.tier("demote", segment=segment, shard=shard,
                         params=params or None)

    def promote(self, shard: int | None = None,
                segment: int | None = None) -> list[dict]:
        """Promote cold segments back to hot OnPair arrays."""
        return self.tier("promote", segment=segment, shard=shard)

    def tier_stats(self) -> list[dict]:
        """Per-shard tier snapshots (``{"enabled": False}`` where off)."""
        return self.tier("stats")

    # ----------------------------------------------------------------- writes
    def append(self, s: bytes) -> int:
        return self.extend([s])[0]

    def extend(self, strings: list[bytes]) -> list[int]:
        """Route appends to the owning shard. New ids extend the global id
        space, which is owned by the LAST shard (bounds are contiguous), so
        that is where appended strings land."""
        # read-modify-write of bounds/n_strings must serialise: two racing
        # extends could otherwise publish a count below acknowledged ids
        with self._write_lock:
            lo, _ = self.bounds[-1]
            local_ids, local_n = self._tail_extend(strings)
            self.bounds[-1] = (lo, lo + local_n)
            self.n_strings = self.bounds[-1][1]
        return [lo + i for i in local_ids]


class ShardedStringStore(ShardRouter):
    """Global-id router over per-shard stores (single-process form).

    The routing arithmetic of :class:`ShardRouter` with every shard store
    open in this process, on one codec that the shards share (the device
    codec of OnPair16, or one host codec).
    """

    def __init__(self, stores: list[CompressedStringStore],
                 bounds: list[tuple[int, int]],
                 dir_path: str | None = None):
        if len(stores) != len(bounds):
            raise ValueError("one store per shard bound required")
        super().__init__(bounds, dir_path=dir_path)
        self.stores = stores

    @classmethod
    def open(cls, dir_path: str, mmap: bool = True, writable: bool = False,
             device: str | torch.device | None = None,
             **overrides) -> "ShardedStringStore":
        """Open every shard of a sharded directory (either package's) on
        ``device`` (default ``"cuda"``; none for a host codec), against one
        load of the shared dictionary and one upload of its tables."""
        with open(os.path.join(dir_path, MANIFEST)) as f:
            manifest = json.load(f)
        source = _shared_codec(dir_path, mmap, device)
        stores = [open_shard(dir_path, k, mmap=mmap, source=source,
                             writable=writable, device=device, **overrides)
                  for k in range(manifest["n_shards"])]
        bounds = [tuple(b) for b in manifest["bounds"]]
        # the LAST shard owns the growing end of the global id space: its
        # bound extends to cover appends saved after the manifest was
        # written. Any other shard disagreeing with the manifest would
        # silently renumber every id behind it — refuse instead.
        for k, store in enumerate(stores):
            lo, hi = bounds[k]
            if store.n_strings != hi - lo:
                if k < len(stores) - 1:
                    raise ValueError(
                        f"shard {k} holds {store.n_strings} strings but the "
                        f"manifest bounds say {hi - lo}: only the last shard "
                        "may grow — appends must route through "
                        "ShardedStringStore.extend, not a non-tail shard")
                bounds[k] = (lo, lo + store.n_strings)
        return cls(stores, bounds, dir_path=dir_path)

    # ------------------------------------------------------------- data plane
    # every shard store lives in this process, so there is nothing to prefer:
    # each shard IS its own primary and read_preference resolves to it
    def _shard_multiget(self, k: int, local_ids: list[int],
                        read_preference: str | None = None) -> list[bytes]:
        return self.stores[k].multiget(local_ids)

    def _shard_scan(self, k: int, lo: int, hi: int,
                    read_preference: str | None = None) -> list[bytes]:
        return self.stores[k].scan(lo, hi)

    def _shard_stats(self, k: int) -> dict:
        return self.stores[k].stats_snapshot()

    def _shard_locate(self, k: int, strings: list[bytes],
                      read_preference: str | None = None
                      ) -> list[int | None]:
        return self.stores[k].locate_batch(strings)

    def _shard_scan_prefix(self, k: int, prefix: bytes, limit: int | None,
                           after: tuple[bytes, int] | None,
                           read_preference: str | None = None
                           ) -> list[tuple[int, bytes]]:
        # a shard store's global ids ARE shard-local ids
        return self.stores[k].scan_prefix(prefix, limit, after)

    def _shard_tier(self, k: int, action: str = "stats",
                    segment: int | None = None,
                    params: dict | None = None) -> dict:
        return tier_op(self.stores[k], action=action, segment=segment,
                       params=params)

    def _writable_tail_store(self):
        store = self.stores[-1]
        if not hasattr(store, "extend"):
            raise TypeError("shards are read-only; reopen with "
                            "ShardedStringStore.open(dir, writable=True)")
        return store

    def _tail_extend(self, strings: list[bytes]) -> tuple[list[int], int]:
        store = self._writable_tail_store()
        local_ids = store.extend(strings)
        return local_ids, store.n_strings

    # -------------------------------------------------------------- lifecycle
    def save(self) -> None:
        """Persist every writable shard (each as a versioned layout inside
        its shard directory) and atomically rewrite the manifest bounds —
        without this, appends live only in memory. In-place only: the
        sharded layout (shared dictionary + manifest + read-only shards)
        already lives in the directory this router was opened from."""
        target = self._dir
        if target is None:
            raise ValueError("no directory: this router was not opened from "
                             "a sharded store directory (use save_sharded "
                             "to write a new layout)")
        # the write lock freezes bounds for the whole snapshot: a racing
        # extend() must not slip acknowledged ids into the manifest after
        # their shard corpus has already been written
        with self._write_lock:
            for k, store in enumerate(self.stores):
                # only shards with unsaved appends/compactions rewrite their
                # generation — untouched shards keep the shared flat layout
                if getattr(store, "_dirty", False):
                    store.save(os.path.join(target, f"shard-{k:04d}"))
            with open(os.path.join(target, MANIFEST)) as f:
                manifest = json.load(f)
            manifest.update(n_strings=self.n_strings,
                            bounds=[list(b) for b in self.bounds])
            write_json_atomic(os.path.join(target, MANIFEST), manifest)

    def compact(self, shard: int | None = None, **kw) -> list[dict]:
        """Compact one shard (or all of them) in place. Each shard re-trains
        on its own live data — after this the shards no longer share one
        dictionary artifact, exactly as in a rolling per-host rewrite."""
        targets = range(len(self.stores)) if shard is None else [shard]
        reports = []
        for k in targets:
            store = self.stores[k]
            if not hasattr(store, "compact"):
                raise TypeError("shards are read-only; reopen with "
                                "ShardedStringStore.open(dir, writable=True)")
            reports.append(store.compact(**kw))
        return reports
