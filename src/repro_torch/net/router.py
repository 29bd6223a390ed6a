"""RemoteShardClient + DistributedStringStore — the routing tier.

:class:`RemoteShardClient` speaks :mod:`repro_torch.net.protocol` to one shard
server through a small connection pool (each in-flight request leases one
socket, so a slow ``compact`` on one connection never head-of-line-blocks a
``multiget`` on another) and transparently reconnects with capped
exponential backoff — a shard process that is killed and restarted is
re-found without the caller noticing more than latency.

:class:`DistributedStringStore` is the multi-process form of
:class:`~repro_torch.distributed.shard_store.ShardedStringStore` and shares
its :class:`~repro_torch.distributed.shard_store.ShardRouter` base, so the
global contract (order-preserving multiget, contiguous bounds, tail-owned
appends) is the same code — only the data plane swaps from in-process
stores to sockets, with ``multiget`` fanning out per shard concurrently.
The router is host code: it holds no tensor and launches no kernel (the
servers do), and it reads servers of either package.

Compaction hand-off: ``register_replica(shard, address)`` attaches a
read-only server (same directory, same versioned generation) to a shard.
While ``compact(shard)`` runs, reads covered by the replica drain to it and
appends targeting the shard park in a bounded retry queue; when the primary
returns (its new ``current.json`` generation is published at that point),
queued appends replay in arrival order and their callers get their ids —
acknowledged appends are never lost, and reads never wait on the rewrite.

Replica read load-balancing: replicas are a *set* per shard, and
``read_preference`` routes reads across it outside compaction windows too —
``"replica"`` round-robins reads over the shard's covering replicas (falling
back to the primary when none is registered or none covers the requested
ids), ``"any"`` round-robins over primary + covering replicas, ``"primary"``
always reads the primary. The staleness guard is generational: a replica
serves the generation it opened, so it is only eligible for a read whose
ids it provably holds (its ``n_strings`` at registration / last compact
refresh); anything newer — appends acknowledged after the replica opened —
must come from the primary.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from repro_torch.distributed.shard_store import (
    MANIFEST,
    ShardRouter,
    check_read_preference,
    manifest_replicas,
)
from repro_torch.net import protocol as P
from repro_torch.obs import TRACER
from repro_torch.store.store import write_json_atomic


#: ops safe to re-send after a transport failure mid-exchange — everything
#: else (append/extend/compact/save) may already have been applied by a
#: slow-but-alive server, so blind resends would duplicate work
_IDEMPOTENT_OPS = frozenset(
    {P.OP_PING, P.OP_GET, P.OP_MULTIGET, P.OP_SCAN, P.OP_STATS,
     P.OP_TRACE_DUMP, P.OP_LOCATE, P.OP_SCAN_PREFIX, P.OP_TIER}
)


class RemoteShardClient:
    """Pooled, reconnecting RPC client for one shard server.

    Reads reconnect and retry transparently. Writes retry only while a
    connection cannot be *established*; once a write has been put on the
    wire, a transport failure surfaces as ConnectionError instead of
    resending — the server may already have applied it, and duplicating
    appends silently is worse than making the caller decide.
    """

    def __init__(
        self,
        address: tuple[str, int],
        timeout: float = 30.0,
        pool_size: int = 4,
        reconnect_attempts: int = 16,
        retry_delay_s: float = 0.05,
        max_retry_delay_s: float = 0.5,
        max_frame: int = P.DEFAULT_MAX_FRAME,
    ):
        self.address = (str(address[0]), int(address[1]))
        self.timeout = float(timeout)
        self.pool_size = int(pool_size)
        self.reconnect_attempts = int(reconnect_attempts)
        self.retry_delay_s = float(retry_delay_s)
        self.max_retry_delay_s = float(max_retry_delay_s)
        self.max_frame = int(max_frame)
        self._pool: queue.LifoQueue = queue.LifoQueue()
        self._closed = False
        self.reconnects = 0
        #: does the server speak trace-header (v2) frames? None = unknown —
        #: resolved lazily by a CAPS_PROBE ping the first time a traced
        #: request goes out, so old servers are never sent v2 frames
        self._traced: bool | None = None
        #: full capability dict from the probe ({} for an old echo-only
        #: server, None until a probe has run)
        self._caps: dict | None = None

    # ------------------------------------------------------------ connections
    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self.address, timeout=self.timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _checkout(self) -> socket.socket:
        try:
            return self._pool.get_nowait()
        except queue.Empty:
            return self._connect()

    def _checkin(self, sock: socket.socket) -> None:
        if self._closed or self._pool.qsize() >= self.pool_size:
            sock.close()
        else:
            self._pool.put(sock)

    def close(self) -> None:
        self._closed = True
        while True:
            try:
                self._pool.get_nowait().close()
            except queue.Empty:
                return

    def __enter__(self) -> "RemoteShardClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------------- calls
    def _probe_caps(self) -> bool:
        """Resolve whether the server understands trace-header frames.

        One :data:`~repro_torch.net.protocol.CAPS_PROBE` ping: an old server's
        ping handler echoes the probe verbatim, a trace-aware server answers
        a capability JSON — the difference IS the negotiation, so no new op
        (which an old server would reject) is needed.
        """
        resp = self._exchange(P.OP_PING, P.CAPS_PROBE, -1.0, None)
        caps = None
        if resp != P.CAPS_PROBE:
            try:
                caps = P.unpack_json(resp)
            except Exception:
                caps = None
        self._caps = caps if isinstance(caps, dict) else {}
        self._traced = bool(caps) and bool(caps.get("trace"))
        return self._traced

    @property
    def supports_locate(self) -> bool:
        """Does the server answer OP_LOCATE / OP_SCAN_PREFIX? Resolved by
        the same one-shot CAPS_PROBE as trace support; an old server's echo
        resolves to False and callers fall back to scan-side filtering."""
        if self._caps is None:
            self._probe_caps()
        return bool(self._caps and self._caps.get("locate"))

    @property
    def supports_tier(self) -> bool:
        """Does the server answer OP_TIER (cold-tier control)? Same
        one-shot CAPS_PROBE; an old server's echo resolves to False and
        tier calls report {"enabled": False} instead of erroring."""
        if self._caps is None:
            self._probe_caps()
        return bool(self._caps and self._caps.get("tier"))

    def _call(self, op: int, payload: bytes = b"", timeout: float = -1.0) -> bytes:
        """One request/response exchange, traced when a request trace is
        active: the exchange gets an ``rpc.<op>`` span and — once a caps
        probe has confirmed the server is trace-aware — the span's context
        rides the frame header so server-side spans join the same trace."""
        if TRACER.current() is None:
            return self._exchange(op, payload, timeout, None)
        if self._traced is None and op != P.OP_PING:
            try:
                self._probe_caps()
            except Exception:
                pass  # unreachable/hostile: this call goes untraced on wire
        with TRACER.span(f"rpc.{P.OP_NAMES.get(op, hex(op))}",
                         shard=f"{self.address[0]}:{self.address[1]}") as ctx:
            return self._exchange(op, payload, timeout,
                                  ctx if self._traced else None)

    def _exchange(self, op: int, payload: bytes, timeout: float,
                  trace) -> bytes:
        """The raw exchange; reconnect-and-retry on transport failure (dead
        socket, truncated frame) for idempotent ops, never on application
        errors (those arrive as ST_ERR and re-raise once).

        ``timeout=None`` blocks for as long as the server works (compaction
        can legitimately outlast the default request timeout); the
        ``-1.0`` sentinel means "use the client's configured timeout".
        """
        if self._closed:
            raise RuntimeError("client is closed")
        last: Exception | None = None
        for attempt in range(self.reconnect_attempts + 1):
            if attempt:
                self.reconnects += 1
                time.sleep(
                    min(
                        self.retry_delay_s * (2 ** (attempt - 1)),
                        self.max_retry_delay_s,
                    )
                )
            try:
                sock = self._checkout()
            except OSError as exc:
                last = exc  # nothing was sent: always safe to retry
                continue
            sock.settimeout(self.timeout if timeout == -1.0 else timeout)
            try:
                P.send_frame(sock, op, payload, trace=trace)
                frame = P.recv_frame(sock, max_frame=self.max_frame)
                if frame is None:
                    raise P.TruncatedFrameError("server closed before answering")
            except (OSError, P.TruncatedFrameError) as exc:
                sock.close()
                if op in _IDEMPOTENT_OPS:
                    last = exc
                    continue
                # a write already on the wire may have been applied — do not
                # resend it; surface the uncertainty to the caller instead
                raise ConnectionError(
                    f"{P.OP_NAMES.get(op, hex(op))} to {self.address[0]}:"
                    f"{self.address[1]} failed mid-exchange; the server may "
                    "or may not have applied it"
                ) from exc
            except P.ProtocolError:
                # oversized/garbled response: the stream cannot be reused
                sock.close()
                raise
            status, resp = frame
            sock.settimeout(self.timeout)
            self._checkin(sock)
            if status == P.ST_ERR:
                P.raise_remote(resp)
            if status != P.ST_OK:
                raise P.ProtocolError(f"unexpected response status 0x{status:02x}")
            return resp
        raise ConnectionError(
            f"shard server {self.address[0]}:{self.address[1]} unreachable "
            f"after {self.reconnect_attempts + 1} attempts"
        ) from last

    def ping(self, payload: bytes = b"") -> bytes:
        return self._call(P.OP_PING, payload)

    def get(self, i: int) -> bytes:
        return self._call(P.OP_GET, P.pack_ids([i]))

    def multiget(self, ids) -> list[bytes]:
        return P.unpack_bytes_list(self._call(P.OP_MULTIGET, P.pack_ids(ids)))

    def scan(self, lo: int, hi: int) -> list[bytes]:
        return P.unpack_bytes_list(self._call(P.OP_SCAN, P.pack_ids([lo, hi])))

    def locate_batch(self, strings) -> list[int | None]:
        """Shard-local ids of ``strings``; misses travel as -1 on the wire
        and come back as None."""
        resp = self._call(
            P.OP_LOCATE, P.pack_bytes_list([bytes(s) for s in strings])
        )
        return [None if gid < 0 else gid for gid in P.unpack_ids(resp)]

    def scan_prefix(
        self,
        prefix: bytes,
        limit: int | None = 100,
        after: tuple[bytes, int] | None = None,
    ) -> list[tuple[int, bytes]]:
        resp = self._call(
            P.OP_SCAN_PREFIX, P.pack_prefix_query(bytes(prefix), limit, after)
        )
        return P.unpack_prefix_hits(resp)

    def append(self, s: bytes) -> int:
        return P.unpack_ids(self._call(P.OP_APPEND, bytes(s)))[0]

    def extend(self, strings: list[bytes]) -> list[int]:
        return P.unpack_ids(self._call(P.OP_EXTEND, P.pack_bytes_list(strings)))

    def stats(self, metrics: bool = False) -> dict:
        """Server stats; ``metrics=True`` additionally asks for the server's
        registry snapshot (mergeable histogram/counter states)."""
        payload = P.pack_json({"metrics": True}) if metrics else b""
        return P.unpack_json(self._call(P.OP_STATS, payload))

    def trace_dump(self, n: int = 16) -> list[dict]:
        """The server's slow-request log: its ``n`` slowest recent traces."""
        return P.unpack_json(
            self._call(P.OP_TRACE_DUMP, P.pack_json({"n": int(n)})))

    def tier(
        self,
        action: str = "stats",
        segment: int | None = None,
        params: dict | None = None,
    ) -> dict:
        """Tier control on the shard server: ``stats`` / ``demote`` /
        ``promote`` (``segment=None`` acts on every eligible segment).
        Servers predating OP_TIER report ``{"enabled": False}``."""
        if not self.supports_tier:
            return {"enabled": False}
        req: dict = {"action": action}
        if segment is not None:
            req["segment"] = int(segment)
        if params:
            req["params"] = params
        # demotion re-encodes whole segments: let it outlast the timeout
        return P.unpack_json(
            self._call(P.OP_TIER, P.pack_json(req), timeout=None)
        )

    def compact(self, **kw) -> dict:
        # retrain + rewrite can far outlast the request timeout: block
        return P.unpack_json(
            self._call(P.OP_COMPACT, P.pack_json(kw) if kw else b"", timeout=None)
        )

    def save(self) -> dict:
        return P.unpack_json(self._call(P.OP_SAVE, timeout=None))

    @property
    def n_strings(self) -> int:
        return int(self.stats()["n_strings"])


class DistributedStringStore(ShardRouter):
    """Global-id router over per-shard RPC servers (multi-process form)."""

    def __init__(
        self,
        clients: list[RemoteShardClient],
        bounds: list[tuple[int, int]],
        dir_path: str | None = None,
        max_workers: int | None = None,
        max_pending_appends: int = 1024,
        scan_chunk: int = 4096,
        read_preference: str = "primary",
    ):
        if len(clients) != len(bounds):
            raise ValueError("one client per shard bound required")
        super().__init__(bounds, dir_path=dir_path,
                         read_preference=read_preference)
        self.clients = clients
        self.max_pending_appends = int(max_pending_appends)
        self.scan_chunk = int(scan_chunk)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or min(32, 2 * max(1, len(clients))),
            thread_name_prefix="dstore",
        )
        #: per-shard replica SET: [client, covered_n_strings] pairs. The
        #: covered count is the generational staleness guard — a replica is
        #: only eligible for reads it provably holds.
        self._replicas: dict[int, list[list]] = {}
        self._rr: dict[int, int] = {}  # round-robin cursors (races benign)
        self._draining: dict[int, bool] = {}
        self._pending: dict[int, queue.Queue] = {}
        self._flush_locks: dict[int, threading.Lock] = {}

    @classmethod
    def connect(
        cls,
        addresses,
        bounds: list[tuple[int, int]] | None = None,
        dir_path: str | None = None,
        client_kw: dict | None = None,
        auto_replicas: bool = True,
        **kw,
    ) -> "DistributedStringStore":
        """Connect to shard servers (``[(host, port), ...]``, in shard
        order). Without explicit ``bounds`` each shard is asked its
        ``n_strings`` and the contiguous global bounds are derived — the
        live-cluster equivalent of reading the manifest.

        With ``dir_path`` (and ``auto_replicas`` left on) any replica
        addresses recorded in the cluster manifest
        (:func:`repro_torch.distributed.shard_store.record_replicas`) register
        automatically, so ``read_preference="replica"|"any"`` load-balances
        without manual wiring. A recorded replica that is down or refuses
        (e.g. restarted writable) is skipped — discovery must not fail the
        connect."""
        clients = [RemoteShardClient(a, **(client_kw or {})) for a in addresses]
        try:
            if bounds is None:
                bounds = []
                lo = 0
                for c in clients:
                    n = c.n_strings
                    bounds.append((lo, lo + n))
                    lo += n
            store = cls(clients, bounds, dir_path=dir_path, **kw)
        except BaseException:
            # bounds derivation already opened sockets (n_strings is an
            # RPC); a dead shard or a bad constructor kwarg must not leak
            # the ones that connected
            for c in clients:
                c.close()
            raise
        if auto_replicas and dir_path is not None:
            store.discover_replicas(client_kw=client_kw)
        return store

    def discover_replicas(self, client_kw: dict | None = None) -> int:
        """Register every manifest-recorded replica not already attached;
        returns how many registered. Callable again after a spawner adds
        replicas to a live cluster."""
        if self._dir is None:
            return 0
        registered = 0
        for shard, addrs in manifest_replicas(self._dir).items():
            if not 0 <= shard < len(self.clients):
                continue
            known = {c.address for c, _ in self._replicas.get(shard, ())}
            for addr in addrs:
                addr = (str(addr[0]), int(addr[1]))
                if addr in known or addr == self.clients[shard].address:
                    continue
                try:
                    self.register_replica(shard, addr, **(client_kw or {}))
                    registered += 1
                except (OSError, ConnectionError, ValueError):
                    continue  # down or not a read-only replica: skip
        return registered

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        for c in self.clients:
            c.close()
        for replicas in self._replicas.values():
            for c, _ in replicas:
                c.close()

    def __enter__(self) -> "DistributedStringStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- data plane
    def _covering_replicas(self, k: int, max_local: int) -> list[RemoteShardClient]:
        """Replicas of shard k whose registered generation holds every
        requested id (the staleness guard: a replica serves the generation
        it opened, so ids at or beyond its covered count must come from the
        primary)."""
        return [c for c, n in self._replicas.get(k, ()) if max_local < n]

    def _round_robin(
        self, k: int, candidates: list[RemoteShardClient]
    ) -> RemoteShardClient:
        cursor = self._rr.get(k, 0)
        self._rr[k] = cursor + 1
        return candidates[cursor % len(candidates)]

    def _read_client(
        self, k: int, max_local: int, read_preference: str | None = None
    ) -> RemoteShardClient:
        """Resolve which server answers a read of shard ``k``.

        While the shard drains (compact in flight) any covering replica wins
        regardless of preference — that is the hand-off. Otherwise
        ``read_preference`` decides: ``replica`` round-robins over covering
        replicas (primary as fallback), ``any`` round-robins over primary +
        covering replicas, ``primary`` (default) always hits the primary.
        """
        pref = check_read_preference(read_preference or self.read_preference)
        covering = self._covering_replicas(k, max_local)
        if covering:
            if self._draining.get(k) or pref == "replica":
                return self._round_robin(k, covering)
            if pref == "any":
                return self._round_robin(k, [self.clients[k]] + covering)
        return self.clients[k]

    def _shard_multiget(
        self, k: int, local_ids: list[int], read_preference: str | None = None
    ) -> list[bytes]:
        client = self._read_client(
            k, max(local_ids) if local_ids else -1, read_preference
        )
        return client.multiget(local_ids)

    def _shard_scan(
        self, k: int, lo: int, hi: int, read_preference: str | None = None
    ) -> list[bytes]:
        """Range decode in bounded-count chunks: one giant scan response
        would trip the protocol's max_frame refusal; N modest RPCs stream
        the same bytes."""
        out: list[bytes] = []
        for c_lo in range(lo, hi, self.scan_chunk):
            c_hi = min(c_lo + self.scan_chunk, hi)
            # re-resolve per chunk so replica round-robin spreads a long
            # scan across the whole replica set
            client = self._read_client(k, c_hi - 1, read_preference)
            out.extend(client.scan(c_lo, c_hi))
        return out

    def _shard_stats(self, k: int) -> dict:
        return self.clients[k].stats()

    def _shard_locate(
        self, k: int, strings: list[bytes], read_preference: str | None = None
    ) -> list[int | None]:
        """Reverse lookup on shard ``k``. A locate can match ANY id in the
        shard, so only replicas covering the whole shard are eligible (the
        generational staleness guard with max_local = shard size - 1).
        Servers predating OP_LOCATE fall back to a scan-side compare."""
        lo, hi = self.bounds[k]
        client = self._read_client(k, hi - lo - 1, read_preference)
        if client.supports_locate:
            return client.locate_batch(strings)
        return self._scan_locate_fallback(k, strings, read_preference)

    def _scan_locate_fallback(
        self, k: int, strings: list[bytes], read_preference: str | None
    ) -> list[int | None]:
        """Old-server interop: stream the shard in scan chunks and compare
        raw strings client-side. First (lowest) local id wins, matching the
        index semantics; stops as soon as every query has resolved."""
        want: dict[bytes, list[int]] = {}
        for pos, s in enumerate(strings):
            want.setdefault(s, []).append(pos)
        out: list[int | None] = [None] * len(strings)
        unresolved = len(want)
        lo, hi = self.bounds[k]
        for c_lo in range(0, hi - lo, self.scan_chunk):
            if not unresolved:
                break
            c_hi = min(c_lo + self.scan_chunk, hi - lo)
            chunk = self._shard_scan(k, c_lo, c_hi, read_preference)
            for off, s in enumerate(chunk):
                positions = want.get(s)
                if positions is None or out[positions[0]] is not None:
                    continue
                for pos in positions:
                    out[pos] = c_lo + off
                unresolved -= 1
        return out

    def _shard_scan_prefix(
        self,
        k: int,
        prefix: bytes,
        limit: int | None,
        after: tuple[bytes, int] | None,
        read_preference: str | None = None,
    ) -> list[tuple[int, bytes]]:
        lo, hi = self.bounds[k]
        client = self._read_client(k, hi - lo - 1, read_preference)
        if client.supports_locate:
            return client.scan_prefix(prefix, limit, after)
        # old-server interop: stream the shard and filter client-side
        hits: list[tuple[bytes, int]] = []
        for c_lo in range(0, hi - lo, self.scan_chunk):
            c_hi = min(c_lo + self.scan_chunk, hi - lo)
            chunk = self._shard_scan(k, c_lo, c_hi, read_preference)
            for off, s in enumerate(chunk):
                local = c_lo + off
                if not s.startswith(prefix):
                    continue
                if after is not None and (s, local) <= after:
                    continue
                hits.append((s, local))
        hits.sort()
        if limit is not None:
            hits = hits[:limit]
        return [(local, s) for s, local in hits]

    def _shard_tier(
        self,
        k: int,
        action: str = "stats",
        segment: int | None = None,
        params: dict | None = None,
    ) -> dict:
        # tier control always targets the primary: demotion state lives
        # with the store that owns the segment files
        return self.clients[k].tier(action, segment=segment, params=params)

    def _fanout_multiget(
        self,
        jobs: list[tuple[int, list[int]]],
        read_preference: str | None = None,
    ) -> list[list[bytes]]:
        """Per-shard fan-out on the pool: one RPC per touched shard, all in
        flight concurrently; reassembly order is the caller's job list."""
        if len(jobs) == 1:  # don't pay executor latency for one shard
            k, local_ids = jobs[0]
            return [self._shard_multiget(k, local_ids, read_preference)]
        # pool threads have no ambient trace — re-activate the caller's so
        # each shard's rpc.multiget span lands in the same request trace
        ctx = TRACER.current()
        futs = [
            self._pool.submit(self._traced_shard_multiget, ctx, k, lids,
                              read_preference)
            for k, lids in jobs
        ]
        return [f.result() for f in futs]

    def _traced_shard_multiget(self, ctx, k, local_ids, read_preference):
        prev = TRACER.activate(ctx)
        try:
            return self._shard_multiget(k, local_ids, read_preference)
        finally:
            TRACER.restore(prev)

    def _tail_extend(self, strings: list[bytes]) -> tuple[list[int], int]:
        local_ids = self.clients[-1].extend(strings)
        if not local_ids:
            return local_ids, self.bounds[-1][1] - self.bounds[-1][0]
        return local_ids, local_ids[-1] + 1

    # ----------------------------------------------------------------- writes
    def extend(self, strings: list[bytes]) -> list[int]:
        """Append via the tail shard's primary; while that shard is
        compacting, park in the bounded retry queue instead and block until
        the post-compact replay acknowledges real ids."""
        k = len(self.clients) - 1
        if self._draining.get(k):
            fut: Future = Future()
            pending = self._pending[k]
            try:
                pending.put(
                    ([bytes(s) for s in strings], fut),
                    timeout=self.clients[k].timeout,
                )
            except queue.Full:
                raise RuntimeError(
                    f"append retry queue full ({self.max_pending_appends} "
                    "batches) while shard compacts — back off and retry"
                ) from None
            if not self._draining.get(k):
                # compact finished between the flag check and the put: the
                # flusher may already have drained past us — flush ourselves
                self._flush_pending(k)
            return fut.result()
        return super().extend(strings)

    def _flush_pending(self, k: int) -> None:
        """Replay parked appends in arrival order against the primary.

        The per-shard flush lock admits ONE drainer at a time: the compact
        thread's post-swap flush and an appender's double-check flush can
        race, and two concurrent drainers could otherwise interleave their
        ``extend`` calls and assign ids out of arrival order.
        """
        pending = self._pending.get(k)
        if pending is None:
            return
        with self._flush_locks[k]:
            while True:
                try:
                    strings, fut = pending.get_nowait()
                except queue.Empty:
                    return
                try:
                    fut.set_result(super().extend(strings))
                except Exception as exc:
                    fut.set_exception(exc)

    # -------------------------------------------------------------- lifecycle
    def register_replica(
        self, shard: int, address: tuple[str, int], **client_kw
    ) -> RemoteShardClient:
        """Attach a read-only replica server to ``shard``'s replica set
        (opened from the same directory's current versioned generation).
        Reads drain to the set during that shard's ``compact()``, and
        ``read_preference="replica"|"any"`` round-robins reads across it at
        any time."""
        client = RemoteShardClient(address, **client_kw)
        stats = client.stats()
        if stats.get("writable"):
            raise ValueError(
                f"replica for shard {shard} at {address} is writable — "
                "replicas must be started with --read-only"
            )
        self._replicas.setdefault(shard, []).append([client, int(stats["n_strings"])])
        return client

    def refresh_replicas(self, shard: int) -> None:
        """Re-read each replica's covered count (the staleness guard) — a
        replica restarted from a newer generation becomes eligible for the
        ids it now holds."""
        for pair in self._replicas.get(shard, ()):
            pair[1] = pair[0].n_strings

    def compact(self, shard: int | None = None, **kw) -> list[dict]:
        """Compact one shard (or all). With a registered replica the shard
        enters hand-off: reads drain to the replica, appends park in the
        retry queue, and both flip back the moment the primary has published
        its new generation."""
        targets = range(len(self.clients)) if shard is None else [shard]
        return [self._compact_one(k, **kw) for k in targets]

    def _compact_one(self, k: int, **kw) -> dict:
        if not self._replicas.get(k):
            return self.clients[k].compact(**kw)
        # refresh coverage: each replica serves ids it had when it opened
        self.refresh_replicas(k)
        self._pending.setdefault(k, queue.Queue(maxsize=self.max_pending_appends))
        self._flush_locks.setdefault(k, threading.Lock())
        self._draining[k] = True
        try:
            # blocking RPC: when it returns, the primary has swapped state
            # and (when directory-backed) published its new current.json
            return self.clients[k].compact(**kw)
        finally:
            self._draining[k] = False
            self._flush_pending(k)

    def save(self) -> list[dict]:
        """Ask every writable shard server to persist its generation, then
        rewrite the local manifest bounds when this router knows the
        directory (single-host topologies; remote routers leave the
        manifest to the operator)."""
        with self._write_lock:
            reports = []
            for k, c in enumerate(self.clients):
                if self._shard_stats(k).get("writable"):
                    reports.append(c.save())
            if self._dir is not None:
                path = os.path.join(self._dir, MANIFEST)
                with open(path) as f:
                    manifest = json.load(f)
                manifest.update(
                    n_strings=self.n_strings,
                    bounds=[list(b) for b in self.bounds],
                )
                write_json_atomic(path, manifest)
        return reports
