"""StoreClient — one session object over every store deployment shape.

``connect(url)`` resolves a store URL (:mod:`repro_torch.client.url`) into a
backend — a local :class:`CompressedStringStore` / `MutableStringStore`, an
in-process :class:`ShardedStringStore`, or a multi-process
:class:`DistributedStringStore` — and wraps it in a :class:`StoreClient`
with a *frozen* surface: the same sync calls
(``get/multiget/scan/locate/scan_prefix/append/extend/stats/compact/save/
close``), the same async counterparts returning
``concurrent.futures.Future``
(``get_async/multiget_async/locate_async/append_async/extend_async``), the
same streaming ``scan_iter`` / ``scan_prefix_iter``, and the same
per-call options (``timeout=``,
``read_preference="primary"|"replica"|"any"``) no matter which deployment
shape sits behind it. New backends land behind this surface once, not once
per call site.

How the async path pipelines, per backend:

* **local stores** (``file://`` / ``mut://``) — every data call rides the
  store's micro-batching :class:`~repro_torch.store.service.StoreService` bulk
  hooks (``submit_multiget`` / ``submit_extend``): one queue item + one
  future per call, and concurrent calls — sync callers on other threads
  included — coalesce into single batched decodes / Encoder passes. The
  service is created by the client (``max_wait_s`` defaults to 0 here:
  drain-what's-there, no standing latency tax) and the ``target_p99_ms``
  connect option arms its adaptive window controller.
* **routers** (``shard://`` / ``tcp://``) — sync calls go straight at the
  router (its own per-shard fan-out pool and the
  :class:`RemoteShardClient` connection pools do the pipelining; a
  per-call ``timeout=`` opts into the future path to get the bound);
  async calls overlap on a small client executor.

Every call is recorded client-side (op counts, latency reservoir, bytes
moved), so :meth:`stats` reports one schema — ``latency_summary`` /
``throughput_mib_s`` / ``wakeups`` — with identical keys across all four
backends; the raw backend snapshot rides along under ``"backend"``.

The surface, the batchers and the stats schema are the reference's
(``repro.client.session``). What is the port's own is where the local
stores run: ``file://``, ``mut://`` and ``shard://`` open OnPair16 stores
on the card by default and take ``device=`` (a keyword or ``?device=cpu``)
like every entry point of the port; without CUDA and without
``device="cpu"`` the open raises (:func:`repro_torch.device.resolve_device`),
never falling back to the host. On the card each batch the client-owned
service drains is one ``store.multiget``: one decode launch, two when it
touches a writable store's tail. ``tcp://`` has no device on the client
side (the servers chose theirs), so ``device=`` there is refused before any
socket opens.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

from repro_torch.client.url import StoreURL, parse_url
from repro_torch.core.metrics import throughput_mib_s
from repro_torch.distributed.shard_store import (ShardedStringStore,
                                                 ShardRouter,
                                                 check_read_preference)
from repro_torch.obs import (REGISTRY, TRACER, Histogram, merge_hist_states,
                             summarize_hist_state)
from repro_torch.store.mutable import MutableStringStore
from repro_torch.store.service import StoreService
from repro_torch.store.store import CompressedStringStore


class _GetBatcher:
    """Client-side coalescer for router point lookups.

    A router backend pays one RPC round-trip per ``get``. This batcher
    gives single gets the same bulk pipeline multiget already rides:
    pending gets accumulate while one batched RPC is in flight and drain as
    ONE ``backend.multiget`` per
    ``read_preference`` group. A lone get drains immediately (batch of one,
    no added latency); pipelined gets coalesce into server-sized batches
    automatically — Nagle without the timer.

    Futures flip to RUNNING only at drain time, so a future cancelled while
    still pending (a hedged read whose first attempt won) never reaches the
    wire at all — the cancellation the hedging tests assert via server-side
    op counters.
    """

    def __init__(self, backend, submit, max_batch: int = 512):
        self._backend = backend
        self._submit = submit  # client executor hand-off (trace-preserving)
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._pending: list[tuple] = []  # (id, pref, Future, TraceContext)
        self._in_flight = False
        self.batches = 0
        self.coalesced = 0  # gets answered in a client-side batch of > 1

    def submit_get(self, i: int, pref: str) -> Future:
        fut: Future = Future()
        with self._lock:
            self._pending.append((int(i), pref, fut, TRACER.current()))
            launch = not self._in_flight
            if launch:
                self._in_flight = True
        if launch:
            self._submit(self._drain)
        return fut

    def _drain(self) -> None:
        while True:
            with self._lock:
                take = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if not take:
                    self._in_flight = False
                    return
            # cancelled-while-pending futures drop out before the wire;
            # survivors flip to RUNNING so a late cancel cannot race
            live = [item for item in take
                    if item[2].set_running_or_notify_cancel()]
            if not live:
                continue
            self.batches += 1
            if len(live) > 1:
                self.coalesced += len(live)
            groups: dict[str, list[tuple]] = {}
            for item in live:
                groups.setdefault(item[1], []).append(item)
            for pref, items in groups.items():
                self._serve_group(pref, items)

    def _serve_group(self, pref: str, items: list[tuple]) -> None:
        """One backend.multiget for every get in the group; the first traced
        caller's context parents the fused rpc spans (same convention as the
        service's coalesced decode)."""
        ids = [i for i, _, _, _ in items]
        ctx = next((c for _, _, _, c in items if c is not None), None)
        prev = TRACER.activate(ctx) if ctx is not None else None
        try:
            values = self._backend.multiget(ids, read_preference=pref)
        except Exception as exc:
            for _, _, fut, _ in items:
                fut.set_exception(exc)
        else:
            for (_, _, fut, _), v in zip(items, values):
                fut.set_result(v)
        finally:
            if ctx is not None:
                TRACER.restore(prev)


class _ExtendBatcher:
    """Client-side group-commit for router writes (mirror of
    :class:`_GetBatcher`).

    A router backend pays one RPC round-trip per ``extend`` — and one per
    ``append``. Pending writes accumulate while one bulk RPC is in flight
    and drain as ONE ``backend.extend`` over the concatenated strings; the
    id list the backend returns (aligned with input order) is split back
    per caller by span. Single appends ride the same queue as one-string
    extends, so pipelined appends group-commit into the server's batched
    Encoder pass exactly like the service queue does for local stores.

    Futures flip to RUNNING only at drain time: a write cancelled while
    still pending never reaches the wire.
    """

    def __init__(self, backend, submit, max_batch: int = 4096):
        self._backend = backend
        self._submit = submit  # client executor hand-off (trace-preserving)
        self.max_batch = int(max_batch)  # strings per drained RPC, not calls
        self._lock = threading.Lock()
        self._pending: list[tuple] = []  # (strings, Future, TraceContext)
        self._in_flight = False
        self.batches = 0
        self.coalesced = 0  # extend/append calls fused into a batch of > 1

    def submit_extend(self, strings: list[bytes]) -> Future:
        fut: Future = Future()
        with self._lock:
            self._pending.append((strings, fut, TRACER.current()))
            launch = not self._in_flight
            if launch:
                self._in_flight = True
        if launch:
            self._submit(self._drain)
        return fut

    def _drain(self) -> None:
        while True:
            take: list[tuple] = []
            n = 0
            with self._lock:
                # at least one call per round; stop adding once the drained
                # RPC would exceed max_batch strings (an oversized single
                # call still goes out whole — the server chunks internally)
                while self._pending and (not take or
                                         n + len(self._pending[0][0])
                                         <= self.max_batch):
                    item = self._pending.pop(0)
                    take.append(item)
                    n += len(item[0])
                if not take:
                    self._in_flight = False
                    return
            live = [item for item in take
                    if item[1].set_running_or_notify_cancel()]
            if not live:
                continue
            self.batches += 1
            if len(live) > 1:
                self.coalesced += len(live)
            flat: list[bytes] = []
            spans: list[tuple[int, int]] = []
            for strings, _, _ in live:
                spans.append((len(flat), len(flat) + len(strings)))
                flat.extend(strings)
            ctx = next((c for _, _, c in live if c is not None), None)
            prev = TRACER.activate(ctx) if ctx is not None else None
            try:
                ids = self._backend.extend(flat)
            except Exception as exc:
                for _, fut, _ in live:
                    fut.set_exception(exc)
            else:
                for (_, fut, _), (lo, hi) in zip(live, spans):
                    fut.set_result(ids[lo:hi])
            finally:
                if ctx is not None:
                    TRACER.restore(prev)


class StoreClient:
    """Uniform session over one store backend. Use :func:`connect` (URL) or
    :func:`wrap` (already-open backend) instead of constructing directly."""

    def __init__(self, backend, *, url: str = "", scheme: str = "",
                 timeout: float = 30.0, read_preference: str = "primary",
                 scan_chunk: int = 4096, owns_backend: bool = False,
                 service: StoreService | None = None,
                 max_async_workers: int = 8):
        self.backend = backend
        self.url = url
        self.scheme = scheme
        self.timeout = float(timeout)
        self.read_preference = check_read_preference(read_preference)
        self.scan_chunk = int(scan_chunk)
        self._owns_backend = owns_backend
        self._is_router = isinstance(backend, ShardRouter)
        self._service = service
        self._executor = (None if service is not None else
                          ThreadPoolExecutor(max_workers=max_async_workers,
                                             thread_name_prefix="store-client"))
        self._closed = False
        self._lock = threading.Lock()
        # router backends coalesce async point lookups client-side; local
        # stores already coalesce through the service queue
        self._get_batcher = (None if service is not None else
                             _GetBatcher(backend, self._submit))
        # ...and async writes the same way: pipelined extends/appends fuse
        # into one bulk RPC per drain (group-commit at the client edge)
        self._extend_batcher = (None if service is not None else
                                _ExtendBatcher(backend, self._submit))
        # per-client histogram (stats() stays session-scoped), registered so
        # /metrics in a client process exports the same series name
        self._lat = REGISTRY.register(
            Histogram("repro_client_request_latency_us"))
        self._ops: dict[str, int] = {}
        self._bytes_moved = 0
        self._busy_s = 0.0
        self._hedges = 0      # hedge attempts actually sent
        self._hedge_wins = 0  # hedged requests answered by a later attempt

    # ------------------------------------------------------------ bookkeeping
    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("client is closed")

    def _pref(self, read_preference: str | None) -> str:
        if read_preference is None:
            return self.read_preference
        return check_read_preference(read_preference)

    def _record(self, op: str, t0: float, nbytes: int) -> None:
        dt = time.perf_counter() - t0
        self._lat.record(dt * 1e6)
        with self._lock:
            self._ops[op] = self._ops.get(op, 0) + 1
            self._bytes_moved += nbytes
            self._busy_s += dt

    def _tracked(self, fut: Future, op: str, t0: float, nbytes_of,
                 ctx=None, parent_id: int = 0) -> Future:
        """Attach session accounting (and the request's root span, when one
        was minted at submit time) to a backend/service future."""
        def _done(f: Future) -> None:
            nbytes = 0
            if not f.cancelled() and f.exception() is None:
                nbytes = nbytes_of(f.result())
            if ctx is not None:
                TRACER.record(f"client.{op}", ctx, parent_id, t0,
                              time.perf_counter() - t0)
            self._record(op, t0, nbytes)
        fut.add_done_callback(_done)
        return fut

    def _trace_submit(self, submit):
        """Mint this request's root span context, activate it around the
        backend submit (queue items / executor jobs capture it there), and
        return ``(future, ctx, parent_id)`` for :meth:`_tracked`."""
        ctx, parent_id = TRACER.new_context()
        prev = TRACER.activate(ctx)
        try:
            return submit(), ctx, parent_id
        finally:
            TRACER.restore(prev)

    @staticmethod
    def _len_sum(values) -> int:
        return sum(len(v) for v in values)

    def _submit(self, fn, *args, **kw) -> Future:
        """Run ``fn`` on the client executor (router backends only); the
        submitter's trace context rides along onto the executor thread."""
        ctx = TRACER.current()
        if ctx is not None:
            inner = fn

            def fn(*a, **k):  # noqa: F811 — traced wrapper shadows on purpose
                prev = TRACER.activate(ctx)
                try:
                    return inner(*a, **k)
                finally:
                    TRACER.restore(prev)
        try:
            return self._executor.submit(fn, *args, **kw)
        except RuntimeError:  # executor shut down under a racing close()
            raise RuntimeError("client is closed") from None

    def _direct(self, op: str, call, nbytes_of):
        """Sync hot path for router backends: call straight into the
        router's own fan-out — no executor hand-off. A per-call ``timeout=``
        opts back into the future path (that is what buys the bound);
        remote transports stay bounded regardless by the socket timeout."""
        self._check_open()
        t0 = time.perf_counter()
        with TRACER.span(f"client.{op}", root=True):
            out = call()
        self._record(op, t0, nbytes_of(out))
        return out

    # ---------------------------------------------------------------- queries
    @property
    def n_strings(self) -> int:
        return len(self.backend)

    def __len__(self) -> int:
        return self.n_strings

    def get_async(self, i: int, *,
                  read_preference: str | None = None) -> "Future[bytes]":
        self._check_open()
        # validated on EVERY backend — a typo'd preference must fail the
        # same way whether or not this backend can act on it
        pref = self._pref(read_preference)
        t0 = time.perf_counter()
        if self._service is not None:
            fut, ctx, pid = self._trace_submit(
                lambda: self._service.submit(int(i)))
        else:
            # ride the bulk multiget pipeline: pipelined gets coalesce into
            # one RPC per drain instead of one round-trip per string
            fut, ctx, pid = self._trace_submit(
                lambda: self._get_batcher.submit_get(int(i), pref))
        return self._tracked(fut, "get", t0, len, ctx, pid)

    def multiget_async(self, ids, *,
                       read_preference: str | None = None
                       ) -> "Future[list[bytes]]":
        """One batched lookup as a future; many in flight pipeline through
        the service queue (local) or the router fan-out (shard/tcp)."""
        self._check_open()
        pref = self._pref(read_preference)
        t0 = time.perf_counter()
        ids = [int(i) for i in ids]
        if self._service is not None:
            fut, ctx, pid = self._trace_submit(
                lambda: self._service.submit_multiget(ids))
        else:
            fut, ctx, pid = self._trace_submit(
                lambda: self._submit(self.backend.multiget, ids,
                                     read_preference=pref))
        return self._tracked(fut, "multiget", t0, self._len_sum, ctx, pid)

    def get(self, i: int, *, timeout: float | None = None,
            read_preference: str | None = None) -> bytes:
        if self._service is None and timeout is None:
            return self._direct(
                "get",
                lambda: self.backend.get(
                    int(i), read_preference=self._pref(read_preference)),
                len)
        return self.get_async(i, read_preference=read_preference).result(
            self.timeout if timeout is None else timeout)

    def multiget(self, ids, *, timeout: float | None = None,
                 read_preference: str | None = None) -> list[bytes]:
        if self._service is None and timeout is None:
            ids = [int(i) for i in ids]
            return self._direct(
                "multiget",
                lambda: self.backend.multiget(
                    ids, read_preference=self._pref(read_preference)),
                self._len_sum)
        return self.multiget_async(
            ids, read_preference=read_preference).result(
            self.timeout if timeout is None else timeout)

    # ---------------------------------------------------------- hedged reads
    def _hedged_async(self, submit, prefs: tuple[str, ...], hedge_s: float,
                      budget: int) -> Future:
        """Tail-tolerant read: launch attempt 0 with ``prefs[0]``; if it has
        not answered after ``hedge_s``, launch a second attempt with
        ``prefs[1]`` (typically a replica) — first answer wins, the loser is
        cancelled (a still-pending loser never reaches the wire; one already
        in flight is abandoned). A failed attempt retries immediately while
        the total attempt ``budget`` lasts, so one dead/slow server costs
        one hedge window, not the caller's whole timeout.
        """
        out: Future = Future()
        out.set_running_or_notify_cancel()  # resolved by callbacks below
        lock = threading.Lock()
        state = {"attempts": 0, "pending": [], "timer": None, "done": False}

        def finish(result=None, exc=None) -> None:
            with lock:
                if state["done"]:
                    return
                state["done"] = True
                timer, losers = state["timer"], list(state["pending"])
                state["pending"] = []
            if timer is not None:
                timer.cancel()
            for f in losers:
                f.cancel()
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(result)

        def on_done(f: Future) -> None:
            with lock:
                if f in state["pending"]:
                    state["pending"].remove(f)
                pending_left = bool(state["pending"])
            if f.cancelled():
                return
            exc = f.exception()
            if exc is None:
                if getattr(f, "_hedge_attempt", 0) > 0:
                    with self._lock:
                        self._hedge_wins += 1
                finish(result=f.result())
                return
            with lock:
                can_retry = not state["done"] and state["attempts"] < budget
            if can_retry:
                launch()
            elif not pending_left:
                finish(exc=exc)

        def launch() -> None:
            with lock:
                if state["done"] or state["attempts"] >= budget:
                    return
                k = state["attempts"]
                state["attempts"] += 1
            if k > 0:
                with self._lock:
                    self._hedges += 1
            try:
                f = submit(prefs[min(k, len(prefs) - 1)])
            except Exception as exc:
                finish(exc=exc)
                return
            f._hedge_attempt = k
            with lock:
                late = state["done"]
                if not late:
                    state["pending"].append(f)
            if late:
                f.cancel()
            f.add_done_callback(on_done)

        launch()
        if budget > 1 and hedge_s is not None:
            if hedge_s <= 0:
                # an immediate hedge must actually be immediate: going
                # through a zero-delay timer would race thread spawn
                # against the first attempt's answer
                launch()
            else:
                timer = threading.Timer(float(hedge_s), launch)
                timer.daemon = True
                with lock:
                    if not state["done"]:
                        state["timer"] = timer
                        timer.start()
        return out

    def _hedge_prefs(self, read_preference: str | None,
                     hedge_preference: str) -> tuple[str, str]:
        return (self._pref(read_preference),
                check_read_preference(hedge_preference))

    def get_hedged_async(self, i: int, *, hedge_ms: float = 10.0,
                         budget: int = 2, read_preference: str | None = None,
                         hedge_preference: str = "any") -> "Future[bytes]":
        """Point lookup with a hedge: the second attempt (after ``hedge_ms``
        without an answer, while the attempt ``budget`` lasts) targets
        ``hedge_preference`` — against a replica-backed cluster the hedge
        lands on a different server, which is what makes open-loop p999
        honest under one slow shard."""
        self._check_open()
        prefs = self._hedge_prefs(read_preference, hedge_preference)
        t0 = time.perf_counter()
        i = int(i)
        if self._service is not None:
            def submit(_pref: str) -> Future:
                return self._service.submit(i)
        else:
            def submit(pref: str) -> Future:
                return self._get_batcher.submit_get(i, pref)
        fut, ctx, pid = self._trace_submit(
            lambda: self._hedged_async(submit, prefs, hedge_ms / 1e3,
                                       int(budget)))
        return self._tracked(fut, "get", t0, len, ctx, pid)

    def multiget_hedged_async(self, ids, *, hedge_ms: float = 10.0,
                              budget: int = 2,
                              read_preference: str | None = None,
                              hedge_preference: str = "any"
                              ) -> "Future[list[bytes]]":
        self._check_open()
        prefs = self._hedge_prefs(read_preference, hedge_preference)
        t0 = time.perf_counter()
        ids = [int(i) for i in ids]
        if self._service is not None:
            def submit(_pref: str) -> Future:
                return self._service.submit_multiget(ids)
        else:
            def submit(pref: str) -> Future:
                return self._submit(self.backend.multiget, ids,
                                    read_preference=pref)
        fut, ctx, pid = self._trace_submit(
            lambda: self._hedged_async(submit, prefs, hedge_ms / 1e3,
                                       int(budget)))
        return self._tracked(fut, "multiget", t0, self._len_sum, ctx, pid)

    def get_hedged(self, i: int, *, timeout: float | None = None,
                   **kw) -> bytes:
        return self.get_hedged_async(i, **kw).result(
            self.timeout if timeout is None else timeout)

    def multiget_hedged(self, ids, *, timeout: float | None = None,
                        **kw) -> list[bytes]:
        return self.multiget_hedged_async(ids, **kw).result(
            self.timeout if timeout is None else timeout)

    def scan(self, lo: int, hi: int, *,
             read_preference: str | None = None) -> list[bytes]:
        """Decode the contiguous id range [lo, hi) in one call (routers
        already chunk below max_frame internally; use :meth:`scan_iter` to
        stream without materialising the whole range)."""
        self._check_open()
        pref = self._pref(read_preference)
        t0 = time.perf_counter()
        if self._is_router:
            out = self.backend.scan(int(lo), int(hi), read_preference=pref)
        else:
            out = self.backend.scan(int(lo), int(hi))
        self._record("scan", t0, self._len_sum(out))
        return out

    def scan_iter(self, lo: int, hi: int, *, chunk: int | None = None,
                  read_preference: str | None = None):
        """Stream the id range [lo, hi) as an iterator of strings, fetched
        in ``chunk``-sized sub-scans (default: the client's ``scan_chunk``)
        so no response — RPC frame or in-memory list — ever covers more
        than one chunk. Out-of-range bounds raise IndexError from the
        offending chunk, after any earlier chunks have been yielded."""
        self._check_open()
        self._pref(read_preference)  # fail a typo now, not at first chunk
        lo, hi = int(lo), int(hi)
        if lo > hi or lo < 0:
            raise IndexError(f"scan range [{lo}, {hi}) is malformed")
        step = int(chunk) if chunk else self.scan_chunk

        def _gen():
            for c_lo in range(lo, hi, step):
                yield from self.scan(c_lo, min(c_lo + step, hi),
                                     read_preference=read_preference)
        return _gen()

    # --------------------------------------------------------- reverse lookup
    def _inline_future(self, call) -> Future:
        """Complete ``call()`` synchronously behind a Future — the async
        surface for ops with no service/executor pipeline on this backend."""
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        try:
            fut.set_result(call())
        except Exception as exc:
            fut.set_exception(exc)
        return fut

    def _locate_call(self, strings: list[bytes], pref: str):
        # plain stores take no read_preference; routers route on it
        if self._is_router:
            return self.backend.locate_batch(strings, read_preference=pref)
        return self.backend.locate_batch(strings)

    def locate_batch_async(self, strings, *,
                           read_preference: str | None = None
                           ) -> "Future[list[int | None]]":
        self._check_open()
        pref = self._pref(read_preference)
        t0 = time.perf_counter()
        strings = [bytes(s) for s in strings]
        if self._executor is not None:
            fut, ctx, pid = self._trace_submit(
                lambda: self._submit(self._locate_call, strings, pref))
        else:  # local backends: the store call is the whole pipeline
            fut, ctx, pid = self._trace_submit(
                lambda: self._inline_future(
                    lambda: self._locate_call(strings, pref)))
        return self._tracked(fut, "locate", t0, lambda _out: 0, ctx, pid)

    def locate_async(self, s, *, read_preference: str | None = None
                     ) -> "Future[int | None]":
        inner = self.locate_batch_async([s], read_preference=read_preference)
        out: Future = Future()

        def _done(f: Future) -> None:
            if f.cancelled():
                out.cancel()
            elif f.exception() is not None:
                out.set_exception(f.exception())
            else:
                out.set_result(f.result()[0])
        inner.add_done_callback(_done)
        return out

    def locate_batch(self, strings, *, timeout: float | None = None,
                     read_preference: str | None = None
                     ) -> list[int | None]:
        """Exact-match reverse lookup: the id of each stored string, or
        ``None`` for strings not in the store (lowest id wins on
        duplicates)."""
        if timeout is None:
            strings = [bytes(s) for s in strings]
            pref = self._pref(read_preference)
            return self._direct("locate",
                                lambda: self._locate_call(strings, pref),
                                lambda _out: 0)
        return self.locate_batch_async(
            strings, read_preference=read_preference).result(timeout)

    def locate(self, s, *, timeout: float | None = None,
               read_preference: str | None = None) -> int | None:
        return self.locate_batch([s], timeout=timeout,
                                 read_preference=read_preference)[0]

    def scan_prefix(self, prefix, limit: int | None = 100, after=None, *,
                    read_preference: str | None = None
                    ) -> list[tuple[int, bytes]]:
        """All stored strings starting with ``prefix`` as ``(id, string)``
        pairs in (string, id) order, at most ``limit`` of them; pass the
        last hit back as ``after=(string, id)`` to page (or use
        :meth:`scan_prefix_iter`)."""
        self._check_open()
        prefix = bytes(prefix)
        pref = self._pref(read_preference)
        if self._is_router:
            call = (lambda: self.backend.scan_prefix(
                prefix, limit, after, read_preference=pref))
        else:
            call = lambda: self.backend.scan_prefix(prefix, limit, after)
        return self._direct(
            "scan_prefix", call,
            lambda out: sum(len(s) for _gid, s in out))

    def scan_prefix_iter(self, prefix, *, chunk: int | None = None,
                         read_preference: str | None = None):
        """Stream every prefix hit as an iterator of ``(id, string)``
        pairs, fetched ``chunk`` hits at a time (default 256) via the
        ``after=`` cursor — no response ever covers more than one chunk."""
        self._check_open()
        self._pref(read_preference)  # fail a typo now, not at first chunk
        prefix = bytes(prefix)
        step = int(chunk) if chunk else 256

        def _gen():
            after = None
            while True:
                page = self.scan_prefix(prefix, limit=step, after=after,
                                        read_preference=read_preference)
                yield from page
                if len(page) < step:
                    return
                gid, s = page[-1]
                after = (s, gid)
        return _gen()

    # ----------------------------------------------------------------- writes
    def append_async(self, s: bytes) -> "Future[int]":
        self._check_open()
        t0 = time.perf_counter()
        if self._service is not None:
            fut, ctx, pid = self._trace_submit(
                lambda: self._service.submit_append(bytes(s)))
        else:
            fut, ctx, pid = self._trace_submit(
                lambda: self._append_via_batcher(bytes(s)))
        return self._tracked(fut, "append", t0, lambda _i: len(s), ctx, pid)

    def _append_via_batcher(self, s: bytes) -> "Future[int]":
        """A single append rides the extend batcher as a one-string extend,
        so pipelined appends group-commit; the id list unwraps to one id."""
        inner = self._extend_batcher.submit_extend([s])
        out: Future = Future()

        def _done(f: Future) -> None:
            if f.cancelled():
                out.cancel()
            elif f.exception() is not None:
                out.set_exception(f.exception())
            else:
                out.set_result(f.result()[0])
        inner.add_done_callback(_done)
        return out

    def extend_async(self, strings) -> "Future[list[int]]":
        """One batched append as a future; local stores fold concurrent
        extends into single Encoder passes via the service write hook."""
        self._check_open()
        t0 = time.perf_counter()
        strings = [bytes(s) for s in strings]
        nbytes = self._len_sum(strings)
        if self._service is not None:
            fut, ctx, pid = self._trace_submit(
                lambda: self._service.submit_extend(strings))
        else:
            fut, ctx, pid = self._trace_submit(
                lambda: self._extend_batcher.submit_extend(strings))
        return self._tracked(fut, "extend", t0, lambda _ids: nbytes, ctx, pid)

    def append(self, s: bytes, *, timeout: float | None = None) -> int:
        if self._service is None and timeout is None:
            s = bytes(s)
            return self._direct("append", lambda: self.backend.append(s),
                                lambda _i: len(s))
        return self.append_async(s).result(
            self.timeout if timeout is None else timeout)

    def extend(self, strings, *, timeout: float | None = None) -> list[int]:
        if self._service is None and timeout is None:
            strings = [bytes(s) for s in strings]
            nbytes = self._len_sum(strings)
            return self._direct("extend",
                                lambda: self.backend.extend(strings),
                                lambda _ids: nbytes)
        return self.extend_async(strings).result(
            self.timeout if timeout is None else timeout)

    # -------------------------------------------------------------- lifecycle
    def compact(self, shard: int | None = None, **kw):
        """Re-train + rewrite: the whole store (local), one shard, or every
        shard (routers). Read-only backends refuse with TypeError."""
        self._check_open()
        if not hasattr(self.backend, "compact"):
            raise TypeError(f"{self.scheme or 'this'} backend is read-only: "
                            "compact() refused")
        if self._is_router:
            return self.backend.compact(shard, **kw)
        if shard is not None:
            raise TypeError("shard= targeting requires a shard:// or tcp:// "
                            "backend")
        return self.backend.compact(**kw)

    def save(self, dir_path: str | None = None):
        """Persist the backend: local stores into their directory (or
        ``dir_path``), routers via their own save protocol."""
        self._check_open()
        if self._is_router:
            if dir_path is not None:
                raise TypeError("router backends persist in place: "
                                "save() takes no directory")
            return self.backend.save()
        target = dir_path or getattr(self.backend, "_dir", None) or (
            parse_url(self.url).path if self.url else None)
        if target is None:
            raise ValueError("no directory to save into (pass dir_path=)")
        return self.backend.save(target)

    def register_replica(self, shard: int, address, **client_kw):
        """Attach a read-only replica to a shard's replica set (tcp://
        backends only) — the target of replica reads and compaction
        hand-off."""
        self._check_open()
        if not hasattr(self.backend, "register_replica"):
            raise TypeError("register_replica requires a tcp:// backend")
        return self.backend.register_replica(shard, address, **client_kw)

    # ----------------------------------------------------------------- tiering
    def _tier(self, action: str, segment: int | None = None,
              shard: int | None = None, params: dict | None = None):
        """Route one tier-control op to the backend: routers fan it out per
        shard (list of reports), local stores answer directly (one dict)."""
        self._check_open()
        if self._is_router:
            return self.backend.tier(action, segment=segment, shard=shard,
                                     params=params)
        if shard is not None:
            raise TypeError("shard= targeting requires a shard:// or tcp:// "
                            "backend")
        from repro_torch.store.tier import tier_op
        return tier_op(self.backend, action=action, segment=segment,
                       params=params)

    def demote(self, segment: int | None = None, shard: int | None = None,
               **params):
        """Demote sealed segments to the mmap'd RLZ cold tier (all eligible
        segments when ``segment`` is None). ``params`` become TierManager
        thresholds on first use (demote_below/promote_above/halflife_s)."""
        return self._tier("demote", segment=segment, shard=shard,
                          params=params or None)

    def promote(self, segment: int | None = None, shard: int | None = None):
        """Promote cold segments back to hot OnPair heap arrays."""
        return self._tier("promote", segment=segment, shard=shard)

    def tier_stats(self):
        """Tier snapshot(s): cold segment set, demotion/promotion counts,
        per-segment read rates ({"enabled": False} where tiering is off)."""
        return self._tier("stats")

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._service is not None:
            self._service.close()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        if self._owns_backend and hasattr(self.backend, "close"):
            self.backend.close()

    def __enter__(self) -> "StoreClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """One stats schema across every backend: client-side op counts and
        ``latency_summary`` / ``throughput_mib_s``, the micro-batching
        service's ``wakeups`` / adaptive-window state where one exists
        (local backends; routers report the aggregate of their servers'),
        and the raw backend snapshot under ``"backend"``."""
        self._check_open()
        backend_snap = (self.backend.stats_snapshot()
                        if hasattr(self.backend, "stats_snapshot")
                        else self.backend.stats())
        wakeups = 0
        max_wait_s = None
        target_p99_s = None
        if self._service is not None:
            svc = self._service.stats()
            backend_snap = {**backend_snap, "service": svc}
            wakeups = svc["wakeups"]
            max_wait_s = svc["max_wait_s"]
            target_p99_s = svc["target_p99_s"]
        else:
            for shard_snap in backend_snap.get("shards", ()):
                svc = shard_snap.get("service")
                if svc:  # tcp:// shard servers export their service counters
                    wakeups += svc.get("wakeups", 0)
        # server-side op counts (tcp:// shard servers report them; other
        # backends have no server so the totals are empty) + cross-shard
        # store-latency aggregation: per-shard histogram states merge
        # losslessly, so the merged p50/p99 equal the pooled-population
        # percentiles no single shard could compute
        op_totals: dict[str, int] = {}
        per_shard_ops: list[dict] = []
        hist_states: list[dict] = []
        shards = backend_snap.get("shards")
        for k, shard_snap in enumerate(shards if shards is not None else ()):
            ops_k = shard_snap.get("ops")
            if ops_k:
                per_shard_ops.append({"shard": k, "ops": dict(ops_k)})
                for op, count in ops_k.items():
                    op_totals[op] = op_totals.get(op, 0) + int(count)
            store_snap = shard_snap.get("store", shard_snap)
            state = store_snap.get("multiget_latency_hist")
            if state:
                hist_states.append(state)
        if shards is None:
            state = backend_snap.get("multiget_latency_hist")
            if state:
                hist_states.append(state)
        merged = merge_hist_states(hist_states)
        lat = self._lat.summary()
        with self._lock:
            ops = dict(self._ops)
            moved, busy = self._bytes_moved, self._busy_s
            hedges, hedge_wins = self._hedges, self._hedge_wins
        batcher = self._get_batcher
        wb = self._extend_batcher
        return {
            "hedges": hedges,
            "hedge_wins": hedge_wins,
            "get_batches": batcher.batches if batcher is not None else 0,
            "coalesced_gets": batcher.coalesced if batcher is not None else 0,
            "extend_batches": wb.batches if wb is not None else 0,
            "coalesced_extends": wb.coalesced if wb is not None else 0,
            "scheme": self.scheme,
            "url": self.url,
            "n_strings": self.n_strings,
            "read_preference": self.read_preference,
            "ops": ops,
            "server_ops": {"total": op_totals, "per_shard": per_shard_ops},
            "store_latency": (summarize_hist_state(merged)
                              if merged is not None else None),
            "latency_summary": lat,
            "throughput_mib_s": round(throughput_mib_s(moved, busy), 2)
            if busy else 0.0,
            "wakeups": wakeups,
            "max_wait_s": max_wait_s,
            "target_p99_s": target_p99_s,
            "backend": backend_snap,
        }


# ------------------------------------------------------------------- factory
#: connect() options consumed by the client itself (everything else is
#: forwarded to the backend opener)
_CLIENT_OPTS = ("timeout", "read_preference", "scan_chunk",
                "max_async_workers")
#: options configuring the client-owned StoreService over local stores
_SERVICE_OPTS = ("max_batch", "max_wait_s", "target_p99_ms", "adapt_window")


def _build_service(store, opts: dict) -> StoreService:
    target_ms = opts.pop("target_p99_ms", None)
    return StoreService(
        store,
        max_batch=opts.pop("max_batch", 256),
        # latency-first default: drain whatever is queued, never hold a lone
        # caller hostage to a batching window (the adaptive controller can
        # re-open the window when target_p99_ms leaves headroom)
        max_wait_s=opts.pop("max_wait_s", 0.0),
        target_p99_s=None if target_ms is None else float(target_ms) / 1e3,
        adapt_window=opts.pop("adapt_window", 64),
    )


def _reject_service_opts(scheme: str, opts: dict) -> None:
    bad = sorted(k for k in _SERVICE_OPTS if k in opts)
    if bad:
        raise TypeError(
            f"{bad} configure the local micro-batching service and do not "
            f"apply to {scheme}:// backends — routers have no client-side "
            "service; set the knobs where the StoreService lives "
            "(shard servers: --max-wait-s / --target-p99-ms)")


def _make_client(backend, parsed: StoreURL, url: str, opts: dict,
                 owns_backend: bool) -> StoreClient:
    service = None
    if not isinstance(backend, ShardRouter):
        service = _build_service(backend, opts)
    else:
        _reject_service_opts(parsed.scheme, opts)
    client_kw = {k: opts.pop(k) for k in _CLIENT_OPTS if k in opts}
    if opts:
        raise TypeError(f"unknown connect() option(s): {sorted(opts)}")
    return StoreClient(backend, url=url, scheme=parsed.scheme,
                       owns_backend=owns_backend, service=service,
                       **client_kw)


def connect(url: str, **opts) -> StoreClient:
    """Resolve a store URL into a ready :class:`StoreClient`.

    ======================  ====================================================
    scheme                  backend
    ======================  ====================================================
    ``file://<dir>``        read-only ``CompressedStringStore.open``
    ``mut://<dir>``         writable ``MutableStringStore.open``
    ``shard://<dir>``       in-process ``ShardedStringStore.open``
                            (``writable=True`` to accept appends)
    ``tcp://h:p[,h:p...]``  ``DistributedStringStore.connect`` (shard order)
    ======================  ====================================================

    Options may ride the URL query string or come as keyword arguments
    (kwargs win): ``timeout=`` (default request timeout, seconds),
    ``read_preference=`` (default read routing), ``scan_chunk=``,
    ``target_p99_ms=`` / ``max_wait_s=`` / ``max_batch=`` (the local
    micro-batching service), plus backend-specific extras (``mmap=``,
    ``writable=``, router ``client_kw`` …). The directory schemes take
    ``device=`` (default ``"cuda"``: without a card they raise unless given
    ``device="cpu"``); ``tcp://`` refuses it.
    """
    parsed = parse_url(url)
    opts = {**parsed.options, **opts}
    client_opts = {k: opts.pop(k) for k in (*_CLIENT_OPTS, *_SERVICE_OPTS)
                   if k in opts}
    if parsed.scheme in ("shard", "tcp"):
        # fail before any backend opens — a rejected option must not leak
        # half-connected sockets
        _reject_service_opts(parsed.scheme, client_opts)
    if parsed.scheme == "tcp" and "device" in opts:
        raise TypeError(
            "device= chooses where a directory store runs and does not apply "
            "to tcp:// backends: each shard server chose its device at start "
            "(python -m repro_torch.net ... --device)")
    if parsed.scheme == "file":
        backend = CompressedStringStore.open(parsed.path, **opts)
    elif parsed.scheme == "mut":
        backend = MutableStringStore.open(parsed.path, **opts)
    elif parsed.scheme == "shard":
        backend = ShardedStringStore.open(parsed.path, **opts)
    else:  # tcp
        from repro_torch.net.router import DistributedStringStore

        if "read_preference" in client_opts:  # the router honours it natively
            opts.setdefault("read_preference",
                            client_opts["read_preference"])
        backend = DistributedStringStore.connect(parsed.addresses, **opts)
    return _make_client(backend, parsed, url, client_opts, owns_backend=True)


def wrap(backend, *, url: str = "", **opts) -> StoreClient:
    """Wrap an already-open backend (store or router) in the same frozen
    client surface ``connect()`` returns — for in-memory stores that never
    touched a URL. The caller keeps ownership: ``close()`` releases the
    client's service/executor but not the backend."""
    if isinstance(backend, ShardRouter):
        scheme = "tcp" if hasattr(backend, "clients") else "shard"
    elif isinstance(backend, MutableStringStore):
        scheme = "mut"
    elif isinstance(backend, CompressedStringStore):
        scheme = "file"
    else:
        raise TypeError(f"cannot wrap {type(backend).__name__}: expected a "
                        "store or a shard router")
    parsed = StoreURL(scheme=scheme)
    return _make_client(backend, parsed, url or f"{scheme}://<wrapped>",
                        opts, owns_backend=False)
