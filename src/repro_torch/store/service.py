"""Micro-batching request service over a CompressedStringStore.

High-volume point-lookup traffic arrives one id at a time; decoding one
string per kernel launch wastes the batch the decode kernel spreads over
the card. :class:`StoreService` coalesces concurrent lookups: a single
worker thread drains the request queue, waits up to ``max_wait_s`` for the
batch to fill (the micro-batching latency/throughput knob), and answers the
whole batch with ONE ``store.multiget``, which is one launch of the
multiget decode kernel over the store's device mirror (one more for a
writable store's tail).

Writes ride the same queue: against a
:class:`~repro_torch.store.mutable.MutableStringStore`,
``submit_append(s)`` enqueues a string and the worker folds every append in
the drained batch into ONE ``store.extend`` (one pass of the encode kernel)
before answering the batch's reads. Appends and reads interleave without
torn state because the store serialises both under its lock.

The bulk entry points ``submit_multiget(ids)`` / ``submit_extend(strings)``
let one request of many ids cost one queue item and one future, while the
worker still folds every read in the drained batch into one
``store.multiget`` and every write into one ``store.extend``:
micro-batching composes across callers.

The worker blocks on the queue (no idle polling): ``close()`` wakes it with
a sentinel. ``wakeups`` counts worker wakeups and therefore stays 0 while
the service is idle.

``max_wait_s`` is either a fixed knob or, when ``target_p99_s`` is set, the
output of a small feedback controller: the worker keeps a window of recent
request latencies and, every ``adapt_window`` requests, halves the wait when
the observed p99 overshoots the target and doubles it (up to
``max_wait_cap_s``) when p99 sits below half the target. The current wait,
the target and the adjustment count are all visible in :meth:`stats`.

Every launch of a service comes from its worker thread: the kernels'
launch counters and the stream kernel's per-stream scratch are safe there
(see :mod:`repro_torch.kernels.onpair_decode`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

from repro_torch.obs import REGISTRY, TRACER, Counter, Histogram
from repro_torch.store.store import CompressedStringStore


class StoreService:
    """Thread-safe coalescing front-end: ``submit(i) -> Future[bytes]``."""

    #: adaptive-controller floor: below this the wait snaps to 0 (drain-only)
    _MIN_WAIT_S = 5e-5

    def __init__(self, store: CompressedStringStore, max_batch: int = 256,
                 max_wait_s: float = 0.0005, target_p99_s: float | None = None,
                 adapt_window: int = 64, max_wait_cap_s: float = 0.01):
        self.store = store
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        self.target_p99_s = (None if target_p99_s is None
                             else float(target_p99_s))
        self.adapt_window = max(8, int(adapt_window))
        self.max_wait_cap_s = float(max_wait_cap_s)
        self.wait_adjustments = 0   # times the controller moved max_wait_s
        self._adapt_win: list[float] = []  # latencies since the last adapt
        # queue.Queue, not SimpleQueue: on CPython 3.12 a SimpleQueue's
        # get(timeout=t) can block forever when t runs out between its
        # deadline's set-up and its first lock acquire, and with it every
        # request of the batch being collected (_collect_batch)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()  # orders submit() vs close()
        # per-service histogram (stats() stays instance-scoped), registered
        # into the process registry so a snapshot merges every service in
        # the process into one repro_service_request_latency_us series
        self._lat = REGISTRY.register(
            Histogram("repro_service_request_latency_us"))
        self._requests_total = REGISTRY.register(
            Counter("repro_service_requests_total"))
        self.requests = 0
        self.batches = 0
        self.coalesced = 0          # requests answered in a batch of > 1
        self.max_batch_seen = 0
        self.appends = 0
        self.append_batches = 0     # store.extend calls (coalesced writes)
        self.wakeups = 0            # worker wakeups; 0 while idle (no polling)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="store-service")
        self._worker.start()

    # ----------------------------------------------------------------- client
    def submit(self, i: int) -> "Future[bytes]":
        """Enqueue a point lookup; resolves to the decoded string.

        Out-of-range ids fail their own future immediately instead of
        poisoning the coalesced batch they would have joined.
        """
        fut: Future = Future()
        i = int(i)
        if not 0 <= i < self.store.n_strings:
            fut.set_exception(IndexError(
                f"string id {i} out of range [0, {self.store.n_strings})"))
            return fut
        self._enqueue(("get", i, fut, time.perf_counter(),
                       TRACER.current()), fut, 1)
        return fut

    def submit_multiget(self, ids) -> "Future[list[bytes]]":
        """Enqueue one batched lookup; resolves to the decoded strings in
        request order.

        The whole request rides the queue as ONE item, so it costs one
        future while the worker still folds all concurrently drained reads
        into a single ``store.multiget``.
        """
        fut: Future = Future()
        ids = [int(i) for i in ids]
        n = self.store.n_strings
        for i in ids:
            if not 0 <= i < n:
                fut.set_exception(IndexError(
                    f"string id {i} out of range [0, {n})"))
                return fut
        self._enqueue(("multiget", ids, fut, time.perf_counter(),
                       TRACER.current()), fut, len(ids))
        return fut

    def submit_append(self, s: bytes) -> "Future[int]":
        """Enqueue an append; resolves to the new string's global id.

        Requires the store to be writable (``MutableStringStore.extend``);
        otherwise the future fails with TypeError. All appends drained into
        one batch are folded into a single ``store.extend`` call.
        """
        fut: Future = Future()
        if not hasattr(self.store, "extend"):
            fut.set_exception(TypeError(
                "store is read-only (open a MutableStringStore to append)"))
            return fut
        self._enqueue(("append", bytes(s), fut, time.perf_counter(),
                       TRACER.current()), fut, 1)
        return fut

    def submit_extend(self, strings) -> "Future[list[int]]":
        """Enqueue one batched append; resolves to the new global ids.

        The write-side bulk drain hook: one queue item per request, folded
        with every other append/extend in the drained batch into ONE
        ``store.extend`` (one pass of the encode kernel).
        """
        fut: Future = Future()
        if not hasattr(self.store, "extend"):
            fut.set_exception(TypeError(
                "store is read-only (open a MutableStringStore to append)"))
            return fut
        strings = [bytes(s) for s in strings]
        self._enqueue(("extend", strings, fut, time.perf_counter(),
                       TRACER.current()), fut, len(strings))
        return fut

    def _enqueue(self, item, fut: Future, n_requests: int) -> None:
        # atomic vs close(): either we enqueue before the shutdown sentinel,
        # or we observe _stop and fail fast — never an unresolved Future
        with self._submit_lock:
            if self._stop.is_set():
                fut.set_exception(RuntimeError("service is closed"))
                return
            self.requests += n_requests
            self._requests_total.inc(n_requests)
            self._q.put(item)

    def get(self, i: int, timeout: float | None = 30.0) -> bytes:
        return self.submit(i).result(timeout)

    def append(self, s: bytes, timeout: float | None = 30.0) -> int:
        return self.submit_append(s).result(timeout)

    def multiget(self, ids, timeout: float | None = 30.0) -> list[bytes]:
        futures = [self.submit(i) for i in ids]
        return [f.result(timeout) for f in futures]

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)  # wake the worker; nothing enqueues after this
        self._worker.join(timeout=5.0)

    def __enter__(self) -> "StoreService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict:
        lat = self._lat.summary()
        return {"requests": self.requests, "batches": self.batches,
                "coalesced": self.coalesced,
                "avg_batch": round(self.requests / self.batches, 2)
                if self.batches else 0.0,
                "max_batch_seen": self.max_batch_seen,
                "appends": self.appends,
                "append_batches": self.append_batches,
                "wakeups": self.wakeups,
                "max_wait_s": self.max_wait_s,
                "target_p99_s": self.target_p99_s,
                "wait_adjustments": self.wait_adjustments,
                "request_latency": lat,
                "request_latency_hist": self._lat.state()}

    # ----------------------------------------------------------------- worker
    def _collect_batch(self, first) -> list:
        """Wait up to max_wait_s for the batch to fill, then drain whatever
        is immediately available."""
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                item = (self._q.get(timeout=remaining) if remaining > 0
                        else self._q.get_nowait())
            except queue.Empty:
                break
            if item is None:
                self._stop.set()
                break
            batch.append(item)
        return batch

    def _drain_and_fail(self) -> None:
        """Fail any request that raced past submit()'s closed check and landed
        behind the shutdown sentinel — never leave a Future unresolved."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and item[2].set_running_or_notify_cancel():
                item[2].set_exception(RuntimeError("service is closed"))

    def _run(self) -> None:
        while True:
            # block until traffic or the close() sentinel arrives — an idle
            # service burns zero wakeups (asserted by tests via `wakeups`)
            item = self._q.get()
            if item is None:
                self._drain_and_fail()
                return
            self.wakeups += 1
            raw = self._collect_batch(item)
            # cancelled futures drop out here; surviving ones flip to RUNNING
            # so a late cancel() cannot race set_result below
            batch = [b for b in raw if b[2].set_running_or_notify_cancel()]
            # writes first: a client holding an id from a resolved append can
            # immediately read it back through the next batch
            writes = [b for b in batch if b[0] in ("append", "extend")]
            reads = [b for b in batch if b[0] in ("get", "multiget")]
            if writes:
                self._serve_writes(writes)
            if reads:
                self._serve_reads(reads)
            done = time.perf_counter()
            lats = [done - t for _, _, _, t, _ in batch]
            for dt in lats:
                self._lat.record(dt * 1e6)
            # one coalesce-wait span per traced request: the enqueue→answer
            # window a trace shows as the price of micro-batching
            for _, _, _, t0, ctx in batch:
                if ctx is not None:
                    TRACER.record_child("service.coalesce", ctx, t0,
                                        done - t0, batch=len(batch))
            if self.target_p99_s is not None:
                self._adapt_wait(lats)
            if len(batch) > 1:
                self.coalesced += len(batch)
            self.batches += 1
            self.max_batch_seen = max(self.max_batch_seen, len(batch))
            if self._stop.is_set():
                # _collect_batch consumed the close() sentinel mid-batch:
                # looping back to the blocking get would hang forever
                self._drain_and_fail()
                return

    def _adapt_wait(self, lats: list[float]) -> None:
        """Latency-aware controller: every ``adapt_window`` answered requests,
        move ``max_wait_s`` toward the largest batching window that still
        meets ``target_p99_s`` (the knob driven by the service's
        own latency counters). Multiplicative so it converges in a handful of
        windows; bounded by ``max_wait_cap_s``; snaps to 0 below _MIN_WAIT_S
        (a sub-50us window buys no coalescing but still costs a timed get)."""
        self._adapt_win.extend(lats)
        if len(self._adapt_win) < self.adapt_window:
            return
        win = sorted(self._adapt_win)
        self._adapt_win.clear()
        p99 = win[min(len(win) - 1, int(0.99 * len(win)))]
        old = self.max_wait_s
        if p99 > self.target_p99_s:
            new = self.max_wait_s / 2
            self.max_wait_s = new if new >= self._MIN_WAIT_S else 0.0
        elif p99 < self.target_p99_s / 2:
            self.max_wait_s = min(max(self.max_wait_s * 2, self._MIN_WAIT_S),
                                  self.max_wait_cap_s)
        if self.max_wait_s != old:
            self.wait_adjustments += 1

    def _serve_writes(self, writes: list) -> None:
        """Fold every append/extend in the drained batch into ONE
        store.extend, then split the contiguous ids back per request."""
        strings: list[bytes] = []
        spans: list[tuple[int, int]] = []  # [lo, hi) into `strings` per item
        for kind, payload, _, _, _ in writes:
            lo = len(strings)
            strings.extend([payload] if kind == "append" else payload)
            spans.append((lo, len(strings)))
        try:
            new_ids = self.store.extend(strings)
        except Exception as exc:
            for _, _, fut, _, _ in writes:
                fut.set_exception(exc)
            return
        self.appends += len(strings)
        self.append_batches += 1
        for (kind, _, fut, _, _), (lo, hi) in zip(writes, spans):
            fut.set_result(new_ids[lo] if kind == "append"
                           else new_ids[lo:hi])

    def _serve_reads(self, reads: list) -> None:
        """Fold every get/multiget in the drained batch into ONE
        store.multiget, then slice the answers back per request."""
        ids: list[int] = []
        spans: list[tuple[int, int]] = []
        for kind, payload, _, _, _ in reads:
            lo = len(ids)
            ids.extend([payload] if kind == "get" else payload)
            spans.append((lo, len(ids)))
        # the fused multiget serves every read in the batch, but a span needs
        # ONE parent — attach store-side spans to the first traced request
        ctx = next((c for _, _, _, _, c in reads if c is not None), None)
        prev = TRACER.activate(ctx) if ctx is not None else None
        try:
            values = self.store.multiget(ids)
        except Exception as exc:  # fail the whole batch, keep serving
            for _, _, fut, _, _ in reads:
                fut.set_exception(exc)
            return
        finally:
            if ctx is not None:
                TRACER.restore(prev)
        for (kind, _, fut, _, _), (lo, hi) in zip(reads, spans):
            fut.set_result(values[lo] if kind == "get" else values[lo:hi])
