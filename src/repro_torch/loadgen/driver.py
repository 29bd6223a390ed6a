"""Closed- and open-loop drivers over a :class:`repro_torch.client.StoreClient`.

Closed loop holds a fixed number of requests in flight (throughput probe:
how fast can the stack drain a saturating client). Open loop fires ops at
their scheduled arrival times regardless of completions (latency probe:
what does a *paced* workload see, queueing included) — latencies are
measured from the *intended* arrival, not the issue instant, so a driver
that falls behind cannot hide server queueing (no coordinated omission).

Both loops ride the client's async surface (``get_async`` coalesces point
reads into batched multiget RPCs; hedged variants engage when the spec
sets ``hedge_ms``), so one Python thread sustains thousands of in-flight
ops without a thread per request.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from repro_torch.loadgen.spec import (Op, WorkloadSpec, build_schedule,
                                      payload_strings)
from repro_torch.obs import Histogram, summarize_hist_state


@dataclass
class RunResult:
    """What one driver run observed, client side."""

    loop: str
    duration_s: float
    ops_issued: int = 0
    ops_ok: int = 0
    ops_failed: int = 0
    per_kind: dict = field(default_factory=dict)
    #: open loop only: ops issued behind their scheduled arrival
    late: int = 0
    bytes_read: int = 0
    #: client-observed latency histogram state (open loop: from intended
    #: arrival; closed loop: from issue) — mergeable/summarizable
    latency_state: dict | None = None
    first_errors: list = field(default_factory=list)

    @property
    def achieved_rate(self) -> float:
        return self.ops_ok / self.duration_s if self.duration_s > 0 else 0.0

    @property
    def error_rate(self) -> float:
        n = self.ops_issued
        return self.ops_failed / n if n else 0.0

    def summary(self) -> dict:
        return {
            "loop": self.loop,
            "duration_s": round(self.duration_s, 3),
            "ops_issued": self.ops_issued,
            "ops_ok": self.ops_ok,
            "ops_failed": self.ops_failed,
            "error_rate": round(self.error_rate, 6),
            "late": self.late,
            "achieved_rate": round(self.achieved_rate, 1),
            "bytes_read": self.bytes_read,
            "per_kind": dict(self.per_kind),
            "client_latency": summarize_hist_state(self.latency_state),
            "first_errors": list(self.first_errors),
        }


class _Run:
    """Shared completion bookkeeping for both loops (thread-safe: client
    completion callbacks fire on pool/IO threads)."""

    def __init__(self, spec: WorkloadSpec, client,
                 queries: dict[int, bytes] | None = None):
        self.spec = spec
        self.client = client
        #: id -> stored string, prefetched before timing starts so locate /
        #: scan_prefix ops don't pay a read on the measured path
        self.queries = queries or {}
        self.hist = Histogram("loadgen_observed_latency_us")
        self.lock = threading.Lock()
        self.per_kind: dict[str, int] = {}
        self.ok = 0
        self.failed = 0
        self.bytes_read = 0
        self.first_errors: list[str] = []
        self.outstanding = 0
        self.drained = threading.Condition(self.lock)
        self._payload_rng = np.random.default_rng(spec.seed + 1)
        # scans/prefix scans are sync on the client; a small side pool keeps
        # them from stalling the issue loop without thread-per-op
        self._scan_pool = (
            ThreadPoolExecutor(max_workers=4, thread_name_prefix="lg-scan")
            if (spec.mix.get("scan", 0) > 0
                or spec.mix.get("scan_prefix", 0) > 0) else None)

    # ------------------------------------------------------------------ issue
    def issue(self, op: Op, t_ref: float, on_done=None) -> None:
        """Fire one op; record completion against ``t_ref`` (intended
        arrival for open loop, issue time for closed)."""
        spec, client = self.spec, self.client
        with self.lock:
            self.outstanding += 1
            self.per_kind[op.kind] = self.per_kind.get(op.kind, 0) + 1
        try:
            if op.kind == "get":
                if spec.hedge_ms is not None:
                    fut = client.get_hedged_async(
                        op.ids[0], hedge_ms=spec.hedge_ms,
                        read_preference=spec.read_preference)
                else:
                    fut = client.get_async(
                        op.ids[0], read_preference=spec.read_preference)
            elif op.kind == "multiget":
                if spec.hedge_ms is not None:
                    fut = client.multiget_hedged_async(
                        list(op.ids), hedge_ms=spec.hedge_ms,
                        read_preference=spec.read_preference)
                else:
                    fut = client.multiget_async(
                        list(op.ids), read_preference=spec.read_preference)
            elif op.kind == "scan":
                lo, hi = op.ids
                fut = self._scan_pool.submit(client.scan, lo, hi)
            elif op.kind == "locate":
                s = self.queries[op.ids[0]]
                if op.n_payload:  # scheduled miss: perturb past any match
                    s = s + b"\x00@@miss@@"
                fut = client.locate_async(
                    s, read_preference=spec.read_preference)
            elif op.kind == "scan_prefix":
                prefix = self.queries[op.ids[0]][:spec.prefix_len]
                fut = self._scan_pool.submit(
                    client.scan_prefix, prefix, spec.prefix_limit)
            elif op.kind == "append":
                fut = client.append_async(
                    payload_strings(spec, self._payload_rng, 1)[0])
            else:  # extend
                fut = client.extend_async(
                    payload_strings(spec, self._payload_rng, op.n_payload))
        except Exception as exc:  # submission itself failed
            self._complete(op, t_ref, None, exc, on_done)
            return
        fut.add_done_callback(
            lambda f: self._complete(op, t_ref, f, f.exception(), on_done))

    def _complete(self, op: Op, t_ref: float, fut, exc, on_done) -> None:
        dt_us = (time.perf_counter() - t_ref) * 1e6
        nbytes = 0
        if exc is None and fut is not None and op.kind in (
                "get", "multiget", "scan"):
            res = fut.result()
            nbytes = (len(res) if isinstance(res, (bytes, bytearray))
                      else sum(len(v) for v in res))
        elif exc is None and fut is not None and op.kind == "scan_prefix":
            nbytes = sum(len(s) for _gid, s in fut.result())
        with self.lock:
            self.outstanding -= 1
            if exc is None:
                self.ok += 1
                self.hist.record(dt_us)
                self.bytes_read += nbytes
            else:
                self.failed += 1
                if len(self.first_errors) < 8:
                    self.first_errors.append(f"{op.kind}: {exc!r}")
            self.drained.notify_all()
        if on_done is not None:
            on_done()

    # ------------------------------------------------------------------ drain
    def wait_drained(self, timeout_s: float = 30.0) -> None:
        deadline = time.perf_counter() + timeout_s
        with self.lock:
            while self.outstanding > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                self.drained.wait(left)
        if self._scan_pool is not None:
            self._scan_pool.shutdown(wait=False)

    def result(self, loop: str, duration_s: float, late: int) -> RunResult:
        return RunResult(
            loop=loop, duration_s=duration_s,
            ops_issued=sum(self.per_kind.values()),
            ops_ok=self.ok, ops_failed=self.failed,
            per_kind=dict(self.per_kind), late=late,
            bytes_read=self.bytes_read,
            latency_state=self.hist.state(),
            first_errors=list(self.first_errors))


def _run_closed(run: _Run, schedule: list[Op], duration_s: float) -> RunResult:
    spec = run.spec
    window = threading.Semaphore(max(1, int(spec.concurrency)))
    start = time.perf_counter()
    deadline = start + duration_s
    for op in itertools.cycle(schedule):
        window.acquire()
        now = time.perf_counter()
        if now >= deadline:
            window.release()
            break
        run.issue(op, now, on_done=window.release)
    run.wait_drained()
    return run.result("closed", time.perf_counter() - start, late=0)


def _run_open(run: _Run, schedule: list[Op], duration_s: float) -> RunResult:
    start = time.perf_counter()
    deadline = start + duration_s
    late = 0
    for op in schedule:
        target = start + op.at_s
        if target >= deadline:
            break
        now = time.perf_counter()
        if target > now:
            time.sleep(target - now)
        elif now - target > 0.001:
            late += 1  # issue loop fell >1ms behind the schedule
        # t_ref = intended arrival: queueing delay counts against the SLO
        run.issue(op, target)
        if time.perf_counter() >= deadline:
            break
    run.wait_drained()
    return run.result("open", time.perf_counter() - start, late=late)


def run_workload(client, spec: WorkloadSpec, duration_s: float,
                 schedule: list[Op] | None = None) -> RunResult:
    """Drive ``client`` with ``spec`` for ``duration_s`` seconds.

    Writes in the mix require a writable backend — a read-only target
    surfaces as per-op errors in the result, not a crash, so mixed specs
    degrade visibly instead of aborting the read measurement.
    """
    if schedule is None:
        n = estimate_n_ops(spec, duration_s)
        schedule = build_schedule(spec, max(1, client.n_strings), n)
    if not schedule:
        raise ValueError("empty schedule")
    # prefetch locate / scan_prefix query strings outside the measured
    # window — the measured op is the reverse lookup, not the read
    qids = sorted({op.ids[0] for op in schedule
                   if op.kind in ("locate", "scan_prefix")})
    queries = dict(zip(qids, client.multiget(qids))) if qids else None
    run = _Run(spec, client, queries)
    if spec.loop == "open":
        return _run_open(run, schedule, duration_s)
    return _run_closed(run, schedule, duration_s)


def estimate_n_ops(spec: WorkloadSpec, duration_s: float) -> int:
    """Schedule length to materialise up front. Open loop: the arrival
    process fixes it (rate × duration + slack). Closed loop: a generous
    guess — the driver cycles the schedule, so too-small only repeats ops,
    never starves the window."""
    if spec.loop == "open":
        return max(16, int(spec.rate * duration_s * 1.25) + 64)
    return max(1024, int(spec.concurrency) * 256)
