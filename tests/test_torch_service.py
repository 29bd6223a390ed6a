"""The micro-batching StoreService and the rest of the Tracer on the port,
held against the JAX package's.

Port stores run on ``device="cpu"`` (the kernels' plain versions) and the
reference's on its numpy backend, over the same seeded titles and the same
artifact. Each case drives both packages' services with the same requests
and compares the answers, the ids and the payloads, answer for answer.
Covered: coalesced point lookups from threads, reads interleaved with
appends on the writable store, the bulk hooks, a read-only store refusing
appends, the idle worker's zero wakeups, ``close()`` landing mid-batch, the
adaptive wait controller, ``stats()``'s keys, the service's instruments in
the registry, and the tracer's queue hops (``record_child``,
``activate``/``restore``, ``new_context``, ``trace_dump``) with the
``service.coalesce`` and ``store.decode`` spans they book.

A wait on the service that times out, in a client thread or in the case
itself, and a client thread still alive after its join, first write every
thread's stack to stderr (``faulthandler``), so a stall of the worker
shows where each thread stood."""

import contextlib
import faulthandler
import sys
import threading
import time
import traceback
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest
import torch

from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.obs.trace import Tracer as RefTracer
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro.store import StoreService as RefService
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.kernels import ops
from repro_torch.obs import REGISTRY, TRACER, Tracer, new_trace_id, trace_dump
from repro_torch.store import (CompressedStringStore, MutableStringStore,
                               StoreService)

SAMPLE = 1 << 18
SPS = 256  # small segments so appends cross seal boundaries quickly
CPU = torch.device("cpu")
JOIN_S = 60.0  # every thread a case starts is joined within this and dead
#: timed waits on a fresh queue: a SimpleQueue on CPython 3.12 blocks for
#: good within about 10^3-10^4 of them at waits of 1-10 us
COLLECTS = 50_000


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: torch's intra-op threads would only
    contend with XLA's thread pool in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    strings = load_dataset("book_titles", SAMPLE)
    assert strings == ref_load_dataset("book_titles", SAMPLE)
    strings[3] = b""
    strings[7] = b"\x00\xff" * 9
    return strings


@pytest.fixture(scope="module")
def ref_art(titles):
    return registry.train("onpair16", titles, sample_bytes=SAMPLE)


@pytest.fixture(scope="module")
def port_art(ref_art):
    return DictArtifact.from_bytes(ref_art.to_bytes())


def _pair(port_art, ref_art, strings, **kw):
    """(port store, reference store) over the same artifact and corpus."""
    kw.setdefault("strings_per_segment", SPS)
    port = CompressedStringStore(
        port_art, Encoder(port_art, device=CPU).encode(strings), device=CPU, **kw)
    want = RefStore(ref_art, RefEncoder(ref_art).encode(strings),
                    backend="numpy", **kw)
    return port, want


def _mutable_pair(port_art, ref_art, strings, **kw):
    kw.setdefault("strings_per_segment", SPS)
    kw.setdefault("cache_bytes", 1 << 20)
    corpus = Encoder(port_art, device=CPU).encode(strings) if strings else None
    port = MutableStringStore(port_art, corpus, device=CPU, **kw)
    ref_corpus = RefEncoder(ref_art).encode(strings) if strings else None
    return port, RefMutable(ref_art, ref_corpus, **kw)


def _dump_all_stacks(why: str) -> None:
    """Write every thread's stack to stderr, where pytest shows it beside
    the failure; by ``faulthandler`` where stderr has a file descriptor,
    else from the interpreter's frames."""
    sys.stderr.write(f"\n--- {why}: the stack of every thread ---\n")
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    except (AttributeError, ValueError, OSError):  # stderr without a fileno
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in sys._current_frames().items():
            sys.stderr.write(f"Thread {names.get(ident, ident)}:\n")
            sys.stderr.write("".join(traceback.format_stack(frame)))
    sys.stderr.flush()


@contextlib.contextmanager
def _stacks_on_timeout():
    """Re-raise a timed-out service wait after dumping every thread's stack."""
    try:
        yield
    except FuturesTimeout:
        _dump_all_stacks("a wait on the service timed out")
        raise


def _run_threads(targets) -> None:
    """Start every (fn, args), join each within JOIN_S, assert all dead."""
    threads = [threading.Thread(target=fn, args=args) for fn, args in targets]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    if any(t.is_alive() for t in threads):
        _dump_all_stacks("a client thread outlived its join")
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def _assert_parentage(trace):
    """Every span is the root or a child of another span in the trace."""
    span_ids = {s["span_id"] for s in trace["spans"]}
    roots = [s for s in trace["spans"] if s["parent_id"] == 0]
    assert len(roots) == 1, f"expected one root span, got {roots}"
    for s in trace["spans"]:
        if s["parent_id"] != 0:
            assert s["parent_id"] in span_ids, f"orphaned span {s}"
        assert s["trace_id"] == trace["trace_id"]


# ------------------------------------------------------------ point lookups
def test_service_coalesces_and_matches(titles, port_art, ref_art):
    port, want = _pair(port_art, ref_art, titles)
    ids = np.random.default_rng(3).integers(0, len(titles), 300).tolist()
    answers = {}
    errs: list[Exception] = []
    for name, store, cls in (("port", port, StoreService),
                             ("ref", want, RefService)):
        with cls(store, max_batch=64, max_wait_s=0.002) as svc:
            got: dict[int, bytes] = {}

            def client(chunk, svc=svc, got=got):
                try:
                    with _stacks_on_timeout():
                        for i in chunk:
                            got[int(i)] = svc.get(int(i))
                except Exception as e:  # surfaced after join
                    errs.append(e)

            _run_threads([(client, (ids[k::4],)) for k in range(4)])
            assert not errs, errs[0]
            st = svc.stats()
            assert st["requests"] == 300
            assert 1 <= st["batches"] <= 300
            bad = svc.submit(len(titles) + 1)
            with pytest.raises(IndexError):
                bad.result(timeout=5)
        with pytest.raises(RuntimeError):
            svc.get(0)                  # closed service fails fast
        assert not svc._worker.is_alive()
        answers[name] = got
    assert answers["port"] == answers["ref"] == {i: titles[i] for i in ids}


def test_service_multiget_one_decode_batch_a_drain(titles, port_art, ref_art):
    """Reads a drained batch holds go to the store as one multiget: with the
    cache off, one decode batch (the kernel's plain version here)."""
    port, want = _pair(port_art, ref_art, titles[:1000], cache_bytes=0)
    ids = np.random.default_rng(4).permutation(1000).tolist()
    decodes0 = ops._DECODE_BATCHES["ref"].value
    with StoreService(port, max_batch=512, max_wait_s=0.05) as svc, \
            _stacks_on_timeout():
        futs = [svc.submit(i) for i in ids[:400]]
        futs.append(svc.submit_multiget(ids[400:]))
        got = [f.result(30) for f in futs]
    assert got[:400] == want.multiget(ids[:400])
    assert got[400] == want.multiget(ids[400:])
    st = svc.stats()  # read after close() joined the worker
    assert ops._DECODE_BATCHES["ref"].value - decodes0 == st["batches"] >= 1
    assert st["requests"] == 1000
    assert st["max_batch_seen"] <= 512


def test_service_stats_keys_match_reference(titles, port_art, ref_art):
    port, want = _pair(port_art, ref_art, titles[:200])
    with StoreService(port) as a, RefService(want) as b:
        assert a.get(5) == b.get(5) == titles[5]
        sa, sb = a.stats(), b.stats()
    assert sorted(sa) == sorted(sb)
    assert sorted(sa["request_latency"]) == sorted(sb["request_latency"])
    assert sorted(sa["request_latency_hist"]) == sorted(sb["request_latency_hist"])
    for key in ("requests", "batches", "coalesced", "avg_batch",
                "max_batch_seen", "appends", "append_batches", "max_wait_s",
                "target_p99_s", "wait_adjustments"):
        assert sa[key] == sb[key], key


def test_service_registers_its_instruments(titles, port_art, ref_art):
    port, _ = _pair(port_art, ref_art, titles[:64])

    def series(name):
        return [m for m in REGISTRY.snapshot()["metrics"] if m["name"] == name]

    before = sum(m["value"] for m in series("repro_service_requests_total"))
    with StoreService(port) as svc:
        svc.multiget([1, 2, 3])
    after = sum(m["value"] for m in series("repro_service_requests_total"))
    assert after - before == 3
    (hist,) = series("repro_service_request_latency_us")
    assert hist["type"] == "histogram" and sum(hist["counts"]) >= 3


# ----------------------------------------------------- reads + appends mixed
def test_service_interleaved_reads_and_appends(titles, port_art, ref_art):
    base = titles[:400]
    port, want = _mutable_pair(port_art, ref_art, base)
    appended = titles[400:600]
    errs: list = []

    with StoreService(port, max_batch=64, max_wait_s=0.002) as svc:
        def writer():
            try:
                futs = [svc.submit_append(s) for s in appended]
                with _stacks_on_timeout():
                    ids = [f.result(30) for f in futs]
                # appends fold into ordered extend() batches: ids come back
                # contiguous from 400
                assert ids == list(range(400, 600))
            except Exception as e:
                errs.append(e)

        def reader(seed):
            try:
                rng = np.random.default_rng(seed)
                last_n = 0
                for _ in range(150):
                    n = port.n_strings
                    assert n >= last_n            # monotonic growth
                    last_n = n
                    i = int(rng.integers(0, 400))  # stable prefix
                    with _stacks_on_timeout():
                        got = svc.get(i, timeout=30)
                    assert got == base[i]
            except Exception as e:
                errs.append(e)

        _run_threads([(writer, ())] + [(reader, (s,)) for s in range(3)])
        assert not errs, errs[0]
        st = svc.stats()
        assert st["appends"] == 200
        assert 1 <= st["append_batches"] <= st["appends"]
    port.seal_barrier()
    # after the dust settles: every appended string is byte-identical, and
    # the payloads are the reference's for the same appends
    assert want.extend(appended) == list(range(400, 600))
    want.seal_barrier()
    assert port.n_strings == 600
    assert port.scan(0, 600) == want.scan(0, 600) == titles[:600]
    assert port.snapshot_corpus().payload.tobytes() == \
        want.snapshot_corpus().payload.tobytes()


def test_service_append_batches_equal_extend_calls(titles, port_art, ref_art):
    port, _ = _mutable_pair(port_art, ref_art, titles[:300])
    calls = []
    real = port.extend

    def counting(strings):
        calls.append(len(strings))
        return real(strings)

    port.extend = counting
    with StoreService(port, max_batch=32, max_wait_s=0.001) as svc, \
            _stacks_on_timeout():
        futs = [svc.submit_append(s) for s in titles[300:420]]
        futs.append(svc.submit_extend(titles[420:450]))
        got = [f.result(30) for f in futs]
    assert got[:-1] == list(range(300, 420)) and got[-1] == list(range(420, 450))
    st = svc.stats()
    assert st["append_batches"] == len(calls) and sum(calls) == st["appends"] == 150
    assert port.multiget(list(range(300, 450))) == titles[300:450]


def test_service_append_to_readonly_store_fails(titles, port_art, ref_art):
    port, want = _pair(port_art, ref_art, titles[:50])
    for store, cls in ((port, StoreService), (want, RefService)):
        with cls(store) as svc:
            with pytest.raises(TypeError):
                svc.submit_append(b"nope").result(5)


# -------------------------------------------------------- no busy wait, hooks
def test_service_idle_without_wakeups(titles, port_art, ref_art):
    port, _ = _pair(port_art, ref_art, titles[:64])
    with StoreService(port) as svc:
        time.sleep(0.3)
        assert svc.wakeups == 0, "idle service must not wake its worker"
        assert svc.batches == 0
        assert svc.get(5) == titles[5]
        assert svc.wakeups >= 1
        wakes = svc.wakeups
        time.sleep(0.2)
        assert svc.wakeups == wakes  # back to fully idle after traffic


def test_service_bulk_hooks(titles, port_art, ref_art):
    port, want = _pair(port_art, ref_art, titles[:128])
    for store, cls in ((port, StoreService), (want, RefService)):
        with cls(store) as svc:
            fut = svc.submit_multiget([5, 3, 5, 127])
            assert fut.result(30) == [titles[5], titles[3], titles[5], titles[127]]
            with pytest.raises(IndexError):
                svc.submit_multiget([0, 128]).result(30)
            with pytest.raises(TypeError):
                svc.submit_extend([b"x"]).result(30)  # read-only store
            # only the served batch counts: failed validations never enqueue
            assert svc.stats()["requests"] == 4


def test_service_close_during_inflight_batch_does_not_hang(titles, port_art,
                                                           ref_art):
    port, _ = _pair(port_art, ref_art, titles[:64])
    svc = StoreService(port, max_wait_s=0.2)  # wide window to land close() in
    orig = port.multiget

    def slow_multiget(ids):
        time.sleep(0.3)
        return orig(ids)

    port.multiget = slow_multiget
    fut = svc.submit(5)
    time.sleep(0.05)  # the worker is now inside the batch window or decode
    t0 = time.perf_counter()
    svc.close()
    assert time.perf_counter() - t0 < 3.0, "close() stalled on a lost sentinel"
    assert not svc._worker.is_alive()
    assert fut.result(1) == titles[5]
    late = svc.submit(6)                # after close: failed, never pending
    with pytest.raises(RuntimeError):
        late.result(1)


def test_collect_batch_ends_when_its_wait_runs_out_before_the_lock(
        titles, port_art, ref_art):
    """The worker's timed wait for more requests ends even when it runs out
    before the queue's lock is first taken. A fresh queue (lock free,
    nothing queued) under a wait of microseconds is that case: on CPython
    3.12 ``queue.SimpleQueue.get(timeout=t)`` then blocks forever, and the
    requests of the batch being collected wait with it."""
    port, _ = _pair(port_art, ref_art, titles[:64])
    svc = StoreService(port, max_wait_s=2e-5)
    svc.close()  # the worker is joined: _collect_batch runs on this thread
    sizes: list[int] = []

    def collect():
        for _ in range(COLLECTS):
            svc._q = type(svc._q)()
            sizes.append(len(svc._collect_batch(("get", 0, Future(), 0.0, None))))

    _run_threads([(collect, ())])
    assert sizes == [1] * COLLECTS


def test_service_failed_batch_fails_its_futures_and_keeps_serving(
        titles, port_art, ref_art):
    port, _ = _pair(port_art, ref_art, titles[:64])
    with StoreService(port) as svc:
        real = port.multiget
        port.multiget = lambda ids: (_ for _ in ()).throw(OSError("boom"))
        with pytest.raises(OSError):
            svc.get(3, timeout=10)
        port.multiget = real
        assert svc.get(3, timeout=10) == titles[3]


# --------------------------------------------------- adaptive wait controller
def test_adaptive_controller_shrinks_window_when_p99_overshoots(titles,
                                                                port_art, ref_art):
    port, _ = _pair(port_art, ref_art, titles[:256])
    with StoreService(port, max_wait_s=0.004, target_p99_s=1e-9,
                      adapt_window=8) as svc:
        for i in range(24):
            assert svc.get(i % 256) == titles[i % 256]
        assert svc.max_wait_s < 0.004
        assert svc.wait_adjustments >= 1
        assert svc.stats()["target_p99_s"] == 1e-9


def test_adaptive_controller_grows_window_under_headroom(titles, port_art,
                                                         ref_art):
    port, _ = _pair(port_art, ref_art, titles[:256])
    with StoreService(port, max_wait_s=0.0, target_p99_s=10.0,
                      adapt_window=8, max_wait_cap_s=0.002) as svc:
        for i in range(64):
            svc.get(i % 256)
        assert 0.0 < svc.max_wait_s <= 0.002
        assert svc.wait_adjustments >= 1


def test_adaptive_controller_steps_equal_reference(titles, port_art, ref_art):
    """The same latency windows move both controllers to the same waits."""
    port, want = _pair(port_art, ref_art, titles[:16])
    rng = np.random.default_rng(9)
    windows = [rng.exponential(scale, 16).tolist()
               for scale in (1e-3, 1e-3, 1e-5, 1e-6, 1e-6, 1e-2, 1e-7, 1e-7)]
    with StoreService(port, max_wait_s=0.001, target_p99_s=1e-4, adapt_window=8,
                      max_wait_cap_s=0.004) as a, \
            RefService(want, max_wait_s=0.001, target_p99_s=1e-4, adapt_window=8,
                       max_wait_cap_s=0.004) as b:
        steps = []
        for lats in windows:
            a._adapt_wait(lats)
            b._adapt_wait(lats)
            steps.append(a.max_wait_s)
            assert (a.max_wait_s, a.wait_adjustments) == \
                (b.max_wait_s, b.wait_adjustments)
    assert len(set(steps)) > 2  # the windows moved the wait both ways


# --------------------------------------------------------------------- trace
def test_record_child_books_queue_hops():
    for cls in (Tracer, RefTracer):
        tr = cls()
        root, _ = tr.new_context(None, inherit=False)
        tr.record("root", root, 0, 0.0, 1.0)
        child = tr.record_child("queue.wait", root, 0.1, 0.2, batch=7)
        assert child.trace_id == root.trace_id
        (trace,) = tr.trace_dump()
        (qspan,) = [s for s in trace["spans"] if s["name"] == "queue.wait"]
        assert qspan["parent_id"] == root.span_id
        assert qspan["annotations"] == {"batch": 7}


def test_tracer_context_hops_match_reference():
    """activate/restore, new_context and span nest the same way in both
    tracers: the dumps agree in everything but the minted ids and times."""
    def drive(tr):
        assert tr.current() is None
        ctx, pid = tr.new_context()           # no ambient context: a root
        assert pid == 0
        prev = tr.activate(ctx)
        assert prev is None and tr.current() == ctx
        with tr.span("inner", batch=3) as ictx:
            assert ictx.trace_id == ctx.trace_id
            child, cpid = tr.new_context()    # child of the ambient span
            assert cpid == ictx.span_id and child.trace_id == ctx.trace_id
            orphan, opid = tr.new_context(inherit=False)
            assert opid == 0 and orphan.trace_id != ctx.trace_id
        tr.restore(prev)
        assert tr.current() is None
        tr.record("root", ctx, 0, 0.0, 0.5)
        tr.record_child("late", None, 0.0, 0.25)  # no parent: its own trace
        with tr.span("untraced"):               # no ambient context: no-op
            pass
        return [(t["root"], t["n_spans"], [(s["name"], s["parent_id"] == 0)
                                           for s in t["spans"]])
                for t in tr.trace_dump()]

    assert drive(Tracer()) == drive(RefTracer())
    assert len(new_trace_id()) == 16
    int(new_trace_id(), 16)


def test_trace_dump_slowest_first_and_ring_bounded():
    tr = Tracer(max_spans=8)
    for i in range(12):
        ctx, pid = tr.new_context(None, inherit=False)
        tr.record(f"r{i}", ctx, pid, 0.0, (i + 1) / 1000.0)
    dump = tr.trace_dump(4)
    assert [t["root"] for t in dump] == ["r11", "r10", "r9", "r8"]
    assert len(tr.trace_dump(100)) == 8
    tr.clear()
    assert tr.trace_dump() == []


def test_service_spans_chain_through_the_worker(titles, port_art, ref_art):
    """A traced request's coalesce wait and the fused multiget's decode
    span both land in the request's trace, though the worker thread ran
    them."""
    port, _ = _pair(port_art, ref_art, titles[:128], cache_bytes=0)
    TRACER.clear()
    with StoreService(port) as svc:
        with TRACER.span("client.multiget", root=True) as root:
            assert svc.submit_multiget([0, 1, 2, 5]).result(30) == \
                [titles[i] for i in (0, 1, 2, 5)]
    trace = next(t for t in trace_dump(8) if t["trace_id"] == root.trace_id)
    spans = {s["name"]: s for s in trace["spans"]}
    assert {"client.multiget", "service.coalesce", "store.decode",
            "kernel.decode_batch"} <= set(spans)
    assert spans["service.coalesce"]["parent_id"] == root.span_id
    assert spans["service.coalesce"]["annotations"]["batch"] >= 1
    assert spans["store.decode"]["parent_id"] == root.span_id
    assert spans["kernel.decode_batch"]["parent_id"] == spans["store.decode"]["span_id"]
    _assert_parentage(trace)
    assert TRACER.current() is None  # the worker restored its context
