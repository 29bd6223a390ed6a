"""Observability on the port — the metrics registry, the exposition over
HTTP, the scrape side and trace propagation across the wire — held against
the JAX package's ``repro.obs``.

Covered: the cases of the reference's ``tests/test_obs.py`` (histogram
percentiles, merges and overflow, exact counters under threads, the
registry's identity merge and Prometheus invariants, span parentage, the
v2 trace header and version compatibility in both directions, span chains
of sharded and TCP multigets, the ``stats`` RPC's metrics extension, the
``trace_dump`` RPC and the HTTP endpoints); byte equality of the port's
Prometheus text and ``snapshot()`` with the reference's for the same
records, and of what each package's scraper reads back; and a spawned port
server's ``/metrics``, ``/traces`` and ``/healthz``.

The span-chain cases open their root span ``client.multiget`` through the
port's client, as the reference's do: ``connect("shard://...")`` and
``connect("tcp://...")`` of :mod:`repro_torch.client`. The reference's
``record_child`` and slow-request ring cases are ported in
``tests/test_torch_service.py``."""

import json
import math
import os
import queue
import re
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from bisect import bisect_left

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.data.synth import load_dataset as ref_load_dataset
from repro.obs import scrape as ref_scrape
from repro_torch import obs
from repro_torch.client import connect
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import save_sharded
from repro_torch.net import DistributedStringStore, RemoteShardClient, ShardServer
from repro_torch.net import protocol as P
from repro_torch.obs import (REGISTRY, TRACER, Counter, Histogram,
                             MetricsRegistry, TraceContext, Tracer,
                             diff_hist_states, fetch_metrics, fetch_traces,
                             find_series, hist_state_from_rows,
                             merge_hist_states, new_trace_id, parse_prometheus,
                             start_metrics_server, summarize_hist_state)
from repro_torch.store import CompressedStringStore

SAMPLE = 1 << 14
CPU = torch.device("cpu")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
READY_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def titles():
    strings = load_dataset("book_titles", SAMPLE)
    assert strings == ref_load_dataset("book_titles", SAMPLE)
    return strings


@pytest.fixture(scope="module")
def sharded_dir(titles, tmp_path_factory):
    store = CompressedStringStore.build(titles, sample_bytes=SAMPLE,
                                        strings_per_segment=256, device=CPU)
    d = str(tmp_path_factory.mktemp("torch-obs") / "shards")
    save_sharded(store, d, 2)
    return d


@pytest.fixture()
def server(sharded_dir):
    s = ShardServer.from_dir(os.path.join(sharded_dir, "shard-0000"),
                             device=CPU).start()
    yield s
    s.close()


@pytest.fixture()
def tcp_cluster(sharded_dir):
    servers = [ShardServer.from_dir(os.path.join(sharded_dir, f"shard-{k:04d}"),
                                    device=CPU).start() for k in range(2)]
    yield servers
    for s in servers:
        s.close()


def _bucket_interval(bounds, value):
    """The ``(lo, hi]`` histogram bucket a value falls in."""
    i = bisect_left(bounds, value)
    lo = bounds[i - 1] if i else 0.0
    hi = bounds[i] if i < len(bounds) else bounds[-1] * 2
    return lo, hi


def _assert_parentage(trace):
    """Every span is the root or a child of another span in the trace."""
    span_ids = {s["span_id"] for s in trace["spans"]}
    roots = [s for s in trace["spans"] if s["parent_id"] == 0]
    assert len(roots) == 1, f"expected one root span, got {roots}"
    for s in trace["spans"]:
        if s["parent_id"] != 0:
            assert s["parent_id"] in span_ids, f"orphaned span {s}"
        assert s["trace_id"] == trace["trace_id"]


# ------------------------------------------------------------------ histogram
def test_histogram_percentiles_within_one_bucket():
    h = Histogram("t_lat_us")
    values = [3.0, 5.0, 9.0, 17.0, 33.0, 100.0, 1000.0, 5000.0]
    for v in values:
        h.record(v)
    s = h.summary()
    assert s["count"] == len(values)
    assert s["mean_us"] == pytest.approx(sum(values) / len(values))
    for pct, key in ((50.0, "p50_us"), (99.0, "p99_us"), (99.9, "p999_us")):
        rank = max(1, math.ceil(len(values) * pct / 100.0))
        true = sorted(values)[rank - 1]
        lo, hi = _bucket_interval(h.bounds, true)
        assert lo < s[key] <= hi, f"{key}: {s[key]} not in ({lo}, {hi}]"
        assert h.percentile(pct) == s[key]


def test_histogram_overflow_bucket_and_count():
    h = Histogram("t_over_us")
    h.record(1e12)  # way past the last bound
    h.record(0.5)  # below the first bound
    assert h.count == 2
    state = h.state()
    assert state["counts"][-1] == 1  # overflow
    assert state["counts"][0] == 1  # first finite bucket
    assert len(state["counts"]) == len(state["bounds"]) + 1


def test_histogram_rejects_unsorted_bounds():
    with pytest.raises(ValueError):
        Histogram("bad", bounds=(2.0, 1.0))
    with pytest.raises(ValueError):
        Histogram("bad", bounds=(1.0, 1.0, 2.0))


def test_merged_percentiles_equal_pooled_within_one_bucket():
    rng = np.random.default_rng(42)
    a = rng.lognormal(mean=4.0, sigma=1.5, size=500)
    b = rng.lognormal(mean=6.0, sigma=1.0, size=300)
    ha, hb, pooled = Histogram("m"), Histogram("m"), Histogram("m")
    for v in a:
        ha.record(float(v))
    for v in b:
        hb.record(float(v))
    for v in np.concatenate([a, b]):
        pooled.record(float(v))
    merged = merge_hist_states([ha.state(), hb.state()])
    # the merge is exact: merged counts equal a histogram of pooled samples
    assert merged["counts"] == pooled.state()["counts"]
    assert merged["sum"] == pytest.approx(pooled.sum)
    ms, ps = summarize_hist_state(merged), pooled.summary()
    for k in ("p50_us", "p99_us", "p999_us", "count", "mean_us"):
        assert ms[k] == pytest.approx(ps[k]), k
    samples = np.sort(np.concatenate([a, b]))
    true_p99 = float(samples[math.ceil(0.99 * len(samples)) - 1])
    lo, hi = _bucket_interval(merged["bounds"], true_p99)
    assert lo < ms["p99_us"] <= hi
    # merge_state / from_state fold the same states into the same counts
    folded = Histogram.from_state(ha.state(), "m")
    folded.merge_state(hb.state())
    assert folded.state()["counts"] == merged["counts"]


def test_merge_rejects_mismatched_bounds():
    a = Histogram("a", bounds=(1.0, 2.0)).state()
    b = Histogram("b", bounds=(1.0, 4.0)).state()
    with pytest.raises(ValueError):
        merge_hist_states([a, b])
    with pytest.raises(ValueError):
        Histogram("a", bounds=(1.0, 2.0)).merge_state(b)


def test_merge_and_summary_of_nothing():
    assert merge_hist_states([]) is None
    assert merge_hist_states([None, {}]) is None
    empty = summarize_hist_state(None)
    assert empty == {"p50_us": 0.0, "p99_us": 0.0, "p999_us": 0.0,
                     "count": 0, "mean_us": 0.0}


def test_counter_exact_under_concurrency():
    c = Counter("c_total")
    n_threads, per_thread = 8, 10_000

    def work():
        for _ in range(per_thread):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert c.value == n_threads * per_thread


# ------------------------------------------------------------------- registry
def test_registry_merges_same_identity_instruments():
    reg = MetricsRegistry()
    h1 = reg.register(Histogram("repro_x_lat_us", labels={"backend": "numpy"}))
    h2 = reg.register(Histogram("repro_x_lat_us", labels={"backend": "numpy"}))
    other = reg.register(Histogram("repro_x_lat_us", labels={"backend": "cuda"}))
    c = reg.counter("repro_x_total", backend="numpy")
    for v in (10.0, 20.0):
        h1.record(v)
        c.inc()
    h2.record(40.0)
    c.inc()
    other.record(7.0)
    series = {(m["name"], tuple(sorted(m["labels"].items()))): m
              for m in reg.snapshot()["metrics"]}
    merged = series[("repro_x_lat_us", (("backend", "numpy"),))]
    assert sum(merged["counts"]) == 3
    assert merged["sum"] == pytest.approx(70.0)
    # label isolation: the cuda series did not leak into the numpy merge
    assert series[("repro_x_lat_us", (("backend", "cuda"),))]["sum"] == 7.0
    assert series[("repro_x_total", (("backend", "numpy"),))]["value"] == 3


def test_registry_shared_series_and_kind_conflict():
    reg = MetricsRegistry()
    a = reg.counter("repro_shared_total", op="get")
    b = reg.counter("repro_shared_total", op="get")
    assert a is b  # same (name, labels) -> same object
    with pytest.raises(TypeError):
        reg.gauge("repro_shared_total", op="get")
    reg.unregister(a)
    reg.unregister(a)  # a second removal is a no-op
    assert reg.snapshot() == {"metrics": []}


def test_prometheus_bucket_counts_sum_to_op_counter():
    reg = MetricsRegistry()
    h = reg.register(Histogram("repro_y_lat_us", labels={"backend": "numpy"}))
    c = reg.counter("repro_y_requests_total", backend="numpy")
    for v in (1.5, 3.0, 1e9):  # includes one overflow sample
        h.record(v)
        c.inc()
    text = reg.render_prometheus()
    assert "# TYPE repro_y_lat_us histogram" in text
    assert "# TYPE repro_y_requests_total counter" in text
    counter = re.search(r'repro_y_requests_total\{backend="numpy"\} (\d+)', text)
    inf = re.search(r'repro_y_lat_us_bucket\{backend="numpy",le="\+Inf"\} (\d+)', text)
    count = re.search(r'repro_y_lat_us_count\{backend="numpy"\} (\d+)', text)
    assert counter and inf and count
    # the acceptance invariant: bucket counts sum to the op counter
    assert int(inf.group(1)) == int(count.group(1)) == int(counter.group(1)) == 3
    cums = [int(m.group(1))
            for m in re.finditer(r'repro_y_lat_us_bucket\{[^}]*\} (\d+)', text)]
    assert cums == sorted(cums)


# -------------------------------------------- byte parity with the reference
def _drive(pkg, scenario: int):
    """The same sequence of instruments and records on ``pkg``'s registry
    (``repro_torch.obs`` or ``repro.obs``); returns the registry."""
    reg = pkg.MetricsRegistry()
    rng = np.random.default_rng(scenario)
    hists = [reg.register(pkg.Histogram("repro_a_lat_us",
                                        labels={"backend": "numpy"}))
             for _ in range(1 + scenario % 3)]
    odd = reg.register(pkg.Histogram("repro_b_bytes", labels={"q": 'a"b\\c\nd'},
                                     bounds=(0.5, 2.0, 1e3)))
    c = reg.counter("repro_rpc_requests_total", op="multiget")
    c2 = reg.register(pkg.Counter("repro_rpc_requests_total",
                                  labels={"op": "multiget"}))
    g = reg.gauge("repro_store_tier_bytes", tier="hot")
    plain = reg.counter("repro_plain_total")
    for v in rng.lognormal(4.0, 2.0, 50 + 40 * scenario):
        hists[int(v) % len(hists)].record(float(v))
        odd.record(float(v) / 7.0)
        c.inc()
    c2.inc(3)
    plain.inc(2 * scenario)
    g.set(12345.0 + scenario)
    g.add(0.25 * scenario)
    reg.histogram("repro_empty_us", tier="cold")
    if scenario:
        reg.unregister(hists[0])
    return reg


@pytest.mark.parametrize("scenario", range(4))
def test_prometheus_text_and_snapshot_equal_reference(scenario):
    port, ref = _drive(obs, scenario), _drive(ref_obs, scenario)
    assert port.render_prometheus() == ref.render_prometheus()
    assert obs.render_prometheus(port) == ref_obs.render_prometheus(ref)
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())


@pytest.mark.parametrize("scenario", range(4))
def test_scraped_states_equal_reference(scenario):
    text = _drive(obs, scenario).render_prometheus()
    rows = parse_prometheus(text)
    assert rows == ref_scrape.parse_prometheus(text)
    snap = {(m["name"], tuple(sorted(m["labels"].items()))): m
            for m in _drive(obs, scenario).snapshot()["metrics"]}
    for (name, labels), m in snap.items():
        if m["type"] == "histogram":
            got = hist_state_from_rows(rows, name, dict(labels))
            assert got == {k: m[k] for k in ("bounds", "counts", "sum")}
            assert got == ref_scrape.hist_state_from_rows(rows, name, dict(labels))
        else:
            (row,) = find_series(rows, name, dict(labels))
            assert row["value"] == m["value"]


def test_hist_state_helpers_equal_reference():
    rng = np.random.default_rng(7)
    before, after = Histogram("d"), Histogram("d")
    for v in rng.lognormal(3.0, 2.0, 300):
        after.record(float(v))
        if v < 40:
            before.record(float(v))
    for a, b in ((after.state(), before.state()), (after.state(), None),
                 (None, before.state()), (before.state(), after.state())):
        assert diff_hist_states(a, b) == ref_obs.diff_hist_states(a, b)
    states = [before.state(), None, after.state()]
    assert merge_hist_states(states) == ref_obs.merge_hist_states(states)
    for p in (0.0, 50.0, 99.0, 99.9, 100.0):
        assert after.percentile(p) == \
            ref_obs.Histogram.from_state(after.state()).percentile(p)


def test_obs_exports_the_reference_names():
    assert set(obs.__all__) == set(ref_obs.__all__)
    assert obs.get_registry() is REGISTRY


# --------------------------------------------------------------------- tracer
def test_span_is_noop_without_ambient_context():
    tr = Tracer()
    with tr.span("x") as ctx:
        assert ctx is None
        assert tr.current() is None
    assert tr.trace_dump() == []


def test_nested_spans_chain_parentage():
    tr = Tracer()
    with tr.span("outer", root=True) as octx:
        assert tr.current() == octx
        with tr.span("inner", batch=3) as ictx:
            assert ictx.trace_id == octx.trace_id
        assert tr.current() == octx  # inner restored the ambient context
    assert tr.current() is None
    (trace,) = tr.trace_dump()
    spans = {s["name"]: s for s in trace["spans"]}
    assert trace["root"] == "outer"
    assert spans["outer"]["parent_id"] == 0
    assert spans["inner"]["parent_id"] == spans["outer"]["span_id"]
    assert spans["inner"]["annotations"] == {"batch": 3}
    _assert_parentage(trace)


# ------------------------------------------------------------------- protocol
def test_trace_ctx_pack_roundtrip():
    ctx = TraceContext(new_trace_id(), 1234567890123)
    assert P.unpack_trace(P.pack_trace(ctx)) == ctx


def test_frame_trace_header_roundtrip_and_v1_compat():
    ctx = TraceContext(new_trace_id(), 42)
    payload = b"hello"
    traced = P.encode_frame(P.OP_MULTIGET, payload, trace=ctx)
    kind, got, trace, used = P.decode_frame_ex(traced + b"trailing")
    assert (kind, got, trace, used) == (P.OP_MULTIGET, payload, ctx, len(traced))
    # a plain v1 frame carries no trace
    plain = P.encode_frame(P.OP_MULTIGET, payload)
    kind, got, trace, used = P.decode_frame_ex(plain)
    assert (kind, got, trace, used) == (P.OP_MULTIGET, payload, None, len(plain))
    # the trace-agnostic decoder sees the same payload with the trace stripped
    kind, got, used = P.decode_frame(traced)
    assert (kind, got, used) == (P.OP_MULTIGET, payload, len(traced))


def test_trace_header_over_socket():
    ctx = TraceContext(new_trace_id(), 99)
    a, b = socket.socketpair()
    try:
        P.send_frame(a, P.OP_PING, b"x", trace=ctx)
        P.send_frame(a, P.OP_PING, b"y")
        assert P.recv_frame_ex(b) == (P.OP_PING, b"x", ctx)
        P.send_frame(a, P.OP_PING, b"z", trace=ctx)
        assert P.recv_frame(b) == (P.OP_PING, b"y")
        assert P.recv_frame(b) == (P.OP_PING, b"z")
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------------- compat
def test_old_client_v1_frames_against_new_server(server):
    """A client that predates the trace header speaks plain v1 frames: ping
    still echoes (non-probe payloads), multiget still answers."""
    sock = socket.create_connection(server.address, timeout=5)
    try:
        P.send_frame(sock, P.OP_PING, b"legacy")
        assert P.recv_frame(sock) == (P.ST_OK, b"legacy")
        P.send_frame(sock, P.OP_MULTIGET, P.pack_ids([0, 1]))
        status, resp = P.recv_frame(sock)
        assert status == P.ST_OK
        assert len(P.unpack_bytes_list(resp)) == 2
    finally:
        sock.close()


def test_new_client_probes_and_falls_back_to_v1():
    """Against a server that echoes the caps probe (an old server), a traced
    client keeps every wire frame at v1, with no trace header."""
    listener = socket.create_server(("127.0.0.1", 0))
    received = []

    def legacy_server():
        conn, _ = listener.accept()
        with conn:
            while True:
                got = P.recv_frame_ex(conn)
                if got is None:
                    return
                kind, payload, trace = got
                received.append((kind, payload, trace))
                if kind == P.OP_PING:
                    P.send_frame(conn, P.ST_OK, payload)  # verbatim echo
                else:
                    P.send_frame(conn, P.ST_OK, P.pack_bytes_list([b"a", b"b"]))

    t = threading.Thread(target=legacy_server, daemon=True)
    t.start()
    client = RemoteShardClient(listener.getsockname(), pool_size=1,
                               reconnect_attempts=0)
    prev = TRACER.activate(TraceContext(new_trace_id(), 1))
    try:
        out = client.multiget([0, 1])
    finally:
        TRACER.restore(prev)
        client.close()
        listener.close()
    t.join(10)
    assert out == [b"a", b"b"]
    assert client._traced is False
    assert received[0][:2] == (P.OP_PING, P.CAPS_PROBE)
    assert all(trace is None for _, _, trace in received)


def test_caps_probe_against_new_server(server):
    client = RemoteShardClient(server.address)
    try:
        assert client.ping(b"abc") == b"abc"  # normal pings still echo
        assert client._probe_caps() is True
        assert client._traced is True
        assert client.supports_locate and client.supports_tier
    finally:
        client.close()


# ----------------------------------------------------------------- end-to-end
def test_trace_spans_local_shard_multiget(sharded_dir):
    TRACER.clear()
    client = connect(f"shard://{sharded_dir}", device=CPU)
    try:
        assert len(client.multiget([0, 1, 2, 5])) == 4
    finally:
        client.close()
    trace = next(t for t in TRACER.trace_dump(8) if t["root"] == "client.multiget")
    names = {s["name"] for s in trace["spans"]}
    assert {"client.multiget", "store.decode"} <= names
    _assert_parentage(trace)


def test_tcp_multiget_trace_has_full_span_chain(tcp_cluster):
    TRACER.clear()
    url = "tcp://" + ",".join(f"{h}:{p}" for h, p in (s.address for s in tcp_cluster))
    client = connect(url)
    try:
        assert len(client.multiget([0, 1, 2, 3])) == 4
    finally:
        client.close()
    trace = next(t for t in TRACER.trace_dump(8) if t["root"] == "client.multiget")
    names = {s["name"] for s in trace["spans"]}
    # the chain: client -> socket -> server -> coalesce -> decode
    assert {"client.multiget", "rpc.multiget", "server.multiget",
            "service.coalesce", "store.decode"} <= names
    assert trace["n_spans"] >= 4
    _assert_parentage(trace)
    decode = next(s for s in trace["spans"] if s["name"] == "store.decode")
    assert decode["annotations"]["backend"] == "cpu"
    assert decode["annotations"]["batch"] >= 1
    coalesce = next(s for s in trace["spans"] if s["name"] == "service.coalesce")
    assert coalesce["annotations"]["batch"] >= 1


def test_stats_metrics_extension_and_trace_dump_rpc(tcp_cluster):
    TRACER.clear()
    client = RemoteShardClient(tcp_cluster[0].address)
    try:
        plain = client.stats()
        assert "metrics" not in plain  # the extension is opt-in
        ctx, _ = TRACER.new_context(None, inherit=False)
        prev = TRACER.activate(ctx)
        try:
            client.multiget([0, 1])
        finally:
            TRACER.restore(prev)
        stats = client.stats(metrics=True)
        names = {m["name"] for m in stats["metrics"]["metrics"]}
        assert "repro_rpc_requests_total" in names
        assert "repro_store_multiget_latency_us" in names
        assert "repro_service_request_latency_us" in names
        dump = client.trace_dump(16)
        trace = next(t for t in dump if t["trace_id"] == ctx.trace_id)
        names = {s["name"] for s in trace["spans"]}
        assert {"server.multiget", "service.coalesce", "store.decode"} <= names
    finally:
        client.close()


# ----------------------------------------------------------------------- http
def test_metrics_http_server_endpoints():
    reg = MetricsRegistry()
    tr = Tracer()
    h = reg.register(Histogram("repro_z_lat_us", labels={"backend": "numpy"}))
    c = reg.counter("repro_z_requests_total")
    for v in (2.0, 8.0, 40.0):
        h.record(v)
        c.inc()
    with tr.span("req", root=True):
        pass
    srv = start_metrics_server(port=0, registry=reg, tracer=tr)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        count = re.search(r'repro_z_lat_us_count\{backend="numpy"\} (\d+)', text)
        inf = re.search(r'repro_z_lat_us_bucket\{backend="numpy",le="\+Inf"\} (\d+)',
                        text)
        assert count and int(count.group(1)) == 3
        assert inf and int(inf.group(1)) == 3
        assert re.search(r"repro_z_requests_total 3\b", text)
        assert text == reg.render_prometheus()
        traces = json.loads(urllib.request.urlopen(base + "/traces?n=4").read())
        assert traces and traces[0]["root"] == "req"
        assert ref_scrape.fetch_traces("127.0.0.1", srv.port, 4) == traces
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(base + "/nope")
        assert info.value.code == 404
    finally:
        srv.close()


def test_spawned_server_metrics_traces_and_healthz(sharded_dir, titles):
    """``python -m repro_torch.net --metrics-port 0`` on the CPU: the
    request counter equals the calls sent, the latency histogram's buckets
    sum to its count, and every endpoint parses."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.net",
         os.path.join(sharded_dir, "shard-0000"), "--port", "0",
         "--metrics-port", "0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC_DIR, "OMP_NUM_THREADS": "1"})
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                         daemon=True).start()
        line = lines.get(timeout=READY_S)
        m = re.search(r"SHARD_SERVER_READY port=(\d+) n_strings=(\d+) "
                      r"writable=1 metrics_port=(\d+) dir=", line)
        assert m, line
        port, n, mport = (int(g) for g in m.groups())
        dist = DistributedStringStore.connect([("127.0.0.1", port)])
        try:
            calls = [list(range(lo, min(lo + 100, n))) for lo in range(0, n, 100)]
            for ids in calls:
                assert dist.multiget(ids) == titles[ids[0] : ids[-1] + 1]
        finally:
            dist.close()
        text = fetch_metrics("127.0.0.1", mport)
        rows = parse_prometheus(text)
        assert rows == ref_scrape.parse_prometheus(text)
        (req,) = find_series(rows, "repro_rpc_requests_total", {"op": "multiget"})
        assert req["value"] == len(calls)
        lat = hist_state_from_rows(rows, "repro_service_request_latency_us")
        count = re.search(r"^repro_service_request_latency_us_count (\d+)$", text,
                          re.M)
        assert sum(lat["counts"]) == int(count.group(1)) == len(calls)
        assert isinstance(fetch_traces("127.0.0.1", mport, 4), list)
        with urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz") as resp:
            assert resp.read() == b"ok\n"
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)
