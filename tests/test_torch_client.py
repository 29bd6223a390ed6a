"""The client on the port: ``repro_torch.client`` held against the JAX
package's ``repro.client``.

Port stores and servers run on ``device="cpu"`` (the kernels' plain
versions), the reference's on its numpy backend, over directories of the
same seeded titles written by each package with one artifact. Every case
of the reference's ``tests/test_client.py`` runs on the port's frontends
and compares its answers with the reference client's over the reference's
stores, byte for byte: URL parsing (one table of URLs, bad ones included,
through both parsers), byte identity over ``file://``, ``mut://``,
``shard://`` and ``tcp://``, the stats key sets frontend by frontend, the
async path (cancelled and timed-out futures, ``scan_iter``'s
``IndexError``), read preferences, replica reads during a live compact,
the adaptive window through ``connect``, reconnects across a restarted
``python -m repro_torch.net ... --device cpu`` child, ``wrap``, and
``mut://`` appends saved where the reference opens them. Also the client
cases of ``tests/test_locate.py`` and ``tests/test_encode_path.py``
(``_ExtendBatcher`` fusion, async appends group-committed over tcp), the
port's client over reference servers, and what is the port's own: without
a card a directory scheme raises unless given ``device="cpu"``, and
``device=`` on ``tcp://`` is refused before any socket opens."""

import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np
import pytest
import torch

import repro.client as ref_client
import repro.net as ref_net
from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.distributed import save_sharded as ref_save_sharded
from repro.store import CompressedStringStore as RefStore
from repro.store import MutableStringStore as RefMutable
from repro_torch.client import (StoreClient, connect, format_tcp_url,
                                parse_url, wrap)
from repro_torch.client.session import _ExtendBatcher
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import save_sharded
from repro_torch.net import DistributedStringStore, ShardServer
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 18
SPS = 256
CPU = torch.device("cpu")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
CHILD_ENV = {**os.environ, "PYTHONPATH": SRC_DIR, "OMP_NUM_THREADS": "1"}
READY_S = 60.0  # a spawned server prints its readiness line within this
JOIN_S = 60.0


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


def _port_store(ref_art, strings, sps=SPS) -> CompressedStringStore:
    art = DictArtifact.from_bytes(ref_art.to_bytes())
    return CompressedStringStore(art, Encoder(art, device=CPU).encode(strings),
                                 device=CPU, strings_per_segment=sps)


def _ref_store(ref_art, strings, sps=SPS) -> RefStore:
    return RefStore(ref_art, RefEncoder(ref_art).encode(strings), backend="numpy",
                    strings_per_segment=sps)


def _write_dirs(store, mutable_cls, base: str, **open_kw) -> dict:
    """One corpus persisted three ways: a flat store dir, a versioned
    writable dir and a 3-shard sharded dir."""
    flat = os.path.join(base, "flat")
    store.save(flat)
    mut = os.path.join(base, "mut")
    mutable_cls.open(flat, **open_kw).save(mut)
    sharded = os.path.join(base, "shards")
    save_sharded_fn = save_sharded if mutable_cls is MutableStringStore \
        else ref_save_sharded
    save_sharded_fn(store, sharded, 3)
    return {"flat": flat, "mut": mut, "sharded": sharded}


@pytest.fixture(scope="module")
def corpus_dirs(titles, ref_art, tmp_path_factory):
    """The port's directories behind file:// mut:// shard:// (and, served,
    tcp://)."""
    base = str(tmp_path_factory.mktemp("torch-client"))
    return _write_dirs(_port_store(ref_art, titles), MutableStringStore, base,
                       device=CPU)


@pytest.fixture(scope="module")
def ref_dirs(titles, ref_art, tmp_path_factory):
    """The reference's directories of the same corpus on the same artifact."""
    base = str(tmp_path_factory.mktemp("ref-client"))
    return _write_dirs(_ref_store(ref_art, titles), RefMutable, base,
                       backend="numpy")


def _shard(d, k):
    return os.path.join(d, f"shard-{k:04d}")


def _port_servers(d, n=3, **kw):
    return [ShardServer.from_dir(_shard(d, k), device=CPU, **kw).start()
            for k in range(n)]


def _ref_servers(d, n=3, **kw):
    return [ref_net.ShardServer.from_dir(_shard(d, k), backend="numpy", **kw).start()
            for k in range(n)]


@pytest.fixture(scope="module")
def cluster(corpus_dirs):
    """In-thread port shard servers over the sharded dir + a tcp:// client."""
    servers = _port_servers(corpus_dirs["sharded"])
    client = connect(format_tcp_url([s.address for s in servers]),
                     dir_path=corpus_dirs["sharded"])
    yield client, servers
    client.close()
    for s in servers:
        s.close()


@pytest.fixture(scope="module")
def ref_cluster(ref_dirs):
    """The reference's servers over its sharded dir + its tcp:// client."""
    servers = _ref_servers(ref_dirs["sharded"])
    client = ref_client.connect(format_tcp_url([s.address for s in servers]),
                                dir_path=ref_dirs["sharded"])
    yield client, servers
    client.close()
    for s in servers:
        s.close()


def _port_connect(scheme, dirs, **kw):
    key = {"file": "flat", "mut": "mut", "shard": "sharded"}[scheme]
    return connect(f"{scheme}://{dirs[key]}", device=CPU, **kw)


def _ref_connect(scheme, dirs, **kw):
    key = {"file": "flat", "mut": "mut", "shard": "sharded"}[scheme]
    return ref_client.connect(f"{scheme}://{dirs[key]}", backend="numpy", **kw)


def _stop(proc) -> str:
    """Kill and reap a child; its stderr."""
    if proc.poll() is None:
        proc.kill()
    _, err = proc.communicate(timeout=30)
    return err


def _spawn_server(args):
    """Start ``python -m repro_torch.net ... --device cpu``; returns (proc,
    (host, port)) once its readiness line came, within READY_S."""
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.net", *args,
                             "--device", "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=CHILD_ENV)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: lines.put(proc.stdout.readline()),
                     daemon=True).start()
    try:
        line = lines.get(timeout=READY_S)
    except queue.Empty:
        line = ""
    m = re.search(r"SHARD_SERVER_READY port=(\d+)", line)
    if not m:
        err = _stop(proc)
        raise AssertionError(f"server not ready within {READY_S} s: {line!r}\n{err}")
    return proc, ("127.0.0.1", int(m.group(1)))


# ------------------------------------------------------------------- parsing
URLS = [
    "file:///data/store",
    "file://rel/dir",
    "mut://rel/dir?mmap=false",
    "shard:///srv/shards?writable=true",
    "file:///data/store?device=cpu",
    "file:///a%20b/c",
    "tcp://h0:9100,h1:9101?read_preference=replica&timeout=5",
    "tcp://:9100",
    "tcp://h0:9100,,h1:9101",
    "tcp://[::1]:9100",
    "tcp://h:9100?timeout=0.5&x=yes&y=off&z=1e3",
    "bogus://x",
    "file:/nope",
    "tcp://",
    "tcp://justahost",
    "tcp://h:port",
    "file://",
    "mut://?mmap=false",
    "shard://",
    "",
]


def _parse(parse, url):
    try:
        u = parse(url)
    except Exception as exc:  # compared by type and message
        return ("raises", type(exc).__name__, str(exc))
    return (u.scheme, u.path, u.addresses, u.options)


@pytest.mark.parametrize("url", URLS)
def test_parse_url_equals_reference(url):
    assert _parse(parse_url, url) == _parse(ref_client.parse_url, url)


def test_parse_url_schemes():
    u = parse_url("file:///data/store")
    assert (u.scheme, u.path) == ("file", "/data/store")
    u = parse_url("mut://rel/dir?mmap=false")
    assert (u.scheme, u.path, u.options) == ("mut", "rel/dir", {"mmap": False})
    u = parse_url("tcp://h0:9100,h1:9101?read_preference=replica&timeout=5")
    assert u.addresses == [("h0", 9100), ("h1", 9101)]
    assert u.options == {"read_preference": "replica", "timeout": 5}
    assert parse_url("file:///s?device=cpu").options == {"device": "cpu"}
    with pytest.raises(ValueError, match="unsupported store url"):
        parse_url("bogus://x")
    with pytest.raises(ValueError, match="no host:port"):
        parse_url("tcp://")
    with pytest.raises(ValueError, match="host:port"):
        parse_url("tcp://justahost")
    with pytest.raises(ValueError, match="no directory"):
        parse_url("file://")


@pytest.mark.parametrize("addresses", [[("h0", 9100)],
                                       [("h0", 9100), ("10.0.0.2", 1)], []])
def test_format_tcp_url_equals_reference(addresses):
    url = format_tcp_url(addresses)
    assert url == ref_client.format_tcp_url(addresses)
    if addresses:
        assert parse_url(url).addresses == addresses


def test_connect_rejects_unknown_options(corpus_dirs, ref_dirs):
    # unrecognised options forward to the backend opener and fail loudly
    # there (TypeError), never silently vanish — in both packages
    with pytest.raises(TypeError, match="frobnicate"):
        connect(f"file://{corpus_dirs['flat']}", device=CPU, frobnicate=3)
    with pytest.raises(TypeError, match="frobnicate"):
        ref_client.connect(f"file://{ref_dirs['flat']}", frobnicate=3)
    # service knobs on a router URL are a loud TypeError too
    with pytest.raises(TypeError, match="target_p99_ms"):
        connect(f"shard://{corpus_dirs['sharded']}", device=CPU,
                target_p99_ms=2.0)
    with pytest.raises(TypeError, match="max_wait_s"):
        connect("tcp://127.0.0.1:1?max_wait_s=0.01")  # pre-connect check


# ----------------------------------------------------- the port's own device
@pytest.mark.parametrize("scheme", ["file", "mut", "shard"])
def test_directory_scheme_raises_without_a_card(corpus_dirs, monkeypatch, scheme):
    """No card and no device="cpu": the open raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    key = {"file": "flat", "mut": "mut", "shard": "sharded"}[scheme]
    url = f"{scheme}://{corpus_dirs[key]}"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        connect(url)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        connect(url + "?device=cuda")
    with connect(url + "?device=cpu") as client:  # the query string's device
        assert client.get(0) == client.backend.multiget([0])[0]


def test_device_on_tcp_refused_before_any_socket_opens():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(8)
    listener.settimeout(0.3)
    url = format_tcp_url([listener.getsockname()])
    try:
        for kw, query in (({"device": "cpu"}, ""), ({}, "?device=cpu"),
                          ({"device": "cuda"}, "")):
            with pytest.raises(TypeError, match="device="):
                connect(url + query, **kw)
        with pytest.raises(socket.timeout):
            listener.accept()  # nothing ever dialled in
    finally:
        listener.close()


# -------------------------------------------------- acceptance: byte identity
def test_byte_identity_across_backends(cluster, ref_cluster, corpus_dirs, ref_dirs,
                                       titles):
    """The same corpus served via file://, mut://, shard:// and tcp://
    returns identical bytes for get/multiget/scan — the titles, and the
    reference client's answers over the reference's stores."""
    tcp_client, _ = cluster
    ref_tcp, _ = ref_cluster
    rng = np.random.default_rng(0)
    ids = rng.integers(0, len(titles), 500).tolist() + [3, 7, len(titles) - 1]
    lo, hi = len(titles) // 3 - 40, len(titles) // 3 + 40  # shard straddle
    expect = [titles[i] for i in ids]
    port = {s: _port_connect(s, corpus_dirs) for s in ("file", "mut", "shard")}
    ref = {s: _ref_connect(s, ref_dirs) for s in ("file", "mut", "shard")}
    port["tcp"], ref["tcp"] = tcp_client, ref_tcp
    try:
        for scheme, client in port.items():
            want = ref[scheme]
            assert client.multiget(ids) == want.multiget(ids) == expect, scheme
            assert client.get(7) == want.get(7) == titles[7]
            assert client.scan(lo, hi) == want.scan(lo, hi) == titles[lo:hi]
            assert list(client.scan_iter(lo, hi, chunk=16)) == titles[lo:hi]
            assert len(client) == len(want) == len(titles)
            # read_preference is part of the frozen surface on every backend
            for pref in ("primary", "replica", "any"):
                assert client.multiget(ids[:5], read_preference=pref) == \
                    want.multiget(ids[:5], read_preference=pref) == expect[:5]
    finally:
        for scheme in ("file", "mut", "shard"):
            port[scheme].close()
            ref[scheme].close()


# --------------------------------------------------------- stats unification
#: the one key the port's store snapshot adds to the reference's (the
#: dictionary tables' bytes on the device; tests/test_torch_store.py)
PORT_STORE_KEYS = {"device_dict_bytes"}


def _key_tree(d, depth=3):
    """The nested key sets of a stats dict down to ``depth``, without the
    port's own store keys; lists of dicts (a router's shards) by item."""
    if isinstance(d, list) and d and all(isinstance(x, dict) for x in d):
        return [_key_tree(x, depth) for x in d]
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _key_tree(v, depth - 1) for k, v in d.items()
            if k not in PORT_STORE_KEYS}


def test_stats_schema_identical_across_all_four_frontends(
        cluster, ref_cluster, corpus_dirs, ref_dirs, titles):
    tcp_client, _ = cluster
    ref_tcp, _ = ref_cluster
    clients = {s: _port_connect(s, corpus_dirs) for s in ("file", "mut", "shard")}
    refs = {s: _ref_connect(s, ref_dirs) for s in ("file", "mut", "shard")}
    clients["tcp"], refs["tcp"] = tcp_client, ref_tcp
    try:
        key_sets = {}
        for name, client in clients.items():
            client.multiget([0, 1, 2])
            client.scan(0, 4)
            refs[name].multiget([0, 1, 2])
            refs[name].scan(0, 4)
            snap, want = client.stats(), refs[name].stats()
            key_sets[name] = frozenset(snap)
            # the port's key sets are the reference's, frontend by frontend:
            # the unified schema, the latency summaries and the backend's own
            # snapshot (the store's, its service's, the router's shards')
            assert _key_tree(snap, 6) == _key_tree(want, 6), name
            assert {"latency_summary", "throughput_mib_s", "wakeups",
                    "ops", "n_strings", "backend", "server_ops",
                    "store_latency"} <= key_sets[name]
            assert snap["n_strings"] == want["n_strings"] == len(titles)
            assert snap["ops"]["multiget"] >= 1
            assert snap["latency_summary"]["count"] >= 2
            assert snap["throughput_mib_s"] > 0
            assert set(snap["server_ops"]) == {"total", "per_shard"}
            assert snap["store_latency"]["count"] >= 1
        assert len(set(key_sets.values())) == 1, key_sets
        assert clients["file"].stats()["wakeups"] >= 1
        assert clients["tcp"].stats()["wakeups"] >= 1
        tcp_ops = tcp_client.stats()["server_ops"]
        assert tcp_ops["total"]["multiget"] >= 1
        assert len(tcp_ops["per_shard"]) >= 1
        assert sum(s["ops"].get("multiget", 0)
                   for s in tcp_ops["per_shard"]) == tcp_ops["total"]["multiget"]
        for name in ("file", "mut", "shard"):
            assert clients[name].stats()["server_ops"]["total"] == {}
    finally:
        for name in ("file", "mut", "shard"):
            clients[name].close()
            refs[name].close()


# ------------------------------------------------------- async path & errors
def test_async_pipelining_matches_sync(corpus_dirs, ref_dirs, titles):
    batches = [list(range(k, k + 50)) for k in range(0, 500, 50)]
    got = {}
    for name, client in (("port", _port_connect("file", corpus_dirs)),
                         ("ref", _ref_connect("file", ref_dirs))):
        with client:
            futs = [client.multiget_async(b) for b in batches]
            got[name] = [v for f in futs for v in f.result(30)]
            assert client.stats()["backend"]["service"]["requests"] == 500
    assert got["port"] == got["ref"] == [titles[i] for i in range(500)]


def test_async_failure_semantics(corpus_dirs, titles):
    with _port_connect("file", corpus_dirs) as client:
        with pytest.raises(IndexError):
            client.multiget_async([0, len(titles)]).result(30)
        with pytest.raises(IndexError):
            client.get_async(-1).result(30)
        # a read-only backend refuses writes through the same future path
        with pytest.raises(TypeError, match="read-only"):
            client.extend_async([b"x"]).result(30)
        with pytest.raises(TypeError, match="read-only"):
            client.append(b"x")
        with pytest.raises(TypeError, match="read-only"):
            client.compact()
    with pytest.raises(RuntimeError, match="closed"):
        client.multiget([0])


def test_cancelled_future_skipped_and_worker_survives(corpus_dirs, titles):
    with _port_connect("file", corpus_dirs) as client:
        store = client.backend
        orig = store.multiget
        started = threading.Event()

        def slow_multiget(ids):
            started.set()
            time.sleep(0.4)
            return orig(ids)

        store.multiget = slow_multiget
        try:
            first = client.multiget_async([0, 1])
            assert started.wait(5), "worker never picked up the first batch"
            victim = client.multiget_async([2, 3])  # queued behind the decode
            assert victim.cancel(), "pending future should be cancellable"
            assert victim.cancelled()
            assert first.result(10) == [titles[0], titles[1]]
        finally:
            store.multiget = orig
        # the worker skipped the cancelled item instead of crashing on it
        assert client.multiget([2, 3]) == [titles[2], titles[3]]


def test_timed_out_future_raises_and_service_completes(corpus_dirs, titles):
    with _port_connect("file", corpus_dirs) as client:
        store = client.backend
        orig = store.multiget
        store.multiget = lambda ids: (time.sleep(0.3), orig(ids))[1]
        try:
            fut = client.multiget_async([5])
            with pytest.raises(FuturesTimeout):
                fut.result(0.05)
            with pytest.raises(FuturesTimeout):
                client.multiget([6], timeout=0.05)
            # the work itself was not lost — the future still resolves
            assert fut.result(10) == [titles[5]]
        finally:
            store.multiget = orig


def test_scan_iter_propagates_index_error(cluster, ref_cluster, corpus_dirs,
                                          ref_dirs, titles):
    tcp_client, _ = cluster
    ref_tcp, _ = ref_cluster
    with _port_connect("file", corpus_dirs) as file_client, \
            _ref_connect("file", ref_dirs) as ref_file:
        for client in (file_client, tcp_client, ref_file, ref_tcp):
            it = client.scan_iter(0, len(titles) + 5, chunk=SPS)
            got = []
            with pytest.raises(IndexError):
                for s in it:
                    got.append(s)
            # the chunks before the offending one were yielded, in both
            assert got == titles[:len(got)]
            assert len(got) == len(titles) - len(titles) % SPS
            with pytest.raises(IndexError):
                list(client.scan_iter(0, len(titles) + 5, chunk=10**9))
            with pytest.raises(IndexError):
                client.scan_iter(5, 4)
            assert list(client.scan_iter(0, 0)) == []


def test_bad_read_preference_rejected_on_every_backend(cluster, corpus_dirs):
    tcp_client, _ = cluster
    with _port_connect("file", corpus_dirs) as file_client:
        for client in (file_client, tcp_client):
            with pytest.raises(ValueError, match="read_preference"):
                client.multiget([0], read_preference="replcia")
            with pytest.raises(ValueError, match="read_preference"):
                client.get_async(0, read_preference="nearest")
            with pytest.raises(ValueError, match="read_preference"):
                client.scan(0, 2, read_preference="replicas")
            with pytest.raises(ValueError, match="read_preference"):
                client.scan_iter(0, 2, read_preference="replicas")
    with pytest.raises(ValueError, match="read_preference"):
        _port_connect("file", corpus_dirs, read_preference="oops")


def test_tcp_connect_failure_closes_opened_sockets(cluster):
    """A bad constructor kwarg (or a dead shard) during tcp connect must
    close the shard connections it already opened, not leak them."""
    _, servers = cluster
    url = format_tcp_url([s.address for s in servers])
    import repro_torch.net.router as router_mod

    closed = []
    orig_close = router_mod.RemoteShardClient.close

    def tracking_close(self):
        closed.append(self.address)
        orig_close(self)

    router_mod.RemoteShardClient.close = tracking_close
    try:
        with pytest.raises(TypeError):
            connect(url, scan_chnk=8)  # typo reaches the ctor post-RPC
    finally:
        router_mod.RemoteShardClient.close = orig_close
    assert len(closed) == len(servers)


def test_router_per_call_timeout_routes_through_future(cluster, titles):
    tcp_client, _ = cluster
    assert tcp_client.multiget([1, 2], timeout=30.0) == titles[1:3]
    assert tcp_client.get(1, timeout=30.0) == titles[1]
    store = tcp_client.backend
    orig = store.multiget

    def slow_multiget(ids, **kw):
        time.sleep(0.3)
        return orig(ids, **kw)

    store.multiget = slow_multiget
    try:
        with pytest.raises(FuturesTimeout):
            tcp_client.multiget([1], timeout=0.02)
    finally:
        store.multiget = orig


def test_replica_preference_falls_back_to_primary(cluster, titles):
    tcp_client, servers = cluster
    before = [s.op_counts.get("multiget", 0) for s in servers]
    ids = [1, len(titles) // 2, len(titles) - 1]  # touches every shard
    assert tcp_client.multiget(ids, read_preference="replica") == \
        [titles[i] for i in ids]
    after = [s.op_counts.get("multiget", 0) for s in servers]
    assert all(a > b for a, b in zip(after, before))


# ----------------------------------- replica routing + compaction hand-off
def test_replica_reads_via_preference_and_during_live_compact(titles, ref_art,
                                                              tmp_path):
    d = str(tmp_path / "shards")
    save_sharded(_port_store(ref_art, titles[:1500]), d, 2)
    tail_dir = _shard(d, 1)
    servers = _port_servers(d, 2)
    client = connect(format_tcp_url([s.address for s in servers]), dir_path=d)
    replica = None
    try:
        pre_ids = client.extend([b"pre-%d" % i for i in range(20)])
        client.save()  # the replica opens the saved (current) generation
        replica = ShardServer.from_dir(tail_dir, read_only=True, device=CPU).start()
        client.register_replica(1, replica.address)

        before = replica.op_counts.get("multiget", 0)
        assert client.multiget(pre_ids[:4], read_preference="replica") == \
            [b"pre-%d" % i for i in range(4)]
        assert replica.op_counts.get("multiget", 0) > before
        p_before = servers[1].op_counts.get("multiget", 0)
        r_before = replica.op_counts.get("multiget", 0)
        for _ in range(4):
            client.get(pre_ids[0], read_preference="any")
        assert servers[1].op_counts.get("multiget", 0) > p_before
        assert replica.op_counts.get("multiget", 0) > r_before
        # staleness guard: an id appended after the replica opened is
        # answered by the primary even under read_preference="replica"
        fresh = client.append(b"past-the-replica-generation")
        r_before = replica.op_counts.get("multiget", 0)
        assert client.get(fresh, read_preference="replica") == \
            b"past-the-replica-generation"
        assert replica.op_counts.get("multiget", 0) == r_before

        # while a live compact() is in flight, the replica serves the reads
        primary_store = servers[1].store
        orig_compact = primary_store.compact

        def slow_compact(**kw):
            time.sleep(0.6)
            return orig_compact(**kw)

        primary_store.compact = slow_compact
        done = {}
        compacter = threading.Thread(
            target=lambda: done.update(report=client.compact(shard=1)))
        compacter.start()
        deadline = time.time() + 5
        while not client.backend._draining.get(1) and time.time() < deadline:
            time.sleep(0.01)
        assert client.backend._draining.get(1), "compact never drained"
        r_before = replica.op_counts.get("multiget", 0)
        t0 = time.time()
        assert client.multiget(pre_ids, read_preference="replica") == \
            [b"pre-%d" % i for i in range(20)]
        assert client.get(pre_ids[3]) == b"pre-3"  # default pref drains too
        assert time.time() - t0 < 0.5, "reads waited on the rewrite"
        assert replica.op_counts.get("multiget", 0) >= r_before + 2
        mid = client.append(b"parked-during-compact")
        compacter.join(timeout=JOIN_S)
        assert not compacter.is_alive()
        assert done["report"][0]["n_strings"] > 0
        assert client.get(mid) == b"parked-during-compact"
    finally:
        client.close()
        for s in servers:
            s.close()
        if replica is not None:
            replica.close()


# ----------------------------------------------------- kill/restart reconnect
def test_client_reconnects_across_server_restart(corpus_dirs, titles):
    proc, addr = _spawn_server([corpus_dirs["mut"]])
    client = None
    try:
        client = connect(f"tcp://{addr[0]}:{addr[1]}")
        assert client.get(1) == titles[1]
        proc.terminate()
        proc.wait(timeout=30)
        _stop(proc)
        proc, _ = _spawn_server([corpus_dirs["mut"], "--port", str(addr[1])])
        # the session re-finds the restarted process transparently
        assert client.multiget([1, 5]) == [titles[1], titles[5]]
        assert client.backend.clients[0].reconnects >= 1
    finally:
        if client is not None:
            client.close()
        _stop(proc)


# ------------------------------------------------- adaptive max_wait_s knob
def test_target_p99_surfaced_through_connect(corpus_dirs, ref_dirs):
    snaps = {}
    for name, client in (
            ("port", _port_connect("file", corpus_dirs, target_p99_ms=0.0001,
                                   max_wait_s=0.004, adapt_window=8)),
            ("ref", _ref_connect("file", ref_dirs, target_p99_ms=0.0001,
                                 max_wait_s=0.004, adapt_window=8))):
        with client:
            for i in range(24):
                client.get(i)
            snaps[name] = client.stats()
    for snap in snaps.values():
        assert snap["target_p99_s"] == pytest.approx(1e-7)
        assert snap["max_wait_s"] < 0.004
        assert snap["backend"]["service"]["wait_adjustments"] >= 1


def test_client_owned_service_drains_without_a_window(corpus_dirs):
    """connect() fronts a local store with max_wait_s=0 (drain what is
    queued), as the reference's does; every drained batch is one
    store.multiget."""
    with _port_connect("file", corpus_dirs) as client:
        calls = []
        orig = client.backend.multiget
        client.backend.multiget = lambda ids: (calls.append(len(ids)), orig(ids))[1]
        try:
            futs = [client.get_async(i) for i in range(64)]
            futs.append(client.multiget_async(list(range(100, 164))))
            [f.result(30) for f in futs]
        finally:
            client.backend.multiget = orig
        svc = client.stats()["backend"]["service"]
        assert svc["max_wait_s"] == 0.0
        assert len(calls) == svc["batches"] and sum(calls) == 128


# ------------------------------------------------------------------ wrapping
def test_wrap_existing_backends(titles, ref_art, tmp_path):
    store = _port_store(ref_art, titles[:512])
    with wrap(store) as client:
        assert isinstance(client, StoreClient)
        assert client.scheme == "file"
        assert client.multiget([0, 5]) == [titles[0], titles[5]]
    mut = MutableStringStore(store.artifact, store.corpus, device=CPU)
    with wrap(mut) as client:
        assert client.scheme == "mut"
        assert client.append(b"wrapped") == 512
    d = str(tmp_path / "shards")
    save_sharded(store, d, 2)
    servers = _port_servers(d, 2)
    try:
        dist = DistributedStringStore.connect([s.address for s in servers])
        with wrap(dist) as client:
            assert client.scheme == "tcp"
            assert client.multiget([0, 511]) == [titles[0], titles[511]]
        dist.close()
    finally:
        for s in servers:
            s.close()
    with pytest.raises(TypeError, match="cannot wrap"):
        wrap(object())


def test_mut_client_appends_and_saves(corpus_dirs, titles, tmp_path):
    d = str(tmp_path / "mut2")
    MutableStringStore.open(corpus_dirs["flat"], device=CPU).save(d)
    with connect(f"mut://{d}", device=CPU) as client:
        n0 = len(client)
        new_id = client.append(b"v3-append")
        ids = client.extend_async([b"v3-a", b"v3-b"]).result(30)
        assert [new_id, *ids] == [n0, n0 + 1, n0 + 2]
        assert client.multiget([new_id, *ids]) == [b"v3-append", b"v3-a", b"v3-b"]
        client.save()
    with connect(f"file://{d}", device=CPU) as reopened:  # durable, read-only
        assert reopened.get(new_id) == b"v3-append"
        assert len(reopened) == n0 + 3
    # the save is the reference's layout: its client opens it, both ways
    for scheme in ("file", "mut"):
        with ref_client.connect(f"{scheme}://{d}", backend="numpy") as ref:
            assert len(ref) == n0 + 3
            assert ref.multiget([1, new_id, *ids]) == \
                [titles[1], b"v3-append", b"v3-a", b"v3-b"]


# --------------------------------------------------- across the two packages
def test_port_client_over_reference_servers(ref_dirs, ref_cluster, titles):
    """The port's connect("tcp://...") over the reference's ShardServers
    returns the reference client's bytes."""
    ref_tcp, servers = ref_cluster
    rng = np.random.default_rng(5)
    ids = rng.integers(0, len(titles), 400).tolist()
    with connect(format_tcp_url([s.address for s in servers]),
                 dir_path=ref_dirs["sharded"]) as client:
        assert client.multiget(ids) == ref_tcp.multiget(ids) == \
            [titles[i] for i in ids]
        futs = [client.get_async(i) for i in ids[:64]]
        assert [f.result(30) for f in futs] == [titles[i] for i in ids[:64]]
        lo, hi = 100, len(titles) // 2 + 30
        assert list(client.scan_iter(lo, hi, chunk=97)) == ref_tcp.scan(lo, hi)
        assert client.locate_batch([titles[9], b"@@absent@@"]) == \
            ref_tcp.locate_batch([titles[9], b"@@absent@@"])
        assert client.scan_prefix(b"The ", limit=7) == \
            ref_tcp.scan_prefix(b"The ", limit=7)
        assert sorted(client.stats()) == sorted(ref_tcp.stats())


def test_reference_client_over_port_servers(cluster, ref_dirs, corpus_dirs,
                                            titles):
    """...and the reverse: the reference's client over port servers."""
    tcp_client, servers = cluster
    ids = np.random.default_rng(6).integers(0, len(titles), 400).tolist()
    with ref_client.connect(format_tcp_url([s.address for s in servers])) as ref:
        assert ref.multiget(ids) == tcp_client.multiget(ids) == \
            [titles[i] for i in ids]
        assert ref.scan(0, 300) == tcp_client.scan(0, 300) == titles[:300]


# -------------------------------------------------------------- client locate
LOC_SAMPLE = 1 << 16


@pytest.fixture(scope="module")
def loc_titles():
    strings = load_dataset("book_titles", LOC_SAMPLE)[:1200]
    strings[3] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = strings[5]  # a duplicate: locate must return id 5
    return strings


def test_client_locate_over_every_backend(loc_titles, tmp_path):
    """The client's locate surface over every backend (the reference's
    ``tests/test_locate.py`` client case) equals the reference client's."""
    titles = loc_titles
    art = registry.train("onpair16", titles, sample_bytes=LOC_SAMPLE)
    store = _port_store(art, titles, sps=128)
    ref_store = _ref_store(art, titles, sps=128)
    flat, rflat = str(tmp_path / "flat"), str(tmp_path / "rflat")
    sharded, rsharded = str(tmp_path / "shards"), str(tmp_path / "rshards")
    store.save(flat)
    ref_store.save(rflat)
    save_sharded(store, sharded, 3)
    ref_save_sharded(ref_store, rsharded, 3)
    first_index: dict[bytes, int] = {}
    for i, s in enumerate(titles):
        first_index.setdefault(s, i)
    probe = [titles[0], titles[11], titles[500], titles[1199], b"@@absent@@"]
    want = ref_store.locate_batch(probe)
    prefix_hits = ref_store.scan_prefix(b"The ", limit=9)
    assert want == [0, 5, first_index[titles[500]], first_index[titles[1199]], None]

    def check(client, ref):
        with client, ref:
            assert client.locate(titles[11]) == ref.locate(titles[11]) == 5
            assert client.locate(b"@@absent@@") is None
            assert client.locate_batch(probe) == ref.locate_batch(probe) == want
            assert client.locate_batch(probe, timeout=30.0) == want
            assert client.locate_async(titles[500]).result(30) == \
                ref.locate_async(titles[500]).result(30) == first_index[titles[500]]
            assert client.scan_prefix(b"The ", limit=9) == \
                ref.scan_prefix(b"The ", limit=9) == prefix_hits
            assert list(client.scan_prefix_iter(b"The ", chunk=4)) == \
                list(ref.scan_prefix_iter(b"The ", chunk=4))
            assert list(client.scan_prefix_iter(b"The ", chunk=4))[:9] == prefix_hits
            assert client.stats()["ops"].get("locate", 0) >= 3

    check(connect(f"file://{flat}", device=CPU),
          ref_client.connect(f"file://{rflat}", backend="numpy"))
    check(connect(f"shard://{sharded}", device=CPU),
          ref_client.connect(f"shard://{rsharded}", backend="numpy"))
    servers = _port_servers(sharded)
    rservers = _ref_servers(rsharded)
    try:
        dist = DistributedStringStore.connect([s.address for s in servers],
                                              dir_path=sharded)
        rdist = ref_net.DistributedStringStore.connect(
            [s.address for s in rservers], dir_path=rsharded)
        check(wrap(dist), ref_client.wrap(rdist))
        dist.close()
        rdist.close()
    finally:
        for srv in servers + rservers:
            srv.close()


# -------------------------------------------------- client-side group-commit
def test_extend_batcher_fuses_pending_writes():
    """Writes submitted while one RPC is in flight drain as ONE
    backend.extend; the id block splits back per caller."""
    gate = threading.Event()
    entered = threading.Event()

    class SlowBackend:
        def __init__(self):
            self.calls = []
            self.n = 0

        def extend(self, strings):
            self.calls.append(len(strings))
            if len(self.calls) == 1:
                entered.set()
                assert gate.wait(5.0)
            ids = list(range(self.n, self.n + len(strings)))
            self.n += len(strings)
            return ids

    backend = SlowBackend()
    pool = ThreadPoolExecutor(max_workers=1)
    batcher = _ExtendBatcher(backend, pool.submit)
    first = batcher.submit_extend([b"a"])
    assert entered.wait(5.0)  # first drain is on the wire, holding the gate
    pending = [batcher.submit_extend([b"b", b"c"]),
               batcher.submit_extend([b"d"])]
    gate.set()
    assert first.result(5.0) == [0]
    assert pending[0].result(5.0) == [1, 2]
    assert pending[1].result(5.0) == [3]
    pool.shutdown(wait=True)
    assert backend.calls == [1, 3]  # second drain fused both pending writes
    assert batcher.batches == 2 and batcher.coalesced == 2


def test_client_async_appends_group_commit(ref_art, titles, tmp_path):
    """Pipelined append_async/extend_async through a tcp:// client fold into
    bulk extends server-side (service append_batches < appends), and the
    payloads are the reference server's for the same appends."""
    art = DictArtifact.from_bytes(ref_art.to_bytes())
    src = str(tmp_path / "src")
    MutableStringStore(art, device=CPU).save(src)
    with ShardServer.from_dir(src, device=CPU) as server:
        server.start()
        with connect(f"tcp://127.0.0.1:{server.port}") as client:
            futs = [client.append_async(s) for s in titles[:48]]
            futs.append(client.extend_async(titles[48:64]))
            ids = [f.result(10.0) for f in futs]
            flat = ids[:48] + list(ids[48])
            assert sorted(flat) == list(range(64))
            assert client.multiget(flat) == titles[:64]
            assert client.stats()["extend_batches"] >= 1
            svc = server.service.stats()
            assert svc["appends"] == 64
            assert svc["append_batches"] <= 49
        # the same strings in the same id order, appended to the reference's
        # writable store, give the port's payloads byte for byte
        order = [s for _, s in sorted(zip(flat, titles[:64]))]
        server.store.seal_barrier()
        got = server.store.snapshot_corpus()
    want = RefMutable(ref_art)
    want.extend(order)
    want.seal_barrier()
    assert got.payload.tobytes() == want.snapshot_corpus().payload.tobytes()
