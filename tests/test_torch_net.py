"""The wire on the port: ``repro_torch.net`` shard servers and router, held
against the JAX package's ``repro.net``.

Port servers run on ``device="cpu"`` (the kernels' plain versions) and the
reference's on its numpy backend, over sharded directories of the same
seeded titles. Covered: the framing (the cases of the reference's
``tests/test_net.py``), and its byte equality with the reference's for
every op, v1 and v2, every payload and every error, each package decoding
the other's frames; loopback routers against the in-process sharded
stores of both packages; a reference router over port servers, a port
router over reference servers and a mixed cluster, answer for answer;
order under concurrent fan-out, tail appends, max-frame refusals, scan
chunks, read-only servers, retries across a restarted server process,
the replica hand-off during a live compact; locate and scan_prefix over
the wire and their scan-side fallback against a server that predates them
(the cases of ``tests/test_locate.py``); and what is the port's own: the
server CLI refusing to start without CUDA unless given ``--device cpu``.

The reference's StoreService cases of ``tests/test_net.py`` are ported in
``tests/test_torch_service.py``. Spawned servers run ``python -m
repro_torch.net ... --device cpu`` (the restart case starts one shard
through ``python -m repro_torch.launch.serve --shard-server``, as the
reference's starts one through its launcher); their readiness line is read
with a deadline, and every child is killed and reaped in a ``finally``."""

import os
import queue
import re
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import repro.net as ref_net
from repro.core import registry
from repro.core.codec import Encoder as RefEncoder
from repro.data.synth import load_dataset as ref_load_dataset
from repro.distributed import ShardedStringStore as RefSharded
from repro.distributed import save_sharded as ref_save_sharded
from repro.net import protocol as RP
from repro.obs import TRACER as REF_TRACER
from repro.obs import TraceContext as RefTraceContext
from repro.store import CompressedStringStore as RefStore
from repro_torch.core import DictArtifact, Encoder
from repro_torch.data.synth import load_dataset
from repro_torch.distributed import ShardedStringStore, save_sharded
from repro_torch.net import (DistributedStringStore, FrameTooLargeError,
                             ProtocolError, RemoteError, RemoteShardClient,
                             ShardServer, TruncatedFrameError)
from repro_torch.net import protocol as P
from repro_torch.net.shard_server import open_serving_store
from repro_torch.obs import TRACER, TraceContext
from repro_torch.store import CompressedStringStore, MutableStringStore

SAMPLE = 1 << 18
SPS = 256
CPU = torch.device("cpu")
SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src")
# a child serves a few requests: one intra-op thread keeps it off the
# cores the rest of the suite runs on
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


@pytest.fixture(scope="module")
def dirs(titles, ref_art, tmp_path_factory):
    """(port-written, reference-written) sharded directories of ``titles``,
    three shards each, on the same artifact."""
    root = tmp_path_factory.mktemp("torch-net")
    pd, rd = str(root / "port"), str(root / "ref")
    want = RefStore(ref_art, RefEncoder(ref_art).encode(titles), backend="numpy",
                    strings_per_segment=SPS)
    assert save_sharded(_port_store(ref_art, titles), pd, 3) == \
        ref_save_sharded(want, rd, 3)
    return pd, rd


@pytest.fixture(scope="module")
def sharded_dir(dirs):
    return dirs[0]


@pytest.fixture(scope="module")
def ref_sharded(dirs):
    """The reference's in-process answers over its own directory."""
    return RefSharded.open(dirs[1], backend="numpy")


def _shard(d, k):
    return os.path.join(d, f"shard-{k:04d}")


def _port_servers(d, n=3, cls=ShardServer, **kw):
    return [cls.from_dir(_shard(d, k), device=CPU, **kw).start() for k in range(n)]


def _ref_servers(d, n=3, **kw):
    return [ref_net.ShardServer.from_dir(_shard(d, k), backend="numpy", **kw).start()
            for k in range(n)]


def _close(*things):
    for t in things:
        t.close()


@pytest.fixture()
def cluster(sharded_dir):
    servers = _port_servers(sharded_dir)
    dist = DistributedStringStore.connect([s.address for s in servers],
                                          dir_path=sharded_dir)
    yield dist, servers
    _close(dist, *servers)


def _stop(proc) -> str:
    """Kill and reap a child; its stderr."""
    if proc.poll() is None:
        proc.kill()
    _, err = proc.communicate(timeout=30)
    return err


def _spawn_server(args, env=None, via_launcher=False):
    """Start ``python -m repro_torch.net ... --device cpu`` (or, with
    ``via_launcher``, ``python -m repro_torch.launch.serve --shard-server
    ...``); returns (proc, (host, port)) once its readiness line came,
    within READY_S."""
    entry = (["repro_torch.launch.serve", "--shard-server"] if via_launcher
             else ["repro_torch.net"])
    proc = subprocess.Popen([sys.executable, "-m", *entry, *args,
                             "--device", "cpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env or CHILD_ENV)
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


# ------------------------------------------------------------------- protocol
def test_frame_roundtrip_all_ops():
    for kind in list(P.OP_NAMES) + [P.ST_OK, P.ST_ERR]:
        payload = os.urandom(kind)  # varied sizes, including empty
        buf = P.encode_frame(kind, payload)
        got_kind, got_payload, used = P.decode_frame(buf + b"trailing")
        assert (got_kind, got_payload, used) == (kind, payload, len(buf))


def test_frame_rejects_bad_magic_and_version():
    frame = bytearray(P.encode_frame(P.OP_PING, b"x"))
    frame[0] = ord("X")
    with pytest.raises(ProtocolError):
        P.decode_frame(bytes(frame))
    frame = bytearray(P.encode_frame(P.OP_PING, b"x"))
    frame[2] = 99  # version byte
    with pytest.raises(ProtocolError):
        P.decode_frame(bytes(frame))


def test_oversized_frame_refused_from_header_alone():
    frame = P.encode_frame(P.OP_EXTEND, b"a" * 1024)
    with pytest.raises(FrameTooLargeError):
        P.decode_frame(frame, max_frame=512)
    # the declared length alone triggers refusal: payload bytes not needed
    with pytest.raises(FrameTooLargeError):
        P.decode_header(frame[: P.HEADER_BYTES], max_frame=512)


def test_truncated_frame_detected_at_every_cut():
    frame = P.encode_frame(P.OP_MULTIGET, P.pack_ids([1, 2, 3]))
    for cut in range(len(frame)):
        with pytest.raises(TruncatedFrameError):
            P.decode_frame(frame[:cut])


def test_truncated_frame_over_socket():
    a, b = socket.socketpair()
    frame = P.encode_frame(P.OP_PING, b"payload")
    a.sendall(frame[: len(frame) - 3])
    a.close()
    with pytest.raises(TruncatedFrameError):
        P.recv_frame(b)
    b.close()
    # clean EOF at a frame boundary is None, not an error
    a, b = socket.socketpair()
    a.sendall(frame)
    a.close()
    assert P.recv_frame(b) == (P.OP_PING, b"payload")
    assert P.recv_frame(b) is None
    b.close()


def test_payload_helpers_roundtrip():
    ids = [0, 1, 2**40, 7]
    assert P.unpack_ids(P.pack_ids(ids)) == ids
    assert P.unpack_ids(b"") == []
    items = [b"", b"a", b"\x00\xff" * 100, b"", b"tail"]
    assert P.unpack_bytes_list(P.pack_bytes_list(items)) == items
    assert P.unpack_bytes_list(P.pack_bytes_list([])) == []
    with pytest.raises(ProtocolError):
        P.unpack_ids(b"odd")
    with pytest.raises(ProtocolError):
        P.unpack_bytes_list(b"\x01")


def test_remote_error_mapping():
    with pytest.raises(IndexError, match="out of range"):
        P.raise_remote(P.pack_error(IndexError("id 9 out of range")))
    with pytest.raises(RemoteError, match="OSError"):
        P.raise_remote(P.pack_error(OSError("disk on fire")))


# --------------------------------------------- byte parity with the reference
def test_wire_constants_equal_reference():
    for name in ("MAGIC", "VERSION", "TRACED_VERSION", "HEADER_BYTES",
                 "TRACE_CTX_BYTES", "CAPS_PROBE", "SERVER_CAPS",
                 "DEFAULT_MAX_FRAME", "OP_NAMES", "ST_OK", "ST_ERR"):
        assert getattr(P, name) == getattr(RP, name), name
    ops = {n: v for n, v in vars(P).items() if n.startswith("OP_") and
           isinstance(v, int)}
    assert ops == {n: v for n, v in vars(RP).items() if n.startswith("OP_") and
                   isinstance(v, int)}


@pytest.mark.parametrize("traced", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("kind", sorted(P.OP_NAMES) + [P.ST_OK, P.ST_ERR],
                         ids=lambda k: P.OP_NAMES.get(k, hex(k)))
def test_frames_equal_reference_both_ways(kind, traced):
    payload = np.random.default_rng(kind).integers(
        0, 256, 3 * kind, dtype=np.uint8).tobytes()
    tid, span = "0123456789abcdef", 2**63 + 5 * kind
    port = P.encode_frame(kind, payload,
                          trace=TraceContext(tid, span) if traced else None)
    ref = RP.encode_frame(kind, payload,
                          trace=RefTraceContext(tid, span) if traced else None)
    assert port == ref
    want_trace = (tid, span) if traced else None
    for decode in (P.decode_frame_ex, RP.decode_frame_ex):
        for frame in (port, ref):
            k, got, trace, used = decode(frame + b"next")
            assert (k, got, used) == (kind, payload, len(frame))
            assert (tuple(trace) if trace else None) == want_trace


def test_payloads_equal_reference_both_ways():
    ids = [0, 5, 2**40, 7, 2**62]
    items = [b"", b"a", b"\x00\xff" * 100, b"", bytes(range(256))]
    cases = [
        (P.pack_ids(ids), RP.pack_ids(ids), "unpack_ids", ids),
        (P.pack_bytes_list(items), RP.pack_bytes_list(items), "unpack_bytes_list",
         items),
        (P.pack_prefix_hits([(3, b"ab"), (9, b"")]),
         RP.pack_prefix_hits([(3, b"ab"), (9, b"")]), "unpack_prefix_hits",
         [(3, b"ab"), (9, b"")]),
        (P.pack_json(P.SERVER_CAPS), RP.pack_json(RP.SERVER_CAPS), "unpack_json",
         P.SERVER_CAPS),
    ]
    for q in ((b"The ", 100, None), (b"\xff\x00", None, (b"\xff\x00x", 12)),
              (b"", 0, None)):
        cases.append((P.pack_prefix_query(*q), RP.pack_prefix_query(*q),
                      "unpack_prefix_query", q))
    for port, ref, unpack, want in cases:
        assert port == ref, unpack
        assert getattr(P, unpack)(ref) == want
        assert getattr(RP, unpack)(port) == want


@pytest.mark.parametrize("make", [
    lambda m: IndexError(m), lambda m: KeyError(m), lambda m: TypeError(m),
    lambda m: ValueError(m), lambda m: RuntimeError(m), lambda m: OSError(m),
    lambda m: ZeroDivisionError(m), lambda m: torch.cuda.OutOfMemoryError(m),
    lambda m: "FrameTooLargeError"],
    ids=["IndexError", "KeyError", "TypeError", "ValueError", "RuntimeError",
         "OSError", "ZeroDivisionError", "torch.OutOfMemoryError",
         "FrameTooLargeError"])
def test_error_payloads_equal_reference_both_ways(make):
    msg = "id 9 out of range é"
    exc = make(msg)
    if exc == "FrameTooLargeError":
        port_exc, ref_exc = FrameTooLargeError(msg), RP.FrameTooLargeError(msg)
    else:
        port_exc = ref_exc = exc
    assert P.pack_error(port_exc) == RP.pack_error(ref_exc)
    raised = []
    for pkg in (P, RP):
        with pytest.raises(Exception) as info:
            pkg.raise_remote(P.pack_error(port_exc))
        raised.append((type(info.value).__name__, str(info.value)))
        assert type(info.value) is pkg._NATIVE_ERRORS.get(
            type(port_exc).__name__, pkg.RemoteError)
    assert raised[0] == raised[1]
    # a torch error stays a RemoteError (or a builtin) on the client
    assert raised[0][0] in ("RemoteError", type(port_exc).__name__)


# --------------------------------------------------------- loopback equality
def test_router_matches_local_sharded_store(cluster, sharded_dir, titles,
                                            ref_sharded):
    dist, _ = cluster
    local = ShardedStringStore.open(sharded_dir, device=CPU)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, len(titles), 800).tolist()
    assert dist.multiget(ids) == local.multiget(ids) == ref_sharded.multiget(ids)
    assert dist.get(3) == titles[3] == local.get(3)
    lo, hi = len(titles) // 3 - 50, len(titles) // 3 + 50  # straddles shards
    assert dist.scan(lo, hi) == local.scan(lo, hi) == titles[lo:hi]
    assert dist.n_strings == local.n_strings == len(titles)
    snap = dist.stats_snapshot()
    assert snap["n_shards"] == 3
    assert snap["bounds"] == [list(b) for b in local.bounds] == \
        [list(b) for b in ref_sharded.bounds]
    assert all(s["service"]["requests"] >= 0 for s in snap["shards"])
    with pytest.raises(IndexError):
        dist.get(len(titles))
    with pytest.raises(IndexError):
        dist.multiget([0, len(titles)])


def test_order_preserved_under_concurrent_fanout(cluster, titles):
    dist, _ = cluster
    errs = []

    def client(seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(10):
                ids = rng.integers(0, len(titles), 200).tolist()
                assert dist.multiget(ids) == [titles[i] for i in ids]
        except Exception as exc:  # pragma: no cover - failure path
            errs.append(exc)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a client thread hung"
    assert not errs, errs[0]


def test_op_counters_exact_under_concurrent_connections(sharded_dir, titles):
    """More client threads than cores, each on its own connection, with a
    shortened switch interval: every request counts once per op, and the
    service answers every id."""
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 12
    server = ShardServer.from_dir(_shard(sharded_dir, 0), device=CPU).start()
    clients = [RemoteShardClient(server.address) for _ in range(n_threads)]
    errs = []

    def work(client, seed):
        try:
            rng = np.random.default_rng(seed)
            for _ in range(per_thread):
                ids = rng.integers(0, 500, 8).tolist()
                assert client.multiget(ids) == [titles[i] for i in ids]
                assert client.ping(b"x") == b"x"
        except Exception as exc:  # pragma: no cover - failure path
            errs.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(c, k))
                   for k, c in enumerate(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads), "a client thread hung"
        assert not errs, errs[0]
        total = n_threads * per_thread
        assert server.op_counts == {"multiget": total, "ping": total}
        assert server.service.stats()["requests"] == 8 * total
    finally:
        _close(*clients, server)


def test_router_appends_route_to_tail_shard(cluster, titles):
    dist, servers = cluster
    n0 = dist.n_strings
    new = [b"net-append-%d" % i for i in range(300)]
    ids = dist.extend(new[:200])
    ids += [dist.append(s) for s in new[200:210]]
    futs = [dist.extend(new[210 + 3 * k : 213 + 3 * k]) for k in range(30)]
    ids += [i for chunk in futs for i in chunk]
    assert ids == list(range(n0, n0 + 300))
    assert dist.multiget(ids) == new
    assert dist.scan(n0 - 5, n0 + 300) == dist.multiget(range(n0 - 5, n0 + 300))
    # every append landed on the tail shard's server, none elsewhere
    assert servers[-1].store.n_strings == dist.bounds[-1][1] - dist.bounds[-1][0]
    assert servers[0].store.n_strings == dist.bounds[0][1]
    assert isinstance(servers[-1].store, MutableStringStore)


def test_oversized_request_surfaces_instead_of_retrying(sharded_dir, titles):
    with ShardServer.from_dir(_shard(sharded_dir, 0), device=CPU,
                              max_frame=4096).start() as server:
        client = RemoteShardClient(server.address)
        assert client.get(0) == titles[0]
        with pytest.raises(FrameTooLargeError, match="max_frame"):
            client.extend([b"x" * 16384])
        assert client.reconnects == 0  # refused once, not resent 17 times
        assert client.get(1) == titles[1]  # the client reconnects cleanly
        client.close()


def test_distributed_scan_chunks_below_max_frame(cluster, titles):
    dist, _ = cluster
    dist.scan_chunk = 64  # many small RPCs across shard boundaries
    lo, hi = 100, 1200
    assert dist.scan(lo, hi) == titles[lo:hi]


def test_server_refuses_writes_when_read_only(sharded_dir):
    with ShardServer.from_dir(_shard(sharded_dir, 0), device=CPU,
                              read_only=True).start() as server:
        client = RemoteShardClient(server.address)
        assert client.get(0) == client.multiget([0])[0]
        with pytest.raises(TypeError):
            client.append(b"nope")
        with pytest.raises(TypeError):
            client.compact()
        assert client.stats()["writable"] is False
        client.close()


def test_stats_rpc_carries_the_reference_keys(sharded_dir):
    port, ref = _port_servers(sharded_dir, 1)[0], _ref_servers(sharded_dir, 1)[0]
    pc, rc = RemoteShardClient(port.address), RemoteShardClient(ref.address)
    try:
        pc.multiget([0, 1])
        rc.multiget([0, 1])
        got, want = pc.stats(), rc.stats()
        assert set(got) == set(want) == {"n_strings", "writable", "ops", "store",
                                         "service"}
        assert set(got["service"]) == set(want["service"])
        assert set(got["store"]) >= set(want["store"]) - {"backend"}
        assert got["ops"] == want["ops"] == {"multiget": 1, "stats": 1}
        assert (got["n_strings"], got["writable"]) == (want["n_strings"], True)
        assert got["store"]["backend"] == "cpu"
    finally:
        _close(pc, rc, port, ref)


def test_tier_and_save_ops_over_the_wire(titles, ref_art, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded(_port_store(ref_art, titles[:1500]), d, 2)
    servers = _port_servers(d, 2)
    dist = DistributedStringStore.connect([s.address for s in servers], dir_path=d)
    try:
        assert all(c.supports_tier for c in dist.clients)
        assert dist.tier_stats()[0] == {"enabled": False}
        (rep,) = dist.demote(shard=0, segment=1, promote_above=1e9,
                             workdir=str(tmp_path / "tier"))
        assert rep["demoted"] == [1]
        assert dist.multiget(range(200, 600)) == titles[200:600]
        ids = dist.extend([b"saved-%d" % i for i in range(40)])
        assert [r["n_strings"] for r in dist.save()] == \
            [hi - lo for lo, hi in dist.bounds]
        reopened = ShardedStringStore.open(d, device=CPU)
        assert reopened.multiget(ids) == [b"saved-%d" % i for i in range(40)]
        assert reopened.n_strings == dist.n_strings
    finally:
        _close(dist, *servers)


# ------------------------------------------------------- across the packages
def test_reference_router_reads_port_servers(sharded_dir, titles, ref_sharded):
    servers = _port_servers(sharded_dir)
    dist = ref_net.DistributedStringStore.connect([s.address for s in servers],
                                                  dir_path=sharded_dir)
    try:
        ids = np.random.default_rng(1).integers(0, len(titles), 900).tolist()
        assert dist.multiget(ids) == ref_sharded.multiget(ids) == \
            [titles[i] for i in ids]
        assert dist.get(7) == titles[7]
        assert dist.scan(0, len(titles)) == titles
        probe = [titles[0], titles[900], titles[-1], b"@@absent@@", titles[3]]
        assert dist.locate_batch(probe) == ref_sharded.locate_batch(probe)
        page = dist.scan_prefix(b"The ", limit=7)
        assert page == ref_sharded.scan_prefix(b"The ", limit=7)
        g, s = page[-1]
        assert dist.scan_prefix(b"The ", limit=7, after=(s, g)) == \
            ref_sharded.scan_prefix(b"The ", limit=7, after=(s, g))
        new = dist.extend([b"from-ref-%d" % i for i in range(25)])
        assert new == list(range(len(titles), len(titles) + 25))
        assert dist.multiget(new) == [b"from-ref-%d" % i for i in range(25)]
        with pytest.raises(IndexError):
            dist.get(len(titles) + 25)
        assert [s.op_counts.get("multiget", 0) > 0 for s in servers] == [True] * 3
    finally:
        _close(dist, *servers)


def test_port_router_reads_reference_servers(sharded_dir, titles, ref_sharded):
    servers = _ref_servers(sharded_dir)
    dist = DistributedStringStore.connect([s.address for s in servers],
                                          dir_path=sharded_dir)
    try:
        ids = np.random.default_rng(2).integers(0, len(titles), 900).tolist()
        assert dist.multiget(ids) == ref_sharded.multiget(ids)
        assert dist.scan(0, len(titles)) == titles
        probe = [titles[5], titles[1500], b"@@absent@@", titles[-2]]
        assert dist.locate_batch(probe) == ref_sharded.locate_batch(probe)
        assert dist.scan_prefix(b"A", limit=None) == \
            ref_sharded.scan_prefix(b"A", limit=None)
        new = dist.extend([b"from-port-%d" % i for i in range(25)])
        assert dist.multiget(new) == [b"from-port-%d" % i for i in range(25)]
        assert [set(s) for s in dist.stats_snapshot()["shards"]] == \
            [{"n_strings", "writable", "ops", "store", "service"}] * 3
    finally:
        _close(dist, *servers)


def test_mixed_cluster_serves_both_routers(sharded_dir, titles, ref_sharded):
    """Shards 0 and 2 on port servers, shard 1 on a reference server; a
    traced reference multiget books the port servers' spans under its
    trace id."""
    port0, port2 = (ShardServer.from_dir(_shard(sharded_dir, k), device=CPU).start()
                    for k in (0, 2))
    ref1 = ref_net.ShardServer.from_dir(_shard(sharded_dir, 1),
                                        backend="numpy").start()
    addrs = [port0.address, ref1.address, port2.address]
    routers = [DistributedStringStore.connect(addrs, dir_path=sharded_dir),
               ref_net.DistributedStringStore.connect(addrs, dir_path=sharded_dir)]
    try:
        ids = np.random.default_rng(3).integers(0, len(titles), 600).tolist()
        want = ref_sharded.multiget(ids)
        for dist in routers:
            assert dist.multiget(ids) == want
            assert dist.scan(0, len(titles)) == titles
            assert dist.locate_batch(titles[::997]) == \
                ref_sharded.locate_batch(titles[::997])
        TRACER.clear()
        ctx, _ = REF_TRACER.new_context(None, inherit=False)
        prev = REF_TRACER.activate(ctx)
        fresh = list(range(1, len(titles), 5))  # not all in the stores' caches
        try:
            assert routers[1].multiget(fresh) == ref_sharded.multiget(fresh)
        finally:
            REF_TRACER.restore(prev)
        names = {s["name"] for t in TRACER.trace_dump(64) if t["trace_id"] ==
                 ctx.trace_id for s in t["spans"]}
        assert {"server.multiget", "service.coalesce", "store.decode"} <= names
    finally:
        _close(*routers, port0, ref1, port2)


# ------------------------------------------------------------- the port's own
def test_open_serving_store_takes_the_device(sharded_dir, titles, tmp_path):
    st = open_serving_store(_shard(sharded_dir, 0), device="cpu")
    assert isinstance(st, MutableStringStore) and st.backend == "cpu"
    ro = open_serving_store(_shard(sharded_dir, 0), read_only=True, device="cpu")
    assert not isinstance(ro, MutableStringStore)
    assert ro.multiget([0, 1, 2]) == titles[:3]
    flat = str(tmp_path / "flat")
    ro.save(flat)
    assert open_serving_store(flat, device="cpu").multiget([5]) == [titles[5]]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            open_serving_store(_shard(sharded_dir, 0))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ShardServer.from_dir(flat)


def test_host_codec_store_serves_on_the_host(tmp_path):
    strings = load_dataset("book_titles", 1 << 15)
    d = str(tmp_path / "bpe")
    CompressedStringStore.build(strings, codec="bpe", sample_bytes=1 << 14).save(d)
    with ShardServer.from_dir(d, device=CPU).start() as server:
        client = RemoteShardClient(server.address)
        assert client.multiget([0, 9, 4]) == [strings[0], strings[9], strings[4]]
        assert client.stats()["store"]["backend"] == "numpy"
        client.close()


def test_cli_refuses_without_cuda_unless_device_cpu(sharded_dir):
    env = {**CHILD_ENV, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.net",
                           _shard(sharded_dir, 0), "--port", "0"],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "SHARD_SERVER_READY" not in proc.stdout
    child, addr = _spawn_server([_shard(sharded_dir, 0), "--port", "0"], env=env)
    try:
        client = RemoteShardClient(addr)
        assert client.stats()["store"]["backend"] == "cpu"
        client.close()
    finally:
        _stop(child)


# ------------------------------------------------------- process lifecycles
def test_router_retries_across_server_restart(titles, ref_art, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded(_port_store(ref_art, titles[:2000]), d, 2)
    shard_dirs = [_shard(d, k) for k in range(2)]
    procs, addrs = [], []
    dist = None
    try:
        for k, sd in enumerate(shard_dirs):
            # shard 0 via the launcher (its --shard-server role), shard 1
            # via python -m repro_torch.net
            proc, addr = _spawn_server([sd], via_launcher=(k == 0))
            procs.append(proc)
            addrs.append(addr)
        dist = DistributedStringStore.connect(addrs, dir_path=d)
        assert dist.get(1) == titles[1]
        mid = dist.bounds[1][0] + 5
        assert dist.get(mid) == titles[mid]

        procs[1].terminate()
        procs[1].wait(timeout=30)
        with pytest.raises((ConnectionError, OSError)):
            # a fast-failing client, so the dead window is observed
            RemoteShardClient(addrs[1], reconnect_attempts=1).multiget([0])

        procs[1], _ = _spawn_server([shard_dirs[1], "--port", str(addrs[1][1])])
        assert dist.get(mid) == titles[mid]  # reconnects transparently
        assert dist.clients[1].reconnects >= 1
    finally:
        if dist is not None:
            dist.close()
        for proc in procs:
            _stop(proc)


def test_replica_failover_during_live_compact(titles, ref_art, tmp_path):
    d = str(tmp_path / "shards")
    save_sharded(_port_store(ref_art, titles[:1500]), d, 2)
    tail_dir = _shard(d, 1)
    servers = _port_servers(d, 2)
    dist = DistributedStringStore.connect([s.address for s in servers], dir_path=d)
    replica = None
    try:
        pre_ids = dist.extend([b"pre-compact-%d" % i for i in range(20)])
        dist.save()  # the replica opens the saved (current) generation

        replica = ShardServer.from_dir(tail_dir, device=CPU, read_only=True).start()
        with pytest.raises(ValueError):  # a writable "replica" is refused
            dist.register_replica(1, servers[1].address)
        dist.register_replica(1, replica.address)

        # stretch the compaction window so the hand-off is observable
        primary_store = servers[1].store
        orig_compact = primary_store.compact

        def slow_compact(**kw):
            time.sleep(0.6)
            return orig_compact(**kw)

        primary_store.compact = slow_compact
        reports = {}

        def run_compact():
            reports["compact"] = dist.compact(1)

        compacter = threading.Thread(target=run_compact)
        compacter.start()
        deadline = time.time() + 5
        while not dist._draining.get(1) and time.time() < deadline:
            time.sleep(0.01)
        assert dist._draining.get(1), "compact never entered hand-off"

        # reads drain to the replica and never block on the rewrite
        t0 = time.time()
        assert dist.get(pre_ids[3]) == b"pre-compact-3"
        assert dist.multiget(pre_ids) == [b"pre-compact-%d" % i for i in range(20)]
        assert time.time() - t0 < 0.5
        replica_client, replica_n = dist._replicas[1][0]
        assert replica_client.n_strings >= pre_ids[-1] - dist.bounds[1][0]
        assert replica_n == replica_client.n_strings

        # appends park in the retry queue and are acknowledged after the swap
        mid_id = dist.append(b"appended-during-compact")
        compacter.join(timeout=30)
        assert not compacter.is_alive()
        assert reports["compact"][0]["n_strings"] > 0
        assert mid_id == pre_ids[-1] + 1
        assert dist.get(mid_id) == b"appended-during-compact"

        # durable: persisted and visible to a fresh in-process open, and to
        # the reference's
        dist.save()
        local = ShardedStringStore.open(d, device=CPU)
        assert local.get(mid_id) == b"appended-during-compact"
        assert local.get(pre_ids[0]) == b"pre-compact-0"
        assert RefSharded.open(d, backend="numpy").get(mid_id) == \
            b"appended-during-compact"
    finally:
        dist.close()
        _close(*servers)
        if replica is not None:
            replica.close()


# ------------------------------------------------- locate over the wire
@pytest.fixture(scope="module")
def loc_titles():
    strings = load_dataset("book_titles", 1 << 16)[:1200]
    strings[3] = b""
    strings[7] = b"\x00\xff" * 9
    strings[11] = strings[5]  # a duplicate: locate must return id 5
    return strings


@pytest.fixture(scope="module")
def loc_stores(loc_titles, tmp_path_factory):
    """(port flat store, reference flat store, port sharded dir), segments of
    128 so queries cross many segment boundaries."""
    art = registry.train("onpair16", loc_titles, sample_bytes=1 << 16)
    store = _port_store(art, loc_titles, sps=128)
    want = RefStore(art, RefEncoder(art).encode(loc_titles), backend="numpy",
                    strings_per_segment=128)
    d = str(tmp_path_factory.mktemp("torch-locate") / "shards")
    save_sharded(store, d, 3)
    return store, want, d


@pytest.fixture(scope="module")
def probe(loc_titles):
    return [loc_titles[0], loc_titles[11], loc_titles[500], loc_titles[1199],
            b"@@absent@@"]


def test_tcp_matches_in_process(loc_stores, probe):
    store, want, d = loc_stores
    servers = _port_servers(d)
    try:
        dist = DistributedStringStore.connect([s.address for s in servers],
                                              dir_path=d)
        try:
            assert all(c.supports_locate for c in dist.clients)
            assert dist.locate_batch(probe) == store.locate_batch(probe) == \
                want.locate_batch(probe)
            prefix = b"The "
            assert (dist.scan_prefix(prefix, limit=None)
                    == store.scan_prefix(prefix, limit=None)
                    == want.scan_prefix(prefix, limit=None))
            page1 = dist.scan_prefix(prefix, limit=4)
            assert page1 == store.scan_prefix(prefix, limit=4)
            g, s = page1[-1]
            assert (dist.scan_prefix(prefix, limit=4, after=(s, g))
                    == want.scan_prefix(prefix, limit=4, after=(s, g)))
        finally:
            dist.close()
    finally:
        _close(*servers)


class _PreLocateServer(ShardServer):
    """A server image predating OP_LOCATE: echoes the capability probe and
    rejects the new ops, like any old peer would."""

    def dispatch(self, kind, payload):
        if kind == P.OP_PING and payload == P.CAPS_PROBE:
            return payload
        if kind in (P.OP_LOCATE, P.OP_SCAN_PREFIX):
            raise P.ProtocolError(f"unknown op 0x{kind:02X}")
        return super().dispatch(kind, payload)


def test_old_server_capability_fallback(loc_stores, probe):
    store, want, d = loc_stores
    servers = _port_servers(d, cls=_PreLocateServer)
    try:
        dist = DistributedStringStore.connect([s.address for s in servers],
                                              dir_path=d)
        try:
            assert not any(c.supports_locate for c in dist.clients)
            # scan-side fallback: identical answers, no new ops on the wire
            assert dist.locate_batch(probe) == want.locate_batch(probe)
            prefix = b"The "
            assert (dist.scan_prefix(prefix, limit=6)
                    == store.scan_prefix(prefix, limit=6)
                    == want.scan_prefix(prefix, limit=6))
            assert not any(s.op_counts.get("locate") for s in servers)
            assert all(s.op_counts.get("scan") for s in servers)
        finally:
            dist.close()
    finally:
        _close(*servers)
