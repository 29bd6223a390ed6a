"""ShardServer — one process serving one shard directory over TCP.

A host owning ``<dir>/shard-000k`` opens it (the shared dictionary and its
corpus slice, writable by default) on the card and answers the
:mod:`repro_torch.net.protocol` ops. Every connection is a thread, but all
reads funnel through one shared
:class:`~repro_torch.store.service.StoreService`: concurrent connections'
``get``/``multiget`` requests coalesce into single store decodes (one
launch of the decode kernel), and their ``append``/``extend`` requests fold
into single ``extend`` calls (the encode kernel), so the micro-batching of
the in-process service survives the move to sockets. ``scan`` (the stream
kernel), ``locate``, ``scan_prefix`` and ``compact`` run in the
connection's own thread, under the store's lock.

Run one per shard::

    python -m repro_torch.net /data/corpus/shard-0002 --port 9102

It serves on the card unless ``--device cpu`` is given, and refuses to
start on a host without CUDA otherwise. With ``--port 0`` the kernel
assigns a free port and the server prints ``SHARD_SERVER_READY port=<p>
...`` on stdout; spawners parse that line. ``--read-only`` serves a
replica: the same directory's current versioned generation, appends and
compaction refused, the hand-off target a router drains reads to while the
primary rewrites itself. The frames, the answers and the metric names are
the reference's, so either package's router reads either package's server.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import socketserver
import threading

import torch

from repro_torch.core import registry
from repro_torch.device import resolve_device
from repro_torch.distributed.shard_store import MANIFEST, open_shard
from repro_torch.net import protocol as P
from repro_torch.obs import REGISTRY, TRACER, Counter, start_metrics_server
from repro_torch.store.mutable import MutableStringStore
from repro_torch.store.service import StoreService
from repro_torch.store.store import CompressedStringStore
from repro_torch.store.tier import tier_op

_SHARD_DIR_RE = re.compile(r"^shard-(\d{4})$")


def open_serving_store(path: str, read_only: bool = False,
                       device: str | torch.device = "cuda",
                       **overrides) -> CompressedStringStore:
    """Open ``path`` for serving on ``device`` (default the card; see
    :func:`repro_torch.device.resolve_device`, which raises without CUDA).

    ``<parent>/shard-000k`` directories open through
    :func:`repro_torch.distributed.shard_store.open_shard` (the shared
    dictionary in the parent); anything else opens as a plain store
    directory. Writable unless ``read_only``: a read-only open of a
    versioned shard serves its current generation, which is what a
    compaction replica needs. A store of a codec with no kernel (unbounded
    OnPair, BPE) serves on the host, as that codec always does.
    """
    dev = resolve_device(device)
    path = os.path.abspath(path)
    m = _SHARD_DIR_RE.match(os.path.basename(path))
    parent = os.path.dirname(path)
    shard_parent = parent if m and os.path.exists(
        os.path.join(parent, MANIFEST)) else None
    # store.json names the codec, in a plain, sharded or versioned layout
    meta = CompressedStringStore._read_meta(CompressedStringStore._resolve_current(path))
    if not registry.capabilities(meta["codec"]).device_decodable:
        dev = None
    if shard_parent is not None:
        return open_shard(shard_parent, int(m.group(1)), writable=not read_only,
                          device=dev, **overrides)
    store_cls = CompressedStringStore if read_only else MutableStringStore
    return store_cls.open(path, device=dev, **overrides)


class _Handler(socketserver.BaseRequestHandler):
    """One connection: read frames until EOF, answer each in order.

    Concurrency comes from the threading server (one handler thread per
    connection) plus the shared StoreService batching across handlers.
    """

    def handle(self) -> None:
        shard: ShardServer = self.server.shard_server  # type: ignore[attr-defined]
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        while True:
            try:
                frame = P.recv_frame_ex(sock, max_frame=shard.max_frame)
            except P.FrameTooLargeError as exc:
                # refuse loudly so the client sees why, then close: the
                # payload was never read, the stream cannot resynchronise
                try:
                    P.send_frame(sock, P.ST_ERR, P.pack_error(exc))
                except OSError:
                    pass
                return
            except P.ProtocolError:
                return  # torn or hostile frame: drop the connection
            except OSError:
                return
            if frame is None:
                return  # clean EOF
            kind, payload, trace = frame
            opname = P.OP_NAMES.get(kind, hex(kind))
            # a v2 frame's trace header joins this server's spans to the
            # client's trace; v1 frames dispatch untraced (span() no-ops)
            prev = TRACER.activate(trace) if trace is not None else None
            try:
                with TRACER.span(f"server.{opname}"):
                    resp = shard.dispatch(kind, payload)
                status = P.ST_OK
            except Exception as exc:
                resp = P.pack_error(exc)
                status = P.ST_ERR
            finally:
                if trace is not None:
                    TRACER.restore(prev)
            try:
                P.send_frame(sock, status, resp)
            except OSError:
                return


class _TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class ShardServer:
    """TCP front-end over one store: the per-shard serving process."""

    def __init__(self, store: CompressedStringStore, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 256,
                 max_wait_s: float = 0.0005,
                 max_frame: int = P.DEFAULT_MAX_FRAME,
                 target_p99_s: float | None = None):
        self.store = store
        self.max_frame = int(max_frame)
        self.service = StoreService(store, max_batch=max_batch,
                                    max_wait_s=max_wait_s,
                                    target_p99_s=target_p99_s)
        # per-op request counters, in stats() and /metrics: which server
        # answered. Counter.inc() takes a lock, since dispatch() runs on
        # every connection's handler thread
        self._op_counters: dict[str, Counter] = {}
        self._op_lock = threading.Lock()  # guards counter creation only
        self._tcp = _TCPServer((host, port), _Handler)
        self._tcp.shard_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @classmethod
    def from_dir(cls, path: str, read_only: bool = False,
                 host: str = "127.0.0.1", port: int = 0,
                 device: str | torch.device = "cuda", **kw) -> "ShardServer":
        """Open ``path`` with :func:`open_serving_store` on ``device`` and
        serve it; ``max_batch``, ``max_wait_s``, ``max_frame`` and
        ``target_p99_s`` go to the server, every other keyword to the open."""
        service_kw = {k: kw.pop(k)
                      for k in ("max_batch", "max_wait_s", "max_frame",
                                "target_p99_s") if k in kw}
        store = open_serving_store(path, read_only=read_only, device=device, **kw)
        return cls(store, host=host, port=port, **service_kw)

    @property
    def address(self) -> tuple[str, int]:
        host, port = self._tcp.server_address[:2]
        return str(host), int(port)

    @property
    def port(self) -> int:
        return self.address[1]

    def start(self) -> "ShardServer":
        """Serve in a background thread (tests, in-process topologies)."""
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name=f"shard-server-{self.port}")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._tcp.serve_forever(poll_interval=0.2)

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.service.close()

    def __enter__(self) -> "ShardServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def op_counts(self) -> dict[str, int]:
        """Per-op request counts as a plain dict."""
        with self._op_lock:
            return {name: c.value for name, c in self._op_counters.items()}

    def _count_op(self, opname: str) -> None:
        with self._op_lock:
            counter = self._op_counters.get(opname)
            if counter is None:
                counter = self._op_counters[opname] = REGISTRY.register(
                    Counter("repro_rpc_requests_total", labels={"op": opname}))
        counter.inc()

    def dispatch(self, kind: int, payload: bytes) -> bytes:
        self._count_op(P.OP_NAMES.get(kind, hex(kind)))
        if kind == P.OP_PING:
            if payload == P.CAPS_PROBE:
                # capability negotiation: an old server echoes the probe
                # verbatim; answering with JSON marks this one trace-aware
                return P.pack_json(P.SERVER_CAPS)
            return payload
        if kind == P.OP_GET:
            (i,) = P.unpack_ids(payload)
            return self.service.submit(i).result()
        if kind == P.OP_MULTIGET:
            ids = P.unpack_ids(payload)
            return P.pack_bytes_list(self.service.submit_multiget(ids).result())
        if kind == P.OP_SCAN:
            lo, hi = P.unpack_ids(payload)
            return P.pack_bytes_list(self.store.scan(lo, hi))
        if kind == P.OP_APPEND:
            return P.pack_ids(self.service.submit_extend([payload]).result())
        if kind == P.OP_EXTEND:
            strings = P.unpack_bytes_list(payload)
            return P.pack_ids(self.service.submit_extend(strings).result())
        if kind == P.OP_STATS:
            opts = P.unpack_json(payload) if payload else {}
            stats = self.stats()
            if opts.get("metrics"):
                # the registry snapshot: mergeable histogram and counter
                # states for a client's cross-shard aggregation
                stats["metrics"] = REGISTRY.snapshot()
            return P.pack_json(stats)
        if kind == P.OP_LOCATE:
            found = self.store.locate_batch(P.unpack_bytes_list(payload))
            # None has no <i8 encoding: misses travel as -1
            return P.pack_ids([-1 if gid is None else gid for gid in found])
        if kind == P.OP_SCAN_PREFIX:
            prefix, limit, after = P.unpack_prefix_query(payload)
            return P.pack_prefix_hits(self.store.scan_prefix(prefix, limit, after))
        if kind == P.OP_TRACE_DUMP:
            n = (P.unpack_json(payload) or {}).get("n", 16) if payload else 16
            return P.pack_json(TRACER.trace_dump(n))
        if kind == P.OP_COMPACT:
            if not hasattr(self.store, "compact"):
                raise TypeError("store is read-only; compact() refused")
            kw = P.unpack_json(payload) if payload else {}
            # runs in this connection's handler thread: other connections
            # keep being served while the store rewrites itself
            return P.pack_json(self.store.compact(**kw))
        if kind == P.OP_TIER:
            req = P.unpack_json(payload) if payload else {}
            return P.pack_json(tier_op(self.store,
                                       action=req.get("action", "stats"),
                                       segment=req.get("segment"),
                                       params=req.get("params")))
        if kind == P.OP_SAVE:
            target = getattr(self.store, "_dir", None)
            if not hasattr(self.store, "extend") or target is None:
                raise TypeError(
                    "store is read-only or has no backing directory; save refused")
            self.store.save(target)
            return P.pack_json({"dir": target, "n_strings": self.store.n_strings})
        raise P.ProtocolError(f"unknown op 0x{kind:02x}")

    def stats(self) -> dict:
        return {"n_strings": self.store.n_strings,
                "writable": hasattr(self.store, "extend"),
                "ops": self.op_counts,
                "store": self.store.stats_snapshot(),
                "service": self.service.stats()}


def run(path: str, host: str = "127.0.0.1", port: int = 0,
        read_only: bool = False, max_batch: int = 256,
        max_wait_s: float = 0.0005, target_p99_s: float | None = None,
        announce: bool = True, metrics_port: int | None = None,
        device: str | torch.device = "cuda") -> None:
    """Open the store on ``device``, print the readiness line, serve until
    interrupted. ``metrics_port`` (0 = kernel-assigned) also serves
    Prometheus text on ``/metrics`` and the slow-request trace dump on
    ``/traces``; its port rides the readiness line as ``metrics_port=``."""
    server = ShardServer.from_dir(path, read_only=read_only, host=host,
                                  port=port, device=device,
                                  max_batch=max_batch, max_wait_s=max_wait_s,
                                  target_p99_s=target_p99_s)
    metrics = (start_metrics_server(port=metrics_port, host=host)
               if metrics_port is not None else None)
    if announce:
        extra = f" metrics_port={metrics.port}" if metrics is not None else ""
        print(f"SHARD_SERVER_READY port={server.port} "
              f"n_strings={server.store.n_strings} "
              f"writable={int(hasattr(server.store, 'extend'))}"
              f"{extra} dir={json.dumps(path)}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if metrics is not None:
            metrics.close()
        server.close()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.net",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="shard directory (<parent>/shard-000k) or store dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = kernel-assigned")
    ap.add_argument("--read-only", action="store_true",
                    help="serve as a replica: appends and compaction refused")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-wait-s", type=float, default=0.0005)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve Prometheus /metrics + /traces on this port "
                    "(0 = kernel-assigned; reported as metrics_port= on the "
                    "READY line)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the store's kernels run (default: the card; "
                    "cpu runs their plain PyTorch versions on the host)")
    ap.add_argument("--target-p99-ms", type=float, default=None,
                    help="enable the adaptive micro-batching window: the service "
                    "tunes max_wait_s toward the largest value whose observed "
                    "request p99 stays under this target")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        ap.exit(1, f"{ap.prog}: {exc}\n")
    run(args.dir, host=args.host, port=args.port, read_only=args.read_only,
        max_batch=args.max_batch, max_wait_s=args.max_wait_s,
        target_p99_s=(None if args.target_p99_ms is None
                      else args.target_p99_ms / 1e3),
        metrics_port=args.metrics_port, device=args.device)


if __name__ == "__main__":
    main()
