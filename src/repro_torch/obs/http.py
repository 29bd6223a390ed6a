"""Metrics and traces over HTTP — the ``--metrics-port`` surface.

A small threaded stdlib HTTP server over the process registry and tracer::

    GET /metrics        Prometheus text exposition (scrape target)
    GET /traces?n=16    slow-request trace dump as JSON
    GET /healthz        "ok" liveness probe

Anything else answers 404. It runs as a daemon thread beside the serving
socket and writes no request log; ``port=0`` binds a kernel-assigned port
(:attr:`MetricsServer.port`, and the shard server's readiness line).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import TRACER, Tracer


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler naming)
        srv: MetricsServer = self.server.metrics_server  # type: ignore[attr-defined]
        url = urlparse(self.path)
        if url.path == "/metrics":
            self._send(200, srv.registry.render_prometheus().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/traces":
            n = int(parse_qs(url.query).get("n", ["16"])[0])
            self._send(200, json.dumps(srv.tracer.trace_dump(n)).encode(),
                       "application/json")
        elif url.path == "/healthz":
            self._send(200, b"ok\n", "text/plain")
        else:
            self._send(404, b"not found\n", "text/plain")

    def log_message(self, *args) -> None:  # scrapes are not server logs
        pass


class MetricsServer:
    """Threaded exposition server over one registry and tracer."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.registry = registry if registry is not None else REGISTRY
        self.tracer = tracer if tracer is not None else TRACER
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.metrics_server = self  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"metrics-server-{self.port}")
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def start_metrics_server(port: int = 0, host: str = "127.0.0.1",
                         registry: MetricsRegistry | None = None,
                         tracer: Tracer | None = None) -> MetricsServer:
    """Bind and serve ``/metrics``, ``/traces`` and ``/healthz`` on a daemon
    thread; returns the running server (``.port`` for port 0)."""
    return MetricsServer(port=port, host=host, registry=registry,
                         tracer=tracer).start()
