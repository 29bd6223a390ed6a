"""Request tracing: trace ids, span stacks, slow-request ring.

A *trace* is one logical request, identified by a 16-hex-char trace id
minted at the outermost span. *Spans* are named timed sections inside it —
``store.decode`` (batch size annotated) → ``kernel.decode_batch`` (path and
shape annotated) — linked by parent span ids.

:meth:`Tracer.span` opens a child of the thread's ambient context and
activates itself for the body, so nested calls need no plumbing. When *no*
ambient context exists and ``root=False``, ``span`` is a no-op: untraced hot
paths pay one ``getattr``.

Finished spans land in a bounded ring (constant memory);
:meth:`Tracer.trace_dump` groups the ring by trace id and returns the
*slowest* ``n`` recent requests. Stdlib only; timestamps are
``perf_counter`` relative to process start.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple


class TraceContext(NamedTuple):
    """Which trace, which span."""

    trace_id: str  # 16 lowercase hex chars
    span_id: int   # u64, unique within the minting process


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Per-process span recorder with ambient (thread-local) context."""

    def __init__(self, max_spans: int = 4096):
        self._tls = threading.local()
        self._spans: deque = deque(maxlen=int(max_spans))
        self._ids = itertools.count(1)  # next() is atomic under the GIL
        self._epoch = time.perf_counter()

    def current(self) -> TraceContext | None:
        return getattr(self._tls, "ctx", None)

    def record(self, name: str, ctx: TraceContext, parent_id: int,
               start_s: float, duration_s: float, **annotations) -> None:
        """Book one finished span with explicit ``perf_counter`` times."""
        self._spans.append({
            "name": name,
            "trace_id": ctx.trace_id,
            "span_id": ctx.span_id,
            "parent_id": parent_id,
            "start_us": (start_s - self._epoch) * 1e6,
            "duration_us": duration_s * 1e6,
            "annotations": annotations,
        })

    @contextmanager
    def span(self, name: str, *, root: bool = False, **annotations):
        """Timed section as a child of the ambient context.

        No ambient context and ``root=False`` → no-op (yields ``None``);
        ``root=True`` mints a new trace when none is active. The span's
        context is ambient for the body, so nested spans chain parentage.
        """
        parent = self.current()
        if parent is None and not root:
            yield None
            return
        if parent is None:
            ctx, pid = TraceContext(new_trace_id(), next(self._ids)), 0
        else:
            ctx, pid = TraceContext(parent.trace_id, next(self._ids)), parent.span_id
        self._tls.ctx = ctx
        t0 = time.perf_counter()
        try:
            yield ctx
        finally:
            self._tls.ctx = parent
            self.record(name, ctx, pid, t0, time.perf_counter() - t0,
                        **annotations)

    def trace_dump(self, n: int = 16) -> list[dict]:
        """The ``n`` slowest recent traces (slowest first), each with its
        spans in start order."""
        by_trace: dict[str, list[dict]] = {}
        for span in list(self._spans):  # snapshot; deque mutates under us
            by_trace.setdefault(span["trace_id"], []).append(span)
        traces = []
        for trace_id, spans in by_trace.items():
            spans.sort(key=lambda s: s["start_us"])
            roots = [s for s in spans if s["parent_id"] == 0]
            duration = max((s["duration_us"] for s in (roots or spans)))
            traces.append({
                "trace_id": trace_id,
                "duration_us": duration,
                "root": (roots or spans)[0]["name"],
                "n_spans": len(spans),
                "spans": spans,
            })
        traces.sort(key=lambda t: -t["duration_us"])
        return traces[: int(n)]


#: the process-wide tracer every serving module records into
TRACER = Tracer()
