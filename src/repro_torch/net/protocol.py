"""Length-prefixed binary framing for the shard RPC plane.

One frame per request and one per response, over a plain TCP socket::

    +-------+---------+------+-------------+----------------+
    | magic | version | kind | length (u32)| payload bytes  |
    | "RS"  |   0x01  | u8   | little-end. | length bytes   |
    +-------+---------+------+-------------+----------------+

``kind`` is a request op (``OP_*``) on the way in and a status
(``ST_OK``/``ST_ERR``) on the way out. Payloads are numpy-native packed
arrays — id vectors are raw ``<i8`` buffers and string batches are an
offsets-plus-blob container (:func:`pack_bytes_list`) — so a router or a
server moves ``multiget`` batches without any per-string Python framing.
Stdlib + numpy only. The format is the reference's, byte for byte, so a
client of either package talks to a server of the other.

Frames above ``max_frame`` are refused *before* the payload is read
(:class:`FrameTooLargeError` — a malformed or hostile peer cannot make the
receiver allocate unbounded memory), and a socket that dies mid-frame
surfaces :class:`TruncatedFrameError` rather than a silent short read.

**Trace propagation (optional, version 2).** A frame whose ``version`` byte
is :data:`TRACED_VERSION` prefixes its payload with a fixed 24-byte trace
context — 16 hex chars of trace id + a ``u64`` parent span id — so a
request's trace follows it across the socket (:mod:`repro_torch.obs`). The
header struct is unchanged and ``length`` covers the prefix, so any receiver
that understands v2 parses both versions; v1-only peers stay tolerated by never
*sending* them v2: a client probes capability once per server with an
:data:`OP_PING` carrying :data:`CAPS_PROBE` (an old server echoes the probe
verbatim — its ping is an echo — while a new server answers a capability
JSON), and only attaches trace headers when the probe came back positive.
"""

from __future__ import annotations

import json
import socket
import struct

import numpy as np

from repro_torch.obs.trace import TraceContext

MAGIC = b"RS"
VERSION = 1
#: frame version whose payload starts with a 24-byte trace context
TRACED_VERSION = 2
_HEADER = struct.Struct("<2sBBI")
HEADER_BYTES = _HEADER.size
_TRACE_CTX = struct.Struct("<16sQ")
#: bytes of trace context prefixing a TRACED_VERSION payload
TRACE_CTX_BYTES = _TRACE_CTX.size

#: OP_PING payload a client sends to discover server capabilities: an old
#: server echoes it back byte-for-byte, a trace-aware server replies with a
#: capability JSON — the difference IS the negotiation.
CAPS_PROBE = b"\x00REPRO-CAPS\x00"
#: capabilities a trace-aware server answers the probe with; ``locate``
#: advertises the reverse-lookup ops (OP_LOCATE / OP_SCAN_PREFIX) so a
#: new client falls back to scan-side filtering against an old server
#: instead of tripping its unknown-op error path on every call
SERVER_CAPS = {
    "trace": True,
    "trace_version": TRACED_VERSION,
    "locate": True,
    "tier": True,
}

#: refuse frames above this size unless the caller raises the limit
DEFAULT_MAX_FRAME = 64 << 20

# request ops
OP_PING = 0x01
OP_GET = 0x02
OP_MULTIGET = 0x03
OP_SCAN = 0x04
OP_APPEND = 0x05
OP_EXTEND = 0x06
OP_STATS = 0x07
OP_COMPACT = 0x08
OP_SAVE = 0x09
OP_TRACE_DUMP = 0x0A
OP_LOCATE = 0x0B
OP_SCAN_PREFIX = 0x0C
OP_TIER = 0x0D

# response statuses
ST_OK = 0x40
ST_ERR = 0x41

OP_NAMES = {
    OP_PING: "ping",
    OP_GET: "get",
    OP_MULTIGET: "multiget",
    OP_SCAN: "scan",
    OP_APPEND: "append",
    OP_EXTEND: "extend",
    OP_STATS: "stats",
    OP_COMPACT: "compact",
    OP_SAVE: "save",
    OP_TRACE_DUMP: "trace_dump",
    OP_LOCATE: "locate",
    OP_SCAN_PREFIX: "scan_prefix",
    OP_TIER: "tier",
}


class ProtocolError(Exception):
    """Malformed frame: bad magic, unknown version, or unknown kind."""


class FrameTooLargeError(ProtocolError):
    """Declared payload length exceeds the receiver's ``max_frame``."""


class TruncatedFrameError(ProtocolError):
    """The stream ended (or the buffer ran out) mid-frame."""


class RemoteError(RuntimeError):
    """A server-side exception type the client does not re-raise natively."""


# --------------------------------------------------------------------- frames
def pack_trace(ctx: TraceContext) -> bytes:
    """Trace context -> the fixed 24-byte wire prefix."""
    return _TRACE_CTX.pack(ctx.trace_id.encode("ascii")[:16].ljust(16, b"0"),
                           ctx.span_id & (2**64 - 1))


def unpack_trace(raw: bytes) -> TraceContext:
    tid, span_id = _TRACE_CTX.unpack(raw)
    return TraceContext(tid.decode("ascii", "replace"), int(span_id))


def encode_frame(kind: int, payload: bytes = b"",
                 trace: TraceContext | None = None) -> bytes:
    """One wire frame: header + payload; with ``trace`` the frame is
    version :data:`TRACED_VERSION` and the payload is prefixed by the
    24-byte trace context (covered by ``length``)."""
    if trace is None:
        return _HEADER.pack(MAGIC, VERSION, kind, len(payload)) + payload
    prefix = pack_trace(trace)
    return (_HEADER.pack(MAGIC, TRACED_VERSION, kind,
                         len(prefix) + len(payload)) + prefix + payload)


def _decode_header_ex(
    header: bytes, max_frame: int = DEFAULT_MAX_FRAME
) -> tuple[int, int, int]:
    """Validate one header; returns ``(kind, payload_length, version)``."""
    if len(header) < HEADER_BYTES:
        raise TruncatedFrameError(
            f"frame header truncated: {len(header)} of {HEADER_BYTES} bytes"
        )
    magic, version, kind, length = _HEADER.unpack(header[:HEADER_BYTES])
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    if version not in (VERSION, TRACED_VERSION):
        raise ProtocolError(f"unsupported protocol version {version}")
    if version == TRACED_VERSION and length < TRACE_CTX_BYTES:
        raise ProtocolError(
            f"traced frame of {length} bytes cannot hold its "
            f"{TRACE_CTX_BYTES}-byte trace context"
        )
    if length > max_frame:
        raise FrameTooLargeError(
            f"frame payload of {length} bytes exceeds max_frame={max_frame}"
        )
    return kind, length, version


def decode_header(header: bytes, max_frame: int = DEFAULT_MAX_FRAME) -> tuple[int, int]:
    """Validate one header; returns ``(kind, payload_length)``."""
    kind, length, _ = _decode_header_ex(header, max_frame=max_frame)
    return kind, length


def _split_trace(payload: bytes, version: int) -> tuple[bytes, TraceContext | None]:
    if version != TRACED_VERSION:
        return payload, None
    return payload[TRACE_CTX_BYTES:], unpack_trace(payload[:TRACE_CTX_BYTES])


def decode_frame_ex(
    buf: bytes, max_frame: int = DEFAULT_MAX_FRAME
) -> tuple[int, bytes, TraceContext | None, int]:
    """Decode one frame from an in-memory buffer.

    Returns ``(kind, payload, trace_context_or_None, bytes_consumed)``;
    raises :class:`TruncatedFrameError` when the buffer holds less than one
    full frame (the streaming equivalent is a peer dying mid-send).
    """
    kind, length, version = _decode_header_ex(buf, max_frame=max_frame)
    end = HEADER_BYTES + length
    if len(buf) < end:
        raise TruncatedFrameError(
            f"frame payload truncated: {len(buf) - HEADER_BYTES} of {length} bytes"
        )
    payload, trace = _split_trace(bytes(buf[HEADER_BYTES:end]), version)
    return kind, payload, trace, end


def decode_frame(
    buf: bytes, max_frame: int = DEFAULT_MAX_FRAME
) -> tuple[int, bytes, int]:
    """Trace-agnostic :func:`decode_frame_ex`: ``(kind, payload, consumed)``
    with any trace context already stripped from the payload."""
    kind, payload, _, end = decode_frame_ex(buf, max_frame=max_frame)
    return kind, payload, end


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes; '' mid-read raises TruncatedFrameError."""
    parts = []
    remaining = n
    while remaining:
        chunk = sock.recv(min(remaining, 1 << 20))
        if not chunk:
            raise TruncatedFrameError(
                f"connection closed mid-frame ({n - remaining} of {n} bytes)"
            )
        parts.append(chunk)
        remaining -= len(chunk)
    return b"".join(parts)


def send_frame(sock: socket.socket, kind: int, payload: bytes = b"",
               trace: TraceContext | None = None) -> None:
    sock.sendall(encode_frame(kind, payload, trace=trace))


def recv_frame_ex(
    sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME
) -> tuple[int, bytes, TraceContext | None] | None:
    """Read one frame; ``None`` on a clean EOF at a frame boundary.

    Returns ``(kind, payload, trace_context_or_None)``. EOF *inside* a
    frame raises :class:`TruncatedFrameError`; an oversized declared length
    raises :class:`FrameTooLargeError` before any payload byte is read.
    """
    first = sock.recv(1)
    if not first:
        return None
    header = first + recv_exact(sock, HEADER_BYTES - 1)
    kind, length, version = _decode_header_ex(header, max_frame=max_frame)
    payload = recv_exact(sock, length) if length else b""
    payload, trace = _split_trace(payload, version)
    return kind, payload, trace


def recv_frame(
    sock: socket.socket, max_frame: int = DEFAULT_MAX_FRAME
) -> tuple[int, bytes] | None:
    """Trace-agnostic :func:`recv_frame_ex`: ``(kind, payload)`` with any
    trace context already stripped."""
    frame = recv_frame_ex(sock, max_frame=max_frame)
    if frame is None:
        return None
    return frame[0], frame[1]


# ------------------------------------------------------------------- payloads
def pack_ids(ids) -> bytes:
    """Id vector as a raw ``<i8`` buffer (numpy zero-copy on both ends)."""
    return np.asarray(list(ids), dtype="<i8").tobytes()


def unpack_ids(payload: bytes) -> list[int]:
    if len(payload) % 8:
        raise ProtocolError(f"id vector of {len(payload)} bytes is not <i8-aligned")
    return [int(i) for i in np.frombuffer(payload, dtype="<i8")]


def pack_bytes_list(items: list[bytes]) -> bytes:
    """String batch container: ``u32 n | i8 offsets[n+1] | blob``.

    The same offsets-plus-payload shape the store's corpus uses, so a
    ``multiget`` response is two ``np.frombuffer`` views, not n copies.
    """
    offsets = np.zeros(len(items) + 1, dtype="<i8")
    np.cumsum([len(s) for s in items], out=offsets[1:])
    head = struct.pack("<I", len(items))
    return head + offsets.tobytes() + b"".join(items)


def unpack_bytes_list(payload: bytes) -> list[bytes]:
    if len(payload) < 4:
        raise ProtocolError("bytes-list payload shorter than its count header")
    (n,) = struct.unpack_from("<I", payload)
    off_end = 4 + (n + 1) * 8
    if len(payload) < off_end:
        raise ProtocolError(f"bytes-list offsets truncated (n={n})")
    offsets = np.frombuffer(payload, dtype="<i8", count=n + 1, offset=4)
    blob = payload[off_end:]
    if offsets.size and int(offsets[-1]) != len(blob):
        raise ProtocolError(
            f"bytes-list blob holds {len(blob)} bytes, offsets claim {int(offsets[-1])}"
        )
    return [bytes(blob[int(offsets[k]) : int(offsets[k + 1])]) for k in range(n)]


def pack_prefix_query(prefix: bytes, limit: int | None,
                      after: tuple[bytes, int] | None = None) -> bytes:
    """OP_SCAN_PREFIX request: prefix + limit (+ optional resume cursor).

    All pieces ride in one nested bytes-list so arbitrary (non-utf8)
    prefixes and cursor strings survive the wire; ``limit=None`` encodes
    as -1.
    """
    parts = [prefix, pack_ids([-1 if limit is None else int(limit)])]
    if after is not None:
        parts += [after[0], pack_ids([int(after[1])])]
    return pack_bytes_list(parts)


def unpack_prefix_query(
    payload: bytes,
) -> tuple[bytes, int | None, tuple[bytes, int] | None]:
    parts = unpack_bytes_list(payload)
    if len(parts) not in (2, 4):
        raise ProtocolError(
            f"prefix query holds {len(parts)} parts, expected 2 or 4"
        )
    limit = unpack_ids(parts[1])[0]
    after = (parts[2], unpack_ids(parts[3])[0]) if len(parts) == 4 else None
    return parts[0], (None if limit < 0 else limit), after


def pack_prefix_hits(hits: list[tuple[int, bytes]]) -> bytes:
    """OP_SCAN_PREFIX response: parallel id vector + string batch."""
    return pack_bytes_list([
        pack_ids([gid for gid, _ in hits]),
        pack_bytes_list([s for _, s in hits]),
    ])


def unpack_prefix_hits(payload: bytes) -> list[tuple[int, bytes]]:
    ids_raw, strings_raw = unpack_bytes_list(payload)
    ids, strings = unpack_ids(ids_raw), unpack_bytes_list(strings_raw)
    if len(ids) != len(strings):
        raise ProtocolError(
            f"prefix hits hold {len(ids)} ids but {len(strings)} strings"
        )
    return list(zip(ids, strings))


def pack_json(obj) -> bytes:
    return json.dumps(obj).encode()


def unpack_json(payload: bytes):
    return json.loads(payload.decode())


# --------------------------------------------------------------------- errors
#: exception types a client re-raises natively (everything else: RemoteError)
_NATIVE_ERRORS = {
    "FrameTooLargeError": FrameTooLargeError,
    "IndexError": IndexError,
    "KeyError": KeyError,
    "TypeError": TypeError,
    "ValueError": ValueError,
    "RuntimeError": RuntimeError,
}


def pack_error(exc: BaseException) -> bytes:
    return pack_json({"type": type(exc).__name__, "message": str(exc)})


def raise_remote(payload: bytes) -> None:
    """Re-raise a server-side error client-side, preserving builtin types
    (an out-of-range id raises IndexError through the socket, exactly as it
    would in-process)."""
    err = unpack_json(payload)
    cls = _NATIVE_ERRORS.get(err.get("type", ""))
    if cls is not None:
        raise cls(err.get("message", "remote error"))
    raise RemoteError(f"{err.get('type', 'Exception')}: {err.get('message', '')}")
