"""Store URL parsing — one connect string per deployment shape.

The client layer resolves every backend from a URL::

    file://<dir>                      read-only CompressedStringStore
    mut://<dir>                       writable MutableStringStore
    shard://<dir>                     in-process ShardedStringStore router
    tcp://host:port[,host:port...]    DistributedStringStore over RPC servers

Options ride the query string (``tcp://h:9100?read_preference=replica``)
and merge under any keyword arguments passed to ``connect()`` — explicit
kwargs win. Values are parsed leniently: ``true``/``false`` become bools,
ints and floats become numbers, everything else stays a string (so
``?device=cpu``, the port's device choice for the directory schemes, rides
as the string ``"cpu"``). Parsing and its errors are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from urllib.parse import parse_qsl, unquote

SCHEMES = ("file", "mut", "shard", "tcp")


@dataclass(frozen=True)
class StoreURL:
    """A parsed connect string."""

    scheme: str
    #: directory path (file/mut/shard) — None for tcp
    path: str | None = None
    #: [(host, port), ...] in shard order — None for directory schemes
    addresses: list[tuple[str, int]] | None = None
    #: query-string options (already type-coerced)
    options: dict = field(default_factory=dict)


def _coerce(value: str):
    low = value.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return value


def _parse_address(part: str) -> tuple[str, int]:
    host, sep, port = part.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bad address {part!r} (expected host:port)")
    return (host or "127.0.0.1", int(port))


def parse_url(url: str) -> StoreURL:
    """Parse a store connect string; raises ValueError on unknown schemes."""
    scheme, sep, rest = url.partition("://")
    if not sep or scheme not in SCHEMES:
        known = ", ".join(f"{s}://" for s in SCHEMES)
        raise ValueError(f"unsupported store url {url!r} (known: {known})")
    rest, _, query = rest.partition("?")
    options = {k: _coerce(v) for k, v in parse_qsl(query)}
    if scheme == "tcp":
        parts = [p for p in rest.split(",") if p]
        if not parts:
            raise ValueError(f"tcp url {url!r} names no host:port")
        return StoreURL(scheme, addresses=[_parse_address(p) for p in parts],
                        options=options)
    if not rest:
        raise ValueError(f"{scheme} url {url!r} names no directory")
    return StoreURL(scheme, path=unquote(rest), options=options)


def format_tcp_url(addresses) -> str:
    """The inverse of parse_url for address lists (spawners print this)."""
    return "tcp://" + ",".join(f"{h}:{p}" for h, p in addresses)
