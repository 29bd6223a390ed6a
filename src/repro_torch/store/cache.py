"""Byte-budgeted LRU cache for decoded strings, with hit/miss accounting.

Point-lookup traffic against a compressed store is typically heavily skewed
(Zipfian ids); caching decoded strings turns the common case into a dict hit
and leaves the batch decode kernel serving the miss tail. Capacity is in
*decoded payload bytes* so the resident budget is explicit next to the
compressed corpus's own footprint.
"""

from __future__ import annotations


class LRUCache:
    """LRU over ``int id -> bytes`` with a decoded-bytes capacity budget.

    ``capacity_bytes=0`` disables caching (every get misses, puts drop) —
    used by benchmarks to measure the pure decode path.
    """

    def __init__(self, capacity_bytes: int = 8 << 20):
        self.capacity_bytes = int(capacity_bytes)
        self._data: dict[int, bytes] = {}  # dict preserves insertion = LRU order
        self.current_bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._data)

    _MISSING = object()  # sentinel: b"" is a valid cached value

    def get(self, key: int) -> bytes | None:
        val = self._data.pop(key, self._MISSING)
        if val is self._MISSING:
            self.misses += 1
            return None
        self._data[key] = val  # reinsert = move to most-recent position
        self.hits += 1
        return val

    def put(self, key: int, value: bytes) -> None:
        if self.capacity_bytes <= 0:
            return
        if len(value) > self.capacity_bytes:
            # never admit an entry the budget can't hold: it would evict the
            # whole cache and then pin current_bytes over capacity forever
            return
        old = self._data.pop(key, None)
        if old is not None:
            self.current_bytes -= len(old)
        self._data[key] = value
        self.current_bytes += len(value)
        while self.current_bytes > self.capacity_bytes and len(self._data) > 1:
            old_key = next(iter(self._data))
            self.current_bytes -= len(self._data.pop(old_key))
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()
        self.current_bytes = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"entries": len(self._data), "bytes": self.current_bytes,
                "capacity_bytes": self.capacity_bytes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}
