"""Per-store serving counters: lookups, batches, bytes, latency percentiles."""

from __future__ import annotations

import time

from repro_torch.core.metrics import throughput_mib_s
from repro_torch.obs import REGISTRY, Counter, Histogram


class StoreStats:
    """Mutable counters updated by the store's hot path."""

    def __init__(self, backend: str = "unknown") -> None:
        self.started_at = time.perf_counter()
        self.lookups = 0            # ids requested (incl. duplicates/cached)
        self.decoded_strings = 0    # strings actually decoded (cache misses)
        self.decoded_bytes = 0
        self.batches = 0            # decode kernel invocations
        self.padded_rows = 0        # batch rows incl. padding (waste metric)
        self.decode_seconds = 0.0
        self.decode_shapes: set[tuple[int, int]] = set()  # (B, T) launched
        # per-store instruments registered into the process registry,
        # labelled by the store's device type
        labels = {"backend": backend}
        self._lat = REGISTRY.register(Histogram(
            "repro_store_multiget_latency_us", labels=labels))
        self._lookups_total = REGISTRY.register(Counter(
            "repro_store_lookups_total", labels=labels))

    def record_multiget(self, n_ids: int, seconds: float) -> None:
        self.lookups += n_ids
        self._lookups_total.inc(n_ids)
        self._lat.record_seconds(seconds)

    def record_decode_batch(self, shape: tuple[int, int], n_real: int,
                            nbytes: int, seconds: float) -> None:
        self.batches += 1
        self.padded_rows += shape[0]
        self.decoded_strings += n_real
        self.decoded_bytes += nbytes
        self.decode_seconds += seconds
        self.decode_shapes.add(shape)

    def snapshot(self, cache_stats: dict | None = None) -> dict:
        elapsed = time.perf_counter() - self.started_at
        return {
            "lookups": self.lookups,
            "decoded_strings": self.decoded_strings,
            "decoded_bytes": self.decoded_bytes,
            "batches": self.batches,
            "padded_rows": self.padded_rows,
            "pad_efficiency": round(
                self.decoded_strings / self.padded_rows, 4
            ) if self.padded_rows else 1.0,
            "decode_shapes": sorted(self.decode_shapes),
            "decode_mib_s": round(
                throughput_mib_s(self.decoded_bytes, self.decode_seconds), 2
            ) if self.decode_seconds else 0.0,
            "lookups_per_s": round(self.lookups / elapsed, 1) if elapsed else 0.0,
            "multiget_latency": self._lat.summary(),
            "cache": cache_stats or {},
        }
