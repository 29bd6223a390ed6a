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
        # (batch_size, cap) batches of misses and their rows, padding
        # included, as the reference launched them (the port launches once
        # per call: its kernel counters count that)
        self.batches = 0
        self.padded_rows = 0
        self.decode_seconds = 0.0
        self.scan_strings = 0       # strings returned by scan()
        self.cold_lookups = 0       # misses decoded from the RLZ cold tier
        self.locates = 0            # reverse lookups (queries, incl. misses)
        self.locate_hits = 0        # reverse lookups that found an id
        self.prefix_scans = 0       # scan_prefix calls
        # (B, T) decode shapes launched; the reference's name for them
        self.jit_shapes: set[tuple[int, int]] = set()
        # per-store instruments registered into the process registry,
        # labelled by the store's device type
        labels = {"backend": backend}
        self._lat = REGISTRY.register(Histogram(
            "repro_store_multiget_latency_us", labels=labels))
        self._lookups_total = REGISTRY.register(Counter(
            "repro_store_lookups_total", labels=labels))
        self._locate_lat = REGISTRY.register(Histogram(
            "repro_store_locate_latency_us", labels=labels))

    def record_multiget(self, n_ids: int, seconds: float) -> None:
        self.lookups += n_ids
        self._lookups_total.inc(n_ids)
        self._lat.record_seconds(seconds)

    def record_locate(self, n_queries: int, n_hits: int,
                      seconds: float) -> None:
        self.locates += n_queries
        self.locate_hits += n_hits
        self._locate_lat.record_seconds(seconds)

    def record_decode(self, chunks: dict[tuple[int, int], int], n_real: int,
                      nbytes: int, seconds: float, jitted: bool = True) -> None:
        """One call's decoded misses. ``chunks`` maps each padded ``(B, T)``
        shape the reference would launch for them to its number of
        batches; a host decode (``jitted=False``) counts its one unpadded
        batch and no shape, as the reference's numpy path does."""
        for shape, k in chunks.items():
            self.batches += k
            self.padded_rows += shape[0] * k
            if jitted:
                self.jit_shapes.add(shape)
        self.decoded_strings += n_real
        self.decoded_bytes += nbytes
        self.decode_seconds += seconds

    def snapshot(self, cache_stats: dict | None = None) -> dict:
        elapsed = time.perf_counter() - self.started_at
        return {
            "lookups": self.lookups,
            "decoded_strings": self.decoded_strings,
            "decoded_bytes": self.decoded_bytes,
            "scan_strings": self.scan_strings,
            "cold_lookups": self.cold_lookups,
            "locates": self.locates,
            "locate_hits": self.locate_hits,
            "prefix_scans": self.prefix_scans,
            "batches": self.batches,
            "padded_rows": self.padded_rows,
            "pad_efficiency": round(
                self.decoded_strings / self.padded_rows, 4
            ) if self.padded_rows else 1.0,
            "jit_shapes": sorted(self.jit_shapes),
            "decode_mib_s": round(
                throughput_mib_s(self.decoded_bytes, self.decode_seconds), 2
            ) if self.decode_seconds else 0.0,
            "lookups_per_s": round(self.lookups / elapsed, 1) if elapsed else 0.0,
            "multiget_latency": self._lat.summary(),
            "multiget_latency_hist": self._lat.state(),
            "cache": cache_stats or {},
        }
