"""Serving-metric helpers shared by the store and the smoke run."""

from __future__ import annotations


def throughput_mib_s(nbytes: int, seconds: float) -> float:
    return nbytes / float(1 << 20) / max(seconds, 1e-12)
