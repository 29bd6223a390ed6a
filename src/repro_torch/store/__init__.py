"""The compressed string store: batched random access on the device, and
the writable store over it (append into a tail, seal, compact on drift)."""

from repro_torch.store.cache import LRUCache
from repro_torch.store.drift import DriftMonitor
from repro_torch.store.mutable import MutableStringStore
from repro_torch.store.store import CompressedStringStore

__all__ = ["CompressedStringStore", "DriftMonitor", "LRUCache",
           "MutableStringStore"]
