"""The compressed string store: batched random access on the device."""

from repro_torch.store.cache import LRUCache
from repro_torch.store.store import CompressedStringStore

__all__ = ["CompressedStringStore", "LRUCache"]
