"""The compressed string store: batched random access on the device for
OnPair16 and on the host for the other token-stream codecs (OnPair, BPE),
the writable store over it (append into a tail, seal, compact on drift),
reverse lookup (locate, scan_prefix), the RLZ cold tier, save/open in the
reference's layout, and the micro-batching service in front of a store.
Which path a store takes follows its codec's registry capability
(:mod:`repro_torch.core.registry`)."""

from repro_torch.store.cache import LRUCache
from repro_torch.store.drift import DriftMonitor
from repro_torch.store.mutable import MutableStringStore
from repro_torch.store.segment import Segment, SegmentedCorpus
from repro_torch.store.service import StoreService
from repro_torch.store.stats import StoreStats
from repro_torch.store.store import CompressedStringStore
from repro_torch.store.tier import TierManager, tier_op

__all__ = ["CompressedStringStore", "DriftMonitor", "LRUCache",
           "MutableStringStore", "Segment", "SegmentedCorpus", "StoreStats",
           "StoreService", "TierManager", "tier_op"]
