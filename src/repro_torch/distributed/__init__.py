"""Distribution layer: segment-sharded store persistence
(:mod:`~repro_torch.distributed.shard_store`), the shards sharing one
dictionary and, on the card, one upload of its tables."""

from repro_torch.distributed.shard_store import (READ_PREFERENCES,
                                                 ShardedStringStore,
                                                 ShardRouter,
                                                 check_read_preference,
                                                 manifest_replicas, open_shard,
                                                 plan_shards, record_replicas,
                                                 save_sharded)

__all__ = ["READ_PREFERENCES", "ShardRouter", "ShardedStringStore",
           "check_read_preference", "manifest_replicas", "open_shard",
           "plan_shards", "record_replicas", "save_sharded"]
