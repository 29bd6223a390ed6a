"""repro_torch.net — the multi-process serving tier, on the card.

Turns the shard directories written by
:func:`repro_torch.distributed.save_sharded` into a retrieval *service*: each
shard host runs a :class:`ShardServer` process over its directory (its store
on the card, the three kernels behind the socket), and a
:class:`DistributedStringStore` routes global ids across them with the
contract of the in-process ``ShardedStringStore`` (they share one
``ShardRouter`` base).

  protocol      — length-prefixed binary framing over TCP, the reference's
                  byte for byte (stdlib + numpy only)
  shard_server  — ShardServer: one shard directory behind a socket, all
                  connections coalesced through one StoreService worker
  router        — RemoteShardClient (pooled, reconnecting) +
                  DistributedStringStore (concurrent per-shard fan-out,
                  replica-backed compaction hand-off)

Frames, answers and metric names match the reference's, so a router of
either package reads servers of either.
"""

from repro_torch.net.protocol import (FrameTooLargeError, ProtocolError,
                                      RemoteError, TruncatedFrameError)
from repro_torch.net.router import DistributedStringStore, RemoteShardClient
from repro_torch.net.shard_server import ShardServer

__all__ = [
    "DistributedStringStore",
    "FrameTooLargeError",
    "ProtocolError",
    "RemoteError",
    "RemoteShardClient",
    "ShardServer",
    "TruncatedFrameError",
]
