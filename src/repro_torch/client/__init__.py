"""repro_torch.client — one session layer over every store backend of the
port.

The port's four frontends — the local
:class:`~repro_torch.store.store.CompressedStringStore` /
:class:`~repro_torch.store.mutable.MutableStringStore`, the in-process
:class:`~repro_torch.distributed.shard_store.ShardedStringStore` router, and
the multi-process :class:`~repro_torch.net.router.DistributedStringStore` —
behind the reference's frozen client surface::

    from repro_torch.client import connect

    client = connect("tcp://host0:9100,host1:9101",
                     read_preference="replica", timeout=10.0)
    client.multiget([3, 99_000, 41])            # sync, order-preserving
    fut = client.multiget_async([7, 8, 9])      # pipelined future
    for doc in client.scan_iter(0, 1_000_000):  # streamed, frame-bounded
        ...
    client.stats()                              # one schema, every backend

    local = connect("file:///data/store")              # on the card
    host = connect("file:///data/store?device=cpu")    # on the host

  url        — connect-string parsing (file:// mut:// shard:// tcp://)
  session    — StoreClient: the frozen sync/async surface + unified stats
"""

from repro_torch.client.session import StoreClient, connect, wrap
from repro_torch.client.url import SCHEMES, StoreURL, format_tcp_url, parse_url

__all__ = [
    "SCHEMES",
    "StoreClient",
    "StoreURL",
    "connect",
    "format_tcp_url",
    "parse_url",
    "wrap",
]
