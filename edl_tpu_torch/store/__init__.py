"""The coordination store's client: the port's copy of ``edl_tpu.store``'s
client side (``client``, ``shard``, ``replica`` and the wire ``Event``).

The server (``python -m edl_tpu.store.server``) is jax-free and runs from
the JAX package; a port worker speaks the same wire protocol to it, so the
two packages share one store.
"""

from edl_tpu_torch.store.kv import Event
from edl_tpu_torch.store.client import (
    LeaseKeeper,
    ShardedStoreClient,
    StoreClient,
    connect_store,
)

__all__ = [
    "Event",
    "StoreClient",
    "ShardedStoreClient",
    "LeaseKeeper",
    "connect_store",
]
