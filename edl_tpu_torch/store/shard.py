"""Keyspace sharding for the coordination store (DESIGN.md "Sharded
control plane").

One :class:`~edl_tpu.store.server.StoreServer` (plus its warm standbys —
the replication/failover machinery, with semi-sync ack) is one
**shard**. The keyspace is partitioned across shards with the existing
consistent-hash ring (``edl_tpu/discovery/consistent_hash.py``), and the
topology is itself stored IN the store, the same way endpoints are:

- **Shard map.** ``/store/shards/{idx:03d}`` rows on the META shard
  (shard 0) name every shard and its ordered endpoint list (primary
  first, standbys after — the same ordered-list convention clients
  already use for ``/store/endpoints/``). Clients bootstrap by dialing
  any seed endpoint of the meta shard, reading the map, then dialing
  the rest; each per-shard client keeps refreshing its own shard's
  ``/store/endpoints/`` exactly as before, so per-shard failover needs
  no map update.
- **Routing rule.** A key routes by its *routing token*: the first two
  path components (``/{job_id}/{service}``) — the granularity every
  read-then-watch consumer (``discovery/registry.py`` ServiceWatch)
  already operates at, so a service's range+watch lands on ONE shard
  and per-shard revisions stay coherent for resume. Keys with fewer
  components route by the whole key. The ``/store/...`` system keyspace
  is pinned to the meta shard (the map must be findable before the
  ring exists).
- **Prefix routing.** A range/watch prefix maps to a single shard iff
  it pins the full routing token (contains the token-closing third
  ``/``); anything shorter fans out to every shard and merges.

Per-shard fencing epochs come for free: each shard is its own
replication group with its own persisted epoch, probes and fence
campaign.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Sequence, Tuple

# Shard-map keyspace: rows live on the META shard (index 0). Like
# /store/endpoints/, the keys sort lexically into shard order.
SHARDS_PREFIX = "/store/shards/"
META_PREFIX = "/store/"


def shard_key(idx: int) -> str:
    return "%s%03d" % (SHARDS_PREFIX, idx)


def shard_name(idx: int) -> str:
    return "shard-%d" % idx


def shard_value(idx: int, endpoints: Sequence[str]) -> bytes:
    return json.dumps({
        "shard": int(idx),
        "name": shard_name(idx),
        "endpoints": list(endpoints),
        "ts": time.time(),
    }).encode()


def parse_shard_rows(rows) -> List[Tuple[str, List[str]]]:
    """``range(SHARDS_PREFIX)`` rows -> ordered ``(name, endpoints)``
    list (slot order; malformed rows skipped)."""
    out: List[Tuple[str, List[str]]] = []
    for _key, value, *_rest in rows:
        try:
            doc = json.loads(value)
            name = str(doc["name"])
            endpoints = [str(e) for e in doc["endpoints"] if e]
        except (ValueError, TypeError, KeyError):
            continue
        if name and endpoints:
            out.append((name, endpoints))
    return out


def publish_shard_map(client, shard_endpoints: Sequence[Sequence[str]]) -> None:
    """Write the shard map through ``client`` (which must reach the meta
    shard — any client does before the map exists, since everything is
    one shard then)."""
    for idx, endpoints in enumerate(shard_endpoints):
        client.put(shard_key(idx), shard_value(idx, endpoints))


def route_token(key: str) -> Optional[str]:
    """The routing token of ``key``: its first two path components, or
    the whole key when shorter. ``None`` pins a ``/store/...`` system
    key to the meta shard."""
    if key.startswith(META_PREFIX):
        return None
    parts = key.split("/", 3)
    if len(parts) >= 4:
        return "/".join(parts[:3])
    return key


def route_prefix(prefix: str) -> Tuple[bool, Optional[str]]:
    """``(single, token)`` for a range/watch prefix: ``single`` is True
    when the prefix maps to exactly one shard — it pins the full routing
    token (``/{job}/{service}/...``) or lives in the meta keyspace —
    else the caller must fan out to every shard and merge."""
    if prefix.startswith(META_PREFIX):
        return True, None
    parts = prefix.split("/", 3)
    if len(parts) >= 4:
        return True, "/".join(parts[:3])
    return False, None
