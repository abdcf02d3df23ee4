"""Consistent-hash ring with virtual nodes and copy-on-write updates.

Capability parity with the reference's ring (python/edl/discovery/
consistent_hash.py:21-141): MD5 hashing, 300 virtual nodes per real node,
and single-writer copy-on-write so concurrent readers never take a lock —
mutation builds a fresh immutable ring snapshot and swaps it atomically.
Used to shard service names across balancer replicas (reference
balance_table.py:376-391).
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, Iterable, List, Optional, Sequence


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class _Ring:
    """Immutable ring snapshot: sorted virtual-node hashes -> real node."""

    __slots__ = ("hashes", "owners", "nodes")

    def __init__(self, nodes: Sequence[str], vnodes: int) -> None:
        pairs = []
        for node in set(nodes):
            for i in range(vnodes):
                pairs.append((_hash("%s#%d" % (node, i)), node))
        pairs.sort()
        self.hashes = [h for h, _ in pairs]
        self.owners = [n for _, n in pairs]
        self.nodes = sorted(set(nodes))

    def get(self, key: str) -> Optional[str]:
        if not self.hashes:
            return None
        idx = bisect.bisect_right(self.hashes, _hash(key))
        if idx == len(self.hashes):
            idx = 0
        return self.owners[idx]

    def successors(self, key: str, k: int, exclude=()) -> List[str]:
        """Up to ``k`` DISTINCT ring successors of ``key``'s position,
        clockwise, skipping ``exclude`` — the replica-placement walk
        (e.g. checkpoint shards pushed to the K nodes after the owner)."""
        if not self.hashes or k <= 0:
            return []
        start = bisect.bisect_right(self.hashes, _hash(key))
        out: List[str] = []
        skip = set(exclude)
        for i in range(len(self.owners)):
            owner = self.owners[(start + i) % len(self.owners)]
            if owner in skip or owner in out:
                continue
            out.append(owner)
            if len(out) >= k:
                break
        return out


class ConsistentHash:
    def __init__(self, nodes: Iterable[str] = (), vnodes: int = 300) -> None:
        self._vnodes = vnodes
        self._ring = _Ring(list(nodes), vnodes)

    @property
    def nodes(self) -> List[str]:
        return list(self._ring.nodes)

    def add_node(self, node: str) -> None:
        self._ring = _Ring(self._ring.nodes + [node], self._vnodes)

    def remove_node(self, node: str) -> None:
        self._ring = _Ring(
            [n for n in self._ring.nodes if n != node], self._vnodes
        )

    def update_nodes(self, nodes: Iterable[str]) -> None:
        self._ring = _Ring(list(nodes), self._vnodes)

    def get_node(self, key: str) -> Optional[str]:
        return self._ring.get(key)

    def successors(self, key: str, k: int, exclude=()) -> List[str]:
        """See :meth:`_Ring.successors` (lock-free snapshot read)."""
        return self._ring.successors(key, k, exclude)

    def assign(self, keys: Iterable[str]) -> Dict[str, List[str]]:
        """Shard ``keys`` across nodes: node -> sorted keys it owns."""
        ring = self._ring
        out: Dict[str, List[str]] = {n: [] for n in ring.nodes}
        for key in sorted(keys):
            owner = ring.get(key)
            if owner is not None:
                out[owner].append(key)
        return out
