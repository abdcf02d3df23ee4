"""The store's watch event, as the client decodes it off the wire.

The port's copy of ``Event`` from ``edl_tpu/store/kv.py``, the one name
the store client imports from there. The state machine itself
(``StoreState``) belongs to the store server, which is jax-free and runs
from the JAX package: a port worker only talks to it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

@dataclass(frozen=True)
class Event:
    type: str  # "put" | "del"
    key: str
    value: Optional[bytes]
    rev: int
    lease: int = 0

    def to_wire(self) -> dict:
        return {
            "t": self.type,
            "k": self.key,
            "v": self.value,
            "r": self.rev,
            "l": self.lease,
        }

    @staticmethod
    def from_wire(d: dict) -> "Event":
        return Event(d["t"], d["k"], d.get("v"), d["r"], d.get("l", 0))
