"""Control-plane HA plumbing shared by the store server and client.

The warm-standby design (see DESIGN.md "Control-plane HA"):

- a follower ``StoreServer`` dials the primary over the ordinary wire
  protocol, bootstraps from a streamed snapshot (``repl_sync``), then
  tails journal entries live (``rl`` push frames);
- the primary publishes every member's endpoint under the
  ``/store/endpoints/`` keyspace — replicated like any other key, so a
  promoted follower still knows the whole membership, and clients can
  refresh their ordered endpoint list from whichever member they reach;
- on primary death the best-placed follower promotes itself: it bumps
  the persisted **fencing epoch**, takes slot 0 in the endpoint
  keyspace, and runs a fence campaign (``repl_fence``) against every
  other known endpoint so a resurrected stale primary refuses service
  before a fresh client can write to it.

This module holds the pieces both sides share: endpoint-list parsing,
the endpoint keyspace layout, and the one-shot probe/fence requests.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Union

from edl_tpu_torch.rpc.wire import WireError, request_once
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("store.replica")

# Root (job-independent) keyspace: the store's own membership. Slot 0 is
# the primary; standbys take their priority as the slot. Keys sort
# lexically into promotion order, so "ordered endpoint list" is one range.
ENDPOINTS_PREFIX = "/store/endpoints/"


def endpoint_key(slot: int) -> str:
    return "%s%03d" % (ENDPOINTS_PREFIX, slot)


def endpoint_value(endpoint: str, epoch: int, role: str) -> bytes:
    return json.dumps(
        {"endpoint": endpoint, "epoch": epoch, "role": role, "ts": time.time()}
    ).encode()


def parse_endpoint_rows(rows) -> List[str]:
    """``range(ENDPOINTS_PREFIX)`` rows -> ordered endpoint list (slot
    order; malformed entries skipped)."""
    out: List[str] = []
    for _key, value, *_rest in rows:
        try:
            endpoint = json.loads(value)["endpoint"]
        except (ValueError, TypeError, KeyError):
            continue
        if endpoint and endpoint not in out:
            out.append(endpoint)
    return out


def parse_endpoints(spec: Union[str, Sequence[str], None]) -> List[str]:
    """Accept ``"h:p"``, ``"h:p,h:p"`` or a sequence; ordered, deduped."""
    if spec is None:
        return []
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",")]
    else:
        parts = [str(p).strip() for p in spec]
    out: List[str] = []
    for part in parts:
        if part and part not in out:
            out.append(part)
    return out


# -- one-shot control probes --------------------------------------------------


# edl: blocking-ok(0.5s-capped one-shot dial; the event-loop caller is a standby weighing promotion — the primary it would otherwise serve behind is already dead)
def probe_status(endpoint: str, timeout: float = 0.5) -> Optional[Dict]:
    """Ask ``endpoint`` for its replication status (role, epoch,
    revision). ``None`` when unreachable or not a store."""
    try:
        resp = request_once(
            endpoint, {"i": 1, "m": "repl_status"}, timeout=timeout
        )
    except (OSError, WireError, ValueError):
        return None
    if not resp.get("ok"):
        return None
    return resp


def send_fence(
    endpoint: str, epoch: int, sender: str = "", timeout: float = 0.5
) -> Optional[Dict]:
    """Deliver a fencing epoch to ``endpoint``. The receiver compares: a
    primary seeing a HIGHER epoch fences itself (every subsequent client
    request is rejected with ``EdlFencedError``); a receiver whose own
    epoch is higher answers with it, telling the CALLER it is the stale
    one; an EQUAL-epoch primary-vs-primary contact (two standbys promoted
    concurrently) tie-breaks on ``sender`` — the lexically larger
    advertise endpoint loses, on both sides of the exchange, so exactly
    one survives. ``None`` when unreachable."""
    try:
        return request_once(
            endpoint,
            {"i": 1, "m": "repl_fence", "e": int(epoch), "ep": sender},
            timeout=timeout,
        )
    except (OSError, WireError, ValueError):
        return None
