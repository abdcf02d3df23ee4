"""Discovery/balance daemon CLI.

Capability parity with the reference's ``python -m
edl.distill.discovery_server`` (python/edl/distill/discovery_server.py:50,
63-94): hosts the BalanceTable(s) assigning teachers to student clients.
Run replicas with distinct ``--balancer_id``s and they shard service
names by consistent hash (≙ reference balance_table.py:376-391).

    python -m edl_tpu_torch.distill.discovery_server \
        --store 127.0.0.1:2379 --job_id distill --services teacher
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence

from edl_tpu_torch.distill.discovery import DiscoveryService
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("distill.discovery_server")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.distill.discovery_server",
        description="teacher<->student balance daemon",
    )
    parser.add_argument("--store", required=True, help="store HOST:PORT")
    parser.add_argument("--job_id", default="distill")
    parser.add_argument(
        "--services", default="teacher", help="comma-separated service names"
    )
    parser.add_argument("--balancer_id", default=None)
    parser.add_argument("--ttl", type=float, default=10.0)
    args = parser.parse_args(argv)

    # handlers first: a signal that lands once the balancer is registered
    # must deregister it
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    service = DiscoveryService(
        args.store,
        args.job_id,
        [s for s in args.services.split(",") if s],
        balancer_id=args.balancer_id,
        ttl=args.ttl,
    )
    logger.info(
        "discovery server up (job=%s services=%s)", args.job_id, args.services
    )
    stop.wait()
    service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
