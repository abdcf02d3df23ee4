"""Generic server-registration CLI.

Capability parity with the reference's ``python -m edl.discovery.register``
(python/edl/discovery/register.py:101-143): wait until a server's port
answers, then register its endpoint under a service name and heartbeat
until terminated. Works for any service; distillation teachers use the
``distill/teachers/`` namespace via ``--teacher``.

    python -m edl_tpu_torch.discovery.register --store 127.0.0.1:2379 \
        --job_id distill --service teacher --teacher --endpoint HOST:PORT

The port's copy of ``edl_tpu/discovery/register.py``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
from typing import Optional, Sequence

from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import wait_until_alive

logger = get_logger("discovery.register")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.discovery.register",
        description="register a live endpoint under a service name",
    )
    parser.add_argument("--store", required=True, help="store HOST:PORT")
    parser.add_argument("--job_id", required=True)
    parser.add_argument("--service", required=True)
    parser.add_argument("--endpoint", required=True, help="server HOST:PORT")
    parser.add_argument("--value", default="1")
    parser.add_argument("--ttl", type=float, default=10.0)
    parser.add_argument(
        "--wait_alive", type=float, default=60.0,
        help="seconds to wait for the endpoint's port to answer",
    )
    parser.add_argument(
        "--teacher", action="store_true",
        help="register in the distill teacher namespace",
    )
    args = parser.parse_args(argv)

    if not wait_until_alive(args.endpoint, timeout=args.wait_alive):
        logger.error("endpoint %s never came alive", args.endpoint)
        return 1

    service = args.service
    if args.teacher:
        from edl_tpu_torch.distill.discovery import TEACHER_SERVICE

        service = TEACHER_SERVICE % args.service

    client = StoreClient(args.store)
    registry = Registry(client, args.job_id)
    reg = registry.register(
        service, args.endpoint, args.value.encode(), ttl=args.ttl
    )
    logger.info(
        "registered %s under %s/%s", args.endpoint, args.job_id, service
    )
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    reg.stop(delete=True)
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
