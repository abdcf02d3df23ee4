"""Network helpers: free ports, host IP, TCP liveness probe.

Capability parity with the reference's ``find_free_ports``
(python/edl/utils/utils.py:139), host-ip discovery, and the TCP connect
probe ``is_server_alive`` (python/edl/discovery/server_alive.py:19) whose
local address doubles as client-identity material.
"""

from __future__ import annotations

import socket
from contextlib import closing
from typing import List, Optional, Tuple


def find_free_ports(num: int = 1) -> List[int]:
    """Reserve ``num`` distinct currently-free TCP ports.

    The sockets are opened simultaneously so the kernel cannot hand the
    same port out twice, then all are closed.
    """
    socks = []
    ports = []
    try:
        for _ in range(num):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def get_host_ip() -> str:
    """Best-effort non-loopback IP of this host (no packets are sent)."""
    with closing(socket.socket(socket.AF_INET, socket.SOCK_DGRAM)) as s:
        try:
            s.connect(("10.255.255.255", 1))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"


def split_endpoint(endpoint: str) -> Tuple[str, int]:
    ip, port = endpoint.rsplit(":", 1)
    return ip, int(port)


def wait_until_alive(
    endpoint: str, timeout: float = 60.0, interval: float = 0.3
) -> bool:
    """Poll :func:`is_server_alive` until ``endpoint`` answers or
    ``timeout`` elapses. Returns whether the endpoint came alive."""
    import time

    deadline = time.time() + timeout
    while True:
        alive, _ = is_server_alive(endpoint)
        if alive:
            return True
        if time.time() > deadline:
            return False
        time.sleep(interval)


def is_server_alive(
    endpoint: str, timeout: float = 1.5
) -> Tuple[bool, Optional[str]]:
    """TCP-connect probe. Returns ``(alive, local_addr_of_probe)``.

    ``local_addr`` ("ip:port" of our side of the probe connection) is
    returned so callers can derive a client identity from it, as the
    reference does (server_alive.py:19-33).
    """
    ip, port = split_endpoint(endpoint)
    try:
        with closing(socket.create_connection((ip, port), timeout=timeout)) as s:
            lip, lport = s.getsockname()[:2]
            return True, "%s:%d" % (lip, lport)
    except OSError:
        return False, None
