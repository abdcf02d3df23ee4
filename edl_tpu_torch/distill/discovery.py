"""Teacher discovery + load balancing for the distillation layer.

Capability parity with the reference's discovery stack (it ships two —
etcd/gRPC ``BalanceTable`` (python/edl/distill/balance_table.py) and the
redis/epoll twin (python/edl/distill/redis/) — which exist only to offer a
choice of external store; here ONE stack over the edl_tpu coordination
store covers both):

- **teacher side**: :class:`TeacherRegister` registers an endpoint under a
  service name once its port answers, then heartbeats via the store lease
  (≙ python/edl/discovery/register.py:29-143).
- **balancer**: :class:`BalanceTable` watches the teacher service and
  tracks registered student clients, assigning teachers to clients with
  the reference's greedy caps (balance_table.py:244-246):
  at most ``ceil(clients/teachers)`` clients per teacher and
  ``max(1, teachers/clients)`` teachers per client; client views are
  versioned so students only reconnect on real change.
- **student side**: :class:`DiscoveryClient` registers, heartbeats, and
  exposes ``get_servers() -> (version, [endpoints])``
  (≙ python/edl/distill/discovery_client.py).

The balancer runs *inside the store's keyspace*: assignments are written
to ``assign/{client_id}`` keys, so students watch their own key instead of
polling a bespoke RPC service — one server process fewer than the
reference, same behavior. A :class:`DiscoveryService` daemon hosts the
BalanceTable; multiple daemons shard service-names by consistent hash
(≙ the reference's ``__balance__`` self-registration + REDIRECT,
balance_table.py:376-391, 487-495) — a client simply connects to the shard
owner's store keyspace, no redirect round-trip needed because assignment
delivery is store-watch based.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from edl_tpu_torch.discovery.consistent_hash import ConsistentHash
from edl_tpu_torch.discovery.registry import Registry, ServerMeta
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import wait_until_alive

logger = get_logger("distill.discovery")

TEACHER_SERVICE = "distill/teachers/%s"  # % service_name
CLIENT_SERVICE = "distill/clients/%s"
ASSIGN_SERVICE = "distill/assign/%s"
BALANCER_SERVICE = "distill/balancers"
# circuit-breaker ejection: clients lease sick reports here, named
# "endpoint|client_id" so reports from different students coexist and a
# dead reporter's opinion expires with its lease
SICK_SERVICE = "distill/sick/%s"


DRAINING = b"draining"  # registration payload of a teacher on notice


class TeacherRegister:
    """Register a live teacher endpoint; the store lease is the heartbeat.

    Waits for the serving port to answer before registering (the
    reference's ``register.py:78`` does the same TCP probe).

    Graceful drain (health plane): :meth:`drain` flips the registration
    payload to ``draining`` — the balancer drops the endpoint from every
    assignment on the next watch tick, so students stop sending NEW work
    while in-flight predicts finish, instead of discovering the teacher
    via connection failures after it dies. When the hosting pod's id is
    known (``pod_id`` arg or ``EDL_POD_ID`` env), the register also
    watches the job's ``preempt/`` keyspace and drains itself the moment
    its pod is preemption-noticed."""

    def __init__(
        self,
        store_endpoint: str,
        job_id: str,
        service_name: str,
        teacher_endpoint: str,
        ttl: float = 10.0,
        wait_alive: float = 60.0,
        pod_id: Optional[str] = None,
    ) -> None:
        if not wait_until_alive(teacher_endpoint, timeout=wait_alive):
            raise TimeoutError(
                "teacher %s not accepting connections" % teacher_endpoint
            )
        self._client = StoreClient(store_endpoint)
        self._registry = Registry(self._client, job_id)
        self._endpoint = teacher_endpoint
        self._drained = False
        self._preempt_watch = None
        self._reg = self._registry.register(
            TEACHER_SERVICE % service_name,
            teacher_endpoint,
            b"1",
            ttl=ttl,
        )
        import os as _os

        pod_id = pod_id or _os.environ.get("EDL_POD_ID", "")
        if pod_id:
            from edl_tpu_torch.cluster.contract import PREEMPT_SERVICE

            self._pod_id = pod_id
            try:
                self._preempt_watch = self._registry.watch_service(
                    PREEMPT_SERVICE, on_change=self._on_preempt
                )
            except Exception as exc:  # noqa: BLE001 — optional integration
                logger.warning("teacher preempt watch not armed: %s", exc)
        logger.info("teacher %s registered under %s", teacher_endpoint, service_name)

    def _on_preempt(self, snapshot) -> None:
        if self._pod_id in snapshot and not self._drained:
            logger.warning(
                "teacher %s: hosting pod %s preemption-noticed; draining",
                self._endpoint, self._pod_id[:8],
            )
            self.drain()

    def drain(self) -> None:
        """Graceful teacher drain: leave the balance set now, keep serving
        until the process actually stops."""
        if self._drained:
            return
        self._drained = True
        try:
            self._reg.update(DRAINING)
        except Exception as exc:  # noqa: BLE001 — a failed mark degrades
            # to the old behavior (students find out via dead connections)
            logger.warning("teacher drain mark failed: %s", exc)

    def stop(self) -> None:
        if self._preempt_watch is not None:
            try:
                self._preempt_watch.cancel()
            except Exception:  # noqa: BLE001
                pass
        self._reg.stop(delete=True)
        self._client.close()


class BalanceTable:
    """Greedy teacher↔client assignment with the reference's caps.

    Rebalance triggers: teacher add/remove (store watch), client add/remove
    (store watch). Assignments are published to ``assign/{client}`` keys as
    ``{"v": version, "servers": [...]}``; version bumps only when that
    client's list actually changed (reference balance_table.py versioned
    per-client views).
    """

    def __init__(self, registry: Registry, service_name: str) -> None:
        self._registry = registry
        self._service_name = service_name
        self._lock = threading.Lock()
        self._teachers: List[str] = []
        self._clients: List[str] = []
        self._sick: set = set()
        self._views: Dict[str, Tuple[int, List[str]]] = {}
        self._teacher_watch = registry.watch_service(
            TEACHER_SERVICE % service_name, on_change=self._on_teachers
        )
        self._client_watch = registry.watch_service(
            CLIENT_SERVICE % service_name, on_change=self._on_clients
        )
        self._sick_watch = registry.watch_service(
            SICK_SERVICE % service_name, on_change=self._on_sick
        )

    # -- watch callbacks ---------------------------------------------------

    def _on_teachers(self, servers: Dict[str, ServerMeta]) -> None:
        with self._lock:
            # draining teachers leave the balance set on NOTICE (their
            # registration payload flips), not on connection failure —
            # the reader sheds them while their in-flight work finishes
            self._teachers = sorted(
                name for name, meta in servers.items()
                if meta.value != DRAINING
            )
        self._rebalance()

    def _on_clients(self, clients: Dict[str, ServerMeta]) -> None:
        with self._lock:
            self._clients = sorted(clients)
        self._rebalance()

    def _on_sick(self, reports: Dict[str, ServerMeta]) -> None:
        # report names are "endpoint|client_id"; any live report ejects
        # the endpoint (a breaker-opening client has hard evidence, and
        # the report's lease bounds how long a wrong opinion can stick)
        with self._lock:
            self._sick = {name.split("|", 1)[0] for name in reports}
        self._rebalance()

    # -- the greedy assignment --------------------------------------------

    @staticmethod
    def assign(
        teachers: Sequence[str], clients: Sequence[str]
    ) -> Dict[str, List[str]]:
        """Round-robin with the reference's caps (balance_table.py:244-246):
        ≤ ceil(clients/teachers) clients per teacher,
        max(1, teachers//clients) teachers per client."""
        out: Dict[str, List[str]] = {c: [] for c in clients}
        if not teachers or not clients:
            return out
        per_client = max(1, len(teachers) // len(clients))
        per_teacher_cap = math.ceil(
            len(clients) * per_client / len(teachers)
        )
        load = {t: 0 for t in teachers}
        ti = 0
        for c in clients:
            for _ in range(per_client):
                for _ in range(len(teachers)):  # find a non-full teacher
                    t = teachers[ti % len(teachers)]
                    ti += 1
                    if load[t] < per_teacher_cap:
                        out[c].append(t)
                        load[t] += 1
                        break
        return out

    def _rebalance(self) -> None:
        with self._lock:
            teachers = [t for t in self._teachers if t not in self._sick]
            if not teachers and self._teachers:
                # every teacher reported sick: keep routing to the raw set
                # rather than assigning nobody — per-client breakers still
                # shield each student, and "all sick" usually means the
                # fleet is overloaded, not dead
                teachers = list(self._teachers)
            clients = list(self._clients)
            assignment = self.assign(teachers, clients)
            changed = []
            for client, servers in assignment.items():
                old_version, old_servers = self._views.get(client, (0, None))
                if servers != old_servers:
                    version = old_version + 1
                    self._views[client] = (version, servers)
                    changed.append((client, version, servers))
            for gone in set(self._views) - set(clients):
                del self._views[gone]
                self._registry.remove(
                    ASSIGN_SERVICE % self._service_name, gone
                )
        for client, version, servers in changed:
            self._registry.set_permanent(
                ASSIGN_SERVICE % self._service_name,
                client,
                json.dumps({"v": version, "servers": servers}).encode(),
            )
        if changed:
            logger.info(
                "rebalanced %s: %d teacher(s) over %d client(s), %d view(s) changed",
                self._service_name,
                len(teachers),
                len(clients),
                len(changed),
            )

    def snapshot(self) -> Dict[str, Tuple[int, List[str]]]:
        with self._lock:
            return dict(self._views)

    def stop(self) -> None:
        self._teacher_watch.cancel()
        self._client_watch.cancel()
        self._sick_watch.cancel()


class DiscoveryService:
    """Daemon hosting BalanceTables for the services it owns.

    With replicas, ownership is sharded by consistent hash over the
    balancer ids (≙ reference balance_table.py:376-391): each daemon
    registers under ``distill/balancers`` and (re)claims the services that
    hash to it whenever the balancer set changes.
    """

    def __init__(
        self,
        store_endpoint: str,
        job_id: str,
        service_names: Sequence[str],
        balancer_id: Optional[str] = None,
        ttl: float = 10.0,
    ) -> None:
        self._client = StoreClient(store_endpoint)
        self._registry = Registry(self._client, job_id)
        self._service_names = list(service_names)
        self._balancer_id = balancer_id or ("balancer-%d" % id(self))
        self._tables: Dict[str, BalanceTable] = {}
        self._lock = threading.Lock()
        self._reg = self._registry.register(
            BALANCER_SERVICE, self._balancer_id, b"1", ttl=ttl
        )
        self._peer_watch = self._registry.watch_service(
            BALANCER_SERVICE, on_change=self._on_peers
        )

    def _on_peers(self, peers: Dict[str, ServerMeta]) -> None:
        ring = ConsistentHash(sorted(peers) or [self._balancer_id])
        mine = {
            s for s in self._service_names
            if ring.get_node(s) == self._balancer_id
        }
        with self._lock:
            for name in list(self._tables):
                if name not in mine:
                    self._tables.pop(name).stop()
            for name in mine:
                if name not in self._tables:
                    self._tables[name] = BalanceTable(self._registry, name)
        logger.info(
            "balancer %s owns %d/%d service(s)",
            self._balancer_id,
            len(mine),
            len(self._service_names),
        )

    def owned_services(self) -> List[str]:
        with self._lock:
            return sorted(self._tables)

    def table(self, name: str) -> Optional[BalanceTable]:
        with self._lock:
            return self._tables.get(name)

    def stop(self) -> None:
        with self._lock:
            tables, self._tables = list(self._tables.values()), {}
        for t in tables:
            t.stop()
        self._peer_watch.cancel()
        self._reg.stop(delete=True)
        self._client.close()


class DiscoveryClient:
    """Student-side discovery: register as a client, watch the assignment.

    ``get_servers()`` returns ``(version, endpoints)``; ``wait_servers()``
    blocks until a non-empty assignment arrives. The store lease is the
    heartbeat (≙ the reference's 2 s heartbeat thread,
    discovery_client.py:155)."""

    def __init__(
        self,
        store_endpoint: str,
        job_id: str,
        service_name: str,
        client_id: str,
        max_teachers: int = 0,
        ttl: float = 10.0,
        on_change: Optional[Callable[[int, List[str]], None]] = None,
    ) -> None:
        self._client = StoreClient(store_endpoint)
        self._registry = Registry(self._client, job_id)
        self._service_name = service_name
        self.client_id = client_id
        self._max = max_teachers
        self._cond = threading.Condition()
        self._version = 0
        self._servers: List[str] = []
        self._on_change = on_change
        self._ttl = ttl
        self._sick_lock = threading.Lock()
        self._sick_regs: Dict[str, object] = {}
        self._reg = self._registry.register(
            CLIENT_SERVICE % service_name, client_id, b"1", ttl=ttl
        )
        self._watch = self._registry.watch_service(
            ASSIGN_SERVICE % service_name, on_change=self._on_assign
        )

    def _on_assign(self, servers: Dict[str, ServerMeta]) -> None:
        meta = servers.get(self.client_id)
        if meta is None:
            return
        view = json.loads(meta.value.decode())
        endpoints = view["servers"]
        if self._max > 0:
            endpoints = endpoints[: self._max]
        with self._cond:
            if view["v"] == self._version:
                return
            self._version, self._servers = view["v"], endpoints
            self._cond.notify_all()
        if self._on_change is not None:
            self._on_change(view["v"], endpoints)

    def get_servers(self) -> Tuple[int, List[str]]:
        with self._cond:
            return self._version, list(self._servers)

    def wait_servers(self, timeout: float = 60.0) -> List[str]:
        deadline = time.time() + timeout
        with self._cond:
            while not self._servers:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(
                        "no teachers assigned for %s" % self._service_name
                    )
                self._cond.wait(remaining)
            return list(self._servers)

    # -- circuit-breaker ejection ------------------------------------------

    def report_sick(self, endpoint: str) -> None:
        """Lease a sick report for ``endpoint`` (breaker opened here).
        The balancer ejects it from every client's assignment; the lease
        means the report dies with this client — a crashed reporter
        cannot permanently exile a healthy teacher."""
        with self._sick_lock:
            if endpoint in self._sick_regs:
                return
            self._sick_regs[endpoint] = self._registry.register(
                SICK_SERVICE % self._service_name,
                "%s|%s" % (endpoint, self.client_id),
                b"1",
                ttl=self._ttl,
            )
        logger.warning(
            "client %s reported %s sick", self.client_id, endpoint
        )

    def clear_sick(self, endpoint: str) -> None:
        """Withdraw this client's sick report (breaker closed)."""
        with self._sick_lock:
            reg = self._sick_regs.pop(endpoint, None)
        if reg is not None:
            reg.stop(delete=True)
            logger.info(
                "client %s cleared sick report for %s",
                self.client_id, endpoint,
            )

    def stop(self) -> None:
        with self._sick_lock:
            regs, self._sick_regs = list(self._sick_regs.values()), {}
        for reg in regs:
            try:
                reg.stop(delete=True)
            except Exception:  # noqa: BLE001 — best-effort on teardown
                pass
        self._watch.cancel()
        self._reg.stop(delete=True)
        self._client.close()
