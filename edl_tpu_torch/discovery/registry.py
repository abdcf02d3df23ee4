"""Job-scoped service registry over the coordination store.

Capability parity with the reference's etcd registry layer
(python/edl/discovery/etcd_client.py:52-257 ``EtcdClient`` +
python/edl/discovery/register.py:29-143 ``ServerRegister``):

- keys are ``/{job_id}/{service}/{name}`` with a value payload;
- a *registration* holds a lease (default TTL 10 s, matching the
  reference's liveness window) refreshed by a background keeper; if the
  lease is lost (store restart, network partition outliving the TTL) the
  registration re-registers itself and reports the incident;
- ``register_if_absent`` is the contended form used for rank racing;
- permanent (lease-less) puts record final status;
- ``watch_service`` delivers add/remove callbacks per server, resolving
  ``resync`` markers into a diff against a fresh read.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.store.client import RESYNC, LeaseKeeper, StoreClient
from edl_tpu_torch.utils.exceptions import EdlRegisterError, EdlStoreError
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.retry import retry_call

logger = get_logger("discovery.registry")

DEFAULT_TTL = 10.0


@dataclass(frozen=True)
class ServerMeta:
    service: str
    name: str
    value: bytes
    mod_rev: int = 0


def _service_prefix(job_id: str, service: str) -> str:
    return "/%s/%s/" % (job_id, service)


class Registration:
    """A live, heartbeated registration. ``stop()`` to deregister."""

    def __init__(
        self,
        registry: "Registry",
        key: str,
        value: bytes,
        ttl: float,
        on_lost: Optional[Callable[[], None]],
        restore: bool = True,
    ) -> None:
        self._registry = registry
        self.key = key
        self.value = value
        self._ttl = ttl
        self._on_lost = on_lost
        self._restore = restore
        self._stopped = False
        self._keeper: Optional[LeaseKeeper] = None

    def _arm(self, lease: int) -> None:
        self._keeper = LeaseKeeper(
            self._registry._client, lease, self._ttl, on_lost=self._lost
        )

    def _lost(self) -> None:
        """Lease died under us: try to re-register, like the reference's
        heartbeat re-register loop (register.py:57-76).

        Contended keys (rank slots) must NOT auto-restore — blindly re-
        putting could steal a slot another pod legitimately won after our
        lease expired — so with ``restore=False`` the loss is only
        reported and the owner re-races."""
        if self._stopped:
            return
        if not self._restore:
            logger.warning("registration %s lost its lease", self.key)
            if self._on_lost is not None:
                self._on_lost()
            return
        logger.warning("registration %s lost its lease; re-registering", self.key)

        def _restore() -> None:
            # re-check before EVERY attempt: a stop() landing during the
            # backoff sleep must not be followed by a successful
            # re-register (resurrecting a key the owner just deleted,
            # with a LeaseKeeper nobody will ever stop)
            if self._stopped:
                raise EdlStoreError("registration stopped mid-restore")
            lease = self._registry._client.lease_grant(self._ttl)
            self._registry._client.put(self.key, self.value, lease=lease)
            if self._stopped:
                # lost the race after the put: undo rather than arm
                try:
                    self._registry._client.lease_revoke(lease)
                except EdlStoreError:
                    pass
                raise EdlStoreError("registration stopped mid-restore")
            self._arm(lease)

        try:
            # bound matches the reference's 45-retry give-up
            retry_call(
                _restore,
                what="register.restore",
                retry_on=(EdlStoreError,),
                retries=44,
                base_delay=0.1,
                max_delay=1.5,
                give_up=lambda: self._stopped,
            )
        except EdlStoreError:
            if self._stopped:
                return
            logger.error("registration %s could not be restored", self.key)
            if self._on_lost is not None:
                self._on_lost()
            return
        logger.info("registration %s restored", self.key)

    def update(self, value: bytes) -> None:
        """Overwrite the registration payload, keeping the same lease."""
        if self._keeper is None:
            raise EdlRegisterError("registration not armed")
        self.value = value
        self._registry._client.put(self.key, value, lease=self._keeper.lease)

    def stop(self, delete: bool = True) -> None:
        self._stopped = True
        if self._keeper is not None:
            self._keeper.stop(revoke=delete)


class ServiceWatch:
    """Watch one service's membership; add/rm callbacks like the
    reference's ``watch_service`` (etcd_client.py:116-170)."""

    def __init__(
        self,
        registry: "Registry",
        service: str,
        on_add: Optional[Callable[[ServerMeta], None]] = None,
        on_remove: Optional[Callable[[ServerMeta], None]] = None,
        on_change: Optional[Callable[[Dict[str, ServerMeta]], None]] = None,
    ) -> None:
        self._registry = registry
        self._service = service
        self._prefix = _service_prefix(registry.job_id, service)
        self._on_add = on_add
        self._on_remove = on_remove
        self._on_change = on_change
        self._lock = threading.Lock()
        self.servers: Dict[str, ServerMeta] = {}
        servers, rev = registry.get_service_with_revision(service)
        with self._lock:
            self.servers = {m.name: m for m in servers}
        for meta in servers:
            self._safe(self._on_add, meta)
        self._notify_change()
        self._watch = registry._client.watch(self._prefix, self._on_events, start_rev=rev)

    def _safe(self, fn, *args) -> None:
        if fn is None:
            return
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — consumer bugs must not kill the watch
            logger.exception("service-watch callback failed for %s", self._service)

    def _name_of(self, key: str) -> str:
        return key[len(self._prefix):]

    def _on_events(self, events) -> None:
        changed = False
        for ev in events:
            if ev.type == RESYNC:
                changed |= self._resync()
                continue
            name = self._name_of(ev.key)
            if ev.type == "put":
                meta = ServerMeta(self._service, name, ev.value, ev.rev)
                with self._lock:
                    existed = name in self.servers
                    self.servers[name] = meta
                if not existed:
                    self._safe(self._on_add, meta)
                changed = True
            elif ev.type == "del":
                with self._lock:
                    meta = self.servers.pop(name, None)
                if meta is not None:
                    self._safe(self._on_remove, meta)
                    changed = True
        if changed:
            self._notify_change()

    def _resync(self) -> bool:
        servers, _ = self._registry.get_service_with_revision(self._service)
        fresh = {m.name: m for m in servers}
        with self._lock:
            old, self.servers = self.servers, fresh
        for name in fresh.keys() - old.keys():
            self._safe(self._on_add, fresh[name])
        for name in old.keys() - fresh.keys():
            self._safe(self._on_remove, old[name])
        return fresh != old

    def _notify_change(self) -> None:
        if self._on_change is not None:
            with self._lock:
                snapshot = dict(self.servers)
            self._safe(self._on_change, snapshot)

    def snapshot(self) -> Dict[str, ServerMeta]:
        with self._lock:
            return dict(self.servers)

    def cancel(self) -> None:
        self._watch.cancel()


class Registry:
    """All registry operations for one job, over one store client."""

    def __init__(self, client: StoreClient, job_id: str) -> None:
        self._client = client
        self.job_id = job_id

    # -- liveness-scoped registration -------------------------------------

    def register(
        self,
        service: str,
        name: str,
        value: bytes,
        ttl: float = DEFAULT_TTL,
        on_lost: Optional[Callable[[], None]] = None,
        restore: bool = True,
    ) -> Registration:
        key = _service_prefix(self.job_id, service) + name
        lease = self._client.lease_grant(ttl)
        self._client.put(key, value, lease=lease)
        reg = Registration(self, key, value, ttl, on_lost, restore)
        reg._arm(lease)
        return reg

    def register_if_absent(
        self,
        service: str,
        name: str,
        value: bytes,
        ttl: float = DEFAULT_TTL,
        on_lost: Optional[Callable[[], None]] = None,
        restore: bool = False,
    ) -> Tuple[Optional[Registration], Optional[bytes]]:
        """Contended registration (rank racing). Returns
        ``(registration, None)`` if we won, ``(None, holder_value)`` if the
        key already exists. Defaults to ``restore=False``: a lost contended
        slot is reported, never silently re-taken."""
        key = _service_prefix(self.job_id, service) + name
        lease = self._client.lease_grant(ttl)
        created, cur = self._client.put_if_absent(key, value, lease=lease)
        if not created:
            self._client.lease_revoke(lease)
            return None, cur
        reg = Registration(self, key, value, ttl, on_lost, restore)
        reg._arm(lease)
        return reg, None

    # -- permanent keys ----------------------------------------------------

    def set_permanent(self, service: str, name: str, value: bytes) -> None:
        self._client.put(_service_prefix(self.job_id, service) + name, value)

    def remove(self, service: str, name: str) -> bool:
        return self._client.delete(_service_prefix(self.job_id, service) + name)

    def remove_service(self, service: str) -> int:
        return self._client.delete_range(_service_prefix(self.job_id, service))

    # -- reads -------------------------------------------------------------

    def get_server(self, service: str, name: str) -> Optional[ServerMeta]:
        value, rev = self._client.get_with_rev(
            _service_prefix(self.job_id, service) + name
        )
        if value is None:
            return None
        return ServerMeta(service, name, value, rev)

    def get_service(self, service: str) -> List[ServerMeta]:
        return self.get_service_with_revision(service)[0]

    def get_service_with_revision(
        self, service: str
    ) -> Tuple[List[ServerMeta], int]:
        prefix = _service_prefix(self.job_id, service)
        kvs, rev = self._client.range(prefix)
        return [
            ServerMeta(service, k[len(prefix):], v, mr) for k, v, mr, _ in kvs
        ], rev

    # -- watches -----------------------------------------------------------

    def watch_service(
        self,
        service: str,
        on_add: Optional[Callable[[ServerMeta], None]] = None,
        on_remove: Optional[Callable[[ServerMeta], None]] = None,
        on_change: Optional[Callable[[Dict[str, ServerMeta]], None]] = None,
    ) -> ServiceWatch:
        return ServiceWatch(self, service, on_add, on_remove, on_change)
