"""Thread-safe blocking client for the coordination store.

Plays the role of the reference's ``EtcdClient``
(python/edl/discovery/etcd_client.py:52-257): get/put/range/delete,
put-if-absent transactions for rank racing, leases with keepalive, and
prefix watches — here push-based over one multiplexed connection instead of
etcd watch streams.

Fault behavior mirrors the reference's ``_handle_errors`` reconnect
decorator (etcd_client.py:40-50): on a broken connection the client
reconnects with backoff; in-flight requests fail with
``EdlConnectionError`` (callers retry idempotent ops); watches are resumed
from the last delivered revision, falling back to a synthetic ``resync``
event when the server's history no longer covers it.

Control-plane HA (DESIGN.md "Control-plane HA"): the client accepts an
ORDERED endpoint list ("primary,standby,...", refreshed from the
``/store/endpoints/`` keyspace) and fails over through it — on
connection loss, on a standby's ``EdlNotPrimaryError``, on a fenced
store's ``EdlFencedError``, and on any response whose fencing epoch is
LOWER than one already seen (a resurrected stale primary that nobody
fenced yet). Watches ride every one of these the same way they ride a
reconnect: resume from the last delivered revision, resync when the new
primary's history can't cover the gap.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import socket
import threading
import time
import queue
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import trace as _obs_trace
from edl_tpu_torch.obs.metrics import counter as _counter
from edl_tpu_torch.obs.metrics import histogram as _histogram
from edl_tpu_torch.rpc.wire import TC_FIELD, pack_frame, read_frame_blocking
from edl_tpu_torch.store import replica as replica_mod
from edl_tpu_torch.store import shard as shard_mod
from edl_tpu_torch.store.kv import Event
from edl_tpu_torch.utils.exceptions import (
    EdlCompactedError,
    EdlConnectionError,
    EdlFencedError,
    EdlNotPrimaryError,
    EdlStoreError,
    deserialize_exception,
)
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import split_endpoint
from edl_tpu_torch.utils.retry import retry_call

logger = get_logger("store.client")

_M_FAILOVERS = _counter(
    "edl_store_client_failovers_total",
    "endpoint failovers (connection loss, standby bounce, stale epoch)",
)

# while healthy, re-read /store/endpoints/ this often (piggybacked on
# request traffic): a client must learn a standby's address BEFORE the
# primary dies — refresh-on-reconnect alone can't, its only dial
# candidate being the endpoint that just vanished
_ENDPOINT_REFRESH_S = 5.0

RESYNC = "resync"

_M_ROUNDTRIP = _histogram(
    "edl_store_client_roundtrip_seconds",
    "store request round-trip (send to response), by method",
)

_M_STANDBY_FALLTHROUGH = _counter(
    "edl_store_client_standby_fallthrough_total",
    "standby-mode reads answered by the primary instead (standby "
    "refused: lag past EDL_STORE_STANDBY_MAX_LAG, session floor not "
    "applied yet, bootstrap — or the read leg was down)",
)

_TC = _obs_trace.PROPAGATION

_FP_CONNECT = _fault_point(
    "store.client.connect", "store dial: drop/partition (store looks down)"
)
_FP_REQUEST = _fault_point(
    "store.client.request",
    "one store RPC: delay, or drop/partition before send (a blip — the "
    "caller's EdlConnectionError retry path takes over)",
)


class Watch:
    """Handle for an active prefix watch. ``cancel()`` to stop.

    The watch id is assigned by the *client* (unique across the client's
    lifetime) and survives reconnects, so pushed events can never race the
    handler registration.
    """

    def __init__(self, client: "StoreClient", wid: int, prefix: str, callback) -> None:
        self._client = client
        self.wid = wid
        self.prefix = prefix
        self.callback = callback
        self.last_rev: Optional[int] = None  # None = live-only, no replay
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        self._client._cancel_watch(self)


class _Pending:
    __slots__ = ("done", "response")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.response: Optional[dict] = None


_CLI_IDS = itertools.count(1)


class _OpTape:
    """Consistency history tape: one JSONL record per completed client
    op (ok or fail), riding the flight recorder's crash-safe segment
    discipline. The chaos plane's history checker
    (``edl_tpu/chaos/consistency.py``) replays these records to prove —
    or catch — stale reads, lost acked writes, non-monotonic session
    reads and watch gaps under fault schedules. Enabled per client
    (``op_tape_dir=...``) or per process (``EDL_STORE_OP_TAPE=<dir>``);
    disabled it costs one attribute load per request.

    Values are taped as short digests, never contents: the checker only
    needs identity (did THIS acked write come back), and probe payloads
    stay out of evidence bundles. One tape = one SESSION (``cid``): a
    standby read leg shares its owner's tape, so session-level
    guarantees (read-your-writes, monotonic reads) are checked across
    both connections — which is exactly where they can break.
    """

    OPS = ("get", "range", "put", "cas", "del", "del_range")
    _ROW_CAP = 128  # range rows taped per op; more sets trunc

    def __init__(self, directory: str) -> None:
        from edl_tpu_torch.obs.events import FlightRecorder

        self.cid = uuid.uuid4().hex[:8]
        self._rec = FlightRecorder(directory, component="storeop-" + self.cid)
        self._seq = itertools.count(1)

    @staticmethod
    def digest(value) -> Optional[str]:
        if value is None:
            return None
        if isinstance(value, str):
            value = value.encode()
        return hashlib.md5(bytes(value)).hexdigest()[:12]

    def _base(self, client: "StoreClient", method, params, t0) -> dict:
        doc = {
            "cid": self.cid,
            "cli": client._tape_cli,
            "seq": next(self._seq),
            "op": method,
            "t0": t0,
            "served": "standby" if params.get("rm") == "s" else "leader",
        }
        if "k" in params:
            doc["k"] = params["k"]
        elif "p" in params:
            doc["p"] = params["p"]
        if "rev" in params:
            doc["pin"] = True  # explicit MVCC pin: deliberately old
        if "v" in params:
            doc["d"] = self.digest(params["v"])
        return doc

    def ok(self, client, method, params, resp, t0) -> None:
        doc = self._base(client, method, params, t0)
        doc["ok"] = True
        if "r" in resp:
            doc["r"] = resp["r"]
        if method == "get":
            doc["mr"] = resp.get("mr", 0)
            doc["d"] = self.digest(resp.get("v"))
        elif method == "range":
            rows = resp.get("kvs") or []
            doc["n"] = len(rows)
            doc["rows"] = [
                [k, mr, self.digest(v)]
                for k, v, mr, *_ in rows[: self._ROW_CAP]
            ]
            if len(rows) > self._ROW_CAP:
                doc["trunc"] = True
        elif method == "cas":
            doc["sw"] = bool(resp.get("swapped"))
        elif method in ("del", "del_range"):
            doc["nd"] = resp.get("deleted", 0)
        self._rec.record("store_op", **doc)

    def fail(self, client, method, params, exc, t0) -> None:
        doc = self._base(client, method, params, t0)
        doc["ok"] = False  # indeterminate: the op may or may not have landed
        doc["err"] = type(exc).__name__
        self._rec.record("store_op", **doc)

    def watch_start(self, client, wid: int, prefix: str, r0: int) -> None:
        self._rec.record(
            "store_watch", cid=self.cid, cli=client._tape_cli,
            wid=wid, p=prefix, r0=r0,
        )

    def watch_events(self, client, wid: int, events) -> None:
        self._rec.record(
            "store_watch_ev", cid=self.cid, cli=client._tape_cli, wid=wid,
            evs=[[e.type, e.key, e.rev] for e in events],
        )

    def close(self) -> None:
        self._rec.close()


class StoreClient:
    def __init__(
        self,
        endpoint: Union[str, Sequence[str]],
        timeout: float = 10.0,
        reconnect: bool = True,
        read_mode: str = "leader",
        op_tape_dir: Optional[str] = None,
    ) -> None:
        if read_mode not in ("leader", "standby"):
            raise ValueError(
                "read_mode must be 'leader' or 'standby', got %r" % read_mode
            )
        # consistency history tape (chaos/consistency.py). A standby read
        # leg arrives with its owner's tape already installed — one tape
        # per SESSION, not per connection.
        self._tape_cli = next(_CLI_IDS)
        if getattr(self, "_tape", None) is None:
            tape_dir = op_tape_dir or os.environ.get(
                "EDL_STORE_OP_TAPE", ""
            ).strip()
            self._tape: Optional[_OpTape] = (
                _OpTape(tape_dir) if tape_dir else None
            )
        self._endpoints = replica_mod.parse_endpoints(endpoint)
        if not self._endpoints:
            raise ValueError("StoreClient needs at least one endpoint")
        self._ep_i = 0
        self._epoch = 0  # highest fencing epoch seen on any response
        self._timeout = timeout
        self._reconnect_enabled = reconnect
        self._ids = itertools.count(1)
        self._sock: Optional[socket.socket] = None
        self._send_lock = threading.Lock()
        self._state_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._watches: Dict[int, Watch] = {}  # wid -> Watch
        self._closed = False
        self._reconnecting = False
        self._renewer: Optional["_LeaseRenewer"] = None
        self._last_refresh = time.monotonic()
        # standby read serving (DESIGN.md "Consistency model"):
        # read_mode="standby" sends get/range/watch through a second
        # connection to a standby member, falling through to the primary
        # whenever the standby refuses (lag bound, session floor) or the
        # leg is down. _min_rev is the SESSION FLOOR — the highest
        # revision any response on this client reported — sent as the
        # read's "minr" so a standby can never answer below what this
        # session already observed (read-your-writes + monotonic reads).
        self.read_mode = read_mode
        self._min_rev = 0
        self._standby_leg_client: Optional["_StandbyLegClient"] = None
        self._leg_failed_at = 0.0
        self._leg_rot = 0  # rotated into the leg's candidate order
        self._leg_misses = 0  # consecutive fall-throughs; many = rebuild
        self._event_queue: "queue.Queue" = queue.Queue()
        self._connect()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="edl-store-dispatch", daemon=True
        )
        self._dispatcher.start()
        self._refresh_endpoints()

    @property
    def _endpoint(self) -> str:
        """The endpoint this client currently targets (logging, tests)."""
        with self._state_lock:
            return self._endpoints[self._ep_i % len(self._endpoints)]

    # -- connection management --------------------------------------------

    def _connect(self) -> None:
        """Dial the current endpoint, then the rest of the ordered list.
        The index sticks to whichever endpoint answered, so after a
        failover every new request lands on the promoted primary."""
        with self._state_lock:
            candidates = [
                self._endpoints[(self._ep_i + k) % len(self._endpoints)]
                for k in range(len(self._endpoints))
            ]
        last_exc: Optional[OSError] = None
        for endpoint in candidates:
            if _FP_CONNECT.armed:
                try:
                    _FP_CONNECT.fire(endpoint=endpoint)  # ChaosDrop is an OSError
                except OSError as exc:
                    last_exc = exc
                    continue
            ip, port = split_endpoint(endpoint)
            try:
                sock = socket.create_connection((ip, port), timeout=self._timeout)
            except OSError as exc:
                last_exc = exc
                continue
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(None)
            with self._state_lock:
                if self._closed:
                    sock.close()
                    raise EdlConnectionError("client closed")
                self._sock = sock
                if endpoint in self._endpoints:
                    self._ep_i = self._endpoints.index(endpoint)
            receiver = threading.Thread(
                target=self._receive_loop, args=(sock,),
                name="edl-store-recv", daemon=True,
            )
            receiver.start()
            return
        raise last_exc if last_exc is not None else OSError("no endpoints")

    def _receive_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                frame = read_frame_blocking(sock)
                if "w" in frame:
                    self._event_queue.put(("events", frame["w"], frame["ev"]))
                elif "wb" in frame:
                    # batched fan-out: one frame carrying deliveries for
                    # several of this connection's watches (the server
                    # coalesces per-connection to cut frame rate)
                    for wid, evs in frame["wb"]:
                        self._event_queue.put(("events", wid, evs))
                else:
                    with self._state_lock:
                        pending = self._pending.pop(frame.get("i"), None)
                    if pending is not None:
                        pending.response = frame
                        pending.done.set()
        except (ConnectionError, OSError) as exc:
            self._on_disconnect(sock, exc)

    def _on_disconnect(
        self, sock: socket.socket, exc: Exception, advance: bool = False
    ) -> None:
        with self._state_lock:
            if self._sock is not sock:
                return  # stale receiver from a previous connection
            self._sock = None
            if advance:
                # the endpoint answered but cannot serve (standby, fenced,
                # stale epoch): start the next dial one slot further on.
                # Inside the stale-receiver guard, so concurrent failures
                # of one connection advance exactly once.
                self._ep_i = (self._ep_i + 1) % len(self._endpoints)
                _M_FAILOVERS.inc()
            dropped = list(self._pending.values())
            self._pending.clear()
        for pending in dropped:
            pending.done.set()  # response stays None -> EdlConnectionError
        try:
            sock.close()
        except OSError:
            pass
        if self._closed or not self._reconnect_enabled:
            return
        with self._state_lock:
            if self._reconnecting:
                return  # one reconnect owner at a time; it laps until healthy
            self._reconnecting = True
        logger.warning("store connection lost (%s); reconnecting", exc)
        threading.Thread(
            target=self._reconnect_loop, name="edl-store-reconnect", daemon=True
        ).start()

    def _reconnect_loop(self) -> None:
        """Re-dial until a SERVING member answers. One lap = connect
        (walking the endpoint ring) + resume watches + refresh the
        endpoint list; a lap that lands on a standby or a fenced store
        bounces (the failed request advanced the ring) and goes again —
        damped, so cycling the ring while a standby promotes doesn't
        spin."""
        while True:
            try:
                retry_call(
                    self._connect,
                    what="store.reconnect",
                    retry_on=(OSError,),
                    base_delay=0.1,
                    max_delay=2.0,
                    give_up=lambda: self._closed,
                )
            except (OSError, EdlConnectionError):
                with self._state_lock:
                    self._reconnecting = False
                return  # gave up: the client was closed mid-retry
            if self._closed:
                with self._state_lock:
                    self._reconnecting = False
                return
            logger.info("store connection re-established (%s)", self._endpoint)
            resumed = self._resume_watches()
            if resumed:
                self._refresh_endpoints()
            with self._state_lock:
                # exit only once a FULL resume pass landed on a live
                # socket — a bounced resume (standby, fence, injected
                # blip) laps even if the socket itself survived. The flag
                # clears under the same lock _on_disconnect consults, so
                # a disconnect racing this exit either sees a live socket
                # (and spawns a fresh owner when it kills it) or keeps
                # this owner lapping.
                if self._closed or (resumed and self._sock is not None):
                    self._reconnecting = False
                    return
            time.sleep(0.1)

    def _resume_watches(self) -> bool:
        with self._state_lock:
            watches = [w for w in self._watches.values() if not w.cancelled]
        for watch in watches:
            try:
                self._start_watch(watch, resume=True)
            except EdlConnectionError as exc:
                # link died again mid-resume — or this member can't serve
                # (standby/fenced: request() already advanced the ring);
                # the watch stays registered and the next lap retries the
                # whole set
                logger.warning(
                    "resume of watch %s bounced (%s)", watch.prefix, exc
                )
                return False
            except EdlStoreError as exc:
                logger.warning("failed to resume watch %s: %s", watch.prefix, exc)
        return True

    def _refresh_endpoints(self) -> None:
        """Refresh the ordered endpoint list from the connected member's
        ``/store/endpoints/`` keyspace (slot order = promotion order).
        Seed endpoints never drop off the end: a stale keyspace must not
        strand the client with no dial candidates. Best-effort."""
        self._last_refresh = time.monotonic()
        try:
            rows, _rev = self.range(replica_mod.ENDPOINTS_PREFIX)
        except EdlStoreError:
            return
        fresh = replica_mod.parse_endpoint_rows(rows)
        if not fresh:
            return
        with self._state_lock:
            current = self._endpoints[self._ep_i % len(self._endpoints)]
            merged = fresh + [e for e in self._endpoints if e not in fresh]
            self._endpoints = merged
            self._ep_i = (
                merged.index(current) if current in merged else 0
            )

    def close(self) -> None:
        with self._state_lock:
            self._closed = True
            sock, self._sock = self._sock, None
            dropped = list(self._pending.values())
            self._pending.clear()
            leg, self._standby_leg_client = self._standby_leg_client, None
        if leg is not None:
            leg.close()
        for pending in dropped:
            pending.done.set()  # fail fast instead of riding out the timeout
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        self._event_queue.put(None)
        if self._tape is not None:
            self._tape.close()  # idempotent: a leg shares its owner's tape

    # -- request plumbing --------------------------------------------------

    def request(self, method: str, timeout: Optional[float] = None, **params) -> dict:
        tape = self._tape
        if tape is None or method not in _OpTape.OPS:
            return self._request_raw(method, timeout, **params)
        t0 = time.time()
        try:
            resp = self._request_raw(method, timeout, **params)
        except Exception as exc:
            tape.fail(self, method, params, exc, t0)
            raise
        tape.ok(self, method, params, resp, t0)
        return resp

    def _request_raw(
        self, method: str, timeout: Optional[float] = None, **params
    ) -> dict:
        if _FP_REQUEST.armed:
            try:
                _FP_REQUEST.fire(method=method)
            except ConnectionError as exc:
                raise EdlConnectionError("chaos: %s" % exc) from exc
        rid = next(self._ids)
        payload = {"i": rid, "m": method}
        payload.update(params)
        # distributed tracing: stamp the caller's span into the frame so
        # the server's handling span is OUR child. Disarmed cost is one
        # attribute load per request (fault-point/counter discipline).
        if _TC.armed and TC_FIELD not in payload:
            tc = _obs_trace.inject()
            if tc is not None:
                payload[TC_FIELD] = tc
        pending = _Pending()
        t0 = time.monotonic()
        with self._state_lock:
            sock = self._sock
            if sock is None:
                raise EdlConnectionError("store not connected")
            self._pending[rid] = pending
        try:
            with self._send_lock:
                sock.sendall(pack_frame(payload))
        except OSError as exc:
            with self._state_lock:
                self._pending.pop(rid, None)
            self._on_disconnect(sock, exc)  # a dead send means a dead link
            raise EdlConnectionError("send failed: %s" % exc) from exc
        if not pending.done.wait(timeout if timeout is not None else self._timeout):
            with self._state_lock:
                self._pending.pop(rid, None)
            raise EdlConnectionError("store request %r timed out" % method)
        resp = pending.response
        if resp is None:
            raise EdlConnectionError("connection lost awaiting %r" % method)
        _M_ROUNDTRIP.observe(time.monotonic() - t0, method=method)
        # epoch fencing: every response carries the server's fencing
        # epoch. A LOWER epoch than one we've already seen identifies a
        # resurrected stale primary — refuse it and fail over, even if it
        # happily "served" the request.
        epoch = resp.get("e")
        if epoch is not None:
            with self._state_lock:
                known = self._epoch
                if epoch > known:
                    self._epoch = epoch
            if epoch < known:
                self._on_disconnect(
                    sock,
                    EdlFencedError("stale epoch %d < %d" % (epoch, known)),
                    advance=True,
                )
                raise EdlFencedError(
                    "store at %s answered with stale epoch %d (cluster is "
                    "at %d); failing over" % (self._endpoint, epoch, known)
                )
        if not resp.get("ok"):
            exc = deserialize_exception(resp.get("err", {}))
            if isinstance(exc, (EdlNotPrimaryError, EdlFencedError)):
                if (
                    params.get("rm") == "s"
                    and isinstance(exc, EdlNotPrimaryError)
                ):
                    # a standby-serving refusal (lag bound, session
                    # floor, bootstrap) is a routine fall-through, not a
                    # dead member: keep the link, the owner retries the
                    # read against the primary
                    raise exc
                # this member answered but cannot serve: advance to the
                # next endpoint so the retry (every caller of the Edl
                # retry family) lands on the primary
                self._on_disconnect(sock, exc, advance=True)
            raise exc
        self._note_rev(resp.get("r"))
        if (
            method != "range"  # the refresh's own request must not recurse
            and time.monotonic() - self._last_refresh > _ENDPOINT_REFRESH_S
        ):
            self._last_refresh = time.monotonic()
            threading.Thread(
                target=self._refresh_endpoints,
                name="edl-store-refresh", daemon=True,
            ).start()
        return resp

    def retrying(self, method: str, retries: int = 30, **params) -> dict:
        """Retry an idempotent request across reconnects."""
        return retry_call(
            lambda: self.request(method, **params),
            what="store.request",
            retry_on=(EdlConnectionError,),
            retries=max(0, retries - 1),
            base_delay=0.05,
            max_delay=1.0,
            give_up=lambda: self._closed,
        )

    # -- standby read leg (read_mode="standby") ----------------------------

    def _note_rev(self, r) -> None:
        """Raise the session floor: the highest revision any response on
        this session reported. Standby reads carry it as ``minr``."""
        if isinstance(r, int):
            with self._state_lock:
                if r > self._min_rev:
                    self._min_rev = r

    def _standby_leg(self) -> Optional["_StandbyLegClient"]:
        """The (lazily dialed) read-serving connection to a standby
        member. None when leader mode, no standby candidates exist, or
        the last dial failed recently (damped)."""
        if self.read_mode != "standby" or self._closed:
            return None
        with self._state_lock:
            if self._standby_leg_client is not None:
                return self._standby_leg_client
            if time.monotonic() - self._leg_failed_at < 2.0:
                return None
            primary = self._endpoints[self._ep_i % len(self._endpoints)]
            cands = [e for e in self._endpoints if e != primary]
            rot = self._leg_rot % len(cands) if cands else 0
        if not cands:
            return None
        cands = cands[rot:] + cands[:rot]
        try:
            leg = _StandbyLegClient(cands, self, self._timeout)
        except (OSError, EdlConnectionError):
            with self._state_lock:
                self._leg_failed_at = time.monotonic()
            return None
        with self._state_lock:
            if self._standby_leg_client is None and not self._closed:
                self._standby_leg_client = leg
                return leg
            keep = self._standby_leg_client
        leg.close()  # lost a concurrent dial race (or the client closed)
        return keep

    def _drop_leg(self, rotate: bool = False) -> None:
        with self._state_lock:
            leg, self._standby_leg_client = self._standby_leg_client, None
            self._leg_misses = 0
            if rotate:
                self._leg_rot += 1
        if leg is not None:
            leg.close()

    def _read(self, method: str, **params) -> dict:
        """get/range through the read path: standby mode tries the leg
        first and falls through to the primary on any refusal or leg
        fault — the contract is 'never worse than leader mode, at most
        one extra round-trip'."""
        if self.read_mode == "standby":
            leg = self._standby_leg()
            if leg is not None:
                try:
                    resp = leg.request(method, **params)
                    self._leg_misses = 0
                    return resp
                except EdlConnectionError:
                    self._drop_leg()  # dead leg: rebuilt (damped) next read
                except EdlStoreError:
                    # refused (lag / session floor / bootstrapping member):
                    # a member that refuses every read for a long stretch
                    # earns a rotation to the next standby candidate
                    self._leg_misses += 1
                    if self._leg_misses >= 32:
                        self._drop_leg(rotate=True)
                _M_STANDBY_FALLTHROUGH.inc()
            # the fall-through carries the session floor too: the leg may
            # have answered at the standby's APPLIED revision a beat
            # before the primary processed the ack that releases it — the
            # primary clamps its read up to ``minr`` so this session
            # never watches its own history rewind by one round-trip
            params.setdefault("minr", self._min_rev)
        return self.request(method, **params)

    # -- KV API ------------------------------------------------------------

    def put(self, key: str, value: bytes, lease: int = 0) -> int:
        return self.request("put", k=key, v=value, l=lease)["r"]

    def put_if_absent(
        self, key: str, value: bytes, lease: int = 0
    ) -> Tuple[bool, Optional[bytes]]:
        resp = self.request("put_absent", k=key, v=value, l=lease)
        return resp["created"], resp.get("cur")

    def cas(self, key: str, expect_mod_rev: int, value: bytes, lease: int = 0) -> bool:
        return self.request("cas", k=key, er=expect_mod_rev, v=value, l=lease)["swapped"]

    def get(self, key: str, rev: Optional[int] = None) -> Optional[bytes]:
        params = {"k": key}
        if rev is not None:
            params["rev"] = rev  # MVCC pin: the key's state AS OF rev
        return self._read("get", **params)["v"]

    def get_with_rev(self, key: str) -> Tuple[Optional[bytes], int]:
        resp = self._read("get", k=key)
        return resp["v"], resp.get("mr", 0)

    def range(
        self, prefix: str, rev: Optional[int] = None
    ) -> Tuple[List[Tuple[str, bytes, int, int]], int]:
        params = {"p": prefix}
        if rev is not None:
            params["rev"] = rev  # snapshot-coherent: every row AS OF rev
        resp = self._read("range", **params)
        return [tuple(kv) for kv in resp["kvs"]], resp["r"]

    def delete(self, key: str) -> bool:
        return self.request("del", k=key)["deleted"] > 0

    def delete_range(self, prefix: str) -> int:
        return self.request("del_range", p=prefix)["deleted"]

    # -- leases ------------------------------------------------------------

    def lease_grant(self, ttl: float) -> int:
        return self.request("lease_grant", ttl=ttl)["lease"]

    def lease_keepalive(self, lease: int) -> bool:
        return self.request("lease_keepalive", lease=lease)["alive"]

    def lease_keepalive_batch(self, leases: Sequence[int]) -> List[bool]:
        """Renew many leases in ONE RPC (the renew coalescer's op): the
        per-lease keepalive stream was the client side's dominant
        control-plane QPS at scale."""
        resp = self.request("lease_renew_batch", ls=list(leases))
        return [bool(a) for a in resp["alive"]]

    def lease_revoke(self, lease: int) -> None:
        self.request("lease_revoke", lease=lease)

    def _lease_renewer(self) -> "_LeaseRenewer":
        """The per-client renew coalescer every LeaseKeeper registers
        with (lazily created; one thread and one batched RPC per tick
        for ALL of this client's leases)."""
        with self._state_lock:
            if self._renewer is None:
                self._renewer = _LeaseRenewer(self)
            return self._renewer

    # -- watches -----------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: Callable[[List[Event]], None],
        start_rev: Optional[int] = None,
    ) -> Watch:
        """Watch a prefix; ``callback(events)`` runs on a dispatcher thread.

        ``start_rev`` replays history after that revision first (pair it
        with ``range()``'s returned revision for a gapless read-then-watch).
        After a reconnect the watch resumes from the last delivered
        revision; if the server compacted past it, the callback receives a
        single ``Event(type='resync', key=prefix, rev=current)`` and the
        consumer should re-read current state via ``range``.

        In standby read mode the whole watch — registration, fan-out,
        reconnect resume — rides the read leg: the standby pushes events
        at apply time (applied == released there), and a leg failover
        resumes from the last delivered revision like any reconnect.
        """
        if self.read_mode == "standby":
            leg = self._standby_leg()
            if leg is not None:
                try:
                    return leg.watch(prefix, callback, start_rev=start_rev)
                except EdlStoreError:
                    _M_STANDBY_FALLTHROUGH.inc()
        watch = Watch(self, next(self._ids), prefix, callback)
        if start_rev is not None:
            watch.last_rev = start_rev
        with self._state_lock:
            self._watches[watch.wid] = watch
        try:
            self._start_watch(watch, resume=False)
        except EdlStoreError:
            with self._state_lock:
                self._watches.pop(watch.wid, None)
            raise
        if self._tape is not None:
            # deliveries begin after start_rev when given, else after the
            # registration high-water mark — the gap checker's floor
            self._tape.watch_start(
                self, watch.wid, prefix,
                start_rev if start_rev is not None else (watch.last_rev or 0),
            )
        return watch

    def _start_watch(self, watch: Watch, resume: bool) -> None:
        params = {"p": watch.prefix, "wid": watch.wid}
        if watch.last_rev is not None:
            params["r"] = watch.last_rev
        try:
            resp = self.request("watch", **params)
        except EdlCompactedError:
            # history compacted past our resume point: restart fresh and
            # hand the consumer a resync marker (delivered through the
            # dispatcher queue so callback ordering is preserved)
            resp = self.request("watch", p=watch.prefix, wid=watch.wid)
            self._event_queue.put(
                (
                    "events",
                    watch.wid,
                    [Event(RESYNC, watch.prefix, None, resp["r"]).to_wire()],
                )
            )
        # any backlog arrives as an ordered push frame; the dispatcher takes
        # the max, so advancing to the server's revision here is safe
        watch.last_rev = max(watch.last_rev or 0, resp["r"])

    def _cancel_watch(self, watch: Watch) -> None:
        with self._state_lock:
            self._watches.pop(watch.wid, None)
        try:
            self.request("unwatch", wid=watch.wid)
        except EdlStoreError:
            pass

    def _dispatch_loop(self) -> None:
        while True:
            item = self._event_queue.get()
            if item is None:
                return
            _, wid, raw_events = item
            with self._state_lock:
                watch = self._watches.get(wid)
            if watch is None or watch.cancelled:
                continue
            events = [Event.from_wire(d) for d in raw_events]
            if events:
                watch.last_rev = max(watch.last_rev or 0, events[-1].rev)
                if self._tape is not None:
                    self._tape.watch_events(self, watch.wid, events)
                try:
                    watch.callback(events)
                except Exception:  # noqa: BLE001 — a consumer bug must not kill dispatch
                    logger.exception("watch callback failed for %s", watch.prefix)


class _StandbyLegClient(StoreClient):
    """The read-serving leg of a ``read_mode="standby"`` client: a plain
    StoreClient pointed at the standby members whose reads opt into
    standby serving ("rm": "s") and carry the OWNER's session floor
    ("minr"), so the standby refuses — and the owner falls through to
    the primary — rather than answer below anything this session already
    observed. Revisions it sees raise the owner's floor too: the session
    contract spans both legs. Against a server that predates these
    fields the opt-in is never honored (the standby keeps bouncing reads
    with EdlNotPrimaryError), so degradation is the plain fall-through
    path, not an error."""

    _READ_OPS = ("get", "range", "watch", "unwatch")

    def __init__(self, endpoints, owner: StoreClient, timeout: float) -> None:
        self._owner = owner  # before super(): dialing refreshes via range()
        self._tape = owner._tape  # one SESSION tape spans both legs
        super().__init__(endpoints, timeout=timeout, reconnect=True)

    def request(self, method: str, timeout: Optional[float] = None, **params) -> dict:
        if method in self._READ_OPS:
            params.setdefault("rm", "s")
            params.setdefault("minr", self._owner._min_rev)
        resp = super().request(method, timeout, **params)
        self._owner._note_rev(resp.get("r"))
        return resp


class _RenewEntry:
    __slots__ = ("lease", "ttl", "interval", "on_lost", "next_due", "missed_s")

    def __init__(self, lease: int, ttl: float, on_lost) -> None:
        self.lease = lease
        self.ttl = ttl
        self.interval = max(ttl / 3.0, 0.05)
        self.on_lost = on_lost
        self.next_due = time.monotonic() + self.interval
        self.missed_s = 0.0


class _LeaseRenewer:
    """One renew loop per client, coalescing EVERY registered lease's
    keepalive into a single batched ``lease_renew_batch`` RPC per tick.

    The pre-shard design ran one keepalive thread + one RPC stream per
    lease; with thousands of registrations per connection the renew
    stream alone dominated store QPS (the per-method
    ``edl_rpc_server_seconds`` made that measurable). Falls back to
    per-lease ``lease_keepalive`` against servers that predate the
    batch op (the native C++ twin)."""

    def __init__(self, client) -> None:
        self._client = client
        self._lock = threading.Lock()
        self._entries: Dict[int, _RenewEntry] = {}  # edl: guarded-by(_lock)
        self._wake = threading.Event()
        self._batch_ok = True  # flips off after an unknown-method error
        self._thread = threading.Thread(
            target=self._run, name="edl-lease-renewer", daemon=True
        )
        self._thread.start()

    def add(self, lease: int, ttl: float, on_lost) -> None:
        with self._lock:
            self._entries[lease] = _RenewEntry(lease, ttl, on_lost)
        self._wake.set()

    def remove(self, lease: int) -> None:
        with self._lock:
            self._entries.pop(lease, None)

    def _run(self) -> None:
        while not getattr(self._client, "_closed", False):
            now = time.monotonic()
            with self._lock:
                # coalescing is the point: when the soonest entry comes
                # due, sweep in everything due within a horizon of ~1/3
                # of its own interval — renewing slightly early is free
                # (keepalive just restarts the TTL window) and it phase-
                # locks staggered registrations into ONE batch per tick
                # instead of a per-entry drizzle of tiny RPCs
                due = [
                    e for e in self._entries.values()
                    if e.next_due <= now + e.interval / 3.0
                ]
                if due and not any(e.next_due <= now for e in due):
                    due = []
                next_due = min(
                    (e.next_due for e in self._entries.values()),
                    default=now + 0.5,
                )
            if due:
                self._renew(due, now)
                with self._lock:
                    next_due = min(
                        (e.next_due for e in self._entries.values()),
                        default=now + 0.5,
                    )
            self._wake.wait(timeout=min(0.5, max(0.02, next_due - time.monotonic())))
            self._wake.clear()

    def _renew(self, due: List[_RenewEntry], now: float) -> None:
        lost: List[_RenewEntry] = []
        try:
            if self._batch_ok:
                alive = self._client.lease_keepalive_batch(
                    [e.lease for e in due]
                )
            else:
                alive = [
                    self._client.lease_keepalive(e.lease) for e in due
                ]
        except EdlConnectionError:
            # unreachable store: misses accumulate per lease; a lease is
            # only declared lost once the store stayed away past its TTL
            for e in due:
                e.missed_s += e.interval
                e.next_due = now + e.interval
                if e.missed_s >= e.ttl:
                    lost.append(e)
        except EdlStoreError as exc:
            if "unknown method" in str(exc) and self._batch_ok:
                logger.info(
                    "store predates lease_renew_batch; renewing per-lease"
                )
                self._batch_ok = False
                for e in due:
                    e.next_due = now  # retry immediately, uncoalesced
                return
            for e in due:
                e.next_due = now + e.interval
        else:
            for e, ok in zip(due, alive):
                e.missed_s = 0.0
                e.next_due = now + e.interval
                if not ok:
                    lost.append(e)
        for e in lost:
            with self._lock:
                # stop() may have raced the renew: only report a loss
                # for a lease still registered
                if self._entries.pop(e.lease, None) is None:
                    continue
            logger.warning("lease %d lost", e.lease)
            if e.on_lost is not None:
                try:
                    e.on_lost()
                except Exception:  # noqa: BLE001 — owner bugs must not kill renew
                    logger.exception("on_lost callback failed for %d", e.lease)


class LeaseKeeper:
    """Background keepalive for a lease; the liveness heartbeat primitive.

    Parity: the reference refreshes etcd leases from a refresher thread
    every ~ttl/3 and re-registers after transient death
    (python/edl/utils/register.py:120-129, discovery/register.py:57-76).
    ``on_lost`` fires if the lease expired server-side or the store stayed
    unreachable past the TTL — the owner must then re-register.

    Renewal is COALESCED: every keeper of one client registers with the
    client's shared :class:`_LeaseRenewer`, which issues one batched
    renew RPC per tick instead of one keepalive stream per lease.
    """

    def __init__(
        self,
        client,
        lease: int,
        ttl: float,
        on_lost: Optional[Callable[[], None]] = None,
    ) -> None:
        self._client = client
        self.lease = lease
        self._ttl = ttl
        self._renewer = client._lease_renewer()
        self._renewer.add(lease, ttl, on_lost)

    def stop(self, revoke: bool = False) -> None:
        self._renewer.remove(self.lease)
        if revoke:
            try:
                self._client.lease_revoke(self.lease)
            except EdlStoreError:
                pass


class _ShardedWatch:
    """Handle for a fan-out watch spanning every shard."""

    def __init__(self, prefix: str, watches: List[Watch]) -> None:
        self.prefix = prefix
        self._watches = watches
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True
        for w in self._watches:
            w.cancel()


class _VLease:
    """A virtual lease: granted lazily, per shard, on first use. The
    registry's grant-then-put idiom cannot know which shard the key
    will route to, so the sharded client hands out a VIRTUAL id and
    realizes a real lease on each shard the id actually touches."""

    __slots__ = ("vid", "ttl", "real")

    def __init__(self, vid: int, ttl: float) -> None:
        self.vid = vid
        self.ttl = ttl
        self.real: Dict[str, int] = {}  # shard name -> real lease id


class ShardedStoreClient:
    """Routes the StoreClient API across a consistent-hash-partitioned
    shard fleet (DESIGN.md "Sharded control plane").

    - keys route by their first-two-component token on the ring
      (``shard.route_token``), so a service's keys — and its
      read-then-watch revision sequence — live on ONE shard;
    - ranges/watches whose prefix pins the token are single-shard
      passthroughs; shorter prefixes fan out to every shard and merge
      (fan-out ``range`` revisions are NOT watch-resumable — pass
      ``start_rev`` only with a token-pinned prefix);
    - leases are virtual: realized per shard on first key attach,
      renewed via one batched renew RPC per shard per tick;
    - each per-shard client keeps its own ordered endpoint list,
      failover lap, and fencing-epoch horizon — per-shard failover
      needs no shard-map update.

    Use :func:`connect_store` to build one from a seed endpoint: it
    reads the replicated ``/store/shards/`` map and returns a plain
    StoreClient when the deployment is unsharded.
    """

    def __init__(
        self,
        shards: Sequence[Tuple[str, Sequence[str]]],
        timeout: float = 10.0,
        reconnect: bool = True,
        seed: Optional[StoreClient] = None,
        read_mode: str = "leader",
        op_tape_dir: Optional[str] = None,
    ) -> None:
        from edl_tpu_torch.discovery.consistent_hash import ConsistentHash

        if not shards:
            raise ValueError("ShardedStoreClient needs at least one shard")
        self._timeout = timeout
        self._closed = False
        self.read_mode = read_mode
        self._clients: Dict[str, StoreClient] = {}
        self._meta_name = shards[0][0]
        names = []
        for name, endpoints in shards:
            names.append(name)
            if (
                seed is not None
                and seed._endpoint in endpoints
                and seed.read_mode == read_mode
            ):
                self._clients[name] = seed
                seed = None
                continue
            self._clients[name] = StoreClient(
                endpoints, timeout=timeout, reconnect=reconnect,
                read_mode=read_mode, op_tape_dir=op_tape_dir,
            )
        if seed is not None:
            seed.close()  # the seed member is not in the map (stale seed)
        self._ring = ConsistentHash(names)
        self._lease_lock = threading.Lock()
        self._vleases: Dict[int, _VLease] = {}  # edl: guarded-by(_lease_lock)
        self._vids = itertools.count(1)
        self._renewer: Optional[_LeaseRenewer] = None
        self._state_lock = threading.Lock()  # _lease_renewer() shares the idiom

    # -- topology ----------------------------------------------------------

    @property
    def num_shards(self) -> int:
        return len(self._clients)

    @property
    def shard_names(self) -> List[str]:
        return sorted(self._clients)

    @property
    def _endpoint(self) -> str:
        """The meta shard's current endpoint (logging, tests)."""
        return self._clients[self._meta_name]._endpoint

    def shard_of(self, key: str) -> str:
        token = shard_mod.route_token(key)
        if token is None:
            return self._meta_name
        return self._ring.get_node(token) or self._meta_name

    def client_for(self, name: str) -> StoreClient:
        return self._clients[name]

    def _route(self, key: str) -> Tuple[str, StoreClient]:
        name = self.shard_of(key)
        return name, self._clients[name]

    # -- request plumbing (retrying() parity with StoreClient) -------------

    def request(self, method: str, timeout: Optional[float] = None, **params) -> dict:
        if method in ("put", "put_absent", "cas"):
            name, client = self._route(params["k"])
            lease = params.get("l", 0)
            if lease:
                params = dict(params, l=self._real_lease(name, client, lease))
            return client.request(method, timeout, **params)
        if method in ("get", "del"):
            _, client = self._route(params["k"])
            return client.request(method, timeout, **params)
        if method == "range":
            rows, rev = self.range(params["p"])
            return {"ok": True, "kvs": [list(r) for r in rows], "r": rev}
        if method == "del_range":
            return {"ok": True, "deleted": self.delete_range(params["p"])}
        if method in ("ping", "state"):
            return self._clients[self._meta_name].request(
                method, timeout, **params
            )
        raise EdlStoreError(
            "method %r is not routable through a sharded client" % method
        )

    def retrying(self, method: str, retries: int = 30, **params) -> dict:
        """Retry an idempotent request across reconnects."""
        return retry_call(
            lambda: self.request(method, **params),
            what="store.request",
            retry_on=(EdlConnectionError,),
            retries=max(0, retries - 1),
            base_delay=0.05,
            max_delay=1.0,
            give_up=lambda: self._closed,
        )

    # -- KV API ------------------------------------------------------------

    def put(self, key: str, value: bytes, lease: int = 0) -> int:
        return self.request("put", k=key, v=value, l=lease)["r"]

    def put_if_absent(
        self, key: str, value: bytes, lease: int = 0
    ) -> Tuple[bool, Optional[bytes]]:
        resp = self.request("put_absent", k=key, v=value, l=lease)
        return resp["created"], resp.get("cur")

    def cas(self, key: str, expect_mod_rev: int, value: bytes, lease: int = 0) -> bool:
        return self.request(
            "cas", k=key, er=expect_mod_rev, v=value, l=lease
        )["swapped"]

    def get(self, key: str, rev: Optional[int] = None) -> Optional[bytes]:
        # through the shard client's public get: the standby read leg
        # (read_mode="standby") only rides the read API, not raw request()
        _, client = self._route(key)
        return client.get(key, rev=rev)

    def get_with_rev(self, key: str) -> Tuple[Optional[bytes], int]:
        _, client = self._route(key)
        return client.get_with_rev(key)

    def range(
        self, prefix: str, rev: Optional[int] = None
    ) -> Tuple[List[Tuple[str, bytes, int, int]], int]:
        single, token = shard_mod.route_prefix(prefix)
        if single:
            client = (
                self._clients[self._meta_name] if token is None
                else self._route_token(token)
            )
            return client.range(prefix, rev=rev)
        if rev is not None:
            # shard revision sequences are independent: one pin cannot
            # mean the same instant on every shard (same rule as watch
            # resume below)
            raise ValueError(
                "rev= needs a token-pinned prefix: %r spans shards" % prefix
            )
        rows: List[Tuple[str, bytes, int, int]] = []
        rev = 0
        for client in self._clients.values():
            shard_rows, shard_rev = client.range(prefix)
            rows.extend(shard_rows)
            rev = max(rev, shard_rev)
        rows.sort(key=lambda r: r[0])
        # NOTE: a fan-out revision spans independent shard sequences —
        # it orders nothing and must not seed a watch resume
        return rows, rev

    def delete(self, key: str) -> bool:
        return self.request("del", k=key)["deleted"] > 0

    def delete_range(self, prefix: str) -> int:
        single, token = shard_mod.route_prefix(prefix)
        if single:
            client = (
                self._clients[self._meta_name] if token is None
                else self._route_token(token)
            )
            return client.delete_range(prefix)
        return sum(c.delete_range(prefix) for c in self._clients.values())

    def _route_token(self, token: str) -> StoreClient:
        name = self._ring.get_node(token) or self._meta_name
        return self._clients[name]

    # -- leases (virtual; see _VLease) -------------------------------------

    def lease_grant(self, ttl: float) -> int:
        vid = next(self._vids)
        with self._lease_lock:
            self._vleases[vid] = _VLease(vid, float(ttl))
        return vid

    def _real_lease(self, shard: str, client: StoreClient, vid: int) -> int:
        with self._lease_lock:
            entry = self._vleases.get(vid)
            if entry is None:
                raise EdlStoreError("lease %d not found" % vid)
            real = entry.real.get(shard)
            ttl = entry.ttl
        if real is not None:
            return real
        granted = client.lease_grant(ttl)  # network op OUTSIDE the lock
        with self._lease_lock:
            entry = self._vleases.get(vid)
            if entry is None:
                revoke = True  # revoked while we were granting
            else:
                real = entry.real.setdefault(shard, granted)
                revoke = real != granted  # lost a concurrent grant race
        if revoke:
            try:
                client.lease_revoke(granted)
            except EdlStoreError:
                pass
            if entry is None:
                raise EdlStoreError("lease %d not found" % vid)
        return real

    def _reals(self, vid: int) -> Optional[List[Tuple[str, int]]]:
        with self._lease_lock:
            entry = self._vleases.get(vid)
            if entry is None:
                return None
            return list(entry.real.items())

    def lease_keepalive(self, lease: int) -> bool:
        reals = self._reals(lease)
        if reals is None:
            return False
        # alive only if EVERY shard-local part is alive: a shard that
        # expired its part already deleted that shard's keys, and the
        # owner must re-register
        alive = all(
            self._clients[shard].lease_keepalive(real)
            for shard, real in reals
        )
        if not alive:
            self._forget_vlease(lease)
        return alive

    def _forget_vlease(self, vid: int) -> None:
        """A lease reported dead is forgotten: the owner re-registers
        with a fresh grant, and keeping the stale entry would both leak
        the dict (registration churn over days) and keep renewing dead
        real ids."""
        with self._lease_lock:
            self._vleases.pop(vid, None)

    def lease_keepalive_batch(self, leases: Sequence[int]) -> List[bool]:
        """One renew RPC per SHARD per tick, regardless of lease count.

        Per-shard fault isolation: an unreachable shard defers ITS
        leases (reported alive — they resolve for real once that shard
        answers again, and a promoted standby resets lease clocks
        anyway) instead of letting one shard's outage count misses
        against every lease on the healthy shards. Only when EVERY
        probed shard is unreachable does the call raise, so the
        renewer's whole-store-down TTL accounting still runs."""
        per_shard: Dict[str, List[Tuple[int, int]]] = {}
        alive = {}
        for vid in leases:
            reals = self._reals(vid)
            if reals is None:
                alive[vid] = False
                continue
            alive[vid] = True  # no realized parts yet = nothing to lose
            for shard, real in reals:
                per_shard.setdefault(shard, []).append((vid, real))
        errors = 0
        for shard, pairs in per_shard.items():
            client = self._clients[shard]
            try:
                oks = client.lease_keepalive_batch([r for _, r in pairs])
            except EdlConnectionError:
                errors += 1
                continue  # defer this shard's verdicts
            except EdlStoreError:
                try:
                    oks = [client.lease_keepalive(r) for _, r in pairs]
                except EdlConnectionError:
                    errors += 1
                    continue
            for (vid, _real), ok in zip(pairs, oks):
                alive[vid] = alive[vid] and bool(ok)
        if per_shard and errors == len(per_shard):
            raise EdlConnectionError(
                "no store shard reachable for lease renewal"
            )
        for vid, ok in alive.items():
            if not ok:
                self._forget_vlease(vid)
        return [alive[vid] for vid in leases]

    def lease_revoke(self, lease: int) -> None:
        with self._lease_lock:
            entry = self._vleases.pop(lease, None)
        if entry is None:
            return
        for shard, real in entry.real.items():
            try:
                self._clients[shard].lease_revoke(real)
            except EdlStoreError:
                pass

    def _lease_renewer(self) -> "_LeaseRenewer":
        with self._state_lock:
            if self._renewer is None:
                self._renewer = _LeaseRenewer(self)
            return self._renewer

    # -- watches -----------------------------------------------------------

    def watch(
        self,
        prefix: str,
        callback: Callable[[List[Event]], None],
        start_rev: Optional[int] = None,
    ):
        single, token = shard_mod.route_prefix(prefix)
        if single:
            client = (
                self._clients[self._meta_name] if token is None
                else self._route_token(token)
            )
            return client.watch(prefix, callback, start_rev=start_rev)
        if start_rev is not None:
            raise ValueError(
                "start_rev needs a token-pinned prefix: %r spans shards "
                "whose revision sequences are independent" % prefix
            )
        watches = [
            c.watch(prefix, callback) for c in self._clients.values()
        ]
        return _ShardedWatch(prefix, watches)

    def close(self) -> None:
        self._closed = True
        for client in self._clients.values():
            client.close()


def connect_store(
    endpoint: Union[str, Sequence[str]],
    timeout: float = 10.0,
    reconnect: bool = True,
    read_mode: str = "leader",
    op_tape_dir: Optional[str] = None,
):
    """Dial ``endpoint`` and return the right client for the deployment:
    a plain :class:`StoreClient` when the store is one replication group,
    a :class:`ShardedStoreClient` when a ``/store/shards/`` map (two or
    more shards) is published — topology discovery rides the same
    replicated keyspace mechanism as endpoint discovery.

    ``read_mode="standby"`` turns on standby read serving (per shard in
    a sharded deployment): see :class:`StoreClient`. ``op_tape_dir``
    arms the consistency history tape (chaos/consistency.py)."""
    client = StoreClient(
        endpoint, timeout=timeout, reconnect=reconnect, read_mode=read_mode,
        op_tape_dir=op_tape_dir,
    )
    try:
        # retried: a transient blip here must NOT silently decide the
        # topology — a worker that degrades to an unsharded client in a
        # sharded deployment pins every key to the seed shard and
        # becomes invisible to correctly-routed peers. A terminal
        # connection failure propagates to the caller like any dial
        # failure; only a server that genuinely cannot answer the map
        # read (no such thing today) falls back to unsharded.
        resp = client.retrying("range", retries=10, p=shard_mod.SHARDS_PREFIX)
        rows = [tuple(kv) for kv in resp["kvs"]]
    except EdlConnectionError:
        client.close()
        raise
    except EdlStoreError:
        return client  # can't read the map: behave exactly as before
    shards = shard_mod.parse_shard_rows(rows)
    if len(shards) <= 1:
        return client
    return ShardedStoreClient(
        shards, timeout=timeout, reconnect=reconnect, seed=client,
        read_mode=read_mode, op_tape_dir=op_tape_dir,
    )
