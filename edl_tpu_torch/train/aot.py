"""AOT resize ladder (memory plans) + cluster-shared compile-cache exchange.

The port of ``edl_tpu/train/aot.py``, with its store keys (``aot/{world}``,
``compile_cache/{pod}``), wire frames, fault points and ``edl_*`` names, so
a torch pod and a JAX pod of one job dedupe each other's rungs and serve
each other's cache entries.

**What changes on the card.** The port is eager: a DDP step has the same
per-rank shapes at every world (the ladder's contract keeps per-worker
rows constant), so no executable depends on the world, and nothing is
compiled ahead of a resize. What does depend on it is the step's memory
plan (and, under FSDP, the size of each shard). So the ladder's rung is a
*planner* (:func:`make_neighbor_planner`): from the live stage's measured
plan (``obs/memory.harvest_plan``) it builds each neighbour world's plan
and publishes it through ``MemoryPlane.harvest_rung`` under
``mem/plan/{world}``, where the launcher's fit gate and the scale plane
read it. The port's compile cache is the kernel-library directory
(``ops/_build.py``): libraries named by the hash of their sources, so
portable between hosts by construction. JAX's
``enable_portable_cache_keys`` re-keys XLA's cache to get that property;
it is XLA's and is not ported. ``instrument_compilation_cache``'s
counterpart is ``ops/_build``'s own count of each resolution
(``edl_train_compile_cache_events_total{kind}``, and the ``nvcc`` seconds
in ``edl_train_restage_compile_seconds``; :func:`cache_event_counts`).

**The AOT ladder** (:class:`AotLadder`). Once a stage reaches steady state
(first step done), a low-priority background thread plans the neighbour
world sizes — pods ±1 and ±2 inside the elastic window, nearest first.
Sizes are claimed through the store (leased while planning, permanent
``done:`` on success) so co-hosted pods never plan the same shape twice.
Ladder time is attributed to the ``aot_compile`` goodput state on its own
flight-recorder lane (component ``aot``). The rungs are the window's
neighbour worlds, as in the JAX ladder, with one departure: the JAX ladder
skips a grow that needs more devices than the live process can see, and
this one plans every rung of the window. A torch rank is not bound to a
device of its own (a card holds as many ranks as fit,
``train/context.group_backend``), so the plan, not a device count, says
whether a grow fits; ``world`` everywhere in this module counts
processes.

**The cache exchange** (:class:`CacheExchange` / :func:`pull_missing`):
each launcher publishes a sha256 digest manifest of its cache dir under
``compile_cache/{pod}`` and serves entry bytes over the wire protocol; a
restaging or newly joined pod diffs manifests against its local dir and
pulls what is missing — from ``train.init()`` (bounded, before the first
kernel load) and from the standby shell's activation path. A corrupted or
dropped pull degrades to a normal build, never a wedged worker: every
entry is digest-verified before an atomic rename into the cache dir, and
the whole pull is deadline-bounded and exception-contained (chaos point
``store.cache.exchange``).

Observability: ``edl_train_aot_compiles_total{outcome}``,
``edl_train_cache_exchange_bytes_total{dir}``, and ``aot`` / ``exchange``
flight records.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("train.aot")

AOT_SERVICE = "aot"                    # store claims: aot/{world}
MANIFEST_SERVICE = "compile_cache"     # store manifests: compile_cache/{pod}

_FP_COMPILE = _fault_point(
    "train.aot.compile",
    "one ladder compile: delay (slow speculative compile) or drop "
    "(compile fails; the ladder counts it and moves on)",
)
_FP_EXCHANGE = _fault_point(
    "store.cache.exchange",
    "one pulled cache entry: corrupt (digest mismatch -> entry skipped, "
    "resize degrades to a normal compile), delay, drop (peer unreachable "
    "mid-pull)",
)


class RungUnavailable(ValueError):
    """A ladder rung that can never be planned here — a permanent
    property of the model/window (a sharded dim not divisible over the
    neighbour mesh), distinct from a real failure."""


_M_AOT = obs_metrics.counter(
    "edl_train_aot_compiles_total",
    "speculative ladder compiles, by outcome (ok/failed/"
    "skipped_nonlocal/skipped_claimed/skipped_indivisible)",
)
_M_XCHG_BYTES = obs_metrics.counter(
    "edl_train_cache_exchange_bytes_total",
    "compile-cache entry bytes moved between pods, by dir (rx/tx)",
)


def cache_event_counts() -> Dict[str, int]:
    """Snapshot of {hit, miss, write} counts this process has seen: the
    kernel libraries' resolutions (``ops/_build.py``)."""
    from edl_tpu_torch.ops import _build

    return _build.cache_event_counts()


# -- the AOT ladder -----------------------------------------------------------

def aot_enabled() -> bool:
    """Ladder gate: on by default wherever a compile cache is armed;
    ``EDL_AOT=0`` disables."""
    return os.environ.get("EDL_AOT", "1") != "0"


def neighbor_worlds(
    world: int, nproc: int, min_nodes: int, max_nodes: int,
    depth: int = 2,
) -> List[int]:
    """The ladder's target world sizes: pods ±1..±depth inside the
    elastic window, nearest rung first, shrink before grow at equal
    distance."""
    nproc = max(1, nproc)
    pods = world // nproc
    if pods * nproc != world:
        return []
    out: List[int] = []
    for k in range(1, depth + 1):
        for target in (pods - k, pods + k):
            if min_nodes <= target <= max_nodes and target != pods:
                w = target * nproc
                if w not in out:
                    out.append(w)
    return out


class AotLadder:
    """Background planner for neighbour world sizes.

    ``compile_for(world)`` is supplied by the integration site (see
    :func:`make_neighbor_planner`); the ladder owns everything else: rung
    enumeration, feasibility, store claims, the low-priority thread,
    pacing, metrics, the ``aot_compile`` goodput lane and the
    ``train.aot.compile`` fault point.

    ``close()`` is cooperative: close joins briefly and abandons the
    daemon thread; a rung in flight becomes a counted outcome, never a
    crash.
    """

    def __init__(
        self,
        env,
        compile_for: Callable[[int], None],
        worlds: Optional[Sequence[int]] = None,
        client=None,
        delay: Optional[float] = None,
    ) -> None:
        self._env = env
        self._compile_for = compile_for
        if worlds is None:
            worlds = neighbor_worlds(
                env.world_size, env.nproc_per_node,
                env.min_nodes, env.max_nodes,
            )
        self._worlds = list(worlds)
        # guards _client create/close and the _compile_for release: the
        # ladder thread lazily dials the store / drops the closure while
        # close() runs on the training thread
        self._mu = threading.Lock()
        self._client = client  # edl: guarded-by(self._mu)
        self._owns_client = client is None
        # let the live stage settle before stealing cycles from it
        if delay is None:
            delay = float(os.environ.get("EDL_AOT_DELAY", "1.0"))
        self._delay = delay
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.compiled: List[int] = []
        # separate ledger + flight lane: the main thread keeps owning the
        # process's train/data_wait attribution; ladder seconds land in
        # aot_compile on a component="aot" lane
        from edl_tpu_torch.obs import goodput as obs_goodput

        self._ledger = obs_goodput.GoodputLedger(component="aot")

    def start(self) -> "AotLadder":
        if self._thread is None and self._worlds:
            self._thread = threading.Thread(
                target=self._run, name="edl-aot-ladder", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        # drop the (state, plan) closure even when the thread was
        # abandoned mid-rung: a hot restage keeps this process alive long
        # after the ladder is gone
        with self._mu:
            self._compile_for = None
            owns, client = self._owns_client, self._client
            if owns:
                self._client = None
        self._ledger.close(cause="ladder_close")
        if owns and client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass

    # -- store claims ------------------------------------------------------

    def _store(self):
        with self._mu:
            client = self._client
        endpoint = getattr(self._env, "store_endpoint", "")
        if client is not None or not endpoint:
            return client
        # dial OUTSIDE the lock: close() on the training thread's hot-
        # restage path takes _mu and must never wait behind this connect
        try:
            from edl_tpu_torch.store.client import StoreClient

            client = StoreClient(endpoint, timeout=5.0)
        except Exception as exc:  # noqa: BLE001
            logger.debug("aot: no store client (%s)", exc)
            return None
        with self._mu:
            if self._client is None:
                self._client = client
                return client
            existing = self._client
        try:
            client.close()  # lost a (theoretical) publish race
        except Exception:  # noqa: BLE001
            pass
        return existing

    def _claim(self, world: int):
        """Returns a held Registration, True (no store — lone pod, rank 0
        plans), or None (claimed/done elsewhere)."""
        client = self._store()
        if client is None:
            return True if self._env.global_rank == 0 else None
        from edl_tpu_torch.discovery.registry import Registry
        from edl_tpu_torch.utils.exceptions import EdlStoreError

        try:
            reg, _holder = Registry(
                client, self._env.job_id or "job"
            ).register_if_absent(
                AOT_SERVICE, str(world),
                ("%s.%d" % (self._env.pod_id, self._env.global_rank)).encode(),
                ttl=60.0,
            )
        except EdlStoreError:
            return None  # transient store trouble: drop the rung this pass
        return reg

    def _finish_claim(self, world: int, reg, ok: bool) -> None:
        if reg is True:
            return
        if ok:
            client = self._store()
            if client is not None:
                from edl_tpu_torch.discovery.registry import Registry
                from edl_tpu_torch.utils.exceptions import EdlStoreError

                try:
                    Registry(client, self._env.job_id or "job").set_permanent(
                        AOT_SERVICE, str(world),
                        b"done:" + self._env.pod_id.encode(),
                    )
                except EdlStoreError:
                    pass
            reg.stop(delete=False)
        else:
            reg.stop(delete=True)

    # -- the rung loop -----------------------------------------------------

    def _run(self) -> None:
        # the whole thread body is contained: speculation is "a counted
        # outcome, never a crash"
        try:
            self._run_inner()
        except Exception as exc:  # noqa: BLE001
            _M_AOT.inc(outcome="failed")
            logger.warning("aot: ladder aborted (%s)", exc)
        finally:
            with self._mu:
                self._compile_for = None

    def _run_inner(self) -> None:
        try:
            # best-effort thread-level niceness (Linux: a tid is a valid
            # PRIO_PROCESS target): the ladder must lose CPU arbitration
            # to the training step it runs beside
            os.setpriority(
                os.PRIO_PROCESS, threading.get_native_id(),
                int(os.environ.get("EDL_AOT_NICE", "10")),
            )
        except (AttributeError, OSError, ValueError):
            pass
        if self._stop.wait(timeout=self._delay):
            return
        deferred: List[int] = []
        for world in self._worlds:
            if self._stop.is_set():
                return
            if self._env.global_rank >= world:
                # the target stage excludes this rank (a surviving peer
                # whose rank is in it holds the work)
                _M_AOT.inc(outcome="skipped_nonlocal")
                continue
            reg = self._claim(world)
            if reg is None:
                _M_AOT.inc(outcome="skipped_claimed")
                deferred.append(world)
                continue
            self._compile_rung(world, reg)
        # second chance for rungs a peer had claimed: a FAILED peer rung
        # deletes its lease and writes no done marker
        for world in deferred:
            if self._stop.wait(timeout=self._RETRY_DELAY):
                return
            reg = self._claim(world)
            if reg is None:
                continue  # done, still in flight, or store trouble
            self._compile_rung(world, reg)

    _RETRY_DELAY = 5.0  # deferred-rung recheck (one peer rung's width)

    def _compile_rung(self, world: int, reg) -> None:
        compile_for = self._compile_for  # close() may null it under us
        if compile_for is None:
            self._finish_claim(world, reg, False)
            return
        ok = False
        indivisible = False
        t0 = time.monotonic()
        try:
            with self._ledger.phase("aot_compile", cause="w%d" % world):
                if _FP_COMPILE.armed:
                    _FP_COMPILE.fire(world=world)
                compile_for(world)
            ok = True
        except RungUnavailable as exc:
            indivisible = True
            logger.debug("aot: world=%d rung unavailable (%s)", world, exc)
        except Exception as exc:  # noqa: BLE001 — speculation never kills training
            logger.warning(
                "aot: rung for world=%d failed (%s)", world, exc,
            )
        finally:
            self._finish_claim(world, reg, ok)
        outcome = ("ok" if ok
                   else ("skipped_indivisible" if indivisible else "failed"))
        _M_AOT.inc(outcome=outcome)
        obs_events.record(
            "aot", fsync=True, component="aot", world=world,
            outcome=outcome, dur=round(time.monotonic() - t0, 3),
        )
        if ok:
            self.compiled.append(world)
            logger.info(
                "aot: world=%d planned ahead of time (%.3fs)",
                world, time.monotonic() - t0,
            )


# -- the planner ---------------------------------------------------------------

def mesh_shape(axes: Dict[str, int], world: int) -> Dict[str, int]:
    """``axes`` at ``world`` ranks, the one ``-1`` axis filled (as
    ``parallel.make_mesh`` fills it); ValueError when it cannot fill."""
    shape = dict(axes)
    fills = [k for k, v in shape.items() if v == -1]
    fixed = math.prod(v for v in shape.values() if v != -1)
    if fills:
        if world % fixed:
            raise ValueError("cannot fill %r: %d ranks / %d"
                             % (fills[0], world, fixed))
        shape[fills[0]] = world // fixed
    if math.prod(shape.values()) != world:
        raise ValueError("axes %r do not cover %d ranks" % (axes, world))
    return shape


def _local(t):
    """The tensor a rank holds: a ``DTensor``'s local shard."""
    return getattr(t, "_local_tensor", t)


def make_neighbor_planner(
    state,
    live_plan,
    mesh_axes: Optional[Dict[str, int]] = None,
    batch_axis: str = "dp",
    fsdp: bool = False,
    on_planned: Optional[Callable[[object, int], None]] = None,
):
    """Build the ``compile_for(world)`` callback for :class:`AotLadder`:
    the rung's memory plan, from the live stage's (the JAX package's
    ``make_neighbor_compiler``, whose rung is an XLA compile).

    ``temp`` is the live plan's: per-rank rows stay constant across
    worlds (the ladder's contract), so a step's activations do not move.
    ``argument`` is the state's bytes (the parameters and the optimizer's
    state, as ``obs.memory.state_bytes`` counts them) as the rung's mesh
    would hold them: under DDP the same; under FSDP each parameter and
    its optimizer-state twins at the rung's ``fsdp`` size, on the dim
    ``parallel.mesh.fsdp_placement`` picks there, padded as FSDP2 pads
    (rank 0's shard, the largest). A parameter whose JAX spec (its
    largest dim the live ``fsdp`` size divides) the rung's size does not
    divide raises :class:`RungUnavailable`, as the JAX rung does.
    ``on_planned(plan, world)`` publishes it (``MemoryPlane.harvest_rung``).
    """
    import torch

    from edl_tpu_torch.obs.memory import MemoryPlan, state_bytes
    from edl_tpu_torch.parallel.mesh import _fsdp_spec, fsdp_placement

    if live_plan is None:
        raise ValueError("no live memory plan to plan the rungs from")
    axes = dict(mesh_axes) if mesh_axes else {batch_axis: -1}
    live_fsdp = mesh_shape(axes, live_plan.world).get("fsdp", 1)
    module = state.apply_fn
    module = getattr(module, "module", module)  # DDP's model
    opt = getattr(getattr(state, "opt_state", None), "optimizer", None)
    # (global shape, element size, sharded like a parameter) per tensor
    tensors: List[Tuple[Tuple[int, ...], int, bool]] = []
    for p in module.parameters():
        shape = tuple(p.shape)
        tensors.append((shape, _local(p).element_size(), True))
        for v in ((opt.state.get(p) or {}).values() if opt is not None else ()):
            if torch.is_tensor(v):
                tensors.append((tuple(v.shape), _local(v).element_size(),
                                tuple(v.shape) == shape and v.dim() > 0))
    live_argument = state_bytes(state)

    def argument_at(world: int) -> float:
        if not fsdp:
            return live_argument
        size = mesh_shape(axes, world).get("fsdp", 1)
        total = 0.0
        for shape, elem, sharded in tensors:
            numel = math.prod(shape)
            if not sharded or size == 1:
                total += numel * elem
                continue
            spec = _fsdp_spec(shape, live_fsdp)
            if spec:
                dim = spec.index("fsdp")
                if shape[dim] % size:
                    raise RungUnavailable(
                        "dim %d (%d) not divisible over %r=%d"
                        % (dim, shape[dim], "fsdp", size))
            dim = fsdp_placement(shape, size).dim
            rows = -(-shape[dim] // size)  # FSDP2's padded chunk
            total += rows * (numel // shape[dim] if shape[dim] else 0) * elem
        return total

    def compile_for(world: int) -> None:
        plan = MemoryPlan(argument=argument_at(world), temp=live_plan.temp,
                          world=world, ts=time.time())
        if on_planned is not None:
            try:
                on_planned(plan, world)
            except Exception as exc:  # noqa: BLE001 — telemetry never fails a rung
                logger.debug("aot: on_planned hook failed for world=%d: %s",
                             world, exc)

    return compile_for


# -- the cache exchange -------------------------------------------------------

_TMP_MARK = ".edlpull"


def _is_entry(name: str) -> bool:
    """True for a shippable cache entry file name. In-flight pull temps,
    ``ops/_build``'s in-flight ``*.tmp`` builds and copies, ``-atime``
    sidecars and dotfiles are excluded. The single definition of "what is
    a cache entry" — the manifest scanners must agree or published
    manifests drift from what peers can serve."""
    return not (
        name.endswith("-atime") or _TMP_MARK in name or name.startswith(".")
        or name.endswith(".tmp")
    )


def _safe_name(name: str) -> bool:
    """True when a PEER-supplied entry name is a bare filename. Enforced
    on both exchange directions: the server never reads a path-shaped
    name out of its cache dir, and the puller never writes one."""
    return bool(name) and "/" not in name and "\\" not in name and not name.startswith(".")


def _digest_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _scan_dir(
    cache_dir: str, digests: Dict[str, Tuple[float, int, str]]
) -> Tuple[Dict[str, Tuple[float, int, str]], Dict[str, Dict]]:
    """THE definition of "what is a publishable cache entry": one
    enumeration shared by every manifest scanner. ``digests`` memoizes by
    (mtime, size) so an unchanged file is a stat, not a re-digest; pass
    ``{}`` for a full scan. Returns ``(fresh_digests, manifest)`` where
    manifest is ``{entry_name: {"sha": hex, "size": n}}``."""
    fresh: Dict[str, Tuple[float, int, str]] = {}
    out: Dict[str, Dict] = {}
    try:
        names = os.listdir(cache_dir)
    except OSError:
        return fresh, out
    for name in names:
        if not _is_entry(name):
            continue
        path = os.path.join(cache_dir, name)
        try:
            st = os.stat(path)
            cached = digests.get(name)
            if cached and cached[0] == st.st_mtime and cached[1] == st.st_size:
                sha = cached[2]
            else:
                sha = _digest_file(path)
            fresh[name] = (st.st_mtime, st.st_size, sha)
            out[name] = {"sha": sha, "size": st.st_size}
        except OSError:
            continue
    return fresh, out


def scan_manifest(cache_dir: str) -> Dict[str, Dict]:
    """One-shot full scan (see :func:`_scan_dir`)."""
    return _scan_dir(cache_dir, {})[1]


class CacheExchange:
    """Pod-side half of the exchange: manifest publication + entry server.

    Owned by the LAUNCHER (pod-scoped, survives worker restarts across
    stages); sharing the launcher's store client. The manifest is
    rescanned and republished (when it changed) on the exchange's own
    thread; ``refresh()`` may also be called by hand.
    """

    _REFRESH_EVERY = 5.0

    def __init__(
        self, cache_dir: str, client, job_id: str, pod_id: str,
        host: str = "0.0.0.0", port: int = 0,
    ) -> None:
        self.cache_dir = cache_dir
        self._client = client
        self.job_id = job_id
        self.pod_id = pod_id
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._host = host
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_lock = threading.Lock()
        self._digests: Dict[str, Tuple[float, int, str]] = {}  # name -> (mtime, size, sha)
        self._published: Optional[str] = None
        self._last_refresh = 0.0

    @property
    def endpoint(self) -> str:
        from edl_tpu_torch.utils.net import get_host_ip

        host = self._host if self._host not in ("", "0.0.0.0") else get_host_ip()
        return "%s:%d" % (host, self.port)

    def start(self) -> "CacheExchange":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="edl-cache-exchange", daemon=True
        )
        self._accept_thread.start()
        # all digest work — the initial scan included — lives on the
        # exchange's own thread, never the caller's
        self._refresh_thread = threading.Thread(
            target=self._refresh_loop, name="edl-cache-exchange-scan",
            daemon=True,
        )
        self._refresh_thread.start()
        return self

    def _refresh_loop(self) -> None:
        self.refresh(force=True)  # initial publish, off the start() path
        while not self._stop.wait(timeout=self._REFRESH_EVERY):
            self.refresh(force=True)

    def stop(self) -> None:
        self._stop.set()
        # the scan thread must be gone before the retraction below, or an
        # in-flight refresh republishes the manifest right after we
        # delete it
        if self._refresh_thread is not None:
            self._refresh_thread.join(timeout=2.0)
        # retract the manifest: it is a plain (unleased) key
        if self._published is not None:
            try:
                self._client.delete(
                    "/%s/%s/%s" % (self.job_id, MANIFEST_SERVICE, self.pod_id)
                )
            except Exception:  # noqa: BLE001 — best-effort retraction
                pass
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    # -- manifest ----------------------------------------------------------

    def _scan_incremental(self) -> Dict[str, Dict]:
        self._digests, out = _scan_dir(self.cache_dir, self._digests)
        return out

    def refresh(self, force: bool = False) -> None:
        """Republish the manifest if the cache dir changed. Best-effort:
        a sick store delays the next pod's pull, it never breaks this
        one."""
        with self._refresh_lock:
            self._refresh_locked(force)

    # edl: blocking-ok(hashing under _refresh_lock is the design: the lock only serializes the exchange's own scan thread against manual refresh() calls)
    def _refresh_locked(self, force: bool) -> None:
        now = time.monotonic()
        if not force and now - self._last_refresh < self._REFRESH_EVERY:
            return
        self._last_refresh = now
        entries = self._scan_incremental()
        # the change check excludes the publication timestamp
        payload = {
            "endpoint": self.endpoint,
            "entries": {n: e["sha"] for n, e in sorted(entries.items())},
        }
        body = json.dumps(payload, sort_keys=True)
        if body == self._published:
            return
        payload["ts"] = time.time()
        try:
            self._client.put(
                "/%s/%s/%s" % (self.job_id, MANIFEST_SERVICE, self.pod_id),
                json.dumps(payload, sort_keys=True).encode(),
            )
            self._published = body
        except Exception as exc:  # noqa: BLE001
            logger.debug("cache-exchange manifest publish failed: %s", exc)

    # -- serving -----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(sock,), daemon=True
            ).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        from edl_tpu_torch.rpc.wire import (
            TC_FIELD,
            pack_frame,
            read_entries_capped,
            read_frame_blocking,
            server_span,
        )

        try:
            with sock:
                sock.settimeout(30.0)
                req = read_frame_blocking(sock)
                if req.get("m") != "cache_pull":
                    sock.sendall(pack_frame(
                        {"i": req.get("i", 0), "ok": False,
                         "err": {"etype": "EdlStoreError",
                                 "detail": "unknown method"}}
                    ))
                    return
                cap = int(os.environ.get(
                    "EDL_CACHE_PULL_MAX_BYTES", str(64 << 20)
                ))
                with server_span(
                    "cache_pull", req.get(TC_FIELD), server="cache"
                ):
                    # the manifest is the only namespace a peer may name:
                    # never serve a path-shaped name out of the cache dir
                    entries, truncated, sent = read_entries_capped(
                        req.get("names", ()),
                        lambda name: (
                            os.path.join(self.cache_dir, name)
                            if _safe_name(name) else None
                        ),
                        cap,
                    )
                sock.sendall(pack_frame(
                    {"i": req.get("i", 0), "ok": True, "entries": entries,
                     "truncated": truncated}
                ))
                _M_XCHG_BYTES.inc(sent, dir="tx")
        except Exception as exc:  # noqa: BLE001 — a sick peer is its problem
            logger.debug("cache-exchange serve failed: %s", exc)


def read_manifests(client, job_id: str) -> Dict[str, Dict]:
    """``{pod_id: manifest}`` for every published pod manifest."""
    out: Dict[str, Dict] = {}
    prefix = "/%s/%s/" % (job_id, MANIFEST_SERVICE)
    try:
        rows, _rev = client.range(prefix)
    except Exception as exc:  # noqa: BLE001
        logger.debug("cache-exchange manifest read failed: %s", exc)
        return out
    for key, value, _c, _m in rows:
        try:
            out[key[len(prefix):]] = json.loads(value)
        except ValueError:
            continue
    return out


def pull_missing(
    cache_dir: str,
    client=None,
    endpoint: str = "",
    job_id: str = "",
    own_pod: str = "",
    deadline: Optional[float] = None,
    chunk: int = 16,
) -> Dict[str, int]:
    """Diff peer manifests against ``cache_dir`` and pull what is missing.

    Returns ``{"pulled": n, "bytes": n, "skipped_bad": n, "peers": n}``.
    Bounded (``deadline`` seconds, default ``EDL_CACHE_PULL_BUDGET`` =
    10) and exception-contained: any failure — peer gone, frame torn,
    digest mismatch (the ``store.cache.exchange`` corrupt drill) — skips
    that entry or peer and the stage degrades to a normal build. Entries
    land via write-to-temp + atomic rename, digest-verified first.
    """
    stats = {"pulled": 0, "bytes": 0, "skipped_bad": 0, "peers": 0}
    if not cache_dir:
        return stats
    if deadline is None:
        deadline = float(os.environ.get("EDL_CACHE_PULL_BUDGET", "10"))
    t_end = time.monotonic() + deadline
    owns_client = False
    if client is None:
        if not endpoint:
            return stats
        try:
            from edl_tpu_torch.store.client import StoreClient

            client = StoreClient(endpoint, timeout=min(5.0, deadline))
            owns_client = True
        except Exception as exc:  # noqa: BLE001
            logger.debug("cache pull: no store (%s)", exc)
            return stats
    # restage-trace segment: the pull is one hop of the restage critical
    # path (spawn -> CACHE PULL -> restore -> first step)
    import contextlib as _contextlib

    span = (
        obs_trace.child_span("cache_pull")
        if obs_trace.PROPAGATION.armed
        else _contextlib.nullcontext()
    )
    try:
        manifests = read_manifests(client, job_id)
        try:
            local = set(os.listdir(cache_dir))
        except OSError:
            os.makedirs(cache_dir, mode=0o700, exist_ok=True)
            local = set()
        t0 = time.monotonic()
        with span:
            for pod, manifest in manifests.items():
                if pod == own_pod or time.monotonic() > t_end:
                    continue
                peer = manifest.get("endpoint", "")
                wanted = {
                    name: sha
                    for name, sha in (manifest.get("entries") or {}).items()
                    # a hostile manifest must not pick where bytes land
                    if name not in local and _safe_name(name)
                }
                if not peer or not wanted:
                    continue
                stats["peers"] += 1
                names = sorted(wanted)
                while names and time.monotonic() <= t_end:
                    batch, names = names[:chunk], names[chunk:]
                    got, truncated = _pull_chunk(
                        peer, batch,
                        # per-dial cap: a dead endpoint must cost one
                        # bounded connect, not the whole pull budget
                        max(0.5, min(
                            float(os.environ.get(
                                "EDL_CACHE_PULL_PEER_TIMEOUT", "5"
                            )),
                            t_end - time.monotonic(),
                        )),
                    )
                    if not got:
                        break  # peer sick/gone: stop dialing it, try the next
                    # entries pushed out of a byte-capped response come
                    # back later; got nonempty guarantees progress
                    names.extend(truncated)
                    for name, data in got.items():
                        if _FP_EXCHANGE.armed:
                            try:
                                data = _FP_EXCHANGE.fire(data, name=name[:32])
                            except ConnectionError:
                                stats["skipped_bad"] += 1
                                continue
                        sha = hashlib.sha256(data).hexdigest()
                        if sha != wanted.get(name):
                            stats["skipped_bad"] += 1
                            logger.warning(
                                "cache pull: digest mismatch for %s from %s; "
                                "entry dropped (degrades to a build)",
                                name[:48], pod[:8],
                            )
                            continue
                        tmp = os.path.join(
                            cache_dir,
                            "%s%s.%d" % (name, _TMP_MARK, os.getpid()),
                        )
                        try:
                            with open(tmp, "wb") as fh:
                                fh.write(data)
                                fh.flush()
                                os.fsync(fh.fileno())
                            os.replace(tmp, os.path.join(cache_dir, name))
                        except OSError as exc:
                            logger.warning("cache pull: write failed: %s", exc)
                            try:
                                os.unlink(tmp)
                            except OSError:
                                pass
                            continue
                        local.add(name)
                        stats["pulled"] += 1
                        stats["bytes"] += len(data)
                        _M_XCHG_BYTES.inc(len(data), dir="rx")
        if stats["pulled"] or stats["skipped_bad"]:
            obs_events.record(
                "exchange", fsync=True, component="aot",
                pulled=stats["pulled"], bytes=stats["bytes"],
                skipped_bad=stats["skipped_bad"],
                dur=round(time.monotonic() - t0, 3),
            )
            logger.info(
                "cache exchange: pulled %d entr%s (%d bytes) from %d "
                "peer(s)%s",
                stats["pulled"], "y" if stats["pulled"] == 1 else "ies",
                stats["bytes"], stats["peers"],
                ", %d bad skipped" % stats["skipped_bad"]
                if stats["skipped_bad"] else "",
            )
    except Exception as exc:  # noqa: BLE001 — the pull is a perf lever, never a gate
        logger.warning("cache pull failed (%s); continuing uncached", exc)
    finally:
        if owns_client:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass
    return stats


def _pull_chunk(
    peer: str, names: List[str], timeout: float
) -> Tuple[Dict[str, bytes], List[str]]:
    """One bounded cache_pull RPC. Returns ``(entries, truncated)``;
    both empty on any transport failure."""
    from edl_tpu_torch.rpc.wire import request_once

    try:
        resp = request_once(
            peer, {"i": 1, "m": "cache_pull", "names": names},
            timeout=min(timeout, 30.0),
        )
    except Exception as exc:  # noqa: BLE001
        logger.debug("cache pull from %s failed: %s", peer, exc)
        return {}, []
    if not resp.get("ok"):
        return {}, []
    entries = resp.get("entries") or {}
    return {
        str(name): bytes(data)
        for name, data in entries.items()
        if isinstance(data, (bytes, bytearray))
    }, [str(n) for n in (resp.get("truncated") or ())]
