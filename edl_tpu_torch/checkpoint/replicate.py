"""Peer-replicated checkpoint shards: shared-FS-free recovery tiers.

The port's copy of ``edl_tpu/checkpoint/replicate.py``. The code differs
in its imports and, for sharded versions (each pod holds its ranks' part
of a version), in three places: :func:`replicas_by_step` and
:func:`fetch_files` take the union of every source pod's replicas of a
step (the manager's ladder reads them in place of the JAX module's
``peer_complete_steps``, and :func:`assemble_from_peers` fetches through
:func:`fetch_files`), the holder drops a departed source's replica only
once a live one is strictly newer (at the same step a live source holds
the other parts), and the durable mirror adds a pod's files to a step
dir another pod mirrored first. The store keyspaces, the ``ckpt_push`` /
``ckpt_fetch`` payloads, ``.manifest.json``, the fault points, the
``edl_ckpt_*`` metrics and the knobs are the JAX package's, so a port pod
and a JAX pod hold and fetch each other's replicas. A port version's
files are DCP's (``__<rank>_<n>.distcp``, ``status.json``); DCP's own
``.metadata`` is a dot-file this plane never moves, so the manager keeps
it as ``dcp.metadata`` too. Where the text below says Orbax, the port's
manager does the same with DCP.

The paper's elastic contract resumes every membership change "from the
last HDFS/local checkpoint" — which puts ONE durable directory on the
critical path of every restore, and leaves nothing at all when that
directory is slow, partitioned, or gone. Gemini (SOSP '23) and CheckFreq
(FAST '21) show the fix this module implements: after every save, a
low-priority background thread pushes the pod's local checkpoint shards
to K ring-successor peers, so a killed pod's replacement recovers from
surviving pods at wire speed and the durable tier demotes to a
background backstop. Three pieces:

**The holder** (:class:`ReplicaServer`, launcher-owned, pod-scoped).
Receives digest-verified shard pushes into a replica dir
(``{src_pod}/{step}/{relpath}``), serves them back over the wire
(``ckpt_fetch``, byte-capped via the shared transfer discipline in
``rpc/wire.read_entries_capped``), and publishes what it holds under the
``ckpt/replicas/{pod}`` store keyspace with a freshness rev — the
manifest IS the recovery map. Membership changes feed
:meth:`ReplicaServer.note_membership` so superseded replicas of departed
pods are garbage-collected.

**The pusher** (:class:`Replicator`, saver-side). Notified after each
``CheckpointManager.save``; a low-priority thread walks the finalized
step dir, picks K ring successors of its own pod on the existing
consistent-hash ring (``ckpt/peers`` registrations name the live
holders), and pushes chunked, digest-verified, budget-bounded
(``EDL_CKPT_REPL_BUDGET``) ``ckpt_push`` frames. It also mirrors the
step into the durable tier — the "background backstop" — and exports
``edl_ckpt_replica_lag_steps`` (latest saved step minus newest
peer-replicated step), the signal the ``ckpt-replica-stale`` monitor
rule watches. :meth:`Replicator.flush` is the synchronous form a
draining pod calls: per-pod and non-collective, it closes the
multi-pod-drain gap where ``emergency_save`` cannot run (Orbax saves
are collective).

**The assembler** (:func:`assemble_from_peers`, restore-side). Reads
the replica manifests, picks the newest complete step across holders,
fetches the missing shards (union across holders — a partially-holding
peer contributes what it has), digest-verifies every file, and lands
the step dir atomically in the local tier for a normal Orbax restore.
Any shortfall — dead holder, torn frame, digest mismatch (the
``ckpt.replicate.fetch`` corrupt drill) — abandons the assembly and the
restore degrades to the durable tier, never to a wedged worker; a
replica that assembles but fails Orbax's own restore is quarantined by
the ``.corrupt`` rename path like any torn local version.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("checkpoint.replicate")

PEERS_SERVICE = "ckpt/peers"        # leased: {pod_id} -> replica endpoint
REPLICAS_SERVICE = "ckpt/replicas"  # permanent: {holder} -> manifest json

_FP_PUSH = _fault_point(
    "ckpt.replicate.push",
    "one pushed checkpoint shard: corrupt (digest rejected at the "
    "holder), delay (slow replication), drop (peer unreachable — the "
    "step stays unreplicated and restore degrades to the durable tier)",
)
_FP_FETCH = _fault_point(
    "ckpt.replicate.fetch",
    "one fetched replica shard during peer-tier assembly: corrupt "
    "(digest mismatch -> assembly abandoned, restore degrades to the "
    "durable tier), delay, drop (holder unreachable mid-fetch)",
)

_M_LAG = obs_metrics.gauge(
    "edl_ckpt_replica_lag_steps",
    "latest saved step minus the newest step fully replicated to a peer "
    "(0 = every checkpoint this pod saved survives it)",
)
_M_BYTES = obs_metrics.counter(
    "edl_ckpt_replicate_bytes_total",
    "checkpoint shard bytes moved between pods, by dir (tx/rx)",
)
_M_PUSHES = obs_metrics.counter(
    "edl_ckpt_replica_pushes_total",
    "checkpoint replication passes, by outcome "
    "(ok/failed/no_peers/emergency)",
)
_M_HELD = obs_metrics.gauge(
    "edl_ckpt_replicas_held",
    "complete peer checkpoint replicas this pod holds (src x step)",
)

_PUSH_CHUNK_FILES = 16
_PUSH_CHUNK_BYTES = 48 << 20
_FETCH_CAP_BYTES = 64 << 20
_MANIFEST_NAME = ".manifest.json"


def replica_count() -> int:
    """K, the ring-successor fan-out (``EDL_CKPT_REPLICAS``, default 1;
    0 disables the whole replication plane)."""
    try:
        return max(0, int(os.environ.get("EDL_CKPT_REPLICAS", "1")))
    except ValueError:
        return 1


def repl_budget() -> float:
    """Seconds one replication/assembly pass may spend
    (``EDL_CKPT_REPL_BUDGET``, default 10)."""
    try:
        return float(os.environ.get("EDL_CKPT_REPL_BUDGET", "10"))
    except ValueError:
        return 10.0


def _safe_relpath(name: str) -> bool:
    """True for a holder/peer-supplied shard name that is a plain
    RELATIVE path with no dot-component — enforced on every direction a
    name crosses a trust boundary (push write, fetch read, assembly
    write): a hostile manifest naming ``../../...`` must never choose
    where shard bytes land."""
    if not name or name.startswith(("/", "\\")) or "\\" in name:
        return False
    parts = name.split("/")
    return all(p and not p.startswith(".") for p in parts)


def _digest_file(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def step_manifest(step_dir: str) -> Dict[str, Dict]:
    """``{relpath: {"sha": hex, "size": n}}`` for every file under one
    finalized checkpoint step dir — the unit of replication."""
    out: Dict[str, Dict] = {}
    for dirpath, _dirnames, filenames in os.walk(step_dir):
        for name in filenames:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, step_dir).replace(os.sep, "/")
            if not _safe_relpath(rel):
                continue
            try:
                out[rel] = {
                    "sha": _digest_file(path),
                    "size": os.path.getsize(path),
                }
            except OSError:
                continue
    return out


def finalized_steps(root: str) -> List[int]:
    """Step numbers with a finalized (plain-int-named) dir under
    ``root``, ascending — Orbax finalizes by rename, so a temp or
    quarantined dir never matches."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    return sorted(int(n) for n in names if n.isdigit())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _write_shard(root: str, rel: str, data: bytes) -> bool:
    """Write one digest-verified shard atomically (tmp + fsync +
    rename) under ``root``; a SIGKILL mid-write must never leave a
    torn file behind a verified name."""
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = "%s.edlrepl.%d" % (path, os.getpid())
    try:
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        return True
    except OSError as exc:
        logger.warning("replica shard write failed (%s): %s", rel, exc)
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


# -- the holder ---------------------------------------------------------------


class ReplicaServer:
    """Pod-side replica holder: receives pushes, serves fetches,
    publishes its manifest. Owned by the LAUNCHER (pod-scoped, survives
    worker restarts across stages), sharing the launcher's store client
    for manifest publication."""

    def __init__(
        self,
        replica_dir: str,
        client,
        job_id: str,
        pod_id: str,
        keep: int = 2,
        host: str = "0.0.0.0",
        port: int = 0,
        ttl: float = 10.0,
    ) -> None:
        self.replica_dir = os.path.abspath(replica_dir)
        os.makedirs(self.replica_dir, exist_ok=True)
        self._client = client
        self.job_id = job_id
        self.pod_id = pod_id
        self._keep = max(1, keep)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._host = host
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        # guards held-replica bookkeeping + manifest publication: pushes
        # arrive on per-connection threads while the launcher's
        # supervision loop calls note_membership()
        self._mu = threading.Lock()
        # (src, step) -> manifest dict, complete replicas only
        self._held: Dict[Tuple[str, int], Dict] = {}  # edl: guarded-by(self._mu)
        self._rev = 0  # edl: guarded-by(self._mu)
        # the manifest is LEASED (launcher-ttl): a SIGKILLed holder's
        # advertisement must expire like its peers registration — its
        # replicas died with its machine, and a phantom manifest would
        # both pollute the freshness-first restore ordering and
        # over-state the lost-work bound newest_replicated_step reports
        self._ttl = ttl
        self._pub_lock = threading.Lock()  # serializes register/update
        self._manifest_reg = None  # edl: guarded-by(self._pub_lock)
        # (src, step) -> manifest of a push IN FLIGHT: detects a
        # re-saved same-numbered step (different bytes, same number —
        # the quarantine-then-resave path) so the previous replica
        # generation is voided instead of mixing with the new one
        self._inflight: Dict[Tuple[str, int], Dict] = {}  # edl: guarded-by(self._mu)
        self._load_held()

    @property
    def endpoint(self) -> str:
        from edl_tpu_torch.utils.net import get_host_ip

        host = self._host if self._host not in ("", "0.0.0.0") else get_host_ip()
        return "%s:%d" % (host, self.port)

    def start(self) -> "ReplicaServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="edl-ckpt-replica", daemon=True
        )
        self._accept_thread.start()
        with self._mu:
            warm = bool(self._held)
        if warm:
            # a relaunched pod over a warm replica dir re-advertises what
            # it still holds — the replicas are the point of surviving
            self._publish()
        return self

    def stop(self) -> None:
        self._stop.set()
        # retract the manifest now (clean stop); SIGKILLed holders are
        # covered by the lease expiring
        with self._pub_lock:
            reg, self._manifest_reg = self._manifest_reg, None
        if reg is not None:
            try:
                reg.stop(delete=True)
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

    # -- held-set bookkeeping ----------------------------------------------

    def _load_held(self) -> None:
        """Recover the held set from disk manifests (a relaunched pod
        keeps serving what the previous incarnation stored)."""
        try:
            srcs = os.listdir(self.replica_dir)
        except OSError:
            return
        found: Dict[Tuple[str, int], Dict] = {}
        for src in srcs:
            for step in finalized_steps(os.path.join(self.replica_dir, src)):
                mpath = os.path.join(
                    self.replica_dir, src, str(step), _MANIFEST_NAME
                )
                try:
                    with open(mpath) as fh:
                        found[(src, step)] = json.load(fh)
                except (OSError, ValueError):
                    continue
        with self._mu:
            self._held.update(found)
            _M_HELD.set(len(self._held))

    def held(self) -> List[Tuple[str, int]]:
        with self._mu:
            return sorted(self._held)

    def note_membership(self, live_pods) -> None:
        """Launcher hook on every adopted generation: drop replicas of
        DEPARTED sources once superseded — a live source's complete
        replica at an equal-or-newer step proves the job moved past the
        departed pod's state — and trim every source to its newest
        ``keep`` steps. A dead pod's newest un-superseded replica is
        exactly what recovery needs, so it is never dropped."""
        live = set(live_pods)
        with self._mu:
            newest_live = max(
                (s for (src, s) in self._held if src in live), default=None
            )
            drop: List[Tuple[str, int]] = []
            by_src: Dict[str, List[int]] = {}
            for src, step in self._held:
                by_src.setdefault(src, []).append(step)
            for src, steps in by_src.items():
                steps.sort()
                drop.extend((src, s) for s in steps[: -self._keep])
                if src not in live and newest_live is not None:
                    # strictly newer: at the same step a live source may
                    # hold the other shards of the same version (a
                    # sharded save leaves every pod a part of it)
                    drop.extend(
                        (src, s)
                        for s in steps[-self._keep:]
                        if s < newest_live
                    )
            for key in set(drop):
                self._held.pop(key, None)
        for src, step in set(drop):
            shutil.rmtree(
                os.path.join(self.replica_dir, src, str(step)),
                ignore_errors=True,
            )
        if drop:
            logger.info(
                "replica gc: dropped %d superseded replica(s)", len(set(drop))
            )
            self._publish()

    def _publish(self) -> None:
        """(Re)publish the leased manifest with a bumped freshness rev."""
        with self._mu:
            self._rev += 1
            payload = {
                "endpoint": self.endpoint,
                "rev": self._rev,
                "ts": time.time(),
                "replicas": {},
            }
            for (src, step), manifest in self._held.items():
                payload["replicas"].setdefault(src, {})[str(step)] = {
                    "files": manifest,
                    "complete": True,
                }
            _M_HELD.set(len(self._held))
            body = json.dumps(payload, sort_keys=True).encode()
        try:
            with self._pub_lock:
                if self._manifest_reg is None:
                    from edl_tpu_torch.discovery.registry import Registry

                    self._manifest_reg = Registry(
                        self._client, self.job_id
                    ).register(
                        REPLICAS_SERVICE, self.pod_id, body, ttl=self._ttl
                    )
                else:
                    self._manifest_reg.update(body)
        except Exception as exc:  # noqa: BLE001 — a sick store delays the
            # next assembly's map, it never breaks the holder
            logger.debug("replica manifest publish failed: %s", exc)

    # -- serving ------------------------------------------------------------

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
        from edl_tpu_torch.rpc.wire import pack_frame, read_frame_blocking

        try:
            with sock:
                sock.settimeout(30.0)
                while not self._stop.is_set():
                    req = read_frame_blocking(sock)
                    method = req.get("m")
                    if method == "ckpt_push":
                        resp = self._handle_push(req)
                    elif method == "ckpt_fetch":
                        resp = self._handle_fetch(req)
                    else:
                        resp = {
                            "ok": False,
                            "err": {"etype": "EdlStoreError",
                                    "detail": "unknown method"},
                        }
                    sock.sendall(pack_frame({"i": req.get("i", 0), **resp}))
        except Exception:  # noqa: BLE001 — a sick peer is its problem;
            pass  # the pusher/assembler re-dials or degrades a tier

    def _handle_push(self, req: dict) -> dict:
        from edl_tpu_torch.rpc.wire import TC_FIELD, server_span

        src = str(req.get("src", ""))
        try:
            step = int(req.get("step", -1))
        except (TypeError, ValueError):
            step = -1
        manifest = req.get("manifest") or {}
        if not src or "/" in src or src.startswith(".") or step < 0:
            return {"ok": False, "err": {"etype": "EdlStoreError",
                                         "detail": "bad src/step"}}
        root = os.path.join(self.replica_dir, src, str(step))
        norm = {
            str(k): {"sha": (v or {}).get("sha"), "size": (v or {}).get("size")}
            for k, v in manifest.items()
        }
        with self._mu:
            prev = self._inflight.get((src, step)) or self._held.get(
                (src, step)
            )
            changed = prev is not None and prev != norm
            if changed:
                # a re-saved same-numbered step (crash -> quarantine ->
                # resave produces new bytes under an old number): the
                # previous replica generation is VOID — advertising its
                # digests against the new bytes would make every later
                # assembly fail digest checks and fall to durable
                self._held.pop((src, step), None)
            self._inflight[(src, step)] = norm
        if changed:
            shutil.rmtree(root, ignore_errors=True)
            logger.warning(
                "replica of %s step %d superseded by a re-push with a "
                "different manifest; previous generation dropped",
                src[:8], step,
            )
            self._publish()  # retract the void advertisement now
        rejected: List[str] = []
        received = 0
        with server_span("ckpt_push", req.get(TC_FIELD), server="ckptrepl"):
            for name, data in (req.get("entries") or {}).items():
                name = str(name)
                if (
                    not _safe_relpath(name)
                    or name not in manifest
                    or not isinstance(data, (bytes, bytearray))
                ):
                    rejected.append(name)
                    continue
                want = manifest[name].get("sha")
                if hashlib.sha256(bytes(data)).hexdigest() != want:
                    # corrupted in flight (the ckpt.replicate.push corrupt
                    # drill) or torn at the pusher: refuse — an incomplete
                    # replica is never published, and the pusher's step
                    # simply stays unreplicated
                    rejected.append(name)
                    continue
                if _write_shard(root, name, bytes(data)):
                    received += len(data)
                else:
                    rejected.append(name)
            _M_BYTES.inc(received, dir="rx")
        complete = self._check_complete(src, step, root, manifest)
        return {"ok": True, "complete": complete, "rejected": rejected}

    def _check_complete(
        self, src: str, step: int, root: str, manifest: dict
    ) -> bool:
        """Complete when every manifest file is on disk at its recorded
        size (bytes were digest-verified at write time)."""
        if not manifest:
            return False
        for name, meta in manifest.items():
            if not _safe_relpath(str(name)):
                return False
            path = os.path.join(root, str(name))
            try:
                if os.path.getsize(path) != int(meta.get("size", -1)):
                    return False
            except (OSError, TypeError, ValueError):
                return False
        with self._mu:
            known = (src, step) in self._held
            if not known:
                self._held[(src, step)] = {
                    str(k): {"sha": v.get("sha"), "size": v.get("size")}
                    for k, v in manifest.items()
                }
                self._inflight.pop((src, step), None)
        if not known:
            # the completeness marker lives as a dot-file so fetches
            # (bare-relpath-validated) can never serve it as a shard
            marker = os.path.join(root, _MANIFEST_NAME)
            tmp = "%s.%d" % (marker, os.getpid())
            try:
                with open(tmp, "w") as fh:
                    json.dump(manifest, fh, sort_keys=True)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, marker)
            except OSError:
                pass
            obs_events.record(
                "ckpt_replica", fsync=True, src=src[:8], step=step,
                holder=self.pod_id[:8],
            )
            logger.info(
                "holding complete replica of %s step %d", src[:8], step
            )
            self._publish()
        return True

    def _handle_fetch(self, req: dict) -> dict:
        from edl_tpu_torch.rpc.wire import (
            TC_FIELD,
            read_entries_capped,
            server_span,
        )

        src = str(req.get("src", ""))
        step = str(req.get("step", ""))
        if not src or "/" in src or src.startswith(".") or not step.isdigit():
            return {"ok": False, "err": {"etype": "EdlStoreError",
                                         "detail": "bad src/step"}}
        root = os.path.join(self.replica_dir, src, step)
        with server_span("ckpt_fetch", req.get(TC_FIELD), server="ckptrepl"):
            entries, truncated, sent = read_entries_capped(
                [str(n) for n in (req.get("names") or ())],
                lambda name: (
                    os.path.join(root, name) if _safe_relpath(name) else None
                ),
                _FETCH_CAP_BYTES,
            )
            _M_BYTES.inc(sent, dir="tx")
        return {"ok": True, "entries": entries, "truncated": truncated}


# -- the pusher ---------------------------------------------------------------


class Replicator:
    """Saver-side background replication of finalized checkpoint steps.

    ``note_save(step)`` is called by :class:`CheckpointManager` after a
    save finalizes; a low-priority daemon thread then pushes the step's
    shards to K ring successors and mirrors it into the durable tier.
    ``flush(budget)`` runs one pass synchronously — the per-pod,
    non-collective emergency path a draining pod uses where the
    collective ``emergency_save`` cannot run."""

    def __init__(
        self,
        local_dir: str,
        client=None,
        endpoint: str = "",
        job_id: str = "",
        pod_id: str = "",
        k: Optional[int] = None,
        budget: Optional[float] = None,
        durable_path: Optional[str] = None,
    ) -> None:
        self.local_dir = os.path.abspath(local_dir)
        self._endpoint = endpoint
        self.job_id = job_id
        self.pod_id = pod_id
        self._k = replica_count() if k is None else max(0, int(k))
        self._budget = repl_budget() if budget is None else float(budget)
        self.durable_path = (
            os.path.abspath(durable_path) if durable_path else None
        )
        # _mu guards the cursor state + lazy client; _pass_lock serializes
        # whole replication passes between the thread and flush()
        self._mu = threading.Lock()
        self._pass_lock = threading.Lock()
        self._client = client  # edl: guarded-by(self._mu)
        self._owns_client = client is None
        self._pending: Optional[int] = None  # edl: guarded-by(self._mu)
        self._latest = -1  # edl: guarded-by(self._mu)
        self._replicated = -1  # edl: guarded-by(self._mu)
        # True after a pass that found NO registered peer holder: a lone
        # pod has nothing to replicate to, and its "lag" is not a
        # staleness signal an operator can act on — lag() reports 0 so
        # ckpt-replica-stale never pages a single-pod deployment
        self._no_peers = False  # edl: guarded-by(self._mu)
        self._mirrored = -1  # edl: guarded-by(self._mu)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- API ---------------------------------------------------------------

    def note_save(self, step: int) -> None:
        """A finalized step exists; replicate it soon (newest wins)."""
        with self._mu:
            self._latest = max(self._latest, int(step))
            if self._pending is None or step > self._pending:
                self._pending = int(step)
            _M_LAG.set(self._lag_locked())
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="edl-ckpt-replicator", daemon=True
                )
                self._thread.start()
        self._wake.set()

    def flush(self, budget_s: Optional[float] = None) -> bool:
        """Synchronously replicate the newest finalized step (emergency
        path — a drain budget bounds it). True when at least one peer
        holds a complete copy of the newest step."""
        steps = finalized_steps(self.local_dir)
        if not steps:
            return False
        step = steps[-1]
        with self._mu:
            self._latest = max(self._latest, step)
            already = self._replicated >= step
        if already:
            return True
        ok = self._replicate_pass(
            step, self._budget if budget_s is None else float(budget_s),
            emergency=True,
        )
        return ok

    @property
    def peers_armed(self) -> bool:
        """False for a mirror-only (k=0) replicator — emergency peer
        pushes have nothing to push to."""
        return self._k > 0

    def _lag_locked(self) -> int:
        if self._k <= 0 or self._latest < 0 or self._no_peers:  # edl: lock-free(every caller holds self._mu)
            return 0  # mirror-only / lone pod: nothing to lag behind
        return max(0, self._latest - max(self._replicated, 0))  # edl: lock-free(every caller holds self._mu)

    def lag(self) -> int:
        with self._mu:
            return self._lag_locked()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._mu:
            owns, client = self._owns_client, self._client
            if owns:
                self._client = None
        if owns and client is not None:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass

    # -- the replication loop ----------------------------------------------

    def _run(self) -> None:
        try:
            # the replicator must lose CPU arbitration to the training
            # step it runs beside (same discipline as the AOT ladder)
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 10)
        except (AttributeError, OSError, ValueError):
            pass
        retries: Dict[int, int] = {}
        while not self._stop.is_set():
            self._wake.wait()
            self._wake.clear()
            if self._stop.is_set():
                return
            with self._mu:
                step, self._pending = self._pending, None
            if step is None:
                continue
            try:
                self._replicate_pass(step, self._budget)
            except Exception as exc:  # noqa: BLE001 — replication is a
                # durability lever, never a crash over training
                _M_PUSHES.inc(outcome="failed")
                logger.warning("checkpoint replication aborted: %s", exc)
                continue
            if not os.path.isdir(os.path.join(self.local_dir, str(step))):
                # an ASYNC save not finalized yet: re-arm bounded (a
                # finalize takes seconds; a step that never appears was
                # quarantined/aborted and must not spin forever)
                retries[step] = retries.get(step, 0) + 1
                if retries[step] <= 120 and not self._stop.wait(0.5):
                    with self._mu:
                        if self._pending is None or step > self._pending:
                            self._pending = step
                    self._wake.set()

    def _store(self):
        with self._mu:
            client = self._client
        if client is not None or not self._endpoint:
            return client
        # dial OUTSIDE the lock (a 5s connect must not
        # block note_save on the training thread)
        try:
            from edl_tpu_torch.store.client import connect_store

            client = connect_store(self._endpoint, timeout=5.0)
        except Exception as exc:  # noqa: BLE001
            logger.debug("replicator: no store client (%s)", exc)
            return None
        with self._mu:
            if self._client is None:
                self._client = client
                return client
            existing = self._client
        try:
            client.close()  # lost the publish race
        except Exception:  # noqa: BLE001
            pass
        return existing

    def _peers(self) -> Dict[str, str]:
        """Live replica holders ``{pod_id: endpoint}`` (own pod excluded)."""
        client = self._store()
        if client is None or not self.job_id:
            return {}
        try:
            from edl_tpu_torch.discovery.registry import Registry

            rows = Registry(client, self.job_id).get_service(PEERS_SERVICE)
        except Exception as exc:  # noqa: BLE001
            logger.debug("replicator: peer read failed: %s", exc)
            return {}
        return {
            m.name: m.value.decode()
            for m in rows
            if m.name != self.pod_id and m.value
        }

    def _targets(self, peers: Dict[str, str]) -> List[str]:
        """K ring successors of this pod among the live holders — the
        same consistent-hash ring the store shards and the distill
        balance tables ride."""
        from edl_tpu_torch.discovery.consistent_hash import ConsistentHash

        ring = ConsistentHash([*peers, self.pod_id])
        return ring.successors(self.pod_id, self._k, exclude=(self.pod_id,))

    def _replicate_pass(
        self, step: int, budget_s: float, emergency: bool = False
    ) -> bool:
        # the deadline starts BEFORE the lock wait: an emergency flush
        # arriving while the background thread mirrors to a slow durable
        # FS must spend its drain budget waiting at most, never block
        # unboundedly past it (SIGKILL lands on schedule either way)
        t_end = time.monotonic() + max(0.5, budget_s)
        if emergency:
            if not self._pass_lock.acquire(
                timeout=max(0.1, t_end - time.monotonic())
            ):
                logger.warning(
                    "emergency replication could not interrupt a running "
                    "pass within the budget; the last pushed replica is "
                    "the recovery point"
                )
                return False
        else:
            self._pass_lock.acquire()
        try:
            return self._replicate_locked(
                step, max(0.5, t_end - time.monotonic()), emergency
            )
        finally:
            self._pass_lock.release()

    # edl: blocking-ok(hashing/dials under _pass_lock are the design: the lock serializes replication passes on the replicator's own low-prio thread, and the one latency-sensitive contender — emergency flush — acquires with a timeout budgeted BEFORE the wait)
    def _replicate_locked(
        self, step: int, budget_s: float, emergency: bool
    ) -> bool:
        t0 = time.monotonic()
        deadline = t0 + max(0.5, budget_s)
        with self._mu:
            pushed = self._replicated >= step
            mirrored = self._mirrored >= step
        if pushed and mirrored:
            # save() and wait() both note a sync save's step: the second
            # note must not re-hash and re-send the whole checkpoint
            return True
        step_dir = os.path.join(self.local_dir, str(step))
        if not os.path.isdir(step_dir):
            return False  # not finalized yet; the manager re-notes on wait()
        manifest = step_manifest(step_dir)
        if not manifest:
            return False
        if pushed:
            if not emergency:
                self._mirror_durable(step, step_dir, manifest)
            return True
        acked = False
        no_peers = False
        if self._k > 0:
            peers = self._peers()
            targets = self._targets(peers)
            if not targets:
                no_peers = True
                _M_PUSHES.inc(outcome="no_peers")
            for pod in targets:
                if time.monotonic() > deadline:
                    break
                if self._push_to(
                    peers[pod], step, step_dir, manifest, deadline
                ):
                    acked = True
        with self._mu:
            self._no_peers = no_peers
            if acked:
                self._replicated = max(self._replicated, step)
            _M_LAG.set(self._lag_locked())
        if acked:
            _M_PUSHES.inc(outcome="emergency" if emergency else "ok")
        elif self._k > 0 and not no_peers:
            _M_PUSHES.inc(outcome="failed")
        if self._k > 0:
            # mirror-only passes are not replication attempts: no
            # "failed" flight noise for a deliberately peer-less config
            obs_events.record(
                "ckpt_replicate", fsync=True, step=step,
                outcome="ok" if acked else "failed",
                emergency=emergency, dur=round(time.monotonic() - t0, 3),
            )
        # the durable tier is a background backstop: mirror AFTER the
        # wire-speed peer copies exist, inside whatever budget remains
        # (an emergency pass spends its whole budget on peers — the
        # durable tier is exactly what a drain cannot afford to wait on)
        if not emergency:
            self._mirror_durable(step, step_dir, manifest)
        return acked

    def _push_to(
        self, endpoint: str, step: int, step_dir: str,
        manifest: Dict[str, Dict], deadline: float,
    ) -> bool:
        from edl_tpu_torch.rpc.wire import request_once

        names = sorted(manifest)
        complete = False
        span = obs_trace.child_span("ckpt_push", step=str(step))
        with span:
            while names:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                chunk: Dict[str, bytes] = {}
                size = 0
                while names and len(chunk) < _PUSH_CHUNK_FILES:
                    name = names[0]
                    try:
                        with open(os.path.join(step_dir, name), "rb") as fh:
                            data = fh.read()
                    except OSError:
                        return False  # step dir churned under us; give up
                    if chunk and size + len(data) > _PUSH_CHUNK_BYTES:
                        break
                    if _FP_PUSH.armed:
                        try:
                            data = _FP_PUSH.fire(data, name=name[:32])
                        except ConnectionError:
                            return False  # drop: peer "unreachable"
                    chunk[name] = data
                    size += len(data)
                    names.pop(0)
                try:
                    resp = request_once(
                        endpoint,
                        {"i": 1, "m": "ckpt_push", "src": self.pod_id,
                         "step": step, "manifest": manifest,
                         "entries": chunk},
                        timeout=max(0.5, min(remaining, 20.0)),
                    )
                except Exception as exc:  # noqa: BLE001
                    logger.debug("ckpt push to %s failed: %s", endpoint, exc)
                    return False
                if not resp.get("ok") or resp.get("rejected"):
                    logger.warning(
                        "ckpt push to %s rejected %d shard(s); step %d "
                        "stays unreplicated there",
                        endpoint, len(resp.get("rejected") or ()), step,
                    )
                    return False
                _M_BYTES.inc(size, dir="tx")
                complete = bool(resp.get("complete"))
        return complete

    def _mirror_durable(
        self, step: int, step_dir: str, manifest: Dict[str, Dict]
    ) -> None:
        """Copy the finalized step into the durable tier (tmp dir +
        atomic rename, per-file fsync) — the demoted backstop restore
        falls to when local and peer tiers both come up empty."""
        if self.durable_path is None:
            return
        with self._mu:
            if self._mirrored >= step:
                return
        dst = os.path.join(self.durable_path, str(step))
        if os.path.isdir(dst):
            # another pod mirrored its part of a sharded version first:
            # add the files it lacks, each by rename
            try:
                for rel in manifest:
                    out = os.path.join(dst, rel)
                    if not os.path.exists(out):
                        with open(os.path.join(step_dir, rel), "rb") as fh:
                            _write_shard(dst, rel, fh.read())
                _fsync_dir(dst)
            except OSError as exc:
                logger.warning("durable mirror of step %d failed: %s",
                               step, exc)
                return
            with self._mu:
                self._mirrored = max(self._mirrored, step)
            return
        tmp = os.path.join(
            self.durable_path, ".mirror-%d-%d" % (step, os.getpid())
        )
        try:
            os.makedirs(self.durable_path, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
            for rel in manifest:
                src = os.path.join(step_dir, rel)
                out = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(out), exist_ok=True)
                with open(src, "rb") as fin, open(out, "wb") as fout:
                    shutil.copyfileobj(fin, fout)
                    fout.flush()
                    os.fsync(fout.fileno())
            _fsync_dir(tmp)
            os.replace(tmp, dst)
            _fsync_dir(self.durable_path)
            with self._mu:
                self._mirrored = max(self._mirrored, step)
            obs_events.record("ckpt_mirror", step=step)
        except OSError as exc:
            logger.warning("durable mirror of step %d failed: %s", step, exc)
            shutil.rmtree(tmp, ignore_errors=True)


def make_replicator(
    local_dir: str, durable_path: Optional[str] = None
) -> Optional[Replicator]:
    """Saver-side replicator from the worker env contract, or None when
    there is nothing for it to do. ONE replicator per pod: in a
    multi-process pod every rank shares the pod-scoped local dir and
    calls the collective ``save()``, and N ranks each re-hashing and
    re-pushing the same shards would cost N× wire bytes and race the
    durable mirror — rank 0 *in the pod* owns the push.

    The DURABLE MIRROR is a purely local copy and must not be gated on
    the store/peer contract: a local tier with a durable path gets a
    mirror-only replicator (k=0) even without a store, a job id, or
    peer replication — otherwise `CheckpointManager(durable, local_dir=
    ssd)` outside the launcher env would silently never populate the
    durable path it was given."""
    if not local_dir:
        return None
    try:
        if int(os.environ.get("EDL_WORKER_RANK_IN_POD", "0") or 0) != 0:
            return None
    except ValueError:
        pass
    endpoint = os.environ.get("EDL_STORE_ENDPOINT", "")
    job_id = os.environ.get("EDL_JOB_ID", "")
    pod_id = os.environ.get("EDL_POD_ID", "")
    peers_armed = (
        replica_count() > 0 and endpoint and job_id and pod_id
    )
    if not peers_armed and not durable_path:
        return None
    return Replicator(
        local_dir,
        endpoint=endpoint if peers_armed else "",
        job_id=job_id,
        pod_id=pod_id,
        k=replica_count() if peers_armed else 0,
        durable_path=durable_path,
    )


# -- the assembler ------------------------------------------------------------


def read_replica_manifests(client, job_id: str) -> Dict[str, Dict]:
    """``{holder_pod: manifest}`` for every published replica manifest."""
    out: Dict[str, Dict] = {}
    prefix = "/%s/%s/" % (job_id, REPLICAS_SERVICE)
    try:
        rows, _rev = client.range(prefix)
    except Exception as exc:  # noqa: BLE001
        logger.debug("replica manifest read failed: %s", exc)
        return out
    for key, value, _c, _m in rows:
        try:
            out[key[len(prefix):]] = json.loads(value)
        except ValueError:
            continue
    return out


def newest_replicated_step(client, job_id: str) -> Optional[int]:
    """The newest step any holder advertises a COMPLETE replica of —
    the bound on lost work when a pod and its durable tier both die."""
    best: Optional[int] = None
    for manifest in read_replica_manifests(client, job_id).values():
        for steps in (manifest.get("replicas") or {}).values():
            for step_s, info in steps.items():
                if not info.get("complete") or not str(step_s).isdigit():
                    continue
                step = int(step_s)
                if best is None or step > best:
                    best = step
    return best


def _candidates_from_manifests(
    manifests: Dict[str, Dict],
) -> List[Tuple[int, str, List[Tuple[str, Dict[str, Dict]]]]]:
    """``[(step, src, [(endpoint, files), ...])]`` newest step first;
    holders of the same (src, step) are merged so assembly can take the
    union across partially-holding peers."""
    merged: Dict[Tuple[int, str], List[Tuple[str, Dict]]] = {}
    for manifest in manifests.values():
        endpoint = manifest.get("endpoint", "")
        if not endpoint:
            continue
        for src, steps in (manifest.get("replicas") or {}).items():
            for step_s, info in steps.items():
                if not info.get("complete") or not str(step_s).isdigit():
                    continue
                files = info.get("files") or {}
                if not files:
                    continue
                merged.setdefault((int(step_s), src), []).append(
                    (endpoint, files)
                )
    return [
        (step, src, holders)
        for (step, src), holders in sorted(merged.items(), reverse=True)
    ]


def replicas_by_step(
    manifests: Dict[str, Dict],
) -> Dict[int, List[Tuple[str, str, Dict[str, Dict]]]]:
    """``{step: [(endpoint, src, files), ...]}`` over every holder's
    complete replicas, every source pod: a sharded version's files are
    spread over the pods that saved it, so a restore takes their union."""
    out: Dict[int, List[Tuple[str, str, Dict[str, Dict]]]] = {}
    for step, src, holders in _candidates_from_manifests(manifests):
        for endpoint, files in holders:
            out.setdefault(step, []).append((endpoint, src, files))
    return out


def file_sha(path: str) -> Optional[str]:
    """The sha256 of a file, None when it cannot be read."""
    try:
        return _digest_file(path)
    except OSError:
        return None


def fetch_files(
    into_dir: str, step: int,
    want: Dict[str, Tuple[str, List[Tuple[str, str]]]],
    budget_s: Optional[float] = None,
) -> bool:
    """Fetch ``want`` (``{name: (sha, [(endpoint, src), ...])}``: each
    file's digest and the holders of it) into ``into_dir``, each file
    digest-verified and written by rename; True when every one landed
    within the budget (``EDL_CKPT_REPL_BUDGET``)."""
    t0 = time.monotonic()
    t_end = t0 + (repl_budget() if budget_s is None else float(budget_s))
    missing = {n for n in want if _safe_relpath(n)}
    if len(missing) != len(want):
        return False
    by_holder: Dict[Tuple[str, str], List[str]] = {}
    for name, (_sha, holders) in want.items():
        for holder in holders:
            by_holder.setdefault(holder, []).append(name)
    rx = 0
    srcs = {src for _sha, holders in want.values() for _ep, src in holders}
    label = next(iter(srcs))[:8] if len(srcs) == 1 else "%d pods" % len(srcs)
    with obs_trace.child_span("ckpt_fetch", step=str(step), src=label):
        for (endpoint, src), names in by_holder.items():
            names = sorted(set(names) & missing)
            while names and time.monotonic() <= t_end:
                chunk, names = (names[:_PUSH_CHUNK_FILES],
                                names[_PUSH_CHUNK_FILES:])
                got, truncated = _fetch_chunk(
                    endpoint, src, step, chunk,
                    max(0.5, min(5.0, t_end - time.monotonic())))
                if not got:
                    break  # holder sick or gone: the next one may have it
                names.extend(n for n in truncated if n in missing)
                for name, data in got.items():
                    if name not in missing:
                        continue
                    if _FP_FETCH.armed:
                        try:
                            data = _FP_FETCH.fire(data, name=name[:32])
                        except ConnectionError:
                            continue
                    if hashlib.sha256(data).hexdigest() != want[name][0]:
                        logger.warning("ckpt fetch: digest mismatch for %s",
                                       name[:48])
                        continue
                    if _write_shard(into_dir, name, data):
                        missing.discard(name)
                        rx += len(data)
            if not missing:
                break
    _M_BYTES.inc(rx, dir="rx")
    obs_events.record(
        "ckpt_peer_fetch", fsync=True, step=step,
        outcome="incomplete" if missing else "ok", bytes=rx,
        shards=len(want) - len(missing), want=len(want),
        dur=round(time.monotonic() - t0, 3),
    )
    return not missing


def _fetch_chunk(
    endpoint: str, src: str, step: int, names: List[str], timeout: float
) -> Tuple[Dict[str, bytes], List[str]]:
    from edl_tpu_torch.rpc.wire import request_once

    try:
        resp = request_once(
            endpoint,
            {"i": 1, "m": "ckpt_fetch", "src": src, "step": step,
             "names": names},
            timeout=min(timeout, 30.0),
        )
    except Exception as exc:  # noqa: BLE001
        logger.debug("ckpt fetch from %s failed: %s", endpoint, exc)
        return {}, []
    if not resp.get("ok"):
        return {}, []
    return {
        str(n): bytes(d)
        for n, d in (resp.get("entries") or {}).items()
        if isinstance(d, (bytes, bytearray))
    }, [str(n) for n in (resp.get("truncated") or ())]


def assemble_from_peers(
    into_dir: str,
    client=None,
    endpoint: str = "",
    job_id: str = "",
    deadline: Optional[float] = None,
    step: Optional[int] = None,
) -> Optional[int]:
    """Rebuild a completely-replicated checkpoint step from peer
    holders into ``into_dir`` (the local tier) — the newest one, or the
    pinned ``step``. Returns the step number on success, None when no
    complete step could be assembled — the caller then degrades to the
    durable tier. Every file is digest-verified against the manifest
    and the step dir lands by one atomic rename, so a SIGKILL or a torn
    fetch can never leave a half-step behind a real step name."""
    if not into_dir or not job_id:
        return None
    budget = repl_budget() if deadline is None else float(deadline)
    t_end = time.monotonic() + budget
    owns_client = False
    if client is None:
        if not endpoint:
            return None
        try:
            from edl_tpu_torch.store.client import connect_store

            client = connect_store(endpoint, timeout=min(5.0, budget))
            owns_client = True
        except Exception as exc:  # noqa: BLE001
            logger.debug("ckpt assembly: no store (%s)", exc)
            return None
    try:
        # NOTE: the restoring pod's OWN holder manifest stays in play —
        # the holder is launcher-owned and pod-scoped, so a surviving
        # pod whose worker lost its local tier recovers from the
        # replicas its own pod holds, over loopback (a holder never
        # holds its own pod's checkpoints: the ring excludes self)
        manifests = read_replica_manifests(client, job_id)
        candidates = _candidates_from_manifests(manifests)
        for cand_step, src, holders in candidates:
            if step is not None and cand_step != step:
                continue
            if time.monotonic() > t_end:
                break
            if os.path.isdir(os.path.join(into_dir, str(cand_step))):
                return cand_step  # already present (raced another rank)
            got = _assemble_step(
                into_dir, src, cand_step, holders, t_end
            )
            if got is not None:
                return got
        return None
    finally:
        if owns_client:
            try:
                client.close()
            except Exception:  # noqa: BLE001
                pass


def _assemble_step(
    into_dir: str,
    src: str,
    step: int,
    holders: List[Tuple[str, Dict[str, Dict]]],
    t_end: float,
) -> Optional[int]:
    # the union manifest: any holder's file set for a complete replica
    # is the full set, but a partially-reachable fleet may need several
    want: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {}
    for endpoint, files in holders:
        for name, meta in files.items():
            if _safe_relpath(str(name)):
                want.setdefault(str(name), (meta.get("sha"), []))[1].append(
                    (endpoint, src))
    if not want:
        return None
    os.makedirs(into_dir, exist_ok=True)
    tmp = os.path.join(into_dir, ".peer-%d-%d" % (step, os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.monotonic()
    try:
        ok = fetch_files(tmp, step, want, max(0.0, t_end - t0))
    except Exception as exc:  # noqa: BLE001 — assembly is a tier, not a gate
        logger.warning("ckpt assembly failed (%s); trying next tier", exc)
        ok = False
    if not ok:
        # partial quorum: shards are unrecoverable from the live holders
        # — abandon; the durable tier owns this case
        logger.warning(
            "ckpt assembly of step %d incomplete; degrading to the durable "
            "tier", step,
        )
        shutil.rmtree(tmp, ignore_errors=True)
        return None
    _fsync_dir(tmp)
    dst = os.path.join(into_dir, str(step))
    try:
        os.replace(tmp, dst)
    except OSError as exc:
        logger.warning("ckpt assembly rename failed: %s", exc)
        shutil.rmtree(tmp, ignore_errors=True)
        return None
    _fsync_dir(into_dir)
    logger.info(
        "assembled checkpoint step %d from peer replicas (%d shards, %.2fs)",
        step, len(want), time.monotonic() - t0,
    )
    return step
