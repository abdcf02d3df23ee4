"""Leader-hosted data-dispatch service: elastic task queues with failover.

The full behavior of the reference's legacy Go master — which does not
even compile in the reference tree (SURVEY §2 C22: task queues
Todo/Pending/Done/Failed with per-task failure counts and timeouts,
pkg/master/service.go:23-35, 134-150; state snapshot/recover via the
store under a leader lock, pkg/master/etcd_client.go:99-161) — finished
and tested, speaking the edl_tpu wire protocol. The native C++ twin
(``native/master``) serves the same methods; the Python client drives
either interchangeably.

A *task* is one input file (+ resume offset). Workers pull tasks, report
record progress, and ack done/failed; a pending task whose worker goes
quiet past ``task_timeout`` is re-queued (``failure_max`` strikes → failed
list, epoch completes without it — the reference's straggler policy).

Graceful drain (health plane): a draining worker — or its launcher's
preemption notice arriving as a ``preempt/{pod_id}`` store key, when the
dispatcher was built with a registry — has its in-flight tasks re-queued
IMMEDIATELY at their reported offsets (``drain_worker``), no strike, no
``task_timeout`` wait: a notice is a fact, not a suspicion.

Wire methods:
  add_dataset(files) / new_epoch(e) / get_task(w) / task_done(w, t) /
  task_failed(w, t) / report(w, t, rec) / drain_worker(w) / state / ping

The port's copy of ``edl_tpu/data/dispatcher.py``: the same wire methods
and frames, registry snapshot, service key and ``edl_data_*`` metrics, so
a port worker pulls tasks from a JAX dispatcher and the reverse.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.rpc.wire import (
    TC_FIELD,
    WireError,
    pack_frame,
    read_frame_blocking,
    server_span,
)

_TC = obs_trace.PROPAGATION
from edl_tpu_torch.utils.exceptions import EdlError, serialize_exception
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("data.dispatcher")

_FP_TASK = _fault_point(
    "data.dispatcher.request",
    "one dispatcher RPC (get_task/report/ack): delay or drop (the worker "
    "re-pulls; a quiet task re-queues after task_timeout)",
)

TODO, PENDING, DONE, FAILED = "todo", "pending", "done", "failed"


@dataclass
class DataTask:
    task_id: int
    file_idx: int
    path: str
    start_record: int = 0
    next_record: int = 0
    failures: int = 0
    worker: str = ""
    deadline: float = 0.0

    def public(self) -> dict:
        return {
            "id": self.task_id,
            "file_idx": self.file_idx,
            "path": self.path,
            "start_record": max(self.start_record, self.next_record),
        }


class _Queues:
    def __init__(self) -> None:
        self.todo: List[DataTask] = []
        self.pending: Dict[int, DataTask] = {}
        self.done: Dict[int, DataTask] = {}
        self.failed: Dict[int, DataTask] = {}


class DataDispatcher:
    """The dispatch state machine + its TCP server.

    ``store`` (optional ``(StoreClient, job_id)``) enables failover: state
    snapshots are written under ``data_master/state`` after every mutation
    and recovered on construction — the role of the Go master's etcd
    Save/Load (etcd_client.go:100-161). Leader election among replicas is
    the launcher's job (only the leader pod hosts the dispatcher), so no
    extra lock is taken here.
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        task_timeout: float = 60.0,
        failure_max: int = 3,
        registry=None,  # Registry for snapshot/recover (optional)
        shuffle_seed: Optional[int] = None,
    ) -> None:
        self._lock = threading.Lock()
        self._q = _Queues()
        self._epoch = 0
        self._files: List[str] = []
        self._next_task_id = 0
        self._task_timeout = task_timeout
        self._failure_max = failure_max
        self._registry = registry
        # cursor-snapshot cadence: report() offsets are too hot to
        # snapshot per call (one store put per progress heartbeat), but
        # losing them across a dispatcher restart replays every pending
        # file from its start_record — so reported cursors are flushed
        # to the store on a cadence by the timeout loop instead
        try:
            self._snapshot_every = float(
                os.environ.get("EDL_DATA_SNAPSHOT_EVERY", "2")
            )
        except ValueError:
            self._snapshot_every = 2.0
        self._dirty_reports = False  # edl: guarded-by(self._lock)
        self._last_cursor_snap = 0.0
        # pass_id-as-seed parity (reference train_with_fleet.py:458-464):
        # task order is a pure function of (seed, epoch), so an epoch
        # replayed after resize/restart dispatches files identically
        self._shuffle_seed = shuffle_seed
        if registry is not None:
            self._recover()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._host = host
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

        # observability: queue depths sampled at scrape time (self._q is
        # swapped atomically; len() on a stale generation is harmless),
        # counters on the mutation paths
        self._m_requests = obs_metrics.counter(
            "edl_data_requests_total", "dispatcher RPCs served, by method"
        )
        self._m_timeouts = obs_metrics.counter(
            "edl_data_task_timeouts_total", "pending tasks re-queued on worker timeout"
        )
        self._m_strikes = obs_metrics.counter(
            "edl_data_task_strikes_total", "task failure strikes (timeout or reported)"
        )
        self._m_drain_requeues = obs_metrics.counter(
            "edl_data_drain_requeues_total",
            "in-flight tasks re-queued because their worker drained",
        )
        self._preempt_watch = None
        self._drained_pods: set = set()
        self._obs_gauges = obs_metrics.bind_gauges((
            ("edl_data_todo_tasks", "tasks waiting for a worker",
             lambda: len(self._q.todo)),
            ("edl_data_pending_tasks", "tasks leased to workers",
             lambda: len(self._q.pending)),
            ("edl_data_done_tasks", "tasks completed this epoch",
             lambda: len(self._q.done)),
            ("edl_data_failed_tasks", "tasks dropped after failure_max strikes",
             lambda: len(self._q.failed)),
            ("edl_data_epoch_seq", "current dispatch epoch",
             lambda: self._epoch),
        ))
        # one stable reference: bound-method attribute access mints a new
        # object each time, and release_health compares by identity
        self._health_fn = self.state
        self._obs = obs_http.start_from_env(
            "dispatcher", health_fn=self._health_fn
        )

    @property
    def endpoint(self) -> str:
        """Routable address for publication in the store: wildcard binds
        advertise this host's real IP so cross-host workers can connect."""
        from edl_tpu_torch.utils.net import get_host_ip

        host = self._host if self._host not in ("", "0.0.0.0") else get_host_ip()
        return "%s:%d" % (host, self.port)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DataDispatcher":
        if self._obs is not None and self._registry is not None:
            # advertise the scrape target in the job's obs keyspace so
            # edl-top finds the dispatcher from the store alone
            try:
                self._registry.set_permanent(
                    obs_http.OBS_SERVICE,
                    "dispatcher.d%d" % self.port,
                    obs_http.endpoint_payload(self._obs.endpoint),
                )
            except Exception as exc:  # noqa: BLE001 — fire-and-forget
                logger.warning("dispatcher obs endpoint not registered: %s", exc)
        if self._registry is not None:
            # health plane: a launcher's preemption notice lands here as a
            # preempt/{pod_id} key — requeue that pod's in-flight tasks
            # NOW instead of letting them ride out task_timeout
            try:
                from edl_tpu_torch.cluster.contract import PREEMPT_SERVICE

                self._preempt_watch = self._registry.watch_service(
                    PREEMPT_SERVICE, on_change=self._on_preempt
                )
            except Exception as exc:  # noqa: BLE001 — optional integration
                logger.warning("dispatcher preempt watch not armed: %s", exc)
        for target, name in (
            (self._accept_loop, "dispatch-accept"),
            (self._timeout_loop, "dispatch-timeout"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def _on_preempt(self, snapshot) -> None:
        """Store-watch side of graceful drain: workers carry their pod id
        in their worker-id by convention ("worker-{rank}-{pod_id}"), so a
        noticed pod's in-flight tasks are identified by substring."""
        for pod_id in set(snapshot) - self._drained_pods:
            self._drained_pods.add(pod_id)
            n = self.drain_worker(pod_id, substring=True)
            if n:
                logger.info(
                    "preempt notice for pod %s: re-queued %d in-flight "
                    "task(s)", pod_id[:8], n,
                )

    def drain_worker(self, worker: str, substring: bool = False) -> int:
        """Re-queue a draining worker's in-flight tasks at their reported
        offsets — immediately, without a failure strike (drain is a clean
        departure, not a fault). Returns the number of tasks re-queued.
        ``substring=True`` matches any worker id containing ``worker``
        (how a pod-level notice fans out to that pod's workers)."""
        if not worker:
            return 0
        if substring:
            match = lambda t: worker in t.worker  # noqa: E731
        else:
            match = lambda t: t.worker == worker  # noqa: E731
        with self._lock:
            hits = [t for t in self._q.pending.values() if match(t)]
            for task in hits:
                del self._q.pending[task.task_id]
                self._m_drain_requeues.inc()
                task.worker, task.deadline = "", 0.0
                # resume offset survives: start_record rides next_record
                # through DataTask.public(), so the successor worker picks
                # up at the drained worker's last report
                self._q.todo.insert(0, task)
            if hits:
                logger.info(
                    "drained worker %r: re-queued %d task(s)", worker, len(hits)
                )
                # flight-record the requeue: edl-timeline orders it between
                # the preempt notice and the successor's first pull
                obs_events.record(
                    "data_drain_requeue", fsync=True,
                    worker=worker, requeued=len(hits),
                )
                self._snapshot()
            return len(hits)

    def stop(self) -> None:
        self._stop.set()
        if self._preempt_watch is not None:
            try:
                self._preempt_watch.cancel()
            except Exception:  # noqa: BLE001
                pass
        self._obs_gauges.release()  # don't pin this instance in the registry
        obs_http.release_health("dispatcher", self._health_fn)
        try:
            self._listener.close()
        except OSError:
            pass

    # -- state machine ------------------------------------------------------

    def add_dataset(self, files: List[str]) -> int:
        with self._lock:
            self._files = list(files)
            self._fill_epoch()
            self._snapshot()
            return len(self._files)

    def _fill_epoch(self) -> None:
        self._q = _Queues()
        order = list(range(len(self._files)))
        if self._shuffle_seed is not None:
            import random

            random.Random(
                self._shuffle_seed * 1_000_003 + self._epoch
            ).shuffle(order)
        for idx in order:
            self._q.todo.append(
                DataTask(
                    task_id=self._next_task_id,
                    file_idx=idx,
                    path=self._files[idx],
                )
            )
            self._next_task_id += 1

    def new_epoch(self, epoch: int) -> bool:
        """Advance to ``epoch`` and re-queue every file; requests for the
        current or an older epoch are idempotent no-ops."""
        with self._lock:
            if epoch > self._epoch:
                self._epoch = epoch
                self._fill_epoch()
                obs_events.record(
                    "data_epoch", fsync=True, epoch=epoch,
                    files=len(self._files),
                )
                self._snapshot()
                return True
            return False

    def get_task(self, worker: str) -> dict:
        with self._lock:
            if self._q.todo:
                task = self._q.todo.pop(0)
                task.worker = worker
                task.deadline = time.time() + self._task_timeout
                self._q.pending[task.task_id] = task
                self._snapshot()
                return {"task": task.public(), "epoch": self._epoch}
            if self._q.pending:
                return {"wait": True, "epoch": self._epoch}
            return {"epoch_done": True, "epoch": self._epoch}

    def task_done(self, worker: str, task_id: int) -> bool:
        with self._lock:
            task = self._q.pending.pop(task_id, None)
            if task is None or (task.worker and task.worker != worker):
                if task is not None:  # late ack from a timed-out worker
                    self._q.pending[task_id] = task
                return False
            self._q.done[task_id] = task
            self._snapshot()
            return True

    def task_failed(self, worker: str, task_id: int) -> bool:
        with self._lock:
            task = self._q.pending.pop(task_id, None)
            if task is None:
                return False
            self._strike(task, "worker %s reported failure" % worker)
            self._snapshot()
            return True

    def _strike(self, task: DataTask, why: str) -> None:
        self._m_strikes.inc()
        obs_events.record(
            "data_task_strike", task=task.task_id, path=task.path,
            failures=task.failures + 1, why=why,
        )
        task.failures += 1
        task.worker, task.deadline = "", 0.0
        if task.failures >= self._failure_max:
            logger.error(
                "task %d (%s) failed %d times, dropping: %s",
                task.task_id, task.path, task.failures, why,
            )
            self._q.failed[task.task_id] = task
        else:
            logger.warning(
                "task %d (%s) re-queued (%d strikes): %s",
                task.task_id, task.path, task.failures, why,
            )
            self._q.todo.append(task)

    def report(self, worker: str, task_id: int, next_record: int) -> bool:
        """Progress heartbeat: extends the deadline, records the offset so a
        re-queued task resumes mid-file (exact-resume semantics)."""
        with self._lock:
            task = self._q.pending.get(task_id)
            if task is None or (task.worker and task.worker != worker):
                return False
            task.next_record = max(task.next_record, next_record)
            task.deadline = time.time() + self._task_timeout
            self._dirty_reports = True  # flushed by the timeout loop
            return True

    def state(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "todo": len(self._q.todo),
                "pending": len(self._q.pending),
                "done": len(self._q.done),
                "failed": len(self._q.failed),
                "files": len(self._files),
            }

    def progress(self) -> dict:
        """Export the epoch's per-file position — the payload of an atomic
        model+data checkpoint (:class:`edl_tpu_torch.data.DataCheckpoint`).
        Offsets are the *reported* positions, so a restore replays at most
        the records a worker consumed after its last report."""
        with self._lock:
            offsets = {}
            for t in list(self._q.pending.values()) + self._q.todo:
                pos = max(t.start_record, t.next_record)
                if pos > 0:
                    offsets[str(t.file_idx)] = pos
            return {
                "epoch": self._epoch,
                "offsets": offsets,
                "done": sorted(t.file_idx for t in self._q.done.values()),
            }

    def set_progress(self, epoch: int, offsets: Dict[str, int], done: List[int]) -> bool:
        """Restore the epoch position from a checkpoint: the inverse of
        :meth:`progress`. Rebuilds the queues so files in ``done`` are not
        re-dispatched and every other file resumes at its offset — run by
        the leader after restoring a model checkpoint, so data and model
        state roll back to the SAME instant (stop-resume exactness)."""
        with self._lock:
            self._epoch = epoch
            self._fill_epoch()
            done_set = set(done)
            todo = []
            for t in self._q.todo:
                if t.file_idx in done_set:
                    self._q.done[t.task_id] = t
                else:
                    t.start_record = int(offsets.get(str(t.file_idx), 0))
                    t.next_record = t.start_record
                    todo.append(t)
            self._q.todo = todo
            self._snapshot()
            return True

    def _timeout_loop(self) -> None:
        while not self._stop.wait(min(1.0, self._task_timeout / 4)):
            now = time.time()
            with self._lock:
                expired = [
                    t for t in self._q.pending.values() if t.deadline < now
                ]
                for task in expired:
                    del self._q.pending[task.task_id]
                    self._m_timeouts.inc()
                    self._strike(task, "worker %s timed out" % task.worker)
                # epoch shard-cursor snapshot on a cadence: a dispatcher
                # restart then resumes every pending file from its last
                # REPORTED record offset instead of replaying the epoch
                # tail from each file's start (report() itself never
                # snapshots — one store put per progress heartbeat would
                # swamp the control plane)
                flush_cursors = (
                    self._dirty_reports
                    and now - self._last_cursor_snap >= self._snapshot_every
                )
                if flush_cursors:
                    self._dirty_reports = False
                    self._last_cursor_snap = now
                if expired or flush_cursors:
                    self._snapshot()

    # -- snapshot / recover -------------------------------------------------

    _SNAP_SERVICE = "data_master"

    def _snapshot(self) -> None:
        if self._registry is None:
            return
        state = {
            "epoch": self._epoch,
            "files": self._files,
            "next_task_id": self._next_task_id,
            "todo": [vars(t) for t in self._q.todo],
            # pending tasks are deliberately saved as todo: after a master
            # restart their workers' acks won't match anyway
            "requeue": [vars(t) for t in self._q.pending.values()],
            "done": [vars(t) for t in self._q.done.values()],
            "failed": [vars(t) for t in self._q.failed.values()],
        }
        try:
            self._registry.set_permanent(
                self._SNAP_SERVICE, "state", json.dumps(state).encode()
            )
        except Exception as exc:  # noqa: BLE001 — snapshot is best-effort
            logger.warning("state snapshot failed: %s", exc)

    def _recover(self) -> None:
        meta = self._registry.get_server(self._SNAP_SERVICE, "state")
        if meta is None:
            return
        state = json.loads(meta.value.decode())

        def mk(d):
            t = DataTask(**{k: d[k] for k in (
                "task_id", "file_idx", "path", "start_record",
                "next_record", "failures")})
            return t

        self._epoch = state["epoch"]
        self._files = state["files"]
        self._next_task_id = state["next_task_id"]
        self._q = _Queues()
        self._q.todo = [mk(d) for d in state["todo"]] + [
            mk(d) for d in state["requeue"]
        ]
        self._q.done = {d["task_id"]: mk(d) for d in state["done"]}
        self._q.failed = {d["task_id"]: mk(d) for d in state["failed"]}
        logger.info(
            "recovered dispatcher state: epoch %d, %d todo, %d done",
            self._epoch, len(self._q.todo), len(self._q.done),
        )

    # -- server -------------------------------------------------------------

    _METHODS = {
        "add_dataset": lambda self, req: {"n": self.add_dataset(req["files"])},
        "new_epoch": lambda self, req: {"ok_epoch": self.new_epoch(req["epoch"])},
        "get_task": lambda self, req: self.get_task(req.get("w", "")),
        "task_done": lambda self, req: {
            "acked": self.task_done(req.get("w", ""), req["t"])
        },
        "task_failed": lambda self, req: {
            "acked": self.task_failed(req.get("w", ""), req["t"])
        },
        "report": lambda self, req: {
            "acked": self.report(req.get("w", ""), req["t"], req["rec"])
        },
        "drain_worker": lambda self, req: {
            "requeued": self.drain_worker(req.get("w", ""))
        },
        "state": lambda self, req: self.state(),
        "progress": lambda self, req: self.progress(),
        "set_progress": lambda self, req: {
            "acked": self.set_progress(
                req["epoch"], req.get("offsets", {}), req.get("done", [])
            )
        },
        "ping": lambda self, req: {},
    }

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(sock,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, sock: socket.socket) -> None:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._stop.is_set():
                req = read_frame_blocking(sock)
                rid = req.get("i", 0)
                if _FP_TASK.armed:
                    _FP_TASK.fire(method=str(req.get("m")))  # ChaosDrop resets conn
                handler = self._METHODS.get(req.get("m"))
                # unknown methods share one sentinel label: the method
                # string is client data, not a bounded series key
                self._m_requests.inc(
                    method=str(req.get("m")) if handler else "<unknown>"
                )
                if handler is None:
                    resp = {
                        "i": rid, "ok": False,
                        "err": {"etype": "EdlInternalError",
                                "detail": "unknown method %r" % req.get("m")},
                    }
                else:
                    try:
                        # per-method server latency + caller-linked span
                        # when the request carried a "tc" trace context
                        with server_span(
                            str(req.get("m")), req.get(TC_FIELD),
                            server="data",
                        ):
                            resp = {"i": rid, "ok": True, **handler(self, req)}
                    except Exception as exc:  # noqa: BLE001
                        logger.exception("dispatch %s failed", req.get("m"))
                        resp = {"i": rid, "ok": False,
                                "err": serialize_exception(exc)}
                sock.sendall(pack_frame(resp))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass


class DispatcherClient:
    """Blocking client for the dispatcher (Python or native C++ server)."""

    def __init__(self, endpoint: str, worker_id: str, timeout: float = 30.0) -> None:
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.worker_id = worker_id
        self._next = 0

    def _call(self, method: str, **params) -> dict:
        self._next += 1
        payload = {"i": self._next, "m": method, "w": self.worker_id, **params}
        # trace propagation: one attr load disarmed (wire discipline)
        if _TC.armed and TC_FIELD not in payload:
            tc = obs_trace.inject()
            if tc is not None:
                payload[TC_FIELD] = tc
        self._sock.sendall(pack_frame(payload))
        resp = read_frame_blocking(self._sock)
        if not resp.get("ok"):
            raise ConnectionError(
                "dispatcher %s failed: %s" % (method, resp.get("err"))
            )
        return resp

    def add_dataset(self, files: List[str]) -> int:
        return self._call("add_dataset", files=list(files))["n"]

    def new_epoch(self, epoch: int) -> bool:
        return self._call("new_epoch", epoch=epoch)["ok_epoch"]

    def get_task(self) -> dict:
        return self._call("get_task")

    def task_done(self, task_id: int) -> bool:
        return self._call("task_done", t=task_id)["acked"]

    def task_failed(self, task_id: int) -> bool:
        return self._call("task_failed", t=task_id)["acked"]

    def report(self, task_id: int, next_record: int) -> bool:
        return self._call("report", t=task_id, rec=next_record)["acked"]

    def drain_worker(self) -> int:
        """Graceful drain: hand this worker's in-flight tasks back NOW (no
        timeout wait, no failure strike); returns how many were requeued."""
        return self._call("drain_worker")["requeued"]

    def progress(self) -> dict:
        resp = self._call("progress")
        return {
            "epoch": resp["epoch"],
            "offsets": {int(k): v for k, v in resp.get("offsets", {}).items()},
            "done": list(resp.get("done", [])),
        }

    def set_progress(self, epoch: int, offsets: Dict[int, int], done) -> bool:
        return self._call(
            "set_progress",
            epoch=epoch,
            offsets={str(k): int(v) for k, v in offsets.items()},
            done=[int(x) for x in done],
        )["acked"]

    def state(self) -> dict:
        resp = self._call("state")
        # strip protocol framing (request id / ok flag): callers get the
        # queue-state payload only, like every other client method
        return {k: v for k, v in resp.items() if k not in ("i", "ok")}

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# -- discovery ---------------------------------------------------------------

DISPATCH_SERVICE = "data/dispatcher"


def publish_dispatcher(registry, endpoint: str, ttl: float = 5.0):
    """Leader-side: advertise a live dispatcher endpoint in the store.

    LEASED on purpose — a dead leader's entry expires instead of sending
    the next stage's workers to a closed port. Returns the Registration
    (keep it referenced; its keeper renews the lease)."""
    return registry.register(DISPATCH_SERVICE, endpoint, b"1", ttl=ttl)


def discover_dispatcher(
    registry, timeout: float = 60.0, probe_timeout: float = 2.0
) -> str:
    """Worker-side: find a LIVE dispatcher endpoint.

    Every advertised endpoint is liveness-probed (connect + ``state``)
    before adoption: a stage transition can leave the dead leader's
    endpoint in the registry until its lease expires, and blindly taking
    ``entries[0]`` crash-loops the new stage's workers on
    ConnectionRefused (observed under churn: rank 0 then waits out the
    full process-group shutdown timeout and the job dies)."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        for meta in registry.get_service(DISPATCH_SERVICE):
            probe = None
            try:
                probe = DispatcherClient(
                    meta.name, "probe", timeout=probe_timeout
                )
                probe.state()
                return meta.name
            except (OSError, EdlError, WireError):
                continue
            finally:
                if probe is not None:
                    probe.close()
        time.sleep(0.1)
    raise TimeoutError(
        "no live dispatcher endpoint within %.0fs" % timeout
    )
