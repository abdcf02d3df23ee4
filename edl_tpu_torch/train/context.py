"""Worker-side job bootstrap: join the distributed runtime, barrier.

The port of ``edl_tpu/train/context.py``, the parts a stop-resume worker
runs. :func:`init` reads the ``EDL_*`` contract the launcher sets
(``edl_tpu/launch/process.py``) and, in a multi-worker stage, joins
``torch.distributed`` where the JAX package calls
``jax.distributed.initialize``: rank 0's published coordinator endpoint
hosts the rendezvous (``tcp://`` init), NCCL on the card, gloo when the
caller asks for the CPU.

Under stop-resume every stage restarts the worker processes, so ``init``
is a fresh-process bootstrap; the stage token is part of every barrier
key. The in-process half is here too: :class:`StageMonitor` and
:func:`reinit_for_stage` adopt a new stage without a restart (hot
restage: the process group is torn down and joined again, the trainer
keeps its module and optimizer), and :class:`HealthMonitor` turns a
preemption notice into a graceful drain.

Every multi-worker stage also builds a second, gloo group for the
checkpoint manager's background writes (:func:`checkpoint_group`): an
async save runs DCP's collectives on a thread while the step's all-reduces
run on the default group, and the two must never share a group.

Backend rule: NCCL on the card, gloo for the CPU, and gloo over the
card's tensors when two ranks of the stage would share a card (NCCL
refuses two ranks on one device) — :func:`group_backend`, decided alike
on every rank.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

from edl_tpu_torch.cluster.contract import (  # shared with launch/launcher.py
    CLUSTER_SERVICE,
    DRAIN_SERVICE,
    DRAINED_EXIT,
    HEARTBEAT_SERVICE,
    HOT_RESTAGE_EXIT,
    HOTADOPT_SERVICE,
    PREEMPT_SERVICE,
)
from edl_tpu_torch.cluster.job_env import WorkerEnv
from edl_tpu_torch.utils.exceptions import EdlBarrierError
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("train.context")

__all__ = [
    "DRAINED_EXIT", "HOT_RESTAGE_EXIT", "HealthMonitor", "StageMonitor",
    "checkpoint_group", "current_env", "group_backend",
    "hot_restage_enabled", "init", "reinit_for_stage", "warm_only",
    "worker_barrier",
]

_env: Optional[WorkerEnv] = None
_distributed_up = False  # torch.distributed joined by a previous init()
_ckpt_group = None  # the stage's gloo group for background checkpoint writes
_cache_noted = False

# the default of jax.distributed.initialize: a dead peer must not wedge the
# rendezvous for torch's 30 minutes; the launcher's deadline does the rest
DIST_INIT_TIMEOUT = datetime.timedelta(seconds=300)
# a checkpoint write's collectives wait while rank 0 writes the version
CKPT_GROUP_TIMEOUT = datetime.timedelta(seconds=300)


def hot_restage_enabled() -> bool:
    """True when the job runs in hot-restage mode (``EDL_HOT_RESTAGE=1``):
    surviving workers adopt new stages IN-PROCESS instead of being killed
    and respawned — process group torn down and joined again, checkpoint
    restored into the live model — skipping the interpreter, import and
    state-construction cold start that dominates stop-resume downtime."""
    return os.environ.get("EDL_HOT_RESTAGE") == "1"


def warm_only() -> bool:
    """True inside a cache-warming shadow stage (``EDL_WARM_ONLY=1``,
    spawned by the launcher's warmer): the training script runs a couple
    of steps and exits 0 without checkpoint writes or store traffic.
    ``ElasticTrainer.fit`` honors this automatically."""
    return os.environ.get("EDL_WARM_ONLY") == "1"


_boot_recorded = False


def _record_boot_span(obs_trace) -> None:
    """Once per process: a ``worker_boot`` restage-trace segment from the
    launcher's spawn stamp (``EDL_SPAWN_TS``) to now — the interpreter +
    import cold start, which no in-process code can otherwise observe."""
    global _boot_recorded
    if _boot_recorded:
        return
    _boot_recorded = True
    raw = os.environ.get("EDL_SPAWN_TS", "")
    if not raw:
        return
    try:
        age = time.time() - float(raw)
    except ValueError:
        return
    if not 0.0 < age < 3600.0:
        return  # a clock step or an inherited stale stamp: drop it
    obs_trace.get_tracer().record(
        "worker_boot", time.monotonic() - age, age
    )


def _note_compile_cache(env: WorkerEnv) -> None:
    """The JAX package points XLA's persistent cache at
    ``EDL_COMPILE_CACHE_DIR``; the port compiles nothing at run time (eager
    PyTorch, kernels built once per source), so the directory has no use
    until the ``torch.compile`` question of ROADMAP M22 is settled."""
    global _cache_noted
    if env.compile_cache_dir and not _cache_noted:
        _cache_noted = True
        logger.info(
            "EDL_COMPILE_CACHE_DIR=%s is not used: the port has no compile "
            "cache until ROADMAP M22", env.compile_cache_dir,
        )


_obs_registered: Optional[tuple] = None


def _mount_obs(env: WorkerEnv) -> None:
    """Worker-side observability mount: /metrics + /healthz (gated on
    ``EDL_OBS_PORT``) plus endpoint registration in the job's obs
    keyspace so ``edl-top`` finds every worker. Re-registers when the
    (stage, rank) changes — a hot restage can move this process to a new
    rank. Never raises: obs must not break worker bootstrap."""
    global _obs_registered
    if warm_only():
        return  # shadow stages must not pollute the job's obs keyspace
    try:
        from edl_tpu_torch.obs import http as obs_http

        server = obs_http.start_from_env(
            "worker",
            health_fn=lambda: {
                "rank": current_env().global_rank,
                "world": current_env().world_size,
                "stage": current_env().stage[:8],
            },
        )
        if server is None or not env.store_endpoint or not env.job_id:
            return
        key = (env.stage, env.global_rank)
        if _obs_registered == key:
            return
        from edl_tpu_torch.store.client import connect_store

        client = connect_store(env.store_endpoint, timeout=2.0)
        try:
            obs_http.register_endpoint(
                client, env.job_id, "worker", "w%d" % env.global_rank,
                server.endpoint,
            )
        finally:
            client.close()
        _obs_registered = key
    except Exception as exc:  # noqa: BLE001
        logger.warning("worker obs mount failed: %s", exc)


def busiest_host(env: WorkerEnv) -> int:
    """The most ranks of the stage on one host, counted from the published
    worker endpoints (one ``host:port`` per rank, the same list on every
    rank). Without endpoints one pod's ranks are all that is known."""
    hosts = [ep.rsplit(":", 1)[0] for ep in env.worker_endpoints]
    if not hosts:
        return max(1, env.nproc_per_node)
    return max(hosts.count(h) for h in set(hosts))


def group_backend(env: WorkerEnv, device_type: str, cards: int) -> str:
    """The process group's backend for this stage, decided from the whole
    stage so that every rank picks the same one: gloo for the CPU; on the
    card NCCL, unless two ranks of the stage would share a card. ``init``
    gives each rank card ``rank_in_pod % cards``, so two ranks share one
    when a pod runs more ranks than its host has cards, or when a host
    runs more than one pod (each pod starts at card 0). NCCL refuses two
    ranks on one device ("Duplicate GPU detected"), so those stages run
    gloo over the card's tensors (DDP's all-reduce and broadcast stage
    them through the host). ``cards`` is this host's count; the stage's
    hosts are taken to have as many (one job runs on like machines)."""
    if device_type != "cuda":
        return "gloo"
    per_pod = max(1, env.nproc_per_node)
    if per_pod > max(cards, 1) or busiest_host(env) > per_pod:
        return "gloo"
    return "nccl"


def init(env: Optional[WorkerEnv] = None, device="cuda") -> WorkerEnv:
    """Join the job: returns the worker env; in multi-worker stages also
    joins ``torch.distributed`` (rank 0's endpoint is the coordinator) and,
    on the card, selects this worker's device (``rank_in_pod``).

    ``device`` picks the backend: NCCL for ``"cuda"`` (the default; raises
    without CUDA), gloo for ``"cpu"``. A one-worker stage builds no
    process group, as the JAX package builds no distributed client.

    Idempotent per process: user scripts call it for the env, and
    ``ElasticTrainer.fit`` calls it again — only the first call joins.
    :func:`reinit_for_stage` tears the group down first, so a hot
    restage joins the new stage's group here.
    """
    global _env, _distributed_up
    env = env or WorkerEnv()
    _env = env
    if not warm_only():
        # goodput: from process start (stop-resume respawn) or in-process
        # re-init until training resumes, the wall-clock is restage cost
        from edl_tpu_torch.obs import goodput as obs_goodput

        obs_goodput.enter("restage", cause="init")
    if env.stage and not warm_only():
        # distributed tracing: this worker's restage window — boot, the
        # process-group join, restore, first step — stitches into the
        # stage's restage trace (the trace id derives from the stage token)
        from edl_tpu_torch.obs import trace as obs_trace

        obs_trace.begin_process_op(
            "restage", env.stage, rank=str(env.global_rank)
        )
        _record_boot_span(obs_trace)
    _note_compile_cache(env)
    _mount_obs(env)
    if _distributed_up or env.world_size <= 1 or not env.coordinator:
        return env
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = group_backend(env, dev.type, cards)
    if dev.type == "cuda":
        torch.cuda.set_device(env.rank_in_pod % cards)
    logger.info(
        "worker %d/%d joining stage %s (coordinator %s, %s; %d rank(s) a "
        "pod, at most %d on one host, %d card(s))",
        env.global_rank, env.world_size, env.stage[:8] or "-",
        env.coordinator, backend, env.nproc_per_node, busiest_host(env),
        cards,
    )
    from edl_tpu_torch.obs import trace as obs_trace

    # restage-trace segment: the join barriers on the slowest joiner
    with obs_trace.child_span("dist_init", world=str(env.world_size)):
        dist.init_process_group(
            backend,
            init_method="tcp://" + env.coordinator,
            world_size=env.world_size,
            rank=env.global_rank,
            timeout=DIST_INIT_TIMEOUT,
        )
        checkpoint_group()
    _distributed_up = True
    return env


def checkpoint_group():
    """The stage's process group for checkpoint writes (gloo, all ranks),
    built with the stage's group (collective: every rank calls this at
    the same point — :func:`init`, or the first save of a caller that
    joined ``torch.distributed`` itself); None without a process group."""
    global _ckpt_group
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _ckpt_group is None:
        _ckpt_group = dist.new_group(backend="gloo", timeout=CKPT_GROUP_TIMEOUT)
    return _ckpt_group


def current_env() -> WorkerEnv:
    return _env if _env is not None else WorkerEnv()


# -- hot restage (in-process stage adoption) --------------------------------


class StageMonitor:
    """Worker-side watch of the job's drain token and published cluster.

    The stop-resume contract learns about stage changes by being killed;
    a hot-restage worker learns by watching the same store keys the
    launcher does: a drain-token bump ≠ my stage sets ``restage_pending``
    (checked between train steps), and ``wait_for_my_stage`` then blocks
    until the leader publishes the new generation. ``mark_adopted``
    reports success back to the launcher, which kills+respawns any worker
    that misses its adoption deadline (the dirty fallback: a peer death
    can leave this process wedged in a collective, where only the
    group's abort or the launcher's kill can recover it)."""

    def __init__(self, env: WorkerEnv) -> None:
        from edl_tpu_torch.discovery.registry import Registry
        from edl_tpu_torch.store.client import connect_store

        self._client = connect_store(env.store_endpoint, timeout=10.0)
        self._registry = Registry(self._client, env.job_id)
        self._stage = env.stage
        self._changed = threading.Event()
        # wall time the token was first seen past this stage: the start
        # of the hot restage's time to recover
        self.pending_since: Optional[float] = None
        # a watch may call back before both exist: _token reads nothing
        self._drain = self._cluster = None
        self._drain = self._registry.watch_service(
            DRAIN_SERVICE, on_change=self._on_change
        )
        self._cluster = self._registry.watch_service(
            CLUSTER_SERVICE, on_change=self._on_change
        )
        self._on_change()

    def _token(self) -> str:
        if self._drain is None:
            return ""
        meta = self._drain.snapshot().get("token")
        return meta.value.decode() if meta else ""

    def _on_change(self, _snapshot=None) -> None:
        token = self._token()
        if token and token != self._stage and not self._changed.is_set():
            self.pending_since = time.time()
            self._changed.set()

    @property
    def restage_pending(self) -> bool:
        return self._changed.is_set()

    def wait_for_my_stage(self, pod_id: str, timeout: float = 20.0):
        """Block until the CURRENT token's generation is published with
        ``pod_id`` in it; returns the Cluster, or None when this pod is
        excluded from the generation or nothing converges in time."""
        from edl_tpu_torch.cluster.model import Cluster

        deadline = time.time() + timeout
        while time.time() < deadline:
            token = self._token()
            meta = self._cluster.snapshot().get("current")
            if token and meta is not None:
                cluster = Cluster.from_json(meta.value)
                if cluster.stage == token:
                    return cluster if cluster.get_pod(pod_id) else None
            time.sleep(0.05)
        return None

    def arm(self, stage: str) -> None:
        """Reset for a newly adopted stage (and immediately re-flag if the
        token has already moved past it)."""
        self._stage = stage
        self._changed.clear()
        self.pending_since = None
        self._on_change()

    def mark_adopted(self, pod_id: str, rank_in_pod: int, stage: str) -> None:
        self._registry.set_permanent(
            HOTADOPT_SERVICE, "%s.%d" % (pod_id, rank_in_pod), stage.encode()
        )

    def close(self) -> None:
        for watch in (self._drain, self._cluster):
            if watch is None:
                continue
            try:
                watch.cancel()
            except Exception:
                pass
        self._client.close()


# -- health plane (graceful drain + progress heartbeat) ----------------------


class HealthMonitor:
    """Worker-side half of the health plane.

    Watches the job's ``preempt/{pod_id}`` key — published by the launcher
    when it receives an advance preemption notice (SIGTERM/SIGUSR1), or by
    an operator directly — and exposes the drain deadline so the training
    loop can take an emergency checkpoint between steps and exit with
    ``DRAINED_EXIT``. Also publishes the per-step progress heartbeat
    (``heartbeat/{pod_id}.{rank_in_pod}``) the launcher-side straggler
    watchdog reads; publication is throttled to ``EDL_HEARTBEAT_EVERY``
    seconds (default 1.0) and strictly fire-and-forget — a sick store must
    never stall a training step (any failure backs off for 5 s).

    Notice delivery is belt-and-suspenders: the watch is the fast path,
    and :meth:`heartbeat` re-reads the pod's own preempt key about once a
    second — a watch event lost to a reconnect race costs at most that
    second, never the whole drain window.
    """

    _POLL_EVERY = 1.0  # direct preempt-key read cadence (watch-miss floor)

    def __init__(self, env: WorkerEnv, min_interval: Optional[float] = None) -> None:
        from edl_tpu_torch.discovery.registry import Registry
        from edl_tpu_torch.store.client import connect_store

        self._env = env
        self._client = connect_store(env.store_endpoint, timeout=2.0)
        self._registry = Registry(self._client, env.job_id or "job")
        self._hb_key = "/%s/%s/%s.%d" % (
            env.job_id, HEARTBEAT_SERVICE, env.pod_id, env.rank_in_pod,
        )
        self._preempt_key = "/%s/%s/%s" % (
            env.job_id, PREEMPT_SERVICE, env.pod_id,
        )
        if min_interval is None:
            min_interval = float(os.environ.get("EDL_HEARTBEAT_EVERY", "1.0"))
        self._min_interval = min_interval
        self._last_pub = 0.0
        self._last_poll = 0.0
        self._backoff_until = 0.0
        self._deadline: Optional[float] = None
        self._noticed = threading.Event()
        self._watch = self._registry.watch_service(
            PREEMPT_SERVICE, on_change=self._on_change
        )
        self._on_change(self._watch.snapshot())

    @property
    def store_client(self):
        """The health plane's store client, shared with sibling
        best-effort planes so one worker holds one store connection."""
        return self._client

    def _apply_notice(self, value: bytes) -> None:
        import json as _json

        try:
            payload = _json.loads(value)
            deadline = float(payload.get("deadline", 0)) or None
        except (ValueError, TypeError):
            deadline = None
        self._deadline = deadline
        self._noticed.set()

    def _on_change(self, snapshot=None) -> None:
        if snapshot is None:
            snapshot = self._watch.snapshot()
        meta = snapshot.get(self._env.pod_id)
        if meta is None:
            return
        self._apply_notice(meta.value)

    @property
    def drain_notice(self) -> bool:
        """True once this pod has been told to drain."""
        return self._noticed.is_set()

    @property
    def drain_deadline(self) -> Optional[float]:
        """Wall-clock deadline of the notice (None = no notice, or one
        without a parseable deadline — drain immediately, best effort)."""
        return self._deadline

    def drain_budget_left(self, floor: float = 0.5) -> float:
        """Seconds the emergency checkpoint may still spend."""
        if self._deadline is None:
            return floor
        return max(floor, self._deadline - time.time())

    def heartbeat(self, step: int, dt: float = 0.0) -> None:
        """Publish step progress (throttled, fire-and-forget)."""
        now = time.time()
        if now < self._backoff_until:
            return
        if not self._noticed.is_set() and now - self._last_poll >= self._POLL_EVERY:
            # watch-miss insurance: one direct read of the preempt key
            self._last_poll = now
            try:
                raw = self._client.get(self._preempt_key)
                if raw is not None:
                    self._apply_notice(raw)
            except Exception as exc:  # noqa: BLE001 — never stall a step
                self._backoff_until = now + 5.0
                logger.debug("preempt poll failed: %s", exc)
                return
        if now - self._last_pub < self._min_interval:
            return
        import json as _json

        try:
            self._client.put(
                self._hb_key,
                _json.dumps(
                    {
                        "step": int(step),
                        "ts": now,
                        "dt": round(float(dt), 4),
                        "stage": self._env.stage,
                    }
                ).encode(),
            )
            self._last_pub = now
        except Exception as exc:  # noqa: BLE001 — never stall a train step
            self._backoff_until = now + 5.0
            logger.debug("heartbeat publish failed: %s", exc)

    def record_drained(self, step: int) -> None:
        """Best-effort 'drained' telemetry event + final heartbeat, written
        right before the worker exits with ``DRAINED_EXIT``."""
        from edl_tpu_torch.obs import events as obs_events
        from edl_tpu_torch.obs import goodput as obs_goodput
        from edl_tpu_torch.obs import trace as obs_trace
        from edl_tpu_torch.utils import telemetry

        obs_goodput.enter("drain", cause="preempt")
        # the drain op's closing segment (zero-duration anchor): marks
        # the trace complete for edl-trace even when no emergency save ran
        obs_trace.get_tracer().record(
            "drained", time.monotonic(), 0.0, step=str(step)
        )
        obs_events.record(
            "drained", fsync=True, step=step,
            pod=self._env.pod_id, rank=self._env.global_rank,
        )
        self._min_interval = 0.0  # the exit heartbeat must not be throttled
        self._backoff_until = 0.0
        self.heartbeat(step)
        telemetry.record_event(
            self._client, self._env.job_id, self._env.stage, "drained",
            "w%d" % self._env.global_rank,
        )

    def close(self) -> None:
        try:
            self._watch.cancel()
        except Exception:  # noqa: BLE001
            pass
        self._client.close()


def _teardown_group() -> str:
    """Leave the current process group; returns how. NCCL: abort the
    communicators (``_abort_process_group``), which returns at once —
    a plain ``destroy_process_group`` runs NCCL's orderly shutdown, which
    can wait forever on a peer that died mid-collective, the very event
    that triggers most restages. Gloo: ``destroy_process_group`` (its
    pairs close their sockets; nothing waits on the peer). The
    checkpoint group goes with the default group and :func:`init` builds
    the next stage's; the trainer's checkpoint manager has finished its
    in-flight save before this runs (its ``close`` waits). So does the
    stage's DeviceMesh (``parallel.mesh``): its ``dp`` and ``fsdp``
    sub-groups were built from this group and go with it, and the next
    stage's ``make_mesh`` builds its own."""
    global _distributed_up, _ckpt_group
    import torch.distributed as dist

    from edl_tpu_torch.parallel.mesh import forget_stage_mesh

    _distributed_up = False
    _ckpt_group = None  # destroyed with the default group below
    forget_stage_mesh()
    if not (dist.is_available() and dist.is_initialized()):
        return "none"
    if dist.get_backend() == "nccl":
        from torch.distributed import distributed_c10d

        abort = getattr(distributed_c10d, "_abort_process_group", None)
        if abort is not None:
            abort()
            if dist.is_initialized():
                dist.destroy_process_group()
            return "nccl-abort"
    dist.destroy_process_group()
    return "destroy"


def reinit_for_stage(cluster, pod_id: str, rank_in_pod: int,
                     device="cuda") -> WorkerEnv:
    """Adopt ``cluster``'s stage in-process: recompute this worker's env
    from the published generation, tear the old process group down and
    re-run :func:`init` (which joins the new stage's group at world > 1).

    Unlike the JAX package — which must clear its backends, so every
    array and compiled function of the previous stage is dead — the
    module, the optimizer and the loaded kernels survive: the caller
    re-wraps the module for the new group and restores the newest
    checkpoint into it. Raises on anything dirty; callers translate that
    into a ``HOT_RESTAGE_EXIT`` respawn request.
    """
    from edl_tpu_torch.obs import goodput as obs_goodput

    obs_goodput.enter("restage", cause="hot_restage")
    pod = cluster.get_pod(pod_id)
    if pod is None:
        raise RuntimeError("pod %s not in stage %s" % (pod_id, cluster.stage))
    worker = next(
        (w for w in pod.workers if w.rank_in_pod == rank_in_pod), None
    )
    if worker is None:
        raise RuntimeError(
            "rank_in_pod %d not in pod %s for stage %s"
            % (rank_in_pod, pod_id, cluster.stage)
        )
    os.environ.update(
        {
            "EDL_STAGE": cluster.stage,
            "EDL_WORKER_RANK": str(worker.global_rank),
            "EDL_NUM_WORKERS": str(cluster.world_size),
            "EDL_COORDINATOR": cluster.coordinator,
            "EDL_WORKER_ENDPOINTS": ",".join(cluster.worker_endpoints()),
        }
    )
    how = _teardown_group()
    new_env = WorkerEnv()
    logger.info(
        "hot restage: adopting stage %s as rank %d/%d (coordinator %s; "
        "old group: %s)",
        new_env.stage[:8], new_env.global_rank, new_env.world_size,
        new_env.coordinator, how,
    )
    return init(new_env, device=device)


_barrier_rounds: dict = {}


def worker_barrier(name: str, timeout: float = 600.0, ttl: float = 10.0) -> None:
    """Control-plane barrier across all workers of the current stage.

    Capability parity with the reference's leader-hosted ``Barrier`` RPC
    (python/edl/utils/pod_server.py:63, pod_client.py:37), built on the
    store instead of a dedicated server: every worker registers
    ``barrier/{stage}:{name}#{round}/{rank}`` (leased) and waits until all
    ``world_size`` ranks are present. The per-process round counter makes
    the same barrier name reusable back-to-back: keys from round N (left
    to lease expiry) can never satisfy round N+1. All ranks hit barriers
    in program order, so counters agree across processes; a restarted
    worker resets to round 0 together with everyone else because restarts
    only happen at stage changes and the stage is part of the key.
    """
    env = current_env()
    if env.world_size <= 1 or not env.store_endpoint:
        return
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.store.client import connect_store

    round_key = (env.stage, name)
    seq = _barrier_rounds.get(round_key, 0)
    _barrier_rounds[round_key] = seq + 1
    service = "barrier/%s:%s#%d" % (env.stage or "static", name, seq)
    client = connect_store(env.store_endpoint, timeout=min(timeout, 30.0))
    try:
        registry = Registry(client, env.job_id or "job")
        # push-based wait: the store watch wakes us on every membership
        # change (the reference polls its leader barrier RPC at ~3 Hz,
        # pod_client.py:37; early rounds here polled at 20 Hz)
        full = threading.Event()
        seen = [0]

        def on_change(snapshot):
            seen[0] = len(snapshot)
            if len(snapshot) >= env.world_size:
                full.set()

        watch = registry.watch_service(service, on_change=on_change)
        reg = registry.register(service, str(env.global_rank), b"1", ttl=ttl)
        try:
            if not full.wait(timeout):
                raise EdlBarrierError(
                    "barrier %r timed out: %d/%d workers"
                    % (name, seen[0], env.world_size)
                )
        finally:
            watch.cancel()
            reg.stop(delete=False)  # leave the key; lease expiry cleans up
    finally:
        client.close()
