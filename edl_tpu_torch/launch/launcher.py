"""The elastic launcher: rank racing, stage fencing, stop-resume supervision.

Capability parity with the reference's v0.2 flagship
(python/edl/collective/launch.py:162-244: register → barrier → watch →
spawn → on change kill/re-register/re-barrier/respawn), re-designed as an
explicit event-driven state machine — the reference's resize branch is its
weakest code (undefined names at launch.py:213/223) and its timing rests on
a hard-coded ``sleep(15) > lease TTL 10`` (launch.py:228-230); here every
transition is driven by store watch events and lease-expiry convergence.

Store layout under the job root (all via :class:`Registry`):

- ``pod_resource/{pod_id}`` -> Pod json, leased     (proof of life; ≙ reference
  PodResourceRegister, register.py:178)
- ``pod_rank/{slot}``       -> pod_id, leased       (contended ordering slots,
  0..max_nodes-1; ≙ PodRankRegister's rank race, register.py:72-114. Slots
  need NOT stay contiguous: the *minimum live slot* is the leader, so a
  dead rank-0 never wedges the job.)
- ``drain/token``           -> uuid                  (the fencing token. Any
  membership change is broadcast by CAS-bumping it; the value IS the stage
  every pod runs under — ≙ the reference's leader-stamped stage uuid,
  register.py:135 — so "which cluster generation am I in" and "was a drain
  requested" are one atomic datum.)
- ``cluster/current``       -> Cluster json          (leader-published; pods
  spawn workers if and only if they appear in it, with its stage in env)
- ``status/{pod_id}``       -> COMPLETE, permanent   (≙ register.complete())
- ``job/status``            -> COMPLETE              (leader-aggregated)
- ``preempt/{pod_id}``      -> json, permanent       (health plane: this pod
  received an advance preemption notice — SIGTERM/SIGUSR1 — and is
  draining. Payload ``{"deadline": wall-ts, "budget": s, "ts": ...}``.
  The leader treats noticed pods as already gone: the next generation
  excludes them with NO lease-expiry wait and NO failure-grace hold,
  while the pod's own workers see the key through their store watch,
  take an emergency best-effort checkpoint inside the budget, and exit
  ``DRAINED_EXIT`` — which every supervisor treats as a clean departure.)
- ``heartbeat/{pod}.{rank}`` -> json, permanent      (health plane: per-step
  worker progress ``{"step", "ts", "dt", "stage"}``. The launcher-side
  straggler watchdog compares each LOCAL worker's heartbeat age against
  a peer-median-derived deadline — a worker that is behind its peers AND
  quiet past the deadline is wedged (dead collective, stuck I/O) and is
  ejected via kill + drain; uniformly slow stages eject nobody.)

This is the port's copy of ``edl_tpu/launch/launcher.py``: the same state
machine, store keys, metric names and worker env, over the port's own
store client and process manager, with the JAX launcher's pod-scoped
planes: the checkpoint replica holder (``checkpoint/replicate.
ReplicaServer``) under ``EDL_CKPT_LOCAL_BASE``, the compile-cache exchange
(``train/aot.CacheExchange``) over a compile cache dir, the prewarmer
(``launch/warm.py``, ``--prewarm``) and the standby worker shells
(``launch/standby.py``, ``--standby``).

The elastic contract is stop-resume, exactly the reference's
(doc/edl_collective_design_doc.md): on any membership change every pod
kills its workers and the job restarts from the last checkpoint under a new
stage with the new world size. Worker processes get the ``EDL_*`` env
(process.py) and call :func:`edl_tpu_torch.train.init`, which joins
``torch.distributed`` at the published coordinator — the reference's
``PADDLE_TRAINER_*`` → NCCL bootstrap.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from edl_tpu_torch.chaos.plane import arm_from_env as _chaos_arm
from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.cluster.job_env import JobEnv, local_device_count
from edl_tpu_torch.cluster.model import Cluster, Pod, Worker, new_uuid
from edl_tpu_torch.discovery.registry import Registration, Registry
from edl_tpu_torch.launch import process as procs_mod
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import memory as obs_memory
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.store.client import connect_store
from edl_tpu_torch.utils import telemetry
from edl_tpu_torch.utils.exceptions import EdlStoreError
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.net import find_free_ports, get_host_ip

logger = get_logger("launch")

_FP_LOOP = _fault_point(
    "launch.launcher.loop",
    "one supervision-loop pass: kill (pod/machine death) or delay",
)
_FP_NOTICE = _fault_point(
    "launch.drain.notice",
    "handling a preemption notice: delay (slow store eats into the drain "
    "budget) or drop (the preempt publication fails; drain proceeds "
    "best-effort)",
)

# store layout + worker exit contract shared with train/context.py
from edl_tpu_torch.cluster.contract import (  # noqa: E402 (module docstring above)
    CLUSTER_SERVICE,
    COMPLETE,
    DRAIN_SERVICE,
    DRAINED_EXIT,
    HEARTBEAT_SERVICE,
    HOT_RESTAGE_EXIT,
    HOTADOPT_SERVICE,
    JOB_SERVICE,
    PREEMPT_SERVICE,
    RANK_SERVICE,
    RES_SERVICE,
    SCALE_SERVICE,
    STATUS_SERVICE,
)


def stalled_workers(
    heartbeats: Dict[str, dict],
    mine: Sequence[str],
    now: float,
    abs_deadline: float = 300.0,
    factor: float = 8.0,
    floor: float = 5.0,
) -> List[str]:
    """The watchdog's decision function, pure so it is unit-testable.

    ``heartbeats``: ``{"{pod}.{rank}": {"step": N, "ts": wall}}`` for ONE
    stage; ``mine``: the subset of keys this launcher supervises. A local
    worker is stalled when either

    - its heartbeat age exceeds ``abs_deadline`` (a forever-wedge bound
      that needs no peers; 0 disables), or
    - it is *behind* some peer's step AND its age exceeds
      ``max(floor, factor x median(peer ages))`` — being behind is what
      separates a wedged worker from a uniformly slow stage, where every
      age grows together and nobody is ejected.
    """
    ages = {k: now - float(h.get("ts", now)) for k, h in heartbeats.items()}
    steps = {k: int(h.get("step", -1)) for k, h in heartbeats.items()}
    out: List[str] = []
    for key in mine:
        if key not in heartbeats:
            continue  # no heartbeat yet this stage: spawn/restore in flight
        age = ages[key]
        if abs_deadline > 0 and age > abs_deadline:
            out.append(key)
            continue
        peers = [k for k in heartbeats if k != key]
        if not peers:
            continue
        peer_ages = sorted(ages[k] for k in peers)
        median = peer_ages[len(peer_ages) // 2]
        behind = steps[key] < max(steps[k] for k in peers)
        if behind and age > max(floor, factor * median):
            out.append(key)
    return out


class ElasticLauncher:
    def __init__(
        self,
        job_env: JobEnv,
        training_script: str,
        training_args: Sequence[str] = (),
        ttl: float = 10.0,
        poll_interval: float = 0.2,
        extra_worker_env: Optional[Dict[str, str]] = None,
        prewarm: bool = False,
        standby: bool = False,
        hot_restage: bool = False,
        fail_grace: Optional[float] = None,
        drain_budget: Optional[float] = None,
    ) -> None:
        self.job_env = job_env
        self.training_script = training_script
        self.training_args = list(training_args)
        self.ttl = ttl
        self.poll = poll_interval
        self.extra_worker_env = dict(extra_worker_env or {})
        # worker-crash grace window before abandoning the job (historically
        # hardcoded 3xTTL): a peer pod's death kills healthy workers too,
        # and the restage must win the race against "leave the job"
        if fail_grace is None:
            fail_grace = float(
                os.environ.get("EDL_FAIL_GRACE", 0) or max(3.0 * ttl, 3.0)
            )
        self.fail_grace = fail_grace
        # graceful drain: how long a noticed pod may spend on its
        # emergency checkpoint before the launcher kills what remains
        if drain_budget is None:
            drain_budget = float(os.environ.get("EDL_DRAIN_BUDGET", "10"))
        self.drain_budget = drain_budget
        # straggler watchdog knobs (see stalled_workers above)
        self.stall_abs = float(os.environ.get("EDL_STALL_DEADLINE", "300"))
        self.stall_factor = float(os.environ.get("EDL_STALL_FACTOR", "8"))
        self.stall_floor = float(
            os.environ.get("EDL_STALL_FLOOR", 0) or max(5.0, 2.0 * ttl)
        )
        self.prewarm = prewarm
        self.warmer = None  # created on first adopted stage
        # the elastic window rides the worker env contract so the AOT
        # resize ladder (train/aot.py) can enumerate its neighbor worlds
        self.extra_worker_env.setdefault(
            "EDL_NODES_RANGE",
            "%d:%d" % (job_env.min_nodes, job_env.max_nodes),
        )
        self.extra_worker_env.setdefault(
            "EDL_NPROC_PER_NODE", str(job_env.nproc_per_node)
        )
        self.cache_exchange = None  # started in run() when the cache is armed
        # the pod-local checkpoint tier (EDL_CKPT_LOCAL_BASE): each pod's
        # workers read EDL_CKPT_LOCAL_DIR, and run() starts the replica
        # holder that keeps peers' versions under <base>/<pod>.replicas
        self._ckpt_local_base = os.environ.get("EDL_CKPT_LOCAL_BASE", "")
        self.ckpt_replicas = None  # the replica holder (run() starts it)
        self._ckpt_peers_reg: Optional[Registration] = None
        # hot-restage mode: surviving workers adopt new stages in-process
        # (train/context.py reinit_for_stage) instead of kill+respawn; the
        # launcher hands the stage over and enforces an adoption deadline
        self.hot = hot_restage or os.environ.get("EDL_HOT_RESTAGE") == "1"
        if self.hot:
            self.extra_worker_env.setdefault("EDL_HOT_RESTAGE", "1")
        self.hot_grace = float(os.environ.get("EDL_HOT_GRACE", "20"))
        self._hot_deadline: Optional[float] = None
        # (count, last_ts): consecutive-fallback guard with decay — widely
        # spaced recovered fallbacks on a long-lived job must not
        # accumulate into a spurious abandonment
        self._hot_fallbacks = 0
        self._hot_fallback_ts = 0.0
        self.standby_pool = None
        from edl_tpu_torch.launch.standby import StandbyPool, standby_enabled

        if standby_enabled(standby):
            spawn_env = procs_mod.base_worker_env(self.extra_worker_env)
            spawn_env.update(self.extra_worker_env)
            # the shell resolves the kernel-library dir (ops/_build.py)
            # before activation: it must be the stage's
            spawn_env["EDL_COMPILE_CACHE_DIR"] = job_env.compile_cache_dir
            # eager device init is only safe when the elastic window pins
            # the world to one worker (see launch/standby.py docstring)
            eager = (
                job_env.max_nodes * job_env.nproc_per_node == 1
                or os.environ.get("EDL_STANDBY_EAGER") == "1"
            )
            self.standby_pool = StandbyPool(
                spawn_env, count=job_env.nproc_per_node, eager=eager
            )

        self.client = connect_store(job_env.store_endpoint, timeout=max(10.0, ttl))
        # chaos plane (EDL_CHAOS env or the job's chaos/ keyspace): no-op
        # unless this job opted into fault injection
        _chaos_arm("launcher", client=self.client, job_id=job_env.job_id)
        self.registry = Registry(self.client, job_env.job_id)
        self.pod = self._make_pod()
        if self._ckpt_local_base:
            # the pod-local checkpoint tier: derived from the shared base
            # here (the pod id exists only now) so every worker — spawned
            # or standby-activated — reads one env var
            self.extra_worker_env.setdefault(
                "EDL_CKPT_LOCAL_DIR",
                os.path.join(self._ckpt_local_base, self.pod.pod_id),
            )

        self._events: "queue.Queue[str]" = queue.Queue()
        self._stop = threading.Event()

        self.resource_reg: Optional[Registration] = None
        self.rank_reg: Optional[Registration] = None
        self.rank_slot: Optional[int] = None
        self.running: Optional[Cluster] = None  # cluster my workers run under
        self.procs: List[procs_mod.WorkerProc] = []
        self.completed = False
        self._complete_published = False
        self._handled_token = ""
        self._mem_gate_last: Optional[int] = None  # last recorded fit cap
        # health plane: a preemption notice (SIGTERM/SIGUSR1) flips the
        # event from the signal handler; the loop turns it into a drain
        self._preempt_notice = threading.Event()
        self._draining = False
        self._drain_trace = ""  # drain-op trace id once a notice landed
        self._drain_deadline: Optional[float] = None
        self._drained_workers = False
        self._preempt_handled: set = set()
        self._was_leader: Optional[bool] = None
        self._prev_handlers: Dict[int, object] = {}
        # (exit_code, deadline, failed_stage): a worker crash holds here for
        # a grace window instead of abandoning the job — a peer pod's death
        # kills healthy workers too (a dead peer's collective aborts the
        # whole process when the coordinator dies), and THAT must restage,
        # not fail the job. A crash with stable membership still fails fast
        # once the grace window (~lease TTL) lapses with no new stage.
        self._worker_failure: Optional[tuple] = None

        # observability plane (EDL_OBS_PORT gates the HTTP mount)
        self._tracer = obs_trace.get_tracer("launcher")
        self._m_drains = obs_metrics.counter(
            "edl_launch_drains_total", "drain tokens this pod CAS-won"
        )
        self._m_spawns = obs_metrics.counter(
            "edl_launch_spawns_total", "worker generations spawned by this pod"
        )
        self._m_hot_handoffs = obs_metrics.counter(
            "edl_launch_hot_handoffs_total", "stages handed to live workers in-process"
        )
        self._m_hot_fallbacks = obs_metrics.counter(
            "edl_launch_hot_fallbacks_total", "hot restages that fell back to respawn"
        )
        self._m_worker_failures = obs_metrics.counter(
            "edl_launch_worker_failures_total", "nonzero worker exits observed"
        )
        self._m_leader = obs_metrics.gauge(
            "edl_launch_leader_state", "1 when this pod is the stage leader"
        )
        self._m_stragglers = obs_metrics.counter(
            "edl_launch_straggler_ejections_total",
            "wedged local workers ejected by the straggler watchdog",
        )
        self._m_notices = obs_metrics.counter(
            "edl_launch_preempt_notices_total",
            "preemption notices (SIGTERM/SIGUSR1 or worker-relayed) this "
            "pod began draining for",
        )
        # histogram, not gauge: edl-top renders p50/p95 from the buckets,
        # so a transient stall is visible after the fact, not only while
        # a scrape happens to catch it
        self._m_hb_age = obs_metrics.histogram(
            "edl_train_step_heartbeat_age_seconds",
            "age of each local worker's last step heartbeat, sampled by "
            "the watchdog every supervision pass",
        )
        self._obs_gauges = obs_metrics.bind_gauges((
            ("edl_launch_workers_running", "live local worker processes",
             lambda: len(self.procs)),
            ("edl_launch_grace_remaining_seconds",
             "seconds left in the worker-failure grace window (0 outside it)",
             lambda: max(0.0, self._worker_failure[1] - time.time())
             if self._worker_failure is not None else 0.0),
        ))
        # stable bound-method reference for identity-guarded release
        self._health_fn = self._health
        self._obs = obs_http.start_from_env(
            "launcher", health_fn=self._health_fn
        )

    def _health(self) -> Dict:
        return {
            "pod": self.pod.pod_id,
            "stage": self.running.stage if self.running is not None else "",
            "workers": len(self.procs),
            "leader": bool(self._m_leader.value()),
            "completed": self.completed,
            "draining": self._draining,
        }

    # -- setup -------------------------------------------------------------

    def _make_pod(self) -> Pod:
        nproc = self.job_env.nproc_per_node
        devices = max(1, local_device_count() // max(1, nproc))
        addr = get_host_ip()
        ports = find_free_ports(nproc)
        workers = [
            Worker(endpoint="%s:%d" % (addr, ports[i]), rank_in_pod=i, num_devices=devices)
            for i in range(nproc)
        ]
        return Pod(addr=addr, workers=workers)

    def _wake(self, _arg=None) -> None:
        self._events.put("changed")

    # -- snapshots ---------------------------------------------------------

    def _live_pods(self) -> Dict[str, Pod]:
        return {
            name: Pod.from_json(meta.value)
            for name, meta in self._res_watch.snapshot().items()
        }

    def _rank_map(self) -> Dict[int, str]:
        out = {}
        for name, meta in self._rank_watch.snapshot().items():
            try:
                out[int(name)] = meta.value.decode()
            except ValueError:
                pass
        return out

    def _drain_token(self) -> str:
        meta = self._drain_watch.snapshot().get("token")
        return meta.value.decode() if meta else ""

    def _published(self) -> Optional[Cluster]:
        meta = self._cluster_watch.snapshot().get("current")
        return Cluster.from_json(meta.value) if meta else None

    def _draining_pods(self) -> set:
        """pod_ids with a preemption notice published (any payload: a key
        we cannot parse still means "this pod is going away")."""
        return set(self._preempt_watch.snapshot())

    # -- drain token (stage fencing) --------------------------------------

    def _trigger_drain(
        self, reason: str, cause: str = "membership",
        caused_by: Optional[str] = None,
    ) -> None:
        token_key = "/%s/%s/token" % (self.job_env.job_id, DRAIN_SERVICE)
        try:
            value, mod_rev = self.client.get_with_rev(token_key)
            new = new_uuid()
            if self.client.cas(token_key, mod_rev if value is not None else 0, new.encode()):
                logger.info("pod %s triggered drain %s (%s)", self.pod.pod_id[:8], new[:8], reason)
                self._m_drains.inc(cause=cause)
                # restage operation root: the CAS winner anchors the
                # trace every other process stitches to — the trace id
                # derives from the new token, so the leader's publish,
                # peers' spawns, and the fresh workers' restore/first-jit
                # all join it with zero extra wire traffic
                root_args = {"cause": cause, "reason": reason,
                             "pod": self.pod.pod_id[:8]}
                if self._drain_trace:
                    # a preemption notice caused this restage: link the
                    # pod's drain trace so edl-trace can chain them
                    root_args["caused_by"] = self._drain_trace
                elif caused_by:
                    # a scale decision caused this restage directly
                    # (leader-side grow/shrink reconcile, no local drain)
                    root_args["caused_by"] = caused_by
                ctx = obs_trace.record_op_root("restage", new, **root_args)
                with obs_trace.use(ctx):
                    self._tracer.instant("drain", stage=new[:8], reason=reason)
                    obs_events.record(
                        "drain", fsync=True, token=new[:8], reason=reason,
                        cause=cause, pod=self.pod.pod_id[:8],
                    )
                telemetry.record_event(
                    self.client, self.job_env.job_id, new, "drain",
                    self.pod.pod_id[:8],
                )
        except EdlStoreError as exc:
            logger.warning("drain trigger failed (%s): %s", reason, exc)

    # -- rank racing -------------------------------------------------------

    def _race_rank(self) -> None:
        """Try to win a free slot 0..max_nodes-1 (reference races
        0..1024 in order, register.py:72-114 — but each miss there costs
        a full RPC round; here one range read finds the free slots and we
        race only those, so a pod joining a nearly-full job pays one read
        plus ~one contended put instead of ~3N round-trips)."""
        if self.rank_reg is not None:
            return
        taken = {
            m.name for m in self.registry.get_service(RANK_SERVICE)
        }
        free = [
            s for s in range(self.job_env.max_nodes) if str(s) not in taken
        ]
        for slot in free:
            reg, _holder = self.registry.register_if_absent(
                RANK_SERVICE,
                str(slot),
                self.pod.pod_id.encode(),
                ttl=self.ttl,
                on_lost=self._on_rank_lost,
            )
            if reg is not None:
                self.rank_reg, self.rank_slot = reg, slot
                logger.info("pod %s won rank slot %d", self.pod.pod_id[:8], slot)
                return
        logger.info(
            "pod %s found no free rank slot (%d taken); waiting",
            self.pod.pod_id[:8], len(taken),
        )

    def _on_rank_lost(self) -> None:
        self.rank_reg = None
        self.rank_slot = None
        self._wake()

    def _is_leader(self) -> bool:
        if self.rank_slot is None:
            return False
        ranks = self._rank_map()
        # a draining pod must not lead: it is about to leave, and leadership
        # passing to the next live slot NOW is what makes the proactive
        # exclusion publish happen while the drainer is still checkpointing
        live = set(self._live_pods()) - self._draining_pods()
        live_slots = [s for s, pid in ranks.items() if pid in live]
        return bool(live_slots) and self.rank_slot == min(live_slots)

    # -- scale-plane reconciliation ---------------------------------------

    def _scale_target(self) -> Optional[dict]:
        """The autoscaler's ``scale/target`` doc for this job, parsed
        (None = no target in force: fit to whatever membership exists)."""
        watch = getattr(self, "_scale_watch", None)
        if watch is None:
            return None
        meta = watch.snapshot().get("target")
        if meta is None:
            return None
        try:
            doc = json.loads(meta.value)
            int(doc.get("pods", 0))
        except (ValueError, TypeError, AttributeError):
            return None
        return doc

    def _mem_fit_cap(self) -> Optional[int]:
        """The memory plane's fit verdict (obs/memory.fit_cap) in pods:
        the largest published ``mem/plan/{world}`` whose plan fits its
        stamped device limit minus ``EDL_MEM_MARGIN`` (plan worlds count
        processes — divided by nproc_per_node). None when no judgeable
        plan is published, and None when every judged world fits: the
        worlds above the largest have no plan (a port worker publishes
        its live world's alone; the JAX package's AOT ladder also
        publishes the neighbours'), and unknown never gates."""
        try:
            plans = obs_memory.read_plans(self.client, self.job_env.job_id)
            cap = obs_memory.fit_cap(plans)
        except Exception:  # noqa: BLE001 — store blip reads as unknown
            return None
        judged = [w for w, p in plans.items()
                  if p.limit > 0 and p.total() > 0]
        if cap is None or cap == max(judged):
            return None
        return cap // max(1, self.job_env.nproc_per_node)

    def _want_pods(
        self, n_live: int, target: Optional[dict], current: int = 0
    ) -> int:
        """How many pods the next generation should hold: membership
        capped by max_nodes, further capped by the autoscale target,
        further capped by the memory-plane fit verdict. 0 means pause —
        every pod drained, and the leader publishes the EMPTY generation
        so the pause lands in cluster/current (the gang floor: a job
        runs at >= min_nodes or not at all).

        The fit cap is the reconcile path's own last line — it holds
        even with no scaler running — but, like the scaler's gate, it
        only refuses GROWTH: it never shrinks below ``current`` (the
        published world is live evidence it fits) or the gang floor."""
        want = min(n_live, self.job_env.max_nodes)
        if target is not None:
            pods = int(target.get("pods", 0) or 0)
            if pods <= 0:
                return 0
            want = min(want, max(pods, self.job_env.min_nodes))
        cap = self._mem_fit_cap()
        if cap is not None:
            fit = max(cap, self.job_env.min_nodes, current)
            if fit < want:
                if self._mem_gate_last != fit:
                    self._mem_gate_last = fit
                    obs_events.record(
                        "mem_unfit", fsync=True, component="launcher",
                        cap_pods=fit, wanted=want,
                        cause="mem_unfit: reconcile capped at %d pods "
                              "(plan over device limit)" % fit,
                    )
                    logger.info(
                        "memory fit gate: next generation capped at %d "
                        "pods (wanted %d)", fit, want,
                    )
                want = fit
        return want

    def _drift_cause(self, missing: set) -> Tuple[str, Optional[str]]:
        """Attribute a membership-drift restage: when every missing pod
        carries an autoscale preempt notice the SCALER caused this drift
        — label the drain so thrash detection and the scale op trace see
        it (otherwise it is ordinary membership weather)."""
        notices = self._preempt_watch.snapshot()
        seq = None
        for pid in missing:
            meta = notices.get(pid)
            if meta is None:
                return "membership", None
            try:
                doc = json.loads(meta.value)
            except ValueError:
                return "membership", None
            if doc.get("cause") != "autoscale":
                return "membership", None
            seq = doc.get("seq", seq)
        if seq is None:
            return "membership", None
        return "autoscale", obs_trace.op_trace_id("scale", str(int(seq)))

    def _release_pods(
        self, current: set, ranks: Dict[int, str], n_excess: int,
        target: dict,
    ) -> None:
        """Autoscale shrink: publish ``preempt/{pod}`` drain notices for
        the ``n_excess`` highest-slot published pods (the leader holds
        the lowest live slot, so it is released last — only when the
        target pauses the whole job). The existing drain machinery does
        everything else: the victims' workers checkpoint and exit
        DRAINED, membership converges without them, and the next
        generation publishes at the target size."""
        slot_of = {pid: s for s, pid in ranks.items()}
        victims = sorted(
            current, key=lambda pid: -slot_of.get(pid, -1)
        )[:n_excess]
        seq = int(target.get("seq", 0) or 0)
        tid = obs_trace.op_trace_id("scale", str(seq))
        now = time.time()
        for pid in victims:
            try:
                self.registry.set_permanent(
                    PREEMPT_SERVICE,
                    pid,
                    json.dumps(
                        {"deadline": now + self.drain_budget,
                         "budget": self.drain_budget, "ts": now,
                         "cause": "autoscale", "seq": seq}
                    ).encode(),
                )
            except EdlStoreError as exc:
                logger.warning(
                    "autoscale release of %s not published: %s", pid[:8], exc
                )
                continue
            obs_events.record(
                "scale_preempt", fsync=True, pod=pid[:8], seq=seq,
                cause="autoscale", trace_id=tid,
            )
            logger.info(
                "autoscale: released pod %s (target %d pods, seq %d)",
                pid[:8], int(target.get("pods", 0) or 0), seq,
            )

    # -- leader duties -----------------------------------------------------

    def _maybe_publish(self) -> None:
        token = self._drain_token()
        draining = self._draining_pods()
        # preemption-noticed pods are excluded from the next generation
        # IMMEDIATELY: no lease-expiry wait (they are still heartbeating
        # while they checkpoint), their rank slots don't block convergence
        live = {
            pid: pod for pid, pod in self._live_pods().items()
            if pid not in draining
        }
        ranks = {
            s: pid for s, pid in self._rank_map().items()
            if pid not in draining
        }
        if not token:
            # first generation: establish the initial stage token
            if live:
                self._trigger_drain("bootstrap", cause="bootstrap")
            return
        target = self._scale_target()
        published = self._published()
        if published is not None and published.stage == token:
            # this generation is already out; reconcile it against
            # membership AND the autoscale target
            current = set(published.pod_ids())
            if not current <= set(live):
                # a published pod died or was preemption-noticed; when
                # the notices are the scaler's, the restage is its doing
                cause, caused_by = self._drift_cause(current - set(live))
                self._trigger_drain(
                    "membership drift", cause=cause, caused_by=caused_by
                )
                return
            want = self._want_pods(len(live), target, current=len(current))
            if want < len(current):
                # autoscale shrink (or pause at want == 0): release the
                # excess through the drain plane, never a bare kill
                self._release_pods(current, ranks, len(current) - want, target)
                return
            if want > len(current):
                # grow: admit pods through a fresh generation — held
                # ones when a target raised, ordinary joiners otherwise
                if target is not None:
                    self._trigger_drain(
                        "autoscale grow to %d (seq %s)"
                        % (want, target.get("seq")),
                        cause="autoscale",
                        caused_by=obs_trace.op_trace_id(
                            "scale", str(int(target.get("seq", 0) or 0))
                        ),
                    )
                else:
                    self._trigger_drain("membership drift")
                return
            ranked_live = {s: pid for s, pid in ranks.items() if pid in live}
            if current != {
                ranked_live[s] for s in sorted(ranked_live)[:want]
            }:
                # same size, different slots/membership (a published pod
                # lost its rank slot to another live pod). With a target
                # in force the comparison is against the first ``want``
                # slots — what the publish path below would emit — so
                # held pods beyond the target never read as drift, but
                # a slot takeover at equal world size still restages
                self._trigger_drain("membership drift")
            return
        # convergence condition: stale rank slots (dead holders) must have
        # lease-expired, every live pod (up to max) must hold a slot
        ranked = {s: pid for s, pid in ranks.items() if pid in live}
        if len(ranked) != len(ranks):
            return  # stale slots still draining out via TTL
        if len(ranked) != min(len(live), self.job_env.max_nodes):
            return  # not every live pod holds a slot yet
        want = self._want_pods(len(live), target)
        # autoscale pause (want == 0): pods stay held, but the EMPTY
        # generation still publishes — cluster/current is the scaler's
        # actual-world source, and leaving the victims' last nonzero
        # doc in place would read as a shrink that never settles,
        # deferring the preempting gang's grow forever
        if 0 < want < self.job_env.min_nodes:
            return
        pods = []
        for slot in sorted(ranked)[:want]:
            pod = live[ranked[slot]]
            pod.rank = slot
            pods.append(pod)
        cluster = Cluster.from_pods(pods, stage=token)
        # restage-trace segment: the leader's publish is one hop of the
        # critical path (token CAS -> election -> PUBLISH -> spawn -> ...)
        with obs_trace.op_segment(
            "publish", "restage", token,
            world=cluster.world_size, pods=cluster.num_pods,
        ):
            self.registry.set_permanent(
                CLUSTER_SERVICE, "current", cluster.to_json()
            )
            obs_events.record(
                "publish", fsync=True, stage=token[:8],
                world=cluster.world_size, pods=cluster.num_pods,
            )
        if target is not None and int(target.get("seq", 0) or 0):
            # decision->restage closure: this publish satisfies the
            # scaler's target — a segment under the deterministic
            # op_trace_id("scale", seq) root plus an fsync'd flight
            # record make the latency a first-class edl-trace query
            seq = int(target["seq"])
            with obs_trace.op_segment(
                "reconcile", "scale", str(seq),
                stage=token[:8], world=cluster.world_size,
                pods=cluster.num_pods,
            ):
                pass
            obs_events.record(
                "scale_reconcile", fsync=True, seq=seq, stage=token[:8],
                pods=cluster.num_pods, world=cluster.world_size,
                trace_id=obs_trace.op_trace_id("scale", str(seq)),
            )
        telemetry.record_event(
            self.client, self.job_env.job_id, token, "published",
            self.pod.pod_id[:8],
        )
        telemetry.record_stage(
            self.client, self.job_env.job_id, token,
            {"world": cluster.world_size, "pods": cluster.num_pods,
             "ts": time.time()},
        )
        logger.info(
            "leader %s published stage %s: %d pod(s), world=%d",
            self.pod.pod_id[:8],
            token[:8],
            cluster.num_pods,
            cluster.world_size,
        )

    def _maybe_complete_job(self) -> None:
        published = self._published()
        if published is None or not published.pod_ids():
            # no generation yet, or a paused (empty) one — vacuous
            # "all pods COMPLETE" must not mark the job done
            return
        statuses = self._status_watch.snapshot()
        done = all(
            (meta := statuses.get(pid)) is not None and meta.value == COMPLETE
            for pid in published.pod_ids()
        )
        if done:
            self.registry.set_permanent(JOB_SERVICE, "status", COMPLETE)
            logger.info("leader %s marked job COMPLETE", self.pod.pod_id[:8])

    # -- follower duties ---------------------------------------------------

    def _check_death(self) -> None:
        """T1: a member of the generation I'm running vanished."""
        if self.running is None:
            return
        live = set(self._live_pods())
        draining = self._draining_pods()
        # a noticed pod's departure is already being handled by the drain
        # its notice triggered — re-triggering here would burn a second
        # restage for the same membership change
        dead = [
            pid for pid in self.running.pod_ids()
            if pid not in live and pid not in draining
        ]
        if dead:
            self._trigger_drain(
                "pod(s) died: %s" % ",".join(p[:8] for p in dead),
                cause="death",
            )

    # -- graceful drain (health plane) -------------------------------------

    def _on_preempt_signal(self, signum=None, _frame=None) -> None:
        """SIGTERM/SIGUSR1: an advance preemption notice (spot VM reclaim,
        k8s eviction). Idempotent — repeated signals while draining are
        absorbed. Safe in a signal context: set a flag, wake the loop."""
        if not self._preempt_notice.is_set():
            logger.warning(
                "pod %s received preemption notice (signal %s); draining",
                self.pod.pod_id[:8], signum,
            )
        self._preempt_notice.set()
        self._wake()

    def _begin_drain(self) -> None:
        """Turn the notice into a drain: publish ``preempt/{pod_id}`` with
        the deadline, bump the drain token so the leader restages without
        this pod, and let the local workers (who see the preempt key via
        their store watch) take their emergency checkpoint. Called from the
        loop, once — double notices are idempotent by construction."""
        if self._draining:
            return
        self._draining = True
        self._m_leader.set(0.0)  # a draining pod never leads
        now = time.time()
        self._drain_deadline = now + self.drain_budget
        # a notice may already be published FOR us (the scaler's leader
        # released this pod with cause=autoscale): preserve its payload
        # — cause and seq attribute the drain, and the key must not be
        # overwritten with a causeless local one
        existing: Optional[dict] = None
        watch = getattr(self, "_preempt_watch", None)
        if watch is not None:
            meta = watch.snapshot().get(self.pod.pod_id)
        else:
            # drain before the loop armed its watches (early signal):
            # one direct read keeps the attribution semantics
            try:
                meta = self.registry.get_server(PREEMPT_SERVICE, self.pod.pod_id)
            except Exception:  # noqa: BLE001 — store blip: local cause wins
                meta = None
        if meta is not None:
            try:
                existing = json.loads(meta.value)
            except ValueError:
                existing = None
        cause = "preempt"
        if existing and existing.get("cause"):
            cause = str(existing["cause"])
        # the token bump below counts in edl_launch_drains_total{cause=
        # "preempt"/"autoscale"} only on CAS win, like every other
        # cause; the notice itself gets its own counter
        self._m_notices.inc()
        # drain operation root, keyed by pod id (a pod drains at most
        # once): this pod's notice, emergency checkpoint, and DRAINED
        # exit stitch under it, and the restage it triggers records it
        # as caused_by
        root_args = {
            "pod": self.pod.pod_id[:8],
            "budget": "%.1f" % self.drain_budget,
        }
        if cause == "autoscale" and existing and existing.get("seq") is not None:
            # chain back to the decision that released this pod
            root_args["caused_by"] = obs_trace.op_trace_id(
                "scale", str(int(existing["seq"]))
            )
        drain_ctx = obs_trace.record_op_root(
            "drain", self.pod.pod_id, **root_args
        )
        self._drain_trace = drain_ctx.trace_id
        with obs_trace.use(drain_ctx):
            self._tracer.instant(
                "preempt_notice", pod=self.pod.pod_id[:8],
                budget="%.1f" % self.drain_budget,
            )
            obs_events.record(
                "preempt_notice", fsync=True, pod=self.pod.pod_id[:8],
                budget=self.drain_budget, deadline=self._drain_deadline,
            )
        stage = (
            self.running.stage if self.running is not None
            else self._handled_token
        )
        if _FP_NOTICE.armed:
            try:
                _FP_NOTICE.fire(pod=self.pod.pod_id[:8])
            except ConnectionError:
                logger.warning("chaos: preempt publication dropped")
                return  # drain proceeds without the store's help
        try:
            if existing is None:
                self.registry.set_permanent(
                    PREEMPT_SERVICE,
                    self.pod.pod_id,
                    json.dumps(
                        {"deadline": self._drain_deadline,
                         "budget": self.drain_budget, "ts": now}
                    ).encode(),
                )
            telemetry.record_event(
                self.client, self.job_env.job_id, stage, "preempt",
                self.pod.pod_id[:8], ts=now,
            )
        except EdlStoreError as exc:
            logger.warning("preempt notice not published: %s", exc)
        if not self.completed and (self.procs or self.running is not None):
            self._trigger_drain("preemption notice", cause=cause)
        if not self.procs:
            # nothing to checkpoint: the drain is already complete
            self._drain_deadline = now

    def _finish_drain(self) -> int:
        """Exit path of a draining pod: everything local is down (or the
        budget lapsed), leases are deleted by run()'s finally so the
        membership converges instantly — no TTL wait for the survivors."""
        if self.procs:
            logger.warning(
                "pod %s drain budget lapsed with %d worker(s) still up; "
                "killing", self.pod.pod_id[:8], len(self.procs),
            )
            self._kill_workers()
        with obs_trace.use(obs_trace.op_context("drain", self.pod.pod_id)):
            self._tracer.instant("drained", pod=self.pod.pod_id[:8])
            obs_events.record(
                "pod_drained", fsync=True, pod=self.pod.pod_id[:8],
                clean=self._drained_workers,
            )
        logger.info(
            "pod %s drained (%s); leaving with exit code %d",
            self.pod.pod_id[:8],
            "workers checkpointed and exited DRAINED"
            if self._drained_workers else "no worker drained cleanly",
            0 if self.completed else DRAINED_EXIT,
        )
        return 0 if self.completed else DRAINED_EXIT

    # -- straggler watchdog ------------------------------------------------

    def _check_stragglers(self) -> None:
        """Eject a LOCAL worker that is wedged: behind its peers and quiet
        past the peer-median-derived deadline (or past the absolute
        forever-wedge bound). Ejection is kill + drain: the pod stays in
        the job — the machine is fine, the process was stuck — and the
        restaged generation respawns it from the last checkpoint."""
        if not self.procs or self.running is None or self._draining:
            return
        mine = self.running.get_pod(self.pod.pod_id)
        if mine is None:
            return
        stage = self.running.stage
        now = time.time()
        beats: Dict[str, dict] = {}
        for name, meta in self._hb_watch.snapshot().items():
            try:
                payload = json.loads(meta.value)
            except ValueError:
                continue
            if payload.get("stage") == stage:
                beats[name] = payload
        my_keys = [
            "%s.%d" % (self.pod.pod_id, w.rank_in_pod) for w in mine.workers
        ]
        for key in my_keys:
            if key in beats:
                self._m_hb_age.observe(
                    now - float(beats[key].get("ts", now)),
                    worker=key.rpartition(".")[2],
                )
        stalled = stalled_workers(
            beats, my_keys, now,
            abs_deadline=self.stall_abs,
            factor=self.stall_factor,
            floor=self.stall_floor,
        )
        if not stalled:
            return
        ages = ", ".join(
            "%s age=%.1fs step=%s" % (
                k.rpartition(".")[2],
                now - float(beats[k].get("ts", now)),
                beats[k].get("step"),
            )
            for k in stalled
        )
        logger.error(
            "pod %s straggler watchdog: worker(s) wedged [%s]; ejecting "
            "and restaging", self.pod.pod_id[:8], ages,
        )
        self._m_stragglers.inc()
        self._tracer.instant("straggler_ejected", stage=stage[:8], who=ages)
        obs_events.record(
            "straggler_ejected", fsync=True, stage=stage[:8], who=ages,
        )
        telemetry.record_event(
            self.client, self.job_env.job_id, stage, "straggler",
            self.pod.pod_id[:8],
        )
        self._kill_workers()
        self._trigger_drain("straggler ejected: %s" % ages, cause="straggler")

    def _handle_token(self) -> None:
        """A new drain token means: my running generation is obsolete."""
        token = self._drain_token()
        if token == self._handled_token:
            return
        self._handled_token = token
        if self._draining:
            # my workers are mid-emergency-checkpoint: killing them for the
            # new generation (which excludes this pod anyway) would throw
            # away exactly the work the drain budget exists to save
            return
        if self.running is not None and self.running.stage != token:
            if self.hot and self.procs and all(
                wp.proc.poll() is None for wp in self.procs
            ):
                # hot mode: live workers see the same token through their
                # own store watch and adopt the next generation in-process;
                # killing them here would throw away the warm runtime
                logger.info(
                    "pod %s drain %s: workers held for in-process restage",
                    self.pod.pod_id[:8], token[:8],
                )
                return
            logger.info(
                "pod %s draining stage %s for token %s",
                self.pod.pod_id[:8],
                self.running.stage[:8],
                token[:8],
            )
            with obs_trace.op_segment(
                "drain_kill", "restage", token,
                stage=token[:8], pod=self.pod.pod_id[:8],
            ):
                self._kill_workers()
                obs_events.record(
                    "killed", fsync=True, stage=token[:8],
                    pod=self.pod.pod_id[:8],
                )
            telemetry.record_event(
                self.client, self.job_env.job_id, token, "killed",
                self.pod.pod_id[:8],
            )

    def _adopt_cluster(self) -> None:
        if self._draining:
            return  # a draining pod never joins another generation
        published = self._published()
        if published is None:
            return
        mine = published.get_pod(self.pod.pod_id)
        if self.running is not None and self.running.stage == published.stage:
            self._enforce_hot_deadline(published)
            return
        if (
            self.hot
            and mine is not None
            and self.running is not None
            and self.procs
            and all(wp.proc.poll() is None for wp in self.procs)
            and not self.completed
            and self._worker_failure is None
            and published.stage == self._drain_token()
        ):
            # hand the generation over to the live workers: they re-enter
            # train.init in-process (reinit_for_stage) and must confirm
            # via the hotadopt store key before the grace deadline
            self.running = published
            self._note_membership(published)
            self._hot_deadline = time.time() + self.hot_grace
            self._m_hot_handoffs.inc()
            with obs_trace.use(
                obs_trace.op_context("restage", published.stage)
            ):
                self._tracer.instant("hot_handoff", stage=published.stage[:8])
            telemetry.record_event(
                self.client, self.job_env.job_id, published.stage,
                "hot-handoff", self.pod.pod_id[:8],
            )
            logger.info(
                "pod %s handed stage %s to live workers (deadline %.0fs)",
                self.pod.pod_id[:8], published.stage[:8], self.hot_grace,
            )
            return
        if self.running is not None:
            self._kill_workers()
        if mine is None:
            return  # not part of this generation; keep waiting
        if self.completed:
            return  # my work is done; don't respawn for resizes
        if (
            self._worker_failure is not None
            and published.stage == self._worker_failure[2]
        ):
            return  # don't crash-loop the generation that just failed
        if published.stage != self._drain_token():
            return  # stale publish; a newer drain is already in flight
        self.running = published
        self._note_membership(published)
        self._m_spawns.inc()
        with obs_trace.op_segment(
            "spawn_workers", "restage", published.stage,
            stage=published.stage[:8], world=published.world_size,
        ):
            obs_events.record(
                "spawn", fsync=True, stage=published.stage[:8],
                world=published.world_size, pod=self.pod.pod_id[:8],
            )
            self.procs = procs_mod.start_local_workers(
                published,
                mine,
                self.training_script,
                self.training_args,
                log_dir=self.job_env.log_dir,
                extra_env={
                    "EDL_JOB_ID": self.job_env.job_id,
                    "EDL_STORE_ENDPOINT": self.job_env.store_endpoint,
                    "EDL_CKPT_PATH": self.job_env.ckpt_path,
                    "EDL_COMPILE_CACHE_DIR": self.job_env.compile_cache_dir,
                    **self.extra_worker_env,
                },
                standby=self.standby_pool,
            )

    def _note_membership(self, published: Cluster) -> None:
        """Per-generation upkeep of the pod-scoped planes: the warmer
        learns the new world size, and the checkpoint replica holder
        GCs replicas superseded by the new membership."""
        self._note_stage_for_warmer(published)
        if self.ckpt_replicas is not None:
            try:
                self.ckpt_replicas.note_membership(published.pod_ids())
            except Exception as exc:  # noqa: BLE001 — GC is best-effort
                logger.warning("ckpt replica gc failed: %s", exc)

    def _note_stage_for_warmer(self, published: Cluster) -> None:
        """Kick proactive compile-cache warming for the OTHER world sizes
        the elastic window allows (see launch/warm.py) — the grow
        transition should land on a warm cache the first time."""
        if self.warmer is None:
            from edl_tpu_torch.launch.warm import make_warmer_if_enabled

            self.warmer = make_warmer_if_enabled(
                self.job_env,
                self.pod.pod_id,
                self.training_script,
                self.training_args,
                self.extra_worker_env,
                self.prewarm,
            ) or False
        if self.warmer:
            self.warmer.note_world(published.world_size)

    def _enforce_hot_deadline(self, published: Cluster) -> None:
        """After a hot handoff, every local worker must confirm it TOOK
        the handoff (hotadopt/{pod}.{rank} == stage, written before its
        process-group re-init — which may legitimately block on a slow
        joiner) before the deadline; a miss means the worker is wedged in
        a dead collective or an abort, and falls back to kill + cold
        respawn of this generation."""
        if self._hot_deadline is None or not self.procs:
            self._hot_deadline = None
            return
        mine = published.get_pod(self.pod.pod_id)
        if mine is None:
            self._hot_deadline = None
            return
        snapshot = self._hotadopt_watch.snapshot()
        want = {
            "%s.%d" % (self.pod.pod_id, w.rank_in_pod) for w in mine.workers
        }
        adopted = {
            name
            for name, meta in snapshot.items()
            if name in want and meta.value == published.stage.encode()
        }
        if adopted == want:
            logger.info(
                "pod %s workers adopted stage %s in-process",
                self.pod.pod_id[:8], published.stage[:8],
            )
            telemetry.record_event(
                self.client, self.job_env.job_id, published.stage,
                "hot-adopted", self.pod.pod_id[:8],
            )
            self._hot_deadline = None
            self._hot_fallbacks = 0
            return
        if time.time() > self._hot_deadline:
            logger.warning(
                "pod %s workers missed the hot-adoption deadline for "
                "stage %s (%d/%d confirmed); falling back to respawn",
                self.pod.pod_id[:8], published.stage[:8],
                len(adopted), len(want),
            )
            self._hot_deadline = None
            self._kill_workers()
            self._wake()

    def _kill_workers(self) -> None:
        if self.procs:
            procs_mod.terminate_local_workers(self.procs)
        self.procs = []
        self.running = None

    # -- main loop ---------------------------------------------------------

    def run(self) -> int:
        env = self.job_env
        logger.info("launching %s: %r", env, self.training_script)
        self.resource_reg = self.registry.register(
            RES_SERVICE, self.pod.pod_id, self.pod.to_json(), ttl=self.ttl
        )
        self._res_watch = self.registry.watch_service(RES_SERVICE, on_change=self._wake)
        self._rank_watch = self.registry.watch_service(RANK_SERVICE, on_change=self._wake)
        self._drain_watch = self.registry.watch_service(DRAIN_SERVICE, on_change=self._wake)
        self._cluster_watch = self.registry.watch_service(CLUSTER_SERVICE, on_change=self._wake)
        self._status_watch = self.registry.watch_service(STATUS_SERVICE, on_change=self._wake)
        self._job_watch = self.registry.watch_service(JOB_SERVICE, on_change=self._wake)
        self._hotadopt_watch = self.registry.watch_service(
            HOTADOPT_SERVICE, on_change=self._wake
        )
        self._preempt_watch = self.registry.watch_service(
            PREEMPT_SERVICE, on_change=self._wake
        )
        # the autoscaler's target-world docs: every launcher watches so
        # the leader reconciles promptly and victims see their release
        self._scale_watch = self.registry.watch_service(
            SCALE_SERVICE, on_change=self._wake
        )
        # no wake on heartbeats: they tick every step and the poll-interval
        # pass is plenty for a watchdog whose deadlines are seconds
        self._hb_watch = self.registry.watch_service(HEARTBEAT_SERVICE)
        # preemption notices arrive as SIGTERM (spot reclaim, k8s eviction)
        # or SIGUSR1 (operator-initiated); installable only from the main
        # thread — embedded/test launchers fall back to shutdown() semantics
        try:
            for signum in (signal.SIGTERM, signal.SIGUSR1):
                self._prev_handlers[signum] = signal.signal(
                    signum, self._on_preempt_signal
                )
        except ValueError:
            pass
        if self._obs is not None:
            # advertise the scrape target so edl-top finds it via the store
            obs_http.register_endpoint(
                self.client, env.job_id, "launcher", self.pod.pod_id[:8],
                self._obs.endpoint,
            )
        # An embedded store shares this process's registry, so its series
        # already ride the launcher endpoint registered above — a second
        # "store" registration would make every scraper that sums across
        # targets double-count this process.

        self._start_pod_planes()

        try:
            return self._loop()
        finally:
            for signum, handler in self._prev_handlers.items():
                try:
                    signal.signal(signum, handler)
                except (ValueError, TypeError):
                    pass
            self._obs_gauges.release()
            obs_http.release_health("launcher", self._health_fn)
            self._kill_workers()
            self._stop_pod_planes()
            for reg in (self.rank_reg, self.resource_reg):
                if reg is not None:
                    reg.stop(delete=True)
            self.client.close()

    def _start_pod_planes(self) -> None:
        """Start the pod-scoped planes that outlive worker restarts: the
        compile-cache exchange and the checkpoint replica holder."""
        # cache exchange (train/aot.py): publish this pod's compile-cache
        # manifest + serve entry bytes, so a restaging or newly joined
        # peer pulls the kernel libraries instead of building them.
        # Pod-scoped (survives worker restarts across stages);
        # best-effort.
        if (
            self.job_env.compile_cache_dir
            and os.environ.get("EDL_CACHE_EXCHANGE", "1") != "0"
        ):
            try:
                from edl_tpu_torch.train.aot import CacheExchange

                self.cache_exchange = CacheExchange(
                    self.job_env.compile_cache_dir, self.client,
                    self.job_env.job_id, self.pod.pod_id,
                ).start()
            except Exception as exc:  # noqa: BLE001 — a perf lever, never a gate
                logger.warning("cache exchange unavailable: %s", exc)

        # checkpoint replica holder (checkpoint/replicate.py): pod-scoped
        # like the cache exchange — replicas must survive worker restarts
        # across stages, and the whole point of holding a peer's files is
        # outliving that peer.
        # Leased peers registration so pushers find only live holders.
        if self._ckpt_local_base:
            from edl_tpu_torch.checkpoint.replicate import (
                PEERS_SERVICE,
                ReplicaServer,
                replica_count,
            )

            if replica_count() > 0:
                try:
                    self.ckpt_replicas = ReplicaServer(
                        os.path.join(
                            self._ckpt_local_base,
                            self.pod.pod_id + ".replicas",
                        ),
                        self.client, self.job_env.job_id, self.pod.pod_id,
                        ttl=self.ttl,
                    ).start()
                    self._ckpt_peers_reg = self.registry.register(
                        PEERS_SERVICE, self.pod.pod_id,
                        self.ckpt_replicas.endpoint.encode(), ttl=self.ttl,
                    )
                except Exception as exc:  # noqa: BLE001 — a durability
                    # lever for PEERS' checkpoints; this pod still trains
                    logger.warning("ckpt replica holder unavailable: %s", exc)

    def _stop_pod_planes(self) -> None:
        """Stop every pod-scoped plane: the standby shells, the warmer,
        the exchange (retracting its manifest) and the replica holder."""
        if self.standby_pool is not None:
            self.standby_pool.stop()
        if self.warmer:
            self.warmer.stop()
        if self.cache_exchange is not None:
            self.cache_exchange.stop()
        if self._ckpt_peers_reg is not None:
            self._ckpt_peers_reg.stop(delete=True)
        if self.ckpt_replicas is not None:
            self.ckpt_replicas.stop()

    def _loop(self) -> int:  # edl: event-loop(launcher supervision: lease renewal stalls behind anything slow here)
        while not self._stop.is_set():
            if _FP_LOOP.armed:
                _FP_LOOP.fire(leader=int(self._m_leader.value() or 0))
            try:
                self._events.get(timeout=self.poll)
                while True:  # coalesce bursts
                    self._events.get_nowait()
            except queue.Empty:
                pass

            # job-level terminal state?
            job_meta = self._job_watch.snapshot().get("status")
            if job_meta is not None and job_meta.value == COMPLETE:
                logger.info("pod %s: job COMPLETE, exiting", self.pod.pod_id[:8])
                return 0

            # an externally published preempt/{us} key (the scaler's
            # leader releasing this pod) is a notice too — a held pod
            # with no workers has no other way to learn it must leave
            if (
                not self._draining
                and not self._preempt_notice.is_set()
                and self.pod.pod_id in self._draining_pods()
            ):
                logger.warning(
                    "pod %s: preempt notice found in store; draining",
                    self.pod.pod_id[:8],
                )
                self._preempt_notice.set()

            # a preemption notice turns the pass into a drain (idempotent:
            # repeat signals find _draining already set)
            if self._preempt_notice.is_set() and not self._draining:
                try:
                    self._begin_drain()
                except EdlStoreError as exc:
                    logger.warning(
                        "pod %s: drain bookkeeping failed (%s); draining "
                        "anyway", self.pod.pod_id[:8], exc,
                    )

            # Every duty below is level-triggered off watch snapshots, so
            # a store blip mid-pass is survivable by construction: log it,
            # let the next poll tick re-derive and retry. Crashing the
            # launcher on a transient EdlConnectionError would convert a
            # sub-TTL store outage into a full pod death.
            try:
                if not self._draining:
                    self._handle_token()
                    self._check_death()
                    if self.rank_reg is None:
                        self._race_rank()
                    leader = self._is_leader()
                    self._m_leader.set(1.0 if leader else 0.0)
                    if leader != self._was_leader:
                        # leader election is the causal root of every
                        # restage: make it a black-box fact edl-timeline
                        # can order the drain/publish chain against —
                        # and, when a token is in flight, a segment of
                        # that token's restage trace
                        token = self._handled_token
                        if leader and token:
                            with obs_trace.op_segment(
                                "election", "restage", token,
                                pod=self.pod.pod_id[:8],
                                slot=str(self.rank_slot),
                            ):
                                obs_events.record(
                                    "leader", fsync=True, leader=leader,
                                    pod=self.pod.pod_id[:8],
                                    slot=self.rank_slot,
                                )
                        else:
                            obs_events.record(
                                "leader", fsync=True, leader=leader,
                                pod=self.pod.pod_id[:8], slot=self.rank_slot,
                            )
                        self._was_leader = leader
                    if leader:
                        self._maybe_publish()
                        self._maybe_complete_job()
                    self._adopt_cluster()
                    self._check_stragglers()
            except EdlStoreError as exc:
                logger.warning(
                    "pod %s: store unavailable mid-pass (%s); retrying "
                    "next tick", self.pod.pod_id[:8], exc,
                )

            # (the cache exchange rescans its dir on its own thread —
            # sha256 over the cache dir must never ride this loop)

            # supervise local workers
            if self.procs and self._draining:
                # a draining pod reaps workers INDIVIDUALLY: a rank that
                # finished its drain fast must not tear down a peer still
                # writing its emergency checkpoint. Any exit — drained or
                # crashed — is final here: no grace hold, no respawn.
                for wp in self.procs:
                    if wp.exit_code is None:
                        wp.exit_code = wp.proc.poll()
                exited = [wp for wp in self.procs if wp.exit_code is not None]
                if exited:
                    procs_mod.close_worker_logs(exited)
                    if any(wp.exit_code == DRAINED_EXIT for wp in exited):
                        self._drained_workers = True
                    self.procs = [
                        wp for wp in self.procs if wp.exit_code is None
                    ]
                    if not self.procs:
                        self.running = None
                        logger.info(
                            "pod %s: all workers down; drain complete",
                            self.pod.pod_id[:8],
                        )
                    self._wake()
            elif self.procs:
                code = procs_mod.watch_local_workers(self.procs)
                if code == 0 and not self.completed:
                    self.completed = True
                    procs_mod.close_worker_logs(self.procs)
                    self.procs = []
                    logger.info("pod %s workers COMPLETE", self.pod.pod_id[:8])
                    self._wake()
                elif code == DRAINED_EXIT:
                    # workers saw the preempt key before the launcher's own
                    # signal (delivery races): adopt their decision — flip
                    # into draining; the next pass reaps them individually
                    logger.info(
                        "pod %s worker drained before the launcher noticed; "
                        "joining the drain", self.pod.pod_id[:8],
                    )
                    self._preempt_notice.set()
                    self._wake()
                elif code == HOT_RESTAGE_EXIT and self.hot:
                    # a hot worker could not adopt in-process and asks for
                    # a cold respawn — a restage request, not a failure
                    # (bounded: RAPID repeated fallbacks become real
                    # failures; ones spaced out by recovered training decay)
                    now = time.time()
                    if now - self._hot_fallback_ts > 10 * self.hot_grace:
                        self._hot_fallbacks = 0
                    self._hot_fallback_ts = now
                    self._hot_fallbacks += 1
                    self._m_hot_fallbacks.inc()
                    self._hot_deadline = None
                    self._kill_workers()
                    if self._hot_fallbacks > 3:
                        logger.error(
                            "pod %s: %d consecutive hot-restage fallbacks; "
                            "treating as failure",
                            self.pod.pod_id[:8], self._hot_fallbacks,
                        )
                        return HOT_RESTAGE_EXIT
                    logger.info(
                        "pod %s worker requested respawn (hot-restage "
                        "fallback %d)",
                        self.pod.pod_id[:8], self._hot_fallbacks,
                    )
                    self._wake()
                elif code is not None and code != 0:
                    self._m_worker_failures.inc()
                    failed_stage = (
                        self.running.stage if self.running is not None else ""
                    )
                    grace = self.fail_grace
                    logger.warning(
                        "pod %s worker failed with exit code %d; holding "
                        "%.1fs for a restage before leaving",
                        self.pod.pod_id[:8], code, grace,
                    )
                    self._kill_workers()
                    self._worker_failure = (
                        code, time.time() + grace, failed_stage, grace
                    )
                    self._wake()
            if self.completed and not self._complete_published:
                # COMPLETE must survive a store blip: publish is retried
                # every tick until it lands (the key is permanent, so one
                # success is enough)
                try:
                    self.registry.set_permanent(
                        STATUS_SERVICE, self.pod.pod_id, COMPLETE
                    )
                    self._complete_published = True
                except EdlStoreError as exc:
                    logger.warning(
                        "pod %s: COMPLETE not yet published (%s); retrying",
                        self.pod.pod_id[:8], exc,
                    )
            if self._draining and (
                not self.procs or time.time() > self._drain_deadline
            ):
                return self._finish_drain()
            if self._worker_failure is not None:
                code, deadline, failed_stage, grace = self._worker_failure
                if self.running is not None and self.running.stage != failed_stage:
                    # restaged into a new generation: the crash was
                    # transition collateral, forget it
                    self._worker_failure = None
                elif time.time() > deadline:
                    logger.error(
                        "pod %s worker failed (exit %d) and membership "
                        "stayed stable for %.1fs; leaving job",
                        self.pod.pod_id[:8], code, grace,
                    )
                    return code
        return 0

    def shutdown(self) -> None:
        self._stop.set()
        self._wake()


def launch(
    job_env: JobEnv,
    training_script: str,
    training_args: Sequence[str] = (),
    **kwargs,
) -> int:
    return ElasticLauncher(job_env, training_script, training_args, **kwargs).run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.launch",
        description="Elastic training launcher of the PyTorch port "
        "(≙ reference edl.collective.launch)",
    )
    parser.add_argument("--job_id", default=None)
    parser.add_argument("--store", default=None, help="store endpoint ip:port")
    parser.add_argument(
        "--embed_store",
        action="store_true",
        help="host the coordination store in this launcher if the port is free "
        "(first pod on the host wins; others connect)",
    )
    parser.add_argument(
        "--store_data_dir",
        default=None,
        help="durable state dir for the embedded store (snapshot + wal): a "
        "restarted store on the same dir recovers every key and lease",
    )
    parser.add_argument(
        "--store_replica_dir",
        default=None,
        help="shared-storage replica for the embedded store's snapshots "
        "(store-HOST loss recovery: a replacement embedded store on a "
        "fresh host with an empty data dir seeds itself from here)",
    )
    parser.add_argument(
        "--shards",
        type=int,
        default=int(os.environ.get("EDL_STORE_SHARDS", "1")),
        help="with --embed_store: partition the store keyspace over this "
        "many primaries (consecutive ports from --store's; shard map "
        "published under /store/shards/ so every client discovers the "
        "topology and routes by key). EDL_STORE_SHARDS also sets it. "
        "See DESIGN.md 'Sharded control plane'.",
    )
    parser.add_argument(
        "--store_standby",
        default=None,
        metavar="DATA_DIR",
        help="co-host a WARM-STANDBY store in this launcher (durable "
        "state under DATA_DIR): it live-replicates the primary at "
        "--store and promotes itself — with an epoch bump that fences "
        "the old primary — if the primary dies. Skipped on the pod that "
        "won the --embed_store bind (a standby co-located with its "
        "primary protects nothing). EDL_STORE_STANDBY=dir also enables.",
    )
    parser.add_argument(
        "--store_standby_priority",
        type=int,
        default=int(os.environ.get("EDL_STORE_STANDBY_PRIORITY", "1")),
        help="promotion order among standbys (1 = first in line)",
    )
    parser.add_argument("--nodes_range", default=None, help='"min:max" elastic window')
    parser.add_argument("--nproc_per_node", type=int, default=None)
    parser.add_argument("--log_dir", default=None)
    parser.add_argument("--ckpt_path", default=None)
    parser.add_argument(
        "--compile_cache_dir",
        default=None,
        help="the workers' kernel-library cache (ops/_build.py), shared "
        "across resizes and served to joining pods by the cache exchange "
        "(default: a job-scoped tmp dir; 'none' disables; "
        "EDL_CACHE_EXCHANGE=0 keeps the dir without the exchange)",
    )
    parser.add_argument("--ttl", type=float, default=10.0, help="liveness lease TTL (s)")
    parser.add_argument(
        "--fail_grace",
        type=float,
        default=None,
        help="seconds a worker crash waits for a restage before the pod "
        "abandons the job (default: EDL_FAIL_GRACE or 3x the lease TTL). "
        "Remaining grace is exported as edl_launch_grace_remaining_seconds.",
    )
    parser.add_argument(
        "--drain_budget",
        type=float,
        default=None,
        help="seconds a preemption-noticed pod gives its workers for the "
        "emergency checkpoint before killing what remains (default: "
        "EDL_DRAIN_BUDGET or 10). SIGTERM/SIGUSR1 starts the drain.",
    )
    parser.add_argument(
        "--prewarm",
        action="store_true",
        help="warm the compile cache for the other world sizes in the "
        "elastic window via background shadow stages (launch/warm.py; "
        "only where their devices are free: workers on the CPU, "
        "CUDA_VISIBLE_DEVICES='' in their env, or EDL_PREWARM_FORCE=1). "
        "EDL_PREWARM=1 also enables.",
    )
    parser.add_argument(
        "--standby",
        action="store_true",
        help="keep pre-imported hot-standby worker shells so restages "
        "skip the python+torch cold start (launch/standby.py). "
        "EDL_STANDBY=1 also enables; EDL_STANDBY=0 force-disables.",
    )
    parser.add_argument(
        "--hot-restage",
        "--hot_restage",
        action="store_true",
        help="let surviving workers adopt new stages IN-PROCESS "
        "(torch.distributed group torn down and re-created, checkpoint "
        "restored into the live model) instead of kill+respawn; dirty "
        "handovers fall back to respawn. EDL_HOT_RESTAGE=1 also enables.",
    )
    parser.add_argument("training_script")
    parser.add_argument("training_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    embedded = None
    embedded_shards = []
    standby = None
    if args.embed_store and args.store:
        from edl_tpu_torch.utils.net import split_endpoint

        host, port = split_endpoint(args.store)
        try:
            from edl_tpu_torch.store.server import StoreServer

            embedded = StoreServer(
                host="0.0.0.0", port=port, data_dir=args.store_data_dir,
                replica_dir=args.store_replica_dir, name="store-0",
            ).start()
            logger.info("embedded store serving on :%d", port)
        except OSError:
            logger.info("store port %d already bound; connecting as client", port)
        if embedded is not None and args.shards > 1:
            # sharded control plane: shard 0 (the meta shard, above) won
            # the bind; shards 1..N-1 take the consecutive ports, and
            # the map rows under /store/shards/ tell every client —
            # launchers, workers, edl-top — how to route by key
            from edl_tpu_torch.store import shard as shard_mod
            from edl_tpu_torch.store.client import StoreClient

            shard_eps = [["%s:%d" % (split_endpoint(args.store)[0], port)]]
            for i in range(1, args.shards):
                data_dir = (
                    os.path.join(args.store_data_dir, "shard-%d" % i)
                    if args.store_data_dir else None
                )
                try:
                    srv = StoreServer(
                        host="0.0.0.0", port=port + i, data_dir=data_dir,
                        name="store-%d" % i,
                    ).start()
                except OSError as exc:
                    # a half-started shard fleet must not leak: this pod
                    # won the meta bind, so nobody else is starting the
                    # fleet — a busy shard port is a misconfiguration,
                    # not a race to lose gracefully
                    for started in embedded_shards:
                        started.stop()
                    embedded.stop()
                    raise RuntimeError(
                        "--shards %d needs ports %d-%d free; port %d is "
                        "not (%s)" % (
                            args.shards, port, port + args.shards - 1,
                            port + i, exc,
                        )
                    ) from exc
                embedded_shards.append(srv)
                shard_eps.append(
                    ["%s:%d" % (split_endpoint(args.store)[0], port + i)]
                )
            seed = StoreClient(args.store, timeout=10.0)
            try:
                shard_mod.publish_shard_map(seed, shard_eps)
            finally:
                seed.close()
            logger.info(
                "store keyspace sharded over %d primaries (ports %d-%d)",
                args.shards, port, port + args.shards - 1,
            )
    standby_dir = args.store_standby or os.environ.get("EDL_STORE_STANDBY")
    if standby_dir and args.store and embedded is None:
        # supervise a co-hosted warm standby: it replicates the primary
        # live and takes over (epoch-fenced) if the primary dies. Only on
        # pods that do NOT host the primary — a standby sharing the
        # primary's failure domain protects nothing.
        from edl_tpu_torch.store.server import StoreServer
        from edl_tpu_torch.utils.net import get_host_ip

        standby = StoreServer(
            host="0.0.0.0",
            port=0,
            data_dir=standby_dir,
            follow=args.store,
            priority=args.store_standby_priority,
        )
        standby._advertise = "%s:%d" % (get_host_ip(), standby.port)
        standby.start()
        logger.info(
            "warm-standby store on :%d following %s (priority %d)",
            standby.port, args.store, args.store_standby_priority,
        )

    job_env = JobEnv(
        job_id=args.job_id,
        store_endpoint=args.store,
        nodes_range=args.nodes_range,
        nproc_per_node=args.nproc_per_node,
        log_dir=args.log_dir,
        ckpt_path=args.ckpt_path,
        compile_cache_dir=args.compile_cache_dir,
    )
    try:
        return launch(
            job_env,
            args.training_script,
            args.training_args,
            ttl=args.ttl,
            prewarm=args.prewarm,
            standby=args.standby,
            hot_restage=args.hot_restage,
            fail_grace=args.fail_grace,
            drain_budget=args.drain_budget,
        )
    finally:
        if standby is not None:
            standby.stop()
        for srv in embedded_shards:
            srv.stop()
        if embedded is not None:
            embedded.stop()


if __name__ == "__main__":
    sys.exit(main())
