"""Named chaos scenarios: compose faults against a live elastic job and
audit the recovery with :mod:`edl_tpu_torch.chaos.invariants`.

Each scenario owns a :class:`Rig` — a real StoreServer, a ResizeHarness
driving real launcher pods around the chaos trainee, a metrics harvester
scraping every obs endpoint the job registers, and the crash-safe chaos
injection ledger — runs one named fault composition, and returns a
:class:`ScenarioOutcome` whose invariants must ALL hold.

Scenarios (see DESIGN.md "Chaos & fault injection"):

- ``worker-kill``     SIGKILL-equivalent death of a worker mid-step;
- ``store-blip``      the launcher loses the store for longer than the
  lease TTL and must re-register, drain, and restage;
- ``corrupt-ckpt``    machine death + the newest checkpoint version
  corrupted on disk; restore must fall back;
- ``slow-rpc``        a seeded latency tail on every store RPC;
- ``teacher-failover`` a distill teacher dies mid-epoch and a
  replacement joins;
- ``serve-slo-churn`` the serving resilience plane under churn: one
  teacher dies without deregistering (breaker ejection, not
  discovery), one drains gracefully, one grows a sub-SLO latency tail
  (hedges absorb it) — gated on answered-p99 vs SLO, bounded shed,
  breaker-open latency, hedge budget, and zero silent request loss;
- ``store-failover``  the PRIMARY STORE dies mid-job: the warm standby
  promotes within budget, no acked write is lost (strict, semi-sync
  holds the ack until standby-applied), the fenced old primary is
  rejected on restart, watches resume exactly-once;
- ``store-shard-failover`` every primary of a 2-shard control plane
  dies at once: per-shard promotion, per-shard strict zero acked-write
  loss, training completes through it;
- ``ckpt-peer-loss``  the checkpoint-writing pod is SIGKILLed and its
  durable checkpoint tier deleted in the same instant: the survivor and
  the replacement restore from PEER REPLICAS with zero durable-tier
  reads, lost work bounded by the last replicated step;
- ``preempt-drain``   a pod gets an advance preemption notice (SIGTERM):
  emergency checkpoint within budget, DRAINED exit, proactive restage
  with no lease-expiry wait and no grace hold, lost work ≤ one step;
- ``straggler-stall`` a worker wedges mid-step forever: the launcher's
  heartbeat watchdog ejects it within the deadline and the job resumes
  (the matching false-positive drill rides ``slow-rpc``);
- ``monitor-clean``   NO fault at all: the monitor plane's
  zero-false-positive control — a clean run must fire nothing, through
  completion and the post-completion quiet;
- ``autoscale-churn`` the scale plane under a seeded signal trace:
  pool capacity and gradient-noise swings drive real grow/shrink
  decisions through the drain/restage machinery (grow admits held
  pods, shrink publishes autoscale preempt notices), gated on goodput
  loss vs the offline oracle schedule and on decision->restage
  latency;
- ``autoscale-multijob`` two elastic jobs arbitrated on ONE shared
  pool: a higher-priority job is submitted mid-flight, the running job
  is preempted down via the drain plane, the newcomer is gang-released
  only once the freed pods are real, both jobs complete, and neither
  ever publishes a stage below its min world.

Every rig also runs the monitor plane (``obs/monitor.py``) with
CPU-rig-paced rules; ``worker-kill`` and ``preempt-drain`` additionally
assert that ``goodput-degraded`` fired within a bounded alert latency of
the fault (the ``alerts_fired`` invariant).

Scenarios are deterministic per seed (seeded fault schedules;
invariants are timing-tolerant within explicit budgets).

The port's copy of ``edl_tpu/chaos/scenario.py``: the same scenarios,
invariant lists, budgets and keys, on the port's own stack — its store,
its monitor, and a :class:`ResizeHarness` that spawns
``python -m edl_tpu_torch.launch`` pods around the port's trainee. The
trainee trains on the rig's ``device`` (``EDL_CHAOS_DEVICE``; ``cuda``
by default, which raises where CUDA is absent); on the CPU the rig also
gives the pods ``EDL_COMPILE_CACHE_DIR=none`` (a CPU worker loads no
kernel library, so no cache exchange and no AOT ladder runs). One
departure: ``autoscale-multijob``'s ``priority_admission_ordered``
compares A's shrunk stage after its preemption with B's first stage that
has pods (the JAX scenario's comparison also admits A's bootstrap and
B's empty held generation, so its verdict depends on process start
order).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.chaos import invariants as inv
from edl_tpu_torch.chaos import plane as chaos
from edl_tpu_torch.harness.resize import ResizeHarness
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.store.server import StoreServer
from edl_tpu_torch.utils import telemetry
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("chaos.scenario")

TRAINEE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trainee.py")

# one downtime budget for every scenario on CPU rigs: generous against
# host-load noise, tight enough to catch a wedged recovery (the real
# numbers land in the outcome's info for trending)
DOWNTIME_BUDGET_S = 45.0

# fault -> monitor "goodput-degraded" firing bound: covers lease expiry,
# the restage gap the rule needs to observe, and the rule's own
# window + for-duration pacing, with CI-noise margin
ALERT_LATENCY_BUDGET_S = 30.0


def _monitor_rules():
    """The built-in rule pack re-paced for CPU-rig time budgets: chaos
    trainees step every ~0.2s and restage gaps last single-digit
    seconds, so detection windows shrink from tens of seconds to ~1s.
    The RULES are the production ones — only the pacing changes."""
    from edl_tpu_torch.obs import monitor as obs_monitor

    rules = obs_monitor.builtin_rules()
    paced = {
        "goodput-degraded": dict(window_s=1.5, for_s=0.75, value=0.05),
        "dead-endpoint": dict(stale_s=4.0),
        "heartbeat-stale": dict(window_s=5.0),
        "straggler-ejections": dict(window_s=10.0),
        "ckpt-restore-fallbacks": dict(window_s=10.0),
        "ckpt-replica-stale": dict(for_s=4.0),
        "telemetry-dropped-keys": dict(window_s=10.0),
        "replication-lag": dict(for_s=2.0),
        "repl-sync-degraded": dict(window_s=10.0),
        "distill-queue-saturated": dict(for_s=2.0),
        # serving plane: chaos drills shed within seconds of an induced
        # overload and trip breakers in under a second
        "serve-shed-rate": dict(window_s=10.0, for_s=2.0),
        "breaker-open": dict(for_s=2.0),
        # numerics plane: chaos trainees publish every 1-2 steps (the
        # drills pin EDL_NUMERICS_EVERY low), so the nonfinite-rate and
        # divergence/stall hold windows shrink with everything else
        "nan-detected": dict(window_s=10.0),
        "loss-spike": dict(window_s=20.0),
        "replica-divergence": dict(for_s=2.0),
        "grad-stall": dict(for_s=4.0),
        # scale plane: the autoscale drills legitimately drain a few
        # times per minute (that IS the scenario), so thrash means a
        # genuine storm — sustained >= 1 autoscale drain per second
        "autoscale-thrash": dict(window_s=10.0, for_s=2.0, value=1.0),
        # memory plane: a chaos OOM must page within the alert budget —
        # the oom counter registers at 0 when the trainee's plane comes
        # up, so the 0 -> 1 jump is always visible to the rate window;
        # pressure holds shrink with the rest of the rig's pacing
        "oom-detected": dict(window_s=10.0),
        "hbm-pressure": dict(for_s=1.0, resolve_s=2.0),
        "donation-dropped": dict(window_s=10.0),
    }
    for rule in rules:
        for field, value in paced.get(rule.name, {}).items():
            setattr(rule, field, value)
    return rules


@dataclasses.dataclass
class ScenarioOutcome:
    name: str
    seed: int
    ok: bool
    invariants: List[inv.InvariantResult]
    info: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "scenario": self.name,
            "seed": self.seed,
            "ok": self.ok,
            "invariants": [
                {"name": r.name, "ok": r.ok, "detail": r.detail}
                for r in self.invariants
            ],
            "info": self.info,
        }


def _outcome(name: str, seed: int, results: List[inv.InvariantResult], **info) -> ScenarioOutcome:
    return ScenarioOutcome(
        name, seed, all(r.ok for r in results), results, dict(info)
    )


class Rig:
    """One scenario's world: store + harness env + evidence collection.

    ``ha=True`` builds the control plane the store-failover drill
    attacks: a durable primary on a pinned port plus a warm standby
    (synced before the rig is handed out), with every client — the
    rig's own, the launcher's, the trainee's — given the ordered
    two-endpoint list."""

    def __init__(
        self,
        workdir: str,
        job_id: str,
        seed: int,
        ha: bool = False,
        shards: int = 1,
        device: str = "cuda",
    ) -> None:
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        # the trainee's device, handed to every pod as EDL_CHAOS_DEVICE
        self.device = device
        self.job_id = job_id
        self.seed = seed
        self.chaos_log = os.path.join(workdir, "chaos.log")
        self.ckpt_dir = os.path.join(workdir, "ckpt")
        # black-box evidence every scenario leaves behind: flight-recorder
        # segments (goodput_accounted audits them; edl-timeline replays
        # the whole run from this workdir) and per-process Chrome traces
        self.flight_dir = os.path.join(workdir, "flight")
        self.trace_dir = os.path.join(workdir, "traces")
        # the env the last harness handed its pods — the knob snapshot
        # archived with the run (the rig's own env carries none of it)
        self.job_env: Dict[str, str] = {}
        self.standby: Optional[StoreServer] = None
        # every (primary, standby) replication group; one entry per shard
        self.shard_servers: List[tuple] = []
        if ha:
            from edl_tpu_torch.utils.net import find_free_ports

            self.primary_dir = os.path.join(workdir, "store-primary")
            # a pinned port so the dead primary can be resurrected at the
            # SAME endpoint every client still lists first
            self.primary_port = find_free_ports(1)[0]
            self.store = StoreServer(
                host="127.0.0.1", port=self.primary_port,
                data_dir=self.primary_dir, name="store-0",
            ).start()
            self.standby = StoreServer(
                host="127.0.0.1", port=0,
                data_dir=os.path.join(workdir, "store-standby"),
                follow=self.store.endpoint, priority=1, failover_grace=1.0,
                name="store-0",
            ).start()
            self.shard_servers.append((self.store, self.standby))
            for i in range(1, max(1, shards)):
                primary_i = StoreServer(
                    host="127.0.0.1", port=0,
                    data_dir=os.path.join(workdir, "store-p%d" % i),
                    name="store-%d" % i,
                ).start()
                standby_i = StoreServer(
                    host="127.0.0.1", port=0,
                    data_dir=os.path.join(workdir, "store-s%d" % i),
                    follow=primary_i.endpoint, priority=1,
                    failover_grace=1.0, name="store-%d" % i,
                ).start()
                self.shard_servers.append((primary_i, standby_i))
            deadline = time.time() + 30
            for _primary, standby_i in self.shard_servers:
                while time.time() < deadline and not standby_i._has_state:
                    time.sleep(0.05)
                assert standby_i._has_state, "standby never bootstrapped"
            if len(self.shard_servers) > 1:
                # the sharded control plane under test: publish the map
                # on the meta shard; every client (the rig's own, the
                # launcher's, the trainee's) discovers it via
                # connect_store and routes by key
                from edl_tpu_torch.store import shard as shard_mod

                boot = StoreClient(self.store.endpoint, timeout=5.0)
                try:
                    shard_mod.publish_shard_map(boot, [
                        [p.endpoint, s.endpoint]
                        for p, s in self.shard_servers
                    ])
                finally:
                    boot.close()
            self.store_endpoints = "%s,%s" % (
                self.store.endpoint, self.standby.endpoint
            )
        else:
            self.store = StoreServer(host="127.0.0.1", port=0).start()
            self.store_endpoints = self.store.endpoint
        from edl_tpu_torch.store.client import connect_store

        self.client = connect_store(self.store_endpoints, timeout=5.0)
        self.harvester = inv.MetricsHarvester(self.client, job_id)
        # the monitor plane rides EVERY scenario: faulted runs prove the
        # alerts fire, the clean control run proves they stay silent
        from edl_tpu_torch.obs import metrics as obs_metrics
        from edl_tpu_torch.obs.monitor import Monitor

        self.monitor_dir = os.path.join(workdir, "monitor")
        self.monitor = Monitor(
            self.store_endpoints,
            job_id,
            rules=_monitor_rules(),
            # a PRIVATE registry: the monitor's self-scrape folds its
            # registry into rule evaluation, and the rig often runs
            # embedded in a long-lived host process (pytest) whose
            # default registry carries state from everything that ran
            # before — e.g. a breaker gauge a PREVIOUS drill's client
            # legitimately left OPEN would fire breaker-open inside the
            # monitor-clean zero-false-positive control. The scenario's
            # real evidence comes from scraping its own workers.
            registry=obs_metrics.MetricsRegistry(),
            # 0.4s matches the harvester's cadence: fast enough for the
            # ~1.5s rule windows, light enough that watching the rig
            # does not load the control plane it watches. HA rigs run
            # the whole primary+standby pair IN-PROCESS, where monitor
            # CPU (scrape parsing, sample persistence) steals GIL time
            # from both event loops and widens the async-replication
            # window the failover drill deliberately attacks — no alert
            # -latency invariant runs there, so watch at a gentle 1s
            interval=1.0 if ha else 0.4,
            # telemetry.collect() is three keyspace range scans decoded
            # in-process: skip it where the pair shares the GIL
            collect_telemetry=not ha,
            retention_s=60.0,
            monitor_dir=self.monitor_dir,
        ).start()

    def harness(
        self,
        spec: Optional[Dict],
        nodes_range: str = "1:2",
        ttl: float = 0.8,
        total: int = 16,
        ckpt_every: int = 4,
        step_time: float = 0.08,
        nproc: int = 1,
        extra: Optional[Dict[str, str]] = None,
    ) -> ResizeHarness:
        env = {
            "EDL_CHAOS_LOG": self.chaos_log,
            "EDL_CHAOS_SEED": str(self.seed),
            "EDL_CKPT_PATH": self.ckpt_dir,
            "EDL_FLIGHT_DIR": self.flight_dir,
            "EDL_TRACE_DIR": self.trace_dir,
            # the scenario-level archive (run_scenario) is the only one:
            # the harness's own EDL_RUN_ARCHIVE hook must not produce a
            # second, invariant-less bundle of the same run
            "EDL_RUN_ARCHIVE": "0",
            "EDL_OBS_PORT": "0",
            "EDL_CHAOS_DEVICE": self.device,
            "EDL_DEVICES_PER_PROC": "1",
            "EDL_CHAOS_TOTAL_STEPS": str(total),
            "EDL_CHAOS_CKPT_EVERY": str(ckpt_every),
            "EDL_CHAOS_STEP_TIME": str(step_time),
        }
        if self.device == "cpu":
            # a CPU trainee loads no kernel library: no cache dir, so the
            # launcher starts no exchange and the trainer no AOT ladder
            env["EDL_COMPILE_CACHE_DIR"] = "none"
        if self.standby is not None:
            # HA rigs: the cache exchange's manifest puts are journal
            # traffic riding the primary->standby replication stream —
            # exactly the async window the failover drill kills into
            # (same reasoning as the gentle monitor pacing above; the
            # exchange has end-to-end drills of its own)
            env["EDL_CACHE_EXCHANGE"] = "0"
        if spec is not None:
            env["EDL_CHAOS"] = json.dumps(spec)
        if extra:
            env.update(extra)
        self.job_env = dict(env)
        return ResizeHarness(
            self.store_endpoints,
            self.job_id,
            TRAINEE,
            nodes_range=nodes_range,
            ttl=ttl,
            log_dir=os.path.join(self.workdir, "logs"),
            extra_env=env,
            device=self.device,
        )

    # -- observation -------------------------------------------------------

    def cursor(self, rank: int = 0) -> int:
        try:
            value = self.client.get(
                chaos.chaos_prefix(self.job_id) + "progress/step.w%d" % rank
            )
        except Exception:  # noqa: BLE001 — store may be mid-fault
            return -1
        return int(value) if value else -1

    def wait_cursor(self, min_step: int, timeout: float) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.cursor() >= min_step:
                return True
            time.sleep(0.1)
        return False

    def evidence(self) -> inv.Evidence:
        return inv.Evidence(
            progress=inv.read_progress(self.client, self.job_id),
            telemetry=telemetry.collect(self.client, self.job_id),
            chaos_log=inv.read_chaos_log(self.chaos_log),
            metrics=self.harvester.snapshot(),
        )

    def flight_events(self) -> list:
        """Merged flight-recorder events from every process of the run
        (killed ones included — that is the point of the recorder)."""
        from edl_tpu_torch.obs import events as obs_events

        return obs_events.read_segments(self.flight_dir)

    def trace_spans(self) -> list:
        """Linked spans from every process's trace export (the
        distributed-tracing evidence critical_path_traced audits)."""
        from edl_tpu_torch.obs import tracepath

        return tracepath.load_run(self.trace_dir)

    def alerts(self) -> dict:
        """The monitor plane's published alert records for this job."""
        from edl_tpu_torch.obs.monitor import read_alerts

        return read_alerts(self.client, self.job_id)

    def close(self) -> None:
        self.monitor.stop()
        self.harvester.stop()
        self.client.close()
        self.store.stop()
        if self.standby is not None:
            self.standby.stop()
        for primary, standby in self.shard_servers[1:]:
            primary.stop()
            standby.stop()


# -- scenarios ----------------------------------------------------------------


def worker_kill(rig: Rig) -> ScenarioOutcome:
    """A worker dies SIGKILL-style mid-step. Its pod leaves the job, the
    survivor drains on lease expiry, restages at the smaller world, and
    resumes from the shared checkpoint."""
    total, ckpt_every = 30, 3
    spec = {
        "seed": rig.seed,
        "rules": [
            # the 7th step fired by whichever process runs global rank 1
            # (step 6): late enough that rank 0's first checkpoint —
            # save(3) blocks its loop at the step-2/3 boundary — is
            # provably durable before the fault, so "resumed, not
            # restarted" is a deterministic property, not a race against
            # how fast the survivor drains
            {"point": "train.step", "proc": "worker", "action": "kill",
             "match": {"rank": "1"}, "after": 7},
        ],
    }
    # steps slow enough that the survivor cannot finish before the kill,
    # grace window, lease expiry, and restage all play out mid-training
    harness = rig.harness(
        spec, nodes_range="1:2", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
    )
    try:
        done = harness.run_schedule([2], interval=3.0, timeout=150.0)
    finally:
        harness.shutdown()
    ev = rig.evidence()
    alerts = rig.alerts()
    kills = [
        e for e in ev.chaos_log
        if e.get("point") == "train.step" and e.get("action") == "kill"
    ]
    prefault = max(
        (int(e["ctx"].get("step", 0)) for e in kills), default=None
    )
    kill_ts = min((float(e.get("ts", 0.0)) for e in kills), default=0.0)
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.resumed_past_prefault_step(ev, prefault),
        inv.replay_bounded(ev, ckpt_every),
        inv.downtime_bounded(ev, DOWNTIME_BUDGET_S),
        inv.fault_injected(ev, "train.step", "kill"),
        inv.multiple_stages(ev),
        # the accounting itself is under test: the SIGKILLed rank's
        # segments must still add up (flight recorder survives the kill)
        inv.goodput_accounted(rig.flight_events()),
        # so is the tracing plane: the post-kill restage must stitch
        # into one cross-process critical path that agrees with the
        # goodput ledger's restage lane
        inv.critical_path_traced(rig.trace_spans(), rig.flight_events()),
        # the monitor plane is under test too: the kill must be noticed
        # within the alert-latency budget — dead-endpoint detects the
        # SIGKILLed worker structurally; goodput-degraded joins when
        # the restage gap is long enough for the paced rate window
        # (the sharded control plane shortened that gap to ~2 s on this
        # rig, below the window — recovery outrunning detection)
        inv.alert_fired_any(
            alerts, ["goodput-degraded", "dead-endpoint"],
            kill_ts, ALERT_LATENCY_BUDGET_S,
        ),
        # the resize continuity sentinel: every post-kill restore must
        # have re-verified the checkpoint's numerics fingerprint and
        # found the resumed loss continuous with the saved one
        inv.numerics_continuous(rig.flight_events()),
    ]
    return _outcome(
        "worker-kill", rig.seed, results,
        harness_completed=done, prefault_step=prefault,
        alerts_fired=sorted(alerts),
    )


def _consistency_results(
    rig: Rig, *churns
) -> List[inv.InvariantResult]:
    """Stop the consistency probes, replay the op tape through the
    history checker, drop the verdict into the flight dir (edl-timeline
    instant + archive evidence), and return the three consistency
    invariants every store drill must hold."""
    from edl_tpu_torch.chaos import consistency as cons

    for churn in churns:
        churn.stop()
    report = cons.check_history(rig.flight_events())
    cons.record_verdict(report, rig.flight_dir)
    return [
        inv.no_stale_reads(report),
        inv.monotonic_session_reads(report),
        inv.watch_gap_free(report),
    ]


def store_blip(rig: Rig) -> ScenarioOutcome:
    """The launcher's store connection blips for longer than the lease
    TTL: leases expire, the shared retry path (utils/retry.py)
    re-registers, the job drains and restages, training resumes."""
    from edl_tpu_torch.chaos.consistency import ConsistencyChurn

    total, ckpt_every = 24, 3
    spec = {
        "seed": rig.seed,
        "rules": [
            # after 60 launcher requests (a few seconds into TRAINING at
            # the coalesced-renew request rate: ~30 land during
            # bootstrap), partition the store for 3 s of wall clock —
            # comfortably past the 0.8 s TTL. (A drop COUNT stopped
            # being a time proxy when lease renewals got coalesced into
            # one batched RPC per tick: the old "drop the next 35"
            # spanned ~10x the wall time at the reduced QPS, and
            # request #30 moved from mid-training into bootstrap.)
            {"point": "store.client.request", "proc": "launcher",
             "action": "partition", "after": 60, "duration_s": 3.0},
        ],
    }
    harness = rig.harness(
        spec, nodes_range="1:1", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
    )
    # the consistency probe churns taped reads/writes/watches through
    # the whole blip: the history checker proves the degraded window
    # never showed anyone a stale or rewound view
    churn = ConsistencyChurn(rig.store_endpoints, rig.flight_dir)
    try:
        done = harness.run_schedule([1], interval=3.0, timeout=150.0)
    finally:
        harness.shutdown()
    consistency_results = _consistency_results(rig, churn)
    ev = rig.evidence()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        inv.fault_injected(ev, "store.client.request", "partition", at_least=5),
        inv.retries_observed(ev),
        inv.downtime_bounded(ev, DOWNTIME_BUDGET_S),
        *consistency_results,
    ]
    return _outcome("store-blip", rig.seed, results, harness_completed=done)


def corrupt_checkpoint(rig: Rig) -> ScenarioOutcome:
    """Machine death plus a corrupted newest checkpoint: the replacement
    pod's restore must fall back past the torn version and resume from
    the previous good one."""
    total, ckpt_every = 18, 4
    harness = rig.harness(
        None, nodes_range="1:1", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.15,
    )
    corrupted_step = None
    try:
        harness.start_pod()
        # let >= 2 versions land (saves at steps 4 and 8), then "lose the
        # machine" mid-flight and tear the newest version on disk
        assert rig.wait_cursor(2 * ckpt_every, timeout=90.0), (
            "trainee never reached step %d (cursor %d)"
            % (2 * ckpt_every, rig.cursor())
        )
        if harness.pods:
            harness.kill_pod(harness.pods[-1])
        corrupted_step = corrupt_latest_checkpoint(rig.ckpt_dir)
        harness.start_pod()
        done = harness.run_schedule([], interval=1.0, timeout=120.0)
    finally:
        harness.shutdown()
    ev = rig.evidence()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.checkpoint_fell_back(ev, corrupted_step or 0),
        inv.resumed_past_prefault_step(ev, corrupted_step),
        inv.downtime_bounded(ev, DOWNTIME_BUDGET_S),
    ]
    return _outcome(
        "corrupt-ckpt", rig.seed, results,
        harness_completed=done, corrupted_step=corrupted_step,
    )


def slow_rpc(rig: Rig) -> ScenarioOutcome:
    """A seeded latency tail on every store RPC server-side: the job must
    complete in one generation — slow control plane, no spurious drains,
    and (the watchdog false-positive drill) ZERO straggler ejections even
    with the stall deadline tightened far below production defaults."""
    total, ckpt_every = 16, 4
    # the store runs in THIS process: arm the plane directly
    armed = chaos.configure(
        {
            "seed": rig.seed,
            "rules": [
                {"point": "store.server.dispatch", "proc": "store",
                 "action": "delay", "delay_s": 0.04, "prob": 0.25,
                 "times": 0},
            ],
        },
        who="store",
    )
    harness = rig.harness(
        None, nodes_range="1:1", ttl=2.5, total=total, ckpt_every=ckpt_every,
        extra={
            # the drill: heartbeats flowing, watchdog armed TIGHT — slow
            # store RPCs must still not look like a wedged worker
            "EDL_HEARTBEAT_EVERY": "0.05",
            "EDL_STALL_DEADLINE": "8.0",
            "EDL_STALL_FLOOR": "2.0",
        },
    )
    try:
        done = harness.run_schedule([1], interval=3.0, timeout=120.0)
        # evidence BEFORE shutdown: the shutdown SIGTERM is itself a drain
        # notice now, and its preempt bookkeeping must not pollute the
        # zero-stragglers ledger of the run under test
        ev = rig.evidence()
    finally:
        harness.shutdown()
        chaos.disarm()
    from edl_tpu_torch.obs import metrics as obs_metrics

    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.single_stage(ev),
        inv.zero_stragglers(ev),
        inv.faults_visible_in_metrics(
            ev, "store.server.dispatch",
            extra_registry=obs_metrics.default_registry(),
        ),
    ]
    return _outcome(
        "slow-rpc", rig.seed, results,
        harness_completed=done, rules_armed=armed,
    )


def teacher_failover(rig: Rig) -> ScenarioOutcome:
    """A distill teacher dies mid-epoch; the reader's pool cools it down,
    re-queues its in-flight tasks, and finishes the epoch on the
    replacement — every batch exactly once, in order."""
    import numpy as np

    from edl_tpu_torch.distill.discovery import DiscoveryClient, DiscoveryService, TeacherRegister
    from edl_tpu_torch.distill.reader import DistillReader
    from edl_tpu_torch.distill.serving import EchoPredictBackend, PredictServer

    # slow each predict a little so the failover lands mid-epoch
    chaos.configure(
        {
            "seed": rig.seed,
            "rules": [
                {"point": "distill.predict", "proc": "student",
                 "action": "delay", "delay_s": 0.03, "times": 0},
            ],
        },
        who="student",
    )
    job = rig.job_id
    num_batches, batch = 24, 8
    t1 = PredictServer(EchoPredictBackend()).start()
    t2 = PredictServer(EchoPredictBackend()).start()
    svc = DiscoveryService(rig.store.endpoint, job, ["teacher"])
    reg1 = TeacherRegister(rig.store.endpoint, job, "teacher", t1.endpoint)
    reg2 = TeacherRegister(rig.store.endpoint, job, "teacher", t2.endpoint)
    probe = DiscoveryClient(
        rig.store.endpoint, job, "teacher", client_id="chaos-probe"
    )
    replacement = []

    def batches():
        for i in range(num_batches):
            x = np.full((batch, 4), float(i), np.float32)
            yield (x,)

    reader = DistillReader(feeds=("x",), teacher_batch_size=batch, require_num=2)
    reader.set_dynamic_teacher(rig.store.endpoint, job, "teacher")
    reader.set_batch_generator(batches)
    seen: List[int] = []
    try:
        probe.wait_servers(timeout=10.0)
        for i, out in enumerate(reader()):
            seen.append(int(out[0][0][0]))
            if i == 4:
                # teacher 1 dies mid-epoch (socket resets, not a clean bye)
                reg1.stop()
                t1.stop()
            if i == 8 and not replacement:
                srv = PredictServer(EchoPredictBackend()).start()
                replacement.append(
                    (srv, TeacherRegister(rig.store.endpoint, job, "teacher", srv.endpoint))
                )
    finally:
        reader.stop()
        probe.stop()
        for srv, reg in replacement:
            reg.stop()
            srv.stop()
        reg2.stop()
        svc.stop()
        t2.stop()
        chaos.disarm()
    from edl_tpu_torch.obs import metrics as obs_metrics

    ordered = seen == list(range(num_batches))
    results = [
        inv.InvariantResult(
            "batches_exactly_once_in_order",
            ordered,
            "yielded %d/%d%s" % (
                len(seen), num_batches,
                "" if ordered else (", got %s" % seen[:30]),
            ),
        ),
        inv.faults_visible_in_metrics(
            inv.Evidence(), "distill.predict",
            extra_registry=obs_metrics.default_registry(),
        ),
    ]
    return _outcome(
        "teacher-failover", rig.seed, results, batches=len(seen),
    )


BREAKER_OPEN_BUDGET_S = 5.0   # teacher death -> breaker OPEN bound
DRAIN_GRACE_S = 2.0           # drain mark -> assignment propagation bound


def serve_slo_churn(rig: Rig) -> ScenarioOutcome:
    """The serving resilience plane under teacher churn, gated on SLO.

    A 4-teacher fleet serves paced predict load through the full stack —
    admission control on the teachers, breaker/hedge/retry-budget routing
    in the :class:`~edl_tpu_torch.distill.slo.SloDriver` — while three distinct
    faults land mid-run:

    - one teacher **dies without deregistering** (its store lease keeps
      advertising the corpse for the rest of the run — the circuit
      breaker, not discovery, must take it out of rotation);
    - one teacher **drains gracefully** (the balancer must stop routing
      new work to it within a propagation grace);
    - one teacher grows a **latency tail** (a chaos delay below the SLO
      — hedges and queue-weighted routing must absorb it, not shed it).

    GREEN means: every issued request got exactly one explicit verdict
    (nothing silently lost), the answered-request p99 stayed under the
    SLO, the shed fraction stayed bounded, the breaker opened on the
    dead teacher within budget, and hedging stayed inside its
    fraction-of-primaries construction."""
    import threading

    import numpy as np

    from edl_tpu_torch.distill.discovery import (
        DiscoveryClient,
        DiscoveryService,
        TeacherRegister,
    )
    from edl_tpu_torch.distill.resilience import BreakerBoard
    from edl_tpu_torch.distill.serving import EchoPredictBackend, PredictServer
    from edl_tpu_torch.distill.slo import SloDriver

    job = rig.job_id
    slo_ms = 400.0
    qps, duration = 25.0, 12.0
    teachers = [
        PredictServer(EchoPredictBackend(), queue_limit=32, slo_ms=slo_ms).start()
        for _ in range(4)
    ]
    dead, drained, slowed = (
        teachers[0].endpoint, teachers[1].endpoint, teachers[2].endpoint,
    )
    svc = DiscoveryService(rig.store.endpoint, job, ["teacher"])
    regs = [
        TeacherRegister(rig.store.endpoint, job, "teacher", t.endpoint)
        for t in teachers
    ]
    probe = DiscoveryClient(
        rig.store.endpoint, job, "teacher", client_id="slo-driver"
    )

    opened_at: Dict[str, float] = {}
    breakers = BreakerBoard(
        failures=3, open_s=2.0,
        on_open=lambda e: opened_at.setdefault(e, time.monotonic()),
    )
    data = np.random.default_rng(rig.seed).random((4, 8), dtype=np.float32)
    driver = SloDriver(
        lambda: probe.get_servers()[1],
        lambda seq: {"x": data},
        qps=qps,
        duration_s=duration,
        slo_ms=slo_ms,
        concurrency=6,
        rpc_timeout=2.0,
        seed=rig.seed,
        breakers=breakers,
    )
    box: Dict = {}

    def _run() -> None:
        box["summary"] = driver.run()

    t_kill = None
    t_drain_off = None
    try:
        probe.wait_servers(timeout=10.0)
        th = threading.Thread(target=_run, name="slo-churn", daemon=True)
        start = time.monotonic()
        th.start()
        # t+3s: teacher 0 dies WITHOUT a goodbye — its registration lease
        # outlives it, so discovery keeps offering the corpse and only
        # the breaker can eject it
        time.sleep(max(0.0, start + 3.0 - time.monotonic()))
        teachers[0].stop()
        t_kill = time.monotonic()
        # t+5s: teacher 1 drains gracefully (balancer-side ejection)
        time.sleep(max(0.0, start + 5.0 - time.monotonic()))
        regs[1].drain()
        t_drain_off = time.monotonic() - start
        # t+6.5s: teacher 2 grows a 250 ms tail — UNDER the 400 ms SLO,
        # so the right response is hedges + steering, not shedding
        time.sleep(max(0.0, start + 6.5 - time.monotonic()))
        chaos.configure(
            {
                "seed": rig.seed,
                "rules": [
                    {"point": "distill.serving.predict", "action": "delay",
                     "delay_s": 0.25, "times": 0,
                     "match": {"port": str(teachers[2].port)}},
                ],
            },
            who="slo-churn",
        )
        th.join(timeout=duration + 45.0)
        driver_done = not th.is_alive()
    finally:
        chaos.disarm()
        probe.stop()
        for reg in regs:
            try:
                reg.stop()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        svc.stop()
        for t in teachers[1:]:
            t.stop()
    from edl_tpu_torch.obs import metrics as obs_metrics

    summary = box.get("summary") or {}
    counts = summary.get("verdicts", {})
    requests = summary.get("requests", 0)
    total = int(round(qps * duration))
    p99 = summary.get("serve_p99_ms")
    shed_pct = summary.get("serve_shed_pct", 100.0)
    hedges = summary.get("hedges", 0)
    open_lat = (
        opened_at[dead] - t_kill
        if (dead in opened_at and t_kill is not None) else None
    )
    late_to_drained = [
        v for v in driver.verdicts
        if v.endpoint == drained
        and t_drain_off is not None
        and v.t_s > t_drain_off + DRAIN_GRACE_S
    ]
    results = [
        inv.InvariantResult(
            "every_request_has_a_verdict",
            driver_done and requests == total
            and sum(counts.values()) == total,
            "driver %s; %d/%d verdicts: %s" % (
                "finished" if driver_done else "WEDGED",
                sum(counts.values()), total, counts,
            ),
        ),
        inv.InvariantResult(
            "answered_p99_within_slo",
            p99 is not None and p99 <= slo_ms,
            "p99 %s ms vs SLO %.0f ms (ok=%d late=%d)" % (
                p99, slo_ms, counts.get("ok", 0), counts.get("late", 0),
            ),
        ),
        inv.InvariantResult(
            "shed_fraction_bounded",
            shed_pct <= 25.0,
            "shed %.2f%% (bound 25%%)" % shed_pct,
        ),
        inv.InvariantResult(
            "breaker_opened_on_dead_teacher",
            open_lat is not None and open_lat <= BREAKER_OPEN_BUDGET_S,
            "open after %s (budget %.0fs); opened: %s" % (
                "%.2fs" % open_lat if open_lat is not None else "NEVER",
                BREAKER_OPEN_BUDGET_S, sorted(opened_at),
            ),
        ),
        inv.InvariantResult(
            "hedges_within_budget",
            hedges <= 0.10 * max(1, requests) + 5.0 + 1e-9,
            "%d hedges vs 0.10 x %d primaries + 5 burst" % (hedges, requests),
        ),
        inv.InvariantResult(
            "drained_teacher_left_rotation",
            not late_to_drained,
            "%d primaries routed to the drained teacher > %.1fs after "
            "its drain mark" % (len(late_to_drained), DRAIN_GRACE_S),
        ),
        inv.faults_visible_in_metrics(
            inv.Evidence(), "distill.serving.predict",
            extra_registry=obs_metrics.default_registry(),
        ),
    ]
    return _outcome(
        "serve-slo-churn", rig.seed, results,
        breaker_open_s=round(open_lat, 2) if open_lat is not None else None,
        verdicts=counts,
        hedge_wins=summary.get("hedge_wins"),
        retries_spent=summary.get("retries_spent"),
        rollups={
            "serve_qps": summary.get("serve_qps"),
            "serve_p99_ms": p99,
            "serve_shed_pct": shed_pct,
        },
    )


DRAIN_BUDGET_S = 6.0       # notice -> emergency ckpt + DRAINED_EXIT bound
STALL_EJECT_BUDGET_S = 8.0  # wedge injection -> watchdog ejection bound


def _published_stage_count(rig: Rig) -> int:
    try:
        data = telemetry.collect(rig.client, rig.job_id)
    except Exception:  # noqa: BLE001 — store may be mid-churn
        return 0
    return sum(
        1 for evs in data.get("events", {}).values() if "published" in evs
    )


def preempt_drain(rig: Rig) -> ScenarioOutcome:
    """A pod receives an advance preemption notice (SIGTERM — a spot-VM
    reclaim / k8s eviction) mid-training. Its workers must take an
    emergency checkpoint inside the drain budget and exit DRAINED; the
    survivor must restage PROACTIVELY — excluded-by-notice, not by lease
    expiry, with no failure-grace hold — and resume from the emergency
    checkpoint, losing at most the one in-flight step."""
    total, ckpt_every = 24, 4
    # ttl deliberately HIGH: any reliance on lease expiry (the reactive
    # path this scenario outlaws) would blow the proactive-drain bound
    harness = rig.harness(
        None, nodes_range="1:2", ttl=5.0, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
        extra={
            "EDL_HEARTBEAT_EVERY": "0.05",
            "EDL_DRAIN_BUDGET": str(DRAIN_BUDGET_S),
        },
    )
    import signal as _signal

    drained_rc = None
    drain_exit_s = None
    cursor_at_notice = -1
    try:
        # pod A alone first: it deterministically wins rank slot 0 (and
        # with it the checkpoint-writing rank and the leadership)
        harness.start_pod()
        assert rig.wait_cursor(2, timeout=90.0), (
            "first pod never started stepping (cursor %d)" % rig.cursor()
        )
        harness.start_pod()  # pod B joins; the job restages to world 2
        deadline = time.time() + 60
        while time.time() < deadline and _published_stage_count(rig) < 2:
            time.sleep(0.2)
        assert _published_stage_count(rig) >= 2, "world-2 stage never published"
        floor = rig.cursor() + 2
        assert rig.wait_cursor(floor, timeout=60.0), (
            "world-2 stage never stepped (cursor %d)" % rig.cursor()
        )
        # the notice: SIGTERM pod A (rank 0, the leader, the ckpt writer)
        cursor_at_notice = rig.cursor()
        victim = harness.pods[0]
        t0 = time.monotonic()
        notice_ts = time.time()
        victim.send_signal(_signal.SIGTERM)
        drained_rc = victim.wait()
        drain_exit_s = time.monotonic() - t0
        harness.pods.remove(victim)
        # pod B: sees preempt/A, leads (draining pods don't), republishes
        # world-1 WITHOUT waiting for A's lease, restores the emergency
        # checkpoint, finishes the job
        done = harness.run_schedule([], interval=1.0, timeout=150.0)
        ev = rig.evidence()
        alerts = rig.alerts()
    finally:
        harness.shutdown()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        inv.drained_before_deadline(ev, DRAIN_BUDGET_S),
        inv.proactive_drain(ev, 2.5),
        inv.lost_work_bounded(ev, cursor_at_notice),
        inv.drained_exit_clean(drained_rc, drain_exit_s, DRAIN_BUDGET_S + 3.0),
        inv.downtime_bounded(ev, DOWNTIME_BUDGET_S),
        inv.multiple_stages(ev, at_least=3),
        inv.goodput_accounted(rig.flight_events()),
        # the drain-triggered restage must stitch into one cross-process
        # critical path that agrees with the goodput restage lane
        inv.critical_path_traced(rig.trace_spans(), rig.flight_events()),
        # the monitor plane must notice the drain: restart-detected /
        # dead-endpoint fire structurally on the drained pod's exit and
        # the survivor's respawn; goodput-degraded joins when the
        # (proactively shortened) gap outlasts the paced rate window
        inv.alert_fired_any(
            alerts,
            ["goodput-degraded", "restart-detected", "dead-endpoint"],
            notice_ts, ALERT_LATENCY_BUDGET_S,
        ),
        # the survivor resumed from the EMERGENCY checkpoint — the
        # continuity sentinel proves it resumed the same training run
        # (fingerprint verified, loss continuous), not a silent restart
        inv.numerics_continuous(rig.flight_events()),
    ]
    return _outcome(
        "preempt-drain", rig.seed, results,
        harness_completed=done, cursor_at_notice=cursor_at_notice,
        drained_rc=drained_rc, drain_exit_s=round(drain_exit_s or -1, 2),
        alerts_fired=sorted(alerts),
    )


def ckpt_peer_loss(rig: Rig) -> ScenarioOutcome:
    """The checkpoint-writing pod DIES (SIGKILL) and its durable
    checkpoint tier is DELETED in the same instant — the
    one-slow-or-dead-filesystem failure the peer-replication plane
    exists to survive. The job runs with a pod-local checkpoint tier
    (``EDL_CKPT_LOCAL_BASE``) and K=1 ring-successor replication: every
    save lands locally, is pushed to the surviving pod's replica holder,
    and mirrors to the durable dir in the background. After the fault,
    the survivor and the replacement pod must restore from PEER REPLICAS
    with zero durable-tier reads (tier-labeled restore metrics + flight
    records), lose no more work than the last replicated step, and the
    restore hop must be visible as a ``ckpt_restore`` segment on the
    edl-trace restage critical path."""
    import shutil

    from edl_tpu_torch.checkpoint import replicate as ckpt_replicate
    from edl_tpu_torch.cluster.contract import RANK_SERVICE

    total, ckpt_every = 24, 3
    local_base = os.path.join(rig.workdir, "ckpt-local")
    harness = rig.harness(
        None, nodes_range="1:2", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
        extra={
            "EDL_CKPT_LOCAL_BASE": local_base,
            "EDL_CKPT_REPLICAS": "1",
        },
    )
    replicated_step = None
    kill_ts = 0.0
    try:
        # pod A alone first: it deterministically wins rank slot 0 (the
        # checkpoint-writing rank and the leadership)
        harness.start_pod()
        assert rig.wait_cursor(2, timeout=90.0), (
            "first pod never started stepping (cursor %d)" % rig.cursor()
        )
        harness.start_pod()  # pod B joins; its launcher holds A's replicas
        deadline = time.time() + 60
        while time.time() < deadline and _published_stage_count(rig) < 2:
            time.sleep(0.2)
        assert _published_stage_count(rig) >= 2, "world-2 stage never published"
        # wait until a world-2 checkpoint is saved AND fully replicated
        # to the peer holder (the manifest is the proof)
        deadline = time.time() + 90
        while time.time() < deadline:
            newest = ckpt_replicate.newest_replicated_step(
                rig.client, rig.job_id
            )
            if newest is not None and newest >= 2 * ckpt_every:
                replicated_step = newest
                break
            time.sleep(0.2)
        assert replicated_step is not None, (
            "no complete peer replica of a world-2 checkpoint within 90s"
        )
        # the fault: SIGKILL pod A (saver/leader), wipe its machine-local
        # state, AND delete the durable tier — recovery may read peers only
        slot0 = rig.client.get("/%s/%s/0" % (rig.job_id, RANK_SERVICE))
        victim_pod = slot0.decode() if slot0 else ""
        kill_ts = time.time()
        harness.kill_pod(harness.pods[0])
        shutil.rmtree(rig.ckpt_dir, ignore_errors=True)
        if victim_pod:
            shutil.rmtree(
                os.path.join(local_base, victim_pod), ignore_errors=True
            )
            shutil.rmtree(
                os.path.join(local_base, victim_pod + ".replicas"),
                ignore_errors=True,
            )
        harness.start_pod()  # the replacement: empty local tier, no durable
        done = harness.run_schedule([], interval=1.0, timeout=150.0)
        ev = rig.evidence()
    finally:
        harness.shutdown()
    flights = rig.flight_events()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        # lost work bounded by the LAST REPLICATED step: the post-fault
        # restore must land exactly there (slack 0 — the replica IS the
        # recovery point, unlike a drain's one in-flight step)
        inv.lost_work_bounded(ev, replicated_step or 0, slack_steps=0),
        inv.resumed_past_prefault_step(ev, replicated_step),
        inv.peer_tier_restored(ev, flights, kill_ts),
        inv.restore_segment_traced(rig.trace_spans()),
        inv.downtime_bounded(ev, DOWNTIME_BUDGET_S),
        inv.multiple_stages(ev, at_least=3),
        inv.goodput_accounted(flights),
        inv.critical_path_traced(rig.trace_spans(), flights),
    ]
    return _outcome(
        "ckpt-peer-loss", rig.seed, results,
        harness_completed=done, replicated_step=replicated_step,
        victim=victim_pod[:8] if victim_pod else "?",
    )


def straggler_stall(rig: Rig) -> ScenarioOutcome:
    """A worker wedges inside a 'collective' (a 120 s chaos delay at one
    rank's step 5 — far past any step time). Without the watchdog this
    hangs the job forever without tripping ANY failure path: the process
    is alive, its lease renews, nothing exits. The launcher-side watchdog
    must spot the silent heartbeat (behind its peer, quiet past the
    peer-median deadline), eject the wedge via kill + drain, and the
    restaged generation must resume from the checkpoint and finish."""
    total, ckpt_every = 40, 4
    spec = {
        "seed": rig.seed,
        "rules": [
            # min_nodes=2 (below) pins rank 1 to start at step 0, so the
            # wedge fires exactly once: after the ejection the restage
            # resumes from a checkpoint far past step 5
            {"point": "train.step", "proc": "worker", "action": "delay",
             "delay_s": 120.0, "match": {"rank": "1", "step": "5"}},
        ],
    }
    harness = rig.harness(
        spec, nodes_range="2:2", ttl=1.5, total=total,
        ckpt_every=ckpt_every, step_time=0.15,
        extra={
            "EDL_HEARTBEAT_EVERY": "0.05",
            "EDL_STALL_FLOOR": "2.0",
        },
    )
    try:
        done = harness.run_schedule([2], interval=3.0, timeout=150.0)
        ev = rig.evidence()
    finally:
        harness.shutdown()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        inv.fault_injected(ev, "train.step", "delay"),
        inv.straggler_ejected_within(ev, STALL_EJECT_BUDGET_S),
        inv.metric_advanced(ev, "edl_launch_straggler_ejections_total"),
        inv.multiple_stages(ev, at_least=2),
    ]
    return _outcome("straggler-stall", rig.seed, results, harness_completed=done)


def monitor_clean(rig: Rig) -> ScenarioOutcome:
    """NO fault at all — the monitor plane's zero-false-positive
    control. A clean single-pod run, through completion AND a
    post-completion quiet window (a finished job going silent must read
    as done, not degraded — the monitor suppresses on the COMPLETE
    status key), must publish not a single alert."""
    total, ckpt_every = 20, 5
    harness = rig.harness(
        None, nodes_range="1:1", ttl=2.0, total=total,
        ckpt_every=ckpt_every, step_time=0.1,
    )
    try:
        done = harness.run_schedule([1], interval=0.5, timeout=120.0)
        # the teeth: keep the monitor evaluating PAST completion — the
        # job going quiet here is exactly the false positive this
        # scenario outlaws
        time.sleep(1.5)
        alerts = rig.alerts()
        ev = rig.evidence()
    finally:
        harness.shutdown()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.single_stage(ev),
        inv.zero_stragglers(ev),
        inv.no_false_alerts(alerts),
    ]
    return _outcome(
        "monitor-clean", rig.seed, results,
        harness_completed=done, monitor_health=rig.monitor.health(),
    )


def grad_corrupt(rig: Rig) -> ScenarioOutcome:
    """Silent numerics corruption — the red drill for the numerics
    plane. One rank's gradient bytes are flipped mid-training (a DMA
    bit-flip / faulty host, the failure SDC postmortems describe): the
    training loop itself keeps stepping happily, so only the fused
    numerics probe can see it. The corrupted update blows the params
    out of float32 range, the next loss overflows to inf, and the plane
    must turn that into evidence end-to-end: a ``nonfinite`` flight
    record, the ``edl_train_nonfinite_total`` counter jump, and a
    ``nan-detected`` (or ``loss-spike``) alert inside the latency
    budget."""
    total, ckpt_every = 40, 5
    spec = {
        "seed": rig.seed,
        "rules": [
            # the 17th gradient rank 0 computes: deep enough into
            # training that the loss-spike rule's z-score history and
            # the nan-detected rate window are both primed with clean
            # samples before the poison lands
            {"point": "train.grad.corrupt", "proc": "worker",
             "action": "corrupt", "match": {"rank": "0"}, "after": 16,
             "times": 1},
        ],
    }
    # publish every 2 steps: the drill audits detection LATENCY, so the
    # probe cadence (not the monitor's) must not dominate the budget
    harness = rig.harness(
        spec, nodes_range="1:2", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.25,
        extra={"EDL_NUMERICS_EVERY": "2"},
    )
    try:
        done = harness.run_schedule([2], interval=3.0, timeout=180.0)
    finally:
        harness.shutdown()
    ev = rig.evidence()
    alerts = rig.alerts()
    corrupts = [
        e for e in ev.chaos_log
        if e.get("point") == "train.grad.corrupt"
        and e.get("action") == "corrupt"
    ]
    corrupt_ts = min(
        (float(e.get("ts", 0.0)) for e in corrupts), default=0.0
    )
    results = [
        # the job must FINISH — corruption detection is observability,
        # not a crash: the run completes and the evidence convicts it
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.fault_injected(ev, "train.grad.corrupt", "corrupt"),
        # the probe's own black-box record of the blowup (survives any
        # later process death, feeds edl-timeline's overlay)
        inv.nonfinite_recorded(rig.flight_events()),
        # the tripwires: nan-detected on the counter jump is the
        # structural detector; loss-spike's z-score joins when the inf
        # loss lands in a primed history window
        inv.alert_fired_any(
            alerts, ["nan-detected", "loss-spike"],
            corrupt_ts, ALERT_LATENCY_BUDGET_S,
        ),
    ]
    return _outcome(
        "grad-corrupt", rig.seed, results,
        harness_completed=done, corrupt_ts=corrupt_ts,
        alerts_fired=sorted(alerts),
    )


def hbm_oom(rig: Rig) -> ScenarioOutcome:
    """Device OOM mid-training — the red drill for the memory plane.
    Rank 0's step dispatch hits RESOURCE_EXHAUSTED (the ``train.mem.oom``
    drop fault, re-raised at the fire site as the allocator error); the
    oom_guard must capture a crash-safe forensics bundle (census, active
    plan, watermark) BEFORE the error kills the worker, the monitor must
    page ``oom-detected`` (or ``hbm-pressure``) inside the alert budget,
    and the job must complete after the launcher restages the gang off
    the emergency checkpoint — an OOM costs a restage, never the run.

    Pacing: the fault lands at step 10 and the restage takes ~7s (grace
    + the failed pod's leave-hold + drain), so ``total`` must keep the
    shard-committing rank busy past the restage; the respawned stage
    resumes from the last periodic checkpoint and the ledger closes.
    Rank 1 is the victim (like worker-kill): after the shrink to
    world=1 no process matches, so the drill OOMs exactly once."""
    total, ckpt_every = 40, 5
    spec = {
        "seed": rig.seed,
        "rules": [
            # deep enough into training that the plan is harvested and
            # the census/monitor windows are primed with clean samples
            {"point": "train.mem.oom", "proc": "worker",
             "action": "drop", "match": {"rank": "1"}, "after": 10,
             "times": 1},
        ],
    }
    harness = rig.harness(
        spec, nodes_range="1:2", ttl=0.8, total=total,
        ckpt_every=ckpt_every, step_time=0.25,
        # census every 4 steps: the live-buffer evidence (and the CPU
        # rig's watermark stand-in) accrues within the drill's length;
        # the grace holds the dying worker's /metrics endpoint up for a
        # few 0.4s monitor sweeps so the terminal oom counter is scraped
        extra={"EDL_MEM_CENSUS_EVERY": "4", "EDL_CHAOS_OOM_GRACE": "1.5"},
    )
    try:
        done = harness.run_schedule([2], interval=3.0, timeout=180.0)
    finally:
        harness.shutdown()
    ev = rig.evidence()
    alerts = rig.alerts()
    flight = rig.flight_events()
    ooms = [
        e for e in ev.chaos_log
        if e.get("point") == "train.mem.oom" and e.get("action") == "drop"
    ]
    fault_ts = min((float(e.get("ts", 0.0)) for e in ooms), default=0.0)
    results = [
        # the contract under test: an OOM costs a restage, never the run
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.fault_injected(ev, "train.mem.oom", "drop"),
        inv.oom_forensics_captured(flight),
        inv.alert_fired_any(
            alerts, ["oom-detected", "hbm-pressure"],
            fault_ts, ALERT_LATENCY_BUDGET_S,
        ),
        # the OOM'd worker died: the job went through >= 2 stages
        inv.multiple_stages(ev),
    ]
    # archive rollups: the run's high-water mark and plan-vs-actual
    # score, from the flight evidence (on the CPU rig the census byte
    # total IS the residency signal — see obs/memory._sample_stats)
    plan_bytes = max(
        (float(e.get("total_bytes", 0.0)) for e in flight
         if e.get("event") == "mem_plan"), default=0.0,
    )
    peak_bytes = max(
        [float(e.get("peak_bytes", 0.0)) for e in flight
         if e.get("event") == "oom"]
        + [float(e.get("live_bytes", 0.0)) for e in flight
           if e.get("event") == "mem_census"]
        + [0.0],
    )
    accuracy = (
        100.0 * min(plan_bytes, peak_bytes) / max(plan_bytes, peak_bytes)
        if plan_bytes > 0 and peak_bytes > 0 else 0.0
    )
    return _outcome(
        "hbm-oom", rig.seed, results,
        harness_completed=done, fault_ts=fault_ts,
        alerts_fired=sorted(alerts),
        rollups={
            "hbm_peak_gb": round(peak_bytes / 1e9, 9),
            "hbm_plan_accuracy_pct": round(accuracy, 2),
        },
    )


PROMOTION_BUDGET_S = 15.0  # primary kill -> standby serving (CPU-rig bound)


def store_failover(rig: Rig) -> ScenarioOutcome:
    """The PRIMARY STORE dies mid-job (crash, not clean stop). The warm
    standby must promote within budget with an epoch bump; every write
    the old primary acked must survive with its revision; the job's
    clients must fail over and finish training with shards exactly-once;
    a watch held across the failover must see every event exactly once;
    and the resurrected old primary must be fenced before it can serve."""
    from edl_tpu_torch.chaos.consistency import ConsistencyChurn
    from edl_tpu_torch.store.server import StoreServer
    from edl_tpu_torch.utils.exceptions import EdlStoreError

    total, ckpt_every = 24, 3
    # ttl comfortably above the failover window so the control-plane
    # outage is INVISIBLE to the job — no drain, no restage, just a
    # paused heartbeat; the shard ledger would catch any double-commit
    # if the job did restage
    harness = rig.harness(
        None, nodes_range="1:1", ttl=2.5, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
    )
    shard_prefix = chaos.chaos_prefix(rig.job_id) + "progress/shard/"
    acked_key = chaos.chaos_prefix(rig.job_id) + "failover/acked"
    seen: List = []
    watch = rig.client.watch(shard_prefix, lambda evs: seen.extend(evs))
    # standby-mode churn: reads prefer the standby across the failover,
    # and the history checker must still find the session linearizable
    churn = ConsistencyChurn(
        rig.store_endpoints, rig.flight_dir, read_mode="standby"
    )
    promote_s = None
    fenced_epoch = None
    probe_refused = False
    old_primary = None
    try:
        harness.start_pod()
        assert rig.wait_cursor(2 * ckpt_every, timeout=90.0), (
            "trainee never reached step %d (cursor %d)"
            % (2 * ckpt_every, rig.cursor())
        )
        acked_rev = rig.client.put(acked_key, b"must-survive")
        t0 = time.monotonic()
        rig.store.kill()  # machine death: no clean-stop snapshot
        deadline = time.monotonic() + PROMOTION_BUDGET_S
        while (
            time.monotonic() < deadline and rig.standby.role != "primary"
        ):
            time.sleep(0.05)
        if rig.standby.role == "primary":
            promote_s = time.monotonic() - t0
        # resurrect the dead primary on its own stale state, at the SAME
        # endpoint every client lists first: the promoted primary's fence
        # campaign must shut it out
        old_primary = StoreServer(
            host="127.0.0.1", port=rig.primary_port,
            data_dir=rig.primary_dir,
        ).start()
        deadline = time.monotonic() + PROMOTION_BUDGET_S
        while (
            time.monotonic() < deadline and old_primary._fenced_by is None
        ):
            time.sleep(0.05)
        fenced_epoch = old_primary._fenced_by
        probe = StoreClient(old_primary.endpoint, timeout=3.0, reconnect=False)
        try:
            probe.request("put", k="/fence/probe", v=b"intruder", l=0)
        except EdlStoreError:
            probe_refused = True
        finally:
            probe.close()
        done = harness.run_schedule([], interval=1.0, timeout=150.0)
    finally:
        harness.shutdown()
        watch.cancel()
        if old_primary is not None:
            old_primary.stop()
    consistency_results = _consistency_results(rig, churn)
    acked = rig.client.retrying("get", k=acked_key)
    ev = rig.evidence()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        inv.promoted_within(promote_s, PROMOTION_BUDGET_S),
        inv.acked_write_survived(
            acked.get("v"), b"must-survive", acked.get("mr", 0), acked_rev
        ),
        inv.stale_primary_fenced(
            fenced_epoch, probe_refused, rig.standby._state.epoch
        ),
        inv.watch_resumed_exactly_once(seen, shard_prefix, total),
        *consistency_results,
    ]
    return _outcome(
        "store-failover", rig.seed, results,
        harness_completed=done, promote_s=promote_s,
        promoted_epoch=rig.standby._state.epoch,
    )


store_failover.ha = True  # run_scenario builds the primary+standby rig


def store_shard_failover(rig: Rig) -> ScenarioOutcome:
    """EVERY shard primary of a 2-shard control plane dies mid-job
    (crash, not clean stop). Each shard's warm standby must promote
    independently within budget with its own epoch bump; an acked write
    ON EACH SHARD must survive with its original revision — semi-sync
    holds the ack until the standby applied+journaled, so this is a
    STRICT zero-loss invariant, not best-effort; and the job must
    finish training through the all-shards failover with shards
    exactly-once."""
    from edl_tpu_torch.chaos.consistency import ConsistencyChurn

    total, ckpt_every = 24, 3
    # ttl comfortably above the failover window, as in store-failover:
    # the control-plane outage must be invisible to the job
    harness = rig.harness(
        None, nodes_range="1:1", ttl=2.5, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
    )
    acked: Dict[str, tuple] = {}  # shard name -> (key, acked rev)
    promotes: List[Optional[float]] = []
    # one standby-mode churn per shard, each pinned to its own pair and
    # probe prefix — the checker judges every /cp/ key independently
    churns = [
        ConsistencyChurn(
            "%s,%s" % (p.endpoint, s.endpoint), rig.flight_dir,
            prefix="/cp/s%d/" % i, read_mode="standby",
        )
        for i, (p, s) in enumerate(rig.shard_servers)
    ]
    try:
        harness.start_pod()
        assert rig.wait_cursor(2 * ckpt_every, timeout=90.0), (
            "trainee never reached step %d (cursor %d)"
            % (2 * ckpt_every, rig.cursor())
        )
        # one must-survive write PER SHARD: walk routing tokens until
        # the ring has handed us a key on every shard
        i = 0
        while len(acked) < len(rig.shard_servers) and i < 128:
            key = "/%s/failover%d/acked" % (rig.job_id, i)
            shard = rig.client.shard_of(key)
            if shard not in acked:
                rev = rig.client.put(key, b"must-survive")
                acked[shard] = (key, rev)
            i += 1
        assert len(acked) == len(rig.shard_servers), (
            "ring never covered every shard: %s" % sorted(acked)
        )
        t0 = time.monotonic()
        for primary, _standby in rig.shard_servers:
            primary.kill()  # machine death: no clean-stop snapshot
        deadline = time.monotonic() + PROMOTION_BUDGET_S
        for _primary, standby in rig.shard_servers:
            while (
                time.monotonic() < deadline and standby.role != "primary"
            ):
                time.sleep(0.05)
            promotes.append(
                time.monotonic() - t0
                if standby.role == "primary" else None
            )
        done = harness.run_schedule([], interval=1.0, timeout=150.0)
    finally:
        harness.shutdown()
    consistency_results = _consistency_results(rig, *churns)
    ev = rig.evidence()
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        *consistency_results,
    ]
    for promote_s in promotes:
        results.append(inv.promoted_within(promote_s, PROMOTION_BUDGET_S))
    for shard, (key, rev) in sorted(acked.items()):
        got = rig.client.retrying("get", k=key)
        results.append(inv.acked_write_survived(
            got.get("v"), b"must-survive", got.get("mr", 0), rev
        ))
    return _outcome(
        "store-shard-failover", rig.seed, results,
        harness_completed=done, promotes_s=promotes,
        shards=sorted(acked),
        epochs=[s._state.epoch for _p, s in rig.shard_servers],
    )


store_shard_failover.ha = True
store_shard_failover.shards = 2  # run_scenario builds a 2-shard rig


def store_consistency_red(rig: Rig) -> ScenarioOutcome:
    """RED DRILL: prove the consistency checker has teeth. With MVCC
    released-revision reads DISABLED (``EDL_STORE_MVCC=0``, set by
    run_scenario before the rig boots), a read during an open semi-sync
    window observes an applied-but-unacked write; when the primary then
    dies before the standby ack, failover rolls the keyspace back and
    the same session later reads the OLDER value — a non-monotonic
    session read the checker MUST flag. The scenario is red-on-green:
    it passes only when the anomaly is reproduced, so a checker that
    goes blind fails the drill."""
    import edl_tpu_torch.chaos.consistency as cons
    from edl_tpu_torch.utils.exceptions import EdlStoreError

    key = "/cp/x"
    # the session under test: taped, endpoints spanning the failover
    sess = StoreClient(
        rig.store_endpoints, timeout=5.0, op_tape_dir=rig.flight_dir
    )
    promote_s = None
    writer = None
    try:
        rev_a = sess.put(key, b"A")  # acked: applied+journaled on standby
        deadline = time.monotonic() + 10.0
        while (
            time.monotonic() < deadline
            and rig.standby._state.revision < rev_a
        ):
            time.sleep(0.02)
        # hold the semi-sync window open: acks wait far longer than the
        # drill runs, and the standby stops applying frames entirely
        rig.store._repl_sync_timeout = 30.0
        rig.standby._repl_apply = lambda frame: None  # wedge
        # indeterminate write: B applies on the primary but the ack
        # never comes back before the client gives up
        writer = StoreClient(
            rig.store.endpoint, timeout=0.6, reconnect=False,
            op_tape_dir=rig.flight_dir,
        )
        try:
            writer.put(key, b"B")
        except EdlStoreError:
            pass  # taped as indeterminate — exactly the point
        # the dirty read: with MVCC off the server answers from applied
        # state, so the session observes B inside the open window
        dirty = sess.get(key)
        t0 = time.monotonic()
        rig.store.kill()  # B dies with the primary
        deadline = time.monotonic() + PROMOTION_BUDGET_S
        while (
            time.monotonic() < deadline and rig.standby.role != "primary"
        ):
            time.sleep(0.05)
        if rig.standby.role == "primary":
            promote_s = time.monotonic() - t0
        # post-failover traffic, then the session re-reads the key: the
        # promoted standby never had B, so the session's view regresses
        for i in range(3):
            sess.retrying("put", k="/cp/fill%d" % i, v=b"f")
        final = sess.retrying("get", k=key)
    finally:
        if writer is not None:
            writer.close()
        sess.close()
    report = cons.check_history(rig.flight_events())
    cons.record_verdict(report, rig.flight_dir)
    results = [
        inv.promoted_within(promote_s, PROMOTION_BUDGET_S),
        inv.consistency_anomaly_reproduced(report),
    ]
    return _outcome(
        "store-consistency-red", rig.seed, results,
        dirty_value=(dirty or b"").decode("utf-8", "replace"),
        final_value=(final.get("v") or b"").decode("utf-8", "replace"),
        violations=report.violations[:8],
        promote_s=promote_s,
    )


store_consistency_red.ha = True
# the whole point: boot the pair WITHOUT released-revision reads
store_consistency_red.env = {"EDL_STORE_MVCC": "0"}


def corrupt_checkpoint_version(ckpt_dir: str, step: int) -> None:
    """Tear one checkpoint version on disk: every file under it is
    overwritten with garbage (the torn-write simulation shared by the
    corrupt-ckpt scenario and tests/test_checkpoint.py)."""
    root = os.path.join(ckpt_dir, str(step))
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            path = os.path.join(dirpath, name)
            try:
                size = os.path.getsize(path)
                with open(path, "wb") as f:
                    f.write(b"\xde\xad" * max(1, size // 2))
            except OSError:
                pass
    logger.warning("corrupted checkpoint version %d under %s", step, root)


def corrupt_latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """Tear the newest finalized version; returns its step (None if no
    versions exist yet)."""
    try:
        steps = sorted(
            int(name) for name in os.listdir(ckpt_dir) if name.isdigit()
        )
    except OSError:
        return None
    if not steps:
        return None
    corrupt_checkpoint_version(ckpt_dir, steps[-1])
    return steps[-1]


# -- scale plane drills -------------------------------------------------------

SCALE_DECISION_BUDGET_S = 30.0   # scale_decision fsync -> scale_reconcile
AUTOSCALE_LOSS_BOUND_PCT = 65.0  # realized vs oracle modeled goodput


def _scale_goodput_trace(
    events: list,
    phases: list,
    end_ts: float,
    params,
    min_world: int,
    max_world: int,
) -> tuple:
    """``(achieved, oracle)`` modeled-goodput integrals over one run.

    The realized schedule is read off the launcher's flight records — a
    ``publish`` sets the world, a ``drain`` zeroes it until the next
    publish (the restage gap trains nothing). The oracle replays the
    same signal trace (``phases`` = [(ts, gns, available pods)]) with
    zero decision latency and free restages: at every instant it runs
    the model argmax for the gns then in force. Both integrals use the
    SAME goodput model, so their ratio isolates scheduler quality."""
    from edl_tpu_torch.scale import decide as scale_decide

    points = []
    for e in sorted(events, key=lambda ev: float(ev.get("ts", 0.0))):
        if e.get("event") == "publish":
            points.append((float(e.get("ts", 0.0)), int(e.get("pods", 0))))
        elif e.get("event") == "drain":
            points.append((float(e.get("ts", 0.0)), 0))
    if not points or not phases or end_ts <= points[0][0]:
        return 0.0, 0.0
    t0 = points[0][0]
    cuts = sorted(
        {t0, end_ts}
        | {ts for ts, _w in points if t0 < ts < end_ts}
        | {ts for ts, _g, _a in phases if t0 < ts < end_ts}
    )
    achieved = oracle = 0.0
    for a, b in zip(cuts, cuts[1:]):
        world = 0
        for ts, w in points:
            if ts <= a:
                world = w
        gns, avail = phases[0][1], phases[0][2]
        for ts, g, av in phases:
            if ts <= a:
                gns, avail = g, av
        stats = scale_decide.JobStats(world=max(world, 1), gns=gns)
        achieved += (b - a) * scale_decide.model_goodput(world, params, stats)
        best = scale_decide.best_world(
            min_world, min(max_world, avail), params, stats
        )
        oracle += (b - a) * scale_decide.model_goodput(best, params, stats)
    return achieved, oracle


def autoscale_churn(rig: Rig) -> ScenarioOutcome:
    """The goodput-driven autoscaler against a seeded signal trace.

    A live Scaler daemon watches the job while the scenario swings the
    two inputs the model ranks worlds by — pool capacity and the
    gradient-noise-scale — through a grow (capacity appears, the held
    pod is admitted via an autoscale-cause restage), a shrink (noise
    collapses, the model says 1 pod, the leader publishes autoscale
    preempt notices and the victims DRAIN out), a regrow, and an
    external spot reclaim (SIGTERM — attributed to membership, NOT
    autoscale). Gates: the job completes exactly-once, every decision
    the launcher reconciled closed within the latency budget, and the
    realized schedule's modeled goodput stays within the loss bound of
    the offline oracle replaying the same trace."""
    import random as _random
    import signal as _signal

    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.scale import decide as scale_decide
    from edl_tpu_torch.scale import scaler as scale_scaler

    total, ckpt_every = 36, 4
    rnd = _random.Random(rig.seed)
    # rich noise scale: big batches stay efficient, optimum = capacity;
    # poor: efficiency collapses, optimum = 1 pod (seeded jitter keeps
    # both regimes decisively on their side of the hysteresis margin)
    gns_rich = 24.0 + 16.0 * rnd.random()
    gns_poor = 0.02 + 0.03 * rnd.random()
    params = scale_decide.ScaleParams(
        alpha=0.05, gns=gns_rich, hysteresis=0.02, cooldown_s=3.0
    )
    state = {"cap": 2, "gns": gns_rich}
    phases: list = []  # (ts, gns, available pods) — the oracle's trace

    def shift(cap=None, gns=None, avail=None):
        if cap is not None:
            state["cap"] = cap
        if gns is not None:
            state["gns"] = gns
        phases.append((
            time.time(), state["gns"],
            avail if avail is not None else state["cap"],
        ))

    # ttl HIGH: every world change must come from the scale/drain
    # planes (targets, preempt notices), never from lease expiry
    harness = rig.harness(
        None, nodes_range="1:3", ttl=5.0, total=total,
        ckpt_every=ckpt_every, step_time=0.2,
        extra={
            "EDL_HEARTBEAT_EVERY": "0.05",
            "EDL_DRAIN_BUDGET": str(DRAIN_BUDGET_S),
        },
    )
    scaler = scale_scaler.Scaler(
        rig.store_endpoints,
        [scale_scaler.JobSpec(rig.job_id, min_world=1, max_world=3)],
        interval=0.5,
        capacity=lambda: state["cap"],
        params=params,
        flight_dir=rig.flight_dir,
        trace_dir=rig.trace_dir,
        # pin the model inputs to the scenario's trace: world and
        # goodput stay REAL, the signals are the seeded schedule
        stats_override=lambda _job: {
            "gns": state["gns"], "per_pod_rate": 1.0, "goodput_ratio": 1.0,
        },
        scrape_timeout=0.5,
    )
    reg = Registry(rig.client, rig.job_id)

    def target_pods():
        try:
            meta = reg.get_server("scale", "target")
            if meta is None:
                return None
            return int(json.loads(meta.value.decode()).get("pods", -1))
        except Exception:  # noqa: BLE001 — store mid-churn
            return None

    def publishes(world=None):
        return [
            e for e in rig.flight_events()
            if e.get("event") == "publish"
            and (world is None or int(e.get("pods", 0)) == world)
        ]

    def wait_for(cond, timeout, what):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if cond():
                return
            time.sleep(0.2)
        raise AssertionError("timed out waiting for %s" % what)

    def reap():
        for proc in list(harness.pods):
            if proc.poll() is not None:
                harness.pods.remove(proc)

    try:
        # bootstrap at 2 pods, scaler quiet (capacity 2, already there)
        harness.start_pod()
        harness.start_pod()
        assert rig.wait_cursor(2, timeout=90.0), (
            "world-2 never stepped (cursor %d)" % rig.cursor()
        )
        shift()  # open the oracle trace: capacity 2, rich gns
        scaler.start()
        # GROW: a third pod's worth of capacity appears; the decision
        # must land before the pod does — arrival admits the held pod
        shift(cap=3)
        wait_for(lambda: target_pods() == 3, 30.0, "grow target")
        harness.start_pod()
        wait_for(lambda: publishes(3), 90.0, "world-3 stage")
        floor = rig.cursor() + 2
        assert rig.wait_cursor(floor, timeout=60.0), "world-3 never stepped"
        # SHRINK: gradient noise collapses -> the model says extra pods
        # buy wasted epochs -> autoscale preempt notices drain 2 pods
        shift(gns=gns_poor)
        wait_for(lambda: target_pods() == 1, 30.0, "shrink target")
        wait_for(lambda: publishes(1), 90.0, "world-1 stage")
        deadline = time.time() + 30
        while time.time() < deadline and len(harness.pods) > 1:
            reap()
            time.sleep(0.2)
        assert len(harness.pods) == 1, (
            "autoscale victims did not exit (%d pods left)"
            % len(harness.pods)
        )
        floor = rig.cursor() + 2
        assert rig.wait_cursor(floor, timeout=60.0), "world-1 never stepped"
        # REGROW: noise recovers; two replacement pods arrive
        n3 = len(publishes(3))
        shift(gns=gns_rich)
        wait_for(lambda: target_pods() == 3, 30.0, "regrow target")
        harness.start_pod()
        harness.start_pod()
        wait_for(lambda: len(publishes(3)) > n3, 90.0, "world-3 restage")
        # SPOT RECLAIM: an EXTERNAL SIGTERM (not the scaler's doing) —
        # the pool genuinely shrank, so the trace shrinks with it
        reap()
        victim = harness.pods[-1]
        victim.send_signal(_signal.SIGTERM)
        victim.wait()
        harness.pods.remove(victim)
        shift(cap=2)
        done = harness.run_schedule([], interval=1.0, timeout=240.0)
        end_ts = time.time()
        ev = rig.evidence()
    finally:
        scaler.stop()
        harness.shutdown()
    events = rig.flight_events()
    achieved, oracle = _scale_goodput_trace(
        events, phases, end_ts, params, 1, 3
    )
    loss_pct = 100.0 * (1.0 - achieved / oracle) if oracle > 0 else 100.0
    latencies = inv.scale_reconcile_latencies(events)
    worst_latency = max(latencies.values()) if latencies else -1.0
    results = [
        inv.completed(ev, total),
        inv.shards_exactly_once(ev, total),
        inv.replay_bounded(ev, ckpt_every),
        inv.multiple_stages(ev, at_least=4),
        # the scaler's moves went through the drain plane, attributed:
        # the grow + shrink restages advance the autoscale-cause counter
        inv.metric_advanced(
            ev, "edl_launch_drains_total", at_least=2,
            label_substr="autoscale",
        ),
        inv.scale_decision_latency(events, SCALE_DECISION_BUDGET_S),
        inv.autoscale_goodput_bounded(
            achieved, oracle, AUTOSCALE_LOSS_BOUND_PCT
        ),
        inv.gang_atomic_worlds(events, 1),
        inv.goodput_accounted(events),
        inv.critical_path_traced(rig.trace_spans(), events),
        inv.numerics_continuous(events),
    ]
    return _outcome(
        "autoscale-churn", rig.seed, results,
        harness_completed=done,
        decisions_reconciled=len(latencies),
        gns_rich=round(gns_rich, 2), gns_poor=round(gns_poor, 3),
        achieved=round(achieved, 2), oracle=round(oracle, 2),
        rollups={
            "autoscale_goodput_loss_pct": round(loss_pct, 1),
            "decision_to_restage_s": round(worst_latency, 2),
        },
    )


def admission_order(a_events: list, b_events: list) -> tuple:
    """``(a_shrunk_ts, b_first_ts)`` of ``autoscale-multijob``: A's
    shrink is its first world-1 stage after its preemption notices (its
    bootstrap may also have been a world-1 stage), and B's admission is
    its first stage with pods — a held gang's leader publishes an EMPTY
    generation at the queued target 0, which orders nothing. (The JAX
    scenario takes A's first world-1 stage and B's first publish of any
    size, so a run passes or fails by which process started first.)
    None where there is no such stage."""
    preempted_ts = min(
        (float(e["ts"]) for e in a_events
         if e.get("event") == "scale_preempt"), default=float("inf"))
    a_shrunk_ts = min(
        (float(e["ts"]) for e in a_events
         if e.get("event") == "publish" and int(e.get("pods", 0)) == 1
         and float(e["ts"]) >= preempted_ts), default=None)
    b_first_ts = min(
        (float(e["ts"]) for e in b_events
         if e.get("event") == "publish" and int(e.get("pods", 0)) > 0),
        default=None)
    return a_shrunk_ts, b_first_ts


def autoscale_multijob(rig: Rig) -> ScenarioOutcome:
    """Two elastic jobs, ONE shared 3-pod pool, one arbiter.

    Job A (priority 0, min 1) runs at the full pool. Job B (priority
    10, min=max=2, short) is submitted mid-flight: the arbiter's
    admission preempts A down to 1 via autoscale preempt notices, and
    gang sequencing holds B's grow until A's freed pods are REAL — B's
    launchers hold their pods at want=0 (the queued target) and only
    publish once released, so B's first stage strictly follows A's
    shrink and neither job ever publishes below its min world. When B
    completes, its bid dissolves and A regrows onto the freed pool."""
    import signal as _signal  # noqa: F401 — parity with sibling drills

    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.harness.resize import ResizeHarness as _ResizeHarness
    from edl_tpu_torch.obs import events as obs_events
    from edl_tpu_torch.scale import decide as scale_decide
    from edl_tpu_torch.scale import scaler as scale_scaler

    total_a, ckpt_a = 120, 6
    total_b, ckpt_b = 8, 4
    job_b = rig.job_id + "-b"
    b_flight = os.path.join(rig.workdir, "b-flight")
    b_trace = os.path.join(rig.workdir, "b-traces")
    params = scale_decide.ScaleParams(
        alpha=0.05, gns=30.0, hysteresis=0.02, cooldown_s=2.0
    )
    harness_a = rig.harness(
        None, nodes_range="1:3", ttl=5.0, total=total_a,
        ckpt_every=ckpt_a, step_time=0.2,
        extra={
            "EDL_HEARTBEAT_EVERY": "0.05",
            "EDL_DRAIN_BUDGET": str(DRAIN_BUDGET_S),
        },
    )
    env_b = dict(rig.job_env)
    env_b.update({
        "EDL_CHAOS_LOG": os.path.join(rig.workdir, "chaos-b.log"),
        "EDL_CKPT_PATH": os.path.join(rig.workdir, "ckpt-b"),
        "EDL_FLIGHT_DIR": b_flight,
        "EDL_TRACE_DIR": b_trace,
        "EDL_CHAOS_TOTAL_STEPS": str(total_b),
        "EDL_CHAOS_CKPT_EVERY": str(ckpt_b),
    })
    harness_b = _ResizeHarness(
        rig.store_endpoints, job_b, TRAINEE,
        nodes_range="2:2",  # the gang floor, enforced structurally too
        ttl=5.0,
        log_dir=os.path.join(rig.workdir, "logs-b"),
        extra_env=env_b,
        device=rig.device,
    )
    scaler = scale_scaler.Scaler(
        rig.store_endpoints,
        [scale_scaler.JobSpec(rig.job_id, min_world=1, max_world=3,
                              priority=0)],
        interval=0.5,
        capacity=3,
        params=params,
        flight_dir=rig.flight_dir,
        trace_dir=rig.trace_dir,
        stats_override=lambda _job: {
            "gns": 30.0, "per_pod_rate": 1.0, "goodput_ratio": 1.0,
        },
        scrape_timeout=0.5,
    )

    def target_of(job_id):
        try:
            meta = Registry(rig.client, job_id).get_server("scale", "target")
            if meta is None:
                return None
            return int(json.loads(meta.value.decode()).get("pods", -1))
        except Exception:  # noqa: BLE001
            return None

    def job_status(job_id):
        try:
            return rig.client.get("/%s/job/status" % job_id)
        except Exception:  # noqa: BLE001
            return None

    def pubs(events, world=None):
        return [
            e for e in events
            if e.get("event") == "publish"
            and (world is None or int(e.get("pods", 0)) == world)
        ]

    def wait_for(cond, timeout, what):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if cond():
                return
            time.sleep(0.2)
        raise AssertionError("timed out waiting for %s" % what)

    def reap(harness):
        for proc in list(harness.pods):
            if proc.poll() is not None:
                harness.pods.remove(proc)

    regrew = False
    try:
        # job A owns the whole pool first
        for _ in range(3):
            harness_a.start_pod()
        assert rig.wait_cursor(2, timeout=120.0), (
            "job A never stepped (cursor %d)" % rig.cursor()
        )
        wait_for(lambda: pubs(rig.flight_events(), 3), 60.0, "A at world 3")
        scaler.start()
        # SUBMIT job B: the queued target (0 pods) lands before its
        # pods do — arrival is not admission
        scaler.add_job(scale_scaler.JobSpec(
            job_b, min_world=2, max_world=2, priority=10,
        ))
        harness_b.start_pod()
        harness_b.start_pod()
        # admission preempts A down to 1 (priority beats incumbency)...
        wait_for(lambda: target_of(rig.job_id) == 1, 30.0,
                 "A's preemption target")
        wait_for(lambda: pubs(rig.flight_events(), 1), 90.0,
                 "A's world-1 stage")
        # ...and only THEN is B's gang released onto the freed pods
        wait_for(lambda: target_of(job_b) == 2, 30.0, "B's release target")
        wait_for(lambda: pubs(obs_events.read_segments(b_flight), 2),
                 90.0, "B's world-2 stage")
        wait_for(lambda: job_status(job_b) == b"COMPLETE", 120.0,
                 "B completion")
        # B's bid dissolves -> A regrows onto the freed pool (unless A
        # already finished during the held window — seeds vary)
        deadline = time.time() + 45
        while time.time() < deadline:
            if job_status(rig.job_id) == b"COMPLETE":
                break
            if target_of(rig.job_id) == 3:
                regrew = True
                reap(harness_a)
                harness_a.start_pod()
                harness_a.start_pod()
                break
            time.sleep(0.3)
        done_a = harness_a.run_schedule([], interval=1.0, timeout=300.0)
        ev_a = rig.evidence()
        ev_b = inv.Evidence(
            progress=inv.read_progress(rig.client, job_b),
            telemetry=telemetry.collect(rig.client, job_b),
        )
    finally:
        scaler.stop()
        harness_b.shutdown()
        harness_a.shutdown()
    a_events = rig.flight_events()
    b_events = obs_events.read_segments(b_flight)
    merged = a_events + b_events
    latencies = inv.scale_reconcile_latencies(merged)
    worst_latency = max(latencies.values()) if latencies else -1.0
    preempts = [e for e in a_events if e.get("event") == "scale_preempt"]
    a_shrunk_ts, b_first_ts = admission_order(a_events, b_events)
    ordered = (
        a_shrunk_ts is not None
        and b_first_ts is not None
        and a_shrunk_ts <= b_first_ts
    )

    def tag(result, suffix):
        result.name += suffix
        return result

    results = [
        tag(inv.completed(ev_a, total_a), "[a]"),
        tag(inv.shards_exactly_once(ev_a, total_a), "[a]"),
        tag(inv.replay_bounded(ev_a, ckpt_a), "[a]"),
        tag(inv.completed(ev_b, total_b), "[b]"),
        tag(inv.shards_exactly_once(ev_b, total_b), "[b]"),
        inv.InvariantResult(
            "autoscale_preempted",
            len(preempts) >= 2,
            "%d scale_preempt notice(s) for job A (want >= 2)"
            % len(preempts),
        ),
        inv.metric_advanced(
            ev_a, "edl_launch_drains_total", at_least=1,
            label_substr="autoscale",
        ),
        inv.InvariantResult(
            "priority_admission_ordered",
            ordered,
            "A shrank at %s, B first published at %s"
            % (a_shrunk_ts, b_first_ts),
        ),
        tag(inv.gang_atomic_worlds(a_events, 1), "[a]"),
        tag(inv.gang_atomic_worlds(b_events, 2), "[b]"),
        inv.scale_decision_latency(merged, SCALE_DECISION_BUDGET_S),
        inv.goodput_accounted(a_events),
    ]
    return _outcome(
        "autoscale-multijob", rig.seed, results,
        harness_a_completed=done_a, regrew=regrew,
        decisions_reconciled=len(latencies),
        rollups={"decision_to_restage_s": round(worst_latency, 2)},
    )


SCENARIOS: Dict[str, Callable[[Rig], ScenarioOutcome]] = {
    "worker-kill": worker_kill,
    "store-blip": store_blip,
    "corrupt-ckpt": corrupt_checkpoint,
    "slow-rpc": slow_rpc,
    "teacher-failover": teacher_failover,
    "serve-slo-churn": serve_slo_churn,
    "store-failover": store_failover,
    "store-shard-failover": store_shard_failover,
    "store-consistency-red": store_consistency_red,
    "ckpt-peer-loss": ckpt_peer_loss,
    "preempt-drain": preempt_drain,
    "straggler-stall": straggler_stall,
    "monitor-clean": monitor_clean,
    "grad-corrupt": grad_corrupt,
    "hbm-oom": hbm_oom,
    "autoscale-churn": autoscale_churn,
    "autoscale-multijob": autoscale_multijob,
}


def run_scenario(
    name: str, seed: int, workdir: str, archive_to: Optional[str] = "auto",
    device: str = "cuda",
) -> ScenarioOutcome:
    """Run one named scenario in a fresh rig under ``workdir``, then
    archive the run (flight segments, traces, monitor series, chaos
    ledger, invariant verdicts) into the run archive and assert the
    ``run_archived`` invariant: every scenario run is a comparable,
    indexed artifact ``edl-report`` can trend, diff, and gate.

    ``archive_to``: an explicit root (the soak runner passes ONE root
    so every seed lands in the same index), the default ``"auto"``
    (``EDL_RUN_ARCHIVE``, else ``{workdir}/runs``), or None — the
    caller opted out of archiving entirely, which also skips the
    invariant (an observability opt-out must not fail a successful
    recovery).

    ``device``: where the trainee trains (``cuda`` or ``cpu``); it is
    also the archived run's ``backend``."""
    fn = SCENARIOS.get(name)
    if fn is None:
        raise KeyError(
            "unknown scenario %r (have: %s)" % (name, ", ".join(sorted(SCENARIOS)))
        )
    # scenario-pinned env (e.g. the red drill's EDL_STORE_MVCC=0) must
    # be in place BEFORE the rig boots: the store reads it at construction
    env_over = getattr(fn, "env", None) or {}
    env_saved = {k: os.environ.get(k) for k in env_over}
    os.environ.update(env_over)
    t0 = time.monotonic()
    try:
        rig = Rig(
            os.path.join(workdir, name.replace("/", "_")),
            job_id="chaos-%s-%d" % (name, seed),
            seed=seed,
            ha=getattr(fn, "ha", False),
            shards=getattr(fn, "shards", 1),
            device=device,
        )
        try:
            outcome = fn(rig)
        finally:
            rig.close()  # monitor stopped -> series segments are final
    finally:
        for k, v in env_saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    outcome.info["duration_s"] = round(time.monotonic() - t0, 2)

    from edl_tpu_torch.obs import archive as run_archive

    if archive_to == "auto":
        root = run_archive.archive_root(default=os.path.join(workdir, "runs"))
    else:
        root = archive_to
    bundle = None
    if root:
        try:
            bundle = run_archive.RunArchive(root).archive(
                "chaos-%s" % name,
                "s%d" % seed,
                backend=rig.device,
                seed=seed,
                flight_dir=rig.flight_dir,
                trace_dir=rig.trace_dir,
                monitor_dir=rig.monitor_dir,
                chaos_log=rig.chaos_log,
                invariants=[
                    {"name": r.name, "ok": r.ok, "detail": r.detail}
                    for r in outcome.invariants
                ],
                # scenario-computed rollups (e.g. the autoscale drill's
                # goodput-loss-vs-oracle) trend beside the duration
                rollups=dict(
                    outcome.info.get("rollups", {}),
                    duration_s=outcome.info["duration_s"],
                ),
                knobs=run_archive.knob_snapshot(rig.job_env),
                extra={"scenario": name, "info": outcome.info},
            )
        except Exception as exc:  # noqa: BLE001 — the invariant reports it
            logger.warning("run archive failed for %s: %s", name, exc)
    if root:
        # the invariant only audits ARMED archiving: EDL_RUN_ARCHIVE=0
        # (or archive_to=None) opted out, and opting out of
        # observability must not turn a green recovery red
        outcome.invariants.append(
            inv.run_archived(bundle, os.path.join(root, run_archive.INDEX_NAME))
        )
        outcome.ok = all(r.ok for r in outcome.invariants)
    if bundle:
        outcome.info["bundle"] = os.path.basename(bundle)
    return outcome
