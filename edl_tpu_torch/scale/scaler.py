"""The scaler daemon: observations in, ``scale/target`` docs out.

One :class:`Scaler` arbitrates every configured job on one shared pool.
Each sweep it

1. **senses** — per job: the actual world from ``cluster/current``,
   ``edl_goodput_ratio`` / ``edl_train_steps_total`` /
   ``edl_train_grad_noise_scale`` scraped off the monitor plane's
   discovered endpoints, straggler pressure from the alert records (and
   a ``stats_override`` hook so drills can inject deterministic
   signals);
2. **decides** — :func:`~edl_tpu_torch.scale.arbiter.allocate` splits the
   pool, :func:`~edl_tpu_torch.scale.decide.decide_world` applies hysteresis
   + cooldown per job;
3. **acts** — gang-sequenced by :func:`~edl_tpu_torch.scale.arbiter
   .release_targets`, each released decision is stamped with a global
   ``seq``, traced under the deterministic ``op_trace_id("scale",
   seq)`` root, fsync'd to the flight log as ``scale_decision``, and
   written to the store as ``scale/target`` (+ a rich
   ``scale/decision`` doc for edl-top). The leader launcher does the
   rest through drain/restage — the scaler never touches a pod.

The decision->restage latency contract: the scaler's ``scale_decision``
record and root span carry the same trace id the launcher stamps on
its ``reconcile`` segment, so ``edl-trace --op scale`` stitches the
full decision->restage path with no clock games.

The port's copy of ``edl_tpu/scale/scaler.py``: the same ``scale/target``
and ``scale/decision`` docs, flight records and ``scale`` op trace ids,
which the port's launcher (and the JAX one) reconcile. One departure:
a job's actual world counts its preempt-noticed pods until its leader
publishes the shrunk generation (``_actual_world``), so a grow it funds
is released only once that shrink is real.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from edl_tpu_torch.cluster.contract import (
    CLUSTER_SERVICE,
    PREEMPT_SERVICE,
    SCALE_SERVICE,
)
from edl_tpu_torch.cluster.model import Cluster
from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import memory as obs_memory
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import monitor as obs_monitor
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.scale import arbiter as scale_arbiter
from edl_tpu_torch.scale import decide as scale_decide

logger = logging.getLogger("edl.scale")

__all__ = ["JobSpec", "Scaler", "TARGET_KEY", "DECISION_KEY"]

# keys under the scale service (see cluster/contract.py keyspace docs)
TARGET_KEY = "target"
DECISION_KEY = "decision"

# alert rules that register as pressure on a job's allocation
_PRESSURE_RULES = ("straggler-ejections", "goodput-degraded", "mfu-degraded")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One arbitrated job: identity + gang limits + standing."""

    job_id: str
    min_world: int = 1
    max_world: int = 8
    priority: int = 0
    weight: float = 1.0

    @staticmethod
    def parse(text: str) -> "JobSpec":
        """``job[:min[:max[:priority]]]`` — the --job CLI grammar."""
        parts = text.split(":")
        return JobSpec(
            job_id=parts[0],
            min_world=int(parts[1]) if len(parts) > 1 else 1,
            max_world=int(parts[2]) if len(parts) > 2 else 8,
            priority=int(parts[3]) if len(parts) > 3 else 0,
        )


def _series_total(series: Dict[str, Dict[str, float]], metric: str) -> Optional[float]:
    vals = series.get(metric)
    if not vals:
        return None
    return sum(vals.values())


class Scaler:
    """Sense -> decide -> act loop over one store (see module doc)."""

    def __init__(
        self,
        store,
        jobs: List[JobSpec],
        interval: float = 5.0,
        capacity: Optional[object] = None,  # int, or () -> int; None = sum of actuals
        params: Optional[scale_decide.ScaleParams] = None,
        flight_dir: Optional[str] = None,
        trace_dir: Optional[str] = None,
        stats_override: Optional[Callable[[str], Optional[Dict]]] = None,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        scrape_timeout: float = 1.0,
        procs_per_pod: int = 1,
    ) -> None:
        if not jobs:
            raise ValueError("scaler needs at least one JobSpec")
        ids = [j.job_id for j in jobs]
        if len(ids) != len(set(ids)):
            raise ValueError("duplicate job ids: %s" % sorted(ids))
        self.jobs = list(jobs)
        self.interval = interval
        self.scrape_timeout = scrape_timeout
        self._capacity = capacity
        self.params = params if params is not None else scale_decide.params_from_env()
        self._stats_override = stats_override
        self._owns_client = False
        if isinstance(store, str):
            from edl_tpu_torch.store.client import connect_store

            self.client = connect_store(store, timeout=5.0)
            self._owns_client = True
        else:
            self.client = store
        self._registries = {
            j.job_id: Registry(self.client, j.job_id) for j in self.jobs
        }
        reg = registry if registry is not None else obs_metrics.default_registry()
        self._m_decisions = reg.counter(
            "edl_scale_decisions_total", "acted scale decisions, by kind"
        )
        self._m_target = reg.gauge(
            "edl_scale_target_world", "published target world, by job"
        )
        self._m_unfit = reg.counter(
            "edl_scale_mem_unfit_total",
            "scale decisions gated by the memory-plane fit check "
            "(target walked down or refused with cause mem_unfit)",
        )
        self.procs_per_pod = max(1, int(procs_per_pod))
        self._recorder: Optional[obs_events.FlightRecorder] = None
        if flight_dir:
            self._recorder = obs_events.FlightRecorder(
                flight_dir, component="scaler"
            )
        self._tracer: Optional[obs_trace.SpanTracer] = None
        self._trace_path: Optional[str] = None
        if trace_dir:
            self._tracer = obs_trace.SpanTracer("scaler")
            self._trace_path = os.path.join(
                trace_dir, "scaler-%d.trace.json" % os.getpid()
            )
        self._seq = 0
        self._last: Dict[str, scale_decide.Decision] = {}
        self._published: Dict[str, int] = {}
        self._steps_hist: Dict[str, tuple] = {}   # job -> (ts, total steps)
        self._pressure: Dict[str, int] = {}       # job -> alert pressure count
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- job set -----------------------------------------------------------

    def add_job(self, spec: JobSpec, queued: bool = True) -> None:
        """Submit a job to the arbitration set mid-flight.

        With ``queued`` (the default) a ``scale/target`` of 0 pods is
        published immediately, BEFORE the job's pods exist: whenever
        they arrive, their launchers hold them (want=0, nothing
        published) until the arbiter genuinely admits the gang with a
        grow decision — admission is the scheduler's call, not a race
        against pod arrival."""
        with self._lock:
            if any(j.job_id == spec.job_id for j in self.jobs):
                raise ValueError("job %s already arbitrated" % spec.job_id)
            self.jobs.append(spec)
            self._registries[spec.job_id] = Registry(self.client, spec.job_id)
        if queued:
            self._act(
                spec.job_id,
                scale_decide.Decision(
                    "queued", 0, "submitted; awaiting admission", 0.0
                ),
                scale_decide.JobStats(world=0),
                time.time(),
            )
        self._wake.set()

    # -- sensing -----------------------------------------------------------

    def _job_complete(self, job_id: str) -> bool:
        """The job's trainee declared completion — it no longer bids
        for pods (its ``cluster/current`` doc is a permanent record of
        the last world and must not be read as demand)."""
        try:
            value = self.client.get("/%s/job/status" % job_id)
        except Exception:  # noqa: BLE001 — store blip: still bidding
            return False
        return bool(value) and value.strip() == b"COMPLETE"

    def _actual_world(self, job_id: str) -> int:
        """The job's published world, until its shrink is real. While
        some published pods survive the preempt notices, their leader
        publishes the next generation without the noticed ones; until it
        has, the published roster is the world, so a grow funded by the
        noticed pods waits for the shrink to land, not merely to be
        ordered (the JAX scaler discounts every noticed pod at once, and
        a gang it admits can publish before the preempted job's shrink
        does). Only when every published pod carries a notice (a pause,
        a preempt to 0) is the world 0: no launcher may survive to
        publish a fresh generation at all — the victim's last
        ``cluster/current`` doc is permanent, and read as it stands it
        would be a shrink that never settles, deferring the preempting
        gang's grow forever."""
        reg = self._registries[job_id]
        try:
            meta = reg.get_server(CLUSTER_SERVICE, "current")
        except Exception:  # noqa: BLE001 — store mid-blip reads as unknown
            return 0
        if meta is None:
            return 0
        try:
            pod_ids = Cluster.from_json(meta.value).pod_ids()
        except (ValueError, KeyError):
            return 0
        if not pod_ids:
            return 0
        try:
            noticed = {m.name for m in reg.get_service(PREEMPT_SERVICE)}
        except Exception:  # noqa: BLE001 — blip: count the full roster
            noticed = set()
        if all(pid in noticed for pid in pod_ids):
            return 0
        return len(pod_ids)

    def _scrape_job(self, job_id: str, now: float) -> Dict[str, float]:
        """Merged metric totals across the job's live endpoints."""
        merged: Dict[str, float] = {}
        try:
            targets = obs_http.discover_endpoints(self.client, job_id)
        except Exception:  # noqa: BLE001
            return merged
        ratios: List[float] = []
        gns: List[float] = []
        steps = 0.0
        saw_steps = False
        for info in targets.values():
            endpoint = info.get("endpoint", "")
            try:
                series = obs_http.fetch_metrics(endpoint, timeout=self.scrape_timeout)
            except Exception:  # noqa: BLE001 — dead endpoints are data too
                continue
            v = _series_total(series, "edl_goodput_ratio")
            if v is not None:
                ratios.append(v)
            v = _series_total(series, "edl_train_grad_noise_scale")
            if v is not None:
                gns.append(v)
            v = _series_total(series, "edl_train_steps_total")
            if v is not None:
                steps += v
                saw_steps = True
        if ratios:
            merged["goodput_ratio"] = sum(ratios) / len(ratios)
        if gns:
            merged["gns"] = sum(gns) / len(gns)
        if saw_steps:
            prev = self._steps_hist.get(job_id)
            self._steps_hist[job_id] = (now, steps)
            if prev is not None and now > prev[0] and steps >= prev[1]:
                merged["step_rate"] = (steps - prev[1]) / (now - prev[0])
        return merged

    def _job_stats(self, spec: JobSpec, now: float) -> scale_decide.JobStats:
        world = self._actual_world(spec.job_id)
        scraped = self._scrape_job(spec.job_id, now)
        stragglers = 0
        try:
            alerts = obs_monitor.read_alerts(self.client, spec.job_id)
        except Exception:  # noqa: BLE001
            alerts = {}
        for rule, doc in alerts.items():
            if rule in _PRESSURE_RULES and doc.get("state") == "firing":
                stragglers += 1
        with self._lock:
            stragglers += self._pressure.pop(spec.job_id, 0)
        rate = scraped.get("step_rate")
        per_pod = (rate / world) if (rate and world) else 1.0
        stats = {
            "world": world,
            "per_pod_rate": per_pod,
            "goodput_ratio": scraped.get("goodput_ratio", 1.0),
            "gns": scraped.get("gns"),
            "stragglers": stragglers,
        }
        if self._stats_override is not None:
            try:
                override = self._stats_override(spec.job_id)
            except Exception:  # noqa: BLE001 — a drill hook must not stop the loop
                override = None
            if override:
                stats.update(override)
        return scale_decide.JobStats(**stats)

    def _mem_cap(self, job_id: str) -> Optional[int]:
        """The memory plane's fit verdict for one job, in pods: the
        largest ``mem/plan/{world}`` whose compile-time plan fits its
        own stamped device limit minus ``EDL_MEM_MARGIN`` (plan worlds
        count processes — divided down by ``procs_per_pod``). None when
        no judgeable plan is published: unknown never gates."""
        try:
            plans = obs_memory.read_plans(self.client, job_id)
        except Exception:  # noqa: BLE001 — store blip reads as unknown
            return None
        cap = obs_memory.fit_cap(plans)
        if cap is None:
            return None
        return cap // self.procs_per_pod

    # -- alert hook (Monitor on_fire registry) -----------------------------

    def alert_hook(self, job_id: str) -> Callable:
        """A ``(rule, doc)`` callable for :meth:`Monitor.add_on_fire`
        bound to one job: pressure-relevant firings count against the
        job's next allocation and wake the loop early."""

        def _hook(rule, doc) -> None:
            self.on_alert(rule, doc, job_id=job_id)

        return _hook

    def on_alert(self, rule, doc, job_id: Optional[str] = None) -> None:
        name = getattr(rule, "name", str(rule))
        if name not in _PRESSURE_RULES:
            return
        job = job_id if job_id is not None else self.jobs[0].job_id
        with self._lock:
            self._pressure[job] = self._pressure.get(job, 0) + 1
        self._wake.set()

    # -- deciding + acting -------------------------------------------------

    def _pool_capacity(self, actuals: Dict[str, int]) -> int:
        cap = self._capacity
        if callable(cap):
            cap = cap()
        if cap is None:
            cap = sum(actuals.values())
        return int(cap)

    def poll_once(self, now: Optional[float] = None) -> List[scale_decide.Decision]:
        """One sense->decide->act sweep; returns the decisions *acted on*
        (published to the store) this sweep."""
        now = time.time() if now is None else now
        with self._lock:
            jobs = list(self.jobs)
        complete = {j.job_id for j in jobs if self._job_complete(j.job_id)}
        jobs = [j for j in jobs if j.job_id not in complete]
        if not jobs:
            return []
        stats = {j.job_id: self._job_stats(j, now) for j in jobs}
        actuals = {job: s.world for job, s in stats.items()}
        capacity = self._pool_capacity(actuals)
        mem_caps = {j.job_id: self._mem_cap(j.job_id) for j in jobs}

        def _arb_max(j: JobSpec) -> int:
            # deprioritize unfit demand at the arbiter too: pods the fit
            # check says this job cannot hold go to jobs that can. The
            # cap never bites below the gang floor or the live world —
            # decide_world owns refusal, the arbiter only splits.
            mc = mem_caps[j.job_id]
            if mc is None:
                return j.max_world
            return max(j.min_world, stats[j.job_id].world, min(j.max_world, mc))

        demands = [
            scale_arbiter.JobDemand(
                job_id=j.job_id,
                min_world=j.min_world,
                max_world=_arb_max(j),
                priority=j.priority,
                weight=j.weight,
                stats=stats[j.job_id],
                params=self.params,
            )
            for j in jobs
        ]
        alloc = scale_arbiter.allocate(demands, capacity)
        # counterfactual allocation with the fit clamp lifted: _arb_max
        # shrinks a gated job's DEMAND, so the pods it cannot hold go to
        # other jobs — but that also means the allocation decide_world
        # sees may already end at the fit ceiling, hiding the gate
        # (hi == hi_raw: no mem_unfit cause, no trace). The ungated
        # re-run tells memory-bound apart from pool-bound.
        gated = [
            j for j in jobs
            if mem_caps[j.job_id] is not None and _arb_max(j) < j.max_world
        ]
        if gated:
            free_alloc = scale_arbiter.allocate(
                [dataclasses.replace(dm, max_world=j.max_world)
                 for dm, j in zip(demands, jobs)],
                capacity,
            )
        else:
            free_alloc = alloc
        decisions: Dict[str, scale_decide.Decision] = {}
        for j in jobs:
            decisions[j.job_id] = scale_decide.decide_world(
                stats[j.job_id],
                alloc[j.job_id],
                j.min_world,
                j.max_world,
                self.params,
                last=self._last.get(j.job_id),
                now=now,
                mem_cap=mem_caps[j.job_id],
            )
        gated_ids = {j.job_id for j in gated}
        for j in jobs:
            job = j.job_id
            d = decisions[job]
            cause = d.cause
            if not cause.startswith("mem_unfit") and job in gated_ids:
                # the arbiter absorbed the gate upstream: would the
                # model have taken more pods than the fit cap let the
                # arbiter offer? Compare against the UNGATED allocation.
                want_free = scale_decide.best_world(
                    j.min_world,
                    min(j.max_world, free_alloc[job]),
                    self.params,
                    stats[job],
                )
                if want_free > d.target:
                    cause = (
                        "mem_unfit: grow to %d withheld by the arbiter "
                        "fit clamp (largest fitting plan: %d pods)"
                        % (want_free, mem_caps[job])
                    )
            if cause.startswith("mem_unfit"):
                # every fit-gated decision leaves a trace, acted or not
                # (a refusal is a HOLD and never reaches _act/the store)
                self._m_unfit.inc()
                fields = dict(
                    job=job, kind=d.kind, target=d.target,
                    world=stats[job].world, cause=cause,
                )
                if self._recorder is not None:
                    self._recorder.record("mem_unfit", fsync=True, **fields)
                else:
                    obs_events.record("mem_unfit", fsync=True, **fields)
        # targets this sweep wants in force (acted kinds only), gang-gated
        want = {
            job: d.target
            for job, d in decisions.items()
            if d.kind != scale_decide.HOLD
        }
        released = scale_arbiter.release_targets(want, actuals)
        acted: List[scale_decide.Decision] = []
        for job in sorted(released):
            d = decisions[job]
            if self._published.get(job) == d.target:
                continue  # already in force — no seq churn, no re-publish
            acted.append(self._act(job, d, stats[job], now))
        deferred = sorted(set(want) - set(released))
        if deferred:
            logger.info(
                "gang sequencing: grow deferred for %s (shrinks in flight)",
                ",".join(deferred),
            )
        if self._tracer is not None and self._trace_path and acted:
            try:
                self._tracer.export(self._trace_path)
            except OSError as exc:
                logger.warning("scaler trace export failed: %s", exc)
        return acted

    def _act(
        self,
        job_id: str,
        decision: scale_decide.Decision,
        stats: scale_decide.JobStats,
        now: float,
    ) -> scale_decide.Decision:
        with self._lock:
            # add_job() publishes a queued target from the caller's
            # thread while the sweep loop acts — seq must stay unique
            self._seq += 1
            seq = self._seq
        decision = dataclasses.replace(decision, seq=seq, job_id=job_id, ts=now)
        ctx = obs_trace.op_context("scale", str(seq))
        if self._tracer is not None:
            # the deterministic decision root every reconcile segment
            # parents to — recorded on OUR tracer, not the global one
            self._tracer.record(
                "op:scale", time.monotonic(), 0.0,
                op="scale", op_key=str(seq), root=True,
                trace_id=ctx.trace_id, span_id=ctx.span_id,
                job=job_id, kind=decision.kind, target=decision.target,
            )
        fields = dict(
            trace_id=ctx.trace_id, seq=seq, job=job_id,
            kind=decision.kind, target=decision.target,
            world=stats.world, cause=decision.cause,
            score=round(decision.score, 4),
        )
        if self._recorder is not None:
            self._recorder.record("scale_decision", fsync=True, **fields)
        else:
            obs_events.record("scale_decision", fsync=True, **fields)
        target_doc = {
            "pods": decision.target,
            "seq": seq,
            "cause": decision.cause,
            "ts": now,
        }
        decision_doc = dict(
            target_doc,
            kind=decision.kind,
            world=stats.world,
            score=round(decision.score, 4),
            trace_id=ctx.trace_id,
            job=job_id,
        )
        try:
            reg = self._registries[job_id]
            reg.set_permanent(
                SCALE_SERVICE, TARGET_KEY, json.dumps(target_doc).encode()
            )
            reg.set_permanent(
                SCALE_SERVICE, DECISION_KEY, json.dumps(decision_doc).encode()
            )
        except Exception as exc:  # noqa: BLE001 — store blip: retry next sweep
            logger.warning("scale target for %s not published: %s", job_id, exc)
            return decision
        self._published[job_id] = decision.target
        self._last[job_id] = decision
        self._m_decisions.inc(kind=decision.kind)
        self._m_target.set(decision.target, job=job_id)
        logger.info(
            "scale decision #%d %s: %s %d -> %d (%s)",
            seq, job_id, decision.kind, stats.world, decision.target,
            decision.cause,
        )
        return decision

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="edl-scaler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — the loop must survive a bad sweep
                logger.warning("scaler sweep failed: %s", exc)
            self._wake.wait(self.interval)
            self._wake.clear()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        if self._tracer is not None and self._trace_path:
            try:
                self._tracer.export(self._trace_path)
            except OSError as exc:
                logger.warning("scaler trace export failed: %s", exc)
        if self._owns_client and self.client is not None:
            try:
                self.client.close()
            except Exception:  # noqa: BLE001
                pass
