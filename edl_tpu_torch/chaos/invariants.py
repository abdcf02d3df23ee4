"""Recovery-conformance invariants: did the system actually recover?

Every chaos scenario ends by assembling :class:`Evidence` — the job's
``chaos/progress/`` ledger, the PR-1 telemetry keyspace
(drain/killed/published/first_step events), the chaos injection log, and
/metrics snapshots harvested from live obs endpoints during the run — and
asserting invariants over it. A scenario is green only when every
invariant holds; each failure names the evidence that contradicts the
recovery claim.

The invariants encode the paper's elastic contract:

- **completed**: the job reached its target step despite the fault;
- **shards exactly-once**: the data-shard ledger (put-if-absent commits)
  covers ``0..N-1`` with no gap and no duplicate — membership change
  neither skipped nor double-processed data;
- **resumed, not restarted**: some post-fault incarnation restored a
  checkpoint at step > 0;
- **bounded rework**: replayed steps are bounded by the checkpoint
  interval per recovery (stop-resume may re-run the tail since the last
  checkpoint, never more);
- **checkpoint fallback**: with the newest version corrupted, restore
  fell back to an older good version (and said so);
- **bounded, attributed downtime**: each recovery transition's
  drain -> first_step interval is under budget, with the kill/publish
  decomposition recorded;
- **fault visibility**: every injected fault left a ledger entry and an
  ``edl_chaos_faults_injected_total`` series where the process survived.

The health plane (PR 4) adds drain/straggler conformance:

- **drained before deadline**: a preemption notice ("preempt" event) was
  answered by a worker "drained" event inside the drain budget;
- **proactive drain**: the drain-token bump followed the notice within a
  couple of loop passes — NOT after a lease expiry or the failure-grace
  window (the no-grace-hold-on-drain property);
- **lost work bounded**: a post-drain restore landed at or past the step
  cursor observed at notice time (the emergency checkpoint was used);
- **straggler ejected within deadline**: the wedge injection was followed
  by a "straggler" ejection event inside the watchdog deadline;
- **zero stragglers**: the false-positive drill — a slow control plane
  must eject nobody.

The monitor plane (PR 6) adds alerting conformance:

- **alerts fired**: the in-rig ``edl_monitord`` published a firing
  transition for the named rule within a bounded latency of the fault;
- **no false alerts**: the clean control run (``monitor-clean``)
  published no alert record at all.

The port's copy of ``edl_tpu/chaos/invariants.py``: the same verdict
names and detail text, over the port's store client, flight recorder and
trace stitcher.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.chaos.plane import chaos_prefix
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("chaos.invariants")


@dataclass
class InvariantResult:
    name: str
    ok: bool
    detail: str = ""

    def __str__(self) -> str:
        return "%s %s%s" % (
            "PASS" if self.ok else "FAIL",
            self.name,
            (": " + self.detail) if self.detail else "",
        )


@dataclass
class Evidence:
    """Everything a scenario collected about one run."""

    progress: Dict = field(default_factory=dict)   # read_progress() output
    telemetry: Dict = field(default_factory=dict)  # utils.telemetry.collect()
    chaos_log: List[Dict] = field(default_factory=list)
    metrics: Dict[str, Dict] = field(default_factory=dict)  # target -> scrape


# -- evidence collection ------------------------------------------------------


def read_progress(client, job_id: str) -> Dict:
    """Parse the trainee's ``chaos/progress/`` ledger back into dicts."""
    prefix = chaos_prefix(job_id) + "progress/"
    rows, _rev = client.range(prefix)
    shards: Dict[int, dict] = {}
    restores: List[dict] = []
    dones: List[dict] = []
    cursors: Dict[str, int] = {}
    malformed = 0
    for key, value, _c, _m in rows:
        rest = key[len(prefix):]
        try:
            if rest.startswith("shard/"):
                shards[int(rest[len("shard/"):])] = json.loads(value)
            elif rest.startswith("restore."):
                restores.append({"key": rest, **json.loads(value)})
            elif rest.startswith("done."):
                dones.append({"key": rest, **json.loads(value)})
            elif rest.startswith("step."):
                cursors[rest[len("step."):]] = int(value)
        except (ValueError, TypeError):
            malformed += 1
    return {
        "shards": shards,
        "restores": restores,
        "dones": dones,
        "cursors": cursors,
        "malformed": malformed,
    }


def read_chaos_log(path: str) -> List[Dict]:
    """Parse the crash-safe injection ledger (one JSON object per line)."""
    entries: List[Dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entries.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return entries


class MetricsHarvester:
    """Scrape every store-registered obs endpoint on a timer, keeping the
    LAST successful scrape per target — processes here die on purpose, so
    conformance must be checked against the freshest pre-death sample."""

    def __init__(self, client, job_id: str, interval: float = 0.4) -> None:
        self._client = client
        self._job_id = job_id
        self._interval = interval
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict] = {}
        self._thread = threading.Thread(
            target=self._loop, name="edl-chaos-harvest", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        from edl_tpu_torch.obs import http as obs_http

        while not self._stop.wait(self._interval):
            try:
                targets = obs_http.discover_endpoints(self._client, self._job_id)
            except Exception:  # noqa: BLE001 — store may be mid-blip
                continue
            for who, info in targets.items():
                endpoint = info.get("endpoint")
                if not endpoint:
                    continue
                try:
                    scraped = obs_http.fetch_metrics(endpoint, timeout=1.0)
                except Exception:  # noqa: BLE001 — dead targets are expected
                    continue
                with self._lock:
                    self._latest[who] = scraped

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._latest.items()}

    def stop(self) -> Dict[str, Dict]:
        self._stop.set()
        self._thread.join(timeout=3)
        return self.snapshot()


def _metric_total(evidence: Evidence, name: str, label_substr: str = "") -> float:
    total = 0.0
    for scrape in evidence.metrics.values():
        for labels, value in scrape.get(name, {}).items():
            if label_substr in labels:
                total += value
    return total


# -- invariants ---------------------------------------------------------------


def completed(evidence: Evidence, total_steps: int) -> InvariantResult:
    steps = [int(d.get("step", -1)) for d in evidence.progress.get("dones", [])]
    ok = any(s == total_steps for s in steps)
    return InvariantResult(
        "completed",
        ok,
        "done records at steps %s (want %d)" % (sorted(set(steps)), total_steps),
    )


def shards_exactly_once(evidence: Evidence, total_steps: int) -> InvariantResult:
    got = set(evidence.progress.get("shards", {}))
    want = set(range(total_steps))
    missing = sorted(want - got)
    extra = sorted(got - want)
    ok = not missing and not extra
    return InvariantResult(
        "shards_exactly_once",
        ok,
        "%d/%d committed%s%s"
        % (
            len(got & want),
            total_steps,
            (", missing %s" % missing[:8]) if missing else "",
            (", unexpected %s" % extra[:8]) if extra else "",
        ),
    )


def resumed_past_prefault_step(
    evidence: Evidence, prefault_step: Optional[int] = None
) -> InvariantResult:
    """Some incarnation RESTORED (restored > 0) and the job's final step
    reached past where training was when the fault struck."""
    restores = evidence.progress.get("restores", [])
    resumed = [r for r in restores if int(r.get("restored", 0)) > 0]
    final = max(
        [int(d.get("step", 0)) for d in evidence.progress.get("dones", [])],
        default=0,
    )
    floor = prefault_step if prefault_step is not None else 1
    ok = bool(resumed) and final >= floor
    return InvariantResult(
        "resumed_past_prefault_step",
        ok,
        "restores at %s, final step %d (pre-fault floor %s)"
        % (sorted(int(r.get("restored", 0)) for r in restores), final, floor),
    )


def replay_bounded(evidence: Evidence, ckpt_every: int) -> InvariantResult:
    """Stop-resume may re-run at most the tail since the last checkpoint,
    once per recovery — a recovery is a restaged GENERATION, so count
    distinct stages among the restore records (per-rank records of one
    stage are one recovery, not several)."""
    replays = sum(
        int(d.get("replays", 0)) for d in evidence.progress.get("dones", [])
    )
    stages = {
        r.get("stage") for r in evidence.progress.get("restores", [])
    }
    recoveries = max(1, len(stages) - 1)
    bound = ckpt_every * recoveries
    ok = replays <= bound
    return InvariantResult(
        "replay_bounded",
        ok,
        "%d replayed steps (bound %d = %d ckpt_every x %d recoveries)"
        % (replays, bound, ckpt_every, recoveries),
    )


def checkpoint_fell_back(
    evidence: Evidence, corrupted_step: int
) -> InvariantResult:
    """After the newest version was corrupted, some restore skipped it:
    fallbacks counted, and the restored step is OLDER than the corrupt one."""
    hits = [
        r
        for r in evidence.progress.get("restores", [])
        if int(r.get("fallbacks", 0)) > 0
        and int(r.get("restored", 0)) < corrupted_step
    ]
    return InvariantResult(
        "checkpoint_fell_back",
        bool(hits),
        "restores %s (corrupt version at step %d)"
        % (
            [(int(r.get("restored", -1)), int(r.get("fallbacks", 0)))
             for r in evidence.progress.get("restores", [])],
            corrupted_step,
        ),
    )


def downtime_bounded(evidence: Evidence, budget_s: float) -> InvariantResult:
    """Every recovery transition (stage with both drain and first_step
    events) kept drain -> first step under budget, with the attribution
    timestamps present."""
    events = evidence.telemetry.get("events", {})
    spans = []
    for stage, evs in events.items():
        if "drain" not in evs or "first_step" not in evs:
            continue
        downtime = max(evs["first_step"].values()) - min(evs["drain"].values())
        spans.append((stage[:8], round(downtime, 3)))
    worst = max((d for _, d in spans), default=None)
    ok = bool(spans) and worst is not None and worst <= budget_s
    return InvariantResult(
        "downtime_bounded",
        ok,
        "transitions %s (budget %.1fs)" % (spans, budget_s),
    )


def fault_injected(
    evidence: Evidence, point: str, action: str, at_least: int = 1
) -> InvariantResult:
    """The fault plane actually struck: the crash-safe ledger has the
    injection(s) this scenario scheduled."""
    hits = [
        e
        for e in evidence.chaos_log
        if e.get("point") == point and e.get("action") == action
    ]
    return InvariantResult(
        "fault_injected[%s@%s]" % (action, point),
        len(hits) >= at_least,
        "%d ledger entr%s (want >= %d)"
        % (len(hits), "y" if len(hits) == 1 else "ies", at_least),
    )


def retries_observed(evidence: Evidence, at_least: int = 1) -> InvariantResult:
    """The shared retry path (utils/retry.py) absorbed the fault:
    edl_rpc_retries_total advanced on some live endpoint."""
    total = _metric_total(evidence, "edl_rpc_retries_total")
    return InvariantResult(
        "retries_observed",
        total >= at_least,
        "edl_rpc_retries_total=%d across %d scraped targets (want >= %d)"
        % (int(total), len(evidence.metrics), at_least),
    )


def faults_visible_in_metrics(
    evidence: Evidence, point: str, extra_registry=None
) -> InvariantResult:
    """edl_chaos_faults_injected_total{point=...} advanced somewhere a
    scrape (or the in-process registry, for runner-hosted components)
    could see it."""
    total = _metric_total(
        evidence, "edl_chaos_faults_injected_total", 'point="%s"' % point
    )
    if extra_registry is not None:
        inst = extra_registry.get("edl_chaos_faults_injected_total")
        if inst is not None:
            for line in inst.render():
                if 'point="%s"' % point in line:
                    total += float(line.rpartition(" ")[2])
    return InvariantResult(
        "faults_visible_in_metrics[%s]" % point,
        total >= 1,
        "counter total %d for point %s" % (int(total), point),
    )


def metric_advanced(
    evidence: Evidence, name: str, at_least: float = 1, label_substr: str = ""
) -> InvariantResult:
    """A named counter advanced on some scraped endpoint during the run
    (the harvester keeps the last pre-death sample per target)."""
    total = _metric_total(evidence, name, label_substr)
    return InvariantResult(
        "metric_advanced[%s]" % name,
        total >= at_least,
        "total %g across %d scraped targets (want >= %g)"
        % (total, len(evidence.metrics), at_least),
    )


def promoted_within(
    promote_s: Optional[float], budget_s: float
) -> InvariantResult:
    """A standby took over inside the failover budget (None = it never
    promoted at all)."""
    ok = promote_s is not None and promote_s <= budget_s
    return InvariantResult(
        "promoted_within",
        ok,
        "promotion took %s (budget %.1fs)"
        % ("%.2fs" % promote_s if promote_s is not None else "—never—", budget_s),
    )


def acked_write_survived(
    value: Optional[bytes],
    expected: bytes,
    mod_rev: int,
    acked_rev: int,
) -> InvariantResult:
    """A write the OLD primary acknowledged is present on the promoted
    store with its original mod revision — the journal-before-ack +
    live-stream contract held through the failover."""
    ok = value == expected and mod_rev == acked_rev
    return InvariantResult(
        "acked_write_survived",
        ok,
        "value=%r rev=%d (acked %r rev=%d)" % (value, mod_rev, expected, acked_rev),
    )


def stale_primary_fenced(
    fenced_epoch: Optional[int],
    probe_refused: bool,
    new_epoch: int,
) -> InvariantResult:
    """The resurrected old primary fenced itself on the promoted
    primary's epoch and refused a fresh client's write."""
    ok = (
        fenced_epoch is not None
        and fenced_epoch >= new_epoch
        and probe_refused
    )
    return InvariantResult(
        "stale_primary_fenced",
        ok,
        "fenced_by=%s (promoted epoch %d), probe write %s"
        % (
            fenced_epoch,
            new_epoch,
            "refused" if probe_refused else "ACCEPTED",
        ),
    )


def watch_resumed_exactly_once(
    events, shard_prefix: str, total_steps: int
) -> InvariantResult:
    """A watch held across the failover saw every shard commit exactly
    once, with no gap (a gap would force a resync marker) and no
    duplicate — the promoted standby's replicated history covered the
    client's resume revision."""
    resyncs = sum(1 for e in events if e.type == "resync")
    shards: List[int] = []
    for e in events:
        if e.type == "put" and e.key.startswith(shard_prefix):
            try:
                shards.append(int(e.key[len(shard_prefix):]))
            except ValueError:
                pass
    want = list(range(total_steps))
    ok = resyncs == 0 and sorted(shards) == want and len(shards) == len(set(shards))
    return InvariantResult(
        "watch_resumed_exactly_once",
        ok,
        "%d/%d shard events (%d dup, %d resync)"
        % (
            len(set(shards) & set(want)),
            total_steps,
            len(shards) - len(set(shards)),
            resyncs,
        ),
    )


def _events_of_kind(evidence: Evidence, kind: str) -> List[float]:
    """All timestamps of one event kind across every stage, sorted."""
    out: List[float] = []
    for evs in evidence.telemetry.get("events", {}).values():
        out.extend(evs.get(kind, {}).values())
    return sorted(out)


def drained_before_deadline(
    evidence: Evidence, budget_s: float
) -> InvariantResult:
    """Every preemption notice was answered by a worker 'drained' event
    within the drain budget (the emergency-checkpoint window held)."""
    preempts = _events_of_kind(evidence, "preempt")
    draineds = _events_of_kind(evidence, "drained")
    if not preempts:
        return InvariantResult(
            "drained_before_deadline", False, "no preempt event recorded"
        )
    worst = None
    for p in preempts:
        after = [d for d in draineds if d >= p - 0.2]
        if not after:
            return InvariantResult(
                "drained_before_deadline",
                False,
                "preempt at %.2f never drained (drained events: %d)"
                % (p, len(draineds)),
            )
        delta = min(after) - p
        worst = delta if worst is None else max(worst, delta)
    ok = worst is not None and worst <= budget_s
    return InvariantResult(
        "drained_before_deadline",
        ok,
        "worst notice->drained %.2fs (budget %.1fs, %d notice(s))"
        % (worst if worst is not None else -1, budget_s, len(preempts)),
    )


def proactive_drain(evidence: Evidence, bound_s: float) -> InvariantResult:
    """No-grace-hold-on-drain: the drain-token bump landed within
    ``bound_s`` of the preemption notice. A reactive system (lease expiry
    after the pod dies, or a worker-failure grace hold) cannot get there —
    its drain trails the notice by at least drain-budget + TTL."""
    preempts = _events_of_kind(evidence, "preempt")
    drains = _events_of_kind(evidence, "drain")
    if not preempts:
        return InvariantResult("proactive_drain", False, "no preempt event")
    p0 = min(preempts)
    after = [d for d in drains if d >= p0 - 0.2]
    if not after:
        return InvariantResult(
            "proactive_drain", False,
            "no drain event followed the notice at %.2f" % p0,
        )
    delta = min(after) - p0
    return InvariantResult(
        "proactive_drain",
        delta <= bound_s,
        "notice->drain %.2fs (bound %.1fs)" % (delta, bound_s),
    )


def lost_work_bounded(
    evidence: Evidence, cursor_at_notice: int, slack_steps: int = 1
) -> InvariantResult:
    """The emergency checkpoint was actually USED: some post-drain restore
    landed at or past the step cursor observed when the notice was sent
    (minus the one in-flight step a drain may legitimately drop)."""
    restores = [
        int(r.get("restored", 0))
        for r in evidence.progress.get("restores", [])
    ]
    best = max(restores, default=0)
    floor = max(0, cursor_at_notice - slack_steps)
    return InvariantResult(
        "lost_work_bounded",
        best >= floor,
        "best restore at step %d, notice cursor %d (floor %d)"
        % (best, cursor_at_notice, floor),
    )


def straggler_ejected_within(
    evidence: Evidence, budget_s: float
) -> InvariantResult:
    """The wedge (a long train.step delay injection) was answered by a
    watchdog ejection ('straggler' event) inside the deadline budget."""
    wedges = sorted(
        float(e["ts"])
        for e in evidence.chaos_log
        if e.get("point") == "train.step" and e.get("action") == "delay"
    )
    ejections = _events_of_kind(evidence, "straggler")
    if not wedges:
        return InvariantResult(
            "straggler_ejected_within", False, "no wedge injected"
        )
    if not ejections:
        return InvariantResult(
            "straggler_ejected_within", False,
            "wedge at %.2f never ejected" % wedges[0],
        )
    delta = min(e for e in ejections) - wedges[0]
    return InvariantResult(
        "straggler_ejected_within",
        0 <= delta <= budget_s,
        "wedge->ejection %.2fs (budget %.1fs)" % (delta, budget_s),
    )


def zero_stragglers(evidence: Evidence) -> InvariantResult:
    """False-positive drill: nobody was ejected and nobody drained."""
    ejections = _events_of_kind(evidence, "straggler")
    preempts = _events_of_kind(evidence, "preempt")
    ok = not ejections and not preempts
    return InvariantResult(
        "zero_stragglers",
        ok,
        "%d straggler ejection(s), %d preempt notice(s) (want 0/0)"
        % (len(ejections), len(preempts)),
    )


def drained_exit_clean(
    exit_code: Optional[int], t_exit_s: Optional[float], budget_s: float
) -> InvariantResult:
    """The noticed pod left with the DRAINED exit code, inside the drain
    budget — not killed, not crash-looped, not grace-held."""
    from edl_tpu_torch.cluster.contract import DRAINED_EXIT

    ok = (
        exit_code == DRAINED_EXIT
        and t_exit_s is not None
        and t_exit_s <= budget_s
    )
    return InvariantResult(
        "drained_exit_clean",
        ok,
        "exit code %s in %s (want %d within %.1fs)"
        % (
            exit_code,
            "%.2fs" % t_exit_s if t_exit_s is not None else "—",
            DRAINED_EXIT,
            budget_s,
        ),
    )


def goodput_accounted(
    flight_events: List[Dict], tolerance: float = 0.05
) -> InvariantResult:
    """The goodput ledger accounts for the run: across every recording
    process, the seconds the ledger CLAIMS (state intervals) cover the
    lifetime each process was OBSERVED for (first to last flight record)
    within ``tolerance`` — in aggregate and per lane — and the run
    actually trained. Note the job table itself partitions wall-clock by
    construction (uncovered slices become ``down``), so comparing its
    sum to the window would be vacuous; the teeth are claimed-vs-
    observed, where a ledger that loses seconds shows a hole."""
    from edl_tpu_torch.obs import goodput as obs_goodput

    if not flight_events:
        return InvariantResult(
            "goodput_accounted", False, "no flight-recorder events"
        )
    att = obs_goodput.attribute(flight_events)
    wall = att["wall_s"]
    if wall <= 0:
        return InvariantResult(
            "goodput_accounted", False, "degenerate window (wall=%.3fs)" % wall
        )
    # claimed-vs-observed, per lane and in aggregate: a lane's intervals
    # are contiguous by construction, so its observed lifetime is
    # first-interval start to last-record end; any shortfall is a second
    # the ledger lost
    gaps = []
    claimed = 0.0
    observed = 0.0
    # a ledger that closed lost no second until it opened again: the AOT
    # ladder's lane closes after each rung and with each ladder, so a
    # hot-restaged process has its lane open only while a rung runs
    closed: Dict[Tuple[str, int], set] = {}
    for ev in flight_events:
        if ev.get("event") == obs_goodput.TRANSITION_EVENT \
                and not ev.get("state"):
            lane = (str(ev.get("component", "proc")), int(ev.get("pid", 0)))
            closed.setdefault(lane, set()).add(float(ev.get("ts", 0.0)))
    for (comp, pid), sp in obs_goodput.process_intervals(flight_events).items():
        life = sp[-1][1] - sp[0][0]
        ends = closed.get((comp, pid), ())
        for (_a0, b0, _s0), (a1, _b1, _s1) in zip(sp, sp[1:]):
            if b0 in ends and a1 > b0:
                life -= a1 - b0
        acc = sum(b - a for a, b, _s in sp)
        claimed += acc
        observed += life
        if life > 0 and (life - acc) > tolerance * max(life, 1.0):
            gaps.append(("%s-%d" % (comp, pid), round(life - acc, 3)))
    sum_ok = observed > 0 and (observed - claimed) <= tolerance * observed
    trained = att["states"].get("train", 0.0) > 0
    pct = {
        s: round(100.0 * v / wall, 1)
        for s, v in sorted(att["states"].items())
    }
    ok = sum_ok and not gaps and trained
    return InvariantResult(
        "goodput_accounted",
        ok,
        "%.1fs wall -> %s (claimed %.1fs of %.1fs observed)%s%s"
        % (
            wall,
            pct,
            claimed,
            observed,
            "" if trained else ", NO train seconds",
            (", lane gaps %s" % gaps) if gaps else "",
        ),
    )


def alert_fired(
    alerts: Optional[Dict[str, Dict]],
    rule: str,
    after_ts: float,
    within_s: float,
) -> InvariantResult:
    """The monitor plane noticed the fault: the named rule has a firing
    transition inside ``[after_ts, after_ts + within_s]`` (the published
    record keeps the full firing history, so a later teardown re-fire or
    an earlier legitimate firing — e.g. a grow-restage gap — cannot mask
    the verdict either way)."""
    record = (alerts or {}).get(rule)
    if record is None:
        return InvariantResult(
            "alerts_fired[%s]" % rule,
            False,
            "no alert record for rule (have: %s)" % sorted(alerts or {}),
        )
    firings = [float(t) for t in record.get("firings", [])]
    # strictly post-fault: both stamps come from time.time() on one host
    # and a fault-caused firing can only trail its cause — a pre-fault
    # grace window would let an unrelated earlier RESOLVED firing pass
    # the check
    hits = [t for t in firings if after_ts <= t <= after_ts + within_s]
    latency = min((t - after_ts for t in hits), default=None)
    # A firing episode that BEGAN before the fault and never resolved
    # also covers it: the monitor was continuously reporting the
    # degradation through the fault window, so no new transition can
    # exist (hysteresis holds one episode open). Seen on loaded CPU
    # rigs where a slow-start dip runs straight into the fault's gap;
    # the monitor-clean scenario keeps this from excusing a rule that
    # simply fires always.
    since = record.get("since")
    resolved_ts = record.get("resolved_ts")
    covered = (
        isinstance(since, (int, float))
        and since <= after_ts
        and (
            record.get("state") == "firing"  # still open at collection
            or (
                isinstance(resolved_ts, (int, float))
                and resolved_ts >= after_ts  # resolved only after it
            )
        )
    )
    return InvariantResult(
        "alerts_fired[%s]" % rule,
        bool(hits) or covered,
        "fired %d time(s)%s; fault at %.2f, budget %.1fs (firings %s%s)"
        % (
            len(firings),
            (", %.2fs after the fault" % latency) if latency is not None else "",
            after_ts,
            within_s,
            [round(t - after_ts, 2) for t in firings[:8]],
            "; episode open across the fault since %.2f" % (since - after_ts)
            if covered else "",
        ),
    )


def alert_fired_any(
    alerts: Optional[Dict[str, Dict]],
    rules: List[str],
    after_ts: float,
    within_s: float,
) -> InvariantResult:
    """The monitor plane noticed the fault through ANY of the named
    rules. Scenarios pass the set of alerts the fault class
    deterministically produces: on a fast CPU rig the goodput dip of a
    restage can be SHORTER than the rate rule's detection granularity
    (the recovery outrunning the monitor is a feature — the sharded
    control plane shortened drain->first-step below the paced window),
    while dead-endpoint / restart-detected fire structurally on a
    killed or respawned worker. The goodput rule's own firing logic
    keeps its dedicated red drill in tests/test_monitor.py."""
    results = [alert_fired(alerts, rule, after_ts, within_s) for rule in rules]
    ok = any(r.ok for r in results)
    hit = next((r for r in results if r.ok), None)
    return InvariantResult(
        "alerts_fired_any[%s]" % "|".join(rules),
        ok,
        hit.detail if hit is not None
        else "; ".join("%s: %s" % (r.name, r.detail) for r in results),
    )


def no_false_alerts(alerts: Optional[Dict[str, Dict]]) -> InvariantResult:
    """The zero-false-positive control: a clean run publishes NO alert
    record at all (records exist only after a first firing)."""
    fired = sorted(
        "%s(x%d)" % (r.get("rule", name), int(r.get("fired_count", 1)))
        for name, r in (alerts or {}).items()
    )
    return InvariantResult(
        "no_false_alerts",
        not fired,
        "no alert ever fired" if not fired else "fired: %s" % fired,
    )


def critical_path_traced(
    trace_spans,
    flight_events: List[Dict],
    tolerance: float = 0.3,
    slack_s: float = 1.25,
) -> InvariantResult:
    """The distributed-tracing plane stitched the restage end to end:
    the LAST completed restage operation (the post-fault generation) has

    - a cross-process trace (>= 2 distinct processes contributed — the
      drain-trigger/leader side AND the respawned worker side),
    - zero orphan segments (every span's parent resolves inside the
      trace: the wire-level ``tc`` propagation and the deterministic op
      roots actually linked up), and
    - a critical path whose covered seconds match the goodput ledger's
      restage-lane accounting for the SAME processes over the same
      pre-first-step window within ``tolerance`` (+ an absolute CPU-rig
      slack) — the trace's claim about where the downtime went agrees
      with the black-box evidence.
    """
    from edl_tpu_torch.obs import tracepath

    spans = list(trace_spans)
    ops = tracepath.extract_ops(spans, op="restage")
    done = [o for o in ops if o.complete]
    if not done:
        return InvariantResult(
            "critical_path_traced",
            False,
            "no completed restage trace (%d linked spans, %d restage "
            "trace(s))" % (len(spans), len(ops)),
        )
    ot = done[-1]
    problems: List[str] = []
    if len(ot.processes) < 2:
        problems.append("single-process trace (%s)" % ot.processes)
    if ot.orphans:
        problems.append(
            "%d orphan segment(s): %s"
            % (len(ot.orphans), sorted({s.name for s in ot.orphans})[:6])
        )
    cmp = tracepath.goodput_compare(ot, flight_events)
    if cmp is None:
        problems.append("no goodput lane evidence for the traced processes")
    else:
        bound = max(tolerance * cmp["window_s"], slack_s)
        if abs(cmp["delta_s"]) > bound:
            problems.append(
                "path %.2fs vs restage lane %.2fs (|delta| %.2fs > "
                "bound %.2fs)"
                % (cmp["path_s"], cmp["lane_s"], abs(cmp["delta_s"]), bound)
            )
    detail = "op %s: %d segment(s) across %s, window %.2fs" % (
        ot.trace_id,
        len(ot.segments),
        ot.processes,
        ot.t1 - ot.t0,
    )
    if cmp is not None:
        detail += ", path %.2fs vs lane %.2fs" % (cmp["path_s"], cmp["lane_s"])
    return InvariantResult(
        "critical_path_traced",
        not problems,
        detail if not problems else "; ".join(problems) + " [" + detail + "]",
    )


def peer_tier_restored(
    evidence: Evidence,
    flight_events: List[Dict],
    after_ts: float,
) -> InvariantResult:
    """Shared-FS-free recovery: every checkpoint restore AFTER the fault
    came from the PEER tier — zero durable-tier reads — with the flight
    records (which survive the killed pod) naming the tier per restore
    and ``edl_ckpt_restores_total{tier="peer"}`` advanced on a scraped
    endpoint as the metric-side corroboration."""
    post = [
        e for e in flight_events
        if e.get("event") == "ckpt_restore"
        and float(e.get("ts", 0.0)) > after_ts
    ]
    tiers = sorted({str(e.get("tier", "?")) for e in post})
    metric_peer = _metric_total(
        evidence, "edl_ckpt_restores_total", 'tier="peer"'
    )
    # "local" may legitimately appear AFTER a peer restore already
    # landed the assembled step in the local tier (a later restage
    # re-reads it there) — still zero shared-FS reads. "durable" is the
    # read this invariant outlaws.
    ok = (
        bool(post)
        and "peer" in tiers
        and "durable" not in tiers
        and metric_peer >= 1
    )
    return InvariantResult(
        "peer_tier_restored",
        ok,
        "%d post-fault restore(s) from tier(s) %s; "
        "edl_ckpt_restores_total{tier=peer}=%d scraped"
        % (len(post), tiers or ["-none-"], int(metric_peer)),
    )


def restore_segment_traced(trace_spans) -> InvariantResult:
    """The restore hop is visible on the edl-trace restage critical
    path: the LAST completed restage operation contains a
    ``ckpt_restore`` segment (the worker-side tier-ladder hop)."""
    from edl_tpu_torch.obs import tracepath

    ops = [
        o for o in tracepath.extract_ops(list(trace_spans), op="restage")
        if o.complete
    ]
    if not ops:
        return InvariantResult(
            "restore_segment_traced", False, "no completed restage trace"
        )
    ot = ops[-1]
    hits = [s for s in ot.segments if s.name == "ckpt_restore"]
    return InvariantResult(
        "restore_segment_traced",
        bool(hits),
        "op %s: %d ckpt_restore segment(s) among %d"
        % (ot.trace_id, len(hits), len(ot.segments)),
    )


def single_stage(evidence: Evidence) -> InvariantResult:
    """The fault was absorbed WITHOUT a restage: exactly one generation
    was ever published."""
    events = evidence.telemetry.get("events", {})
    published = [s[:8] for s, evs in events.items() if "published" in evs]
    return InvariantResult(
        "single_stage",
        len(published) == 1,
        "published stages %s" % published,
    )


def multiple_stages(evidence: Evidence, at_least: int = 2) -> InvariantResult:
    """Recovery went through a restage: a new generation was published
    after the fault."""
    events = evidence.telemetry.get("events", {})
    published = [s[:8] for s, evs in events.items() if "published" in evs]
    return InvariantResult(
        "restaged",
        len(published) >= at_least,
        "published stages %s (want >= %d)" % (published, at_least),
    )


def run_archived(
    bundle: Optional[str], index_path: str
) -> InvariantResult:
    """The run-archive plane (PR 14) worked: every scenario must leave a
    COMPLETE bundle behind — the manifest parses, its rollups are
    non-empty, and one index row was appended (the crash-safe
    ``runs/index.jsonl`` line edl-report lists and gates on)."""
    name = "run_archived"
    if not bundle or not os.path.isdir(bundle):
        return InvariantResult(name, False, "no bundle archived")
    manifest_path = os.path.join(bundle, "run.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        return InvariantResult(
            name, False, "manifest unreadable: %s" % exc
        )
    if not isinstance(manifest, dict):
        return InvariantResult(name, False, "manifest is not an object")
    rollups = manifest.get("rollups") or {}
    if not rollups:
        return InvariantResult(name, False, "manifest has no rollups")
    bundle_name = os.path.basename(bundle.rstrip(os.sep))
    from edl_tpu_torch.obs import events as obs_events

    indexed = any(
        row.get("bundle") == bundle_name
        for row in obs_events.read_records(index_path)
    )
    if not indexed:
        return InvariantResult(
            name, False,
            "no index row for %s in %s" % (bundle_name, index_path),
        )
    return InvariantResult(
        name, True,
        "bundle %s: %d rollups, indexed" % (bundle_name, len(rollups)),
    )


def numerics_continuous(flight_events: List[Dict]) -> InvariantResult:
    """The resize continuity sentinel held (PR 16, obs/numerics): every
    restored worker's probe re-checked the checkpoint's stamped loss
    against its first post-resume loss and found training continuous
    (``numerics_resume`` flight records, ``ok`` true). A drill that
    restarts workers MUST leave at least one such record — no record
    means the sentinel never ran, which is its own failure."""
    name = "numerics_continuous"
    resumes = [
        e for e in flight_events if e.get("event") == "numerics_resume"
    ]
    if not resumes:
        return InvariantResult(
            name, False, "no numerics_resume records: sentinel never ran"
        )
    bad = [e for e in resumes if not e.get("ok")]
    return InvariantResult(
        name,
        not bad,
        "%d resume check(s), %d failed%s"
        % (
            len(resumes),
            len(bad),
            "" if not bad else ": " + "; ".join(
                str(e.get("detail", "?")) for e in bad[:3]
            ),
        ),
    )


def nonfinite_recorded(
    flight_events: List[Dict], at_least: int = 1
) -> InvariantResult:
    """The corruption left a black-box trace: fsync'd ``nonfinite`` /
    ``loss_spike`` flight instants (the ones edl-timeline overlays on
    the goodput lanes) were recorded by the probe."""
    hits = [
        e
        for e in flight_events
        if e.get("event") in ("nonfinite", "loss_spike")
    ]
    return InvariantResult(
        "nonfinite_recorded",
        len(hits) >= at_least,
        "%d nonfinite/loss_spike flight record(s) (want >= %d)"
        % (len(hits), at_least),
    )


def oom_forensics_captured(flight_events: List[Dict]) -> InvariantResult:
    """The OOM left admissible evidence: an fsync'd ``oom`` flight
    instant was recorded AND its forensics bundle is on disk and
    parseable — the error text, the active memory plan, a census of what
    was resident, and the stage watermark. The crash-safety contract is
    that the bundle lands (tmp + fsync + replace) BEFORE the error
    propagates into drain/restage, so it must survive the process
    death that follows."""
    name = "oom_forensics_captured"
    ooms = [e for e in flight_events if e.get("event") == "oom"]
    if not ooms:
        return InvariantResult(name, False, "no oom flight instant recorded")
    problems: List[str] = []
    parsed = 0
    for e in ooms:
        bundle = e.get("bundle") or ""
        if not bundle:
            problems.append("oom instant without a bundle path")
            continue
        try:
            with open(bundle) as f:
                doc = json.load(f)
        except (OSError, ValueError) as exc:
            problems.append("bundle %s unreadable: %s" % (bundle, exc))
            continue
        missing = [
            k for k in ("error", "census", "plan", "peak_bytes")
            if k not in doc
        ]
        if missing:
            problems.append("bundle %s missing %s" % (bundle, missing))
            continue
        if "RESOURCE_EXHAUSTED" not in str(doc.get("error", "")):
            problems.append(
                "bundle %s error is not an OOM: %r"
                % (bundle, str(doc.get("error", ""))[:80])
            )
            continue
        parsed += 1
    return InvariantResult(
        name,
        parsed >= 1,
        "%d oom instant(s), %d parseable bundle(s)%s"
        % (len(ooms), parsed,
           ("; problems: %s" % "; ".join(problems[:4])) if problems else ""),
    )


# -- scale plane --------------------------------------------------------------


def scale_reconcile_latencies(flight_events: List[Dict]) -> Dict[int, float]:
    """Per decision seq, the decision->restage latency: the scaler's
    fsync'd ``scale_decision`` instant to the FIRST launcher
    ``scale_reconcile`` record carrying the same seq (both wall-clock
    ``ts`` on the same host — the chaos rig runs everything locally)."""
    decided: Dict[int, float] = {}
    for e in flight_events:
        if e.get("event") == "scale_decision" and e.get("seq") is not None:
            decided.setdefault(int(e["seq"]), float(e.get("ts", 0.0)))
    out: Dict[int, float] = {}
    for e in flight_events:
        if e.get("event") != "scale_reconcile" or e.get("seq") is None:
            continue
        seq = int(e["seq"])
        if seq in decided and seq not in out:
            out[seq] = float(e.get("ts", 0.0)) - decided[seq]
    return out


def scale_decision_latency(
    flight_events: List[Dict], budget_s: float
) -> InvariantResult:
    """The scale plane's end-to-end contract: at least one autoscale
    decision was reconciled into a published stage, and every
    reconciled decision closed inside the latency budget."""
    name = "scale_decision_latency"
    lat = scale_reconcile_latencies(flight_events)
    if not lat:
        return InvariantResult(
            name, False, "no scale_decision->scale_reconcile pair recorded"
        )
    worst = max(lat.values())
    return InvariantResult(
        name,
        worst <= budget_s,
        "%d decision(s) reconciled, worst %.1fs (budget %.1fs)"
        % (len(lat), worst, budget_s),
    )


def autoscale_goodput_bounded(
    achieved: float, oracle: float, loss_bound_pct: float
) -> InvariantResult:
    """Scheduler quality vs the offline oracle: the realized world-size
    schedule (publish/drain flight records evaluated under the same
    goodput model and signal trace) must capture at least
    ``100 - loss_bound_pct`` percent of the oracle's integral — the
    oracle re-decides instantly and restages for free, so the loss is
    exactly what hysteresis, cooldown, and restage gaps cost."""
    name = "autoscale_goodput_bounded"
    if oracle <= 0:
        return InvariantResult(name, False, "degenerate oracle (<= 0)")
    loss = 100.0 * (1.0 - achieved / oracle)
    return InvariantResult(
        name,
        loss <= loss_bound_pct,
        "goodput loss %.1f%% vs oracle (bound %.0f%%)"
        % (loss, loss_bound_pct),
    )


def gang_atomic_worlds(
    flight_events: List[Dict], min_world: int
) -> InvariantResult:
    """Gang atomicity: every stage the launcher PUBLISHED for this job
    ran at >= its min world — grow/shrink transitions never stranded
    the collective below its floor (pods held or released, all or
    nothing). Exactly 0 is legal: the pause marker an autoscale
    preempt-to-0 publishes (nobody runs; not a stranded collective)."""
    sizes = [
        int(e.get("pods", 0))
        for e in flight_events
        if e.get("event") == "publish"
    ]
    low = [s for s in sizes if 0 < s < min_world]
    return InvariantResult(
        "gang_atomic_worlds",
        bool(sizes) and not low,
        "%d published stage(s), worlds %s (floor %d)"
        % (len(sizes), sorted(set(sizes)), min_world),
    )


# -- store consistency plane (chaos/consistency.py) ---------------------------


def _consistency_detail(report, *checks: str) -> str:
    bad = report.violations_of(*checks)
    head = "%d ops, %d reads, %d acked writes, %d watch events" % (
        report.ops, report.reads, report.writes_acked,
        report.watch_deliveries,
    )
    if not bad:
        return head
    return "%s; %d violation(s): %s" % (
        head, len(bad),
        "; ".join(v.get("detail", v["check"]) for v in bad[:3]),
    )


def no_stale_reads(report) -> InvariantResult:
    """Every taped read answered with the newest ACKED write at-or-below
    its revision — no stale value, no lost acked write, no value
    mismatch. Vacuous histories fail: a checker that judged nothing
    proves nothing."""
    bad = report.violations_of("stale-read", "value-mismatch")
    ok = not bad and report.reads > 0 and report.writes_acked > 0
    return InvariantResult(
        "no_stale_reads", ok,
        _consistency_detail(report, "stale-read", "value-mismatch"),
    )


def monotonic_session_reads(report) -> InvariantResult:
    """No session watched its own history rewind: per session, a key's
    observed revision never decreased, nothing observed vanished without
    an acked delete, and no read answered below the session floor — even
    with reads hopping between standby leg and primary, across the
    failover."""
    bad = report.violations_of("non-monotonic-session")
    ok = not bad and report.reads > 0
    return InvariantResult(
        "monotonic_session_reads", ok,
        _consistency_detail(report, "non-monotonic-session"),
    )


def watch_gap_free(report) -> InvariantResult:
    """Every taped watch delivered acked writes exactly once in strictly
    increasing revision order — no duplicate, no reorder, no silent gap
    (an honest ``resync`` marker is the one sanctioned gap)."""
    bad = report.violations_of("watch-gap", "watch-duplicate", "watch-order")
    ok = not bad and report.watch_deliveries > 0
    return InvariantResult(
        "watch_gap_free", ok,
        _consistency_detail(
            report, "watch-gap", "watch-duplicate", "watch-order"
        ),
    )


def consistency_anomaly_reproduced(report) -> InvariantResult:
    """RED drill: the checker must CATCH the anomaly the degraded
    configuration (EDL_STORE_MVCC=0, kill inside the semi-sync window)
    provably produces — a checker that stays green here checks
    nothing."""
    ok = bool(report.violations)
    return InvariantResult(
        "consistency_anomaly_reproduced", ok,
        report.summary(),
    )
