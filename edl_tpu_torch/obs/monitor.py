"""Monitor plane: scrape-and-retain time series + SLO rule engine.

Every process has a ``/metrics`` endpoint and the goodput ledger prices
every second of wall-clock — but nothing *watched* the measurements:
``edl-top`` renders the latest scrape and forgets it. This module is the
sensor half of closing the loop: a :class:`Monitor` discovers every
scrape target from the job's ``obs/`` store keyspace (the same
discovery ``edl-top`` uses), scrapes on an interval, **retains** the
samples — in memory for rule evaluation and, when ``monitor_dir`` /
``EDL_MONITOR_DIR`` is set, as crash-safe append-only ring segments
(``*.series.jsonl``, the :class:`~edl_tpu_torch.obs.events.FlightRecorder`
design under a monitor-owned suffix) — and evaluates a declarative rule
set over the retained window. A goodput-driven autoscaler only has to
subscribe to the alerts this plane publishes; it never scrapes anything
itself.

Rule kinds (see :class:`Rule`):

- ``threshold`` — latest value per target violates ``op value``
  (``edl_goodput_ratio < 0.7``), sustained ``for_s`` seconds;
- ``rate``      — the job-level per-second increase of a counter over
  ``window_s`` violates ``op value``
  (``rate(edl_launch_straggler_ejections_total) > 0``); with
  ``require_advance`` the rule arms only after the series has been seen
  advancing, so a job that never trained cannot "degrade";
- ``quantile``  — quantile ``q`` of a histogram's *windowed delta*
  (observations added during the window) violates ``op value`` — the
  staleness rule over ``edl_train_step_heartbeat_age_seconds`` rides the
  shared :func:`~edl_tpu_torch.obs.metrics.histogram_quantile` grid math;
- ``absent``    — a target that has been scraped alive before has been
  silent for more than ``stale_s`` (dead endpoint);
- ``restart``   — a target's ``edl_process_start_time_seconds`` jumped
  between samples: the process behind the registration was replaced —
  distinguishing a *restarted* process from a *wedged* one (whose start
  time is stable while its heartbeats go silent);
- ``zscore``    — the target's newest value sits ``op value`` standard
  deviations from the trailing window history (consecutive duplicate
  scrapes of a throttled gauge deduped, std floored at 5% of the mean's
  magnitude, at least 6 distinct finite points required, a non-finite
  newest value reads as an unbounded z) — the ``loss-spike`` detector;
  blind or flat windows never fire.

Firing semantics are hysteresis-bounded: a rule must hold continuously
for ``for_s`` before it fires and be clear for ``resolve_s`` before it
resolves. Every transition publishes an alert record to the store's
``alerts/{rule}`` keyspace (severity, firing/resolved, evidence
samples, full firing history), increments
``edl_monitor_alerts_total{rule,severity}``, and is flight-recorded so
``edl-timeline`` overlays alert transitions on the goodput lanes. A job
whose ``job/status`` key reads COMPLETE is *done, not degraded*: the
monitor suppresses evaluation and resolves anything still firing —
completion must never page anyone.

Run it: ``python -m edl_tpu_torch.tools.edl_monitord --store HOST:PORT --job ID``.
Conformance: the chaos rig runs a Monitor inside every scenario;
``worker-kill``/``preempt-drain`` must fire ``goodput-degraded`` within
a bounded latency and the ``monitor-clean`` control run must fire
nothing (``alerts_fired`` / ``no_false_alerts`` invariants).

The port's copy of ``edl_tpu/obs/monitor.py``: the same rules, ring
segments, ``alerts/{rule}`` records and ``edl_monitor_*`` metrics, so a
port monitor judges a JAX job and the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("obs.monitor")

ALERTS_SERVICE = "alerts"
ENV_DIR = "EDL_MONITOR_DIR"
SERIES_SUFFIX = ".series.jsonl"
SELF_TARGET = "monitor"
_OPS: Dict[str, Callable[[float, float], bool]] = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}
_KINDS = ("threshold", "rate", "quantile", "absent", "restart", "zscore")
_ZSCORE_MIN_POINTS = 6  # distinct finite history points before a z is trusted
_FIRINGS_KEPT = 32  # firing timestamps retained in the published record


def alerts_prefix(job_id: str) -> str:
    return "/%s/%s/" % (job_id, ALERTS_SERVICE)


def read_alerts(client, job_id: str) -> Dict[str, Dict]:
    """Read back ``{rule: alert-record}`` for a job (empty dict when the
    monitor never fired anything — records exist only after a first
    firing)."""
    out: Dict[str, Dict] = {}
    prefix = alerts_prefix(job_id)
    try:
        rows, _rev = client.range(prefix)
    except Exception as exc:  # noqa: BLE001 — a dead store reads as no alerts
        logger.warning("alert read failed: %s", exc)
        return out
    for key, value, _c, _m in rows:
        try:
            out[key[len(prefix):]] = json.loads(value)
        except ValueError:
            continue
    return out


@dataclasses.dataclass
class Rule:
    """One declarative SLO rule (see the module docstring for kinds)."""

    name: str
    kind: str = "threshold"
    metric: str = ""         # series the rule watches ("" for absent rules)
    labels: str = ""         # label substring filter, e.g. 'state="train"'
    op: str = "<"
    value: float = 0.0
    q: float = 0.95          # quantile rules
    for_s: float = 0.0       # condition must hold this long before firing
    resolve_s: float = 0.0   # condition must clear this long before resolving
    window_s: float = 60.0   # rate/quantile evaluation window
    stale_s: float = 30.0    # absent rules: silence bound
    forget_s: float = 0.0    # absent rules: silence after which a target is
    #                          RETIRED (a legitimate departure — downsize,
    #                          graceful drain — must not page forever);
    #                          0 = 20 * stale_s
    target: str = ""         # substring filter on target names ("" = all)
    severity: str = "warning"
    require_advance: bool = False  # rate rules: arm only after the series moved

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(
                "rule %r: unknown kind %r (have: %s)"
                % (self.name, self.kind, ", ".join(_KINDS))
            )
        if self.op not in _OPS:
            raise ValueError(
                "rule %r: unknown op %r (have: %s)"
                % (self.name, self.op, ", ".join(_OPS))
            )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, doc: Dict) -> "Rule":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(doc) - fields)
        if unknown:
            raise ValueError("rule %r: unknown keys %s" % (doc.get("name"), unknown))
        if "name" not in doc:
            raise ValueError("rule without a name: %r" % (doc,))
        return cls(**doc)


def builtin_rules() -> List[Rule]:
    """The built-in rule pack: the signals a goodput-driven autoscaler
    needs, with production-paced defaults (the chaos rig re-paces them
    for CPU-rig time budgets). Every rule's metric must have a DESIGN.md
    catalogue row — lint-enforced by tests/test_monitor.py."""
    return [
        Rule(
            "goodput-degraded", kind="rate",
            metric="edl_goodput_seconds_total", labels='state="train"',
            op="<", value=0.05, window_s=30.0, for_s=30.0,
            severity="critical", require_advance=True,
        ),
        Rule(
            # the on-device twin of goodput-degraded: goodput prices
            # SECONDS, this rule prices WORK — a job whose cost-model
            # FLOP dispatch rate collapsed after having dispatched is
            # stepping uselessly (or not at all) even if wall-clock
            # still reads "train". The profiling plane's auto-capture
            # answers the firing with an on-device trace of the window.
            "mfu-degraded", kind="rate",
            metric="edl_train_flops_total",
            op="<", value=1.0, window_s=30.0, for_s=30.0,
            severity="warning", require_advance=True,
        ),
        Rule(
            "straggler-ejections", kind="rate",
            metric="edl_launch_straggler_ejections_total",
            op=">", value=0.0, window_s=120.0, severity="warning",
        ),
        Rule(
            "replication-lag", kind="threshold",
            metric="edl_store_replication_lag_entries",
            op=">", value=64.0, for_s=15.0, severity="warning",
        ),
        Rule(
            # the semi-sync escape hatch engaged: a primary is acking
            # commits WITHOUT standby durability (standby too slow or
            # its link dead) — the exact loss window semi-sync exists
            # to close is open again, and store-failover is no longer
            # lossless until the standby catches back up
            "repl-sync-degraded", kind="rate",
            metric="edl_store_repl_sync_degraded_total",
            op=">", value=0.0, window_s=120.0, severity="warning",
        ),
        Rule(
            "ckpt-restore-fallbacks", kind="rate",
            metric="edl_ckpt_restore_fallbacks_total",
            op=">", value=0.0, window_s=120.0, severity="warning",
        ),
        Rule(
            # the peer-replication plane's freshness signal: the saver
            # is accruing checkpoints its peers do not hold — lose this
            # pod now and recovery falls to the durable backstop with
            # that many steps of extra lost work. Fires on sustained
            # lag only (a push in flight right after a save is normal).
            "ckpt-replica-stale", kind="threshold",
            metric="edl_ckpt_replica_lag_steps",
            op=">", value=8.0, for_s=60.0, severity="warning",
        ),
        Rule(
            "distill-queue-saturated", kind="threshold",
            metric="edl_distill_task_queue_depth",
            op=">=", value=64.0, for_s=15.0, severity="warning",
        ),
        Rule(
            # the serving plane's overload signal: teachers refusing
            # work at a sustained rate. Occasional sheds are the
            # admission test doing its job under a burst; a sustained
            # rate means offered load exceeds fleet capacity and the
            # autoscaler (or the operator) owes the fleet teachers.
            # require_advance: the counter registers at 0 with the
            # first served request — only real sheds arm the window.
            "serve-shed-rate", kind="rate",
            metric="edl_distill_shed_total",
            op=">", value=1.0, window_s=60.0, for_s=30.0,
            severity="warning", require_advance=True,
        ),
        Rule(
            # a client-side circuit breaker is OPEN on some teacher:
            # that teacher is dead or shedding everything it is offered
            # (the gauge carries the teacher endpoint as a label). The
            # breaker already routed traffic away — this rule is the
            # operator-facing "a teacher needs replacing" signal, so it
            # fires on sustained openings, not a half-open flap.
            "breaker-open", kind="threshold",
            metric="edl_distill_breaker_open",
            op=">=", value=1.0, for_s=10.0, severity="warning",
        ),
        Rule("dead-endpoint", kind="absent", stale_s=30.0, severity="warning"),
        Rule(
            "heartbeat-stale", kind="quantile",
            metric="edl_train_step_heartbeat_age_seconds", q=0.95,
            op=">", value=30.0, window_s=60.0, severity="critical",
        ),
        Rule(
            "restart-detected", kind="restart",
            metric="edl_process_start_time_seconds",
            resolve_s=10.0, severity="info",
        ),
        Rule(
            "telemetry-dropped-keys", kind="rate",
            metric="edl_obs_telemetry_dropped_keys_total",
            op=">", value=0.0, window_s=120.0, severity="warning",
        ),
        Rule(
            # the numerics plane's tripwire: ANY non-finite element in
            # gradients or loss is corruption, never noise — the counter
            # registers at 0 with the first real publish, so the 0 -> N
            # jump is always visible to the rate window
            "nan-detected", kind="rate",
            metric="edl_train_nonfinite_total",
            op=">", value=0.0, window_s=60.0, severity="critical",
        ),
        Rule(
            # windowed z-score of the published loss vs its trailing
            # history: a divergence/corruption spike fires, a healthy
            # monotone descent never does (z stays negative)
            "loss-spike", kind="zscore",
            metric="edl_train_loss",
            op=">", value=4.0, window_s=120.0, severity="critical",
        ),
        Rule(
            # dp replicas publishing different param digests AT THE SAME
            # STEP are not training the same model: a lost broadcast or
            # resharding bug, sustained (one laggy publish is normal)
            "replica-divergence", kind="threshold",
            metric="edl_train_replica_divergence",
            op=">", value=1e-3, for_s=10.0, severity="critical",
        ),
        Rule(
            # the optimizer stopped moving: a gradient norm at zero for
            # a sustained window means dead inputs or a wedged optimizer
            # (the gauge only exists once real steps published, so a
            # compiling job cannot false-fire)
            "grad-stall", kind="threshold",
            metric="edl_train_grad_norm",
            op="<", value=1e-9, for_s=60.0, severity="warning",
        ),
        Rule(
            # the scale plane's flap detector: autoscale-caused drains
            # at a sustained rate mean the controller is thrashing —
            # oscillating world sizes burn restage time the decisions
            # were supposed to buy back. Hysteresis/cooldown in the
            # decision engine should keep this silent; firing is a
            # controller-tuning bug, not weather. require_advance keeps
            # a freshly-registered counter from arming the window.
            "autoscale-thrash", kind="rate",
            metric="edl_launch_drains_total", labels='cause="autoscale"',
            op=">", value=0.05, window_s=120.0, for_s=60.0,
            severity="warning", require_advance=True,
        ),
        Rule(
            # the AOT resize ladder's regression signal: the histogram
            # only gains observations when a cache MISS forces a real
            # XLA compile, so a quiet window is speculation working and
            # a fat p95 after a restage is speculation MISSING (ladder
            # off, portable keys broken, exchange unreachable). Blind
            # windows never fire — a job that never recompiles is the
            # goal state, not a gap.
            "restage-compile-regression", kind="quantile",
            metric="edl_train_restage_compile_seconds", q=0.95,
            op=">", value=5.0, window_s=120.0, severity="warning",
        ),
        Rule(
            # the memory plane's early-warning twin of oom-detected:
            # sustained residency above 92% of the device limit is the
            # regime where one transient (resharding double-buffer, an
            # eval batch) tips into RESOURCE_EXHAUSTED. for_s keeps a
            # harvest-time spike from paging; resolve_s keeps the alert
            # from flapping as the allocator hovers at the line.
            "hbm-pressure", kind="threshold",
            metric="edl_device_hbm_utilization_ratio",
            op=">", value=0.92, for_s=20.0, resolve_s=30.0,
            severity="warning",
        ),
        Rule(
            # an OOM is never weather: the step dispatcher's forensics
            # guard counts each RESOURCE_EXHAUSTED it intercepts, and a
            # single one must page IMMEDIATELY (for_s=0) — the evidence
            # bundle is already on disk, the job is restaging, and the
            # operator owes the plan a smaller world or a bigger margin.
            "oom-detected", kind="rate",
            metric="edl_train_oom_total",
            op=">", value=0.0, window_s=60.0, severity="critical",
        ),
        Rule(
            # donate_argnums silently dropped by XLA (plan shows zero
            # aliased bytes): the state is resident TWICE — peak HBM is
            # a full state-size above what the author believes
            "donation-dropped", kind="rate",
            metric="edl_train_donation_dropped_total",
            op=">", value=0.0, window_s=120.0, severity="warning",
        ),
    ]


def rules_from_json(text: str, base: Optional[List[Rule]] = None) -> List[Rule]:
    """Parse a JSON rule list; with ``base`` given, entries override
    same-named base rules (field-wise) and new names append — so a
    deployment can re-pace one built-in rule without restating the pack."""
    docs = json.loads(text)
    if not isinstance(docs, list):
        raise ValueError("rule file must be a JSON list of rule objects")
    if base is None:
        return [Rule.from_dict(d) for d in docs]
    rules = {r.name: r for r in base}
    order = [r.name for r in base]
    for doc in docs:
        name = doc.get("name")
        if name in rules:
            merged = rules[name].to_dict()
            merged.update(doc)
            rules[name] = Rule.from_dict(merged)
        else:
            rules[name] = Rule.from_dict(doc)
            order.append(name)
    return [rules[n] for n in order]


class _RuleState:
    """Hysteresis + history for one rule."""

    __slots__ = (
        "pending_since", "last_true", "firing", "firing_since",
        "fired_count", "first_fired_ts", "firings", "resolved_ts",
        "seen_advance", "bearers", "start_times", "last_restart_ts",
    )

    def __init__(self) -> None:
        self.pending_since: Optional[float] = None
        self.last_true: Optional[float] = None
        self.firing = False
        self.firing_since: Optional[float] = None
        self.fired_count = 0
        self.first_fired_ts: Optional[float] = None
        self.firings: List[float] = []
        self.resolved_ts: Optional[float] = None
        self.seen_advance = False           # rate rules: require_advance arm
        self.bearers: Dict[str, float] = {}  # rate rules: target -> last ts it bore the series
        self.start_times: Dict[str, float] = {}  # restart rules, per target
        self.last_restart_ts: Optional[float] = None


def _series_sum(
    series: Dict[str, Dict[str, float]], metric: str, label_substr: str
) -> Optional[float]:
    """Sum of every label set of ``metric`` containing ``label_substr``;
    None when the scrape has no matching series at all."""
    found = False
    total = 0.0
    for labels, value in series.get(metric, {}).items():
        if label_substr in labels:
            total += value
            found = True
    return total if found else None


def _latest_value(
    samples: List[Dict], metric: str, label_substr: str
) -> Optional[Tuple[float, float]]:
    """The newest live ``(ts, value)`` of a series in one target's
    window (threshold and restart rules share this scan)."""
    for s in reversed(samples):
        if s["up"]:
            v = _series_sum(s["series"], metric, label_substr)
            if v is not None:
                return s["ts"], v
    return None


class Monitor:
    """Scrape, retain, evaluate, alert — one instance per watched job.

    Headless-friendly: with ``store=None`` the engine runs on samples
    fed through :meth:`ingest` and transitions returned by
    :meth:`evaluate` (the decision-table tests drive it this way);
    with a store it discovers, scrapes and publishes end to end.
    """

    def __init__(
        self,
        store,
        job_id: str,
        rules: Optional[List[Rule]] = None,
        interval: float = 5.0,
        retention_s: float = 300.0,
        monitor_dir: Optional[str] = None,
        registry: Optional[obs_metrics.MetricsRegistry] = None,
        scrape_timeout: float = 1.0,
        collect_telemetry: bool = True,
        on_fire: Optional[Callable[[Rule, Dict], None]] = None,
    ) -> None:
        self.job_id = job_id
        self.rules = list(rules) if rules is not None else builtin_rules()
        names = [r.name for r in self.rules]
        if len(names) != len(set(names)):
            raise ValueError("duplicate rule names: %s" % sorted(names))
        self.interval = interval
        self.retention_s = retention_s
        self.scrape_timeout = scrape_timeout
        self.collect_telemetry = collect_telemetry
        # action hooks: each called (rule, alert-record) on every FIRING
        # transition — e.g. obs.profile.AutoCapture requesting an
        # on-device trace of the degraded window, or the scale plane
        # penalizing a degraded job's allocation. A registry, not a
        # single slot: subscribers coexist (add_on_fire) instead of
        # clobbering each other. Exception-contained per hook: one
        # failing action must never stop the sensor OR its peers.
        self._on_fire_hooks: List[Callable[[Rule, Dict], None]] = []
        if on_fire is not None:
            self._on_fire_hooks.append(on_fire)
        self._registry = registry if registry is not None else obs_metrics.default_registry()
        self._m_scrapes = self._registry.counter(
            "edl_monitor_scrapes_total", "scrape attempts, by outcome"
        )
        self._m_alerts = self._registry.counter(
            "edl_monitor_alerts_total", "alert firings, by rule and severity"
        )
        self._m_firing = self._registry.gauge(
            "edl_monitor_rules_firing", "rules currently in the firing state"
        )
        self._m_up = self._registry.gauge(
            "edl_monitor_targets_up", "scrape targets alive at the last sweep"
        )
        self._owns_client = False
        self._client = None
        if store is not None:
            if isinstance(store, str):
                from edl_tpu_torch.store.client import connect_store

                self._client = connect_store(store, timeout=5.0)
                self._owns_client = True
            else:
                self._client = store
        self._lock = threading.Lock()
        self._window: Dict[str, List[Dict]] = {}   # target -> samples
        self._last_up: Dict[str, float] = {}
        self._ever_up: Dict[str, float] = {}       # target -> first-up ts
        self._state: Dict[str, _RuleState] = {r.name: _RuleState() for r in self.rules}
        self._complete = False
        self._last_telemetry = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # scrape pool, created once and reused per sweep; _lock-guarded:
        # stop() tears it down on the caller's thread while the sweep
        # thread lazily creates/uses it
        self._pool = None  # edl: guarded-by(self._lock)
        self._series_writer: Optional[obs_events.FlightRecorder] = None
        self._alert_recorder: Optional[obs_events.FlightRecorder] = None
        if monitor_dir:
            self._warm_start(monitor_dir)
            self._series_writer = obs_events.FlightRecorder(
                monitor_dir, component="series", suffix=SERIES_SUFFIX
            )
            self._alert_recorder = obs_events.FlightRecorder(
                monitor_dir, component="monitor"
            )

    # -- firing-action hooks -----------------------------------------------

    @property
    def on_fire(self) -> Optional[Callable[[Rule, Dict], None]]:
        """Back-compat view of the hook registry: the first subscriber
        (or None). Assigning REPLACES the registry — a sole-owner idiom;
        subscribers that must coexist use :meth:`add_on_fire`."""
        return self._on_fire_hooks[0] if self._on_fire_hooks else None

    @on_fire.setter
    def on_fire(self, fn: Optional[Callable[[Rule, Dict], None]]) -> None:
        self._on_fire_hooks = [fn] if fn is not None else []

    def add_on_fire(
        self, fn: Callable[[Rule, Dict], None]
    ) -> Callable[[Rule, Dict], None]:
        """Subscribe a firing-action hook; returns ``fn`` so callers can
        keep the handle for :meth:`remove_on_fire`."""
        self._on_fire_hooks.append(fn)
        return fn

    def remove_on_fire(self, fn: Callable[[Rule, Dict], None]) -> None:
        """Unsubscribe a hook; absent hooks are ignored."""
        try:
            self._on_fire_hooks.remove(fn)
        except ValueError:
            pass

    # -- retention ---------------------------------------------------------

    def _warm_start(self, monitor_dir: str) -> None:
        """Reload the retained window from the ring segments a previous
        monitor incarnation left behind: a restarted monitor resumes its
        rate/staleness windows instead of going blind (rule hysteresis
        state itself restarts pending — firing again is the safe side)."""
        horizon = time.time() - self.retention_s
        warmed = 0
        for doc in obs_events.read_segments(monitor_dir, suffix=SERIES_SUFFIX):
            if doc.get("event") != "sample" or doc.get("ts", 0.0) < horizon:
                continue
            self.ingest(
                str(doc.get("target", "?")),
                doc.get("series") or {},
                up=bool(doc.get("up")),
                ts=float(doc["ts"]),
                _persist=False,
            )
            warmed += 1
        if warmed:
            logger.info("monitor warm-started with %d retained samples", warmed)

    def ingest(
        self,
        target: str,
        series: Dict[str, Dict[str, float]],
        up: bool = True,
        ts: Optional[float] = None,
        _persist: bool = True,
    ) -> None:
        """Retain one observation of one target (``series`` in the
        ``fetch_metrics`` shape; ``up=False`` records a failed probe)."""
        now = ts if ts is not None else time.time()
        sample = {"ts": now, "up": up, "series": series}
        with self._lock:
            window = self._window.setdefault(target, [])
            window.append(sample)
            horizon = now - self.retention_s
            while window and window[0]["ts"] < horizon:
                window.pop(0)
            if up:
                self._last_up[target] = max(self._last_up.get(target, 0.0), now)
                self._ever_up.setdefault(target, now)
        if _persist and self._series_writer is not None:
            self._series_writer.record(
                "sample", target=target, up=up, series=series
            )

    # -- evaluation --------------------------------------------------------

    def _window_for(
        self, rule: Rule, now: float
    ) -> Dict[str, List[Dict]]:
        horizon = now - rule.window_s
        with self._lock:
            return {
                t: [s for s in w if s["ts"] >= horizon]
                for t, w in self._window.items()
                if rule.target in t
            }

    def _eval_threshold(
        self, rule: Rule, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        worst: Optional[float] = None
        evidence: List[Dict] = []
        for target, samples in self._window_for(rule, now).items():
            latest = _latest_value(samples, rule.metric, rule.labels)
            if latest is None:
                continue
            ts, v = latest
            if _OPS[rule.op](v, rule.value):
                evidence.append({"target": target, "value": v, "ts": ts})
            if worst is None or _OPS[rule.op](v, worst):
                worst = v
        return bool(evidence), worst, evidence

    def _eval_rate(
        self, rule: Rule, state: _RuleState, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        windows = self._window_for(rule, now)
        up_ts = [
            s["ts"] for w in windows.values() for s in w if s["up"]
        ]
        if len(up_ts) < 2:
            return False, None, []  # blind window: never alert on no data
        span = max(up_ts) - min(up_ts)
        if span < 0.5 * rule.window_s:
            return False, None, []  # a window still filling proves nothing
        increase = 0.0
        advancing: List[Dict] = []
        for target, samples in windows.items():
            seen = [
                (s["ts"], v) for s in samples if s["up"]
                for v in (_series_sum(s["series"], rule.metric, rule.labels),)
                if v is not None
            ]
            if not seen:
                continue
            state.bearers[target] = max(state.bearers.get(target, 0.0), seen[-1][0])
            first, last = seen[0][1], seen[-1][1]
            # a counter that went BACKWARDS restarted: its new value is
            # the whole post-restart increase
            inc = last - first if last >= first else last
            if inc > 0:
                increase += inc
                advancing.append({"target": target, "value": inc, "ts": seen[-1][0]})
        if increase > 0:
            state.seen_advance = True
        if rule.require_advance and not state.seen_advance:
            return False, None, []
        rate = increase / span if span > 0 else 0.0
        if rule.op in ("<", "<="):
            # a too-LOW rate indicts the series' RECENT bearers that went
            # flat or silent, not whoever still advanced — and a target
            # that stopped bearing long ago (a downsized worker from
            # hours back) is history, not a culprit
            moved = {e["target"] for e in advancing}
            horizon = now - max(10.0 * rule.window_s, 60.0)
            evidence = [
                {"target": t, "value": 0.0, "ts": now}
                for t in sorted(state.bearers)
                if t not in moved and state.bearers[t] >= horizon
            ]
        else:
            evidence = advancing
        return _OPS[rule.op](rate, rule.value), rate, evidence

    def _eval_quantile(
        self, rule: Rule, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        bucket = rule.metric + "_bucket"
        agg: Dict[float, float] = {}
        evidence: List[Dict] = []
        for target, samples in self._window_for(rule, now).items():
            grids = [
                (s["ts"], obs_metrics.bucket_grid(s["series"][bucket], rule.labels))
                for s in samples
                if s["up"] and bucket in s["series"]
            ]
            if len(grids) < 2:
                continue
            first, last = grids[0][1], grids[-1][1]
            added = 0.0
            for le, cum in last.items():
                delta = max(0.0, cum - first.get(le, 0.0))
                agg[le] = agg.get(le, 0.0) + delta
                if le == float("inf"):
                    added = delta
            if added > 0:
                evidence.append({"target": target, "value": added, "ts": grids[-1][0]})
        qv = obs_metrics.quantile_from_grid(agg, rule.q)
        if qv is None:
            return False, None, []  # no new observations: nothing to judge
        return _OPS[rule.op](qv, rule.value), qv, evidence

    def _eval_absent(
        self, rule: Rule, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        evidence: List[Dict] = []
        worst = 0.0
        forget_after = rule.forget_s or 20.0 * rule.stale_s
        with self._lock:
            targets = {
                t: self._last_up[t]
                for t in self._ever_up
                if rule.target in t and t != SELF_TARGET
            }
        for target, last_up in targets.items():
            silent = now - last_up
            if silent > forget_after:
                # obs registrations are permanent keys, so a legitimate
                # permanent departure (downsize, graceful drain) would
                # otherwise page for the rest of the job: after 20x the
                # stale bound the target is RETIRED — the alert stood
                # long enough to be seen, and a comeback on the same key
                # re-registers as up on the next sweep
                with self._lock:
                    self._ever_up.pop(target, None)
                    self._last_up.pop(target, None)
                continue
            if silent > rule.stale_s:
                evidence.append({"target": target, "value": silent, "ts": last_up})
                worst = max(worst, silent)
        return bool(evidence), (worst if evidence else None), evidence

    def _eval_restart(
        self, rule: Rule, state: _RuleState, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        evidence: List[Dict] = []
        for target, samples in self._window_for(rule, now).items():
            latest = _latest_value(samples, rule.metric, rule.labels)
            if latest is None:
                continue
            prev = state.start_times.get(target)
            state.start_times[target] = latest[1]
            if prev is not None and abs(latest[1] - prev) > 1.0:
                state.last_restart_ts = now
                evidence.append(
                    {"target": target, "value": latest[1] - prev, "ts": latest[0]}
                )
        # a restart is an event: condition holds for resolve_s after the
        # last observed jump, then the alert resolves itself
        hold = max(rule.resolve_s, 2 * self.interval)
        cond = (
            state.last_restart_ts is not None
            and now - state.last_restart_ts <= hold
        )
        return cond, (evidence[0]["value"] if evidence else None), evidence

    def _eval_zscore(
        self, rule: Rule, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        worst: Optional[float] = None
        evidence: List[Dict] = []
        for target, samples in self._window_for(rule, now).items():
            seen = [
                (s["ts"], v) for s in samples if s["up"]
                for v in (_series_sum(s["series"], rule.metric, rule.labels),)
                if v is not None
            ]
            # a throttled gauge re-scraped between publishes repeats its
            # value; keeping the duplicates would shrink the trailing std
            # toward zero and make ordinary drift look like a spike
            dedup: List[Tuple[float, float]] = []
            for ts, v in seen:
                if not dedup or v != dedup[-1][1]:
                    dedup.append((ts, v))
            if len(dedup) < _ZSCORE_MIN_POINTS + 1:
                continue  # blind/flat window: nothing to judge
            ts, newest = dedup[-1]
            hist = [v for _, v in dedup[:-1] if math.isfinite(v)]
            if len(hist) < _ZSCORE_MIN_POINTS:
                continue
            mean = sum(hist) / len(hist)
            var = sum((v - mean) ** 2 for v in hist) / len(hist)
            # std floor: a near-constant history (converged loss) must
            # not turn ordinary jitter into an unbounded z
            std = max(math.sqrt(var), 0.05 * abs(mean), 1e-12)
            # a non-finite newest value is an unbounded spike; 1e30, not
            # inf, keeps the published alert record strict-JSON-safe
            z = (newest - mean) / std if math.isfinite(newest) else 1e30
            if _OPS[rule.op](z, rule.value):
                evidence.append({"target": target, "value": z, "ts": ts})
            if worst is None or _OPS[rule.op](z, worst):
                worst = z
        return bool(evidence), worst, evidence

    def _evaluate_rule(
        self, rule: Rule, state: _RuleState, now: float
    ) -> Tuple[bool, Optional[float], List[Dict]]:
        if rule.kind == "threshold":
            return self._eval_threshold(rule, now)
        if rule.kind == "rate":
            return self._eval_rate(rule, state, now)
        if rule.kind == "quantile":
            return self._eval_quantile(rule, now)
        if rule.kind == "absent":
            return self._eval_absent(rule, now)
        if rule.kind == "zscore":
            return self._eval_zscore(rule, now)
        return self._eval_restart(rule, state, now)

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """One evaluation pass over every rule; returns the transitions
        (the published alert records) this pass produced."""
        now = time.time() if now is None else now
        transitions: List[Dict] = []
        for rule in self.rules:
            state = self._state[rule.name]
            try:
                cond, value, evidence = self._evaluate_rule(rule, state, now)
            except Exception as exc:  # noqa: BLE001 — one bad rule must not stop the plane
                logger.warning("rule %s evaluation failed: %s", rule.name, exc)
                continue
            if self._complete:
                # a COMPLETE job is done, not degraded: suppress firing
                # and resolve anything still open
                cond = False
            if cond:
                state.last_true = now
                if state.pending_since is None:
                    state.pending_since = now
                if not state.firing and now - state.pending_since >= rule.for_s:
                    transitions.append(
                        self._transition(rule, state, now, "firing", value, evidence)
                    )
            else:
                state.pending_since = None
                if state.firing and (
                    state.last_true is None
                    or now - state.last_true >= rule.resolve_s
                ):
                    transitions.append(
                        self._transition(rule, state, now, "resolved", value, evidence)
                    )
        self._m_firing.set(sum(1 for s in self._state.values() if s.firing))
        return transitions

    def _transition(
        self,
        rule: Rule,
        state: _RuleState,
        now: float,
        to: str,
        value: Optional[float],
        evidence: List[Dict],
    ) -> Dict:
        if to == "firing":
            state.firing = True
            state.firing_since = now
            state.fired_count += 1
            if state.first_fired_ts is None:
                state.first_fired_ts = now
            state.firings.append(now)
            del state.firings[:-_FIRINGS_KEPT]
            self._m_alerts.inc(rule=rule.name, severity=rule.severity)
            logger.warning(
                "ALERT %s [%s] firing: value=%s targets=%s",
                rule.name, rule.severity, value,
                [e.get("target") for e in evidence[:4]],
            )
        else:
            state.firing = False
            state.resolved_ts = now
            logger.info("alert %s resolved", rule.name)
        doc = {
            "rule": rule.name,
            "severity": rule.severity,
            "state": to,
            "ts": now,
            "since": state.firing_since,
            "resolved_ts": state.resolved_ts,
            "value": value,
            "fired_count": state.fired_count,
            "first_fired_ts": state.first_fired_ts,
            "firings": list(state.firings),
            "evidence": evidence[:8],
            "job_complete": self._complete,
        }
        self._publish(rule, doc)
        if to == "firing":
            for hook in list(self._on_fire_hooks):
                try:
                    hook(rule, doc)
                except Exception as exc:  # noqa: BLE001 — actions must not stop the sensor or each other
                    logger.warning(
                        "on_fire action for %s failed: %s", rule.name, exc
                    )
        rec = self._alert_recorder
        fields = dict(
            rule=rule.name, state=to, severity=rule.severity,
            value=value, fired_count=state.fired_count,
        )
        if rec is not None:
            rec.record("alert", fsync=True, **fields)
        else:
            obs_events.record("alert", fsync=True, **fields)
        return doc

    def _publish(self, rule: Rule, doc: Dict) -> None:
        if self._client is None:
            return
        key = alerts_prefix(self.job_id) + rule.name
        try:  # fire-and-forget, like every telemetry writer
            self._client.put(key, json.dumps(doc).encode())
        except Exception as exc:  # noqa: BLE001
            logger.warning("alert %s not published: %s", rule.name, exc)

    # -- the scrape loop ---------------------------------------------------

    def _check_complete(self) -> None:
        if self._complete or self._client is None:
            return
        try:
            value = self._client.get("/%s/job/status" % self.job_id)
        except Exception:  # noqa: BLE001 — store mid-blip: keep last verdict
            return
        if value == b"COMPLETE":
            self._complete = True
            logger.info("job %s COMPLETE: alert evaluation suppressed", self.job_id)

    def poll_once(self) -> List[Dict]:
        """One full sweep: discover, scrape, retain, evaluate. Returns
        the alert transitions the sweep produced."""
        self._check_complete()
        targets: Dict[str, Dict] = {}
        if self._client is not None:
            targets = obs_http.discover_endpoints(self._client, self.job_id)

        def _probe(item):
            name, info = item
            endpoint = info.get("endpoint", "")
            try:
                series = obs_http.fetch_metrics(
                    endpoint, timeout=self.scrape_timeout
                )
                return name, True, series
            except Exception:  # noqa: BLE001 — dead endpoints are data too
                return name, False, {}

        items = sorted(targets.items())
        results = []
        if items:
            with self._lock:
                if self._pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    # one long-lived pool: spawning a fresh executor per
                    # sweep is thread churn the watched job would feel
                    self._pool = ThreadPoolExecutor(
                        max_workers=8,
                        thread_name_prefix="edl-monitor-scrape",
                    )
                pool = self._pool
            # map() outside the lock: a sweep must not hold _lock for
            # eight concurrent scrape round-trips
            results = list(pool.map(_probe, items))
        up_count = 0
        for name, up, series in results:
            self._m_scrapes.inc(outcome="ok" if up else "error")
            up_count += 1 if up else 0
            self.ingest(name, series, up=up)
        self._m_up.set(up_count)
        if (
            self._client is not None
            and self.collect_telemetry
            and time.time() - self._last_telemetry >= max(self.interval, 1.0)
        ):
            # throttled to >= 1s: collect() is three keyspace range scans,
            # and a fast-scraping monitor must not double the store load
            # of the job it watches
            self._last_telemetry = time.time()
            try:
                from edl_tpu_torch.utils import telemetry

                telemetry.collect(self._client, self.job_id)
            except Exception:  # noqa: BLE001 — store mid-fault
                pass
        # the monitor's own registry rides the same path as a scraped
        # endpoint: its edl_monitor_* series (and the scraper-side
        # telemetry drop counter) become rule-visible retained samples
        self.ingest(
            SELF_TARGET, obs_http.parse_metrics_text(self._registry.render())
        )
        return self.evaluate()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — the watcher must outlive faults
                logger.warning("monitor sweep failed: %s", exc)

    def start(self) -> "Monitor":
        self._thread = threading.Thread(
            target=self._loop, name="edl-monitord", daemon=True
        )
        self._thread.start()
        logger.info(
            "monitor watching job %s: %d rules, %.2gs interval",
            self.job_id, len(self.rules), self.interval,
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        if self._series_writer is not None:
            self._series_writer.close()
        if self._alert_recorder is not None:
            self._alert_recorder.close()
        if self._owns_client and self._client is not None:
            self._client.close()
            self._client = None

    # -- introspection -----------------------------------------------------

    @property
    def client(self):
        """The store client this monitor watches through (None when
        headless) — for callers that piggyback on it, e.g. the daemon
        registering its own obs endpoint."""
        return self._client

    def firing(self) -> List[str]:
        return sorted(n for n, s in self._state.items() if s.firing)

    def health(self) -> Dict:
        with self._lock:
            retained = sum(len(w) for w in self._window.values())
            targets = len(self._window)
        return {
            "job": self.job_id,
            "rules": len(self.rules),
            "firing": self.firing(),
            "targets": targets,
            "retained_samples": retained,
            "job_complete": self._complete,
        }
