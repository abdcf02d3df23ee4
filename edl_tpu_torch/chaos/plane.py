"""The fault plane: named fault points compiled into control-plane hot paths.

A *fault point* is a module-level handle declared next to the code it can
break::

    _FP_TX = chaos.fault_point("rpc.wire.tx", "corrupt/delay/drop an outgoing frame")

    def pack_frame(payload):
        if _FP_TX.armed:
            _FP_TX.fire(method=...)          # may sleep, raise, corrupt, or _exit
        ...

Disarmed (the default — no ``EDL_CHAOS`` in the env), the entire plane
costs one attribute load per point per pass: ``armed`` is a plain ``False``
until rules attach, so production hot paths pay nothing measurable.

Armed, a point consults its rules. Rules are matched deterministically:
each rule counts the fires that match its ``match`` context filter and
triggers on the ``after``-th matching fire, for ``times`` consecutive
matching fires, gated by a ``prob`` drawn from a per-rule
``random.Random`` seeded from ``(spec seed, rule index)`` — the same seed
always injects the same faults at the same points in the same order.

Spec (JSON, via ``EDL_CHAOS`` inline / ``@file`` / ``store``)::

    {"seed": 0, "rules": [
        {"point": "train.step", "proc": "worker", "action": "kill",
         "match": {"rank": "1"}, "after": 6},
        {"point": "store.client.request", "proc": "launcher",
         "action": "drop", "after": 30, "times": 20},
        {"point": "store.server.dispatch", "proc": "store",
         "action": "delay", "delay_s": 0.05, "prob": 0.3, "times": 0}]}

Rule fields: ``point`` (required), ``action`` (required), ``proc``
(prefix-match against the arming process's name; absent = every process),
``match`` (ctx equality filter, values compared as strings), ``after``
(1-based matching-fire index, default 1), ``times`` (consecutive
triggers, 0 = unlimited, default 1), ``prob`` (default 1.0), ``delay_s``,
``duration_s`` (partition window), ``exit_code`` (kill, default 137).

Actions:

- ``kill``      ``os._exit(exit_code)`` — a machine death, not a clean exit;
- ``delay``     sleep ``delay_s`` in the caller's thread;
- ``drop``      raise :class:`ChaosDrop` (a ``ConnectionError``) — the
  caller's failure handling sees a dead peer;
- ``corrupt``   flip bits in the ``payload`` bytes handed to ``fire`` (the
  caller sends/uses the corrupted copy);
- ``partition`` like ``drop``, but stays active for ``duration_s`` of
  wall clock after the first trigger (a network partition, not one lost
  frame).

Every injection increments ``edl_chaos_faults_injected_total{point,action}``,
records a trace instant (visible in edl-top and merged Chrome traces), and
— because a ``kill`` takes its process's metrics with it — appends one
line to the crash-safe ``EDL_CHAOS_LOG`` file when set.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

from edl_tpu_torch.utils.log import get_logger

logger = get_logger("chaos.plane")

CHAOS_SERVICE = "chaos"
_KILL_EXIT = 137  # what a SIGKILLed process reports

ACTIONS = ("kill", "delay", "drop", "corrupt", "partition")


class ChaosDrop(ConnectionError):
    """Raised by ``drop``/``partition`` — callers see a dead peer."""


def chaos_prefix(job_id: str) -> str:
    return "/%s/%s/" % (job_id, CHAOS_SERVICE)


class _Rule:
    __slots__ = (
        "point", "action", "proc", "match", "after", "times", "prob",
        "delay_s", "duration_s", "exit_code", "_rng", "_matched",
        "_triggered", "_window_until",
    )

    def __init__(self, spec: Dict, seed: int, index: int) -> None:
        self.point = spec["point"]
        self.action = spec["action"]
        if self.action not in ACTIONS:
            raise ValueError("unknown chaos action %r" % self.action)
        self.proc = spec.get("proc", "")
        self.match = {str(k): str(v) for k, v in (spec.get("match") or {}).items()}
        self.after = int(spec.get("after", 1))
        self.times = int(spec.get("times", 1))  # 0 = unlimited
        self.prob = float(spec.get("prob", 1.0))
        self.delay_s = float(spec.get("delay_s", 0.05))
        self.duration_s = float(spec.get("duration_s", 1.0))
        self.exit_code = int(spec.get("exit_code", _KILL_EXIT))
        # deterministic per-rule stream: same (seed, index) -> same draws
        self._rng = random.Random((seed * 1_000_003 + index) & 0xFFFFFFFF)
        self._matched = 0
        self._triggered = 0
        self._window_until = 0.0

    def applies(self, whos) -> bool:
        """``whos``: the component names armed in this process (a process
        can host several — a launcher with an embedded store)."""
        if not self.proc:
            return True
        return any(w.startswith(self.proc) for w in whos)

    def decide(self, ctx: Dict) -> bool:
        """One matching-fire bookkeeping step; True = inject now."""
        for k, v in self.match.items():
            if str(ctx.get(k)) != v:
                return False
        if self.action == "partition" and time.monotonic() < self._window_until:
            return True  # inside an open window every matching fire drops
        self._matched += 1
        if self._matched < self.after:
            return False
        if self.times and self._triggered >= self.times:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self._triggered += 1
        if self.action == "partition":
            # each trigger opens a fresh window: for partition, ``times``
            # counts WINDOWS (0 = unlimited), not individual drops
            self._window_until = time.monotonic() + self.duration_s
        return True


class FaultPoint:
    """One named place where faults can be injected.

    ``armed`` is False until :func:`configure` attaches a rule, so the
    disabled-plane cost at the call site is a single attribute load.
    """

    __slots__ = ("name", "description", "armed", "_rules", "_lock")

    def __init__(self, name: str, description: str) -> None:
        self.name = name
        self.description = description
        self.armed = False
        self._rules: List[_Rule] = []
        self._lock = threading.Lock()

    def fire(self, payload: Optional[bytes] = None, **ctx):
        """Evaluate rules; may sleep, raise, corrupt ``payload``, or exit.

        Returns ``payload`` (corrupted if a ``corrupt`` rule triggered).
        """
        if not self.armed:
            return payload
        with self._lock:
            hits = [r for r in self._rules if r.decide(ctx)]
        for rule in hits:
            payload = _execute(self, rule, payload, ctx)
        return payload


def _execute(point: FaultPoint, rule: _Rule, payload, ctx):
    _note_injection(point, rule, ctx)
    if rule.action == "delay":
        time.sleep(rule.delay_s)
        return payload
    if rule.action in ("drop", "partition"):
        raise ChaosDrop(
            "chaos: %s at %s" % (rule.action, point.name)
        )
    if rule.action == "corrupt":
        if payload is None:
            raise ChaosDrop("chaos: corrupt at %s (no payload)" % point.name)
        mutable = bytearray(payload)
        for i in range(min(4, len(mutable))):  # header bits: a torn frame
            mutable[i] ^= 0xFF
        return bytes(mutable)
    if rule.action == "kill":
        # flush what we can: the log line above is already on disk
        os._exit(rule.exit_code)
    return payload


def _note_injection(point: FaultPoint, rule: _Rule, ctx: Dict) -> None:
    """Make the injection visible BEFORE the fault executes — a kill must
    not erase its own evidence."""
    log_path = os.environ.get("EDL_CHAOS_LOG")
    if log_path:
        try:
            line = json.dumps(
                {
                    "ts": time.time(),
                    "point": point.name,
                    "action": rule.action,
                    "who": _who,
                    "pid": os.getpid(),
                    "ctx": {k: str(v) for k, v in ctx.items()},
                }
            )
            fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, (line + "\n").encode())
            finally:
                os.close(fd)
        except OSError:
            pass
    try:
        from edl_tpu_torch.obs import metrics as obs_metrics
        from edl_tpu_torch.obs import trace as obs_trace

        obs_metrics.counter(
            "edl_chaos_faults_injected_total",
            "faults injected by the chaos plane, by point and action",
        ).inc(point=point.name, action=rule.action)
        obs_trace.get_tracer().instant(
            "chaos_" + rule.action, point=point.name, **{
                k: str(v) for k, v in ctx.items()
            }
        )
    except Exception:  # noqa: BLE001 — observability must not alter the fault
        pass
    logger.warning(
        "chaos: injecting %s at %s (ctx=%s)", rule.action, point.name, ctx
    )


# -- registry ----------------------------------------------------------------

_points: Dict[str, FaultPoint] = {}
_points_lock = threading.Lock()
_pending: List[_Rule] = []  # rules whose point has not been declared yet
_who = os.environ.get("EDL_CHAOS_PROC", "proc")
# every component name arm_from_env/arm_from_store saw in this process: a
# launcher embedding a store hosts BOTH, and arming the second must not
# silently discard the first's rules (rules match against the whole set)
_armed_whos: set = set()


def fault_point(name: str, description: str) -> FaultPoint:
    """Get-or-create the named fault point (module-import time)."""
    with _points_lock:
        point = _points.get(name)
        if point is None:
            point = _points[name] = FaultPoint(name, description)
            for rule in _pending:
                if rule.point == name:
                    point._rules.append(rule)
            if point._rules:
                point.armed = True
        return point


def points() -> Dict[str, FaultPoint]:
    """Snapshot of every declared fault point (catalogue lint, tools)."""
    with _points_lock:
        return dict(_points)


def configure(spec: Dict, who: Optional[str] = None, extra_whos=()) -> int:
    """Arm the plane from a parsed spec; returns the number of rules that
    apply to this process. Re-configuring replaces all previous rules
    (``arm_from_env``/``arm_from_store`` layer identity accumulation on
    top so co-hosted components don't strip each other's rules)."""
    global _who
    if who:
        _who = who
    whos = {_who, *extra_whos}
    seed = int(spec.get("seed", os.environ.get("EDL_CHAOS_SEED", 0) or 0))
    rules = [
        _Rule(r, seed, i)
        for i, r in enumerate(spec.get("rules", ()))
    ]
    mine = [r for r in rules if r.applies(whos)]
    with _points_lock:
        _pending.clear()
        for point in _points.values():
            point._rules = []
            point.armed = False
        for rule in mine:
            point = _points.get(rule.point)
            if point is None:
                _pending.append(rule)
            else:
                point._rules.append(rule)
                point.armed = True
    if mine:
        logger.warning(
            "chaos plane armed for %r: %d rule(s) [%s]",
            _who, len(mine),
            ", ".join("%s@%s" % (r.action, r.point) for r in mine),
        )
    return len(mine)


def disarm() -> None:
    _armed_whos.clear()
    configure({"rules": []})


def arm_from_env(who: str, client=None, job_id: str = "") -> int:
    """Arm from the ``EDL_CHAOS`` env contract; 0 rules when unset.

    ``EDL_CHAOS`` is inline JSON, ``@/path/to/spec.json``, or ``store``
    (read the job's ``chaos/spec`` key through ``client``). Call sites are
    the long-lived processes' constructors; with the env unset this is a
    dict lookup and a return.
    """
    raw = os.environ.get("EDL_CHAOS", "").strip()
    if not raw:
        return 0
    try:
        if raw == "store":
            if client is None or not job_id:
                logger.warning(
                    "EDL_CHAOS=store but no store client for %r; disarmed", who
                )
                return 0
            return arm_from_store(client, job_id, who)
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                spec = json.load(f)
        else:
            spec = json.loads(raw)
    except (OSError, ValueError) as exc:
        logger.warning("EDL_CHAOS unusable (%s); plane disarmed", exc)
        return 0
    # accumulate: a launcher embedding a store arms twice ('store', then
    # 'launcher'); both identities must keep matching rules
    _armed_whos.add(who)
    return configure(spec, who, extra_whos=_armed_whos)


def arm_from_store(client, job_id: str, who: str) -> int:
    """Arm from the job's ``chaos/spec`` store key (the ``chaos/``
    keyspace lets a running job be attacked without respawning it)."""
    try:
        value = client.get(chaos_prefix(job_id) + "spec")
    except Exception as exc:  # noqa: BLE001 — chaos must not break startup
        logger.warning("chaos spec read failed: %s", exc)
        return 0
    if not value:
        return 0
    try:
        spec = json.loads(value)
    except ValueError as exc:
        logger.warning("chaos spec in store unparseable: %s", exc)
        return 0
    _armed_whos.add(who)
    return configure(spec, who, extra_whos=_armed_whos)


def publish_spec(client, job_id: str, spec: Dict) -> None:
    """Write a spec into the job's ``chaos/`` keyspace (scenario runner)."""
    client.put(chaos_prefix(job_id) + "spec", json.dumps(spec).encode())
