"""Client-side serving resilience: retry budgets, hedged predicts,
per-teacher circuit breakers (Dean & Barroso, *The Tail at Scale*).

These primitives are shared by the two client paths of the distill
plane — the training pipeline (:mod:`edl_tpu_torch.distill.worker`, which may
never drop a batch and so converts every failure into a bounded retry or
a re-queue) and the serving-style load driver (the JAX package's
``distill/slo.py``, not yet in this package, which records an explicit
shed/timeout verdict instead). Three ideas, one invariant each:

- :class:`FractionBudget` — secondary work (retries, hedges) is earned
  by primary work at a fixed fraction, never granted per-call. A fleet
  of workers cannot retry-storm a sick teacher *by construction*: with
  ratio ``r`` and burst ``b``, secondaries ≤ ``r × primaries + b``.
- :class:`HedgePolicy` — a backup RPC to a *different* teacher is
  launched only after the p95-tracked hedge delay (slower than 95% of
  recent primaries ⇒ probably stuck), metered and budget-capped so
  hedging adds tail insurance, not baseline load.
- :class:`BreakerBoard` — per-teacher circuit breakers: consecutive
  failures/overloads trip the breaker open, a half-open probe is let
  through after the cooldown, one success closes it. Open breakers veto
  the endpoint in :class:`~edl_tpu_torch.distill.worker.ServerPool` and are
  reported to discovery so :class:`~edl_tpu_torch.distill.discovery.
  BalanceTable` routes *other* students around the sick teacher without
  waiting for its lease to expire.

Env knobs (all read at construction):

    EDL_RETRY_BUDGET      retry tokens earned per primary (default 0.25)
    EDL_HEDGE_BUDGET      hedge tokens earned per primary (default 0.10;
                          0 disables hedging)
    EDL_HEDGE_MIN_MS      hedge-delay floor, ms (default 20)
    EDL_BREAKER_FAILURES  consecutive failures that trip a breaker
                          (default 5)
    EDL_BREAKER_OPEN_S    open duration before the half-open probe
                          (default 5)
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("distill.resilience")

_M_RETRY_DENIED = obs_metrics.counter(
    "edl_distill_retry_denied_total",
    "retries refused because the retry budget was empty",
)
_M_HEDGES = obs_metrics.counter(
    "edl_distill_hedges_total", "backup predicts launched by the hedger"
)
_M_HEDGE_WINS = obs_metrics.counter(
    "edl_distill_hedge_wins_total",
    "hedged predicts where the backup answered first",
)
_M_BREAKER_TRANSITIONS = obs_metrics.counter(
    "edl_distill_breaker_transitions_total",
    "circuit breaker state transitions, by destination state",
)
_G_BREAKER_OPEN = obs_metrics.gauge(
    "edl_distill_breaker_open",
    "1 while a teacher's circuit breaker is open/half-open, by teacher",
)


def _env_float(raw: Optional[str], default: float) -> float:
    try:
        return float(raw or default)
    except ValueError:
        return default


def _env_int(raw: Optional[str], default: int) -> int:
    try:
        return int(raw or default)
    except ValueError:
        return default


class FractionBudget:
    """Token bucket where primaries earn secondary-work tokens.

    Each :meth:`note_primary` deposits ``ratio`` tokens (capped at
    ``burst``); each secondary must :meth:`try_spend` a whole token.
    The cap is what makes storms impossible: a burst of failures can
    spend at most ``burst`` tokens ahead of what primaries earned."""

    def __init__(self, ratio: float, burst: float = 10.0) -> None:
        self.ratio = max(0.0, ratio)
        self._burst = max(1.0, burst)
        self._lock = threading.Lock()
        # start with the burst: a cold pipeline's first failures may
        # retry (connection establishment is the flakiest moment), the
        # steady state is still ratio-bound
        self._tokens = self._burst if self.ratio > 0 else 0.0
        self.primaries = 0
        self.spent = 0

    def note_primary(self) -> None:
        with self._lock:
            self.primaries += 1
            self._tokens = min(self._burst, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            return False


class RetryBudget(FractionBudget):
    """The pipeline-wide retry budget (``EDL_RETRY_BUDGET``)."""

    def __init__(
        self, ratio: Optional[float] = None, burst: float = 10.0
    ) -> None:
        super().__init__(
            _env_float(os.environ.get("EDL_RETRY_BUDGET", "0.25"), 0.25)
            if ratio is None else ratio,
            burst,
        )

    def try_spend(self) -> bool:
        ok = super().try_spend()
        if not ok:
            _M_RETRY_DENIED.inc()
        return ok


# -- hedging -------------------------------------------------------------------


class HedgePolicy:
    """p95-tracked hedge delay + budget-capped hedge permission.

    ``delay_s()`` is None until enough primary latencies accumulated —
    a cold pipeline must not hedge on a guess. The budget is the same
    fraction-of-primaries construction as retries, so
    ``edl_distill_hedges_total ≤ ratio × primaries + burst`` always."""

    _MIN_SAMPLES = 8
    _WINDOW = 256

    def __init__(
        self,
        budget_ratio: Optional[float] = None,
        min_delay_ms: Optional[float] = None,
        burst: float = 5.0,
    ) -> None:
        ratio = (
            _env_float(os.environ.get("EDL_HEDGE_BUDGET", "0.10"), 0.10)
            if budget_ratio is None else budget_ratio
        )
        self.budget = FractionBudget(ratio, burst)
        self._floor_s = (
            _env_float(os.environ.get("EDL_HEDGE_MIN_MS", "20"), 20.0)
            if min_delay_ms is None else min_delay_ms
        ) / 1000.0
        self._lock = threading.Lock()
        self._lat: List[float] = []
        self._i = 0
        self.hedges = 0
        self.wins = 0

    @property
    def enabled(self) -> bool:
        return self.budget.ratio > 0

    def note_primary(self) -> None:
        """Each primary request earns hedge budget at the ratio."""
        self.budget.note_primary()

    def note_latency(self, seconds: float) -> None:
        with self._lock:
            if len(self._lat) < self._WINDOW:
                self._lat.append(seconds)
            else:
                self._lat[self._i % self._WINDOW] = seconds
            self._i += 1

    def delay_s(self) -> Optional[float]:
        """The current hedge delay: p95 of recent primary latencies,
        floored; None while cold or disabled."""
        if not self.enabled:
            return None
        with self._lock:
            if len(self._lat) < self._MIN_SAMPLES:
                return None
            xs = sorted(self._lat)
        p95 = xs[min(len(xs) - 1, int(0.95 * len(xs)))]
        return max(p95, self._floor_s)

    def try_hedge(self) -> bool:
        if not self.enabled or not self.budget.try_spend():
            return False
        with self._lock:
            self.hedges += 1
        _M_HEDGES.inc()
        return True

    def note_win(self, backup_won: bool) -> None:
        if backup_won:
            with self._lock:
                self.wins += 1
            _M_HEDGE_WINS.inc()


def hedged_call(
    primary_fn: Callable[[], object],
    hedge_delay_s: Optional[float],
    backup_factory: Callable[[], Optional[Callable[[], object]]],
    policy: Optional[HedgePolicy] = None,
) -> Tuple[object, bool, bool]:
    """Run ``primary_fn``; if it is still running after ``hedge_delay_s``,
    ask ``backup_factory`` for a backup callable (it returns None when no
    second teacher is available) and race them — first *success* wins,
    the loser is ignored (the caller closes its transport, which unblocks
    the losing thread). Returns ``(result, backup_won,
    primary_abandoned)``; ``primary_abandoned`` means the primary was
    still in flight when the call returned, so its connection is desynced
    and must be discarded.

    Budget metering happens in the caller-supplied ``backup_factory``
    via ``policy.try_hedge()`` — the factory is only invoked after the
    delay actually elapsed, so hedges are only spent on real tail
    latencies."""
    results: "queue.Queue" = queue.Queue()

    def run(tag: str, fn: Callable[[], object]) -> None:
        try:
            results.put((tag, True, fn()))
        except BaseException as exc:  # noqa: BLE001 — raced to the caller
            results.put((tag, False, exc))

    threading.Thread(
        target=run, args=("primary", primary_fn),
        name="edl-hedge-primary", daemon=True,
    ).start()
    if hedge_delay_s is not None:
        try:
            tag, ok, val = results.get(timeout=hedge_delay_s)
            if ok:
                return val, False, False
            raise val
        except queue.Empty:
            pass
    else:
        tag, ok, val = results.get()
        if ok:
            return val, False, False
        raise val

    backup_fn = backup_factory()
    if backup_fn is None:
        tag, ok, val = results.get()  # no hedge possible: wait it out
        if ok:
            return val, False, False
        raise val
    threading.Thread(
        target=run, args=("backup", backup_fn),
        name="edl-hedge-backup", daemon=True,
    ).start()
    failures = 0
    while True:
        tag, ok, val = results.get()
        if ok:
            backup_won = tag == "backup"
            if policy is not None:
                policy.note_win(backup_won)
            return val, backup_won, backup_won
        failures += 1
        if failures >= 2:
            raise val


# -- circuit breakers ----------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Breaker:
    __slots__ = ("state", "fails", "opened_at", "probe_inflight")

    def __init__(self) -> None:
        self.state = CLOSED
        self.fails = 0
        self.opened_at = 0.0
        self.probe_inflight = False


class BreakerBoard:
    """Per-teacher circuit breakers with half-open probing.

    State machine: CLOSED --(``failures`` consecutive failures or
    overloads)--> OPEN --(``open_s`` elapsed)--> HALF_OPEN --(one probe
    succeeds)--> CLOSED, or --(probe fails)--> OPEN again. ``admits()``
    is the pool's veto predicate: False while OPEN and while a half-open
    probe is already in flight, so exactly one request at a time tests a
    recovering teacher.

    Transitions are metered (``edl_distill_breaker_open{teacher}``,
    ``edl_distill_breaker_transitions_total{to}``), flight-recorded as
    ``breaker_open``/``breaker_close`` causal instants, and surfaced to
    the optional ``on_open``/``on_close`` callbacks (the pipeline wires
    these to discovery's sick-reporting so the balancer ejects the
    teacher fleet-wide)."""

    def __init__(
        self,
        failures: Optional[int] = None,
        open_s: Optional[float] = None,
        on_open: Optional[Callable[[str], None]] = None,
        on_close: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.failures = (
            _env_int(os.environ.get("EDL_BREAKER_FAILURES", "5"), 5)
            if failures is None else failures
        )
        self.open_s = (
            _env_float(os.environ.get("EDL_BREAKER_OPEN_S", "5"), 5.0)
            if open_s is None else open_s
        )
        self._lock = threading.Lock()
        self._breakers: Dict[str, _Breaker] = {}
        self._on_open = on_open
        self._on_close = on_close

    def _get(self, endpoint: str) -> _Breaker:
        b = self._breakers.get(endpoint)
        if b is None:
            b = self._breakers[endpoint] = _Breaker()
        return b

    def _transition(self, endpoint: str, b: _Breaker, to: str) -> None:
        b.state = to
        _M_BREAKER_TRANSITIONS.inc(to=to)
        _G_BREAKER_OPEN.set(0.0 if to == CLOSED else 1.0, teacher=endpoint)

    def admits(self, endpoint: str) -> bool:
        """Pure veto check — consumes nothing. Never-seen endpoints are
        admitted (breakers exist only once traffic flowed)."""
        now = time.monotonic()
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is None or b.state == CLOSED:
                return True
            if b.state == OPEN:
                if now - b.opened_at < self.open_s:
                    return False
                self._transition(endpoint, b, HALF_OPEN)
                return not b.probe_inflight
            return not b.probe_inflight  # HALF_OPEN

    def starting(self, endpoint: str) -> None:
        """An attempt against ``endpoint`` begins; a HALF_OPEN breaker
        marks it as THE probe (no second request until it concludes)."""
        with self._lock:
            b = self._breakers.get(endpoint)
            if b is not None and b.state == HALF_OPEN:
                b.probe_inflight = True

    def record_success(self, endpoint: str) -> None:
        closed = False
        with self._lock:
            b = self._get(endpoint)
            b.fails = 0
            b.probe_inflight = False
            if b.state != CLOSED:
                self._transition(endpoint, b, CLOSED)
                closed = True
        if closed:
            obs_events.record("breaker_close", teacher=endpoint)
            logger.info("breaker closed for %s", endpoint)
            if self._on_close is not None:
                try:
                    self._on_close(endpoint)
                except Exception as exc:  # noqa: BLE001 — advisory hook
                    logger.warning("breaker on_close failed: %s", exc)

    def record_failure(self, endpoint: str, overload: bool = False) -> None:
        """A failed (or shed — ``overload=True``) attempt. Overloads
        count toward the trip threshold like failures: a teacher
        shedding everything it is offered is not serving this client."""
        opened = False
        with self._lock:
            b = self._get(endpoint)
            b.fails += 1
            b.probe_inflight = False
            if b.state == HALF_OPEN or (
                b.state == CLOSED and b.fails >= self.failures
            ):
                b.opened_at = time.monotonic()
                self._transition(endpoint, b, OPEN)
                opened = True
            elif b.state == OPEN:
                b.opened_at = time.monotonic()
        if opened:
            obs_events.record(
                "breaker_open", teacher=endpoint, overload=bool(overload)
            )
            logger.warning(
                "breaker OPEN for %s (%d consecutive %s)",
                endpoint, self.failures if b.fails >= self.failures else 1,
                "overloads/failures" if overload else "failures",
            )
            if self._on_open is not None:
                try:
                    self._on_open(endpoint)
                except Exception as exc:  # noqa: BLE001 — advisory hook
                    logger.warning("breaker on_open failed: %s", exc)

    def state(self, endpoint: str) -> str:
        with self._lock:
            b = self._breakers.get(endpoint)
            return b.state if b is not None else CLOSED

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return {e: b.state for e, b in self._breakers.items()}

    def forget(self, endpoint: str) -> None:
        """Drop state (and the gauge series) for a departed teacher."""
        with self._lock:
            self._breakers.pop(endpoint, None)
