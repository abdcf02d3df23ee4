"""Per-job scaling decisions as a pure function of observed stats.

The objective is Pollux's (Qiao et al., OSDI '21) goodput:

    goodput(n) = throughput(n) * efficiency(batch(n))

with a simple two-parameter system model on each factor:

- ``throughput(n) = n * rate1 / (1 + alpha * (n - 1))`` — linear scaling
  bent by a contention coefficient ``alpha`` (0 = perfect scaling). The
  per-pod rate ``rate1`` cancels out of every comparison the engine
  makes, so an uncalibrated job still ranks world sizes correctly.
- ``efficiency(B) = (phi + b0) / (phi + B)`` with ``B = n * b0`` — the
  statistical-efficiency discount from running a bigger global batch,
  saturating at the gradient-noise-scale ``phi`` (the numerics plane's
  estimator feeds the live value; a large ``phi`` means big batches are still
  efficient, a small one means extra pods buy mostly wasted epochs).

Decisions carry *hysteresis* (a move must beat the current world by a
relative margin, or the controller oscillates on noise) and *cooldown*
(a restage just happened; let the new world show its rate before
re-deciding). Both are knobs: ``EDL_SCALE_HYSTERESIS``,
``EDL_SCALE_COOLDOWN`` (plus ``EDL_SCALE_ALPHA`` / ``EDL_SCALE_GNS``
model priors). Everything here is deterministic and store-free — the
decision-table tests in tests/test_scale.py drive it directly.

The port's copy of ``edl_tpu/scale/decide.py``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "ScaleParams",
    "JobStats",
    "Decision",
    "model_goodput",
    "best_world",
    "decide_world",
    "fit_alpha",
    "params_from_env",
]

# decision kinds — the full grammar the scale plane speaks
GROW = "grow"
SHRINK = "shrink"
HOLD = "hold"
PREEMPT = "preempt"  # taken to zero: gang floor says min-or-nothing

_DEF_ALPHA = 0.05
_DEF_GNS = 32.0
_DEF_HYSTERESIS = 0.15
_DEF_COOLDOWN = 30.0

# a measured goodput ratio damps the curve but never flattens it: a
# freshly-restaged job legitimately reports ~0 (its wall time so far IS
# all restage), and a flat-zero curve would zero every marginal gain,
# collapse the arbiter's water-fill to the gang floor, and trip the
# mandatory (cooldown-bypassing) shrink — grow -> shrink thrash on
# every restage (seen live in an autoscale drill).
_HEALTH_FLOOR = 0.05


@dataclasses.dataclass(frozen=True)
class ScaleParams:
    """Model priors + controller damping for one job."""

    alpha: float = _DEF_ALPHA        # scaling contention (0 = perfect)
    gns: float = _DEF_GNS            # gradient-noise-scale prior (phi)
    batch_per_pod: float = 1.0       # b0: global batch grows n * b0
    hysteresis: float = _DEF_HYSTERESIS  # relative gain a move must clear
    cooldown_s: float = _DEF_COOLDOWN    # quiet time after an acted decision


def params_from_env(base: Optional[ScaleParams] = None) -> ScaleParams:
    """Layer the ``EDL_SCALE*`` knobs over ``base``: a set (non-empty)
    knob wins, an unset one falls through to the base value — so a
    caller-supplied prior survives when the env is silent. Single read
    site per knob (the env-registry lint tracks these); the literal
    defaults live on :class:`ScaleParams` itself."""
    b = base if base is not None else ScaleParams()
    return ScaleParams(
        alpha=float(os.environ.get("EDL_SCALE_ALPHA") or b.alpha),
        gns=float(os.environ.get("EDL_SCALE_GNS") or b.gns),
        batch_per_pod=b.batch_per_pod,
        hysteresis=float(
            os.environ.get("EDL_SCALE_HYSTERESIS") or b.hysteresis
        ),
        cooldown_s=float(
            os.environ.get("EDL_SCALE_COOLDOWN") or b.cooldown_s
        ),
    )


@dataclasses.dataclass(frozen=True)
class JobStats:
    """One job's observed signals, as the scaler scraped them."""

    world: int                      # actual pods right now
    per_pod_rate: float = 1.0       # examples/s/pod (cancels in ranking)
    goodput_ratio: float = 1.0      # ledger train/wall; damps the model
    gns: Optional[float] = None     # measured noise scale; None = prior
    stragglers: int = 0             # alert pressure; reads as contention


@dataclasses.dataclass(frozen=True)
class Decision:
    """One decision record — what scale/target serializes."""

    kind: str                       # grow | shrink | hold | preempt
    target: int                     # pods (0 only with kind=preempt)
    cause: str
    score: float                    # model goodput at target
    seq: int = 0                    # global decision sequence number
    job_id: str = ""
    ts: float = 0.0                 # decision wall-time (cooldown anchor)


def model_goodput(
    n: int,
    params: ScaleParams,
    stats: Optional[JobStats] = None,
) -> float:
    """The modeled goodput of running at ``n`` pods (examples/s scaled
    by statistical efficiency); 0 for n <= 0.

    Two observed health signals damp the curve:

    - ``stats.stragglers`` reads as *measured* contention — each firing
      pressure rule adds one alpha-prior of slope, so extra pods look
      worse and the per-job argmax shifts down;
    - ``stats.goodput_ratio`` (the ledger's train/wall fraction) scales
      the whole curve, floored at ``_HEALTH_FLOOR`` so a transient zero
      (a job mid-restage has spent ALL its wall time restaging) damps
      rather than erases it. It cancels inside this job's own argmax
      and hysteresis comparisons, but it damps the weighted *marginal*
      gains the arbiter water-fills by — an unhealthy job funds a
      healthy one.
    """
    if n <= 0:
        return 0.0
    rate1 = stats.per_pod_rate if stats is not None else 1.0
    if rate1 <= 0:
        rate1 = 1.0
    phi = params.gns
    alpha = params.alpha
    health = 1.0
    if stats is not None:
        if stats.gns is not None and stats.gns > 0:
            phi = stats.gns
        if stats.stragglers > 0:
            alpha += _DEF_ALPHA * stats.stragglers
        health = min(max(stats.goodput_ratio, _HEALTH_FLOOR), 1.0)
    b0 = max(params.batch_per_pod, 1e-9)
    throughput = n * rate1 / (1.0 + alpha * (n - 1))
    efficiency = (phi + b0) / (phi + n * b0)
    return throughput * efficiency * health


def best_world(
    lo: int,
    hi: int,
    params: ScaleParams,
    stats: Optional[JobStats] = None,
) -> int:
    """argmax of :func:`model_goodput` over ``[lo, hi]`` (smallest world
    wins ties — fewer pods for the same goodput is strictly better for
    the cluster)."""
    lo = max(1, lo)
    if hi < lo:
        return lo
    best_n, best_g = lo, model_goodput(lo, params, stats)
    for n in range(lo + 1, hi + 1):
        g = model_goodput(n, params, stats)
        if g > best_g * (1.0 + 1e-9):
            best_n, best_g = n, g
    return best_n


def decide_world(
    stats: JobStats,
    capacity: int,
    min_world: int,
    max_world: int,
    params: ScaleParams,
    last: Optional[Decision] = None,
    now: float = 0.0,
    mem_cap: Optional[int] = None,
) -> Decision:
    """One job's decision against ``capacity`` free-for-it pods.

    The grammar:

    - capacity below ``min_world`` -> ``preempt`` to 0 (gang floor: a
      job runs at >= min_world or not at all, never in between);
    - the current world EXCEEDS capacity -> ``shrink`` to the model
      argmax within capacity, unconditionally — the allocation is
      binding (another job was admitted onto those pods), so neither
      hysteresis nor cooldown may hold the preemption hostage;
    - the model argmax over ``[min_world, min(max_world, capacity)]``
      beats the current world by the hysteresis margin -> ``grow`` /
      ``shrink`` to it;
    - otherwise -> ``hold`` (including during cooldown after an acted
      decision — a restage must settle before the next one).

    ``mem_cap`` is the memory-plane fit verdict (obs/memory.fit_cap):
    the largest world whose published compile-time memory plan fits the
    device limit minus the safety margin, or None when no plan has been
    published (unknown never gates). The gate clamps *growth* — a
    target above the cap is walked down and the decision's cause says
    ``mem_unfit`` — but it never force-shrinks the current world: a
    running world is live evidence it fits, and the plan's margin is
    deliberately conservative.
    """
    if capacity < min_world:
        return Decision(
            PREEMPT, 0, "capacity %d < min world %d" % (capacity, min_world),
            0.0, ts=now,
        )
    hi_raw = min(max_world, capacity)
    lo = min_world
    cur = stats.world if stats.world > 0 else 0
    hi = hi_raw
    if mem_cap is not None and mem_cap < hi_raw:
        hi = max(mem_cap, cur)
        if hi < lo:
            # even the gang floor is unfit: refuse admission outright
            return Decision(
                HOLD, 0,
                "mem_unfit: no world in [%d, %d] fits device memory "
                "(largest fitting plan: %d pods)" % (lo, hi_raw, mem_cap),
                0.0, ts=now,
            )
    want = best_world(lo, hi, params, stats)
    want_raw = want if hi == hi_raw else best_world(lo, hi_raw, params, stats)
    mem_gated = want != want_raw
    if cur == 0:
        # not running yet: admission at the model optimum, no hysteresis
        cause = (
            "mem_unfit: admit capped at %d pods (model optimum %d over "
            "device memory)" % (want, want_raw)
            if mem_gated else "admit at model optimum"
        )
        return Decision(
            GROW, want, cause,
            model_goodput(want, params, stats), ts=now,
        )
    if cur > hi:
        return Decision(
            SHRINK, want,
            "allocation %d below world %d" % (hi, cur),
            model_goodput(want, params, stats), ts=now,
        )
    if (
        last is not None
        and last.kind in (GROW, SHRINK, PREEMPT)
        and params.cooldown_s > 0
        and (now - last.ts) < params.cooldown_s
    ):
        return Decision(
            HOLD, cur, "cooldown (%.0fs left)"
            % (params.cooldown_s - (now - last.ts)),
            model_goodput(cur, params, stats), ts=now,
        )
    g_cur = model_goodput(cur, params, stats)
    g_want = model_goodput(want, params, stats)
    if want != cur and g_want > g_cur * (1.0 + params.hysteresis):
        kind = GROW if want > cur else SHRINK
        cause = (
            "mem_unfit: grow capped at %d pods (model optimum %d over "
            "device memory)" % (want, want_raw)
            if mem_gated and kind == GROW
            else "model goodput %.3f -> %.3f at %d pods" % (g_cur, g_want, want)
        )
        return Decision(kind, want, cause, g_want, ts=now)
    if mem_gated and want == cur and want_raw > cur:
        return Decision(
            HOLD, cur,
            "mem_unfit: grow to %d refused (plan over device memory, "
            "cap %d)" % (want_raw, hi),
            g_cur, ts=now,
        )
    return Decision(HOLD, cur, "within hysteresis", g_cur, ts=now)


def fit_alpha(
    samples: Iterable[Tuple[int, float]],
    default: float = _DEF_ALPHA,
) -> float:
    """Fit the contention coefficient from observed ``(world,
    per-pod-rate)`` samples: the model says ``rate(n) = rate1 / (1 +
    alpha (n-1))``, so each pair of distinct worlds yields an alpha
    estimate; the fit is their median (robust to one noisy restage
    window). Falls back to ``default`` with <2 distinct worlds."""
    by_world: Dict[int, List[float]] = {}
    for n, r in samples:
        if n >= 1 and r > 0:
            by_world.setdefault(int(n), []).append(float(r))
    worlds = sorted(by_world)
    if len(worlds) < 2:
        return default
    rates = {n: sum(v) / len(v) for n, v in by_world.items()}
    estimates: List[float] = []
    for i, n1 in enumerate(worlds):
        for n2 in worlds[i + 1:]:
            if n1 == n2 or rates[n2] <= 0:
                continue
            # rate(n1)/rate(n2) = (1 + a(n2-1)) / (1 + a(n1-1))
            ratio = rates[n1] / rates[n2]
            denom = (n2 - 1) - ratio * (n1 - 1)
            if abs(denom) < 1e-12:
                continue
            a = (ratio - 1.0) / denom
            if a >= 0:
                estimates.append(a)
    if not estimates:
        return default
    estimates.sort()
    mid = len(estimates) // 2
    if len(estimates) % 2:
        return estimates[mid]
    return (estimates[mid - 1] + estimates[mid]) / 2.0
