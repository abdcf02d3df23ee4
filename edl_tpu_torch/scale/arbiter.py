"""Multi-job arbitration of one shared device pool.

Gavel's framing (Narayanan et al., OSDI '20): the cluster objective is
the weighted sum of per-job goodputs, and the allocator's job is the
argmax over feasible allocations. The feasible set here is integral pod
counts with two hard structural rules:

- **gang floor** — a job gets >= its min world or exactly 0; an
  allocation strictly between strands a gang-scheduled job (its
  collective can't form) while still burning pods;
- **priority admission** — when the pool can't fit every job's floor,
  lower-priority jobs are preempted to 0 first (the drain plane turns
  that into graceful `preempt/{pod}` notices, not kills).

Above the floors, remaining pods are water-filled one at a time to the
job whose weighted *marginal* modeled goodput is highest — a greedy
argmax that is exact here because :func:`~edl_tpu_torch.scale.decide
.model_goodput` is concave in ``n`` (throughput gains shrink with
alpha, efficiency strictly decays), so marginal gains are monotone.

Gang *sequencing* lives here too (:func:`release_targets`): a grow must
not be released until the shrinks that fund it have actually happened,
or the pool transiently oversubscribes and both restages collide.
Pure functions, stdlib only — tests/test_scale.py drives the tables.

The port's copy of ``edl_tpu/scale/arbiter.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

from edl_tpu_torch.scale import decide as scale_decide

__all__ = ["JobDemand", "allocate", "release_targets"]


@dataclasses.dataclass(frozen=True)
class JobDemand:
    """One job's standing in the arbitration round."""

    job_id: str
    min_world: int = 1
    max_world: int = 1024
    priority: int = 0            # higher wins admission
    weight: float = 1.0          # cluster-objective weight
    stats: Optional[scale_decide.JobStats] = None
    params: scale_decide.ScaleParams = dataclasses.field(
        default_factory=scale_decide.ScaleParams
    )
    active: bool = True          # wants to run (has or is owed pods)


def _gain(d: JobDemand, n: int) -> float:
    """Weighted marginal goodput of this job's (n)th pod."""
    g1 = scale_decide.model_goodput(n, d.params, d.stats)
    g0 = scale_decide.model_goodput(n - 1, d.params, d.stats)
    return d.weight * (g1 - g0)


def allocate(demands: Iterable[JobDemand], capacity: int) -> Dict[str, int]:
    """The cluster-goodput-maximizing allocation of ``capacity`` pods.

    Returns ``{job_id: pods}`` for every demand (inactive jobs and
    jobs that lost admission get 0). Deterministic: admission order is
    (priority desc, job_id asc); water-filling tie-breaks the same way.
    """
    jobs = [d for d in demands if d.active]
    out: Dict[str, int] = {d.job_id: 0 for d in demands}
    if capacity <= 0 or not jobs:
        return out
    order = sorted(jobs, key=lambda d: (-d.priority, d.job_id))
    admitted: List[JobDemand] = []
    free = capacity
    for d in order:
        floor = max(1, d.min_world)
        if floor <= free:
            admitted.append(d)
            out[d.job_id] = floor
            free -= floor
    # water-fill: one pod at a time to the best weighted marginal gain
    while free > 0:
        best: Optional[JobDemand] = None
        best_gain = 0.0
        for d in admitted:
            n = out[d.job_id]
            if n >= d.max_world:
                continue
            g = _gain(d, n + 1)
            if best is None or g > best_gain + 1e-12:
                best, best_gain = d, g
        if best is None or best_gain <= 0:
            break
        out[best.job_id] += 1
        free -= 1
    return out


def release_targets(
    targets: Dict[str, int], actuals: Dict[str, int]
) -> Dict[str, int]:
    """The subset of ``targets`` safe to publish *now* (gang
    sequencing).

    Shrinks and preempts release immediately — they free pods and can
    never oversubscribe. Grows release only once NO shrink is still in
    flight (every job's actual world is at or below its target), i.e.
    the pods the grows spend have genuinely been returned to the pool.
    The scaler re-sweeps until that holds, so a deferred grow releases
    on the first sweep after the funding shrinks settle.
    """
    shrinking = [
        j for j, t in targets.items() if t < actuals.get(j, 0)
    ]
    out: Dict[str, int] = {}
    for job, t in targets.items():
        cur = actuals.get(job, 0)
        if t <= cur or not shrinking:
            out[job] = t
    return out
