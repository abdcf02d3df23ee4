"""Learning-rate schedules with elastic world-size scaling.

The port of ``edl_tpu/train/schedules.py``. A schedule is a pure function
of the optimizer step, ``step -> lr``, evaluated as optax evaluates it: at
the count BEFORE the update, so the first update uses ``schedule(0)``
(:mod:`edl_tpu_torch.train.optim` calls it that way). The formulas are
optax's ``piecewise_constant_schedule`` and ``warmup_cosine_decay_schedule``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

__all__ = [
    "piecewise_decay",
    "warmup_cosine",
    "scaled_schedule_factory",
]

Schedule = Callable[[int], float]


def piecewise_decay(
    base_lr: float,
    steps_per_epoch: int,
    boundaries_epochs: Sequence[int] = (30, 60, 90),
    decay: float = 0.1,
) -> Schedule:
    """Step decay at epoch boundaries (the reference's default ResNet
    strategy: /10 at epochs 30/60/90): ``base_lr`` times ``decay`` for each
    boundary step already reached."""
    boundaries = sorted(int(e * steps_per_epoch) for e in boundaries_epochs)

    def schedule(step: int) -> float:
        lr = base_lr
        for boundary in boundaries:
            if step >= boundary:
                lr *= decay
        return lr

    return schedule


def warmup_cosine(
    base_lr: float,
    steps_per_epoch: int,
    total_epochs: int,
    warmup_epochs: int = 5,
    end_lr: float = 0.0,
) -> Schedule:
    """Linear warmup from 0 then cosine decay to ``end_lr`` (the
    reference's ``cosine_decay`` strategy with the warmup its large-batch
    runs use)."""
    warmup = max(int(warmup_epochs * steps_per_epoch), 1)
    total = max(int(total_epochs * steps_per_epoch), warmup + 1)
    decay_steps = total - warmup
    alpha = 0.0 if base_lr == 0.0 else end_lr / base_lr

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        t = min(step - warmup, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


def scaled_schedule_factory(
    make_schedule: Callable[[float], Schedule],
    make_tx: Optional[Callable] = None,
):
    """Build an optimizer factory whose peak lr comes from the
    AdjustRegistry overrides (e.g. ``linear_scaled_lr``): on every elastic
    restart the factory is re-invoked with the overrides resolved for the
    NEW world size, so the whole schedule re-peaks at the rescaled lr.
    ``make_tx(schedule)`` defaults to ``sgd(schedule, momentum=0.9)``."""
    if make_tx is None:
        from edl_tpu_torch.train.optim import sgd

        make_tx = lambda sched: sgd(sched, momentum=0.9)

    def factory(overrides: Dict):
        lr = overrides.get("lr")
        if lr is None:
            raise ValueError(
                "scaled_schedule_factory needs an 'lr' override — register "
                "linear_scaled_lr (or similar) on the AdjustRegistry"
            )
        return make_tx(make_schedule(float(lr)))

    return factory
