"""Hyper-parameter re-adjustment on elastic resize.

The reference sketches this API in its aspirational test
(python/edl/tests/unittests/test_train.py:28-67:
``state.register_adjust_function``) and its README promises "adjust
hyper-parameters" on world-size change (reference README.md:96-151). Here
it is a small registry of callbacks invoked at every stage start with the
restored status and the new worker env.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from edl_tpu_torch.checkpoint.manager import TrainStatus

AdjustFn = Callable[[Optional[TrainStatus], int], Dict[str, Any]]


class AdjustRegistry:
    """Collect adjust callbacks; merge their hyper-parameter overrides.

    Each callback gets ``(restored_status_or_None, new_world_size)`` and
    returns a dict of overrides; later registrations win on key conflicts.
    """

    def __init__(self) -> None:
        self._fns: List[AdjustFn] = []

    def register(self, fn: AdjustFn) -> AdjustFn:
        self._fns.append(fn)
        return fn

    def resolve(
        self, status: Optional[TrainStatus], world_size: int
    ) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for fn in self._fns:
            out.update(fn(status, world_size) or {})
        return out


def linear_scaled_lr(base_lr: float, base_world_size: int) -> AdjustFn:
    """Linear-scaling rule: lr grows with world size (Goyal et al. 2017) —
    the canonical adjustment the reference's elastic resize calls for."""

    def adjust(status: Optional[TrainStatus], world_size: int) -> Dict[str, Any]:
        return {"lr": base_lr * world_size / base_world_size}

    return adjust
