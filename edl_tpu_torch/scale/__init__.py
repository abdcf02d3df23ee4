"""Scale plane: the controller that decides cluster shape.

Everything below this package turns *observations* into *actions*:

- :mod:`edl_tpu_torch.scale.decide` — the pure per-job decision engine: a
  Pollux-style goodput model (speedup x statistical efficiency) and the
  grow/shrink/hold/preempt decision grammar with hysteresis + cooldown.
- :mod:`edl_tpu_torch.scale.arbiter` — the pure multi-job arbiter: cluster-
  goodput-maximizing allocation of one shared device pool with priority
  admission, gang floors (never strand a job below its min world) and
  gang-sequenced grow/shrink release.
- :mod:`edl_tpu_torch.scale.scaler` — the daemon loop (``python -m edl_tpu_torch.tools.edl_scaled``)
  that scrapes the monitor plane, runs the two pure halves, and *acts*
  by publishing ``scale/target`` docs the leader launcher reconciles
  through the existing drain/restage machinery.

The split is deliberate: decide/arbiter import nothing but stdlib, so
``tests/test_scale.py`` exercises the whole decision table without a
live cluster; only the scaler touches stores, flight recorders, traces.

The port's copy of ``edl_tpu/scale``.
"""

from edl_tpu_torch.scale.decide import (  # noqa: F401
    Decision,
    JobStats,
    ScaleParams,
    decide_world,
    fit_alpha,
    model_goodput,
    params_from_env,
)
from edl_tpu_torch.scale.arbiter import (  # noqa: F401
    JobDemand,
    allocate,
    release_targets,
)
from edl_tpu_torch.scale.scaler import JobSpec, Scaler  # noqa: F401
