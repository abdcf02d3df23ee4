"""The fault plane: the port's copy of ``edl_tpu/chaos/plane.py``.

Named fault points (the store client's, the checkpoint manager's) armed
by ``EDL_CHAOS`` or the job's ``chaos/`` store keys, with the same
seeded schedules as the JAX package. The scenarios, invariants and the
chaos trainee come with slice 3b.
"""

from edl_tpu_torch.chaos.plane import (  # noqa: F401
    ChaosDrop,
    FaultPoint,
    arm_from_env,
    arm_from_store,
    chaos_prefix,
    configure,
    disarm,
    fault_point,
    points,
    publish_spec,
)
