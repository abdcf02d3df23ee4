"""Checkpoints across a change of world size: the port of
``edl_tpu.checkpoint``'s manager (on ``torch.distributed.checkpoint``)
and its hyper-parameter adjustment registry. The peer-replication plane
(``replicate.py``) comes with slice 3b."""

from edl_tpu_torch.checkpoint.manager import CheckpointManager, TrainStatus
from edl_tpu_torch.checkpoint.adjust import AdjustRegistry, linear_scaled_lr

__all__ = [
    "CheckpointManager",
    "TrainStatus",
    "AdjustRegistry",
    "linear_scaled_lr",
]
