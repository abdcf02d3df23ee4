"""Training: the port of ``edl_tpu.train``'s step builders and schedules.

The elastic plane (``context.init``, ``ElasticTrainer``, the AUC metrics
and DGC compression) comes with later slices (ROADMAP M5-M9, M17).
"""

from edl_tpu_torch.train.optim import adam, adamw, sgd
from edl_tpu_torch.train.schedules import (
    piecewise_decay,
    scaled_schedule_factory,
    warmup_cosine,
)
from edl_tpu_torch.train.step import (
    TrainState,
    create_state,
    cross_entropy_loss,
    make_cross_entropy_loss,
    make_eval_step,
    make_kd_loss,
    make_masked_eval_step,
    make_masked_train_step,
    make_train_step,
    mse_loss,
)

__all__ = [
    "piecewise_decay",
    "warmup_cosine",
    "scaled_schedule_factory",
    "TrainState",
    "create_state",
    "make_train_step",
    "make_masked_train_step",
    "make_eval_step",
    "make_masked_eval_step",
    "cross_entropy_loss",
    "make_cross_entropy_loss",
    "make_kd_loss",
    "mse_loss",
    "adamw",
    "adam",
    "sgd",
]
