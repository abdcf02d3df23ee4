"""Training: the port of ``edl_tpu.train``: the step builders, the
schedules, the optimizers with ``chain`` and DGC's ``topk_compression``,
the streaming AUC, and the elastic plane (``init``, ``worker_barrier``,
``ElasticTrainer`` — stop-resume, hot restage and graceful drain — and the
checkpoint's ``AdjustRegistry``).
"""

from edl_tpu_torch.checkpoint.adjust import AdjustRegistry, linear_scaled_lr
from edl_tpu_torch.train.context import (
    current_env,
    init,
    warm_only,
    worker_barrier,
)
from edl_tpu_torch.train.loop import ElasticTrainer

from edl_tpu_torch.train.compression import topk_compression
from edl_tpu_torch.train.metrics import (
    AUCState,
    auc_compute,
    auc_init,
    auc_merge,
    auc_update,
)
from edl_tpu_torch.train.optim import adam, adamw, chain, sgd
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
    "init",
    "current_env",
    "warm_only",
    "worker_barrier",
    "ElasticTrainer",
    "AdjustRegistry",
    "linear_scaled_lr",
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
    "chain",
    "topk_compression",
    "AUCState",
    "auc_init",
    "auc_update",
    "auc_compute",
    "auc_merge",
]
