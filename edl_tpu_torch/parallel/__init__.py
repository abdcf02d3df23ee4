"""Parallelism: data parallelism, FSDP, tensor and expert parallelism by
rules, ring and Ulysses sequence parallelism, and the GPipe and 1F1B
pipelines with the stage-split TransformerLM (``edl_tpu.parallel``'s
surface). ``SwitchMoE`` and ``MOE_EP_RULES`` live in ``models.moe`` and
are also found here."""

from edl_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    data_parallel,
    device_put_global,
    device_put_local_rows,
    is_fsdp,
    make_mesh,
    replicated,
    seq_positions,
    shard_batch,
    shard_params_fsdp,
    shard_seq,
    sharded_init,
)
from edl_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_efficiency,
    pipeline_loss_and_grads,
)
from edl_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grads
from edl_tpu_torch.parallel.pipeline_lm import (
    LMStage,
    lm_stage,
    merge_lm_params,
    pipeline_lm_1f1b_grads,
    pipeline_lm_logits,
    pipeline_lm_loss,
    split_lm_params,
)
from edl_tpu_torch.parallel.ring import ring_attention, ring_attention_sharded
from edl_tpu_torch.parallel.sharding_rules import (
    TRANSFORMER_TP_RULES,
    gather_params,
    shard_params_by_rules,
    spec_for_path,
)
from edl_tpu_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_sharded,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "data_parallel",
    "device_put_global",
    "device_put_local_rows",
    "is_fsdp",
    "make_mesh",
    "replicated",
    "seq_positions",
    "shard_batch",
    "shard_params_fsdp",
    "shard_seq",
    "sharded_init",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
    "pipeline_apply",
    "pipeline_efficiency",
    "pipeline_loss_and_grads",
    "pipeline_1f1b_loss_and_grads",
    "LMStage",
    "lm_stage",
    "split_lm_params",
    "merge_lm_params",
    "pipeline_lm_logits",
    "pipeline_lm_loss",
    "pipeline_lm_1f1b_grads",
    "TRANSFORMER_TP_RULES",
    "gather_params",
    "shard_params_by_rules",
    "spec_for_path",
    "MOE_EP_RULES",
    "SwitchMoE",
]


def __getattr__(name):
    # models.moe imports this package's collectives: resolved on first use
    if name in ("MOE_EP_RULES", "SwitchMoE"):
        from edl_tpu_torch.models import moe

        return getattr(moe, name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
