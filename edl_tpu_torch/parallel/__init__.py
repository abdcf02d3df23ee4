"""Parallelism: data parallelism, FSDP, tensor and expert parallelism by
rules, and ring and Ulysses sequence parallelism (``edl_tpu.parallel``'s
surface short of pipelines). ``SwitchMoE`` and ``MOE_EP_RULES`` live in
``models.moe`` and are also found here."""

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
