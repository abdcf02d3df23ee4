"""Parallelism: data parallelism and FSDP, the subset of ``edl_tpu.parallel``
the elastic trainer uses."""

from edl_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    data_parallel,
    device_put_global,
    device_put_local_rows,
    is_fsdp,
    make_mesh,
    replicated,
    shard_batch,
    shard_params_fsdp,
    sharded_init,
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
    "shard_batch",
    "shard_params_fsdp",
    "sharded_init",
]
