"""Parallelism: the data-parallel subset of ``edl_tpu.parallel``."""

from edl_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    data_parallel,
    device_put_global,
    device_put_local_rows,
    make_mesh,
    replicated,
    shard_batch,
    shard_params_fsdp,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "data_parallel",
    "device_put_global",
    "device_put_local_rows",
    "make_mesh",
    "replicated",
    "shard_batch",
    "shard_params_fsdp",
]
