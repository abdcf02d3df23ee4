"""The data-parallel mesh: the port of the subset of
``edl_tpu/parallel/mesh.py`` that ``ElasticTrainer`` uses.

The JAX package shards over a ``jax.sharding.Mesh`` and lets XLA insert the
gradient all-reduce. Here the mesh is the stage's process group: one
``dp`` axis over the world's ranks, one device per process
(``init`` selected it), and :func:`data_parallel` wraps the model in
``DistributedDataParallel``, which broadcasts rank 0's parameters and
averages gradients over the ranks. With equal local batches that average
is the gradient of the mean loss over the concatenated global batch, so a
step at world N equals one step on the global batch at world 1.

Placement keeps the JAX semantics: :func:`device_put_global` takes a value
that is the same on every rank (parameters), :func:`device_put_local_rows`
and :func:`shard_batch` take this rank's rows of the batch (the global
batch is the ranks' rows concatenated in rank order).

Only ``dp`` is served. ``fsdp`` (and :func:`shard_params_fsdp`) waits for
slice 3b; ``tp``/``sp``/``ep`` for ROADMAP M12/M14/M15.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.utils.device import resolve_device

_NOT_PORTED = {
    "fsdp": "slice 3b (FSDP2)",
    "tp": "ROADMAP M12",
    "sp": "ROADMAP M14",
    "ep": "ROADMAP M15",
}


def _fsdp_not_ported():
    return NotImplementedError(
        "fsdp (sharded parameters and optimizer state) waits for slice 3b "
        "of the port; this slice serves data parallelism only"
    )


class Mesh:
    """One ``dp`` axis over the stage's ranks; ``device`` is this rank's."""

    def __init__(self, size: int, rank: int, device: torch.device) -> None:
        self.shape = {"dp": size}
        self.axis_names = ("dp",)
        self.size = size
        self.rank = rank
        self.device = device

    def __repr__(self) -> str:
        return "Mesh(dp=%d, rank=%d, device=%s)" % (
            self.size, self.rank, self.device)


class Sharding:
    """Where a value lives on the mesh: split over ``axis`` along its
    leading dim, or replicated (``axis=None``)."""

    def __init__(self, mesh: Mesh, axis: Optional[str]) -> None:
        self.mesh = mesh
        self.axis = axis

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def make_mesh(axes: Optional[Dict[str, int]] = None, device="cuda") -> Mesh:
    """The stage's mesh: ``dp`` over every rank of the process group (one
    rank and no group in a one-worker stage). ``axes`` may name ``dp``
    (-1 fills) and axes of size 1; any other axis raises, naming the slice
    or ROADMAP item it waits for. ``device`` is the card unless the caller
    names the CPU; on the card, the device ``init`` selected."""
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    axes = dict(axes or {"dp": world})
    for name, size in axes.items():
        if name == "dp" or size == 1:
            continue
        if name == "fsdp":
            raise _fsdp_not_ported()
        raise NotImplementedError(
            "mesh axis %r waits for %s of the port"
            % (name, _NOT_PORTED.get(name, "a later slice"))
        )
    fixed = math.prod(v for v in axes.values() if v != -1)
    if axes.get("dp", 1) == -1:
        if world % fixed:
            raise ValueError("cannot fill 'dp': %d ranks / %d" % (world, fixed))
        axes["dp"] = world // fixed
    if math.prod(axes.values()) != world:
        raise ValueError("axes %r do not cover %d ranks" % (axes, world))
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world, rank, dev)


def batch_sharding(mesh: Mesh, axis: str = "dp") -> Sharding:
    """Leading-dim sharding for batches over the data axis."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def to_tensor(x) -> torch.Tensor:
    """A host array (or a tensor, as it is) as a tensor; arrays are
    copied, so the source may be reused."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, copy=True))


def device_put_global(x, sharding: Sharding) -> torch.Tensor:
    """Place a value that is the SAME on every rank (GLOBAL-value
    semantics, the params case) on this rank's device; a copy."""
    return to_tensor(x).to(sharding.device, copy=True)


def device_put_local_rows(x, sharding: Sharding) -> torch.Tensor:
    """Place THIS rank's rows of a batch (LOCAL-rows semantics: the global
    batch is every rank's rows concatenated in rank order); a copy."""
    return to_tensor(x).to(sharding.device, copy=True)


def tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = "dp"):
    """Place a batch (tuples, lists and dicts of arrays) with local-rows
    semantics, see :func:`device_put_local_rows`."""
    sharding = batch_sharding(mesh, axis)
    return tree_map(lambda x: device_put_local_rows(x, sharding), batch)


def shard_params_fsdp(mesh: Mesh, params, axis: str = "fsdp"):
    raise _fsdp_not_ported()


def data_parallel(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Wrap ``model`` for data parallelism over ``mesh``'s process group:
    ``DistributedDataParallel`` (rank 0's parameters and buffers are
    broadcast now; each backward averages the gradients over the ranks,
    bucketed and overlapped with the backward). Without a group (a
    one-worker stage) it returns ``model`` itself."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    from torch.nn.parallel import DistributedDataParallel

    ids = [mesh.device] if mesh.device.type == "cuda" else None
    return DistributedDataParallel(model, device_ids=ids)

