"""The stage's mesh: the port of ``edl_tpu/parallel/mesh.py`` over the
axes the port runs: pipeline parallelism (``pp``), data parallelism, FSDP,
tensor parallelism (``tp``), sequence parallelism (``sp``), expert
parallelism (``ep``) and the CTR tables' model parallelism (``mp``).

The JAX package shards over a ``jax.sharding.Mesh`` and lets XLA insert the
collectives. Here the mesh is the stage's process group, one device per
process (``init`` selected it), laid out row-major in the JAX package's
axis order ``("pp", "dp", "fsdp", "tp", "sp", "ep", "mp")``: the last
axis varies fastest, so rank ``r`` of a ``dp × tp × sp × ep`` mesh holds
``ep`` index ``r % ep``, ``sp`` index ``r // ep % sp``, ``tp`` index
``r // (sp·ep) % tp`` and ``dp`` index ``r // (tp·sp·ep)`` (of a
``dp × fsdp`` mesh: ``dp`` index ``r // fsdp``, ``fsdp`` index
``r % fsdp``). ``pp`` is the outermost axis, as the JAX callers write it
first (``{"pp": 2, "dp": 2}``) and JAX lays devices out in the dict's
order: the stage of rank ``r`` is ``r // (world / pp)``. ``mp`` comes
last, as the CTR example writes ``{"dp": -1, "mp": 2}``.

- Data parallelism: :func:`data_parallel` wraps the model in
  ``DistributedDataParallel``, which broadcasts rank 0's parameters and
  averages gradients over the ranks. With equal local batches that
  average is the gradient of the mean loss over the concatenated global
  batch, so a step at world N equals one step on the global batch at
  world 1.
- FSDP: :func:`shard_params_fsdp` applies FSDP2's ``fully_shard`` over a
  ``DeviceMesh`` of the stage (:attr:`Mesh.device_mesh`, axes ``("dp",
  "fsdp")``): HSDP on the 2-D mesh (replicated over ``dp``, sharded over
  ``fsdp``), plain FSDP on the 1-D ``fsdp`` mesh when ``dp`` is 1. The
  parameters become ``DTensor`` shards, and the optimizer built over
  them keeps its state sharded alike; FSDP2's reduce-scatter over
  ``fsdp`` and all-reduce over ``dp`` average the gradients, so the
  module takes no DDP wrap.

Placement keeps the JAX semantics: :func:`device_put_global` takes a value
that is the same on every rank (parameters), :func:`device_put_local_rows`
and :func:`shard_batch` take this rank's rows of the batch. Batches shard
over ``dp`` only (``batch_sharding`` is ``P("dp")``): the ranks of one
``fsdp`` group pass the same rows, and the global batch is the ``dp``
groups' rows concatenated in ``dp`` order.

- Tensor, sequence and expert parallelism: at ``tp``, ``sp`` or ``ep``
  > 1 the mesh builds, collectively and once, the process groups over
  ``tp``, ``sp``, ``ep``, ``dp`` and ``dp × sp`` (:meth:`Mesh.group`).
  ``parallel.sharding_rules`` shards the TransformerLM's weights over
  ``tp`` and its MoE blocks' expert banks over ``ep``, and averages
  gradients over ``dp × sp``; ring and Ulysses attention run over ``sp``
  (:func:`sharded_seq_attention`). A rank holds its ``dp`` rows (the
  ranks of one ``tp``, ``sp`` or ``ep`` group hold the same ones) and its
  ``sp`` chunk of the sequence (:func:`shard_seq`, global RoPE positions
  from :func:`seq_positions`). ``fsdp`` does not combine with ``tp``,
  ``sp`` or ``ep`` in the port (left out of ROADMAP M12-M15).
- Pipeline parallelism: at ``pp`` > 1 each ``pp`` rank holds one stage
  of the model (``parallel.pipeline``, ``pipeline_1f1b``,
  ``pipeline_lm``); the mesh builds a ``pp`` group (the ranks of one
  ``dp`` index, one per stage) and a ``dp`` group inside each stage.
  ``pp`` combines with ``dp`` only, as the JAX pipeline shards over its
  ``axis`` and ``batch_axis`` only.
- The CTR tables' vocabulary over ``mp`` (``models.ctr.
  CTR_EMBEDDING_RULES``): an ``mp`` group; the ranks of one group hold
  the same rows of the batch and their own rows of each table, and
  gradients are averaged over ``dp`` only. ``mp`` combines with ``dp``
  only.

Axes of size 1 are kept in ``Mesh.shape``.
"""

from __future__ import annotations

import inspect
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.utils.device import resolve_device

DEFAULT_AXES = ("pp", "dp", "fsdp", "tp", "sp", "ep", "mp")

# the stage's DeviceMesh, built once per process group (its sub-groups are
# collective to create) and dropped with the group
# (train.context._teardown_group): (key, DeviceMesh)
_stage_mesh: Optional[Tuple[tuple, object]] = None
# the sub-groups of a tp/sp/ep/pp/mp mesh, built once per process group and
# layout:
# (key, {axes tuple: this rank's group})
_stage_groups: Optional[Tuple[tuple, dict]] = None


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _default_group():
    from torch.distributed import distributed_c10d

    return distributed_c10d._get_default_group()


def forget_stage_mesh() -> None:
    """Drop the stage's DeviceMesh; its groups go with the default group
    they were split from (``train.context._teardown_group``)."""
    global _stage_mesh, _stage_groups
    _stage_mesh = None
    _stage_groups = None


def _current_mesh(dp: int, fsdp: int, device_type: str):
    """The stage's DeviceMesh over ``(dp, fsdp)``, built on first use
    (collective: every rank asks at the same point)."""
    global _stage_mesh
    from torch.distributed.device_mesh import init_device_mesh

    key = (id(_default_group()), device_type, dp, fsdp)
    if _stage_mesh is None or _stage_mesh[0] != key:
        _stage_mesh = (key, init_device_mesh(
            device_type, (dp, fsdp), mesh_dim_names=("dp", "fsdp")))
    return _stage_mesh[1]


def _coords(shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """``rank``'s index on each axis of the row-major layout."""
    out = {}
    for name in reversed(tuple(shape)):
        out[name] = rank % shape[name]
        rank //= shape[name]
    return {name: out[name] for name in shape}


def _axes_key(shape: Dict[str, int], axes) -> tuple:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in shape if a in axes)


def _build_groups(shape: Dict[str, int], rank: int) -> dict:
    """This rank's process group over each of ``tp``, ``sp``, ``ep``,
    ``pp``, ``mp``, ``dp`` and ``dp × sp`` (collective: every rank creates
    every group, in one order); an axis set of one rank gets None."""
    world = math.prod(shape.values())
    coords = [_coords(shape, r) for r in range(world)]
    out = {}
    for axes in (("tp",), ("sp",), ("ep",), ("pp",), ("mp",), ("dp",),
                 ("dp", "sp")):
        key = _axes_key(shape, axes)
        if key in out:
            continue  # ("dp", "sp") on a mesh without sp is ("dp",)
        if math.prod(shape[a] for a in key) == 1:
            out[key] = None
            continue
        others = [a for a in shape if a not in key]
        parts: Dict[tuple, list] = {}
        for r, c in enumerate(coords):
            parts.setdefault(tuple(c[a] for a in others), []).append(r)
        for ranks in parts.values():
            grp = dist.new_group(ranks)
            if rank in ranks:
                out[key] = grp
    return out


class Mesh:
    """The stage's axes (``shape``: ``pp``, ``dp``, ``fsdp``, ``tp``,
    ``sp``, ``ep``, ``mp`` as named, ``dp`` always, and the axes of size 1
    the caller named), this rank's place on them
    (``coords``) and its ``device``."""

    def __init__(self, shape: Dict[str, int], rank: int,
                 device: torch.device) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self.device = device
        self.coords = _coords(self.shape, rank)

    @property
    def dp_size(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def fsdp_size(self) -> int:
        return self.shape.get("fsdp", 1)

    @property
    def tp_size(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def sp_size(self) -> int:
        return self.shape.get("sp", 1)

    @property
    def ep_size(self) -> int:
        return self.shape.get("ep", 1)

    @property
    def pp_size(self) -> int:
        return self.shape.get("pp", 1)

    @property
    def mp_size(self) -> int:
        return self.shape.get("mp", 1)

    @property
    def pp_rank(self) -> int:
        """This rank's ``pp`` index: which stage of the pipeline it holds."""
        return self.coords.get("pp", 0)

    @property
    def mp_rank(self) -> int:
        """This rank's ``mp`` index: which rows of a vocab-sharded table it
        holds."""
        return self.coords.get("mp", 0)

    @property
    def dp_rank(self) -> int:
        """This rank's ``dp`` index: which rows of the global batch it
        holds (the ranks of one ``fsdp``, ``tp``, ``sp`` or ``ep`` group
        hold the same ones)."""
        return self.coords.get("dp", 0)

    @property
    def fsdp_rank(self) -> int:
        return self.coords.get("fsdp", 0)

    @property
    def tp_rank(self) -> int:
        return self.coords.get("tp", 0)

    @property
    def sp_rank(self) -> int:
        """This rank's ``sp`` index: which chunk of the sequence it holds."""
        return self.coords.get("sp", 0)

    @property
    def ep_rank(self) -> int:
        """This rank's ``ep`` index: which experts of a split bank it
        holds."""
        return self.coords.get("ep", 0)

    @property
    def model_parallel(self) -> bool:
        """True when ``tp``, ``sp``, ``ep``, ``pp`` or ``mp`` is above 1:
        the mesh's groups are then :meth:`group`'s own."""
        return any(self.shape.get(a, 1) > 1
                   for a in ("tp", "sp", "ep", "pp", "mp"))

    @property
    def device_mesh(self):
        """The ``("dp", "fsdp")`` DeviceMesh of the stage's process group
        (None without one, and on a tp/sp/ep/pp/mp mesh, whose groups are
        :meth:`group`'s); its ``"dp"`` and ``"fsdp"`` sub-meshes carry
        their own groups. Built at the first use in a stage, collectively."""
        if not _joined() or self.model_parallel:
            return None
        return _current_mesh(self.dp_size, self.fsdp_size, self.device.type)

    def group(self, axes):
        """The process group over ``axes`` (an axis name, or a tuple of
        them such as ``("dp", "sp")``) that holds this rank; None without
        a process group, and on a tp/sp/ep/pp/mp mesh where the axes span
        one rank."""
        if self.model_parallel:
            if not _joined():
                return None
            return _model_groups(self)[_axes_key(self.shape, axes)]
        dm = self.device_mesh
        return None if dm is None else dm.get_group(axes)

    @property
    def dp_group(self):
        return self.group("dp")

    @property
    def fsdp_group(self):
        return self.group("fsdp")

    def __repr__(self) -> str:
        return "Mesh(%s, rank=%d, device=%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.rank, self.device)


class Sharding:
    """Where a value lives on the mesh: split over ``axis`` along its
    leading dim, or replicated (``axis=None``)."""

    def __init__(self, mesh: Mesh, axis: Optional[str]) -> None:
        self.mesh = mesh
        self.axis = axis

    @property
    def device(self) -> torch.device:
        return self.mesh.device


def _model_groups(mesh: Mesh) -> dict:
    global _stage_groups
    key = (id(_default_group()), tuple(mesh.shape.items()))
    if _stage_groups is None or _stage_groups[0] != key:
        _stage_groups = (key, _build_groups(mesh.shape, mesh.rank))
    return _stage_groups[1]


def make_mesh(axes: Optional[Dict[str, int]] = None, device="cuda") -> Mesh:
    """The stage's mesh over every rank of the process group (one rank and
    no group in a one-worker stage). ``axes`` may name ``pp``, ``dp``,
    ``fsdp``, ``tp``, ``sp``, ``ep`` and ``mp`` at any sizes whose product
    is the world, one of them ``-1`` (it fills), and other axes at size 1;
    ``pp`` or ``mp`` > 1 beside ``fsdp``, ``tp``, ``sp``, ``ep`` (or each
    other) > 1 raises, and so does ``fsdp`` > 1 beside ``tp``, ``sp`` or
    ``ep`` > 1. ``device`` is the card unless the caller names the CPU; on
    the card, the device ``init`` selected. At ``fsdp`` > 1 the DeviceMesh
    and its sub-groups are built now (collective), so that batch norm
    finds its ``dp`` group; at ``tp``, ``sp``, ``ep``, ``pp`` or ``mp`` > 1
    the :meth:`Mesh.group` sub-groups are."""
    joined = _joined()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    axes = dict(axes or {"dp": world})
    fills = [k for k, v in axes.items() if v == -1]
    if len(fills) > 1:
        raise ValueError("only one axis may be -1, got %r" % fills)
    fixed = math.prod(v for v in axes.values() if v != -1)
    if fills:
        if world % fixed:
            raise ValueError("cannot fill %r: %d ranks / %d"
                             % (fills[0], world, fixed))
        axes[fills[0]] = world // fixed
    for name, size in axes.items():
        if name in DEFAULT_AXES or size == 1:
            continue
        raise NotImplementedError(
            "mesh axis %r: the port shards over %s only"
            % (name, DEFAULT_AXES))
    for axis, others in (("pp", ("fsdp", "tp", "sp", "ep", "mp")),
                         ("mp", ("fsdp", "tp", "sp", "ep"))):
        if axes.get(axis, 1) > 1 and any(axes.get(a, 1) > 1 for a in others):
            raise NotImplementedError(
                "%s > 1 beside %s > 1 is not ported: the JAX package shards "
                "over %s and dp only: %r"
                % (axis, ", ".join(others), axis, axes))
    if axes.get("fsdp", 1) > 1 and any(axes.get(a, 1) > 1
                                       for a in ("tp", "sp", "ep")):
        raise NotImplementedError(
            "fsdp > 1 beside tp, sp or ep > 1 is not ported (left out of "
            "ROADMAP M12-M15): %r" % (axes,))
    if math.prod(axes.values()) != world:
        raise ValueError("axes %r do not cover %d ranks" % (axes, world))
    axes.setdefault("dp", 1)
    # row-major in the JAX package's order (pp slowest, mp fastest), other
    # axes after
    order = [a for a in DEFAULT_AXES if a in axes]
    axes = {a: axes[a] for a in order + [a for a in axes if a not in order]}
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = Mesh(axes, rank, dev)
    if joined and mesh.model_parallel:
        _model_groups(mesh)  # build the sub-groups now (collective)
    elif joined and mesh.fsdp_size > 1:
        mesh.device_mesh  # noqa: B018 — build the sub-groups now
    return mesh


def batch_stats_group():
    """The group that batch statistics reduce over: every rank of the
    stage, except on a mesh with ``fsdp`` > 1, where the ranks of one
    ``fsdp`` group hold the same rows and the ``dp`` sub-group holds each
    row once (None when it is one rank, or without a process group)."""
    if not _joined() or dist.get_world_size() == 1:
        return None
    if _stage_mesh is not None and _stage_mesh[0][0] == id(_default_group()):
        _key, dm = _stage_mesh
        dp, fsdp = dm.shape
        if fsdp > 1:
            return dm.get_group("dp") if dp > 1 else None
    return dist.group.WORLD


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
    batch is every ``dp`` group's rows concatenated in order); a copy."""
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


def shard_seq(mesh: Mesh, x, seq_dim: int = 1) -> torch.Tensor:
    """This rank's block of a GLOBAL ``[B, T, ...]`` value: its ``dp``
    rows and its ``sp`` chunk of the sequence (``T / sp`` positions from
    ``sp_rank · T / sp``), as ``shard_map`` hands a ``P("dp", "sp")``
    array to each device; a copy on the mesh's device."""
    x = to_tensor(x)
    dp, sp = mesh.dp_size, mesh.sp_size
    if x.shape[0] % dp or x.shape[seq_dim] % sp:
        raise ValueError("%s does not split over dp %d x sp %d"
                         % (tuple(x.shape), dp, sp))
    rows = x.shape[0] // dp
    x = x.narrow(0, mesh.dp_rank * rows, rows)
    t = x.shape[seq_dim] // sp
    x = x.narrow(seq_dim, mesh.sp_rank * t, t)
    return x.to(mesh.device, copy=True)


def seq_positions(mesh: Mesh, batch: int, t_local: int) -> torch.Tensor:
    """``[batch, t_local]`` GLOBAL positions of this rank's sequence
    chunk, ``sp_rank · t_local + arange(t_local)`` (RoPE needs them: the
    chunk is not the sequence's start)."""
    start = mesh.sp_rank * t_local
    pos = torch.arange(start, start + t_local, device=mesh.device)
    return pos.expand(batch, t_local)


def sharded_seq_attention(per_shard_fn, local_fn, q, k, v, mesh: Mesh,
                          sp_axis: str = "sp", dp_axis=None):
    """Sequence-parallel attention (ring and Ulysses) on this rank's
    shards: ``q, k, v`` are ``[B_local, H, T / sp, D]``, the block
    ``shard_map`` would hand this device. ``per_shard_fn`` runs over the
    ``sp`` group; at ``sp == 1`` it is ``local_fn`` (both must agree
    numerically). ``dp_axis`` keeps the JAX signature: batch rows are
    local already."""
    if mesh.shape.get(sp_axis, 1) == 1:
        return local_fn(q, k, v)
    return per_shard_fn(q, k, v)


def _fsdp_spec(shape: Sequence[int], axis_size: int,
               axis: str = "fsdp") -> tuple:
    """``edl_tpu.parallel.mesh._fsdp_spec`` as a tuple: ``axis`` on the
    largest dim that ``axis_size`` divides (the first of equal ones),
    ``()`` (replicated) when there is none."""
    if not shape:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for dim in order:
        if shape[dim] >= axis_size and shape[dim] % axis_size == 0:
            spec = [None] * len(shape)
            spec[dim] = axis
            return tuple(spec)
    return ()


def fsdp_placement(shape: Sequence[int], axis_size: int):
    """FSDP2's placement of a parameter of ``shape``: ``Shard(dim)`` on the
    dim :func:`_fsdp_spec` picks. Where the JAX spec replicates (no dim
    divides), ``Shard(0)``: FSDP2 cannot replicate a parameter inside a
    ``fully_shard`` group, so it shards dim 0 unevenly (padded). That is
    the one placement that differs from the JAX package's; the values do
    not depend on it."""
    from torch.distributed.tensor import Shard

    spec = _fsdp_spec(shape, axis_size)
    return Shard(spec.index("fsdp") if spec else 0)


def _wrap_units(module: torch.nn.Module):
    """The sub-modules that get an FSDP group of their own, in module
    order: each direct child that holds parameters and modules of its own
    (a residual block, a transformer layer); containers are looked
    through, since their ``forward`` never runs. The root takes what is
    left (stems, norms, heads)."""
    for child in module.children():
        if isinstance(child, (torch.nn.ModuleList, torch.nn.ModuleDict)):
            yield from _wrap_units(child)
        elif any(True for _ in child.children()) and \
                any(True for _ in child.parameters()):
            yield child


def shard_params_fsdp(mesh: Mesh, module: torch.nn.Module,
                      axis: str = "fsdp") -> torch.nn.Module:
    """ZeRO-style sharding of ``module``'s parameters over ``axis``, in
    place, as FSDP2 (``fully_shard`` on each wrap unit, then the root,
    placements from :func:`fsdp_placement`); the module is returned. The
    parameters become ``DTensor`` shards on the mesh's device. FSDP2
    moves one wrap unit's parameters there before it splits them, so the
    device never holds the whole model; a module on ``meta`` stays there
    (for ``to_empty`` and an init).

    Shard before the optimizer is built (``create_state`` after this):
    one built over the whole parameters would hold tensors the module no
    longer has. Applied whenever a process group exists, a joined group
    at fsdp 1 included. A one-worker stage without a group keeps the module whole
    on the mesh's device: the JAX function's placement on an axis of
    size 1. A mesh without the axis raises: it was not built for FSDP
    (ROADMAP item 5 ported ``make_mesh({"dp": d, "fsdp": f})``)."""
    if axis not in mesh.shape:
        raise NotImplementedError(
            "shard_params_fsdp shards over the mesh's %r axis (ROADMAP "
            "item 5, M5: build the mesh with make_mesh({'dp': d, %r: f})); "
            "this mesh has axes %r" % (axis, axis, mesh.axis_names))
    if not _joined():
        return module.to(mesh.device)
    from torch.distributed.fsdp import fully_shard

    dm = mesh.device_mesh
    fsdp_mesh = dm if mesh.dp_size > 1 else dm[axis]
    size = mesh.shape[axis]

    def place(param):
        return fsdp_placement(param.shape, size)

    with torch.no_grad():
        for param in module.parameters():
            if not param.is_contiguous():
                # FSDP2 shards contiguous parameters only (a channels-last
                # conv kernel; the conv lays its cast copy out again)
                param.data = param.data.contiguous()
    for unit in list(_wrap_units(module)):
        fully_shard(unit, mesh=fsdp_mesh, shard_placement_fn=place)
    fully_shard(module, mesh=fsdp_mesh, shard_placement_fn=place)
    return module


class sharded_init:
    """Inside this context ``copy_``, ``fill_`` and ``zero_`` on a
    ``DTensor`` act on this rank's shard alone, with no collective: a
    whole source tensor is sliced to the shard's place in it. A model's
    own ``init_weights`` (a full draw per tensor, then ``p.copy_(draw)``)
    or a load of whole values so fills an FSDP-sharded module with the
    values the unsharded one would get, one tensor whole at a time.
    (DTensor's own redistribution of a whole source issues a collective,
    which gloo does not carry for tensors on the card.)"""

    def __enter__(self):
        from torch.overrides import TorchFunctionMode

        ops = (torch.Tensor.copy_, torch.Tensor.fill_, torch.Tensor.zero_)

        class _Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                target = args[0] if args else None
                if func not in ops or not isinstance(target, DTensor) or (
                        func is torch.Tensor.copy_
                        and isinstance(args[1], DTensor)):
                    return func(*args, **kwargs)
                local = target._local_tensor
                if func is torch.Tensor.copy_:
                    from torch.distributed.tensor._utils import (
                        compute_local_shape_and_global_offset)

                    shape, offset = compute_local_shape_and_global_offset(
                        target.shape, target.device_mesh, target.placements)
                    src = args[1][tuple(slice(o, o + n) for o, n in
                                        zip(offset, shape))]
                    local.copy_(src, **kwargs)
                else:
                    func(local, *args[1:], **kwargs)
                return target

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)


def is_fsdp(module: torch.nn.Module) -> bool:
    """True for a module ``shard_params_fsdp`` sharded (FSDP2)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(module, FSDPModule)


def data_parallel(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Wrap ``model`` for data parallelism over ``mesh``'s process group:
    ``DistributedDataParallel`` (rank 0's parameters are broadcast now;
    each backward averages the gradients over the ranks, bucketed and
    overlapped with the backward). Without a group (a one-worker stage),
    or for a module :func:`shard_params_fsdp` sharded (FSDP2 averages its
    gradients itself), it returns ``model`` itself.

    Buffers are not broadcast before each forward (DDP's
    ``forward_sync_buffers=False``, ``broadcast_buffers=False`` before
    torch 2.13): the only buffers of the port's models are batch-norm
    running averages, which every rank initialises alike or restores from
    the same checkpoint, and which stage-wide batch norm
    (:mod:`edl_tpu_torch.models.resnet`) updates from the same all-reduced
    statistics on every rank, so they stay equal without a broadcast.
    A MoE block's load-balancing statistics are means over the ranks the
    gradients are averaged over, as over the JAX step's global batch
    (``SwitchMoE.set_batch_group``)."""
    if not _joined() or is_fsdp(model):
        return model
    from torch.nn.parallel import DistributedDataParallel

    for module in model.modules():
        if hasattr(module, "set_batch_group"):
            module.set_batch_group(dist.group.WORLD)

    ids = [mesh.device] if mesh.device.type == "cuda" else None
    no_sync = ("forward_sync_buffers" if "forward_sync_buffers" in
               inspect.signature(DistributedDataParallel).parameters
               else "broadcast_buffers")
    return DistributedDataParallel(model, device_ids=ids, **{no_sync: False})
