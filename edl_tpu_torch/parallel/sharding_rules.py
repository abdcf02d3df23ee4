"""Rule-based parameter sharding: the port of
``edl_tpu/parallel/sharding_rules.py``.

A rule maps a parameter's flax path (``/layer_0/attn/q/kernel``, the
``state_dict`` key ``layer_0.attn.q.kernel`` with ``/`` for ``.``) to a
spec: one mesh axis name (or None) per dimension, the port's tuple in
place of a ``PartitionSpec``. :func:`spec_for_path` and the resolution in
:func:`shard_params_by_rules` are the JAX functions': axes absent from the
mesh are dropped, a dimension the axis does not divide is replicated
(GQA's narrowed k/v heads on a wider ``tp``), and that is logged once per
``(parameter suffix, axis, axis size)``.

``TRANSFORMER_TP_RULES`` is the Megatron split of
:class:`~edl_tpu_torch.models.transformer.TransformerLM`: q/k/v and the
MLP's gate/up column-parallel (output dim on ``tp``), the attention output
and the MLP's down row-parallel (input dim on ``tp``), the embedding and
the LM head vocabulary-sharded. ``models.moe.MOE_EP_RULES`` (added to
them) split the MoE blocks' expert banks over ``ep``, and
``models.ctr.CTR_EMBEDDING_RULES`` the CTR tables' vocab over ``mp``.

Where XLA inserts the collectives in the JAX package, here each rank keeps
its slice of every sharded parameter (plain tensors, sliced in place: the
port never redistributes a DTensor on a step's path) and the model
installs its parallel forward (``TransformerLM.install_parallel``, with
the collectives of :mod:`edl_tpu_torch.parallel.collectives`). The
gradient rules GSPMD applies silently are :func:`sync_gradients`'s, which
the train step calls after each backward:

- (a) a parameter replicated over ``tp`` whose gradient each ``tp`` rank
  computes only in part (k/v under the replicate fallback: each rank's
  share comes from its own q heads) is summed over ``tp``;
- (c) every parameter's gradient is averaged over the ``dp × sp`` ranks,
  since the loss is the mean over the global batch and sequence (each
  rank's loss is the mean over its block), and so is the reported loss.
  An expert bank split over ``ep`` is averaged over the ``dp × sp``
  ranks that hold the same experts; its gradient is whole on each rank
  (the tokens are the same on every ``ep`` rank). So are a CTR table's
  rows split over ``mp`` (the rows of the batch are the same on every
  ``mp`` rank).

Trap (b), the global GQA head map under the fallback, is the model's
(``Attention.install_tp``).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set, Tuple

import torch

from edl_tpu_torch.parallel.collectives import all_reduce_, group_size
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("parallel.sharding_rules")

Spec = Tuple
Rules = Sequence[Tuple[str, Spec]]

# (param-suffix, axis, axis-size) triples already warned about a
# non-divisible rule axis: one line per parameter KIND per mesh axis (not
# per layer), and a new mesh size is a new key (a hot restage reuses the
# process), as in the JAX module
_warned_suffixes: Set[Tuple[str, str, int]] = set()


def _param_suffix(path: str, parts: int = 3) -> str:
    """The path's trailing components ("attn/q/kernel")."""
    return "/".join(path.strip("/").split("/")[-parts:])


TRANSFORMER_TP_RULES: List[Tuple[str, Spec]] = [
    (r".*/attn/[qkv]/kernel", (None, "tp", None)),   # col: [d, H, hd]
    (r".*/attn/o/kernel", ("tp", None, None)),        # row: [H, hd, d]
    (r".*/mlp/(gate|up)/kernel", (None, "tp")),       # col: [d, ff]
    (r".*/mlp/down/kernel", ("tp", None)),            # row: [ff, d]
    (r".*/embed/embedding", ("tp", None)),            # vocab-sharded
    (r".*/lm_head/kernel", (None, "tp")),             # vocab-sharded out
]


def spec_for_path(path: str, rules: Rules) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return tuple(spec)
    return ()


def param_path(name: str) -> str:
    """The flax path of a ``state_dict`` name."""
    return "/" + name.replace(".", "/")


def resolve_spec(mesh_shape: Dict[str, int], path: str, shape,
                 rules: Rules) -> Spec:
    """The spec the JAX function places a parameter of ``shape`` at
    ``path`` with: the rule's axes, None where the mesh lacks the axis or
    the axis does not divide the dimension (warned once per suffix)."""
    resolved = []
    for dim, axis in enumerate(spec_for_path(path, rules)):
        if axis not in mesh_shape:
            resolved.append(None)
            continue
        size = mesh_shape[axis]
        if shape[dim] % size:
            warn_key = (_param_suffix(path), axis, size)
            if warn_key not in _warned_suffixes:
                _warned_suffixes.add(warn_key)
                logger.warning(
                    "param %s dim %d (size %d) not divisible by mesh axis "
                    "%r (size %d): replicating that dimension (further "
                    "params with suffix %r suppressed)",
                    path, dim, shape[dim], axis, size, warn_key[0],
                )
            resolved.append(None)
        else:
            resolved.append(axis)
    return tuple(resolved)


def _sharded_dims(mesh, spec: Spec):
    """``(dim, axis)`` of each dimension split over an axis of size > 1."""
    return [(d, a) for d, a in enumerate(spec)
            if a is not None and mesh.shape[a] > 1]


class _RulesState:
    def __init__(self, mesh, specs, partial) -> None:
        self.mesh = mesh
        self.specs = specs
        self.partial = set(partial)


def shard_params_by_rules(mesh, module: torch.nn.Module,
                          rules: Rules) -> torch.nn.Module:
    """Shard ``module``'s parameters over ``mesh`` by ``rules``, in place,
    and return it: each parameter keeps this rank's slice along every
    dimension its resolved spec splits (over ``tp``, ``ep`` or ``mp``), the
    module installs its parallel forward
    (``module.install_parallel(mesh, specs)``) and the train step syncs the
    gradients (:func:`sync_gradients`). Call it on whole parameters
    (after ``init_weights`` or a load of converted ones), before the
    first step. A module with nothing split still gets the gradient
    average over ``dp × sp``."""
    specs = {}
    for name, p in module.named_parameters():
        specs[name] = resolve_spec(mesh.shape, param_path(name), p.shape,
                                   rules)
    split = {n: _sharded_dims(mesh, s) for n, s in specs.items()}
    for name, dims in split.items():
        for _dim, axis in dims:
            if axis not in ("tp", "ep", "mp"):
                raise NotImplementedError(
                    "rule splits %s over %r: the port shards parameters "
                    "over tp, ep and mp only" % (name, axis))
    install = getattr(module, "install_parallel", None)
    if any(split.values()) and install is None:
        raise NotImplementedError(
            "%s has no parallel forward (install_parallel)"
            % type(module).__name__)
    with torch.no_grad():
        for name, p in module.named_parameters():
            for dim, axis in split[name]:
                n = mesh.shape[axis]
                p.data = p.data.chunk(n, dim=dim)[mesh.coords[axis]].contiguous()
    partial = install(mesh, specs) if install is not None else ()
    module._edl_rules = _RulesState(mesh, specs, partial)
    return module


def rules_state(module: torch.nn.Module):
    return getattr(module, "_edl_rules", None)


def average_group(mesh):
    """``(group, n)``: the ranks whose gradients are averaged, ``dp × sp``
    (None without a process group or at one rank), and their number."""
    if mesh.model_parallel:
        return mesh.group(("dp", "sp")), mesh.dp_size * mesh.sp_size
    return (mesh.group("dp") if mesh.dp_size > 1 else None), mesh.dp_size


def _flat_all_reduce(tensors, group) -> None:
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        all_reduce_(flat, group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@torch.no_grad()
def sync_gradients(module: torch.nn.Module, loss: torch.Tensor = None):
    """After a backward on a module :func:`shard_params_by_rules` sharded:
    sum the tp-partial gradients over ``tp`` (trap a), average every
    gradient over ``dp × sp`` (trap c); returns ``loss`` averaged over
    ``dp × sp`` (the global batch's mean), or None."""
    st = rules_state(module)
    if st is None:
        return loss
    mesh = st.mesh
    params = dict(module.named_parameters())
    tp = mesh.group("tp") if mesh.model_parallel else None
    partial = [params[n].grad for n in sorted(st.partial)
               if params[n].grad is not None]
    if partial and group_size(tp) > 1:
        _flat_all_reduce(partial, tp)
    group, n = average_group(mesh)
    if n > 1:
        grads = [p.grad for p in params.values() if p.grad is not None]
        _flat_all_reduce(grads, group)
        torch._foreach_mul_(grads, 1.0 / n)
        if loss is not None:
            loss = all_reduce_(loss.detach().clone(), group) / n
    return loss


@torch.no_grad()
def gather_params(mesh, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter whole (``state_dict`` names), gathered over the
    axes :func:`shard_params_by_rules` split it on (expert banks over
    ``ep``, CTR tables over ``mp``); collective over those groups. For
    ``convert.to_flax`` and comparisons."""
    from edl_tpu_torch.parallel.collectives import _gather_stacked

    st = rules_state(module)
    out = {}
    for name, p in module.named_parameters():
        t = p.detach()
        for dim, axis in (_sharded_dims(mesh, st.specs[name]) if st else ()):
            parts = _gather_stacked(t, mesh.group(axis)).unbind(0)
            t = torch.cat(parts, dim=dim)
        out[name] = t
    return out
