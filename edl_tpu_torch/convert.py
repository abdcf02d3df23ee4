"""Flax variables <-> PyTorch ``state_dict``: a rename plus conv layouts.

The port's modules carry the flax names
(:mod:`edl_tpu_torch.models.transformer`, :mod:`~edl_tpu_torch.models.resnet`,
:mod:`~edl_tpu_torch.models.mlp`), so the param path
``layer_0/attn/q/kernel`` becomes the key ``layer_0.attn.q.kernel``. The
conversion is no longer a pure rename: a conv kernel (a 4-D ``kernel``)
is flax's HWIO ``[kh, kw, in/groups, out]`` and torch's OIHW ``[out,
in/groups, kh, kw]``, so it is transposed on the way in and back. Every
other leaf keeps its shape (a Dense kernel stays ``[d_in, d_out]``). A
batch-norm model's ``batch_stats`` collection (``.../BatchNorm_0/mean``,
``var``) maps to the module's buffers of the same names, beside its
``scale``/``bias`` parameters. For ``TransformerLM``:

    embed/embedding            [V, d]
    layer_i/{ln1,ln2}/scale    [d]
    layer_i/attn/{q,k,v}/kernel [d, H|KV, D]
    layer_i/attn/o/kernel      [H, D, d]
    layer_i/mlp/{gate,up,down}/kernel
    layer_i/moe/router/kernel  [d, E]     (a MoE block, in place of mlp)
    layer_i/moe/wi             [E, d, F]
    layer_i/moe/wo             [E, F, d]
    ln_f/scale                 [d]
    lm_head/kernel             [d, V]

A model whose expert banks are split over ``ep`` (or tensor-parallel
weights over ``tp``) converts from ``parallel.gather_params``, which
reassembles them. The JAX pipeline's ``LMStageParams`` (``embed``, a body
stacked ``[PP, L/PP, ...]``, ``head``) become each rank's
``parallel.LMStage`` dict through :func:`lm_stage_state_dict`.

A tree is a nested dict of numpy arrays (``state.params``, the
``{"params": ...}`` dict ``Module.init`` returns, or ``{"params": ...,
"batch_stats": ...}``), or an ``.npz`` whose keys are the ``/``-joined
paths (:func:`save_npz` writes one), or the bytes of flax's
``serialization.to_bytes`` of such a tree (:func:`from_flax_bytes`,
which reads them without flax). Loading casts each array to its
parameter's dtype (fp32 masters for training) and copies it into the
parameter as it is laid out (channels-last conv kernels stay so);
:func:`to_flax` goes back, ``state_dict`` -> nested dict of numpy arrays,
and the round trip is exact.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from edl_tpu_torch.rpc import _msgpack


STATS = ("mean", "var")  # batch_stats leaves: module buffers in the port


def _is_conv_kernel(path: str, arr) -> bool:
    return path.rsplit("/", 1)[-1].rsplit(".", 1)[-1] == "kernel" \
        and len(arr.shape) == 4


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/c": array}``; a variables dict
    (``params`` and optionally ``batch_stats``) is merged into one tree."""
    if not prefix and "params" in tree and set(tree) <= {"params",
                                                          "batch_stats"}:
        out = flatten(tree["params"])
        out.update(flatten(tree.get("batch_stats", {})))
        return out
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = "%s/%s" % (prefix, key) if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def to_state_dict(params) -> Dict[str, torch.Tensor]:
    """A flax param tree (nested dict, or an already flat ``/``-keyed
    dict) -> ``state_dict`` of CPU tensors in the arrays' dtypes."""
    flat = params if all(
        not isinstance(v, Mapping) for v in params.values()
    ) else flatten(params)
    out = {}
    for path, arr in flat.items():
        arr = np.array(arr, copy=True)
        if _is_conv_kernel(path, arr):
            arr = np.ascontiguousarray(arr.transpose(3, 2, 0, 1))  # OIHW
        out[path.replace("/", ".")] = torch.from_numpy(arr)
    return out


def to_flax(state_dict) -> Dict:
    """``state_dict`` (or ``named_parameters``) -> the flax tree as a
    nested dict of numpy arrays (bf16 tensors become fp32 arrays, conv
    kernels HWIO): the params tree, or ``{"params": ..., "batch_stats":
    ...}`` when the state holds batch-norm buffers."""
    params: Dict = {}
    stats: Dict = {}
    for key, tensor in dict(state_dict).items():
        *parents, leaf = key.split(".")
        node = stats if leaf in STATS else params
        for part in parents:
            node = node.setdefault(part, {})
        t = tensor.detach().cpu()
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if _is_conv_kernel(key, arr):
            arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))  # HWIO
        node[leaf] = arr
    return {"params": params, "batch_stats": stats} if stats else params


def lm_stage_state_dict(split, rank: int) -> Dict[str, torch.Tensor]:
    """Stage ``rank``'s ``state_dict`` (CPU tensors) from the JAX
    ``LMStageParams`` ``split`` (a named tuple or ``(embed, body, head)``
    of numpy trees): the body's ``[rank, j]`` entry is block
    ``layer_{rank·L/PP + j}``; the embedding goes to rank 0, ``ln_f`` and
    ``lm_head`` to the last rank."""
    embed, body, head = split
    flat = flatten(body)
    pp, lps = next(iter(flat.values())).shape[:2]
    out: Dict[str, torch.Tensor] = {}
    if rank == 0:
        out.update(to_state_dict({"embed": embed}))
    for j in range(lps):
        out.update(to_state_dict({
            "layer_%d/%s" % (rank * lps + j, path): np.asarray(arr)[rank, j]
            for path, arr in flat.items()}))
    if rank == pp - 1:
        out.update(to_state_dict(head))
    return out


def save_npz(params, path: str) -> None:
    """Write a flax param tree to ``path`` with ``/``-joined keys."""
    np.savez(path, **flatten(params))


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """``state_dict`` from an ``.npz`` of ``/``-joined flax paths."""
    with np.load(path) as data:
        return to_state_dict({k: data[k] for k in data.files})


def load_params(model: torch.nn.Module, params) -> torch.nn.Module:
    """Load a flax tree, a flat ``/``-keyed dict or an ``.npz`` path into
    ``model`` (strict: every key and shape must match); values are cast
    to each parameter's dtype and copied to its device."""
    sd = load_npz(params) if isinstance(params, str) else to_state_dict(params)
    model.load_state_dict(sd, strict=True)
    return model


# flax.serialization's msgpack ext code of an ndarray: the msgpack of
# (shape, dtype name, C-order bytes)
_EXT_NDARRAY = 1
_CHUNKED = "__msgpack_chunked_array__"


def _flax_ext(code: int, data: bytes) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError("flax msgpack ext type %d is not an array" % code)
    shape, dtype, raw = _msgpack.unpackb(data)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def from_flax_bytes(data: bytes) -> Dict:
    """The tree that flax's ``serialization.to_bytes`` wrote (``msgpack``
    of a nested dict with ext-type-1 array leaves) as nested dicts of
    numpy arrays, decoded by the port's own msgpack. Arrays above flax's
    1 GiB chunk size (written as chunk lists) are refused."""
    tree = _msgpack.unpackb(data, ext_hook=_flax_ext)

    def check(node):
        if isinstance(node, dict):
            if _CHUNKED in node:
                raise ValueError("chunked flax arrays (> 1 GiB) are not read")
            for value in node.values():
                check(value)

    check(tree)
    return tree
