"""Flax params <-> PyTorch ``state_dict``, 1:1.

The port's modules carry the flax names and shapes
(:mod:`edl_tpu_torch.models.transformer`), so the conversion is a rename:
the param path ``layer_0/attn/q/kernel`` becomes the key
``layer_0.attn.q.kernel``, same shape. For ``TransformerLM``:

    embed/embedding            [V, d]
    layer_i/{ln1,ln2}/scale    [d]
    layer_i/attn/{q,k,v}/kernel [d, H|KV, D]
    layer_i/attn/o/kernel      [H, D, d]
    layer_i/mlp/{gate,up,down}/kernel
    ln_f/scale                 [d]
    lm_head/kernel             [d, V]

A tree is a nested dict of numpy arrays (``state.params``, or the
``{"params": ...}`` dict ``Module.init`` returns), or an ``.npz`` whose
keys are the ``/``-joined paths (:func:`save_npz` writes one). Loading
casts each array to its parameter's dtype (fp32 masters for training);
:func:`to_flax` goes back, ``state_dict`` -> nested dict of numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> ``{"a/b/c": array}``; unwraps a lone ``params`` key."""
    if not prefix and set(tree) == {"params"}:
        tree = tree["params"]
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
    return {
        path.replace("/", "."): torch.from_numpy(np.array(arr, copy=True))
        for path, arr in flat.items()
    }


def to_flax(state_dict) -> Dict:
    """``state_dict`` (or ``named_parameters``) -> the flax param tree as
    a nested dict of numpy arrays (bf16 tensors become fp32 arrays)."""
    tree: Dict = {}
    for key, tensor in dict(state_dict).items():
        node = tree
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        t = tensor.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


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
