"""Numpy arrays over the wire protocol.

The reference moves teacher predictions as Paddle-Serving feed/fetch
ndarray maps (python/edl/distill/distill_worker.py:262-291); here arrays
ride the same msgpack frames as everything else, tagged so decode is
unambiguous. Contiguous bytes only — no pickling, so frames are safe to
exchange with the native C++ runtime.
"""

from __future__ import annotations

import numpy as np

_ND_KEY = "__nd__"


def encode_ndarray(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        _ND_KEY: True,
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": arr.tobytes(),
    }


def decode_ndarray(obj: dict) -> np.ndarray:
    return np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"])).reshape(
        obj["shape"]
    )


def is_encoded_ndarray(obj) -> bool:
    return isinstance(obj, dict) and obj.get(_ND_KEY) is True


def encode_tree(obj):
    """Recursively encode ndarrays inside dicts/lists/tuples."""
    if isinstance(obj, np.ndarray):
        return encode_ndarray(obj)
    if isinstance(obj, (list, tuple)):
        return [encode_tree(x) for x in obj]
    if isinstance(obj, dict):
        return {k: encode_tree(v) for k, v in obj.items()}
    if isinstance(obj, (np.generic,)):
        return obj.item()
    return obj


def decode_tree(obj):
    if is_encoded_ndarray(obj):
        return decode_ndarray(obj)
    if isinstance(obj, list):
        return [decode_tree(x) for x in obj]
    if isinstance(obj, dict):
        return {k: decode_tree(v) for k, v in obj.items()}
    return obj


# -- zero-copy attachment refs (EDL2 frames) --------------------------------

_REF_KEY = "__ndref__"


def encode_tree_zc(obj):
    """Like :func:`encode_tree`, but arrays become offset refs into an
    attachment list of memoryviews (never copied): returns
    ``(encoded, attachments)`` for :func:`edl_tpu_torch.rpc.wire.pack_frame_buffers`.
    """
    attachments: list = []
    offset = [0]

    def walk(node):
        if isinstance(node, np.ndarray):
            arr = np.ascontiguousarray(node)
            # zero-size arrays can't be cast ("zeros in shape or strides")
            view = (
                memoryview(arr).cast("B") if arr.size else memoryview(b"")
            )
            ref = {
                _REF_KEY: True,
                "dtype": arr.dtype.str,
                "shape": list(arr.shape),
                "off": offset[0],
                "nbytes": view.nbytes,
            }
            attachments.append(view)
            offset[0] += view.nbytes
            return ref
        if isinstance(node, (list, tuple)):
            return [walk(x) for x in node]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, np.generic):
            return node.item()
        return node

    return walk(obj), attachments


def resolve_ndrefs(obj, att_region: memoryview):
    """Materialize refs produced by :func:`encode_tree_zc` as zero-copy
    (read-only) arrays over the received frame buffer."""
    if isinstance(obj, dict):
        if obj.get(_REF_KEY) is True:
            data = att_region[obj["off"] : obj["off"] + obj["nbytes"]]
            return np.frombuffer(data, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]
            )
        return {k: resolve_ndrefs(v, att_region) for k, v in obj.items()}
    if isinstance(obj, list):
        return [resolve_ndrefs(x, att_region) for x in obj]
    return obj
