"""Numerics plane, the fingerprint half: the port of the resize
continuity sentinel of ``edl_tpu/obs/numerics.py``.

:func:`stamp_fingerprint` puts a ``{step, loss, param_norm}`` fingerprint
into the checkpoint's status document at save; :func:`verify_fingerprint`
re-derives the parameter norm at restore, and the checkpoint manager
quarantines a version whose norm does not match, like any corrupt one.

The probe (the fused bundle, its throttled export, the gradient noise
scale, the cross-replica digest and the post-resume loss check) comes with
slice 3b; until then :func:`latest_loss` has nothing to report.

Knobs: ``EDL_NUMERICS`` (``0`` disables the plane), ``EDL_NUMERICS_FP_TOL``
(fingerprint param-norm relative tolerance).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

DEFAULT_FP_TOL = 1e-4       # fingerprint param-norm relative tolerance


def enabled() -> bool:
    return os.environ.get("EDL_NUMERICS", "1") != "0"


def host_param_norm(state) -> float:
    """The global L2 norm of the floating parameters, in float64: each
    tensor's sum of squares is taken in float64 where it lives, and the
    sums are added on the host in parameter-name order. The save-time and
    restore-time sides run the same math, so a match is exact up to
    float64 rounding.

    ``state`` is a ``TrainState``, a module or a ``name -> tensor`` dict;
    a data-parallel wrapper's ``module.`` prefix does not change the
    order."""
    params = getattr(state, "params", state)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    total = 0.0
    for _name, p in sorted(params.items()):
        if not (torch.is_tensor(p) and p.is_floating_point()):
            continue
        total += float(torch.sum(torch.square(p.detach().double())))
    return math.sqrt(total)


def latest_loss() -> Optional[float]:
    """The newest loss a probe has buffered: None until the probe is
    ported (slice 3b)."""
    return None


def fingerprint_for_save(state, step: int) -> Dict[str, Any]:
    return {
        "step": int(step),
        "param_norm": host_param_norm(state),
        "loss": latest_loss(),
    }


def stamp_fingerprint(status_doc: Dict, state, step: int) -> Dict:
    """Return a copy of the checkpoint status document carrying the
    numerics fingerprint under ``meta.numerics`` (no-op when the plane
    is disabled)."""
    if not enabled():
        return status_doc
    doc = dict(status_doc)
    meta = dict(doc.get("meta") or {})
    meta["numerics"] = fingerprint_for_save(state, step)
    doc["meta"] = meta
    return doc


def verify_fingerprint(state, fingerprint, tol: Optional[float] = None) -> Tuple[bool, str]:
    """Re-derive the restored state's param norm and compare against the
    stamped one. A mismatch means the bytes the checkpoint handed back are
    not the bytes the trainer saved — the caller treats the candidate like
    any other corrupt checkpoint (fallback + quarantine)."""
    if not fingerprint or not enabled():
        return True, "no fingerprint"
    want = fingerprint.get("param_norm") if isinstance(fingerprint, dict) else None
    if want is None:
        return True, "fingerprint has no param_norm"
    if tol is None:
        tol = float(os.environ.get("EDL_NUMERICS_FP_TOL", DEFAULT_FP_TOL))
    have = host_param_norm(state)
    if not math.isfinite(have):
        return False, "restored param norm is non-finite (%r)" % have
    rel = abs(have - float(want)) / max(abs(float(want)), 1e-12)
    if rel > tol:
        return False, (
            "param norm %.9g vs stamped %.9g at step %s (rel %.3g > %.3g)"
            % (have, float(want), fingerprint.get("step"), rel, tol)
        )
    return True, "param norm match (rel %.3g)" % rel
