"""Numerics plane: is the job still *learning*? The port of
``edl_tpu/obs/numerics.py``.

- :func:`device_bundle` — the per-step scalar bundle (loss, global grad
  norm, param norm, update ratio, non-finite element count, optional
  half-batch squared grad norms for the gradient-noise-scale estimate),
  over name -> tensor dicts instead of pytrees. It stays on the device as
  0-d fp32 tensors, and it is built from ``torch._foreach_*`` reductions:
  a few multi-tensor launches for all of a model's tensors, not several
  per tensor (the JAX package gets the same fusion from XLA).
- :class:`NumericsProbe` — the host half. Every step it starts a
  ``non_blocking`` copy of the bundle into a pinned host buffer and
  records a CUDA event; every ``EDL_NUMERICS_EVERY`` steps it publishes
  the *previous* step's bundle, whose copy has had a full step to land,
  so the probe never waits on the step in flight (no ``.item()`` on the
  current step). Published values become ``edl_train_*`` gauges, flight
  records (``numerics`` / ``nonfinite`` / ``loss_spike``), a windowed
  gradient-noise scale (McCandlish et al., *An Empirical Model of
  Large-Batch Training*) and a cross-replica parameter digest under
  ``/<job>/numerics/digest/<rank>``, read back as
  ``edl_train_replica_divergence``.
- the **resize continuity sentinel** — :func:`stamp_fingerprint` puts a
  ``{step, loss, param_norm}`` fingerprint into the checkpoint's status
  document at save (the loss is :func:`latest_loss`, the probe's newest),
  :func:`verify_fingerprint` re-derives the parameter norm at restore,
  and :meth:`NumericsProbe.expect` checks the first post-resume loss
  against the stamped one within ``EDL_NUMERICS_LOSS_TOL``, recorded as
  ``numerics_resume`` for the ``numerics_continuous`` invariant.

Knobs, with the JAX package's defaults: ``EDL_NUMERICS`` (``0`` disables
the plane), ``EDL_NUMERICS_EVERY`` (8), ``EDL_NUMERICS_GNS`` (``0`` skips
the half-batch gradient pass), ``EDL_NUMERICS_FP_TOL`` (1e-4),
``EDL_NUMERICS_LOSS_TOL`` (0.5).
"""

from __future__ import annotations

import collections
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("obs.numerics")

#: reserved key the step passes its bundle under in the metrics dict —
#: the loop pops it before metrics aggregation
METRICS_KEY = "_numerics"

ENV_ENABLED = "EDL_NUMERICS"
ENV_EVERY = "EDL_NUMERICS_EVERY"
ENV_GNS = "EDL_NUMERICS_GNS"
ENV_FP_TOL = "EDL_NUMERICS_FP_TOL"
ENV_LOSS_TOL = "EDL_NUMERICS_LOSS_TOL"

DEFAULT_EVERY = 8
DEFAULT_FP_TOL = 1e-4       # fingerprint param-norm relative tolerance
DEFAULT_LOSS_TOL = 0.5      # post-resume loss-continuity relative tolerance

_GNS_WINDOW = 32            # (g2, s) pairs retained for the windowed GNS
_SPIKE_HISTORY = 64         # published losses retained for spike detection
_SPIKE_MIN_HISTORY = 6      # finite points required before a z is trusted
_SPIKE_Z = 4.0              # host-side twin of the loss-spike monitor rule
_DIGEST_SERVICE = "numerics"

# the bundle's scalars in their packed order (half_sq is two values)
_SCALARS = ("loss", "grad_norm", "param_norm", "update_ratio", "nonfinite")

# newest (step, fetch) any probe in this process has seen —
# fingerprint_for_save reads the loss out of it at checkpoint time (a
# save is already a sync point, so waiting for that copy is free)
_LATEST: Optional[Tuple[int, "_Fetch"]] = None
_LATEST_LOCK = threading.Lock()


def enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "1") != "0"


def gns_enabled() -> bool:
    return os.environ.get(ENV_GNS, "1") != "0"


def _reset() -> None:
    """Forget cross-probe module state (tests)."""
    global _LATEST
    with _LATEST_LOCK:
        _LATEST = None


# -- device side ----------------------------------------------------------


def floating(tree) -> List[torch.Tensor]:
    """The floating tensors of a ``name -> tensor`` dict (in name order),
    a sequence or one tensor, detached. Non-floating entries are skipped,
    as the JAX bundle skips non-inexact leaves."""
    if torch.is_tensor(tree):
        items = [tree]
    elif isinstance(tree, dict):
        items = [tree[k] for k in sorted(tree)]
    else:
        items = list(tree)
    return [t.detach() for t in items
            if torch.is_tensor(t) and t.is_floating_point()]


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _split_shards(tensors: List[torch.Tensor]):
    """``(whole, shards, group)``: the plain tensors, the local shards of
    the ``DTensor`` ones (FSDP2's parameters, gradients and optimizer
    state) and the group their shards are spread over (the mesh dim they
    are ``Shard`` on; replicated dims hold copies and are not summed)."""
    from torch.distributed.tensor import DTensor

    whole, shards, group = [], [], None
    for t in tensors:
        if not isinstance(t, DTensor):
            whole.append(t)
            continue
        dims = [i for i, pl in enumerate(t.placements) if pl.is_shard()]
        if not dims:
            whole.append(t.to_local())
            continue
        if group is None:
            group = t.device_mesh.get_group(dims[0])
        shards.append(t.to_local())
    return whole, shards, group


def _sum_over(local: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(local, group=group)
    return local


def global_norm(tensors: List[torch.Tensor], device=None) -> torch.Tensor:
    """The global L2 norm of ``tensors`` as a 0-d fp32 tensor: one
    ``_foreach_norm`` (fp32 accumulation) and the norm of the per-tensor
    norms. Over ``DTensor`` shards each rank's sum of squares is summed
    over the shards' group (one all-reduce: collective) before the root,
    so every rank gets the norm of the whole tensors."""
    if not tensors:
        return _zero(device)
    whole, shards, group = _split_shards(tensors)
    if not shards:
        norms = torch._foreach_norm(whole, 2, dtype=torch.float32)
        return torch.linalg.vector_norm(torch.stack(norms))
    sq = torch.stack(torch._foreach_norm(shards, 2, dtype=torch.float32)
                     ).square().sum()
    sq = _sum_over(sq, group)
    if whole:
        sq = sq + torch.stack(torch._foreach_norm(
            whole, 2, dtype=torch.float32)).square().sum()
    return sq.sqrt()


def _count_nonfinite(tensors: List[torch.Tensor]) -> torch.Tensor:
    marks = torch._foreach_mul(tensors, 0.0)
    torch._foreach_add_(marks, 1.0)
    torch._foreach_sign_(marks)
    torch._foreach_sub_(marks, 1.0)
    counts = torch._foreach_norm(marks, 1, dtype=torch.float32)
    return torch.stack(counts).sum()


def nonfinite_count(tensors: List[torch.Tensor], device=None) -> torch.Tensor:
    """The number of inf/NaN elements in ``tensors`` as a 0-d fp32 tensor,
    in five multi-tensor passes: ``x*0 + 1`` is 1 where ``x`` is finite
    and NaN elsewhere; its sign is 1 or 0 (``sign`` compares, and NaN
    compares false); less 1 and summed by an L1 norm, minus the count.
    The count per tensor is exact below 2**24. ``DTensor`` shards'
    counts are summed over their group, as in :func:`global_norm`."""
    if not tensors:
        return _zero(device)
    whole, shards, group = _split_shards(tensors)
    if not shards:
        return _count_nonfinite(whole)
    count = _sum_over(_count_nonfinite(shards), group)
    return count + _count_nonfinite(whole) if whole else count


def _fp32(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    if all(t.dtype == torch.float32 for t in tensors):
        return tensors
    return [t.float() for t in tensors]


def assemble(loss, grad_norm, param_norm, old_norm, delta_norm, nonfinite,
             half_sq: Optional[torch.Tensor] = None,
             batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The bundle dict from its reductions (the train step computes them
    at the points of the step where their inputs live)."""
    loss32 = loss.detach().float().reshape(())
    bundle = {
        "loss": loss32,
        "grad_norm": grad_norm,
        "param_norm": param_norm,
        "update_ratio": delta_norm / old_norm.clamp(min=1e-12),
        "nonfinite": nonfinite + (~torch.isfinite(loss32)).float(),
    }
    if half_sq is not None:
        bundle["half_sq"] = half_sq
        # a fill on the device: a host value copied in would wait for the
        # step queued before it
        bundle["batch"] = torch.full(
            (), float(0 if batch is None else batch), device=loss32.device)
    return bundle


def device_bundle(
    loss,
    grads,
    params,
    new_params,
    halves: Optional[Tuple[Any, Any]] = None,
    batch: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """The per-step scalar bundle: a dict of 0-d fp32 tensors (plus the
    2-vector ``half_sq`` when the GNS half-gradients are given).
    ``grads``, ``params`` (pre-update) and ``new_params`` (post-update)
    are ``name -> tensor`` dicts (or sequences in one order); the new
    parameter norm doubles as the cross-replica digest."""
    loss = torch.as_tensor(loss, dtype=torch.float32)
    dev = loss.device
    g = floating(grads)
    old = floating(params)
    new = floating(new_params)
    delta = torch._foreach_sub(_fp32(new), _fp32(old)) if new else []
    half_sq = None
    if halves is not None:
        half_sq = torch.stack([global_norm(floating(h), dev).square()
                               for h in halves])
    return assemble(
        loss, global_norm(g, dev), global_norm(new, dev),
        global_norm(old, dev), global_norm(delta, dev),
        nonfinite_count(g, dev), half_sq=half_sq, batch=batch,
    )


def gns_estimates(big_sq: float, small_sq: float, batch: float) -> Tuple[float, float]:
    """One-step unbiased estimators from McCandlish et al. appendix A:
    given ``|G_big|^2`` at batch ``B`` and the mean half-batch
    ``|G_small|^2`` at ``B/2``, return ``(|G|^2 estimate, tr(Sigma)
    estimate)``; the noise scale is ``mean(s) / mean(g2)`` over a
    window of these pairs (each pair alone is far too noisy)."""
    # g2 = (B_big*big - B_small*small) / (B_big - B_small), B_small = B/2
    g2 = 2.0 * big_sq - small_sq
    # s = (small - big) / (1/B_small - 1/B_big) = B * (small - big)
    s = batch * (small_sq - big_sq)
    return g2, s


# -- fingerprints (the resize continuity sentinel) ------------------------


def host_param_norm(state) -> float:
    """The global L2 norm of the floating parameters, in float64: each
    tensor's sum of squares is taken in float64 where it lives, and the
    sums are added on the host in parameter-name order. The save-time and
    restore-time sides run the same math, so a match is exact up to
    float64 rounding. A ``DTensor``'s sum is its shards' sums, added over
    their group in one float64 all-reduce for all of them (collective:
    every rank of a sharded state calls this at the same point).

    ``state`` is a ``TrainState``, a module or a ``name -> tensor`` dict;
    a data-parallel wrapper's ``module.`` prefix does not change the
    order."""
    from torch.distributed.tensor import DTensor

    params = getattr(state, "params", state)
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    items = [p.detach() for _name, p in sorted(params.items())
             if torch.is_tensor(p) and p.is_floating_point()]
    sums = [torch.sum(torch.square(p.to_local().double()))
            if isinstance(p, DTensor) else
            float(torch.sum(torch.square(p.double()))) for p in items]
    sharded = [i for i, p in enumerate(items) if isinstance(p, DTensor)]
    if sharded:
        _whole, _shards, group = _split_shards([items[sharded[0]]])
        local = torch.stack([sums[i] for i in sharded])
        if group is not None:
            import torch.distributed as dist

            if dist.get_backend(group) == "gloo":
                local = local.cpu()  # float64 through the host
            local = _sum_over(local, group)
        for i, v in zip(sharded, local.tolist()):
            sums[i] = v
    total = 0.0
    for v in sums:
        total += v
    return math.sqrt(total)


def latest_loss() -> Optional[float]:
    """The newest loss any probe in this process has buffered (waits for
    that step's copy; None when no probe has run or the value is
    non-finite — ``json`` cannot carry Infinity portably and a non-finite
    stamp could never gate continuity anyway)."""
    with _LATEST_LOCK:
        latest = _LATEST
    if latest is None:
        return None
    try:
        loss = latest[1].values()["loss"]
    except (RuntimeError, KeyError):
        return None
    return loss if math.isfinite(loss) else None


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
        tol = float(os.environ.get(ENV_FP_TOL, DEFAULT_FP_TOL))
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


# -- host side ------------------------------------------------------------


class _Fetch:
    """One step's bundle on its way to the host: packed into one vector,
    copied without blocking into a host buffer (pinned on the card), and
    the event that marks the copy done."""

    __slots__ = ("names", "host", "event", "_vals")

    def __init__(self, bundle: Dict[str, Any], host_buf) -> None:
        self.event = None
        self._vals: Optional[Dict[str, Any]] = None
        names, parts = [], []
        for key in _SCALARS + ("half_sq", "batch"):
            if key not in bundle:
                continue
            v = bundle[key]
            t = v.detach() if torch.is_tensor(v) else torch.tensor(v)
            t = t.reshape(-1).float()
            names.extend([key] * t.numel())
            parts.append(t)
        dev = parts[0].device
        packed = torch.cat([p.to(dev) for p in parts])
        self.names = names
        if packed.is_cuda:
            host = host_buf(packed.numel())
            host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
            self.host = host
        else:
            self.host = packed.clone()

    def values(self) -> Dict[str, Any]:
        """The bundle as host numbers (waits for the copy, once)."""
        if self._vals is None:
            if self.event is not None:
                self.event.synchronize()
            flat = self.host.tolist()
            vals: Dict[str, Any] = {}
            for name, v in zip(self.names, flat):
                if name == "half_sq":
                    vals.setdefault(name, []).append(v)
                else:
                    vals[name] = v
            self._vals = vals
        return self._vals


class NumericsProbe:
    """Host half of the plane: throttled device->host transfer, metric
    export, GNS/digest/spike derivation, and the resume-continuity
    check. One instance per training process; not thread-safe beyond
    the module-level latest-bundle buffer (the train loop is the only
    caller)."""

    def __init__(
        self,
        every: Optional[int] = None,
        rank: int = 0,
        client=None,
        job_id: str = "",
    ) -> None:
        if every is None:
            every = int(os.environ.get(ENV_EVERY, DEFAULT_EVERY))
        self.every = max(1, int(every))
        self.rank = int(rank)
        self._client = client
        self._job = job_id
        self._loss_tol = float(os.environ.get(ENV_LOSS_TOL, DEFAULT_LOSS_TOL))
        self._calls = 0
        self._held: Optional[Tuple[int, _Fetch]] = None
        self._last_pub_step: Optional[int] = None
        self._gns_win: collections.deque = collections.deque(maxlen=_GNS_WINDOW)
        self._loss_hist: collections.deque = collections.deque(maxlen=_SPIKE_HISTORY)
        self._expected: Optional[Dict] = None
        self._gauges: Dict[str, obs_metrics.Gauge] = {}
        self._nonfinite: Optional[obs_metrics.Counter] = None
        self._closed = False
        # two pinned host buffers, alternating: step n's copy never lands
        # in the buffer of step n-1, the one the next publish reads
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._slot = 0
        self.published = 0  # publishes performed (tests assert throttling)

    def _host_buf(self, n: int) -> torch.Tensor:
        buf = self._bufs[self._slot]
        if buf is None or buf.numel() != n:
            buf = torch.empty(n, dtype=torch.float32, pin_memory=True)
            self._bufs[self._slot] = buf
        self._slot ^= 1
        return buf

    # -- step ingestion ---------------------------------------------------

    def on_step(self, step: int, bundle: Optional[Dict[str, Any]]) -> None:
        """Buffer this step's bundle (its host copy starts now, without
        waiting); publish on the throttle cadence. Publishing reads the
        *previous* buffered bundle — retired by a full step of device
        work — except on the very first call, which publishes this one
        (waiting for it) so the plane is armed with real data the moment
        training produces any (a registered-but-never-set gauge would
        render 0.0 and trip the grad-stall rule during a long first
        step)."""
        if self._closed or bundle is None:
            return
        self._calls += 1
        prev = self._held
        self._held = (int(step), _Fetch(bundle, self._host_buf))
        global _LATEST
        with _LATEST_LOCK:
            _LATEST = self._held
        if self._calls == 1:
            self._publish(*self._held)
        elif self._calls % self.every == 0 and prev is not None:
            self._publish(*prev)

    def close(self) -> None:
        """Flush the held bundle (the final step's numbers must not be
        lost to the throttle) and stop accepting steps."""
        if self._closed:
            return
        self._closed = True
        if self._held is not None:
            self._publish(*self._held)

    def expect(self, fingerprint: Optional[Dict]) -> None:
        """Arm the post-resume continuity check: at the next publish the
        observed loss is compared against the checkpoint's stamped loss
        and the verdict is flight-recorded as ``numerics_resume`` (the
        ``numerics_continuous`` chaos invariant reads these). A None
        fingerprint arms nothing."""
        if isinstance(fingerprint, dict):
            self._expected = fingerprint

    # -- publication ------------------------------------------------------

    def _gauge(self, name: str, help_text: str) -> obs_metrics.Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = obs_metrics.gauge(name, help_text)
            self._gauges[name] = g
        return g

    def _publish(self, step: int, fetch: _Fetch) -> None:
        if step == self._last_pub_step:
            return
        self._last_pub_step = step
        try:
            vals = fetch.values()
        except Exception as exc:  # noqa: BLE001 — a failed copy must not kill the loop
            logger.warning("numerics fetch failed at step %d: %s", step, exc)
            return
        self.published += 1
        loss = float(vals["loss"])
        grad_norm = float(vals["grad_norm"])
        param_norm = float(vals["param_norm"])
        update_ratio = float(vals["update_ratio"])
        nonfinite = int(vals["nonfinite"])

        self._gauge("edl_train_loss", "training loss, last published step").set(loss)
        self._gauge(
            "edl_train_grad_norm", "global gradient L2 norm, last published step"
        ).set(grad_norm)
        self._gauge(
            "edl_train_param_norm",
            "global parameter L2 norm (the cross-replica digest)",
        ).set(param_norm)
        self._gauge(
            "edl_train_update_ratio",
            "|param update| / |params|, last published step",
        ).set(update_ratio)
        if self._nonfinite is None:
            # the counter registers with the gauges (renders 0 from the
            # first publish) so the nan-detected rate rule sees the
            # 0 -> N jump instead of a series born already at N
            self._nonfinite = obs_metrics.counter(
                "edl_train_nonfinite_total",
                "non-finite elements seen in gradients/loss",
            )
        if nonfinite > 0:
            self._nonfinite.inc(nonfinite)
            obs_events.record(
                "nonfinite", fsync=True, step=step, count=nonfinite, loss=loss
            )

        gns = self._update_gns(vals)
        divergence = self._update_divergence(step, param_norm)
        self._check_spike(step, loss)
        self._resolve_expected(step, loss)
        obs_events.record(
            "numerics",
            step=step,
            loss=loss,
            grad_norm=grad_norm,
            param_norm=param_norm,
            update_ratio=update_ratio,
            nonfinite=nonfinite,
            gns=gns,
            divergence=divergence,
        )

    def _update_gns(self, vals) -> Optional[float]:
        half_sq = vals.get("half_sq")
        if half_sq is None:
            return None
        batch = float(vals.get("batch", 0.0))
        big_sq = float(vals["grad_norm"]) ** 2
        small_sq = sum(float(v) for v in half_sq) / len(half_sq)
        if batch < 2 or not (math.isfinite(big_sq) and math.isfinite(small_sq)):
            return None
        self._gns_win.append(gns_estimates(big_sq, small_sq, batch))
        mean_g2 = sum(p[0] for p in self._gns_win) / len(self._gns_win)
        mean_s = sum(p[1] for p in self._gns_win) / len(self._gns_win)
        if mean_g2 <= 1e-12:
            return None  # all signal is noise: no stable estimate yet
        gns = mean_s / mean_g2
        self._gauge(
            "edl_train_grad_noise_scale",
            "windowed gradient-noise-scale estimate (McCandlish et al.)",
        ).set(gns)
        return gns

    def _update_divergence(self, step: int, param_norm: float) -> Optional[float]:
        """Publish this replica's digest and read the spread across dp
        replicas *at the same step* (digests from different steps are
        incomparable: params move every step). Best-effort: a dead
        store reads as no divergence signal, never as a stall."""
        if self._client is None or not self._job:
            return None
        prefix = "/%s/%s/digest/" % (self._job, _DIGEST_SERVICE)
        try:
            self._client.put(
                prefix + str(self.rank),
                json.dumps({"step": step, "digest": param_norm}).encode(),
            )
            rows, _rev = self._client.range(prefix)
        except Exception as exc:  # noqa: BLE001
            logger.warning("digest exchange failed: %s", exc)
            return None
        digests = []
        for _key, value, _c, _m in rows:
            try:
                doc = json.loads(value)
            except ValueError:
                continue
            if doc.get("step") == step:
                digests.append(float(doc.get("digest", 0.0)))
        if len(digests) < 2:
            return None  # peers not at this step yet: nothing comparable
        spread = (max(digests) - min(digests)) / max(abs(max(digests)), 1e-12)
        self._gauge(
            "edl_train_replica_divergence",
            "relative spread of the param digest across dp replicas",
        ).set(spread)
        return spread

    def _check_spike(self, step: int, loss: float) -> None:
        """Host-side twin of the ``loss-spike`` monitor rule, so the
        flight recorder carries the instant even when no monitor is
        scraping this process (edl-timeline overlays these)."""
        hist = [v for v in self._loss_hist if math.isfinite(v)]
        if math.isfinite(loss):
            self._loss_hist.append(loss)
        if len(hist) < _SPIKE_MIN_HISTORY:
            return
        mean = sum(hist) / len(hist)
        var = sum((v - mean) ** 2 for v in hist) / len(hist)
        std = max(math.sqrt(var), 0.05 * abs(mean), 1e-12)
        z = (loss - mean) / std if math.isfinite(loss) else float("inf")
        if z > _SPIKE_Z:
            obs_events.record(
                "loss_spike", fsync=True, step=step, loss=loss,
                z=(z if math.isfinite(z) else 1e30), mean=mean,
            )

    def _resolve_expected(self, step: int, loss: float) -> None:
        if self._expected is None:
            return
        fp = self._expected
        self._expected = None
        want = fp.get("loss")
        if want is None:
            ok = math.isfinite(loss)
            rel = None
            detail = "no stamped loss; observed %s" % ("finite" if ok else "non-finite")
        elif not math.isfinite(loss):
            ok, rel = False, None
            detail = "post-resume loss is non-finite"
        else:
            rel = (loss - float(want)) / max(abs(float(want)), 1e-9)
            ok = rel <= self._loss_tol
            detail = "rel %.3g vs tol %.3g" % (rel, self._loss_tol)
        obs_events.record(
            "numerics_resume",
            fsync=True,
            step=step,
            ok=ok,
            expected_loss=want,
            actual_loss=loss if math.isfinite(loss) else None,
            rel=rel,
            ref_step=fp.get("step"),
            detail=detail,
        )
        if not ok:
            logger.warning(
                "resume continuity FAILED at step %d: %s (ckpt step %s)",
                step, detail, fp.get("step"),
            )
