"""Pipeline parallelism: the GPipe fill-drain schedule over the ``pp`` axis,
the port of ``edl_tpu/parallel/pipeline.py``.

Each ``pp`` rank holds one stage of the model and runs it on every
microbatch; activations flow rank to rank with
:func:`~edl_tpu_torch.parallel.collectives.neighbour_exchange` (through
pinned host memory on a gloo group), one tick at a time. Stage ``r`` runs
microbatch ``m`` at tick ``r + m``, so ``M`` microbatches drain through
``PP`` stages in ``M + PP - 1`` ticks (:func:`pipeline_efficiency` is the
ideal share of busy ticks).

The stage contract is the JAX function's: ``body_fn(act) -> act``, the
repeated part every rank runs, keeps the activation's shape and dtype;
``first_fn(feed) -> act`` runs on ``pp`` rank 0 only (token ids into the
circulating activation), ``last_fn(act[, aux]) -> y`` on the last rank
only (logits, or a per-example loss so that only scalars leave the
pipeline). ``x`` (and ``last_aux``) are the GLOBAL batch on every rank, as
a replicated JAX array is: it is cut into ``M`` microbatches of ``mb``
rows, and with ``batch_axis`` (``"dp"``) each ``dp`` rank takes its
``mb / dp`` rows of every microbatch, as ``shard_map`` hands
``P(None, batch_axis)`` to each device.

Where JAX gets GPipe's gradient from autodiff (the transpose of
``ppermute`` is the reverse permute), autograd here ends at the process:
:func:`pipeline_loss_and_grads` runs the fill-drain schedule explicitly,
``M`` forwards keeping each microbatch's graph, then ``M`` backwards in
reverse order, each sending the cotangent of its stage input one rank
back. It leaves the stage's gradients in ``.grad`` (summed over
``batch_axis``: every microbatch's loss is scaled by the global example
count) and returns the mean loss on every rank. The 1F1B schedule
(``pipeline_1f1b``) runs on the same tick runner, :class:`_Stage`.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

import torch
import torch.distributed as dist

from edl_tpu_torch.parallel.collectives import (
    _gather_stacked,
    all_reduce_,
    group_size,
    neighbour_exchange,
)

# the dtypes a stage's activation may have, by code (the shape handshake)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32)
_MAX_DIMS = 8


def pipeline_efficiency(num_microbatches: int, pp: int) -> float:
    """GPipe ideal utilization: M busy ticks out of M + PP - 1 total."""
    return num_microbatches / (num_microbatches + pp - 1)


def _check_axes(mesh, axis: str, batch_axis: Optional[str]) -> None:
    for name in (axis, batch_axis):
        if name is not None and name not in mesh.shape:
            raise ValueError("mesh has no %r axis (axes: %r)"
                             % (name, mesh.axis_names))


def _microbatches(x: torch.Tensor, num_micro: int, mesh,
                  batch_axis: Optional[str]) -> List[torch.Tensor]:
    """``x [batch, ...]`` as ``M`` microbatches of this rank's rows: all
    ``mb`` rows, or with ``batch_axis`` its ``mb / n`` rows of each."""
    batch = x.shape[0]
    if batch % num_micro:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (batch, num_micro))
    mb = batch // num_micro
    micro = x.reshape((num_micro, mb) + tuple(x.shape[1:]))
    if batch_axis is not None:
        n = mesh.shape[batch_axis]
        if mb % n:
            raise ValueError(
                "microbatch size %d not divisible by %r axis size %d"
                % (mb, batch_axis, n))
        rows = mb // n
        start = mesh.coords[batch_axis] * rows
        micro = micro[:, start:start + rows]
    return list(micro.unbind(0))


def _describe(t: Optional[torch.Tensor], device) -> torch.Tensor:
    """A tensor's dtype code, rank and shape as int64 ``[2 + _MAX_DIMS]``
    (zeros for None): summed over a group, the one rank's that has it."""
    out = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
    if t is not None:
        if t.dim() > _MAX_DIMS or t.dtype not in _DTYPES:
            raise ValueError("a stage activation of %s %s cannot cross stages"
                             % (t.dtype, tuple(t.shape)))
        out[0] = _DTYPES.index(t.dtype) + 1
        out[1] = t.dim()
        out[2:2 + t.dim()] = torch.tensor(t.shape)
    return out.to(device)


def _spec(desc: torch.Tensor):
    d = desc.tolist()
    return tuple(d[2:2 + d[1]]), _DTYPES[d[0] - 1]


def _shared_spec(t: Optional[torch.Tensor], group, device):
    """``(shape, dtype)`` of the tensor ONE rank of ``group`` holds (the
    others pass None), on every rank: one small all-reduce (on the host
    for gloo, on the card for NCCL)."""
    if dist.get_backend(group) == "gloo":
        device = "cpu"
    return _spec(all_reduce_(_describe(t, device), group))


class _Stage:
    """One ``pp`` rank's side of a schedule: its forward and backward
    ops on microbatches and the tick loop that moves activations forward
    and cotangents back.

    ``loss=True``: ``last_fn`` gives per-example losses, summed into the
    global mean; under grad mode the stage trains. ``recompute=False``
    (GPipe) keeps each microbatch's graph from its
    forward to its backward; ``recompute=True`` (1F1B) runs the forward
    without a graph, keeps the stage input (at most ``PP`` of them, slot
    ``m % PP``) and runs it again with a graph at the backward, as the
    JAX ``do_b`` does. ``live_max`` is the most microbatches whose stage
    input or graph this rank held at once."""

    def __init__(self, body_fn, first_fn, last_fn, feeds, aux, mesh,
                 axis: str, batch_scale: float, recompute: bool,
                 loss: bool) -> None:
        self.body_fn, self.first_fn, self.last_fn = body_fn, first_fn, last_fn
        self.feeds, self.aux = feeds, aux
        self.pp = mesh.shape[axis]
        self.rank = mesh.coords[axis]
        self.group = mesh.group(axis) if self.pp > 1 else None
        self.device = mesh.device
        self.batch_scale = batch_scale
        self.recompute = recompute
        self.loss = loss  # the last rank reduces last_fn's output to a loss
        self.grad = loss and torch.is_grad_enabled()
        self.first = self.rank == 0
        self.last = self.rank == self.pp - 1
        self.arrived = {}   # m -> activation received, not yet forwarded
        self.held = {}      # m -> what the backward of m needs
        self.cotangents = {}  # m -> cotangent received for m's output
        self.outputs = {}   # m -> last_fn's output (no graph)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        self.live_max = 0
        self.act_spec = None

    # -- the ops ---------------------------------------------------------

    def _input(self, m: int, grad: bool):
        """The stage input of ``m``: rank 0's ``first_fn`` of the feed
        (with its graph to the embedding), another rank's received
        activation (a leaf that collects its cotangent when ``grad``)."""
        if self.first:
            feed = self.feeds[m]
            return self.first_fn(feed) if self.first_fn else feed
        act = self.arrived.pop(m)
        if grad and act.is_floating_point():
            act = act.detach().requires_grad_(True)
        return act

    def _run(self, act, m: int):
        """The stage on ``act``: the body, and on the last rank
        ``last_fn`` (per-example losses reduced to this microbatch's
        share of the global mean when training)."""
        y = self.body_fn(act)
        if y.shape != act.shape or y.dtype != act.dtype:
            raise ValueError(
                "body_fn must preserve the activation shape/dtype (%s %s -> "
                "%s %s); shape changes belong in first_fn/last_fn"
                % (act.dtype, tuple(act.shape), y.dtype, tuple(y.shape)))
        if not self.last or self.last_fn is None:
            return y
        args = (y,) if self.aux is None else (y, self.aux[m])
        return self.last_fn(*args)

    def forward(self, m: int):
        """F of microbatch ``m``; the activation to send on (None on the
        last rank)."""
        keep_graph = self.grad and not self.recompute
        with torch.set_grad_enabled(keep_graph):
            act = self._input(m, keep_graph)
            out = self._run(act, m)
        if self.last:
            if self.loss:
                loss = out.float().sum() * self.batch_scale
                self.loss_sum += loss.detach()
                out = loss
            else:
                self.outputs[m] = out
        if self.grad:
            # GPipe: the input leaf and the output's graph; 1F1B: the
            # input alone (rank 0: its feed, recomputed from it) at slot
            # m % PP, which the schedule has freed
            key = self._slot(m)
            if key in self.held:
                raise RuntimeError("stash slot %d still holds a microbatch "
                                   "at the forward of %d" % (key, m))
            self.held[key] = (act, out) if keep_graph else (
                self.feeds[m] if self.first else act)
            self.live_max = max(self.live_max, len(self.held)
                                + len(self.arrived))
        return None if self.last else out.detach()

    def _slot(self, m: int) -> int:
        return m % self.pp if self.recompute else m

    def backward(self, m: int):
        """B of microbatch ``m``; the cotangent of its stage input to send
        back (None on rank 0)."""
        held = self.held.pop(self._slot(m))
        if self.recompute:
            if not self.first:
                self.arrived[m] = held
            with torch.enable_grad():
                act = self._input(m, True)
                out = self._run(act, m)
                if self.last:
                    out = out.float().sum() * self.batch_scale
        else:
            act, out = held
        if self.last:
            torch.autograd.backward(out)
        else:
            torch.autograd.backward(out, self.cotangents.pop(m))
        if self.first:
            return None
        return act.grad if act.grad is not None else torch.zeros_like(act)

    # -- the tick loop -----------------------------------------------------

    def run(self, ops: Callable, ticks: int) -> None:
        """Tick ``t``: this rank's ``ops(t, rank) -> (m_f, m_b)`` (None
        where it has no op), then one :func:`neighbour_exchange`: what its
        forward made to rank + 1, what its backward made to rank - 1, and
        from its neighbours what their ops at ``t`` made for it."""
        if self.pp > 1:
            probe = None
            if self.first:
                with torch.no_grad():
                    feed = self.feeds[0]
                    probe = self.first_fn(feed) if self.first_fn else feed
            self.act_spec = _shared_spec(probe, self.group, self.device)
        for t in range(ticks):
            m_f, m_b = ops(t, self.rank)
            to_next = None if m_f is None else self.forward(m_f)
            to_prev = None if m_b is None else self.backward(m_b)
            if self.pp == 1:
                continue
            prev_f = None if self.first else ops(t, self.rank - 1)[0]
            next_b = None if self.last else ops(t, self.rank + 1)[1]
            got_act, got_cot = neighbour_exchange(
                self.group, self.device, to_next=to_next, to_prev=to_prev,
                from_prev=None if prev_f is None else self.act_spec,
                from_next=None if next_b is None else self.act_spec)
            if got_act is not None:
                self.arrived[prev_f] = got_act
            if got_cot is not None:
                self.cotangents[next_b] = got_cot


def _stage(body_fn, x, mesh, num_microbatches, axis, first_fn, last_fn,
           last_aux, batch_axis, recompute, loss) -> _Stage:
    _check_axes(mesh, axis, batch_axis)
    feeds = _microbatches(x, num_microbatches, mesh, batch_axis)
    aux = None
    if last_aux is not None:
        if last_aux.shape[0] != x.shape[0]:
            raise ValueError("last_aux batch %d != x batch %d"
                             % (last_aux.shape[0], x.shape[0]))
        aux = _microbatches(last_aux, num_microbatches, mesh, batch_axis)
    # the loss-mean seed: 1 / the GLOBAL example count (every dp shard's
    # per-example sums are scaled by it, then summed over dp)
    scale = 1.0 / x.shape[0]
    return _Stage(body_fn, first_fn, last_fn, feeds, aux, mesh, axis,
                  scale, recompute, loss)


def _gpipe_ops(num_micro: int, pp: int, train: bool):
    """GPipe's ticks: ``M + PP - 1`` forward ticks (stage ``r`` runs
    microbatch ``t - r``), then as many backward ticks in reverse order
    (stage ``r`` runs microbatch ``M - 1 - (t - (PP - 1 - r))``, so a
    cotangent reaches rank ``r`` the tick before it is needed)."""
    span = num_micro + pp - 1

    def ops(t: int, r: int):
        if t < span:
            m = t - r
            return (m if 0 <= m < num_micro else None), None
        m = num_micro - 1 - (t - span - (pp - 1 - r))
        return None, (m if 0 <= m < num_micro else None)

    return ops, 2 * span if train else span


def _finish(stage: _Stage, mesh, batch_axis, params) -> torch.Tensor:
    """After a training schedule: the stage's gradients summed over
    ``batch_axis`` (one flat all-reduce per dtype; a parameter this rank
    did not reach gets zeros) and the loss made whole on every rank."""
    from edl_tpu_torch.parallel.sharding_rules import _flat_all_reduce

    if batch_axis is not None and mesh.shape[batch_axis] > 1:
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        _flat_all_reduce(grads, mesh.group(batch_axis))
    loss = stage.loss_sum
    if stage.pp > 1:
        loss = all_reduce_(loss, stage.group)
    if batch_axis is not None:
        loss = all_reduce_(loss, mesh.group(batch_axis))
    return loss


def pipeline_loss_and_grads(
    body_fn: Callable,
    params: Iterable[torch.nn.Parameter],
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
    first_fn: Optional[Callable],
    last_loss_fn: Callable,
    last_aux: Optional[torch.Tensor] = None,
    axis: str = "pp",
    batch_axis: Optional[str] = None,
    stats: Optional[dict] = None,
):
    """GPipe training over this rank's stage: ``(loss, grads)``.

    ``last_loss_fn(act[, aux]) -> [mb]`` gives per-example losses on the
    last rank; the loss is their mean over the global batch, returned on
    every rank. ``params`` are this rank's stage parameters (those of
    ``body_fn`` and, on the edge ranks, of ``first_fn`` / ``last_loss_fn``):
    their ``.grad`` is reset, then holds the loss's gradient, summed over
    ``batch_axis``; ``grads`` lists them in ``params``' order. Under
    ``torch.no_grad()`` only the forward ticks run: the loss, and no
    gradient. The JAX counterpart is ``jax.value_and_grad`` over
    ``pipeline_apply`` with the same ``last_fn``. ``stats`` (a dict), when
    given, receives ``live_max``: the most microbatch graphs this rank
    held at once (``M``: every forward precedes every backward)."""
    params = list(params)
    stage = _stage(body_fn, x, mesh, num_microbatches, axis, first_fn,
                   last_loss_fn, last_aux, batch_axis, recompute=False,
                   loss=True)
    trained = params if stage.grad else []
    for p in trained:
        p.grad = None
    stage.run(*_gpipe_ops(num_microbatches, stage.pp, stage.grad))
    if stats is not None:
        stats["live_max"] = stage.live_max
    loss = _finish(stage, mesh, batch_axis, trained)
    return loss, [p.grad for p in trained]


@torch.no_grad()
def pipeline_apply(
    stage_fn: Callable,
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
    axis: str = "pp",
    first_fn: Optional[Callable] = None,
    last_fn: Optional[Callable] = None,
    last_aux: Optional[torch.Tensor] = None,
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Apply this rank's stage of a ``PP``-stage pipeline to the global
    batch ``x`` (forward only, no graph: the gradient of a pipeline is
    :func:`pipeline_loss_and_grads` or ``pipeline_1f1b``'s).

    ``stage_fn(micro) -> micro`` is the body; ``first_fn`` / ``last_fn``
    (``last_fn(act[, aux])``, ``aux`` the microbatch's rows of
    ``last_aux``) the edges; ``batch_axis`` shards each microbatch's rows
    over that mesh axis. Returns the last stage's outputs on every rank,
    ``[batch, *y.shape[1:]]`` when ``last_fn`` keeps the microbatch
    dimension, else ``[M, *y.shape]`` (with ``batch_axis`` it must keep
    it), as the JAX function does."""
    stage = _stage(stage_fn, x, mesh, num_microbatches, axis, first_fn,
                   last_fn, last_aux, batch_axis, recompute=False, loss=False)
    stage.run(*_gpipe_ops(num_microbatches, stage.pp, train=False))
    out = (torch.stack([stage.outputs[m] for m in range(num_microbatches)])
           if stage.last else None)
    if stage.pp > 1:
        # the last rank's outputs to every rank (a sum: the others add 0)
        shape, dtype = _shared_spec(out, stage.group, stage.device)
        if out is None:
            out = torch.zeros(shape, dtype=dtype, device=stage.device)
        out = all_reduce_(out, stage.group)
    mb = x.shape[0] // num_microbatches
    keeps_mb = out.dim() >= 2 and out.shape[1] == len(stage.feeds[0])
    if batch_axis is not None:
        if not keeps_mb:
            raise ValueError(
                "batch_axis=%r requires last_fn to keep the microbatch "
                "dimension (got per-microbatch shape %s) — return "
                "per-example values (e.g. a [mb] loss vector) so dp shards "
                "aren't dropped" % (batch_axis, tuple(out.shape[1:])))
        group = mesh.group(batch_axis)
        if group_size(group) > 1:
            # [n, M, mb/n, ...] -> [M, n, mb/n, ...]: dp rows in order
            parts = _gather_stacked(out, group).transpose(0, 1)
            out = parts.reshape((out.shape[0], mb) + tuple(out.shape[2:]))
    if out.dim() >= 2 and out.shape[1] == mb:
        return out.reshape((x.shape[0],) + tuple(out.shape[2:]))
    return out

