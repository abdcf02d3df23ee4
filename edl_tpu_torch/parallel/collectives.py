"""Collectives of the tensor- and sequence-parallel paths, as autograd
functions over ``torch.distributed`` process groups.

The JAX package states where each value lives and lets XLA insert the
collectives (GSPMD, ``shard_map``). Here they are explicit, Megatron's way:

- :func:`copy_to_group` (f): identity forward, all-reduce backward; the
  input of a column-parallel product (q/k/v, gate/up, the vocab-sharded
  head), whose input gradient is partial on each rank.
- :func:`reduce_from_group` (g): all-reduce forward, identity backward; the
  output of a row-parallel product (o, down) and the vocab-sharded
  embedding's masked lookup.
- :func:`gather_last_dim`: all-gather along the last axis, slice backward;
  the vocab-sharded head's logits become whole.
- :func:`all_gather_dim` (reduce-scatter backward) and :func:`all_to_all`
  (the reverse all-to-all backward): Ulysses' reshards.
- :func:`ring_shift`: every rank sends to the next rank of the group and
  receives from the previous one, with ``batch_isend_irecv`` (no pair
  waits on another); the ring's hop.
- :func:`neighbour_exchange`: the pipeline's hop, not cyclic: a rank
  sends to and receives from its neighbours on the ``pp`` group only the
  tensors its schedule says carry data, all of one tick in one
  ``batch_isend_irecv``.

None of them redistributes a DTensor (gloo does not carry DTensor's
functional collectives for tensors on the card). A ``group`` of None, or
of one rank, makes each an identity.

**The transport.** gloo carries every collective here for tensors on the
card but point-to-point send/recv, so the ring's hop stages its tensors
through pinned host memory on a gloo group, and so do the pipeline's;
:func:`stage_through_host` is the one place that decides, from the
backend, never by catching a failure.
"""

from __future__ import annotations

import math
import time
from typing import List, Sequence

import torch
import torch.distributed as dist

# Whether gloo carries point-to-point send/recv for CUDA tensors. Probed on
# the H100 with two ranks sharing the card (torch 2.11,
# tools/gloo_probe.py; PERF.md §7): gloo stages all-reduce,
# all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single
# through the host itself, but hands a send's device pointer to its TCP
# transport ("writev ... Bad address"), so the ring stages its hops.
GLOO_CARRIES_CUDA_P2P = False

# host seconds, bytes and calls spent in the sequence-parallel transport
# (ring_shift and all_to_all; TRANSPORT) and in the tensor-parallel
# collectives (f, g and the logits' gather; TP_COLLECTIVES) in this
# process; phase lm_parallel of chip_smoke.py reports a step's share of each
TRANSPORT = {"seconds": 0.0, "bytes": 0, "calls": 0}
TP_COLLECTIVES = {"seconds": 0.0, "bytes": 0, "calls": 0}
# the same for the pipeline's stage-to-stage hops (neighbour_exchange);
# phase pipeline of chip_smoke.py reports a step's share
PIPELINE = {"seconds": 0.0, "bytes": 0, "calls": 0}


def reset_transport() -> None:
    for counter in (TRANSPORT, TP_COLLECTIVES, PIPELINE):
        counter.update(seconds=0.0, bytes=0, calls=0)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def stage_through_host(group, t) -> bool:
    """True when a point-to-point transfer of ``t`` (a tensor, or the
    device of the tensors) over ``group`` must go through host buffers: a
    CUDA tensor on a gloo group (:data:`GLOO_CARRIES_CUDA_P2P`; NCCL
    carries it)."""
    dev = t.device if isinstance(t, torch.Tensor) else torch.device(t)
    return (dev.type == "cuda" and dist.get_backend(group) == "gloo"
            and not GLOO_CARRIES_CUDA_P2P)


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (gloo has no average)."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def _tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """A summed copy of ``x`` over ``group``, timed in TP_COLLECTIVES."""
    out = x.contiguous().clone()
    with _timed(out.numel() * out.element_size(), TP_COLLECTIVES):
        return all_reduce_(out, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tp_all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """f: ``x`` forward; the gradient summed over ``group`` backward."""
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """g: ``x`` summed over ``group`` forward; the gradient as it is
    backward."""
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def _gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, *x.shape]``: every rank's ``x`` in rank order."""
    shape = x.shape
    n = group_size(group)
    x = x.contiguous().reshape(1, -1)
    out = torch.empty((n, x.shape[1]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.view((n,) + tuple(shape))


def _reduce_scatter_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """``x [n, ...]`` summed over ``group``; this rank's row of the sum."""
    flat = x.contiguous().reshape(x.shape[0], -1)
    out = torch.empty((1, flat.shape[1]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out.view(x.shape[1:])


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = _gather_stacked(x, group).unbind(0)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        stacked = torch.stack(g.chunk(n, dim=ctx.dim), dim=0)
        return _reduce_scatter_stacked(stacked, ctx.group), None, None


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order; the
    backward sums the gradient over the group and keeps this rank's part
    (reduce-scatter)."""
    if group_size(group) == 1:
        return x
    return _AllGatherDim.apply(x, group, dim % x.dim())


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        with _timed(x.numel() * x.element_size(), TP_COLLECTIVES):
            parts = _gather_stacked(x, group).unbind(0)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, w = group_rank(ctx.group), ctx.width
        return g[..., r * w:(r + 1) * w], None


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the last axis; backward, this
    rank's slice of the gradient (each rank computes the whole loss)."""
    if group_size(group) == 1:
        return x
    return _GatherLastDim.apply(x, group)


class _timed:
    """Adds its host time, ``nbytes`` and one call to ``counter``."""

    def __init__(self, nbytes: int, counter=TRANSPORT) -> None:
        self.nbytes, self.counter = nbytes, counter

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.counter["seconds"] += time.perf_counter() - self.t0
        self.counter["bytes"] += self.nbytes
        self.counter["calls"] += 1


def _all_to_all_raw(x: torch.Tensor, group, split_dim: int,
                    concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim), dim=0).contiguous()
    recv = torch.empty_like(send)
    with _timed(send.numel() * send.element_size()):
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all_raw(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all_raw(g, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)``: ``x`` split into ``n`` chunks along
    ``split_dim``, chunk ``j`` sent to rank ``j``, and the chunks received
    concatenated along ``concat_dim`` in source order. Differentiable: the
    backward is the reverse all-to-all."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), concat_dim % x.dim())


def ring_shift(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Send each of ``tensors`` to the next rank of ``group`` (rank + 1
    mod n) and return what the previous rank sent: the ring's hop, all
    tensors in one ``batch_isend_irecv``. Not differentiable (the ring's
    backward moves its own gradients)."""
    n = group_size(group)
    if n == 1:
        return list(tensors)
    me = group_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    tensors = [t.contiguous() for t in tensors]
    staged = stage_through_host(group, tensors[0])
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    with _timed(nbytes):
        if staged:
            sends = []
            for t in tensors:
                buf = _pinned_like(t)
                buf.copy_(t)
                sends.append(buf)
            recvs = [_pinned_like(t) for t in tensors]
        else:
            sends = tensors
            recvs = [torch.empty_like(t) for t in tensors]
        ops = []
        for s, r in zip(sends, recvs):
            ops.append(dist.P2POp(dist.isend, s, nxt, group))
            ops.append(dist.P2POp(dist.irecv, r, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            dev = tensors[0].device
            recvs = [r.to(dev, non_blocking=True) for r in recvs]
    return recvs


def neighbour_exchange(group, device, to_next=None, to_prev=None,
                       from_prev=None, from_next=None):
    """One tick of the pipeline's hops over ``group`` (the ``pp`` group),
    not cyclic: send ``to_next`` to ``pp`` rank + 1 and ``to_prev`` to
    rank - 1, and receive from rank - 1 and rank + 1 a tensor of
    ``from_prev`` / ``from_next`` (``(shape, dtype)``), each only where it
    is not None, all in one ``batch_isend_irecv`` (no pair waits on
    another). Both sides derive what moves from the same schedule, so
    every send meets its receive. Returns ``(from rank - 1, from rank +
    1)``, None where nothing was asked for, on ``device``. A CUDA tensor
    on a gloo group goes through pinned host buffers
    (:func:`stage_through_host`). Not differentiable (the schedules move
    their own cotangents). Timed in :data:`PIPELINE`."""
    me = group_rank(group)
    sends = [(t.detach().contiguous(), peer) for t, peer in
             ((to_next, me + 1), (to_prev, me - 1)) if t is not None]
    wants = [(spec, peer) for spec, peer in
             ((from_prev, me - 1), (from_next, me + 1))]
    if not sends and all(spec is None for spec, _ in wants):
        return None, None
    staged = stage_through_host(group, device)
    nbytes = sum(t.numel() * t.element_size() for t, _ in sends) + sum(
        math.prod(spec[0]) * torch.empty((), dtype=spec[1]).element_size()
        for spec, _ in wants if spec is not None)
    with _timed(nbytes, PIPELINE):
        ops, recvs = [], []
        for t, peer in sends:
            if staged:
                buf = _pinned_like(t)
                buf.copy_(t)
                t = buf
            ops.append(dist.P2POp(dist.isend, t,
                                  dist.get_global_rank(group, peer), group))
        for spec, peer in wants:
            if spec is None:
                recvs.append(None)
                continue
            shape, dtype = spec
            buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
                   else torch.empty(shape, dtype=dtype, device=device))
            ops.append(dist.P2POp(dist.irecv, buf,
                                  dist.get_global_rank(group, peer), group))
            recvs.append(buf)
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if staged:
            recvs = [r if r is None else r.to(device, non_blocking=True)
                     for r in recvs]
    return recvs[0], recvs[1]
