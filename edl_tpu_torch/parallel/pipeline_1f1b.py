"""1F1B pipeline schedule: memory-bounded training over the ``pp`` axis, the
port of ``edl_tpu/parallel/pipeline_1f1b.py``.

GPipe (:func:`~edl_tpu_torch.parallel.pipeline.pipeline_loss_and_grads`)
runs every forward before any backward, so the microbatch graphs a rank
holds grow with the microbatch count M. The 1F1B schedule (Megatron's
non-interleaved pipeline) interleaves: after a warm-up of ``PP-1-r``
forwards, rank ``r`` alternates one forward and one backward, so at most
``PP`` microbatches' stage inputs are held per rank, whatever M is, and M
can grow (shrinking the bubble, ``(PP-1)/(M+PP-1)``) without growing
memory.

As in the JAX module the backward is part of the schedule, so this
computes ``(loss, grads)`` directly: a forward runs without a graph and
stashes its stage input at slot ``m % PP``; the backward recomputes the
stage from it with a graph (``do_b``), gradients accumulate in ``.grad``
and cotangents go one rank back per tick
(:func:`~edl_tpu_torch.parallel.collectives.neighbour_exchange`).

Tick algebra (``_schedule``, as in the JAX module):

    F_m^r = r + m              (fill: m < PP-1-r)
    F_m^r = 2m + r             (steady: m >= PP-1-r)
    B_m^r = 2PP - 1 - r + 2m
    total ticks = 2(M + PP - 1); at most one op of each kind per (tick,
    rank); an activation may wait in its slot, a cotangent arrives on the
    tick that consumes it.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from edl_tpu_torch.parallel.pipeline import _check_axes, _finish, _stage


def _schedule(t: int, r: int, pp: int, num_micro: int):
    """Rank ``r``'s ops at tick ``t``: ``(has_f, m_f, has_b, m_b)``, the
    microbatch indices clipped into ``[0, M)`` as the JAX function's."""
    tr = t - r
    fill = tr >= 0 and t < pp - 1 and tr < num_micro
    m_steady = tr // 2
    steady = (tr >= 0 and tr % 2 == 0 and m_steady >= pp - 1 - r
              and m_steady < num_micro)
    has_f = fill or steady
    m_f = tr if fill else m_steady
    tb = t - (2 * pp - 1 - r)
    has_b = tb >= 0 and tb % 2 == 0 and tb // 2 < num_micro
    m_b = tb // 2
    clip = lambda m: min(max(m, 0), num_micro - 1)  # noqa: E731
    return has_f, clip(m_f), has_b, clip(m_b)


def _onef_oneb_ops(num_micro: int, pp: int):
    """The tick runner's ``ops(t, r) -> (m_f, m_b)`` of 1F1B, and its
    ``2(M + PP - 1)`` ticks."""

    def ops(t: int, r: int):
        has_f, m_f, has_b, m_b = _schedule(t, r, pp, num_micro)
        return (m_f if has_f else None), (m_b if has_b else None)

    return ops, 2 * (num_micro + pp - 1)


def pipeline_1f1b_loss_and_grads(
    body_fn: Callable,
    params: Iterable[torch.nn.Parameter],
    x: torch.Tensor,
    mesh,
    num_microbatches: int,
    first_fn: Callable,
    last_loss_fn: Callable,
    last_aux: torch.Tensor,
    axis: str = "pp",
    batch_axis: Optional[str] = None,
    stats: Optional[dict] = None,
):
    """Run the 1F1B schedule over this rank's stage: ``(loss, grads)``.

    The stage contract of
    :func:`~edl_tpu_torch.parallel.pipeline.pipeline_loss_and_grads`, with
    ``first_fn`` and ``last_loss_fn(act, aux) -> [mb]`` mandatory: the
    loss is the mean of the per-example losses over the global batch
    (each microbatch's seeded with 1 / the global example count), on
    every rank; ``params``' ``.grad`` is reset, then holds its gradient,
    summed over ``batch_axis`` once, after the loop. The same numbers as
    GPipe's. Needs ``num_microbatches >= pp``. ``stats`` (a dict), when
    given, receives ``live_max``: the most microbatches whose stage input
    this rank held at once (at most ``pp``)."""
    _check_axes(mesh, axis, batch_axis)
    pp = mesh.shape[axis]
    if num_microbatches < pp:
        raise ValueError("1F1B needs num_microbatches >= pp (%d < %d)"
                         % (num_microbatches, pp))
    params = list(params)
    with torch.enable_grad():
        stage = _stage(body_fn, x, mesh, num_microbatches, axis, first_fn,
                       last_loss_fn, last_aux, batch_axis, recompute=True,
                       loss=True)
        for p in params:
            p.grad = None
        stage.run(*_onef_oneb_ops(num_microbatches, pp))
    if stats is not None:
        stats["live_max"] = stage.live_max
    return _finish(stage, mesh, batch_axis, params), [p.grad for p in params]
