"""Gradient compression: DGC-style top-k sparsification with error
feedback, the port of ``edl_tpu/train/compression.py``.

A gradient transform in the port's optax idiom, chained ahead of an
optimizer::

    tx = chain(topk_compression(0.01), sgd(lr, momentum=0.9))

Each step keeps only the top ``ratio`` fraction of each tensor's gradient
entries (by magnitude) and banks the rest locally, adding it back the
next step (error feedback, Lin et al. 2018). As in the JAX package it
acts after the gradient sync (it rewrites the averaged ``.grad`` the train
step leaves), before the inner optimizer steps; what it preserves is the
optimization behaviour of DGC training, not its network savings.

The threshold is the linear ``percentile`` of ``|g|`` at ``100 · (1 -
ratio)`` (:func:`percentile_threshold`): the two order statistics around
the fractional index ``q · (n - 1)`` (two ``kthvalue`` calls, which take
any size, where ``torch.quantile`` refuses inputs above 2^24 elements),
interpolated.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np
import torch

__all__ = ["topk_compression", "TopKState", "percentile_threshold"]


def percentile_threshold(x: torch.Tensor, q: float) -> torch.Tensor:
    """``numpy.percentile(x, q)`` (linear interpolation) of a tensor of any
    size, as a 0-d tensor in ``x``'s dtype on its device. The fractional
    index ``q / 100 · (n - 1)`` and the weight are computed in ``x``'s
    precision (float32 for any dtype but float64), as ``jnp.percentile``
    and numpy 2 do for a float32 input: above 2^24 elements that rounding
    picks the order statistics."""
    flat = x.reshape(-1)
    real = np.float64 if x.dtype == torch.float64 else np.float32
    pos = real(real(q) / real(100)) * real(flat.numel() - 1)
    lo = int(np.floor(pos))
    t = pos - real(lo)
    a = flat.kthvalue(lo + 1).values
    if t == 0:
        return a
    b = flat.kthvalue(lo + 2).values
    diff = b - a
    # numpy's _lerp: from the nearer end
    if t < 0.5:
        return a + diff * float(t)
    return b - diff * float(real(1) - t)


class TopKState:
    """The error-feedback residual of each parameter (the same shapes),
    and ``optimizer`` None: this transform steps no optimizer."""

    def __init__(self, params: List[torch.nn.Parameter]) -> None:
        self.params = params
        self.residual = [torch.zeros_like(p) for p in params]
        self.optimizer = None


class _TopK:
    def __init__(self, ratio: float) -> None:
        self.ratio = ratio

    def init(self, params: Iterable[torch.nn.Parameter]) -> TopKState:
        return TopKState(list(params))

    @torch.no_grad()
    def update(self, state: TopKState) -> None:
        """Rewrite each parameter's ``.grad`` to its kept entries and bank
        the rest in the residual."""
        dense_below = int(1.0 / self.ratio)
        q = 100.0 * (1.0 - self.ratio)
        for p, resid in zip(state.params, state.residual):
            if p.grad is None:
                continue
            g = p.grad + resid  # error feedback: add back what was dropped
            if self.ratio >= 1.0 or g.numel() < dense_below:
                p.grad = g
                resid.zero_()
                continue
            mag = g.abs()
            kept = torch.where(mag >= percentile_threshold(mag, q), g, 0.0)
            resid.copy_(g - kept)
            p.grad = kept


def topk_compression(ratio: float = 0.01) -> _TopK:
    """Keep the top ``ratio`` of entries per tensor; bank the rest.

    ``ratio`` in (0, 1]. Tensors with fewer than ``1/ratio`` elements pass
    through dense (biases and norms are tiny and sign-critical; the DGC
    paper likewise exempts them)."""
    if not 0.0 < ratio <= 1.0:
        raise ValueError("ratio must be in (0, 1], got %r" % (ratio,))
    return _TopK(ratio)
