"""Streaming evaluation metrics: the port of ``edl_tpu/train/metrics.py``.

A bucketed AUC accumulator: fixed-size histograms of the predicted
probability by class, updated per batch on the device with no host sync,
and mergeable across ranks with a plain sum (:func:`auc_merge`, or an
all-reduce of both histograms over the ranks that saw different rows).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edl_tpu_torch.utils.device import resolve_device


class AUCState(NamedTuple):
    """Histograms of predicted probability by class; sum across ranks to
    merge partial states."""

    pos: torch.Tensor  # [num_buckets] count of positives per score bucket
    neg: torch.Tensor  # [num_buckets] count of negatives per score bucket


def auc_init(num_buckets: int = 2048, device="cuda") -> AUCState:
    """Empty histograms on ``device`` (the card unless the caller names
    the CPU)."""
    dev = resolve_device(device)
    return AUCState(
        pos=torch.zeros(num_buckets, dtype=torch.float32, device=dev),
        neg=torch.zeros(num_buckets, dtype=torch.float32, device=dev),
    )


def auc_update(state: AUCState, logits: torch.Tensor,
               labels: torch.Tensor) -> AUCState:
    """Accumulate a batch: each example's sigmoid probability into bucket
    ``clip(int(p · n), 0, n - 1)`` of its class. Returns a new state."""
    n = state.pos.shape[0]
    prob = torch.sigmoid(logits.detach().reshape(-1).float())
    bucket = (prob * n).to(torch.int32).clamp(0, n - 1).long()
    is_pos = labels.reshape(-1).float()
    return AUCState(pos=state.pos.index_add(0, bucket, is_pos),
                    neg=state.neg.index_add(0, bucket, 1.0 - is_pos))


def auc_compute(state: AUCState) -> torch.Tensor:
    """Trapezoidal AUC over the bucketed ROC curve (0-d fp32 tensor).

    Within-bucket ties contribute half (the trapezoid), matching the
    standard rank-statistic treatment of tied scores."""
    total_pos = state.pos.sum().clamp(min=1e-12)
    total_neg = state.neg.sum().clamp(min=1e-12)
    # sweep buckets from high score to low: cumulative TP / FP
    tpr = state.pos.flip(0).cumsum(0) / total_pos
    fpr = state.neg.flip(0).cumsum(0) / total_neg
    zero = tpr.new_zeros(1)
    tpr0 = torch.cat([zero, tpr[:-1]])
    fpr0 = torch.cat([zero, fpr[:-1]])
    return torch.sum((fpr - fpr0) * (tpr + tpr0) / 2.0)


def auc_merge(a: AUCState, b: AUCState) -> AUCState:
    return AUCState(pos=a.pos + b.pos, neg=a.neg + b.neg)
