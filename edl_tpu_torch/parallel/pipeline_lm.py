"""Pipeline-parallel TransformerLM: embed → block stages → head, the port of
``edl_tpu/parallel/pipeline_lm.py``.

A :class:`LMStage` is one ``pp`` rank's share of a
:class:`~edl_tpu_torch.models.transformer.TransformerLM`:

- the **embedding** on rank 0 only (``first_fn``), turning int tokens into
  the circulating ``[mb, T, D]`` activation;
- its ``L/PP`` **transformer blocks**, under their global names
  ``layer_i`` (rank ``r`` holds ``layer_{r·L/PP}`` ... ``layer_{(r+1)·L/PP
  - 1}``), run under the model's ``remat`` / ``remat_policy`` as the flat
  model runs them;
- the **final norm + lm_head** on the last rank only; for training,
  :func:`pipeline_lm_loss` folds the cross entropy into the last stage so
  only per-example losses leave the pipeline.

The stage's ``state_dict`` is the whole model's restricted to its parts,
so :func:`split_lm_params` and :func:`merge_lm_params` are selections and
a union, and a merged dict loads into ``TransformerLM``; converted JAX
``LMStageParams`` come in through ``convert.lm_stage_state_dict``.

Where the JAX functions take ``(model, split)``, these take the rank's
stage, which holds both. The MoE LM is refused, as the JAX package
refuses it: its blocks are not homogeneous.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_loss_and_grads,
)
from edl_tpu_torch.parallel.pipeline_1f1b import pipeline_1f1b_loss_and_grads

if TYPE_CHECKING:  # models.transformer imports this package's collectives
    from edl_tpu_torch.models.transformer import TransformerLM


def _check_model(model: TransformerLM, pp: int) -> int:
    if model.num_experts > 0:
        raise ValueError(
            "pipeline parallelism requires homogeneous (dense) blocks; "
            "MoE layers change the per-layer param structure"
        )
    if model.num_layers % pp:
        raise ValueError(
            "num_layers %d not divisible by pp %d" % (model.num_layers, pp)
        )
    return model.num_layers // pp


def _prefixes(model: TransformerLM, pp: int, rank: int) -> List[str]:
    """The ``state_dict`` name prefixes of stage ``rank``'s parts."""
    lps = _check_model(model, pp)
    out = ["layer_%d." % i for i in range(rank * lps, (rank + 1) * lps)]
    if rank == 0:
        out.insert(0, "embed.")
    if rank == pp - 1:
        out += ["ln_f.", "lm_head."]
    return out


class LMStage(nn.Module):
    """Stage ``rank`` of ``pp`` of ``model``: the model's own embedding
    (rank 0), blocks and norm + head (the last rank) as its sub-modules
    (shared, not copied: build the model on ``meta`` and ``to_empty`` the
    stage to hold only its parts)."""

    def __init__(self, model: TransformerLM, pp: int, rank: int) -> None:
        super().__init__()
        lps = _check_model(model, pp)
        self.pp, self.rank = pp, rank
        self.remat, self.remat_policy = model.remat, model.remat_policy
        self.layer_names = ["layer_%d" % i
                            for i in range(rank * lps, (rank + 1) * lps)]
        if rank == 0:
            self.embed = model.embed
        for name in self.layer_names:
            self.add_module(name, getattr(model, name))
        if rank == pp - 1:
            self.ln_f = model.ln_f
            self.lm_head = model.lm_head

    def first(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens)

    def body(self, h: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(h.shape[1], device=h.device).expand(
            h.shape[:2])
        remat = None
        if self.remat and torch.is_grad_enabled():
            remat = self.remat_policy or "full"
        for name in self.layer_names:
            h, _ = getattr(self, name)(h, positions, remat)
        return h

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(h))

    def last_loss(self, h: torch.Tensor, targets: torch.Tensor):
        """Per-example next-token cross entropy ``[mb]``: THE loss both
        the GPipe and the 1F1B paths share."""
        logits = self.head(h)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             targets.reshape(-1).long(), reduction="none")
        return ce.reshape(targets.shape).mean(dim=-1)


def lm_stage(model: TransformerLM, mesh, axis: str = "pp") -> LMStage:
    """This rank's :class:`LMStage` of ``model`` on ``mesh``'s ``axis``."""
    return LMStage(model, mesh.shape.get(axis, 1), mesh.coords.get(axis, 0))


def split_lm_params(model: TransformerLM, params: Dict[str, torch.Tensor],
                    pp: int) -> List[Dict[str, torch.Tensor]]:
    """A flat TransformerLM ``state_dict`` as ``pp`` stage dicts (stage
    ``r``'s loads into ``LMStage(model, pp, r)``): a selection by name,
    where the JAX function stacks the blocks ``[PP, L/PP, ...]``."""
    out = []
    for r in range(pp):
        prefixes = tuple(_prefixes(model, pp, r))
        out.append({k: v for k, v in params.items()
                    if k.startswith(prefixes)})
    return out


def merge_lm_params(model: TransformerLM,
                    stages: List[Dict[str, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`split_lm_params`: a dict ``TransformerLM`` loads."""
    _check_model(model, len(stages))
    out: Dict[str, torch.Tensor] = {}
    for sd in stages:
        out.update(sd)
    return out


def pipeline_lm_logits(stage: LMStage, tokens: torch.Tensor, mesh,
                       num_microbatches: int, axis: str = "pp",
                       batch_axis: Optional[str] = None) -> torch.Tensor:
    """Forward → logits ``[B, T, V]`` on every rank (the eval path: the
    whole logits go from the last rank to every rank; prefer
    :func:`pipeline_lm_loss` for training)."""
    return pipeline_apply(stage.body, tokens, mesh, num_microbatches,
                          axis=axis, first_fn=stage.first,
                          last_fn=stage.head, batch_axis=batch_axis)


def pipeline_lm_loss(stage: LMStage, tokens: torch.Tensor,
                     targets: torch.Tensor, mesh, num_microbatches: int,
                     axis: str = "pp", batch_axis: Optional[str] = None,
                     stats: Optional[dict] = None) -> torch.Tensor:
    """Mean next-token cross entropy, computed INSIDE the pipeline (GPipe):
    the last rank projects to logits and reduces them to per-example
    losses. Under grad mode it also runs GPipe's backward and leaves the
    stage's gradients in ``.grad`` (``jax.value_and_grad`` of the JAX
    function); under ``torch.no_grad()`` only the loss."""
    loss, _ = pipeline_loss_and_grads(
        stage.body, stage.parameters(), tokens, mesh, num_microbatches,
        first_fn=stage.first, last_loss_fn=stage.last_loss,
        last_aux=targets, axis=axis, batch_axis=batch_axis, stats=stats)
    return loss


def pipeline_lm_1f1b_grads(stage: LMStage, tokens: torch.Tensor,
                           targets: torch.Tensor, mesh,
                           num_microbatches: int, axis: str = "pp",
                           batch_axis: Optional[str] = None,
                           stats: Optional[dict] = None):
    """``(loss, grads)`` by the memory-bounded 1F1B schedule, ``grads`` the
    stage's by ``state_dict`` name (also left in ``.grad``): the numbers
    of :func:`pipeline_lm_loss`'s backward, with at most ``pp``
    microbatches' stage inputs held per rank whatever the microbatch
    count."""
    names, params = zip(*stage.named_parameters())
    loss, grads = pipeline_1f1b_loss_and_grads(
        stage.body, params, tokens, mesh, num_microbatches,
        first_fn=stage.first, last_loss_fn=stage.last_loss,
        last_aux=targets, axis=axis, batch_axis=batch_axis, stats=stats)
    return loss, dict(zip(names, grads))
