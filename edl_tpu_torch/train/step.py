"""Train-step builders: the port of ``edl_tpu/train/step.py``.

A step is eager PyTorch: the model's forward, the loss head, ``backward``
and the optimizer's update, on whatever device the model lives on. The
numerics follow the JAX package: bf16 compute inside the model, fp32
parameters and optimizer state, no loss scaling (bf16 needs none).

What changes with the framework:

- ``TrainState`` holds the module (``apply_fn``), the optimizer transform
  (``tx``) and its torch optimizer (``opt_state``); ``params`` are the
  module's parameters. Batch-norm statistics live in module buffers, so
  there is no ``batch_stats`` field.
- ``donate=True`` (the default, as in the JAX package) becomes an in-place
  update: the step returns the state it was given, changed. With
  ``donate=False`` the step leaves the given state untouched and returns
  an updated copy.
- Metrics are 0-d device tensors: the step never waits for the device.
- ``numerics=True`` (the half-batch GNS bundle) waits for ``obs/numerics``
  (ROADMAP M7) and ``aux_losses=True`` for the MoE FFN that sows them
  (M15); both raise, naming the item.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edl_tpu_torch.train.optim import OptState, Transform
from edl_tpu_torch.utils.device import resolve_device

LossHead = Callable[[torch.Tensor, Any], Tuple[torch.Tensor, Dict]]


class TrainState:
    """Model + optimizer state. ``step`` is a 0-d int32 device tensor."""

    def __init__(self, step: torch.Tensor, apply_fn: torch.nn.Module,
                 tx: Transform, opt_state: OptState) -> None:
        self.step = step
        self.apply_fn = apply_fn
        self.tx = tx
        self.opt_state = opt_state

    @property
    def params(self) -> Dict[str, torch.nn.Parameter]:
        return dict(self.apply_fn.named_parameters())

    def apply_gradients(self, grads: Optional[Dict[str, torch.Tensor]] = None
                        ) -> "TrainState":
        """One optimizer update from ``grads`` (name -> tensor) or, when
        None, from the gradients already in each parameter's ``.grad``;
        in place. The gradients are released afterwards."""
        params = self.params
        if grads is not None:
            for name, p in params.items():
                p.grad = grads[name]
        self.tx.update(self.opt_state)
        for p in params.values():
            p.grad = None
        self.step += 1
        return self

    def copy(self) -> "TrainState":
        """A deep copy (module, optimizer and its state), for a step that
        must leave its input untouched."""
        return copy.deepcopy(self)


def create_state(model: torch.nn.Module, rng, tx: Transform,
                 device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller names the
    CPU), initialise its weights from ``rng`` (a seed or a
    ``torch.Generator``; None keeps the weights it has, e.g. converted
    ones) and build the optimizer."""
    dev = resolve_device(device)
    model.to(dev)
    if rng is not None:
        gen = rng if isinstance(rng, torch.Generator) else (
            torch.Generator(device=dev).manual_seed(int(rng))
        )
        model.init_weights(gen)
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        apply_fn=model,
        tx=tx,
        opt_state=tx.init(model.parameters()),
    )


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross entropy over every leading position, and the
    accuracy of the argmax."""
    loss = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()
    )
    accuracy = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"accuracy": accuracy}


def make_cross_entropy_loss(report_top_k: Optional[int] = None) -> LossHead:
    """CE loss head with opt-in top-k accuracy (``"top%d" % k``), skipped
    when the class count is <= k."""

    def head(logits, labels):
        loss, metrics = cross_entropy_loss(logits, labels)
        if report_top_k and logits.shape[-1] > report_top_k:
            idx = logits.topk(report_top_k, dim=-1).indices
            hit = (idx == labels[..., None]).any(dim=-1).float().mean()
            metrics = {**metrics, "top%d" % report_top_k: hit}
        return loss, metrics

    return head


def mse_loss(preds: torch.Tensor, targets: torch.Tensor):
    return ((preds - targets) ** 2).mean(), {}


def make_kd_loss(alpha: float = 0.5, temperature: float = 1.0) -> LossHead:
    """Knowledge-distillation head; the target is ``(labels,
    teacher_logits)``. Objective ``(1-alpha)*CE(labels) +
    alpha*T^2*KL(teacher_T || student_T)`` (Hinton et al. 2015)."""

    def kd_loss(logits, y):
        labels, teacher_logits = y
        t = F.log_softmax(teacher_logits.float() / temperature, dim=-1)
        s = F.log_softmax(logits / temperature, dim=-1)
        kl = (t.exp() * (t - s)).sum(dim=-1).mean()
        hard, metrics = cross_entropy_loss(logits, labels)
        loss = (1.0 - alpha) * hard + alpha * temperature ** 2 * kl
        return loss, {**metrics, "kd_kl": kl, "hard_ce": hard}

    return kd_loss


def _detached(loss, metrics) -> Dict[str, torch.Tensor]:
    return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}


def make_train_step(loss_head: LossHead,
                    apply_kwargs: Optional[Dict[str, Any]] = None,
                    donate: bool = True, aux_losses: bool = False,
                    numerics: bool = False):
    """Build ``step(state, (x, y)) -> (state, metrics)``; ``apply_kwargs``
    are forwarded to the model."""
    if numerics:
        raise NotImplementedError(
            "numerics=True (the half-batch GNS bundle) needs obs/numerics, "
            "ROADMAP M7, not ported yet"
        )
    if aux_losses:
        raise NotImplementedError(
            "aux_losses=True collects what the MoE FFN sows: ROADMAP M15, "
            "not ported yet"
        )
    kwargs = dict(apply_kwargs or {})

    def step(state: TrainState, batch):
        if not donate:
            state = state.copy()
        x, y = batch
        loss, metrics = loss_head(state.apply_fn(x, **kwargs), y)
        loss.backward()
        state.apply_gradients()
        return state, _detached(loss, metrics)

    return step


def _masked_reduce(loss_head: LossHead, outputs, y, mask, context: str):
    """The loss head per row (``torch.func.vmap``, enforcing the
    per-example-mean contract), reduced over valid rows only:
    ``(loss, metrics, n_valid)``."""
    losses, metrics = torch.func.vmap(loss_head)(outputs, y)
    b = mask.shape[0]
    for name, v in [("loss", losses), *metrics.items()]:
        if tuple(v.shape) != (b,):
            raise ValueError(
                "masked %s requires per-example loss heads: %r has shape %s "
                "under vmap, expected (%d,)"
                % (context, name, tuple(v.shape), b)
            )
    w = mask.float()
    n_valid = w.sum()
    denom = n_valid.clamp(min=1.0)
    loss = (losses.float() * w).sum() / denom
    out = {name: (v.float() * w).sum() / denom for name, v in metrics.items()}
    return loss, out, n_valid


def make_masked_train_step(loss_head: LossHead,
                           apply_kwargs: Optional[Dict[str, Any]] = None,
                           donate: bool = True):
    """Step over a PADDED batch: ``step(state, (x, y), mask) -> (state,
    metrics, n_valid)``; the loss is the sum of per-example losses over
    valid rows divided by the valid count, so the gradient is plain SGD
    over exactly the valid rows."""
    kwargs = dict(apply_kwargs or {})

    def step(state: TrainState, batch, mask):
        if not donate:
            state = state.copy()
        x, y = batch
        outputs = state.apply_fn(x, **kwargs)
        loss, metrics, n_valid = _masked_reduce(
            loss_head, outputs, y, mask, "train"
        )
        loss.backward()
        state.apply_gradients()
        return state, _detached(loss, metrics), n_valid

    return step


def make_eval_step(loss_head: LossHead,
                   apply_kwargs: Optional[Dict[str, Any]] = None):
    kwargs = dict(apply_kwargs or {})

    @torch.no_grad()
    def step(state: TrainState, batch):
        x, y = batch
        loss, metrics = loss_head(state.apply_fn(x, **kwargs), y)
        return {"loss": loss, **metrics}

    return step


def make_masked_eval_step(loss_head: LossHead,
                          apply_kwargs: Optional[Dict[str, Any]] = None):
    """Eval step for a PADDED batch: ``step(state, batch, mask) ->
    (metrics, n_valid)``, pad rows excluded per row."""
    kwargs = dict(apply_kwargs or {})

    @torch.no_grad()
    def step(state: TrainState, batch, mask):
        x, y = batch
        outputs = state.apply_fn(x, **kwargs)
        loss, metrics, n_valid = _masked_reduce(
            loss_head, outputs, y, mask, "eval"
        )
        return {"loss": loss, **metrics}, n_valid

    return step
