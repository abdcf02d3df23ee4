"""Train-step builders: the port of ``edl_tpu/train/step.py``.

A step is eager PyTorch: the model's forward, the loss head, ``backward``
and the optimizer's update, on whatever device the model lives on. The
numerics follow the JAX package: bf16 compute inside the model, fp32
parameters and optimizer state, no loss scaling (bf16 needs none).

What changes with the framework:

- ``TrainState`` holds the module (``apply_fn``), the optimizer transform
  (``tx``) and its torch optimizer (``opt_state``); ``params`` are the
  module's parameters. Batch-norm statistics live in module buffers, so
  there is no ``batch_stats`` field; a model "has batch stats" when it
  holds batch-norm layers (:func:`edl_tpu_torch.models.resnet.batch_norms`),
  and the steps then keep the JAX step's rules for ``batch_stats``: one
  full-batch pass (no GNS halves), the masked step refuses it, the eval
  steps normalise with the running averages.
- ``donate=True`` (the default, as in the JAX package) becomes an in-place
  update: the step returns the state it was given, changed. With
  ``donate=False`` the step leaves the given state untouched and returns
  an updated copy.
- Metrics are 0-d device tensors: the step never waits for the device.
- ``numerics=True`` adds the numerics plane's bundle (``obs/numerics``)
  under ``METRICS_KEY``; with ``EDL_NUMERICS_GNS`` not ``0`` and a batch
  that splits into equal even halves, the gradient is the mean of two
  half-batch gradients, as in the JAX step. ``aux_losses=True`` adds the
  model's aux losses (the MoE blocks' load-balancing terms, which the
  model keeps in ``aux_losses`` after its forward) to the loss, reports
  their sum as ``metrics["aux_loss"]`` (0 for a model without them) and
  takes one full-batch pass, as the JAX step does.
- A module that ``parallel.shard_params_fsdp`` sharded (FSDP2) takes no
  DDP wrap: its backward reduce-scatters the gradients over ``fsdp`` and
  all-reduces them over ``dp``, and the optimizer updates this rank's
  shards. ``donate=False`` needs a copy of the module, which FSDP2
  refuses (``deepcopy``).
- ``apply_kwargs`` reach the model's forward; ``{"train": b}`` also sets
  the module's mode (``module.train(b)``) before the forward. A tuple
  ``x`` is the forward's positional arguments (a sequence shard's tokens
  and its global positions).
- A module that ``parallel.shard_params_by_rules`` sharded syncs its
  gradients after each backward (``sharding_rules.sync_gradients``: the
  tp-partial ones summed over ``tp``, all averaged over ``dp × sp``), and
  the step's loss is the mean over ``dp × sp``, as the JAX step's is over
  the global batch.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from edl_tpu_torch.models.resnet import batch_norms
from edl_tpu_torch.obs import numerics as obs_numerics
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
        """A deep copy (module with its buffers, optimizer and its state),
        for a step that must leave its input untouched."""
        return copy.deepcopy(self)


def init_weights(model: torch.nn.Module, rng, device) -> None:
    """``model.init_weights`` from ``rng`` (a seed, drawn on ``device``,
    or a ``torch.Generator``). On an FSDP-sharded model each full draw is
    sliced into this rank's shard (``parallel.sharded_init``: the model's
    own init, one tensor whole at a time), so the weights are those of
    the unsharded model drawn from the same generator."""
    from edl_tpu_torch.parallel.mesh import is_fsdp, sharded_init

    gen = rng if isinstance(rng, torch.Generator) else (
        torch.Generator(device=device).manual_seed(int(rng)))
    with sharded_init() if is_fsdp(model) else contextlib.nullcontext():
        model.init_weights(gen)


def create_state(model: torch.nn.Module, rng, tx: Transform,
                 device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (the card unless the caller names the
    CPU), initialise its weights from ``rng`` (a seed or a
    ``torch.Generator``; None keeps the weights it has, e.g. converted
    ones) and build the optimizer. A model ``shard_params_fsdp`` sharded
    already lives there; its optimizer's state is sharded alike."""
    dev = resolve_device(device)
    model.to(dev)
    if rng is not None:
        init_weights(model, rng, dev)
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


def _split_size(batch) -> Optional[int]:
    """The batch size when every leaf of ``batch`` is a tensor batched
    with the same even leading dim of at least 2 (the JAX step's static
    split rule), else None."""
    leaves = torch.utils._pytree.tree_leaves(batch)
    dims = set()
    for leaf in leaves:
        if not (torch.is_tensor(leaf) and leaf.dim() >= 1):
            return None  # an unbatched leaf cannot be halved
        dims.add(leaf.shape[0])
    if len(dims) != 1:
        return None
    b = dims.pop()
    return b if b >= 2 and b % 2 == 0 else None


def _set_mode(module: torch.nn.Module, kwargs: Dict[str, Any]) -> None:
    """``{"train": b}`` in the apply kwargs sets the module's mode."""
    if "train" in kwargs and module.training != bool(kwargs["train"]):
        module.train(bool(kwargs["train"]))


def _eval_kwargs(module: torch.nn.Module, kwargs: Dict[str, Any]
                 ) -> Dict[str, Any]:
    """An eval step's apply kwargs: a model with batch stats normalises
    with its running averages (``train=False``), as the JAX eval step
    applies the stored ``batch_stats`` without updating them."""
    if batch_norms(module):
        return {**kwargs, "train": False}
    return kwargs


def _halves(batch, h: int):
    first = torch.utils._pytree.tree_map(lambda a: a[:h], batch)
    second = torch.utils._pytree.tree_map(lambda a: a[h:], batch)
    return first, second


def _aux_total(module: torch.nn.Module, like: torch.Tensor) -> torch.Tensor:
    """The sum of the aux losses ``module`` (or the module a data-parallel
    wrapper holds) kept from its last forward; a 0-d fp32 zero when there
    are none."""
    module = getattr(module, "module", module)
    total = torch.zeros((), dtype=torch.float32, device=like.device)
    for aux in getattr(module, "aux_losses", ()):
        total = total + aux
    return total


def _after_backward(module: torch.nn.Module, loss: torch.Tensor):
    """The gradient sync of a module ``shard_params_by_rules`` sharded
    (and its loss's mean over ``dp × sp``); ``loss`` as it is otherwise."""
    if getattr(module, "_edl_rules", None) is None:
        return loss
    from edl_tpu_torch.parallel.sharding_rules import sync_gradients

    return sync_gradients(module, loss)


def make_train_step(loss_head: LossHead,
                    apply_kwargs: Optional[Dict[str, Any]] = None,
                    donate: bool = True, aux_losses: bool = False,
                    numerics: bool = False):
    """Build ``step(state, (x, y)) -> (state, metrics)``; ``apply_kwargs``
    are forwarded to the model. ``aux_losses=True`` adds the model's aux
    losses to the objective and reports their sum as
    ``metrics["aux_loss"]``.

    ``numerics=True`` adds the numerics plane's bundle to the metrics
    under ``obs_numerics.METRICS_KEY``: 0-d device tensors the caller
    pops and hands to ``NumericsProbe.on_step`` (never aggregates). The
    update ratio needs the parameters before the update: the step
    snapshots them (one fp32 copy of the parameters, freed when the step
    returns). When ``EDL_NUMERICS_GNS`` is not ``0`` (read when the step
    is built) and the batch splits into equal even halves, the gradient
    is the mean of two half-batch gradients — the same gradient for
    mean-reduced loss heads — and the halves' squared norms feed the
    gradient-noise-scale estimate. The first half's gradient tensors are
    set aside while the second backward fills fresh ones (one model's
    worth of fp32 gradients more, no copy); under data parallelism both
    backwards all-reduce, so each half is a gradient over half of the
    global batch. Under FSDP2 each backward reduce-scatters likewise and
    leaves its sharded gradient in ``.grad`` when the parameter had none
    (it accumulates only into a gradient still there), so the first
    half's shards are set aside the same way and no gradient sync is
    switched off; the halves' norms sum their shards over the group
    (``obs.numerics.global_norm``). A model with batch stats takes one
    full-batch pass (two half-batch forwards would update its running
    averages twice, from half-batch statistics), as the JAX step decides
    for ``batch_stats``, and so does a step with ``aux_losses``."""
    kwargs = dict(apply_kwargs or {})
    want_gns = numerics and obs_numerics.gns_enabled()

    def forward_backward(state, x, y):
        args = x if isinstance(x, tuple) else (x,)
        loss, metrics = loss_head(state.apply_fn(*args, **kwargs), y)
        if aux_losses:
            aux = _aux_total(state.apply_fn, loss)
            loss = loss + aux
            metrics = {**metrics, "aux_loss": aux}
        loss.backward()
        loss = _after_backward(state.apply_fn, loss.detach())
        return loss, {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch):
        if not donate:
            state = state.copy()
        _set_mode(state.apply_fn, kwargs)
        x, y = batch
        if not numerics:
            loss, metrics = forward_backward(state, x, y)
            state.apply_gradients()
            return state, {"loss": loss, **metrics}
        params = [p for p in state.params.values() if p.is_floating_point()]
        dev = params[0].device if params else None
        b = (_split_size(batch) if want_gns and not aux_losses
             and not batch_norms(state.apply_fn) else None)
        half_sq = None
        if b is not None:
            (x1, y1), (x2, y2) = _halves((x, y), b // 2)
            l1, m1 = forward_backward(state, x1, y1)
            held = [p for p in params if p.grad is not None]
            g1 = [p.grad for p in held]
            for p in held:
                p.grad = None
            l2, m2 = forward_backward(state, x2, y2)
            g2 = [p.grad for p in held]
            with torch.no_grad():
                half_sq = torch.stack([
                    obs_numerics.global_norm(g1, dev).square(),
                    obs_numerics.global_norm(g2, dev).square()])
                torch._foreach_add_(g1, g2)
                torch._foreach_mul_(g1, 0.5)
            for p, g in zip(held, g1):
                p.grad = g
            del g1, g2
            loss = (l1 + l2) / 2.0
            metrics = {k: (m1[k] + m2[k]) / 2.0 for k in m1}
        else:
            loss, metrics = forward_backward(state, x, y)
        with torch.no_grad():
            grads = [p.grad for p in params if p.grad is not None]
            grad_norm = obs_numerics.global_norm(grads, dev)
            nonfinite = obs_numerics.nonfinite_count(grads, dev)
            before = torch._foreach_mul(params, 1.0)
            old_norm = obs_numerics.global_norm(before, dev)
        del grads
        state.apply_gradients()
        with torch.no_grad():
            new_norm = obs_numerics.global_norm(params, dev)
            torch._foreach_sub_(before, params)
            delta_norm = obs_numerics.global_norm(before, dev)
        del before
        metrics = {"loss": loss, **metrics}
        metrics[obs_numerics.METRICS_KEY] = obs_numerics.assemble(
            loss, grad_norm, new_norm, old_norm, delta_norm, nonfinite,
            half_sq=half_sq, batch=b,
        )
        return state, metrics

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
    over exactly the valid rows. A model with batch stats is refused, as
    in the JAX step: pad rows would pollute the running statistics."""
    kwargs = dict(apply_kwargs or {})

    def step(state: TrainState, batch, mask):
        if batch_norms(state.apply_fn):
            raise ValueError(
                "masked train step does not support batch_stats models: "
                "pad rows would pollute the running BN statistics"
            )
        if not donate:
            state = state.copy()
        _set_mode(state.apply_fn, kwargs)
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
        outputs = state.apply_fn(x, **_eval_kwargs(state.apply_fn, kwargs))
        loss, metrics = loss_head(outputs, y)
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
        outputs = state.apply_fn(x, **_eval_kwargs(state.apply_fn, kwargs))
        loss, metrics, n_valid = _masked_reduce(
            loss_head, outputs, y, mask, "eval"
        )
        return {"loss": loss, **metrics}, n_valid

    return step
