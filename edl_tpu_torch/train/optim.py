"""The optax optimizers the repo's callers use, built over ``torch.optim``.

``adamw``, ``adam`` and ``sgd`` take optax's arguments and defaults and
return a :class:`Transform`: ``init(params)`` builds the torch optimizer
(the counterpart of ``tx.init``), ``update(state)`` applies the gradients
in ``.grad`` in place and counts the step. Each mapping is pinned by a
test that runs optax and the port side by side for several steps:

- ``optax.adamw`` decays every parameter by ``weight_decay`` (default
  1e-4, where ``torch.optim.AdamW`` defaults to 1e-2), decoupled as
  ``p -= lr * (adam_update + wd * p)``; eps is added outside the square
  root, as torch does.
- ``optax.sgd(momentum=m)`` is ``trace`` (``t = g + m t``) then
  ``scale(-lr)``: ``torch.optim.SGD(momentum=m, dampening=0)``.
- a schedule (``step -> lr``) is evaluated at the count before the
  update, so the first update uses ``schedule(0)``.

:func:`chain` is ``optax.chain``: gradient transforms (``train.
compression.topk_compression``) rewrite ``.grad`` in order, then the last
transform's optimizer steps.
"""

from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

LearningRate = Union[float, Callable[[int], float]]


class OptState:
    """A torch optimizer and the number of updates it has applied."""

    def __init__(self, optimizer: torch.optim.Optimizer) -> None:
        self.optimizer = optimizer
        self.count = 0


class Transform:
    """An optax-style optimizer: ``init(params) -> OptState``,
    ``update(state)`` steps the optimizer on the gradients in ``.grad``."""

    def __init__(self, make: Callable[[list, float], torch.optim.Optimizer],
                 learning_rate: LearningRate) -> None:
        self._make = make
        self.learning_rate = learning_rate

    def lr(self, count: int) -> float:
        if callable(self.learning_rate):
            return float(self.learning_rate(count))
        return float(self.learning_rate)

    def init(self, params: Iterable[torch.nn.Parameter]) -> OptState:
        return OptState(self._make(list(params), self.lr(0)))

    def update(self, state: OptState) -> None:
        if callable(self.learning_rate):
            lr = self.lr(state.count)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
        state.optimizer.step()
        state.count += 1


def adamw(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Transform:
    """``optax.adamw``: Adam with decoupled weight decay on every
    parameter (optax's default 1e-4)."""
    return Transform(
        lambda params, lr: torch.optim.AdamW(
            params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay
        ),
        learning_rate,
    )


def adam(learning_rate: LearningRate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    """``optax.adam``."""
    return Transform(
        lambda params, lr: torch.optim.Adam(
            params, lr=lr, betas=(b1, b2), eps=eps
        ),
        learning_rate,
    )


def sgd(learning_rate: LearningRate, momentum=None,
        nesterov: bool = False) -> Transform:
    """``optax.sgd``: ``trace(momentum)`` then ``scale(-lr)``, i.e.
    ``torch.optim.SGD`` with ``dampening=0``."""
    return Transform(
        lambda params, lr: torch.optim.SGD(
            params, lr=lr, momentum=momentum or 0.0, dampening=0.0,
            nesterov=nesterov,
        ),
        learning_rate,
    )


class ChainState(OptState):
    """The states of a :func:`chain`'s transforms; ``optimizer`` is the
    one torch optimizer among them (the checkpoint's)."""

    def __init__(self, states: list) -> None:
        optimizers = [s.optimizer for s in states if s.optimizer is not None]
        if len(optimizers) != 1:
            raise ValueError("a chain holds one optimizer, got %d"
                             % len(optimizers))
        super().__init__(optimizers[0])
        self.states = states


class _Chain:
    def __init__(self, transforms) -> None:
        self.transforms = transforms

    def init(self, params) -> ChainState:
        params = list(params)
        return ChainState([t.init(params) for t in self.transforms])

    def update(self, state: ChainState) -> None:
        for t, s in zip(self.transforms, state.states):
            t.update(s)
        state.count += 1


def chain(*transforms) -> _Chain:
    """``optax.chain``: each transform's ``update`` in order on the same
    ``.grad`` (gradient transforms first, one optimizer last)."""
    return _Chain(transforms)
