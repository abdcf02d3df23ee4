"""Small dense models: the port of ``edl_tpu/models/mlp.py``.

The reference's minimum end-to-end example (``example/fit_a_line``,
13-feature linear regression) and an MLP. Flax infers a Dense layer's
input width at init; a torch module is built whole, so both take
``in_features``. Layers carry flax's auto-names (``Dense_0``, ...), each
``kernel [in, out]`` and ``bias [out]``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.models.resnet import Dense


class LinearRegression(nn.Module):
    """y = xW + b; the fit_a_line model."""

    def __init__(self, in_features: int, features: int = 1,
                 device=None) -> None:
        super().__init__()
        self.Dense_0 = Dense(in_features, features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LinearRegression":
        self.Dense_0.init_weights(generator)
        return self


class MLP(nn.Module):
    """ReLU MLP: ``hidden`` widths, then a ``features``-wide output."""

    def __init__(self, in_features: int, hidden: Sequence[int] = (64, 64),
                 features: int = 1, dtype=torch.float32, device=None) -> None:
        super().__init__()
        widths = (in_features,) + tuple(hidden) + (features,)
        self.n_layers = len(widths) - 1
        for i in range(self.n_layers):
            self.add_module("Dense_%d" % i, Dense(
                widths[i], widths[i + 1], dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, "Dense_%d" % i)(x)
            if i < self.n_layers - 1:
                x = F.relu(x)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MLP":
        for i in range(self.n_layers):
            getattr(self, "Dense_%d" % i).init_weights(generator)
        return self
