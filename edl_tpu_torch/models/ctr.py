"""CTR / recommendation model family: the port of ``edl_tpu/models/ctr.py``.

DeepFM over one fused embedding table for all sparse fields (ids
pre-offset into a shared hashed vocab): the wide (first-order) term, the
FM second-order interaction as sum-square minus square-sum (no ``[F, F]``
pairs), and a deep MLP over the flattened field embeddings and the dense
features, in the compute ``dtype`` (bf16 by default) with fp32
parameters. Parameters carry the flax names (``embedding/embedding``
``[V, D]``, ``wide/embedding`` ``[V, 1]``, ``mlp_i/{kernel,bias}``,
``mlp_out/{kernel,bias}``), so ``convert`` loads the JAX model's.

The JAX package shards both tables' vocab axis over the ``mp`` mesh axis
(``CTR_EMBEDDING_RULES``) and lets XLA insert the gathers. Here
``parallel.shard_params_by_rules(mesh, model, CTR_EMBEDDING_RULES)`` keeps
each ``mp`` rank's rows and installs the lookup of
:meth:`DeepFM.install_parallel`: this rank's range masked, then summed
over the ``mp`` group (``reduce_from_group``, identity backward: each
rank's rows get their own gradient whole). The ranks of an ``mp`` group
pass the same rows of the batch, so every replicated parameter's gradient
is the same on each, and the train step averages gradients over ``dp``
only.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from edl_tpu_torch.parallel.collectives import reduce_from_group

# Embedding tables shard the vocab axis over ``mp``; shard_params_by_rules
# drops axes absent from the mesh.
CTR_EMBEDDING_RULES: List[Tuple[str, tuple]] = [
    (r".*/embedding/embedding", ("mp", None)),  # [V, D] vocab-sharded
    (r".*/wide/embedding", ("mp", None)),       # [V, 1] first-order term
]


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


class _Table(nn.Module):
    """``nn.Embed``'s table (``embedding [V, D]``, fp32); vocab-sharded
    over a group after :meth:`install_mp`."""

    def __init__(self, vocab: int, dim: int, device=None) -> None:
        super().__init__()
        self.embedding = _param((vocab, dim), device)
        self.group = None
        self.start = 0

    def install_mp(self, mesh) -> None:
        self.group = mesh.group("mp")
        self.start = mesh.mp_rank * self.embedding.shape[0]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return self.embedding[ids.long()]
        rows = self.embedding.shape[0]
        local = ids.long() - self.start
        inside = (local >= 0) & (local < rows)
        x = self.embedding[local.clamp(0, rows - 1)]
        return reduce_from_group(torch.where(inside[..., None], x, 0.0),
                                 self.group)


class _Dense(nn.Module):
    """flax ``nn.Dense(use_bias=True, dtype=dtype)``: kernel ``[in, out]``
    and bias in fp32, both cast to the compute dtype."""

    def __init__(self, d_in: int, d_out: int, dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((d_in, d_out), device)
        self.bias = _param((d_out,), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (torch.matmul(x.to(self.dtype), self.kernel.to(self.dtype))
                + self.bias.to(self.dtype))


class DeepFM(nn.Module):
    """DeepFM-style CTR model: ``(sparse_ids [B, F] int, dense [B, dense])
    -> fp32 logits [B]``.

    Parameters are created uninitialised on ``device``: call
    :meth:`init_weights` or load converted weights."""

    def __init__(self, vocab_size: int = 1_000_000, embed_dim: int = 16,
                 num_fields: int = 26, dense_features: int = 13,
                 mlp_dims: Sequence[int] = (256, 128, 64),
                 dtype=torch.bfloat16, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.embed_dim = embed_dim
        self.embedding = _Table(vocab_size, embed_dim, device)
        self.wide = _Table(vocab_size, 1, device)
        d_in = num_fields * embed_dim + dense_features
        self.mlp = []
        for i, width in enumerate(mlp_dims):
            layer = _Dense(d_in, width, dtype, device)
            self.add_module("mlp_%d" % i, layer)
            self.mlp.append(layer)
            d_in = width
        self.mlp_out = _Dense(d_in, 1, dtype, device)

    def install_parallel(self, mesh, specs) -> list:
        """The tables' vocab-sharded lookup over ``mesh``'s ``mp`` group
        where the rules split them (``parallel.shard_params_by_rules``
        calls it after slicing); no gradient is partial."""
        for name in ("embedding", "wide"):
            if "mp" in specs["%s.embedding" % name]:
                getattr(self, name).install_mp(mesh)
        return []

    def forward(self, sparse_ids: torch.Tensor,
                dense: torch.Tensor) -> torch.Tensor:
        e = self.embedding(sparse_ids).to(self.dtype)       # [B, F, D]
        # FM second-order: 0.5 * sum_d((Σ_f e)² - Σ_f e²)
        s = e.sum(dim=1)                                     # [B, D]
        fm = 0.5 * (s * s - (e * e).sum(dim=1)).sum(dim=-1)  # [B]
        first_order = self.wide(sparse_ids)[..., 0].sum(dim=1)  # [B] fp32
        x = torch.cat([e.reshape(e.shape[0], -1), dense.to(self.dtype)],
                      dim=-1)
        for layer in self.mlp:
            x = torch.relu(layer(x))
        deep = self.mlp_out(x)[..., 0]                       # [B]
        return (first_order + fm + deep).float()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "DeepFM":
        """flax's initialisers from a seeded generator: the table
        N(0, 1/embed_dim), the wide table zeros, Dense kernels LeCun
        normal (N(0, 1/fan_in)), biases zeros; drawn in fp32 on the
        generator's device in ``named_parameters`` order."""
        for name, p in self.named_parameters():
            if name == "wide.embedding" or name.endswith(".bias"):
                p.zero_()
                continue
            std = (self.embed_dim ** -0.5 if name == "embedding.embedding"
                   else p.shape[0] ** -0.5)
            draw = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            draw.normal_(0.0, std, generator=generator)
            p.copy_(draw)
        return self


def binary_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor):
    """Loss head for ``make_train_step``: sigmoid BCE with accuracy, for
    CTR-style binary targets."""
    labels_f = labels.float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * labels_f
                      + torch.log1p(torch.exp(-logits.abs())))
    accuracy = ((logits > 0) == (labels_f > 0.5)).float().mean()
    return loss, {"accuracy": accuracy}
