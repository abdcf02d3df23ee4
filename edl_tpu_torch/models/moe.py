"""Mixture-of-Experts FFN: the port of ``edl_tpu/models/moe.py``.

:class:`SwitchMoE` computes the JAX module's function: Switch top-1
routing (or GShard top-2, ``top_k=2``) in fp32, a capacity of
``max(1, int(capacity_factor · k · S / E))`` slots per expert and batch
row, CHOICE-MAJOR queues (every first choice claims its slot before any
second choice), tokens past capacity dropped (their output exactly zero),
the expert FFN ``gelu(x · wi) · wo`` in the compute ``dtype`` (flax's
``nn.gelu`` is the tanh approximation), and the Switch load-balancing
loss ``aux_weight · E · Σ frac_tokens · frac_probs`` over first choices.
At ``top_k == 1`` the combine weight is the raw gate probability, at 2
the two gates renormalised.

Where the JAX module builds dense ``[B, S, E, C]`` one-hot dispatch and
combine tensors and contracts them (168 MB of fp32 a layer at the
flagship), the port computes each choice's queue position in integers and
moves rows by index: a scatter of the tokens into the ``[E, B·C, D]``
expert buffer (the JAX ``ebcd`` layout), two batched products, a gather
back weighted by the combine weights. The same function: a slot holds at
most one token, so the JAX contractions copy rows too; the weighted rows
are summed in fp32 and rounded once to the compute dtype, as a bf16
contraction with fp32 accumulation does.

The aux loss is returned, not stored (``forward(x, return_aux=True)``),
so that it survives remat: a recompute in the backward returns its own,
which the checkpoint drops. Called plainly, the module keeps the last aux
in ``aux_losses`` for the train step (``make_train_step(aux_losses=
True)``), as a bare flax ``SwitchMoE`` sows it.

Parallelism (:meth:`SwitchMoE.install_parallel`, which
``parallel.shard_params_by_rules`` reaches through the model):

- expert parallelism: ``MOE_EP_RULES`` split the ``[E]`` axis of ``wi``
  and ``wo`` over ``ep``; the router stays whole. Every ``ep`` rank holds
  the same tokens (batches shard over ``dp`` only), routes them alike and
  runs its own experts on the slots that route to them; the partial
  combine is summed over ``ep`` (g: all-reduce forward, identity
  backward), and the experts' input and the combine weights pass through
  f (identity forward, all-reduce backward), so everything upstream gets
  the whole gradient. The router's input does not: each rank computes its
  gradient whole;
- sequence parallelism: a rank holds a chunk of the sequence, and the
  JAX module sees the whole one: the capacity comes from the global S and
  each chunk's queue positions follow the earlier ``sp`` ranks' counts,
  choice-major (all ranks' ``[B, k, E]`` counts are gathered);
- data and sequence parallelism: ``frac_tokens`` and ``frac_probs`` are
  means over the global batch (one all-reduce of the counts and the
  probabilities' sums over the ranks whose gradients are averaged). The
  aux's value is the global one on every rank; its gradient is that of
  the rank's own ``frac_probs``, which the average over those ranks
  makes the global gradient;
- tensor parallelism leaves the MoE whole on every ``tp`` rank
  (``TRANSFORMER_TP_RULES`` has no rule for it): its gradients are not
  summed over ``tp``.

A pipeline refuses the MoE LM (``parallel.pipeline_lm``), as the JAX
pipeline does: its blocks are not homogeneous. The dp × tp × sp × ep dry
run waits for ROADMAP M24.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.parallel.collectives import (
    _gather_stacked,
    all_reduce_,
    copy_to_group,
    group_rank,
    group_size,
    reduce_from_group,
)

# Expert-parallel sharding rules: expert banks split their leading [E] axis
# over ``ep``; the router stays replicated.
MOE_EP_RULES = [
    (r".*/moe/w[io]", ("ep", None, None)),
]


class Routing(NamedTuple):
    """One forward's routing of ``x [B, S, D]``."""

    probs: torch.Tensor    # [B, S, E] fp32 softmax of the router logits
    gates: torch.Tensor    # [B, S, k] fp32 combine weights
    experts: torch.Tensor  # [B, S, k] int64, best expert first
    slots: torch.Tensor    # [B, S, k] int64 0-based queue position
    keep: torch.Tensor     # [B, S, k] bool: within capacity
    capacity: int


def _queue_slots(experts: torch.Tensor, num_experts: int,
                 sp_group) -> torch.Tensor:
    """Each choice's 0-based position in its expert's queue of its batch
    row, choice-major over the whole sequence: the choices ``c' < c`` of
    every ``sp`` rank first, then choice ``c`` of the earlier ranks, then
    this chunk's tokens in order. Integers throughout."""
    onehot = F.one_hot(experts, num_experts)          # [B, S, k, E]
    counts = onehot.sum(dim=1)                        # [B, k, E]
    before = torch.zeros_like(counts)
    total = counts
    if group_size(sp_group) > 1:
        every = _gather_stacked(counts, sp_group)     # [sp, B, k, E]
        before = every[:group_rank(sp_group)].sum(dim=0)
        total = every.sum(dim=0)
    earlier = total.cumsum(dim=1) - total             # the earlier choices
    pos = onehot.cumsum(dim=1) + (earlier + before)[:, None]
    return pos.gather(-1, experts[..., None]).squeeze(-1) - 1


class Router(nn.Module):
    """The fp32 router ``x @ kernel`` (flax ``nn.Dense(E, dtype=float32)``,
    no bias)."""

    def __init__(self, d_model: int, num_experts: int, device=None) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(
            (d_model, num_experts), dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x.float(), self.kernel.float())


class SwitchMoE(nn.Module):
    """Top-k routed expert FFN bank, ``[B, S, D] -> [B, S, D]``; see the
    module docstring. Parameters (flax names): ``router.kernel [D, E]``
    fp32, ``wi [E, D, F]`` and ``wo [E, F, D]`` in ``param_dtype`` (fp32 by
    default, as in the JAX module), cast to ``dtype`` for the products."""

    def __init__(self, d_model: int, num_experts: int = 8, d_ff: int = 2048,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 top_k: int = 1, dtype=torch.bfloat16,
                 param_dtype=torch.float32, device=None) -> None:
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.top_k = top_k
        self.dtype = dtype
        self.router = Router(d_model, num_experts, device)
        self.wi = nn.Parameter(torch.empty(
            (num_experts, d_model, d_ff), dtype=param_dtype, device=device))
        self.wo = nn.Parameter(torch.empty(
            (num_experts, d_ff, d_model), dtype=param_dtype, device=device))
        # parallelism (install_parallel): the ep group and this rank's
        # first expert, the sp group of the queues, and the group whose
        # ranks' gradients are averaged (the aux's statistics)
        self.ep_group = None
        self.expert_start = 0
        self.sp_group = None
        self.batch_group = None
        self.aux_losses: list = []
        # the last forward's served routes, [B, S, k] bool (within
        # capacity); a device tensor, never synchronised here
        self.kept: Optional[torch.Tensor] = None

    def install_parallel(self, mesh, specs) -> None:
        """Run over ``mesh``, given the resolved specs of ``wi``/``wo``
        (keys ``"wi"``, ``"wo"``; the router's are ignored): expert
        parallel over ``ep`` where the rules split the banks, the queues
        over ``sp``, the aux's statistics over ``dp × sp``."""
        from edl_tpu_torch.parallel.sharding_rules import average_group

        split = [any(a == "ep" for a in specs.get(n, ()))
                 for n in ("wi", "wo")]
        if any(split) and not all(split):
            raise NotImplementedError("MoE banks split in part: %s" % specs)
        if all(split):
            self.ep_group = mesh.group("ep")
            self.expert_start = mesh.coords["ep"] * self.wi.shape[0]
        self.sp_group = mesh.group("sp") if mesh.sp_size > 1 else None
        self.batch_group = average_group(mesh)[0]

    def set_batch_group(self, group) -> None:
        """The ranks whose gradients are averaged (data parallelism's
        group): the aux's statistics are reduced over them."""
        self.batch_group = group

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SwitchMoE":
        """LeCun normal draws, as the model's ``init_weights``: the router
        N(0, 1/D); the banks N(0, 1/fan_in) with flax's fan-in of a 3-D
        kernel, ``E · D`` for ``wi`` and ``E · F`` for ``wo``."""
        for p in (self.router.kernel, self.wi, self.wo):
            fan_in = p.shape[0] if p.dim() == 2 else p.shape[0] * p.shape[1]
            draw = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            draw.normal_(0.0, fan_in ** -0.5, generator=generator)
            p.copy_(draw)
        return self

    def route(self, x: torch.Tensor) -> Routing:
        """Routing of ``x [B, S, D]`` (fp32): probabilities, top-k gates
        and experts, queue slots and the kept choices."""
        b, s, _ = x.shape
        e, k = self.num_experts, self.top_k
        seq = s * group_size(self.sp_group)  # the whole sequence's length
        capacity = max(1, int(self.capacity_factor * k * seq / e))
        probs = torch.softmax(self.router(x), dim=-1)
        gates, experts = probs.topk(k, dim=-1)
        if k > 1:
            # renormalised over the selected experts (GShard); not at k 1,
            # where Switch scales by the raw gate probability
            gates = gates / gates.sum(dim=-1, keepdim=True)
        with torch.no_grad():
            slots = _queue_slots(experts, e, self.sp_group)
        return Routing(probs, gates, experts, slots, slots < capacity,
                       capacity)

    def aux_loss(self, r: Routing) -> torch.Tensor:
        """The Switch load-balancing loss (first choices), over the whole
        batch of the ranks in ``batch_group``."""
        e = self.num_experts
        n = r.probs.shape[0] * r.probs.shape[1]
        frac_probs = r.probs.mean(dim=(0, 1))
        counts = F.one_hot(r.experts[..., 0], e).sum(dim=(0, 1)).float()
        ranks = group_size(self.batch_group)
        if ranks > 1:
            stats = torch.cat([counts, r.probs.detach().sum(dim=(0, 1))])
            all_reduce_(stats, self.batch_group)
            n *= ranks
            counts = stats[:e]
            # the global value, the gradient of this rank's mean
            frac_probs = frac_probs + (stats[e:] / n - frac_probs).detach()
        return self.aux_weight * e * torch.sum(counts / n * frac_probs)

    def experts_out(self, x: torch.Tensor, r: Routing) -> torch.Tensor:
        """The kept routes through this rank's experts, combined (summed
        over ``ep``), in ``x``'s dtype."""
        b, s, d = x.shape
        k, cap = self.top_k, r.capacity
        e_local = self.wi.shape[0]
        local = r.experts - self.expert_start
        mine = r.keep & (local >= 0) & (local < e_local)
        rows = e_local * b * cap
        brow = torch.arange(b, device=x.device)[:, None, None]
        # each served route's row of the [E, B, C] buffer; the others
        # land on one spill row past its end
        dest = torch.where(mine, (local * b + brow) * cap + r.slots, rows)
        dest = dest.reshape(-1)
        xd = copy_to_group(x.to(self.dtype), self.ep_group)
        src = xd[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
        buf = xd.new_zeros((rows + 1, d)).index_copy(0, dest, src)
        h = torch.bmm(buf[:rows].view(e_local, b * cap, d),
                      self.wi.to(self.dtype))
        h = F.gelu(h, approximate="tanh")
        out = torch.bmm(h, self.wo.to(self.dtype)).view(rows, d)
        out = torch.cat([out, out.new_zeros((1, d))])
        picked = out.index_select(0, dest).view(b, s, k, d)
        gates = copy_to_group(r.gates, self.ep_group) * mine
        w = gates.to(self.dtype).float()
        y = (w[..., None] * picked.float()).sum(dim=2)
        y = reduce_from_group(y, self.ep_group)
        return y.to(self.dtype).to(x.dtype)

    def forward(self, x: torch.Tensor, return_aux: bool = False):
        """``[B, S, D] -> [B, S, D]``; with ``return_aux`` also the aux
        loss (0-d fp32), else the aux is kept in ``aux_losses``."""
        r = self.route(x)
        aux = self.aux_loss(r)
        out = self.experts_out(x, r)
        self.kept = r.keep
        if return_aux:
            return out, aux
        self.aux_losses = [aux]
        return out
