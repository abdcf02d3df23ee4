"""Decoder-only Transformer LM: the port of ``edl_tpu/models/transformer.py``.

Pre-norm blocks with RMSNorm, half-split RoPE and a SwiGLU MLP; attention
goes through :func:`edl_tpu_torch.ops.attention.attention`, which on CUDA
tensors is the differentiable flash op (the hand-written forward and
backward kernels) and on CPU tensors the dense reference. Modules and
parameters carry the flax names, so a flax param path
``layer_0/attn/q/kernel`` is the ``state_dict`` key ``layer_0.attn.q.kernel``
with the same shape (:mod:`edl_tpu_torch.convert`).

Numerics follow the JAX model. Parameters are stored in ``param_dtype``
(fp32 by default, flax's default: the trainer's master weights) and every
product casts its kernel to the compute ``dtype`` first, as
``nn.DenseGeneral(dtype=bf16)`` does; a serving model may store them in the
compute dtype, which gives the same products. RMSNorm scales stay fp32 and
RMSNorm runs in fp32; RoPE angles are fp32; the LM head multiplies
compute-dtype operands with fp32 accumulation and returns fp32 logits.

``remat=True`` checkpoints each block (``torch.utils.checkpoint``,
non-reentrant) and ``remat_policy`` picks what the recompute keeps, as the
JAX model's policies do:

- ``"save_flash"`` (the default): the attention op runs between two
  checkpointed regions (norm + q/k/v projections + RoPE before it, output
  projection + MLP after it), so its outputs (o and lse) are kept and the
  backward never re-runs the forward kernel; both regions are recomputed.
  Its saved inputs q, k and v stay alive too (JAX recomputes them).
- ``"save_flash_qkv"``: the region before the op is not checkpointed
  either, so q, k and v are not recomputed.
- ``"full"``/``None``: the whole block is recomputed, the op included.

A selective-checkpoint policy (``create_selective_checkpoint_contexts``)
would express the same, but its dispatch mode calls back into Python for
every operation of the block, forward and recompute: measured on the
H100 at the flagship, that made the host slower than the device.

``attention_fn`` replaces the attention function, as in the JAX model: one
that does not declare ``supports_gqa`` (also through ``functools.partial``
layers) sees k/v repeated to the query heads; ring and Ulysses attention
(:mod:`edl_tpu_torch.parallel`) declare it and take grouped k/v.

Tensor parallelism: ``parallel.shard_params_by_rules(mesh, model,
TRANSFORMER_TP_RULES)`` keeps each rank's slice of the weights and calls
:meth:`TransformerLM.install_parallel`, which switches the attention, the MLP,
the embedding and the head to their Megatron forwards over the mesh's
``tp`` group: column-parallel products take their input through
``copy_to_group`` (all-reduce backward), row-parallel ones sum their
output (all-reduce forward), the vocabulary-sharded embedding looks up
its rows and sums, and the vocabulary-sharded head gathers whole fp32
logits. Where ``num_kv_heads`` does not divide ``tp`` the k/v projections
stay whole on every rank (the replicate fallback): a rank projects only
the kv heads its query heads read, through the GLOBAL head map (local q
head ``j`` of rank ``r`` reads kv head ``(r·H/tp + j) // (H/KV)``), and
their gradients are partial, summed over ``tp`` by the train step.

Decoding: ``decode=True`` (or :func:`edl_tpu_torch.models.decode.
decode_model`) is the KV-cached model of ``_decode_step``:
``forward(tokens, positions, cache)`` returns ``(logits, cache)``, the
cache a dict keyed by the flax cache paths (``layer_i/attn/cached_key``,
``cached_value``, ``cache_index``), its keys and values at the grouped
width (under tensor parallelism, the rank's kv heads) in the compute
dtype. New keys and values land in place at the running index; scores
are fp32, slots past each query's position get ``NEG_INF_DECODE``, and
every shape is static (the cache is ``max_decode_len`` long). Prefill
(T > 1) and the single-token step run the same masked products, in plain
PyTorch as in the JAX model, which has no kernel there.

Mixture of experts: with ``num_experts > 0`` every ``moe_every``-th block
(``(i + 1) % moe_every == 0``) runs :class:`~edl_tpu_torch.models.moe.
SwitchMoE` under the name ``moe`` in place of the SwiGLU ``mlp``, as the
JAX model does. Each block returns its aux loss beside its output (a
remat recompute returns its own, which the checkpoint drops), and the
model keeps the forward's terms in ``aux_losses``, which
``make_train_step(aux_losses=True)`` adds to the loss. A decode step
routes its T new tokens with the capacity of T (one slot an expert and
row for a single token), as the JAX decode does.
:meth:`TransformerLM.install_parallel` also switches the MoE blocks to
expert parallelism where the rules split their banks over ``ep``.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.models.moe import SwitchMoE
from edl_tpu_torch.ops.attention import attention
from edl_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_last_dim,
    reduce_from_group,
)

REMAT_POLICIES = ("save_flash", "save_flash_qkv", "full", None)
NEG_INF_DECODE = -1e30  # mask value for cache positions past the index


def _supports_gqa(fn) -> bool:
    """True when ``fn`` (possibly wrapped in ``functools.partial`` layers)
    declares that it takes grouped k/v (a ``supports_gqa`` attribute)."""
    while isinstance(fn, functools.partial):
        if getattr(fn, "supports_gqa", False):
            return True
        fn = fn.func
    return getattr(fn, "supports_gqa", False)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, epsilon: float = 1e-6, device=None) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.scale = _param((dim,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        norm = x32 * torch.rsqrt(
            x32.square().mean(dim=-1, keepdim=True) + self.epsilon
        )
        return (norm * self.scale).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0):
    """Rotary position embedding; x: [B, T, H, D], positions [B, T]."""
    half = x.shape[-1] // 2
    freq = base ** (
        -torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[:, :, None, None].float() * freq  # B T 1 half
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Dense(nn.Module):
    """Bias-free ``x @ kernel`` with ``kernel [in, out]`` (flax ``nn.Dense``),
    the kernel cast to the compute ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype, param_dtype,
                 device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.kernel = _param((d_in, d_out), param_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel.to(self.dtype))


class DenseGeneral(nn.Module):
    """Bias-free ``DenseGeneral``: contracts the last ``n_in`` axes of x
    with the first ``n_in`` axes of ``kernel`` (flax's layout), e.g. q
    ``[d, H, D]`` (n_in 1) or o ``[H, D, d]`` (n_in 2)."""

    def __init__(self, shape, n_in: int, dtype, param_dtype,
                 device=None) -> None:
        super().__init__()
        self.n_in = n_in
        self.dtype = dtype
        self.kernel = _param(tuple(shape), param_dtype, device)

    def forward(self, x: torch.Tensor, heads=None) -> torch.Tensor:
        """``heads``: a ``(lo, hi)`` slice of the kernel's first output
        axis to project (the kv heads a tensor-parallel rank reads)."""
        kernel = self.kernel
        if heads is not None:
            kernel = kernel[:, heads[0]:heads[1]]
        in_shape = kernel.shape[: self.n_in]
        out_shape = kernel.shape[self.n_in:]
        x2 = x.reshape(*x.shape[: x.dim() - self.n_in], -1)
        kernel = kernel.to(self.dtype).reshape(in_shape.numel(), -1)
        y = torch.matmul(x2, kernel)
        return y.reshape(*y.shape[:-1], *out_shape)


class Attention(nn.Module):
    """Multi-head / grouped-query attention; grouped k/v go straight to
    the attention function when it takes them (the default one does,
    reading them without a repeat). ``attention_fn`` (default
    :func:`attention`) may be another ``(q, k, v, causal=...) -> out``."""

    def __init__(self, d_model: int, num_heads: int, dtype, param_dtype,
                 num_kv_heads: Optional[int] = None, device=None,
                 attention_fn=None) -> None:
        super().__init__()
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if kv_heads < 1 or num_heads % kv_heads:
            raise ValueError(
                "num_kv_heads (%d) must be a positive divisor of "
                "num_heads (%d)" % (kv_heads, num_heads)
            )
        head_dim = d_model // num_heads
        self.num_heads, self.kv_heads, self.head_dim = (
            num_heads, kv_heads, head_dim)
        self.dtype = dtype
        self.attention_fn = attention_fn or attention
        # custom functions see plain MHA shapes unless they declare
        # supports_gqa, as in the JAX model
        self.repeat_kv = (attention_fn is not None
                          and not _supports_gqa(attention_fn))
        dense = functools.partial(
            DenseGeneral, dtype=dtype, param_dtype=param_dtype, device=device
        )
        self.q = dense((d_model, num_heads, head_dim), 1)
        self.k = dense((d_model, kv_heads, head_dim), 1)
        self.v = dense((d_model, kv_heads, head_dim), 1)
        self.o = dense((num_heads, head_dim, d_model), 2)
        # tensor parallelism (install_tp): the tp group, the kv heads this
        # rank projects under the replicate fallback, and the map of its
        # local q heads onto them where it is not a plain grouping
        self.tp_group = None
        self.kv_slice = None
        self.head_map = None

    def install_tp(self, mesh, specs) -> list:
        """Switch to the tensor-parallel forward over ``mesh``'s ``tp``
        group, given the resolved specs of ``q``/``k``/``v``/``o``'s
        kernels (keys ``"q"`` ...); returns the names (``"k.kernel"``,
        ``"v.kernel"``) whose gradients are partial on each rank."""
        tp = mesh.tp_size
        split = lambda name: any(a == "tp" for a in specs[name])
        if not split("q"):
            if split("o") or split("k") or split("v"):
                raise NotImplementedError("q replicated but %s split" % specs)
            return []  # H % tp != 0: the attention runs whole on each rank
        if not split("o"):
            raise NotImplementedError("q split but o replicated: %s" % specs)
        self.tp_group = mesh.group("tp")
        h_local = self.num_heads // tp
        if split("k") and split("v"):
            return []  # kv heads divide tp: a plain grouping of the shards
        if split("k") or split("v"):
            raise NotImplementedError("k and v split differently: %s" % specs)
        # the replicate fallback: this rank's q heads are global heads
        # r*h_local + j, reading kv head (r*h_local + j) // group
        group = self.num_heads // self.kv_heads
        first = mesh.tp_rank * h_local
        reads = [(first + j) // group for j in range(h_local)]
        lo, hi = reads[0], reads[-1] + 1
        self.kv_slice = (lo, hi)
        local = [r - lo for r in reads]
        g_local = h_local // (hi - lo) if h_local % (hi - lo) == 0 else 0
        if not g_local or local != [j // g_local for j in range(h_local)]:
            self.head_map = torch.tensor(local)
        return ["k.kernel", "v.kernel"]

    @property
    def kv_heads_local(self) -> int:
        """The kv heads this rank holds (and caches)."""
        if self.kv_slice is not None:
            return self.kv_slice[1] - self.kv_slice[0]
        return self.k.kernel.shape[1]

    def project(self, x: torch.Tensor, positions: torch.Tensor):
        """q, k, v as [B, T, heads, D], RoPE applied to q and k."""
        x = copy_to_group(x, self.tp_group)
        q = rope(self.q(x), positions)
        k = rope(self.k(x, self.kv_slice), positions)
        v = self.v(x, self.kv_slice)
        return q, k, v

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """q, k, v as [B, H, T, D] views of [B, T, H, D]; the kernels read
        the strides."""
        return tuple(t.transpose(1, 2) for t in self.project(x, positions))

    def _map_kv(self, k, v, dim):
        """k/v for the local q heads: as they are where the heads group
        plainly, else one per q head (``head_map``)."""
        if self.head_map is None:
            return k, v
        idx = self.head_map.to(k.device)
        return k.index_select(dim, idx), v.index_select(dim, idx)

    def attend(self, q, k, v) -> torch.Tensor:
        """The attention function on [B, H, T, D] q and grouped k/v."""
        k, v = self._map_kv(k, v, 1)
        if self.repeat_kv and k.shape[1] != q.shape[1]:
            group = q.shape[1] // k.shape[1]
            k, v = (t.repeat_interleave(group, dim=1) for t in (k, v))
        return self.attention_fn(q, k, v, causal=True)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return reduce_from_group(self.o(o.transpose(1, 2)), self.tp_group)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        return self.out(self.attend(q, k, v))

    def decode(self, x: torch.Tensor, positions: torch.Tensor, cache: dict,
               prefix: str):
        """The cached step of the JAX ``_decode_step`` for T >= 1 new
        tokens: their keys and values land in the cache at the running
        index (in place), each query attends to the slots up to its own
        position, scores in fp32. Returns ``(out, entries)``: the
        attention output projected, and this layer's cache entries."""
        ck = cache[prefix + "cached_key"]
        cv = cache[prefix + "cached_value"]
        i = cache[prefix + "cache_index"]
        q, k, v = self.project(x, positions)
        b, t, h, d = q.shape
        slots = i + torch.arange(t, device=q.device)
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))
        keys, values = self._map_kv(ck, cv, 2)
        kv = keys.shape[2]
        qg = q.float().reshape(b, t, kv, h // kv, d) * (d ** -0.5)
        scores = torch.einsum("btkgd,blkd->bkgtl", qg, keys.float())
        length = keys.shape[1]
        valid = (torch.arange(length, device=q.device)[None, :]
                 <= slots[:, None])  # [T, L]
        scores = scores.masked_fill(~valid, NEG_INF_DECODE)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgtl,blkd->btkgd", probs, values.float())
        out = out.reshape(b, t, h, d).to(self.dtype)
        entries = {prefix + "cached_key": ck, prefix + "cached_value": cv,
                   prefix + "cache_index": i + t}
        return self.out(out.transpose(1, 2)), entries


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype, param_dtype,
                 device=None) -> None:
        super().__init__()
        dense = functools.partial(
            Dense, dtype=dtype, param_dtype=param_dtype, device=device
        )
        self.gate = dense(d_model, d_ff)
        self.up = dense(d_model, d_ff)
        self.down = dense(d_ff, d_model)
        self.tp_group = None

    def install_tp(self, mesh, specs) -> list:
        """gate/up column-parallel and down row-parallel over ``tp``, or
        all three whole (``d_ff`` % tp != 0)."""
        split = [any(a == "tp" for a in specs[n])
                 for n in ("gate", "up", "down")]
        if all(split):
            self.tp_group = mesh.group("tp")
        elif any(split):
            raise NotImplementedError("MLP split in part: %s" % specs)
        return []

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.tp_group)
        y = self.down(F.silu(self.gate(x)) * self.up(x))
        return reduce_from_group(y, self.tp_group)


class Block(nn.Module):
    """Pre-norm attention and FFN: the SwiGLU ``mlp``, or with
    ``num_experts > 0`` the ``moe`` (:class:`SwitchMoE`)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, dtype,
                 param_dtype, num_kv_heads: Optional[int] = None,
                 device=None, attention_fn=None, num_experts: int = 0) -> None:
        super().__init__()
        self.ln1 = RMSNorm(d_model, device=device)
        self.attn = Attention(d_model, num_heads, dtype, param_dtype,
                              num_kv_heads, device, attention_fn)
        self.ln2 = RMSNorm(d_model, device=device)
        if num_experts > 0:
            self.moe = SwitchMoE(d_model, num_experts, d_ff, dtype=dtype,
                                 param_dtype=param_dtype, device=device)
        else:
            self.mlp = SwiGLU(d_model, d_ff, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                remat: Optional[str] = None):
        """``(out, aux)``: the aux loss of a MoE block (0-d fp32), None for
        a SwiGLU one. ``remat``: None (no checkpoint) or a
        ``remat_policy`` name."""
        if remat is None:
            return self._block(x, positions)
        ckpt = functools.partial(checkpoint, use_reentrant=False,
                                 preserve_rng_state=False)
        if remat == "full":
            return ckpt(self._block, x, positions)
        if remat == "save_flash":
            q, k, v = ckpt(self._qkv, x, positions)
        else:
            q, k, v = self._qkv(x, positions)
        o = self.attn.attend(q, k, v)
        return ckpt(self._after_attention, x, o)

    def decode(self, x, positions, cache, prefix):
        h, entries = self.attn.decode(self.ln1(x), positions, cache,
                                      prefix + "attn/")
        x = x + h
        return x + self._ffn(self.ln2(x))[0], entries

    def _ffn(self, h):
        if hasattr(self, "moe"):
            return self.moe(h, return_aux=True)
        return self.mlp(h), None

    def _residual_ffn(self, x):
        y, aux = self._ffn(self.ln2(x))
        return x + y, aux

    def _block(self, x, positions):
        return self._residual_ffn(x + self.attn(self.ln1(x), positions))

    def _qkv(self, x, positions):
        return self.attn.qkv(self.ln1(x), positions)

    def _after_attention(self, x, o):
        return self._residual_ffn(x + self.attn.out(o))


class Embed(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((vocab_size, d_model), param_dtype, device)
        self.tp_group = None
        self.vocab_start = 0

    def install_tp(self, mesh, specs) -> list:
        """Vocabulary-sharded: this rank holds rows ``[r·V/tp, (r+1)·V/tp)``."""
        if specs["embedding"][0] == "tp":
            self.tp_group = mesh.group("tp")
            self.vocab_start = mesh.tp_rank * self.embedding.shape[0]
        return []

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return F.embedding(tokens.long(), self.embedding).to(self.dtype)
        # the masked lookup of this rank's rows, summed over tp
        rows = self.embedding.shape[0]
        local = tokens.long() - self.vocab_start
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), self.embedding)
        x = torch.where(inside[..., None], x, 0.0).to(self.dtype)
        return reduce_from_group(x, self.tp_group)


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of two compute-dtype (bf16) CUDA matrices with fp32
    accumulation and fp32 output; the backward's products keep bf16
    operands (the fp32 cotangent rounded to bf16) with fp32 sums."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return torch.mm(g, w.t()), torch.mm(x.t(), g)


class LMHead(nn.Module):
    """Vocabulary projection: compute-dtype operands, fp32 accumulation,
    fp32 logits (the JAX head's ``preferred_element_type=float32``)."""

    def __init__(self, d_model: int, vocab_size: int, param_dtype,
                 device=None):
        super().__init__()
        self.kernel = _param((d_model, vocab_size), param_dtype, device)
        self.tp_group = None

    def install_tp(self, mesh, specs) -> list:
        """Vocabulary-sharded: local logits, gathered whole."""
        if specs["kernel"][1] == "tp":
            self.tp_group = mesh.group("tp")
        return []

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = copy_to_group(x, self.tp_group)
        return gather_last_dim(self._local(x), self.tp_group)

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        x2 = x.reshape(-1, x.shape[-1])
        kernel = self.kernel.to(x.dtype)
        if x.device.type == "cuda" and x.dtype != torch.float32:
            logits = _MatmulF32.apply(x2, kernel)
        else:
            # exact products of the compute-dtype values, fp32 sums
            logits = torch.mm(x2.float(), kernel.float())
        return logits.reshape(*x.shape[:-1], -1)


class TransformerLM(nn.Module):
    """``tokens [B, T] -> fp32 logits [B, T, vocab]``.

    Parameters are created uninitialised on ``device`` in ``param_dtype``
    (the norm scales always in fp32): call :meth:`init_weights` with a
    seeded ``torch.Generator`` or load converted weights
    (:func:`edl_tpu_torch.convert.load_params`). ``dtype`` is the compute
    type. ``remat``/``remat_policy``: see the module docstring; the policy
    may be changed between steps. ``attention_fn``, ``decode``,
    ``max_decode_len``, ``num_experts`` and ``moe_every``: see the module
    docstring."""

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 512,
        num_heads: int = 8,
        num_layers: int = 6,
        d_ff: int = 1408,
        dtype=torch.bfloat16,
        param_dtype=torch.float32,
        remat: bool = False,
        remat_policy: Optional[str] = "save_flash",
        num_kv_heads: Optional[int] = None,
        num_experts: int = 0,
        moe_every: int = 2,
        decode: bool = False,
        max_decode_len: int = 2048,
        attention_fn=None,
        device=None,
    ) -> None:
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError("unknown remat_policy %r" % (remat_policy,))
        self.num_layers = num_layers
        self.remat = remat
        self.remat_policy = remat_policy
        self.decode = decode
        self.max_decode_len = max_decode_len
        self.dtype = dtype
        self.num_experts = num_experts
        self.moe_every = moe_every
        self.aux_losses: list = []
        self.embed = Embed(vocab_size, d_model, dtype, param_dtype, device)
        for i in range(num_layers):
            self.add_module(
                "layer_%d" % i,
                Block(d_model, num_heads, d_ff, dtype, param_dtype,
                      num_kv_heads, device, attention_fn,
                      num_experts if num_experts > 0
                      and (i + 1) % moe_every == 0 else 0),
            )
        self.ln_f = RMSNorm(d_model, device=device)
        self.lm_head = LMHead(d_model, vocab_size, param_dtype, device)

    def install_parallel(self, mesh, specs) -> list:
        """The forward over ``mesh``, given every parameter's resolved spec
        (``parallel.shard_params_by_rules`` calls it after slicing the
        parameters): the MoE blocks' expert, sequence and data
        parallelism (:meth:`SwitchMoE.install_parallel`), and at ``tp`` > 1
        the tensor-parallel forward over the ``tp`` group. Returns the
        parameters whose gradients are partial on each rank (summed over
        ``tp``)."""
        def local(prefix):
            return {n[len(prefix):].removesuffix(".kernel"): s
                    for n, s in specs.items() if n.startswith(prefix)}

        layers = [getattr(self, "layer_%d" % i)
                  for i in range(self.num_layers)]
        for i, layer in enumerate(layers):
            if hasattr(layer, "moe"):
                layer.moe.install_parallel(mesh, local("layer_%d.moe." % i))
        if mesh.tp_size == 1:
            return []
        partial = []
        for prefix, mod in [("embed.", self.embed),
                            ("lm_head.", self.lm_head)] + [
                ("layer_%d.%s." % (i, part), getattr(layer, part))
                for i, layer in enumerate(layers)
                for part in ("attn", "mlp") if hasattr(layer, part)]:
            partial += [prefix + n
                        for n in mod.install_tp(mesh, local(prefix))]
        return partial

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, cache=None):
        """``fp32 logits [B, T, vocab]``; in decode mode ``(logits,
        cache)``, the cache given (or a zero one) with the new keys and
        values in place and every ``cache_index`` advanced by T. Outside
        decode mode the MoE blocks' aux losses land in ``aux_losses``."""
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device
            ).expand(tokens.shape)
        if self.decode:
            if cache is None:
                from edl_tpu_torch.models.decode import init_cache

                cache = init_cache(self, tokens.shape[0], self.max_decode_len)
            new_cache = {}
            for i in range(self.num_layers):
                x, entries = getattr(self, "layer_%d" % i).decode(
                    x, positions, cache, "layer_%d/" % i)
                new_cache.update(entries)
            return self.lm_head(self.ln_f(x)), new_cache
        remat = None
        if self.remat and torch.is_grad_enabled():
            remat = self.remat_policy or "full"
        aux_losses = []
        for i in range(self.num_layers):
            x, aux = getattr(self, "layer_%d" % i)(x, positions, remat)
            if aux is not None:
                aux_losses.append(aux)
        self.aux_losses = aux_losses
        return self.lm_head(self.ln_f(x))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Seeded random weights: kernels ~ N(0, 1/fan_in) (LeCun normal,
        fan_in = the contracted axes; of a MoE bank ``[E, in, out]``,
        flax's ``E · in``), embeddings ~ N(0, 1), norm scales 1. Drawn in
        fp32 on the generator's device, in ``named_parameters`` order, then
        cast to each parameter's dtype."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            if name.endswith("embedding"):
                std = 1.0
            elif name.endswith(("attn.o.kernel", "moe.wi", "moe.wo")):
                std = (p.shape[0] * p.shape[1]) ** -0.5
            else:
                std = p.shape[0] ** -0.5
            draw = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            draw.normal_(0.0, std, generator=generator)
            p.copy_(draw)
        return self
