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

This slice is the non-decode model with the dense FFN: ``decode=True``
waits for ROADMAP M13 and ``num_experts > 0`` for M15.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from edl_tpu_torch.ops.attention import attention

REMAT_POLICIES = ("save_flash", "save_flash_qkv", "full", None)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_shape = self.kernel.shape[: self.n_in]
        out_shape = self.kernel.shape[self.n_in:]
        x2 = x.reshape(*x.shape[: x.dim() - self.n_in], -1)
        kernel = self.kernel.to(self.dtype).reshape(in_shape.numel(), -1)
        y = torch.matmul(x2, kernel)
        return y.reshape(*y.shape[:-1], *out_shape)


class Attention(nn.Module):
    """Multi-head / grouped-query attention; grouped k/v go straight to
    the attention function, which reads them without a repeat.
    ``attention_fn`` (default :func:`attention`) may be set to another
    ``(q, k, v, causal=...) -> out``, e.g. the plain reference."""

    def __init__(self, d_model: int, num_heads: int, dtype, param_dtype,
                 num_kv_heads: Optional[int] = None, device=None) -> None:
        super().__init__()
        kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if kv_heads < 1 or num_heads % kv_heads:
            raise ValueError(
                "num_kv_heads (%d) must be a positive divisor of "
                "num_heads (%d)" % (kv_heads, num_heads)
            )
        head_dim = d_model // num_heads
        self.attention_fn = attention
        dense = functools.partial(
            DenseGeneral, dtype=dtype, param_dtype=param_dtype, device=device
        )
        self.q = dense((d_model, num_heads, head_dim), 1)
        self.k = dense((d_model, kv_heads, head_dim), 1)
        self.v = dense((d_model, kv_heads, head_dim), 1)
        self.o = dense((num_heads, head_dim, d_model), 2)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """q, k, v as [B, H, T, D] views of [B, T, H, D]; the kernels read
        the strides."""
        q = rope(self.q(x), positions)
        k = rope(self.k(x), positions)
        v = self.v(x)
        return tuple(t.transpose(1, 2) for t in (q, k, v))

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return self.o(o.transpose(1, 2))

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(x, positions)
        return self.out(self.attention_fn(q, k, v, causal=True))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, dtype,
                 param_dtype, num_kv_heads: Optional[int] = None,
                 device=None) -> None:
        super().__init__()
        self.ln1 = RMSNorm(d_model, device=device)
        self.attn = Attention(d_model, num_heads, dtype, param_dtype,
                              num_kv_heads, device)
        self.ln2 = RMSNorm(d_model, device=device)
        self.mlp = SwiGLU(d_model, d_ff, dtype, param_dtype, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                remat: Optional[str] = None) -> torch.Tensor:
        """``remat``: None (no checkpoint) or a ``remat_policy`` name."""
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
        o = self.attn.attention_fn(q, k, v, causal=True)
        return ckpt(self._after_attention, x, o)

    def _block(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))

    def _qkv(self, x, positions):
        return self.attn.qkv(self.ln1(x), positions)

    def _after_attention(self, x, o):
        x = x + self.attn.out(o)
        return x + self.mlp(self.ln2(x))


class Embed(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, dtype, param_dtype,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = _param((vocab_size, d_model), param_dtype, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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
    may be changed between steps."""

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
        decode: bool = False,
        device=None,
    ) -> None:
        super().__init__()
        if decode:
            raise NotImplementedError(
                "decode=True (KV-cached generation) is ROADMAP M13, not "
                "ported yet"
            )
        if num_experts > 0:
            raise NotImplementedError(
                "num_experts > 0 (SwitchMoE FFN) is ROADMAP M15, not ported yet"
            )
        if remat_policy not in REMAT_POLICIES:
            raise ValueError("unknown remat_policy %r" % (remat_policy,))
        self.num_layers = num_layers
        self.remat = remat
        self.remat_policy = remat_policy
        self.embed = Embed(vocab_size, d_model, dtype, param_dtype, device)
        for i in range(num_layers):
            self.add_module(
                "layer_%d" % i,
                Block(d_model, num_heads, d_ff, dtype, param_dtype,
                      num_kv_heads, device),
            )
        self.ln_f = RMSNorm(d_model, device=device)
        self.lm_head = LMHead(d_model, vocab_size, param_dtype, device)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device
            ).expand(tokens.shape)
        remat = None
        if self.remat and torch.is_grad_enabled():
            remat = self.remat_policy or "full"
        for i in range(self.num_layers):
            x = getattr(self, "layer_%d" % i)(x, positions, remat)
        return self.lm_head(self.ln_f(x))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransformerLM":
        """Seeded random weights: kernels ~ N(0, 1/fan_in) (LeCun normal,
        fan_in = the contracted axes), embeddings ~ N(0, 1), norm scales
        1. Drawn in fp32 on the generator's device, in ``named_parameters``
        order, then cast to each parameter's dtype."""
        for name, p in self.named_parameters():
            if name.endswith(".scale"):
                p.fill_(1.0)
                continue
            if name.endswith("embedding"):
                std = 1.0
            elif name.endswith("attn.o.kernel"):
                std = (p.shape[0] * p.shape[1]) ** -0.5
            else:
                std = p.shape[0] ** -0.5
            draw = torch.empty(p.shape, dtype=torch.float32, device=p.device)
            draw.normal_(0.0, std, generator=generator)
            p.copy_(draw)
        return self
