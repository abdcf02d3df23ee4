"""Autoregressive decoding for :class:`TransformerLM`: the port of
``edl_tpu/models/decode.py``.

A KV-cached greedy decode: one bulk prefill pass over the prompt, then the
single-token step. The step's shapes are static (the cache is
``max_decode_len`` long, its validity masked by the running index, the
index a device tensor), so a later change can capture it in a CUDA graph.
With grouped-query models the cache is stored at ``num_kv_heads`` width
(under tensor parallelism: the rank's kv heads), in the compute dtype. A
MoE model's blocks route the prefill's prompt with the prompt's capacity
and each single-token step with one slot an expert and row, as the JAX
decode does.

Usage::

    tokens = greedy_generate(model, prompt, max_new_tokens=32)
"""

from __future__ import annotations

import copy

import torch

from edl_tpu_torch.models.transformer import TransformerLM


def decode_model(model: TransformerLM, max_decode_len: int) -> TransformerLM:
    """The decode-mode twin of a trained model: the same modules and
    parameters (a shallow copy with ``decode=True``)."""
    twin = copy.copy(model)
    twin.decode = True
    twin.max_decode_len = max_decode_len
    return twin


def init_cache(model: TransformerLM, batch: int, max_decode_len: int) -> dict:
    """A zeroed KV cache for ``model``: per layer ``cached_key`` and
    ``cached_value`` ``[batch, max_decode_len, kv heads, head_dim]`` in the
    compute dtype (the grouped width; the rank's kv heads under tensor
    parallelism) and a 0-d int32 ``cache_index``, on the model's device,
    keyed by the flax cache paths."""
    dev = model.lm_head.kernel.device
    cache = {}
    for i in range(model.num_layers):
        attn = getattr(model, "layer_%d" % i).attn
        shape = (batch, max_decode_len, attn.kv_heads_local, attn.head_dim)
        prefix = "layer_%d/attn/" % i
        cache[prefix + "cached_key"] = torch.zeros(shape, dtype=model.dtype,
                                                   device=dev)
        cache[prefix + "cached_value"] = torch.zeros(shape, dtype=model.dtype,
                                                     device=dev)
        cache[prefix + "cache_index"] = torch.zeros((), dtype=torch.int32,
                                                    device=dev)
    return cache


@torch.no_grad()
def greedy_generate(model: TransformerLM, prompt: torch.Tensor,
                    max_new_tokens: int,
                    max_decode_len: int | None = None) -> torch.Tensor:
    """Greedy decode: ``[B, P + max_new_tokens]`` tokens (the prompt
    first). One bulk prefill over the prompt, then ``max_new_tokens - 1``
    single-token steps; ``max_new_tokens <= 0`` returns the prompt."""
    b, plen = prompt.shape
    if plen < 1:
        raise ValueError("prompt must hold at least one token")
    total = plen + max_new_tokens
    cap = max_decode_len or total
    if cap < total:
        raise ValueError("max_decode_len %d < prompt+new %d" % (cap, total))
    if max_new_tokens <= 0:
        return prompt
    dm = decode_model(model, cap)
    cache = init_cache(model, b, cap)
    positions = torch.arange(plen, device=prompt.device).expand(b, plen)
    logits, cache = dm(prompt, positions, cache)
    tok = logits[:, -1, :].argmax(dim=-1).to(prompt.dtype)
    out = [prompt, tok[:, None]]
    pos = torch.full((b, 1), plen, dtype=torch.long, device=prompt.device)
    for _ in range(max_new_tokens - 1):
        logits, cache = dm(tok[:, None], pos, cache)
        tok = logits[:, -1, :].argmax(dim=-1).to(prompt.dtype)
        out.append(tok[:, None])
        pos = pos + 1
    return torch.cat(out, dim=1)
