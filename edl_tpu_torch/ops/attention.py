"""Attention: the plain PyTorch reference and the CUDA flash forward.

The port of ``edl_tpu/ops/attention.py``. Layout ``[batch, heads, seq,
head_dim]``; k/v may carry fewer heads than q (GQA/MQA) as long as the
count divides.

- :func:`attention_reference_with_lse` is the plain version, and the spec:
  fp32 scores, the END-aligned causal mask (``q_offset = tk - tq``) with
  the finite mask value ``NEG_INF`` (a row that sees no key gets a
  uniform softmax, not NaN), probabilities cast to ``v.dtype`` before p·v.
- :func:`flash_forward` is the wrapper of the hand-written CUDA kernel
  ``csrc/flash_fwd.cu`` (the counterpart of the TPU ``_flash_kernel`` and
  ``_flash2_kernel``). On a CPU tensor it is the plain version; on a CUDA
  tensor it launches the kernel or raises. ``flash_forward.launches``
  counts the launches.
- :func:`attention`, :func:`flash_attention` and :func:`flash_with_lse`
  keep the JAX package's signatures. On the CPU, ``attention`` is exactly
  the reference, as the JAX package is off the TPU.

The kernel has no backward yet: a CUDA call that needs a gradient raises.
The TPU dispatch machinery (measured block tables, the packaged dispatch
table, the sequence and dense-size limits) was measured on a TPU v5e and
is not carried over: on CUDA the kernel serves every shape it takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

NEG_INF = -1e30

# dtype codes of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_TRAINING_SLICE = (
    "the flash backward kernels (ROADMAP K2 dq, K3 dk/dv) come with the "
    "training slice; run the forward under torch.inference_mode() or "
    "torch.no_grad()"
)


def _dense_causal_mask(scores: torch.Tensor) -> torch.Tensor:
    """End-aligned causal mask for a dense [..., Tq, Tk] score tensor:
    ``qpos = arange(Tq) + (Tk - Tq)`` so sequence ENDS line up."""
    tq, tk = scores.shape[-2], scores.shape[-1]
    qpos = torch.arange(tq, device=scores.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=scores.device)[None, :]
    return scores.masked_fill(qpos < kpos, NEG_INF)


def _gqa_group(q: torch.Tensor, k: torch.Tensor) -> int:
    """q heads per kv head (1 = plain MHA)."""
    h, h_kv = q.shape[1], k.shape[1]
    if h == h_kv:
        return 1
    if h_kv < 1 or h % h_kv:
        raise ValueError("kv heads (%d) must divide q heads (%d)" % (h_kv, h))
    return h // h_kv


def _broadcast_kv(q, k, v):
    g = _gqa_group(q, k)
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def attention_reference_with_lse(q, k, v, causal: bool = False, scale=None):
    """Plain attention with the per-row logsumexp of the scaled scores:
    ``(out [B, H, Tq, D] in v.dtype, lse [B, H, Tq] fp32)``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    k, v = _broadcast_kv(q, k, v)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        scores = _dense_causal_mask(scores)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)
    return out, lse


def attention_reference(q, k, v, causal: bool = False, scale=None):
    """Plain softmax attention; [B, H, T, D] in, [B, H, Tq, D] out."""
    return attention_reference_with_lse(q, k, v, causal=causal, scale=scale)[0]


def _check_kernel_inputs(q, k, v) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("%s on %s, q on %s" % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError("%s is %s, q is %s" % (name, t.dtype, q.dtype))
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            "flash_forward takes bfloat16 or float32, not %s" % q.dtype
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, heads, T, D]")
    b, h, _, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(
            "flash_forward takes head_dim in %s, not %d" % (_HEAD_DIMS, d)
        )
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            "k %s / v %s do not match q %s"
            % (tuple(k.shape), tuple(v.shape), tuple(q.shape))
        )
    _gqa_group(q, k)
    if k.shape[2] < 1:
        raise ValueError("flash_forward needs at least one key")
    if b * h > 65535:
        raise ValueError("B*H = %d exceeds the grid limit 65535" % (b * h))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                "%s needs unit stride on head_dim (strides %s)"
                % (name, t.stride())
            )
    _prepare_device(q.device.index)


@functools.lru_cache(maxsize=None)
def _prepare_device(index) -> None:
    """Once per device: require Hopper and set the kernel's shared-memory
    attribute there (kept off the launch path)."""
    major, minor = torch.cuda.get_device_capability(index)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            "the flash kernel is built for sm_90a (Hopper); %s is sm_%d%d"
            % (torch.cuda.get_device_name(index), major, minor)
        )
    with torch.cuda.device(index):
        err = _flash_lib().edl_flash_fwd_prepare()
    if err != 0:
        raise RuntimeError("flash_fwd prepare failed: CUDA error %d" % err)


@functools.lru_cache(maxsize=None)
def _flash_lib():
    """The library of ``csrc/flash_fwd.cu``, built at first use."""
    from edl_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    lib.edl_flash_fwd_prepare.argtypes = ()
    lib.edl_flash_fwd_prepare.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _flash_fwd_fn():
    """The C entry point of ``csrc/flash_fwd.cu``."""
    fn = _flash_lib().edl_flash_fwd
    fn.argtypes = (
        [ctypes.c_int, ctypes.c_int]
        + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5
        + [ctypes.c_longlong] * 12
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def flash_forward(q, k, v, causal: bool = False, scale=None):
    """``(o [B, H, Tq, D], lse [B, H, Tq] fp32)``.

    CPU tensors: the plain version. CUDA tensors: one launch of the flash
    kernel on the current stream (no synchronisation), or an exception —
    unsupported dtype (``TypeError``), head_dim or shape (``ValueError``),
    or a call that needs a gradient (``NotImplementedError``). ``o`` is a
    [B, H, Tq, D] view of [B, Tq, H, D] memory: the layout the attention
    output projection reads without a copy."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError("flash_forward runs on cpu or cuda, not %s" % q.device)
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        raise NotImplementedError(
            "flash_forward on CUDA has no backward yet: " + _TRAINING_SLICE
        )
    _check_kernel_inputs(q, k, v)
    fn = _flash_fwd_fn()
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0 or b * h == 0:
        return o, lse
    strides = []
    for t in (q, k, v, o):
        strides.extend(t.stride()[:3])
    # every q/k/v row on a 16-byte boundary: the kernel loads 16-byte vectors
    vec16 = all(
        t.data_ptr() % 16 == 0
        and all(s * t.element_size() % 16 == 0 for s in t.stride()[:3])
        for t in (q, k, v)
    )
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, h_kv, tq, tk,
            *strides, int(bool(causal)), float(scale), int(vec16), stream,
        )
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: CUDA error %d" % err)
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def flash_with_lse(q, k, v, causal: bool = False, scale=None,
                   block_q=None, block_k=None):
    """Forward-only ``(o, lse)`` with ``lse`` as [B, H, Tq] fp32 — the
    primitive blockwise/ring merging builds on. ``block_q``/``block_k``
    keep the JAX signature; the CUDA kernel's tiles are fixed (64 x 64)."""
    return flash_forward(q, k, v, causal=causal, scale=scale)


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None):
    """Flash attention output (see :func:`flash_with_lse`)."""
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]


def attention(q, k, v, causal: bool = False, scale=None):
    """The default entry point for every model: on CPU tensors exactly the
    dense reference (native autodiff), on CUDA tensors the flash kernel."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]
