"""Attention: the plain PyTorch reference and the CUDA flash kernels.

The port of ``edl_tpu/ops/attention.py``. Layout ``[batch, heads, seq,
head_dim]``; k/v may carry fewer heads than q (GQA/MQA) as long as the
count divides.

- :func:`attention_reference_with_lse` is the plain version of the
  forward, and the spec: fp32 scores, the END-aligned causal mask
  (``q_offset = tk - tq``) with the finite mask value ``NEG_INF`` (a row
  that sees no key gets a uniform softmax, not NaN), probabilities cast to
  ``v.dtype`` before p·v.
- :func:`_block_grads_reference` is the plain version of the backward
  (both kernels together), given the forward's per-row ``lse`` and the
  row correction ``delta = rowsum(dO∘O)``; it agrees with autograd through
  the reference, rows that see no key included (p = 1/Tk, ds = 0).
- :func:`flash_forward` (``csrc/flash_fwd.cu``, the counterpart of the TPU
  ``_flash_kernel``/``_flash2_kernel``), :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv` (``csrc/flash_bwd.cu``, the counterparts of
  ``_flash_bwd_dq_kernel``/``_flash2_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``/``_flash2_bwd_dkv_kernel``) are the kernel
  wrappers. On a CPU tensor each is its plain version; on a CUDA tensor it
  launches its kernel or raises. Each counts its launches in
  ``<wrapper>.launches``.
- ``torch.ops.edl_tpu_torch.flash_fwd`` is the differentiable op: its
  forward is :func:`flash_forward`, its backward :func:`flash_backward`
  (K2 then K3, no fallback). It saves q, k, v, o and lse, the residuals
  the JAX package names for its remat policies; the model's
  ``save_flash`` keeps them by running the op outside its checkpointed
  regions.
- :func:`attention`, :func:`flash_attention`, :func:`flash_with_lse` and
  :func:`flash_block_grads` keep the JAX package's signatures. On CPU
  tensors ``attention`` is exactly the reference with native autodiff, as
  the JAX package is off the TPU; on CUDA tensors it is the op.

The TPU dispatch machinery (measured block tables, the packaged dispatch
table, the sequence and dense-size limits) was measured on a TPU v5e and
is not carried over: on CUDA the kernels serve every shape they take.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch import Tensor

NEG_INF = -1e30

# dtype codes of the C interface
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _dense_causal_mask(scores: torch.Tensor) -> torch.Tensor:
    """End-aligned causal mask for a dense [..., Tq, Tk] score tensor:
    ``qpos = arange(Tq) + (Tk - Tq)`` so sequence ENDS line up."""
    tq, tk = scores.shape[-2], scores.shape[-1]
    return scores.masked_fill(~_causal_visible(tq, tk, scores.device), NEG_INF)


def _causal_visible(tq: int, tk: int, device) -> torch.Tensor:
    """[Tq, Tk] bool: query row i sees key j (end-aligned)."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=device)[None, :]
    return qpos >= kpos


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


def _fold_dkv(dk, dv, b, h_kv, group, tk, d):
    """Sum full-q-head-width dk/dv back to the grouped input width."""
    if group == 1:
        return dk, dv
    dk = dk.reshape(b, h_kv, group, tk, d).sum(dim=2)
    dv = dv.reshape(b, h_kv, group, tk, d).sum(dim=2)
    return dk, dv


def _bwd_delta(g: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO∘O)`` in fp32, [B, H, Tq]: the softmax-jacobian
    row correction both backward kernels consume."""
    return (g.float() * o.float()).sum(dim=-1)


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


def _block_grads_reference(q, k, v, g, lse, delta, causal, scale):
    """The plain version of the two backward kernels: ``(dq, dk, dv)`` of
    one attention block given the per-row ``lse`` and ``delta`` [B, H, Tq]
    (external, e.g. global, residuals welcome), fp32 math.

    ``p = exp(s - lse)``, ``ds = p∘(dO·vᵀ - delta)``, ``dq = scale·ds·k``,
    ``dk = scale·dsᵀ·q``, ``dv = pᵀ·dO``. Masked entries get p = 0 and
    ds = 0 (``masked_fill`` passes no gradient); a causal row that sees no
    key (Tq > Tk) had a uniform softmax over all Tk keys, so its p is 1/Tk
    and its ds is 0."""
    b, h_kv, tk, d = k.shape
    tq = q.shape[2]
    grp = _gqa_group(q, k)
    kb, vb = _broadcast_kv(q, k, v)
    s = torch.matmul(q.float(), kb.float().transpose(-1, -2)) * scale
    p = torch.exp(s - lse[..., None].float())
    g32 = g.float()
    dp = torch.matmul(g32, vb.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None].float())
    if causal:
        visible = _causal_visible(tq, tk, q.device)
        no_key = (torch.arange(tq, device=q.device) + (tk - tq) < 0)[:, None]
        p = torch.where(visible, p, torch.where(no_key, 1.0 / tk, 0.0))
        ds = ds.masked_fill(~visible, 0.0)
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dq = torch.matmul(ds, kb.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dk, dv = _fold_dkv(dk, dv, b, h_kv, grp, tk, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ---------------------------------------------------------


def _check_kernel_inputs(q, k, v, what: str = "flash_forward",
                         lib: str = "flash_fwd") -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError("%s on %s, q on %s" % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError("%s is %s, q is %s" % (name, t.dtype, q.dtype))
    if q.dtype not in _DTYPE_CODES:
        raise TypeError("%s takes bfloat16 or float32, not %s" % (what, q.dtype))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, heads, T, D]")
    b, h, _, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(
            "%s takes head_dim in %s, not %d" % (what, _HEAD_DIMS, d)
        )
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            "k %s / v %s do not match q %s"
            % (tuple(k.shape), tuple(v.shape), tuple(q.shape))
        )
    _gqa_group(q, k)
    if k.shape[2] < 1:
        raise ValueError("%s needs at least one key" % what)
    if b * h > 65535:
        raise ValueError("B*H = %d exceeds the grid limit 65535" % (b * h))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(
                "%s needs unit stride on head_dim (strides %s)"
                % (name, t.stride())
            )
    _prepare_device(q.device.index, lib)


@functools.lru_cache(maxsize=None)
def _prepare_device(index, name: str) -> None:
    """Once per device and library: require Hopper and set the kernels'
    shared-memory attributes there (kept off the launch path)."""
    major, minor = torch.cuda.get_device_capability(index)
    if (major, minor) != (9, 0):
        raise RuntimeError(
            "the flash kernels are built for sm_90a (Hopper); %s is sm_%d%d"
            % (torch.cuda.get_device_name(index), major, minor)
        )
    with torch.cuda.device(index):
        err = getattr(_lib(name), "edl_%s_prepare" % name)()
    if err != 0:
        raise RuntimeError("%s prepare failed: CUDA error %d" % (name, err))


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The library of ``csrc/<name>.cu``, built at first use, with the
    argument types of its C entry points declared."""
    from edl_tpu_torch.ops import _build

    lib = _build.load(name)
    prepare = getattr(lib, "edl_%s_prepare" % name)
    prepare.argtypes = ()
    prepare.restype = ctypes.c_int
    if name == "flash_fwd":
        fns = [lib.edl_flash_fwd]
        # dtype, head_dim; q k v o lse; B H Hkv Tq Tk; strides of q k v o
        # (b, h, t each); causal scale stream
        argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 12
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
    else:
        fns = [lib.edl_flash_bwd_dq, lib.edl_flash_bwd_dkv]
        # dtype, head_dim; q k v dO lse2 delta out0 out1; B H Hkv Tq Tk;
        # strides (18, in an array); causal scale t_pad stream
        argtypes = (
            [ctypes.c_int, ctypes.c_int]
            + [ctypes.c_void_p] * 8
            + [ctypes.c_int] * 5
            + [ctypes.c_void_p]
            + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    for fn in fns:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def flash_forward(q, k, v, causal: bool = False, scale=None):
    """``(o [B, H, Tq, D], lse [B, H, Tq] fp32)``, with no autograd (the
    differentiable op is ``torch.ops.edl_tpu_torch.flash_fwd``).

    CPU tensors: the plain version. CUDA tensors: one launch of the flash
    kernel on the current stream (no synchronisation), or an exception —
    unsupported dtype (``TypeError``), head_dim or shape (``ValueError``).
    bf16 q, k and v views TMA cannot read go in as contiguous copies
    (:func:`_kernel_operand`). ``o`` is a [B, H, Tq, D]
    view of [B, Tq, H, D] memory: the layout the attention output
    projection reads without a copy."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference_with_lse(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError("flash_forward runs on cpu or cuda, not %s" % q.device)
    q, k, v = _fwd_inputs(q, k, v)
    b, h, tq, d = q.shape
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if tq == 0 or b * h == 0:
        return o, lse
    _launch_fwd(_lib("flash_fwd").edl_flash_fwd, q, k, v, o, lse, causal,
                scale)
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def _fwd_inputs(q, k, v):
    """Check the forward's inputs for the kernel: bf16 q, k and v views
    TMA cannot read become contiguous copies (:func:`_kernel_operand`);
    the fp32 body reads any view with unit stride on head_dim. Returns
    ``(q, k, v)``."""
    if q.dtype == torch.bfloat16:
        q, k, v = (_kernel_operand(t) for t in (q, k, v))
    _check_kernel_inputs(q, k, v)
    return q, k, v


def _launch_fwd(fn, q, k, v, o, lse, causal, scale) -> None:
    """One call of ``fn`` (an ``edl_flash_fwd`` of ``csrc/flash_fwd.cu``)
    on checked kernel operands, writing ``o`` and ``lse``; raises if the
    launch failed."""
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    strides = []
    for t in (q, k, v, o):
        strides.extend(t.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, h_kv, tq, tk,
            *strides, int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        raise RuntimeError("flash_fwd launch failed: CUDA error %d" % err)


def _tma_ready(t: torch.Tensor) -> bool:
    """The kernels can read ``t`` as it is: unit stride on the last axis,
    a 16-byte aligned base and 16-byte multiples as the other strides
    (TMA's rules; the stride of an axis of extent 1 is never used)."""
    esize = t.element_size()
    return (
        t.stride(-1) == 1
        and t.data_ptr() % 16 == 0
        and all(n == 1 or st * esize % 16 == 0
                for n, st in zip(t.shape[:-1], t.stride()[:-1]))
    )


def _kernel_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels can read it, else a contiguous copy
    of it (a copy, never the plain version). The model's [B, H, T, D]
    views of [B, T, H, D] memory go in as they are."""
    return t if _tma_ready(t) else t.clone(memory_format=torch.contiguous_format)


_LOG2E = 1.4426950408889634
_ROW_PAD = 128  # a multiple of every query tile, as the C interface asks


def _bwd_rows(lse, delta):
    """``(lse2, delta, t_pad)``: [B*H, t_pad] fp32 rows for the backward
    kernels, ``lse·log2(e)`` and ``delta`` padded with zeros to ``t_pad``,
    the next multiple of 128 at or above Tq (one tile copies them whole)."""
    b, h, tq = lse.shape
    t_pad = -(-tq // _ROW_PAD) * _ROW_PAD
    rows = torch.empty((2, b * h, t_pad), dtype=torch.float32,
                       device=lse.device)
    if t_pad > tq:
        rows[:, :, tq:].zero_()
    torch.mul(lse.reshape(b * h, tq).float(), _LOG2E, out=rows[0, :, :tq])
    rows[1, :, :tq].copy_(delta.reshape(b * h, tq))
    return rows[0], rows[1], t_pad


def _bwd_inputs(q, k, v, g, lse, delta, what):
    """Check the backward's inputs for the kernels: q, k, v and dO they
    cannot read as they are become contiguous copies
    (:func:`_kernel_operand`), and lse/delta [B, H, Tq] become the padded
    rows of :func:`_bwd_rows`. Returns ``(q, k, v, g, lse2, delta2,
    t_pad)``."""
    q, k, v = (_kernel_operand(t) for t in (q, k, v))
    _check_kernel_inputs(q, k, v, what, lib="flash_bwd")
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError(
            "dO %s %s does not match q %s %s"
            % (tuple(g.shape), g.dtype, tuple(q.shape), q.dtype)
        )
    g = _kernel_operand(g)
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != tuple(q.shape[:3]) or t.device != q.device:
            raise ValueError(
                "%s is %s on %s, want [B, H, Tq] %s on %s"
                % (name, tuple(t.shape), t.device, tuple(q.shape[:3]),
                   q.device)
            )
    return (q, k, v, g) + _bwd_rows(lse, delta)


def _launch_bwd(fn, name, ins, outs, causal, scale):
    q, k, v, g, lse2, delta2, t_pad = ins
    b, h, tq, d = q.shape
    h_kv, tk = k.shape[1], k.shape[2]
    strides = []
    for t in (q, k, v, g) + tuple(outs):
        strides.extend(t.stride()[:3])
    strides += [0] * (18 - len(strides))
    arr = (ctypes.c_longlong * 18)(*strides)
    ptrs = [t.data_ptr() for t in outs] + [None] * (2 - len(outs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), g.data_ptr(), lse2.data_ptr(), delta2.data_ptr(),
            ptrs[0], ptrs[1], b, h, h_kv, tq, tk, ctypes.addressof(arr),
            int(bool(causal)), float(scale), t_pad, stream,
        )
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, err))


def _run_dq(ins, causal, scale):
    q = ins[0]
    b, h, tq, d = q.shape
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    if tq == 0 or b * h == 0:
        return dq
    _launch_bwd(_lib("flash_bwd").edl_flash_bwd_dq, "flash_bwd_dq", ins,
                (dq,), causal, scale)
    flash_bwd_dq.launches += 1
    return dq


def _run_dkv(ins, causal, scale):
    q, k = ins[0], ins[1]
    b, h_kv, tk, d = k.shape
    shape = (b, tk, h_kv, d)
    dk = torch.empty(shape, dtype=k.dtype, device=k.device).transpose(1, 2)
    dv = torch.empty(shape, dtype=k.dtype, device=k.device).transpose(1, 2)
    if q.shape[2] == 0:
        return dk.zero_(), dv.zero_()
    _launch_bwd(_lib("flash_bwd").edl_flash_bwd_dkv, "flash_bwd_dkv", ins,
                (dk, dv), causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, causal: bool = False, scale=None):
    """``dq`` [B, H, Tq, D] of one attention block given ``dO`` (``g``)
    and the per-row ``lse``/``delta`` [B, H, Tq].

    CPU tensors: the plain version. CUDA tensors: one launch of the dq
    kernel (``csrc/flash_bwd.cu``) or an exception, as
    :func:`flash_forward`. ``dq`` is a [B, H, Tq, D] view of [B, Tq, H, D]
    memory (the layout the q projection's backward reads)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _block_grads_reference(q, k, v, g, lse, delta, causal, scale)[0]
    ins = _bwd_inputs(q, k, v, g, lse, delta, "flash_bwd_dq")
    return _run_dq(ins, causal, scale)


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, causal: bool = False, scale=None):
    """``(dk, dv)`` [B, Hkv, Tk, D] of one attention block, at the grouped
    width (the kernel walks a group's query heads inside one CTA, so the
    result equals the full-width result folded by :func:`_fold_dkv`).

    CPU tensors: the plain version. CUDA tensors: one launch of the dk/dv
    kernel (``csrc/flash_bwd.cu``) or an exception. ``dk``/``dv`` are
    [B, Hkv, Tk, D] views of [B, Tk, Hkv, D] memory."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _block_grads_reference(q, k, v, g, lse, delta, causal, scale)[1:]
    ins = _bwd_inputs(q, k, v, g, lse, delta, "flash_bwd_dkv")
    return _run_dkv(ins, causal, scale)


flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, g, lse, delta, causal: bool, scale: float):
    """``(dq, dk, dv)``: the dq kernel then the dk/dv kernel on CUDA
    tensors, sharing one preparation of their inputs (their plain version,
    once, on CPU tensors). ``lse``/``delta`` are [B, H, Tq] fp32."""
    if q.device.type == "cpu":
        return _block_grads_reference(q, k, v, g, lse, delta, causal, scale)
    ins = _bwd_inputs(q, k, v, g, lse, delta, "flash_backward")
    dq = _run_dq(ins, causal, scale)
    dk, dv = _run_dkv(ins, causal, scale)
    return dq, dk, dv


# -- the differentiable op ---------------------------------------------------


@torch.library.custom_op("edl_tpu_torch::flash_fwd", mutates_args=())
def _flash_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
              scale: float) -> Tuple[Tensor, Tensor]:
    return flash_forward(q, k, v, causal=causal, scale=scale)


def _flash_setup(ctx, inputs, output) -> None:
    q, k, v, causal, scale = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.scale = causal, scale


def _flash_op_backward(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    # d lse / d s = p, so the lse cotangent (zeros when lse is unused) adds
    # p∘dlse to ds: the same kernels with delta - dlse
    delta = _bwd_delta(do, o) - dlse.float()
    dq, dk, dv = flash_backward(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_op_backward, setup_context=_flash_setup)


def flash_with_lse(q, k, v, causal: bool = False, scale=None,
                   block_q=None, block_k=None):
    """``(o, lse)`` with ``lse`` as [B, H, Tq] fp32 — the primitive
    blockwise/ring merging builds on; both are differentiable.
    ``block_q``/``block_k`` keep the JAX signature; the CUDA kernels pick
    their own tiles (64 query rows by 64 keys, as measured fastest on the
    H100)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _flash_op(q, k, v, bool(causal), float(scale))


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None):
    """Flash attention output through the differentiable op (see
    :func:`flash_with_lse`)."""
    return flash_with_lse(q, k, v, causal=causal, scale=scale)[0]


def flash_block_grads(q, k, v, g, lse, delta, causal: bool = False,
                      scale=None, block_q=None, block_k=None):
    """``(dq, dk, dv)`` for one attention block given external residuals:
    per-row ``lse`` and row correction ``delta`` [B, H, Tq], e.g. over the
    GLOBAL softmax — the ring backward's building block. CUDA tensors:
    the two backward kernels; CPU tensors: their plain version."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return flash_backward(q, k, v, g, lse, delta, causal, scale)


def attention(q, k, v, causal: bool = False, scale=None):
    """The default entry point for every model: on CPU tensors exactly the
    dense reference (native autodiff), on CUDA tensors the flash op."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    return flash_attention(q, k, v, causal=causal, scale=scale)
