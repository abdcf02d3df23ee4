"""What surrounds the forward kernel, on the CPU: which q/k/v views the
kernel reads as they are and which it gets as contiguous copies, the
plain version the wrapper runs on CPU tensors, and ``chip_smoke.py``'s
bound of the forward (the yardstick its ``bound_share`` divides).

Exact comparisons throughout: the helpers copy or count, they round
nothing. The bounds are checked to 1e-12 relative (float sums of
integers).
"""

import importlib
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from edl_tpu_torch.ops.attention import (
    _causal_visible,
    _fwd_inputs,
    attention_reference_with_lse,
    flash_forward,
)

# the module (the package re-exports its ``attention`` function by name)
attn = importlib.import_module("edl_tpu_torch.ops.attention")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, HKV, T, D = 2, 4, 2, 24, 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(shape, dtype=torch.bfloat16, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _contiguous(heads):
    return _values((B, heads, T, D))


def _bthd_view(heads):
    """[B, H, T, D] view of [B, T, H, D] memory: the model's layout."""
    return _values((B, T, heads, D)).transpose(1, 2)


def _head_dim_slice(heads):
    return _values((B, heads, T, D + 32))[..., :D]


def _offset(heads, elems):
    shape = (B, heads, T, D)
    return _values((math.prod(shape) + elems,))[elems:].view(shape)


def _odd_rows(heads):
    """Rows 2·(D+1) bytes apart: no 16-byte multiple."""
    return _values((B, heads, T, D + 1))[..., 1:]


def _head_dim_strided(heads):
    return _values((B, heads, D, T)).transpose(2, 3)


def _odd_batch_stride(heads):
    shape = (B, heads, T, D)
    strides = (heads * T * D + 4, T * D, D, 1)
    size = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return _values((size,)).as_strided(shape, strides)


AS_THEY_ARE = [
    pytest.param(_contiguous, id="contiguous"),
    pytest.param(_bthd_view, id="bthd-view"),
    pytest.param(_head_dim_slice, id="head-dim-slice"),
    pytest.param(lambda heads: _offset(heads, 8), id="offset-16-bytes"),
]
COPIED = [
    pytest.param(lambda heads: _offset(heads, 1), id="offset-2-bytes"),
    pytest.param(_odd_rows, id="odd-row-stride"),
    pytest.param(_head_dim_strided, id="head-dim-strided"),
    pytest.param(_odd_batch_stride, id="odd-batch-stride"),
]


@pytest.fixture
def no_device_prep(monkeypatch):
    """The input checks without the per-device preparation (which needs
    the card and the built library)."""
    monkeypatch.setattr(attn, "_prepare_device", lambda index, name: None)


@pytest.mark.parametrize("make", AS_THEY_ARE)
def test_readable_views_reach_the_kernel_as_they_are(no_device_prep, make):
    q, k, v = make(H), make(HKV), make(HKV)
    got = _fwd_inputs(q, k, v)
    for a, given in zip(got, (q, k, v)):
        assert a is given


@pytest.mark.parametrize("make", COPIED)
@pytest.mark.parametrize("which", [0, 1, 2], ids=["q", "k", "v"])
def test_unreadable_views_are_copied_and_only_they(no_device_prep, make,
                                                   which):
    given = [_bthd_view(H), _bthd_view(HKV), _bthd_view(HKV)]
    given[which] = make(H if which == 0 else HKV)
    got = _fwd_inputs(*given)
    for i, (a, t) in enumerate(zip(got, given)):
        if i != which:
            assert a is t
            continue
        assert a.data_ptr() != t.data_ptr()
        assert a.is_contiguous() and a.data_ptr() % 16 == 0
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.equal(a, t)


def test_fp32_operands_follow_the_same_rule(no_device_prep):
    """The fp32 body loads scalars, not TMA boxes: its rule is unit stride
    on head_dim alone, so unaligned fp32 views go in as they are."""
    q = _values((B, H, T, 32), torch.float32)
    k = _values((B, HKV, T, 33), torch.float32)[..., 1:]  # 4-byte offset
    v = _values((B, HKV, T, 33), torch.float32)[..., :32]  # odd row stride
    got = _fwd_inputs(q, k, v)
    for a, given in zip(got, (q, k, v)):
        assert a is given


def test_fp32_head_dim_strided_is_refused(no_device_prep):
    q = _values((B, H, T, 32), torch.float32)
    k = _values((B, HKV, 32, T), torch.float32).transpose(2, 3)
    v = _values((B, HKV, T, 32), torch.float32)
    with pytest.raises(ValueError, match="unit stride on head_dim"):
        _fwd_inputs(q, k, v)


@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 4, 4, 24, 24, 64), True, torch.bfloat16),
    ((2, 4, 2, 20, 36, 32), True, torch.bfloat16),
    ((1, 4, 4, 40, 16, 64), True, torch.bfloat16),
    ((2, 4, 1, 24, 30, 128), False, torch.bfloat16),
    ((2, 2, 2, 17, 17, 32), True, torch.float32),
], ids=["mha-causal", "gqa-tq<tk", "tq>tk-no-key-rows", "mqa-noncausal",
        "fp32"])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_flash_forward_on_cpu_is_the_plain_version(shape, causal, dtype,
                                                   scale):
    b, h, h_kv, tq, tk, d = shape
    q = _values((b, h, tq, d), dtype, seed=1)
    k = _values((b, h_kv, tk, d), dtype, seed=2)
    v = _values((b, h_kv, tk, d), dtype, seed=3)
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, causal=causal, scale=scale)
    want_o, want_lse = attention_reference_with_lse(q, k, v, causal=causal,
                                                    scale=scale)
    assert flash_forward.launches == before  # the plain version launches nothing
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


CHIP = _chip_smoke()


def _small(case):
    """A small analogue of a KERNEL_CASES entry: sequence lengths / 16."""
    (b, h, h_kv, tq, tk, d), causal, dtype = case
    return (b, h, h_kv, max(1, tq // 16), max(1, tk // 16), d), causal, dtype


SMALL_CASES = [pytest.param(_small(c), id="case%d" % i)
               for i, c in enumerate(CHIP.KERNEL_CASES)]


@pytest.mark.parametrize("case", SMALL_CASES + [
    pytest.param(((1, 2, 2, 200, 70, 64), True, "bfloat16"), id="no-key-rows"),
    pytest.param(((1, 2, 1, 65, 129, 128), False, "bfloat16"), id="ragged"),
])
def test_fwd_bound_matches_the_visible_pairs(case):
    """4·D per visible (query, key) pair from ``_causal_visible``; a row
    that sees no key averages v over all Tk keys (2·D per key); bytes: q,
    k, v read and o written once, lse in fp32."""
    (b, h, h_kv, tq, tk, d), causal, dtype = case
    vis = (_causal_visible(tq, tk, "cpu") if causal
           else torch.ones(tq, tk, dtype=torch.bool))
    pairs = int(vis.sum())
    no_key = int((~vis.any(dim=1)).sum())
    ops = 4.0 * d * b * h * pairs + 2.0 * d * b * h * tk * no_key
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * d * (2 * b * h * tq + 2 * b * h_kv * tk) + 4 * b * h * tq
    got = CHIP._bound(case)
    assert got["ops"] == pytest.approx(ops, rel=1e-12)
    assert got["bytes"] == nbytes
    t_ops = ops / CHIP.PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / CHIP.HBM_BYTES_PER_S * 1e3
    assert got["bound_ms"] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
    assert got["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
