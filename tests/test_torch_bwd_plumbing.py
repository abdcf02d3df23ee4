"""What surrounds the backward kernels, on the CPU: the operand helper that
decides which q/k/v/dO views the TMA kernels read as they are, the padded
lse/delta rows they load, and ``chip_smoke.py``'s count of visible pairs
and its bounds (the yardstick that ranks the kernels).

Exact comparisons throughout: the helpers copy or count, they round
nothing. The bounds are checked to 1e-12 relative (float sums of integers).
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from edl_tpu_torch.ops.attention import (
    _bwd_rows,
    _causal_visible,
    _kernel_operand,
    _tma_ready,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _bthd_view(b, h, t, d, dtype):
    """[B, H, T, D] view of [B, T, H, D] memory: the model's layout."""
    return _values((b, t, h, d), dtype).transpose(1, 2)


def _offset_view(shape, dtype, elems):
    """A contiguous tensor whose first element sits `elems` past an
    allocation's start."""
    flat = _values((math.prod(shape) + elems,), dtype)
    return flat[elems:].view(shape)


def _strided(shape, strides, dtype):
    """A view with the given element strides over a fresh allocation."""
    size = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return _values((size,), dtype).as_strided(shape, strides)


def _odd_rows(b, h, t, d, dtype):
    """Rows 2·(D+1) bytes apart: no 16-byte multiple."""
    wide = _values((b, h, t, d + 1), dtype)
    return wide[..., 1:]


LEGAL = [
    pytest.param(lambda: _values((2, 4, 96, 64), torch.bfloat16), id="contiguous"),
    pytest.param(lambda: _bthd_view(2, 4, 96, 64, torch.bfloat16), id="bthd-view"),
    pytest.param(lambda: _bthd_view(1, 16, 33, 128, torch.bfloat16), id="bthd-d128"),
    pytest.param(lambda: _values((2, 4, 96, 96), torch.bfloat16)[..., :64],
                 id="head-dim-slice"),
    pytest.param(lambda: _offset_view((2, 4, 8, 32), torch.bfloat16, 8),
                 id="offset-16-bytes"),
    pytest.param(lambda: _values((2, 4, 33, 64), torch.bfloat16)[:, 1:2],
                 id="one-head-slice"),
    pytest.param(lambda: _strided((2, 1, 8, 64), (8 * 64, 3, 64, 1),
                                  torch.bfloat16), id="extent-1-odd-stride"),
    pytest.param(lambda: _values((2, 2, 40, 32), torch.float32), id="fp32"),
]

COPIED = [
    pytest.param(lambda: _values((2, 4, 64, 96), torch.bfloat16)
                 .transpose(2, 3)[..., :64, :], id="head-dim-strided"),
    pytest.param(lambda: _offset_view((2, 4, 8, 64), torch.bfloat16, 1),
                 id="offset-2-bytes"),
    pytest.param(lambda: _odd_rows(2, 4, 24, 64, torch.bfloat16), id="odd-row-stride"),
    pytest.param(lambda: _odd_rows(1, 1, 5, 32, torch.bfloat16), id="odd-row-stride-d32"),
    pytest.param(lambda: _strided((2, 4, 16, 64), (4 * 16 * 64 + 4, 16 * 64, 64, 1),
                                  torch.bfloat16), id="odd-batch-stride"),
]


@pytest.mark.parametrize("make", LEGAL)
def test_legal_views_go_in_as_they_are(make):
    t = make()
    assert _tma_ready(t)
    assert _kernel_operand(t) is t


@pytest.mark.parametrize("make", COPIED)
def test_illegal_views_become_contiguous_copies(make):
    t = make()
    assert not _tma_ready(t)
    got = _kernel_operand(t)
    assert got.data_ptr() != t.data_ptr()
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert _tma_ready(got)
    assert got.dtype == t.dtype and got.shape == t.shape
    assert torch.equal(got, t)


@pytest.mark.parametrize("tq", [1, 63, 64, 127, 128, 129, 300])
def test_bwd_rows_are_scaled_padded_and_exact(tq):
    b, h = 2, 3
    lse = _values((b, h, tq), torch.float32, seed=1)
    delta = _values((b, h, tq), torch.float32, seed=2)
    lse2, delta2, t_pad = _bwd_rows(lse, delta)
    assert t_pad % 128 == 0 and tq <= t_pad < tq + 128
    assert lse2.shape == delta2.shape == (b * h, t_pad)
    assert lse2.dtype == delta2.dtype == torch.float32
    want = lse.reshape(b * h, tq) * 1.4426950408889634
    assert torch.equal(lse2[:, :tq], want)
    assert torch.equal(delta2[:, :tq], delta.reshape(b * h, tq))
    assert not lse2[:, tq:].any() and not delta2[:, tq:].any()
    # one 1-D copy of a 64-row tile starts on a 16-byte boundary
    assert lse2.data_ptr() % 16 == 0 and delta2.data_ptr() % 16 == 0
    assert lse2.stride(0) * 4 % 16 == 0


def _small(case):
    """A small analogue of a KERNEL_CASES entry: sequence lengths / 16,
    the rest as it is."""
    (b, h, h_kv, tq, tk, d), causal, dtype = case
    return (b, h, h_kv, max(1, tq // 16), max(1, tk // 16), d), causal, dtype


def _brute(case):
    (b, h, h_kv, tq, tk, d), causal, _dtype = case
    if causal:
        vis = _causal_visible(tq, tk, "cpu")
    else:
        vis = torch.ones(tq, tk, dtype=torch.bool)
    pairs = int(vis.sum())
    no_key = int((~vis.any(dim=1)).sum())
    return pairs, no_key


CHIP = _chip_smoke()
SMALL_CASES = [pytest.param(_small(c), id="case%d" % i)
               for i, c in enumerate(CHIP.KERNEL_CASES)]


def test_small_cases_keep_every_mask_kind():
    kinds = {(c.values[0][1], (c.values[0][0][3] > c.values[0][0][4])
              - (c.values[0][0][3] < c.values[0][0][4])) for c in SMALL_CASES}
    assert {(True, 0), (False, 0), (True, -1), (True, 1)} <= kinds


@pytest.mark.parametrize("case", SMALL_CASES)
def test_visible_pairs_match_brute_force(case):
    assert CHIP._visible(case) == _brute(case)


@pytest.mark.parametrize("case", SMALL_CASES)
def test_bwd_bounds_match_brute_force(case):
    (b, h, h_kv, tq, tk, d), causal, dtype = case
    pairs, no_key = _brute(case)
    esize = 2 if dtype == "bfloat16" else 4
    q_bytes = esize * b * h * tq * d        # q, dO and dq each
    kv_bytes = esize * b * h_kv * tk * d    # k, v, dk, dv each
    rows = 4 * b * h * tq                   # lse, delta each
    reads = 2 * q_bytes + 2 * kv_bytes + 2 * rows
    dv_no_key = 2.0 * d * tk * no_key * b * h
    want = {
        "dq": (6.0 * d * pairs * b * h, reads + q_bytes),
        "dkv": (8.0 * d * pairs * b * h + dv_no_key, reads + 2 * kv_bytes),
        "fused": (10.0 * d * pairs * b * h + dv_no_key,
                  reads + q_bytes + 2 * kv_bytes),
    }
    got = CHIP._bwd_bounds(case)
    assert set(got) == set(want)
    for name, (ops, nbytes) in want.items():
        rec = got[name]
        assert rec["ops"] == pytest.approx(ops, rel=1e-12)
        assert rec["bytes"] == nbytes
        t_ops = ops / CHIP.PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / CHIP.HBM_BYTES_PER_S * 1e3
        assert rec["bound_ms"] == pytest.approx(max(t_ops, t_bytes), rel=1e-12)
        assert rec["bound_by"] == ("operations" if t_ops >= t_bytes else "bytes")
