"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card (``pytest -m gpu tests/test_torch_kernels.py`` on the
machine with the H100); here they skip. Whether a card is present is
decided in the ``cuda`` fixture, never at import or collection, so every
test worker collects the same tests.

Tolerances (same inputs, kernel vs plain, on the card): bf16 o 2e-2 (the
two round the output at different points; one bf16 ulp on [2, 4) is
1.6e-2), fp32 o 1e-4, lse 1e-3 (fp32 summation order).
"""

import pytest
import torch

from edl_tpu_torch.ops.attention import (
    attention,
    attention_reference_with_lse,
    flash_forward,
)

pytestmark = pytest.mark.gpu

TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3

# (B, H, Hkv, Tq, Tk, D), causal, dtype
CASES = [
    pytest.param((2, 4, 4, 256, 256, 64), True, torch.bfloat16, id="mha-causal"),
    pytest.param((2, 8, 2, 200, 200, 128), True, torch.bfloat16, id="gqa4-ragged"),
    pytest.param((2, 4, 4, 300, 300, 64), False, torch.bfloat16, id="non-causal"),
    pytest.param((1, 4, 4, 100, 400, 64), True, torch.bfloat16, id="tq<tk"),
    pytest.param((1, 4, 4, 150, 70, 64), True, torch.bfloat16, id="tq>tk"),
    pytest.param((2, 4, 4, 96, 96, 32), True, torch.bfloat16, id="bf16-d32"),
    pytest.param((2, 4, 4, 64, 64, 32), True, torch.float32, id="fp32-d32"),
    pytest.param((2, 4, 2, 90, 130, 128), False, torch.float32, id="fp32-d128"),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed=0):
    b, h, h_kv, tq, tk, d = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device=device, generator=gen).to(dtype)
    return mk(b, h, tq, d), mk(b, h_kv, tk, d), mk(b, h_kv, tk, d)


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_flash_forward_matches_plain(cuda, shape, causal, dtype):
    q, k, v = _inputs(shape, dtype, cuda)
    before = flash_forward.launches
    o, lse = flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    ro, rlse = attention_reference_with_lse(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert (o.float() - ro.float()).abs().max().item() <= TOL_O[dtype]
    assert (lse - rlse).abs().max().item() <= TOL_LSE


def test_strided_inputs_match_contiguous(cuda):
    """The model hands the kernel [B, H, T, D] views of [B, T, H, D]."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _inputs((2, 4, 4, 128, 128, 64), torch.bfloat16, cuda))
    assert not q.is_contiguous()
    o, lse = flash_forward(q, k, v, causal=True)
    o2, lse2 = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_unaligned_rows_match_aligned(cuda):
    """Rows that do not start on a 16-byte boundary take the scalar loads."""
    q, k, v = _inputs((2, 4, 4, 130, 130, 64), torch.bfloat16, cuda)
    q_odd, k_odd, v_odd = (
        torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in (q, k, v)
    )
    assert q_odd.stride(2) % 8 != 0 and torch.equal(q_odd, q)
    o, lse = flash_forward(q_odd, k_odd, v_odd, causal=True)
    o2, lse2 = flash_forward(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_attention_on_cuda_runs_the_kernel(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.bfloat16, cuda)
    before = flash_forward.launches
    attention(q, k, v, causal=True)
    assert flash_forward.launches == before + 1


def test_unsupported_inputs_raise(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.float16, cuda)
    with pytest.raises(TypeError):
        flash_forward(q, k, v)
    q, k, v = _inputs((1, 2, 2, 64, 64, 48), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_forward(q, k, v)
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.bfloat16, cuda)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_forward(q, k, v)
