"""The hand-written CUDA kernels against their plain PyTorch versions.

These need the card (``pytest -m gpu tests/test_torch_kernels.py`` on the
machine with the H100); here they skip. Whether a card is present is
decided in the ``cuda`` fixture, never at import or collection, so every
test worker collects the same tests.

Tolerances (same inputs, kernel vs plain, on the card): forward bf16 o
2e-2 (the two round the output at different points; one bf16 ulp on
[2, 4) is 1.6e-2), fp32 o 1e-4, lse 1e-3 (fp32 summation order).
Backward dq/dk/dv: bf16 2e-2 * max(1, max|ref|) (the kernels round p and
ds to bf16 before their products and the output to bf16, the plain
version keeps fp32), fp32 1e-4 * max(1, max|ref|) (summation order).
"""

import pytest
import torch

from edl_tpu_torch.ops.attention import _bwd_inputs as _kernel_inputs
from edl_tpu_torch.ops.attention import (
    _block_grads_reference,
    _bwd_delta,
    _fwd_inputs,
    _kernel_operand,
    attention,
    attention_reference_with_lse,
    flash_attention,
    flash_backward,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_forward,
)

pytestmark = pytest.mark.gpu

TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3
TOL_GRAD = {torch.bfloat16: 2e-2, torch.float32: 1e-4}

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

# the backward kernels' tiles are 64 rows (K2: query rows, K3: keys) and
# 64-row ring tiles, with lse/delta rows padded to 128: one below and one
# above each edge, rows that see no key in a partial tile, GQA g 4 at the
# smallest and largest head_dim
BWD_EDGE_CASES = [
    pytest.param((1, 2, 2, 63, 63, 64), True, id="t63"),
    pytest.param((1, 2, 2, 65, 65, 64), True, id="t65"),
    pytest.param((1, 2, 2, 127, 127, 64), True, id="t127"),
    pytest.param((1, 2, 2, 129, 129, 64), True, id="t129"),
    pytest.param((1, 2, 2, 129, 127, 64), False, id="t129x127-noncausal"),
    pytest.param((1, 4, 4, 200, 70, 64), True, id="tq>tk-partial-nokey-tile"),
    pytest.param((2, 8, 2, 161, 161, 32), True, id="gqa4-d32"),
    pytest.param((2, 8, 2, 191, 191, 128), True, id="gqa4-d128"),
]


# the forward's tiles are 64 query rows by 64 keys: one below and one
# above each edge (and the second edge, 128) in Tq and Tk, rows that see
# no key in a partial tile, GQA g 4 at the smallest and largest head_dim,
# ragged non-causal Tq != Tk
FWD_EDGE_CASES = [
    pytest.param((1, 2, 2, 63, 63, 64), True, id="t63"),
    pytest.param((1, 2, 2, 65, 65, 64), True, id="t65"),
    pytest.param((1, 2, 2, 127, 127, 64), True, id="t127"),
    pytest.param((1, 2, 2, 129, 129, 64), True, id="t129"),
    pytest.param((1, 2, 2, 255, 257, 64), True, id="t255x257"),
    pytest.param((1, 2, 2, 65, 63, 128), True, id="t65x63-d128"),
    pytest.param((1, 2, 2, 129, 127, 64), False, id="t129x127-noncausal"),
    pytest.param((1, 2, 2, 63, 129, 32), False, id="t63x129-noncausal-d32"),
    pytest.param((1, 4, 4, 200, 70, 64), True, id="tq>tk-partial-nokey-tile"),
    pytest.param((1, 4, 4, 300, 129, 128), True, id="tq>tk-d128"),
    pytest.param((2, 8, 2, 161, 161, 32), True, id="gqa4-d32"),
    pytest.param((2, 8, 2, 191, 191, 128), True, id="gqa4-d128"),
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


def _bwd_inputs(shape, causal, dtype, device, seed=0):
    """q, k, v, dO and the forward's lse and delta (from the plain forward,
    so that kernel and plain version see the same residuals)."""
    q, k, v = _inputs(shape, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 100)
    g = torch.randn(q.shape, device=device, generator=gen).to(dtype)
    o, lse = attention_reference_with_lse(q, k, v, causal=causal)
    return q, k, v, g, lse, _bwd_delta(g, o)


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


@pytest.mark.parametrize("shape,causal", FWD_EDGE_CASES)
def test_forward_tile_edges_match_plain(cuda, shape, causal):
    q, k, v = _inputs(shape, torch.bfloat16, cuda, seed=7)
    o, lse = flash_forward(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ro, rlse = attention_reference_with_lse(q, k, v, causal=causal)
    assert bool(torch.isfinite(o).all())
    assert (o.float() - ro.float()).abs().max().item() <= TOL_O[torch.bfloat16]
    assert (lse - rlse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("scale", [-0.125, 0.0])
def test_forward_any_scale_matches_plain(cuda, scale):
    """The interior tiles take the row max of the raw scores and scale it
    once: a negative scale turns that into the row min, a zero scale gives
    a uniform softmax."""
    q, k, v = _inputs((1, 4, 2, 200, 200, 64), torch.bfloat16, cuda, seed=9)
    for causal in (True, False):
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        ro, rlse = attention_reference_with_lse(q, k, v, causal=causal,
                                                scale=scale)
        assert (o.float() - ro.float()).abs().max().item() <= TOL_O[torch.bfloat16]
        assert (lse - rlse).abs().max().item() <= TOL_LSE


@pytest.mark.parametrize("d", [64, 128])
def test_forward_repeats_bit_for_bit(cuda, d):
    """No atomics: two runs on the same inputs give the same bits (causal
    GQA g 4)."""
    q, k, v = _inputs((2, 8, 2, 320, 320, d), torch.bfloat16, cuda, seed=5)
    first = flash_forward(q, k, v, causal=True)
    for _ in range(3):
        again = flash_forward(q, k, v, causal=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("shape,causal,dtype", CASES)
def test_flash_backward_matches_plain(cuda, shape, causal, dtype):
    q, k, v, g, lse, delta = _bwd_inputs(shape, causal, dtype, cuda)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_backward(q, k, v, g, lse, delta, causal, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = _block_grads_reference(
        q, k, v, g, lse, delta, causal, q.shape[-1] ** -0.5)
    for name, a, ref, like in zip("q k v".split(), got, want, (q, k, v)):
        assert a.dtype == dtype and a.shape == like.shape, name
        assert bool(torch.isfinite(a).all()), name
        err = (a.float() - ref.float()).abs().max().item()
        limit = TOL_GRAD[dtype] * max(1.0, ref.float().abs().max().item())
        assert err <= limit, "d%s: %.3g > %.3g" % (name, err, limit)


@pytest.mark.parametrize("shape,causal", BWD_EDGE_CASES)
def test_backward_tile_edges_match_plain(cuda, shape, causal):
    q, k, v, g, lse, delta = _bwd_inputs(shape, causal, torch.bfloat16, cuda)
    got = flash_backward(q, k, v, g, lse, delta, causal, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    want = _block_grads_reference(
        q, k, v, g, lse, delta, causal, q.shape[-1] ** -0.5)
    for name, a, ref in zip("q k v".split(), got, want):
        assert bool(torch.isfinite(a).all()), name
        err = (a.float() - ref.float()).abs().max().item()
        limit = TOL_GRAD[torch.bfloat16] * max(1.0, ref.float().abs().max().item())
        assert err <= limit, "d%s: %.3g > %.3g" % (name, err, limit)


def test_backward_writes_the_projection_layout(cuda):
    """dq/dk/dv are [B, H, T, D] views of [B, T, H, D] memory, as o is."""
    q, k, v, g, lse, delta = _bwd_inputs(
        (1, 4, 2, 64, 64, 64), True, torch.bfloat16, cuda)
    dq = flash_bwd_dq(q, k, v, g, lse, delta, causal=True)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal=True)
    for t in (dq, dk, dv):
        assert t.transpose(1, 2).is_contiguous()


def test_strided_inputs_match_contiguous(cuda):
    """The model hands the kernels [B, H, T, D] views of [B, T, H, D]."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _inputs((2, 4, 4, 128, 128, 64), torch.bfloat16, cuda))
    assert not q.is_contiguous()
    o, lse = flash_forward(q, k, v, causal=True)
    o2, lse2 = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                             causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g = torch.randn_like(o)
    delta = _bwd_delta(g, o)
    got = flash_backward(q, k, v, g, lse, delta, True, 0.125)
    want = flash_backward(q.contiguous(), k.contiguous(), v.contiguous(),
                          g.contiguous(), lse, delta, True, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # dO without unit stride on head_dim is copied, not refused
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert g_t.stride(3) != 1
    for a, b in zip(flash_backward(q, k, v, g_t, lse, delta, True, 0.125), want):
        assert torch.equal(a, b)


def test_unaligned_rows_match_aligned(cuda):
    """Rows that do not start on a 16-byte boundary (an odd row stride and
    an unaligned base, which TMA cannot read) go through a contiguous copy
    in the forward and the backward, and give the aligned result."""
    q, k, v = _inputs((2, 4, 4, 130, 130, 64), torch.bfloat16, cuda)
    q_odd, k_odd, v_odd = (
        torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in (q, k, v)
    )
    assert q_odd.stride(2) % 8 != 0 and torch.equal(q_odd, q)
    assert _fwd_inputs(q_odd, k_odd, v_odd)[0].data_ptr() != q_odd.data_ptr()
    o, lse = flash_forward(q_odd, k_odd, v_odd, causal=True)
    o2, lse2 = flash_forward(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g = torch.randn_like(o)
    delta = _bwd_delta(g, o)
    got = flash_backward(q_odd, k_odd, v_odd, g, lse, delta, True, 0.125)
    want = flash_backward(q, k, v, g, lse, delta, True, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_fp32_unaligned_views_go_in_as_they_are(cuda):
    """The fp32 forward body loads scalars: views off a 16-byte boundary
    reach it without a copy and give the contiguous result."""
    q, k, v = _inputs((2, 4, 4, 70, 70, 32), torch.float32, cuda)
    q_odd, k_odd, v_odd = (
        torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in (q, k, v)
    )
    for got, given in zip(_fwd_inputs(q_odd, k_odd, v_odd),
                          (q_odd, k_odd, v_odd)):
        assert got.data_ptr() == given.data_ptr()
    o, lse = flash_forward(q_odd, k_odd, v_odd, causal=True)
    o2, lse2 = flash_forward(q, k, v, causal=True)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64), (torch.float32, 64),
                                     (torch.bfloat16, 128)])
def test_backward_repeats_bit_for_bit(cuda, dtype, d):
    """No atomics: two runs on the same inputs give the same bits (causal
    GQA g 4, at head_dim 64 and 128)."""
    q, k, v, g, lse, delta = _bwd_inputs(
        (2, 8, 2, 320, 320, d), True, dtype, cuda, seed=5)
    first = flash_backward(q, k, v, g, lse, delta, True, d ** -0.5)
    for _ in range(3):
        again = flash_backward(q, k, v, g, lse, delta, True, d ** -0.5)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_aligned_views_go_in_without_a_copy(cuda):
    """The model's [B, H, T, D] views of [B, T, H, D] memory meet TMA's
    rules and reach the kernels (forward and backward) as they are; a view
    whose rows start off a 16-byte boundary goes through a contiguous copy
    and gives the same gradients."""
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _inputs((2, 4, 4, 192, 192, 64), torch.bfloat16, cuda))
    for got, given in zip(_fwd_inputs(q, k, v), (q, k, v)):
        assert got.data_ptr() == given.data_ptr()
    o, lse = flash_forward(q, k, v, causal=True)
    g = torch.randn_like(o)
    delta = _bwd_delta(g, o)
    ins = _kernel_inputs(q, k, v, g, lse, delta, "test")
    for got, given in zip(ins[:4], (q, k, v, g)):
        assert got.data_ptr() == given.data_ptr()
    want = flash_backward(q, k, v, g, lse, delta, True, 0.125)
    q_odd, k_odd = (torch.cat([t[..., :1], t], dim=-1)[..., 1:] for t in (q, k))
    assert q_odd.data_ptr() % 16 != 0 and torch.equal(q_odd, q)
    assert _kernel_operand(q_odd).data_ptr() != q_odd.data_ptr()
    got = flash_backward(q_odd, k_odd, v, g, lse, delta, True, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_attention_on_cuda_runs_the_kernel(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.bfloat16, cuda)
    before = flash_forward.launches
    attention(q, k, v, causal=True)
    assert flash_forward.launches == before + 1


def test_gradient_runs_each_backward_kernel_once(cuda):
    q, k, v = (t.requires_grad_(True) for t in
               _inputs((1, 2, 2, 64, 64, 64), torch.bfloat16, cuda))
    before = (flash_forward.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    out = flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    after = (flash_forward.launches, flash_bwd_dq.launches,
             flash_bwd_dkv.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    assert all(t.grad is not None and t.grad.shape == t.shape
               for t in (q, k, v))


def test_unsupported_inputs_raise(cuda):
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.float16, cuda)
    with pytest.raises(TypeError):
        flash_forward(q, k, v)
    g = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3], device=cuda)
    with pytest.raises(TypeError):
        flash_bwd_dq(q, k, v, g, lse, lse)
    q, k, v = _inputs((1, 2, 2, 64, 64, 64), torch.bfloat16, cuda)
    g = torch.zeros_like(q)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd_dkv(q, k, v, g, lse[..., :32], lse)
    q, k, v = _inputs((1, 2, 2, 64, 64, 48), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_forward(q, k, v)


def test_lm_head_gradient_on_cuda(cuda):
    """The LM head's CUDA product (bf16 operands, fp32 sums and logits) and
    its backward (bf16 operands, fp32 sums) against fp32 autograd of the
    same bf16 values; 2e-2 of max(1, max|ref|) for the bf16 gradients."""
    from edl_tpu_torch.models.transformer import LMHead

    gen = torch.Generator(device=cuda).manual_seed(3)
    head = LMHead(64, 1000, torch.float32, device=cuda)
    with torch.no_grad():
        head.kernel.normal_(0.0, 0.125, generator=gen)
    x = torch.randn(2, 48, 64, device=cuda, generator=gen).to(torch.bfloat16)
    x.requires_grad_(True)
    w = torch.randn(2, 48, 1000, device=cuda, generator=gen)
    logits = head(x)
    assert logits.dtype == torch.float32
    (logits * w).sum().backward()
    x32 = x.detach().float().requires_grad_(True)
    k32 = head.kernel.detach().to(torch.bfloat16).float().requires_grad_(True)
    ref = x32 @ k32
    (ref * w).sum().backward()
    assert (logits - ref).abs().max().item() <= 1e-3
    for got, want in ((x.grad, x32.grad), (head.kernel.grad, k32.grad)):
        limit = 2e-2 * max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= limit


@pytest.mark.parametrize("remat", ["save_flash", "full"])
def test_small_model_gradients_match_cpu(cuda, remat):
    """A small fp32 TransformerLM (head_dim 32): loss and every parameter's
    gradient on the card (the flash op: forward and backward kernels,
    under remat) against the same weights on the CPU (the dense reference
    with native autodiff); 1e-4 of max(1, max|ref|) (summation order)."""
    from edl_tpu_torch.models.transformer import TransformerLM

    cfg = dict(vocab_size=256, d_model=128, num_heads=4, num_layers=2,
               d_ff=256, dtype=torch.float32, remat=True, remat_policy=remat)
    cpu = TransformerLM(device="cpu", **cfg).init_weights(
        torch.Generator().manual_seed(0))
    gpu = TransformerLM(device=cuda, **cfg)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, 256, (2, 97), generator=torch.Generator()
                           .manual_seed(1))
    losses = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        x, y = tokens[:, :-1].to(dev), tokens[:, 1:].to(dev)
        logits = model(x)
        loss = torch.nn.functional.cross_entropy(
            logits.reshape(-1, 256), y.reshape(-1))
        loss.backward()
        losses.append(loss.item())
    assert abs(losses[0] - losses[1]) <= 1e-4
    for (name, pc), pg in zip(cpu.named_parameters(), gpu.parameters()):
        limit = 1e-4 * max(1.0, pc.grad.abs().max().item())
        assert (pg.grad.cpu() - pc.grad).abs().max().item() <= limit, name
