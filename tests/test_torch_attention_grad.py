"""Parity: the port's attention gradients (CPU: the plain version of the
backward kernels) vs edl_tpu's Pallas backward kernels.

The same numpy inputs go through:

- JAX ``jax.grad`` of ``flash_attention(block_q=16, block_k=16)`` — the
  Pallas dq and dk/dv kernels in interpret mode off the TPU, as
  tests/test_attention.py runs them — and the port's differentiable
  ``flash_attention`` (its backward, on CPU tensors, is
  ``_block_grads_reference``, the plain version of the CUDA kernels);
- JAX ``_flash2_backward_kernels(..., interpret=True)`` (the grid-pipelined
  pair) and ``flash_block_grads`` with given lse/delta, and the port's
  ``flash_block_grads``;
- for causal Tq > Tk, which the JAX kernels do not take, JAX ``jax.grad``
  of ``attention_reference``.

The kernels themselves are held against the plain version on the card
(tests/test_torch_kernels.py).

Tolerances, relative to max(1, max|ref|): fp32 2e-5 (summation order
only). bf16 3e-2: both sides round dq/dk/dv to bf16 (one ulp is 0.4-0.8 %
of the value), and the Pallas kernels also round p and ds to bf16 before
their products where the plain version keeps fp32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Compile this module's JAX code afresh: another test file in the same
    worker may have armed JAX's persistent compilation cache with a key
    function (``edl_tpu.train.aot.enable_portable_cache_keys``) that this
    JAX version cannot call."""
    from jax._src import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()


jattn = importlib.import_module("edl_tpu.ops.attention")
tattn = importlib.import_module("edl_tpu_torch.ops.attention")

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (B, H, Hkv, Tq, Tk, D, causal)
CASES = [
    pytest.param((2, 4, 4, 32, 32, 16, False), id="mha"),
    pytest.param((2, 4, 4, 32, 32, 16, True), id="mha-causal"),
    pytest.param((2, 4, 2, 32, 32, 16, False), id="gqa2"),
    pytest.param((2, 4, 2, 32, 32, 16, True), id="gqa2-causal"),
    pytest.param((2, 4, 1, 32, 32, 16, True), id="gqa4-causal"),
    pytest.param((2, 4, 1, 32, 32, 16, False), id="gqa4"),
    pytest.param((2, 4, 4, 16, 48, 16, True), id="tq<tk-end-aligned"),
    pytest.param((2, 4, 2, 16, 48, 16, False), id="tq<tk-gqa2"),
]
NO_KEY_CASES = [
    pytest.param((1, 2, 2, 48, 32, 16), id="mha"),
    pytest.param((1, 4, 2, 48, 16, 16), id="gqa2"),
]


def _arrays(shape, seed=0):
    b, h, h_kv, tq, tk, d = shape
    rng = np.random.RandomState(seed)
    return (
        rng.randn(b, h, tq, d).astype(np.float32),
        rng.randn(b, h_kv, tk, d).astype(np.float32),
        rng.randn(b, h_kv, tk, d).astype(np.float32),
        rng.randn(b, h, tq, d).astype(np.float32),  # dO / loss weights
    )


def _jax(arrs, dtype):
    return tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)


def _torch(arrs, dtype):
    return tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what=""):
    for name, a, b in zip("q k v".split(), got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, name)
        limit = TOL[dtype] * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= limit, "%s d%s: %.3g > %.3g" % (what, name, err, limit)


def _port_grads(arrs, dtype, causal):
    q, k, v, w = _torch(arrs, dtype)
    for t in (q, k, v):
        t.requires_grad_(True)
    out = tattn.flash_attention(q, k, v, causal=causal)
    (out.float() * w.float()).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_attention_grads_match_pallas(case, dtype):
    *shape, causal = case
    arrs = _arrays(shape)
    jq, jk, jv, jw = _jax(arrs, dtype)

    def loss(q, k, v):
        out = jattn.flash_attention(q, k, v, causal=causal,
                                    block_q=16, block_k=16)
        return (out.astype(jnp.float32) * jw.astype(jnp.float32)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    got = _port_grads(arrs, dtype, causal)
    # CPU tensors: the plain version, no kernel
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == before
    for g, t in zip(got, _torch(arrs, dtype)):
        assert g.dtype == t.dtype and g.shape == t.shape
    _close(got, want, dtype, "flash_attention")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_block_grads_match_flash2_kernels(case, dtype):
    """External lse/delta through JAX's grid-pipelined Pallas pair and its
    public ``flash_block_grads`` vs the port's ``flash_block_grads``."""
    *shape, causal = case
    b, h, _, tq, _, d = shape
    arrs = _arrays(shape, seed=1)
    jq, jk, jv, jg = _jax(arrs, dtype)
    j_o, j_lse = jattn.flash_with_lse(jq, jk, jv, causal=causal,
                                      block_q=16, block_k=16)
    j_delta = jattn._bwd_delta(jg, j_o, b, h, tq, d).reshape(b, h, tq)
    scale = d ** -0.5
    flash2 = jattn._flash2_backward_kernels(
        jq, jk, jv, jg, j_lse.reshape(b * h, tq), j_delta.reshape(b * h, tq),
        causal, scale, 16, 16, True,
    )
    public = jattn.flash_block_grads(jq, jk, jv, jg, j_lse, j_delta,
                                     causal=causal, block_q=16, block_k=16)
    tq_, tk_, tv_, tg_ = _torch(arrs, dtype)
    got = tattn.flash_block_grads(
        tq_, tk_, tv_, tg_, torch.from_numpy(_np(j_lse)),
        torch.from_numpy(_np(j_delta)), causal=causal,
    )
    _close(got, flash2, dtype, "flash2 kernels")
    _close(got, public, dtype, "flash_block_grads")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", NO_KEY_CASES)
def test_rows_that_see_no_key_match_reference_autodiff(shape, dtype):
    """Causal Tq > Tk: the first Tq - Tk rows see no key. Their gradient is
    dq = 0, no dk, and dO/Tk to every key's dv — autodiff through the
    reference (JAX's own flash backward falls back to it here)."""
    arrs = _arrays(shape, seed=2)
    jq, jk, jv, jw = _jax(arrs, dtype)

    def loss(q, k, v):
        out = jattn.attention_reference(q, k, v, causal=True)
        return (out.astype(jnp.float32) * jw.astype(jnp.float32)).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    got = _port_grads(arrs, dtype, True)
    _close(got, want, dtype, "no-key rows")
    no_key = shape[3] - shape[4]
    assert float(got[0][:, :, :no_key].abs().max()) == 0.0


def test_lse_cotangent_matches_reference_autodiff():
    """``flash_with_lse`` is differentiable in both outputs: an lse
    cotangent enters as ``delta - dlse``."""
    arrs = _arrays((2, 4, 2, 32, 32, 16), seed=3)
    wl = torch.from_numpy(np.random.RandomState(4).randn(2, 4, 32).astype(
        np.float32))
    grads = []
    for fn in (tattn.flash_with_lse, tattn.attention_reference_with_lse):
        q, k, v, w = _torch(arrs, "float32")
        for t in (q, k, v):
            t.requires_grad_(True)
        o, lse = fn(q, k, v, causal=True)
        ((o * w).sum() + (lse * wl).sum()).backward()
        grads.append((q.grad, k.grad, v.grad))
    _close(grads[0], grads[1], "float32", "lse cotangent")


def test_fold_dkv_sums_each_group():
    rng = np.random.RandomState(5)
    dk = rng.randn(2, 6, 8, 4).astype(np.float32)
    dv = rng.randn(2, 6, 8, 4).astype(np.float32)
    want = jattn._fold_dkv(jnp.asarray(dk), jnp.asarray(dv), 2, 3, 2, 8, 4)
    got = tattn._fold_dkv(torch.from_numpy(dk), torch.from_numpy(dv),
                          2, 3, 2, 8, 4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def test_block_grads_of_rows_with_no_key_follow_autodiff():
    """``flash_block_grads`` with the block's own lse/delta on causal
    Tq > Tk equals autodiff through the reference (the JAX package's
    ``_block_grads_reference``, which its ``flash_block_grads`` uses here,
    gives those rows p = 1 instead of 1/Tk; see ROADMAP section 3)."""
    q, k, v, g = _torch(_arrays((1, 2, 2, 48, 32, 16), seed=6), "float32")
    for t in (q, k, v):
        t.requires_grad_(True)
    o, lse = tattn.attention_reference_with_lse(q, k, v, causal=True)
    want = torch.autograd.grad(o, (q, k, v), g)
    got = tattn.flash_block_grads(q.detach(), k.detach(), v.detach(), g,
                                  lse.detach(), tattn._bwd_delta(g, o.detach()),
                                  causal=True)
    _close(got, want, "float32", "flash_block_grads no-key rows")
    assert float(got[0][:, :, :16].abs().max()) == 0.0
