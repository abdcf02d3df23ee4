"""Parity: edl_tpu_torch attention (CPU: the plain version) vs edl_tpu's.

The same numpy inputs go through JAX ``flash_with_lse`` (the Pallas kernel
in interpret mode off the TPU, blocks of 16, as tests/test_attention.py
runs it), JAX ``attention_reference_with_lse``, and the port's
``flash_with_lse`` / ``attention``, which on CPU tensors are the plain
PyTorch version of the CUDA kernel. The kernel itself is held against
the plain version on the card (tests/test_torch_kernels.py).

Tolerances: fp32 outputs 1e-5 (summation order only); bf16 outputs 2e-2
(both sides round the output to bf16, one ulp on [2, 4) is 1.6e-2); lse
is fp32 on both sides, 1e-5 (bf16 inputs multiply exactly in fp32).
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


# the packages export an ``attention`` function that shadows the module
jattn = importlib.import_module("edl_tpu.ops.attention")
tattn = importlib.import_module("edl_tpu_torch.ops.attention")

TOL_O = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_LSE = 1e-5

# (B, H, Hkv, Tq, Tk, D, causal)
CASES = [
    pytest.param((2, 4, 4, 32, 32, 16, False), id="mha"),
    pytest.param((2, 4, 4, 32, 32, 16, True), id="mha-causal"),
    pytest.param((2, 4, 2, 32, 32, 16, False), id="gqa2"),
    pytest.param((2, 4, 2, 32, 32, 16, True), id="gqa2-causal"),
    pytest.param((2, 4, 1, 32, 32, 16, True), id="gqa4-causal"),
    pytest.param((2, 4, 4, 16, 48, 16, True), id="tq<tk-end-aligned"),
    pytest.param((1, 2, 2, 48, 32, 16, True), id="causal-tq>tk"),
]


def _inputs(case, dtype, seed=0):
    b, h, h_kv, tq, tk, d, _ = case
    rng = np.random.RandomState(seed)
    arrs = (
        rng.randn(b, h, tq, d).astype(np.float32),
        rng.randn(b, h_kv, tk, d).astype(np.float32),
        rng.randn(b, h_kv, tk, d).astype(np.float32),
    )
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    return (
        tuple(jnp.asarray(a, jdt) for a in arrs),
        tuple(torch.from_numpy(a).to(tdt) for a in arrs),
    )


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_with_lse_matches_jax(case, dtype):
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, dtype)
    j_o, j_lse = jattn.flash_with_lse(
        jq, jk, jv, causal=causal, block_q=16, block_k=16
    )
    r_o, r_lse = jattn.attention_reference_with_lse(jq, jk, jv, causal=causal)
    launches = tattn.flash_forward.launches
    t_o, t_lse = tattn.flash_with_lse(tq, tk, tv, causal=causal)
    assert tattn.flash_forward.launches == launches  # CPU: no kernel
    assert t_o.dtype == getattr(torch, dtype) and t_lse.dtype == torch.float32
    assert t_o.shape == tq.shape and t_lse.shape == tq.shape[:3]
    for ref_o, ref_lse in ((j_o, j_lse), (r_o, r_lse)):
        np.testing.assert_allclose(_np(t_o), _np(ref_o), atol=TOL_O[dtype])
        np.testing.assert_allclose(_np(t_lse), _np(ref_lse), atol=TOL_LSE)


@pytest.mark.parametrize("case", CASES)
def test_attention_matches_jax(case):
    causal = case[-1]
    (jq, jk, jv), (tq, tk, tv) = _inputs(case, "float32", seed=1)
    want = jattn.attention(jq, jk, jv, causal=causal)
    got = tattn.attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL_O["float32"])
    np.testing.assert_array_equal(
        got.numpy(), tattn.flash_attention(tq, tk, tv, causal=causal).numpy()
    )


def test_no_visible_key_rows_are_the_mean_of_v():
    """End-aligned causal with Tq > Tk: the first Tq - Tk rows see no key
    and the finite mask gives a uniform softmax over all Tk keys."""
    (_, _, _), (q, k, v) = _inputs((1, 2, 2, 40, 24, 16, True), "float32")
    o, lse = tattn.flash_with_lse(q, k, v, causal=True)
    torch.testing.assert_close(
        o[:, :, :16], v.mean(dim=2, keepdim=True).expand(-1, -1, 16, -1)
    )
    assert torch.isfinite(o).all()
    assert (lse[:, :, :16] == tattn.NEG_INF).all()


def test_gqa_group_validation():
    q = torch.zeros(1, 6, 4, 8)
    k = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="must divide"):
        tattn.attention(q, k, k)
