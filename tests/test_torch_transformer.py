"""Parity: edl_tpu_torch TransformerLM vs edl_tpu's, with converted weights.

A JAX ``TransformerLM`` (2 layers, d_model 64, 4 heads, 2 kv heads,
vocab 256, T 32) is initialised, its flax params are converted 1:1
(:mod:`edl_tpu_torch.convert`), and both models' logits are compared on the
same numpy tokens, on the CPU (the port's attention is then the plain
version).

Tolerances: fp32 logits 1e-4 (summation order only). bf16 logits 0.1 on
logits of magnitude ~4: both models round every product and residual to
bf16 (8 significant bits, 0.4% relative), but at different points (XLA
fuses elementwise chains in fp32, PyTorch rounds after each op), and two
layers of such differences reach a few hundredths.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu_torch import convert
from edl_tpu_torch.models.transformer import TransformerLM


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


jtf = importlib.import_module("edl_tpu.models.transformer")
ttf = importlib.import_module("edl_tpu_torch.models.transformer")

CFG = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128,
           num_kv_heads=2)
TOL_LOGITS = {"float32": 1e-4, "bfloat16": 0.1}


def _tokens(seed=0, b=2, t=32):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxLM(dtype=jnp.float32, **CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(_tokens()))
    return jax.tree.map(np.asarray, params["params"])


def _port(dtype, params, param_dtype=torch.float32):
    model = TransformerLM(dtype=getattr(torch, dtype), param_dtype=param_dtype,
                          device="cpu", **CFG)
    return convert.load_params(model, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(jax_params, dtype):
    tokens = _tokens(seed=1)
    jmodel = JaxLM(dtype=getattr(jnp, dtype), **CFG)
    want = np.asarray(jmodel.apply({"params": jax_params}, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = _port(dtype, jax_params)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (2, 32, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LOGITS[dtype])


def test_state_dict_is_the_flax_tree_one_to_one(jax_params):
    flat = convert.flatten(jax_params)
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    sd = model.state_dict()
    assert sorted(sd) == sorted(k.replace("/", ".") for k in flat)
    for path, arr in flat.items():
        assert tuple(sd[path.replace("/", ".")].shape) == arr.shape, path
    assert sd["layer_0.attn.q.kernel"].shape == (64, 4, 16)
    assert sd["layer_0.attn.k.kernel"].shape == (64, 2, 16)
    assert sd["layer_0.attn.o.kernel"].shape == (4, 16, 64)


def test_npz_round_trip(jax_params, tmp_path):
    path = str(tmp_path / "teacher.npz")
    convert.save_npz({"params": jax_params}, path)
    direct = convert.to_state_dict(jax_params)
    loaded = convert.load_npz(path)
    assert sorted(loaded) == sorted(direct)
    for key in direct:
        assert torch.equal(loaded[key], direct[key]), key
    tokens = torch.from_numpy(_tokens(seed=2))
    with torch.inference_mode():
        a = _port("float32", path)(tokens)
        b = _port("float32", jax_params)(tokens)
    assert torch.equal(a, b)


def test_bf16_storage_keeps_norm_scales_fp32(jax_params):
    model = _port("bfloat16", jax_params, param_dtype=torch.bfloat16)
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith(".scale") else torch.bfloat16
        assert p.dtype == want, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype(np.float32)
    scale = rng.rand(64).astype(np.float32) + 0.5
    want = jtf.RMSNorm().apply(
        {"params": {"scale": jnp.asarray(scale)}},
        jnp.asarray(x, getattr(jnp, dtype)),
    )
    norm = ttf.RMSNorm(64, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        atol=1e-5 if dtype == "float32" else 2e-2,
    )


def test_rope_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 32, 4, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None], (2, 32))
    want = jtf.rope(jnp.asarray(x), jnp.asarray(pos))
    got = ttf.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="M13"):
        TransformerLM(decode=True, device="cpu", **CFG)
    with pytest.raises(NotImplementedError, match="M15"):
        TransformerLM(num_experts=4, device="cpu", **CFG)


def test_seeded_init_is_deterministic():
    def build(seed):
        model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
        return model.init_weights(torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, pa), pb, pc in zip(
        a.named_parameters(), b.parameters(), c.parameters()
    ):
        assert torch.equal(pa, pb), name
        if not name.endswith(".scale"):
            assert not torch.equal(pa, pc), name
