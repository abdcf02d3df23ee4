"""Parity: edl_tpu_torch's ResNet-vd family and MLP against edl_tpu's.

The same numpy inputs and the same weights (flax variables drawn from a
seed with numpy, converted by ``edl_tpu_torch.convert``) go through the
JAX model (jitted ``apply``) and the port, in eval mode (non-trivial
running averages) and in train mode (batch statistics; the updated
running averages are compared too).

Tolerances, on ``max|port - jax| / max(1, max|jax|)``:

- fp32, 2e-5: both sides compute in fp32 and differ only in summation
  order (convolution algorithms, the batch variance as E[x^2] - E[x]^2
  against the native kernel's);
- bf16, 3e-2 on the logits: both sides round every conv output and every
  normalised activation to bf16 (an ulp is 2^-8 relative), and the
  rounding of the two sides differs wherever their fp32 values differ in
  the last bits, through up to a dozen layers; 1e-2 on the running
  averages, which are fp32 statistics of those bf16 activations. In train
  mode the bound on the logits is 3e-2 plus 5 times the JAX model's own
  bf16 error against its fp32 result: XLA keeps fused intermediates in
  fp32 (``xla_allow_excess_precision``) where eager PyTorch rounds after
  every op, and a BN over few values a channel amplifies the difference
  (ResNet18 at 32x32 normalises 4 values a channel on its 1x1 maps: the
  JAX bf16 logits are 0.10 from the fp32 ones there, the port's 0.42).

The cases that pin the parity traps: 32x32 (every map even: the stride-2
convs and the max pool pad 0 before and 1 after), 36x36 (the vd shortcut
average-pools a 9x9 map: the SAME pad is counted in the divisor) and
``ResNet(stage_sizes=(1, 1))`` at 8x8 and batch 2, whose last map is 1x1,
so the running variance's batch term is a variance of 2 values (the
biased estimate is half the unbiased one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import mlp as jmlp
from edl_tpu.models import resnet as jresnet
from edl_tpu_torch import convert
from edl_tpu_torch.models import mlp as tmlp
from edl_tpu_torch.models import resnet as tresnet


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


TOL = {"float32": 2e-5, "bfloat16": 3e-2}
TOL_STATS = {"float32": 2e-5, "bfloat16": 1e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# name -> (JAX model, port model) at a compute dtype
MODELS = {
    "resnet": lambda jd, td: (
        jresnet.ResNet(stage_sizes=(1, 1), width=8, num_classes=10, dtype=jd),
        tresnet.ResNet((1, 1), width=8, num_classes=10, dtype=td)),
    "resnet18": lambda jd, td: (
        jresnet.ResNet18_vd(width=8, num_classes=10, dtype=jd),
        tresnet.ResNet18_vd(width=8, num_classes=10, dtype=td)),
    "resnext": lambda jd, td: (
        jresnet.ResNeXt(stage_sizes=(1, 1), cardinality=2, base_width=4,
                        num_classes=10, dtype=jd),
        tresnet.ResNeXt((1, 1), cardinality=2, base_width=4, num_classes=10,
                        dtype=td)),
}


def flax_variables(jmodel, x, seed=0):
    """Variables of ``jmodel``'s shapes drawn with numpy: kernels
    N(0, 1/fan_in), BN scales 1 + N(0, 0.1^2), biases and running means
    N(0, 0.1^2), running variances U(0.5, 1.5)."""
    shapes = jax.eval_shape(functools.partial(jmodel.init, train=False),
                            jax.random.PRNGKey(0), x)
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rs.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def images(batch, size, seed=1):
    return np.random.RandomState(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return float(err / max(1.0, np.abs(want).max()))


def _compare(jmodel, tmodel, x, train: bool, dtype: str, jref=None,
             tol=None):
    """``jref``: the JAX model at fp32, whose logits set the train-mode
    bf16 bound (see the module docstring); ``tol`` overrides the logits'
    tolerance."""
    v = flax_variables(jmodel, x)
    convert.load_params(tmodel, v)
    if train:
        want, mutated = jax.jit(functools.partial(
            jmodel.apply, train=True, mutable=["batch_stats"]))(v, x)
    else:
        want = jax.jit(functools.partial(jmodel.apply, train=False))(v, x)
    got = tmodel(torch.from_numpy(x), train=train)
    assert got.dtype == torch.float32
    err = _rel(got.detach().numpy(), want)
    tol = TOL[dtype] if tol is None else tol
    if train and jref is not None:
        ref, _ = jax.jit(functools.partial(
            jref.apply, train=True, mutable=["batch_stats"]))(v, x)
        tol += 5.0 * _rel(want, ref)
    assert err <= tol, (err, tol)
    back = convert.to_flax(tmodel.state_dict())
    if not train:
        # eval mode leaves the running averages as they were
        same = jax.tree.map(np.array_equal, v["batch_stats"],
                            back["batch_stats"])
        assert all(jax.tree.leaves(same))
        return
    errs = jax.tree.map(_rel, back["batch_stats"],
                        jax.tree.map(np.asarray, mutated["batch_stats"]))
    assert max(jax.tree.leaves(errs)) <= TOL_STATS[dtype], errs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [32, 36])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_forward_matches_jax(name, train, size, dtype):
    jmodel, tmodel = MODELS[name](*DTYPES[dtype])
    jref = MODELS[name](jnp.float32, torch.float32)[0] \
        if dtype == "bfloat16" else None
    _compare(jmodel, tmodel, images(4, size), train, dtype, jref)


def test_running_variance_is_the_biased_batch_variance():
    """Batch 2 at 8x8: the last stage's map is 1x1, so each of its BNs
    sees 2 values a channel and the unbiased variance is twice the biased
    one that flax's running average takes. The running averages hold
    the fp32 tolerance; the logits 2e-4, since a BN over two values
    normalises them to +-1 whatever their difference, which carries the
    fp32 rounding of that difference (measured 6.6e-5)."""
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), num_classes=10,
                            dtype=jnp.float32)
    tmodel = tresnet.ResNet((1, 1), num_classes=10, dtype=torch.float32)
    x = images(2, 8)
    _compare(jmodel, tmodel, x, True, "float32", tol=2e-4)
    # the map the last block's BNs normalise is 1x1
    seen = []
    block = tmodel.BottleneckVd_1
    hook = block.BatchNorm_2.register_forward_pre_hook(
        lambda m, args: seen.append(tuple(args[0].shape)))
    tmodel(torch.from_numpy(x), train=False)
    hook.remove()
    assert seen == [(2, 512, 1, 1)]


@pytest.mark.parametrize("size,kernel,stride,want", [
    (32, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (9, 2, 2, (0, 1)),
    (8, 2, 2, (0, 0)), (7, 3, 1, (1, 1)), (5, 1, 1, (0, 0)),
])
def test_same_pads_are_xla_pads(size, kernel, stride, want):
    assert tresnet.same_pads(size, kernel, stride) == want


def test_pools_match_flax():
    """The 3x3 stride-2 max pool (-inf pads) and the 2x2 stride-2 average
    pool (zero pads counted) on even and odd maps, fp32, exact up to
    rounding."""
    import flax.linen as nn

    for size in (8, 9):
        x = images(2, size)
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        want = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        got = tresnet.max_pool_same(t).permute(0, 2, 3, 1).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        want = nn.avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")
        got = tresnet.avg_pool_same(t, 2).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_layout_and_names_follow_flax():
    """Every flax variable has its ``state_dict`` key (conv kernels OIHW,
    kept channels-last), and the blocks' last BNs start at zero scale."""
    jmodel, tmodel = MODELS["resnet"](jnp.float32, torch.float32)
    x = images(2, 32)
    v = flax_variables(jmodel, x)
    flat = convert.flatten(v)
    sd = tmodel.state_dict()
    assert sorted(k.replace("/", ".") for k in flat) == sorted(sd)
    for key, arr in flat.items():
        t = sd[key.replace("/", ".")]
        if key.endswith("kernel") and arr.ndim == 4:
            assert tuple(t.shape) == (arr.shape[3], arr.shape[2],
                                      arr.shape[0], arr.shape[1])
            assert t.is_contiguous(memory_format=torch.channels_last)
        else:
            assert tuple(t.shape) == arr.shape
    jinit = jax.jit(functools.partial(jmodel.init, train=False))(
        jax.random.PRNGKey(0), x)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    zero_j = sorted(p for p, a in convert.flatten(jinit["params"]).items()
                    if p.endswith("scale") and not np.any(a))
    zero_t = sorted(k.replace(".", "/") for k, t in tmodel.state_dict().items()
                    if k.endswith("scale") and not t.any())
    assert zero_j == zero_t == ["BottleneckVd_0/BatchNorm_2/scale",
                                "BottleneckVd_1/BatchNorm_2/scale"]


def test_init_matches_flax_lecun_normal():
    """Conv and Dense kernels: truncated normal with std sqrt(1/fan_in)
    (flax's lecun_normal), within 5 % on 36,864 draws, bounded at two
    standard deviations of the untruncated normal; Dense bias 0, BN bias
    0, running mean 0 and variance 1."""
    model = tresnet.ResNet((1, 1), width=64, num_classes=10,
                           dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    w = model.BottleneckVd_0.Conv_1.kernel  # [64, 64, 3, 3]
    fan_in = 64 * 9
    w = w.detach()
    assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
    assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.87962566103423978
    jw = jax.nn.initializers.lecun_normal()(jax.random.PRNGKey(0),
                                            (3, 3, 64, 64))
    assert float(w.std()) == pytest.approx(float(jnp.std(jw)), rel=0.05)
    assert not model.Dense_0.bias.any() and not model.BatchNorm_0.bias.any()
    assert not model.BatchNorm_0.mean.any()
    assert bool((model.BatchNorm_0.var == 1).all())


def test_convert_round_trip_is_exact():
    jmodel, tmodel = MODELS["resnext"](jnp.bfloat16, torch.bfloat16)
    v = flax_variables(jmodel, images(2, 32))
    sd = convert.to_state_dict(v)
    back = convert.to_flax(sd)
    assert set(back) == {"params", "batch_stats"}
    same = jax.tree.map(lambda a, b: a.dtype == b.dtype and
                        np.array_equal(a, b), v, back)
    assert all(jax.tree.leaves(same))
    tmodel.load_state_dict(sd)
    again = tmodel.state_dict()
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    # a params-only tree (no batch norm) comes back as a params tree
    assert set(convert.to_flax({"Dense_0.kernel": torch.ones(2, 3)})) \
        == {"Dense_0"}


def test_batchnorm_autograd_pieces_are_exact():
    """The stage-wide BN's two autograd functions against autograd of
    their formulas, float64: the moments [sum x, sum x^2] and the
    normalisation with given statistics (gradients in x, mean, var,
    scale and bias)."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(tresnet._Moments.apply, (x,))
    mean = torch.randn(4, dtype=torch.float64, requires_grad=True)
    var = torch.rand(4, dtype=torch.float64).add(0.5).requires_grad_()
    scale = torch.randn(4, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda *a: tresnet._Normalize.apply(*a, 1e-5),
        (x, mean, var, scale, bias))


@pytest.mark.parametrize("name", ["mlp", "linear"])
def test_mlp_matches_jax(name):
    x = np.random.RandomState(0).standard_normal((6, 13)).astype(np.float32)
    if name == "mlp":
        jmodel = jmlp.MLP(hidden=(16, 8), features=3)
        tmodel = tmlp.MLP(13, hidden=(16, 8), features=3)
    else:
        jmodel = jmlp.LinearRegression()
        tmodel = tmlp.LinearRegression(13)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0), x))
    convert.load_params(tmodel, params)
    want = np.asarray(jmodel.apply(params, x))
    got = tmodel(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    tmodel.init_weights(torch.Generator().manual_seed(0))
    assert not tmodel.Dense_0.bias.any()
