"""Parity: the port's training step vs edl_tpu's, on the CPU.

A JAX ``TransformerLM`` (vocab 256, d_model 64, 4 heads, 2 layers, d_ff
128, T 32) is initialised, its flax params are converted 1:1 into the
port's fp32 master weights, and the same numpy tokens go through both:
loss and every parameter's gradient, five AdamW steps, the KD and masked
heads, the optimizer mappings and the schedules. On the CPU the port's
attention is the plain version (``attention``: the dense reference with
native autodiff; ``flash_attention``: the differentiable op, whose
backward is the plain version of the CUDA kernels).

Tolerances: fp32 loss and metrics 1e-5, gradients and parameters 1e-5 of
max(1, max|ref|) (summation order only; Adam's normalised update keeps
per-step differences at that scale). bf16 compute: loss 2e-2, per-tensor
relative L2 gradient error 5e-2 (both models round every product and
activation to bf16, at different points).
"""

import copy
import importlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu.train import schedules as jsched
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import (
    adam,
    adamw,
    create_state,
    cross_entropy_loss,
    make_eval_step,
    make_kd_loss,
    make_masked_eval_step,
    make_masked_train_step,
    make_train_step,
    piecewise_decay,
    scaled_schedule_factory,
    sgd,
    warmup_cosine,
)


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


tattn = importlib.import_module("edl_tpu_torch.ops.attention")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128)
B, T = 2, 32
TOL = 1e-5
TOL_BF16_LOSS = 2e-2
TOL_BF16_GRAD = 5e-2


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, CFG["vocab_size"], (B, T + 1)).astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


@pytest.fixture(scope="module")
def jax_params():
    model = JaxLM(dtype=jnp.float32, **CFG)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(_tokens()[0]))
    return jax.tree.map(np.asarray, params["params"])


def _jax_lm_loss(logits, t):
    return jstep.cross_entropy_loss(
        logits.reshape(-1, logits.shape[-1]), t.reshape(-1)
    )


def _lm_loss(logits, t):
    return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              t.reshape(-1))


def _port(params, dtype=torch.float32, **kw):
    model = TransformerLM(dtype=dtype, device="cpu", **CFG, **kw)
    return convert.load_params(model, params)


def _flat(tree):
    return convert.flatten(tree)


def _assert_trees_close(got, want, tol=TOL, what=""):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for path in w:
        a, b = np.asarray(g[path], np.float32), np.asarray(w[path], np.float32)
        limit = tol * max(1.0, float(np.abs(b).max()))
        err = float(np.abs(a - b).max())
        assert err <= limit, "%s %s: %.3g > %.3g" % (what, path, err, limit)


def _grads(model):
    return convert.to_flax({n: p.grad for n, p in model.named_parameters()})


def _jax_state(params, tx, dtype=jnp.float32, **kw):
    model = JaxLM(dtype=dtype, **CFG, **kw)
    params = jax.tree.map(jnp.asarray, params)
    return jstep.TrainState(
        step=jnp.zeros((), jnp.int32), apply_fn=model.apply, params=params,
        tx=tx, opt_state=tx.init(params),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(jax_params, dtype):
    x, y = _tokens(seed=1)
    jmodel = JaxLM(dtype=getattr(jnp, dtype), **CFG)

    def loss_fn(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(x))
        return _jax_lm_loss(logits, jnp.asarray(y))[0]

    want_loss, want = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, jax_params))
    model = _port(jax_params, getattr(torch, dtype))
    loss, _ = _lm_loss(model(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
    got = _grads(model)
    if dtype == "float32":
        assert abs(loss.item() - float(want_loss)) <= TOL
        _assert_trees_close(got, want, what="grad")
        return
    assert abs(loss.item() - float(want_loss)) <= TOL_BF16_LOSS
    g, w = _flat(got), _flat(want)
    for path in w:
        rel = np.linalg.norm(g[path] - w[path]) / max(
            np.linalg.norm(w[path]), 1e-12)
        assert rel <= TOL_BF16_GRAD, "%s rel L2 %.3g" % (path, rel)


@pytest.mark.parametrize("policy", ["save_flash", "save_flash_qkv", "full"])
def test_remat_policies_give_the_same_gradients(jax_params, policy,
                                                monkeypatch):
    """Every layer on the differentiable flash op (on the CPU ``attention``
    is native autodiff and would bypass the op the policy saves). The
    named policies keep the op's outputs: one forward per layer; ``full``
    recomputes it: two."""
    x, y = (torch.from_numpy(a) for a in _tokens(seed=2))
    calls = {"n": 0}
    forward = tattn.flash_forward

    def counting(*args, **kwargs):
        calls["n"] += 1
        return forward(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_forward", counting)
    grads = []
    for remat in (False, True):
        model = _port(jax_params, remat=remat, remat_policy=policy)
        for i in range(model.num_layers):
            getattr(model, "layer_%d" % i).attn.attention_fn = (
                tattn.flash_attention)
        calls["n"] = 0
        loss, _ = _lm_loss(model(x), y)
        loss.backward()
        grads.append(_grads(model))
        want_calls = CFG["num_layers"] * (2 if remat and policy == "full" else 1)
        assert calls["n"] == want_calls, (remat, policy, calls["n"])
    _assert_trees_close(grads[1], grads[0], what=policy)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TransformerLM(remat=True, remat_policy="save_all", device="cpu", **CFG)


def test_five_adamw_steps_match_jax(jax_params):
    batches = [_tokens(seed=10 + i) for i in range(5)]
    jstate = _jax_state(jax_params, optax.adamw(1e-3))
    jtrain = jstep.make_train_step(_jax_lm_loss, donate=False)
    state = create_state(_port(jax_params), None, adamw(1e-3), device="cpu")
    train = make_train_step(_lm_loss)
    for i, (x, y) in enumerate(batches):
        jstate, jm = jtrain(jstate, (jnp.asarray(x), jnp.asarray(y)))
        state, m = train(state, (torch.from_numpy(x), torch.from_numpy(y)))
        assert m["loss"].dim() == 0 and not m["loss"].requires_grad
        assert abs(m["loss"].item() - float(jm["loss"])) <= TOL, i
        assert abs(m["accuracy"].item() - float(jm["accuracy"])) <= TOL, i
    assert int(state.step) == int(jstate.step) == 5
    _assert_trees_close(convert.to_flax(state.apply_fn.state_dict()),
                        jax.tree.map(np.asarray, jstate.params), what="param")


def test_kd_head_matches_jax(jax_params):
    x, y = _tokens(seed=3)
    teacher = np.random.RandomState(4).randn(B, T, CFG["vocab_size"]).astype(
        np.float32)
    jhead = jstep.make_kd_loss(alpha=0.3, temperature=2.0)
    head = make_kd_loss(alpha=0.3, temperature=2.0)
    jstate, jm = jstep.make_train_step(jhead, donate=False)(
        _jax_state(jax_params, optax.sgd(0.1)),
        (jnp.asarray(x), (jnp.asarray(y), jnp.asarray(teacher))),
    )
    state, m = make_train_step(head)(
        create_state(_port(jax_params), None, sgd(0.1), device="cpu"),
        (torch.from_numpy(x), (torch.from_numpy(y), torch.from_numpy(teacher))),
    )
    assert sorted(m) == sorted(jm)
    for key in jm:
        assert abs(m[key].item() - float(jm[key])) <= TOL, key
    _assert_trees_close(convert.to_flax(state.apply_fn.state_dict()),
                        jax.tree.map(np.asarray, jstate.params), what="param")


def test_masked_train_and_eval_match_jax(jax_params):
    x, y = _tokens(seed=5)
    mask = np.array([1, 0], np.int32)
    jargs = ((jnp.asarray(x), jnp.asarray(y)), jnp.asarray(mask))
    targs = ((torch.from_numpy(x), torch.from_numpy(y)), torch.from_numpy(mask))

    jm, jn = jstep.make_masked_eval_step(jstep.cross_entropy_loss)(
        _jax_state(jax_params, optax.sgd(0.1)), *jargs)
    m, n = make_masked_eval_step(cross_entropy_loss)(
        create_state(_port(jax_params), None, sgd(0.1), device="cpu"), *targs)
    assert float(n) == float(jn) == 1.0
    for key in jm:
        assert abs(m[key].item() - float(jm[key])) <= TOL, key
    # a masked eval of one valid row is the plain eval of that row
    plain = make_eval_step(cross_entropy_loss)(
        create_state(_port(jax_params), None, sgd(0.1), device="cpu"),
        (torch.from_numpy(x[:1]), torch.from_numpy(y[:1])))
    assert abs(plain["loss"].item() - m["loss"].item()) <= TOL

    jstate, jm, jn = jstep.make_masked_train_step(
        jstep.cross_entropy_loss, donate=False)(
        _jax_state(jax_params, optax.sgd(0.1)), *jargs)
    state, m, n = make_masked_train_step(cross_entropy_loss)(
        create_state(_port(jax_params), None, sgd(0.1), device="cpu"), *targs)
    assert float(n) == float(jn)
    for key in jm:
        assert abs(m[key].item() - float(jm[key])) <= TOL, key
    _assert_trees_close(convert.to_flax(state.apply_fn.state_dict()),
                        jax.tree.map(np.asarray, jstate.params), what="param")


def test_masked_step_refuses_batch_level_heads(jax_params):
    def batch_head(logits, labels):
        loss, metrics = cross_entropy_loss(logits, labels)
        return loss, {"batch_max": logits.amax(dim=(-2, -1), keepdim=True)}

    state = create_state(_port(jax_params), None, sgd(0.1), device="cpu")
    x, y = (torch.from_numpy(a) for a in _tokens())
    with pytest.raises(ValueError, match="per-example"):
        make_masked_eval_step(batch_head)(state, (x, y), torch.ones(B))


def _run_optimizer(jtx, ttx, steps=6, seed=6):
    """Both optimizers on the same parameters and gradient sequence."""
    rng = np.random.RandomState(seed)
    p0 = rng.randn(5, 3).astype(np.float32)
    grads = [rng.randn(5, 3).astype(np.float32) for _ in range(steps)]
    jp = jnp.asarray(p0)
    jstate = jtx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    tstate = ttx.init([tp])
    for g in grads:
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        ttx.update(tstate)
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                                   atol=1e-6, rtol=1e-6)
    assert tstate.count == steps


@pytest.mark.parametrize("which", [
    "adamw", "adam", "sgd", "sgd-momentum", "sgd-nesterov",
    "sgd-momentum-warmup-cosine", "adamw-piecewise",
])
def test_optimizers_match_optax(which):
    jcos = jsched.warmup_cosine(0.5, steps_per_epoch=2, total_epochs=3,
                                warmup_epochs=1, end_lr=0.05)
    tcos = warmup_cosine(0.5, steps_per_epoch=2, total_epochs=3,
                         warmup_epochs=1, end_lr=0.05)
    jpw = jsched.piecewise_decay(0.01, steps_per_epoch=1,
                                 boundaries_epochs=(2, 4), decay=0.5)
    tpw = piecewise_decay(0.01, steps_per_epoch=1, boundaries_epochs=(2, 4),
                          decay=0.5)
    pairs = {
        "adamw": (optax.adamw(1e-2), adamw(1e-2)),
        "adam": (optax.adam(1e-2), adam(1e-2)),
        "sgd": (optax.sgd(0.1), sgd(0.1)),
        "sgd-momentum": (optax.sgd(0.1, momentum=0.9), sgd(0.1, momentum=0.9)),
        "sgd-nesterov": (optax.sgd(0.1, momentum=0.9, nesterov=True),
                         sgd(0.1, momentum=0.9, nesterov=True)),
        "sgd-momentum-warmup-cosine": (optax.sgd(jcos, momentum=0.9),
                                       sgd(tcos, momentum=0.9)),
        "adamw-piecewise": (optax.adamw(jpw), adamw(tpw)),
    }
    _run_optimizer(*pairs[which])


def test_schedules_match_optax():
    cases = [
        (jsched.warmup_cosine(0.4, 10, 9, warmup_epochs=2, end_lr=0.01),
         warmup_cosine(0.4, 10, 9, warmup_epochs=2, end_lr=0.01)),
        (jsched.warmup_cosine(0.1, 3, 2), warmup_cosine(0.1, 3, 2)),
        (jsched.piecewise_decay(0.1, 7), piecewise_decay(0.1, 7)),
    ]
    for jfn, tfn in cases:
        for step in range(0, 1000, 7):
            assert abs(tfn(step) - float(jfn(step))) <= 1e-6, step


def test_scaled_schedule_factory_builds_sgd_at_the_override():
    factory = scaled_schedule_factory(lambda lr: piecewise_decay(lr, 10))
    tx = factory({"lr": 0.2})
    assert tx.lr(0) == pytest.approx(0.2) and tx.lr(300) == pytest.approx(0.02)
    assert tx.lr(950) == pytest.approx(2e-4)
    p = torch.nn.Parameter(torch.ones(2))
    state = tx.init([p])
    assert state.optimizer.param_groups[0]["momentum"] == 0.9
    with pytest.raises(ValueError, match="lr"):
        factory({})


def test_donate_false_leaves_the_state_untouched(jax_params):
    state = create_state(_port(jax_params), None, adamw(1e-3), device="cpu")
    before = copy.deepcopy(state.apply_fn.state_dict())
    x, y = (torch.from_numpy(a) for a in _tokens())
    new, _ = make_train_step(_lm_loss, donate=False)(state, (x, y))
    assert new is not state and int(new.step) == 1 and int(state.step) == 0
    for k, v in state.apply_fn.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(v, before[k])
               for k, v in new.apply_fn.state_dict().items())
    donated, _ = make_train_step(_lm_loss)(state, (x, y))
    assert donated is state and int(state.step) == 1


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="M7"):
        make_train_step(_lm_loss, numerics=True)
    with pytest.raises(NotImplementedError, match="M15"):
        make_train_step(_lm_loss, aux_losses=True)


def test_seeded_state_is_reproducible():
    def build(seed):
        model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
        return create_state(model, seed, adamw(1e-3), device="cpu")

    a, b = build(3), build(3)
    for (name, pa), pb in zip(a.apply_fn.named_parameters(),
                              b.apply_fn.parameters()):
        assert torch.equal(pa, pb), name
    assert a.step.dtype == torch.int32 and int(a.step) == 0


def test_to_flax_round_trips(jax_params):
    model = _port(jax_params)
    tree = convert.to_flax(model.state_dict())
    _assert_trees_close(tree, jax_params, tol=0.0, what="round trip")
    bf16 = _port(jax_params, param_dtype=torch.bfloat16)
    assert convert.to_flax(bf16.state_dict())["embed"]["embedding"].dtype == (
        np.float32)


def test_bf16_storage_gives_the_same_logits(jax_params):
    """The serving teacher stores bf16 weights; fp32 masters cast to bf16
    before every product give the same logits."""
    x = torch.from_numpy(_tokens(seed=7)[0])
    with torch.inference_mode():
        a = _port(jax_params, torch.bfloat16)(x)
        b = _port(jax_params, torch.bfloat16, param_dtype=torch.bfloat16)(x)
    assert torch.equal(a, b)


def test_step_flops_counts_the_flagship():
    """The formula of lm_bench's docstring at the flagship: 26.5 TFLOP a
    step under save_flash (6.80 TFLOP forward)."""
    from edl_tpu_torch.tools import lm_bench

    cfg = {"batch": 8, "seq": 2048, "d_model": 1024, "num_heads": 16,
           "num_kv_heads": None, "num_layers": 12, "d_ff": 2688,
           "vocab_size": 32000, "remat": "save_flash"}
    assert lm_bench.step_flops(cfg) == pytest.approx(26.52e12, rel=1e-3)
    full = lm_bench.step_flops({**cfg, "remat": "full"})
    none = lm_bench.step_flops({**cfg, "remat": "none"})
    assert none == pytest.approx(26.52e12 - 4.896e12, rel=1e-3)
    assert full - lm_bench.step_flops(cfg) == pytest.approx(0.825e12, rel=1e-2)


def test_lm_bench_cli_prints_one_json_line():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.tools.lm_bench", "--device",
         "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "transformer_lm_train_tokens_per_s_cpu_debug"
    assert np.isfinite(rec["loss"]) and rec["value"] > 0
    assert (rec["batch"], rec["seq"], rec["d_model"], rec["layers"]) == (
        2, 128, 64, 2)
    assert "mfu" not in rec  # no device metric from a CPU run
