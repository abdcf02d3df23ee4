"""Mixture of experts (ROADMAP M15): edl_tpu_torch's ``SwitchMoE``, the MoE
TransformerLM, ``make_train_step(aux_losses=True)`` and expert parallelism
against edl_tpu's, on the CPU.

The JAX side runs eagerly or jitted on the CPU, its persistent compilation
cache off; weights come from the flax init and are converted 1:1. The
port's multi-rank stages are one launch of four gloo processes of
``tests/torch_lm_parallel_worker.py`` (``run_stage``), each op on its own
mesh. Routing data keep every top-k margin above 1e-4 (asserted), so no
tie-break decides a route. Tolerances (fp32, summation order only):

- ``SwitchMoE``: outputs rtol 2e-5, atol 2e-6; the dropped routes
  identical (JAX's own choice-major positions, recomputed from its
  operations); the aux loss 1e-6 relative; gradients of the input, the
  router, ``wi`` and ``wo`` 1e-4 of each tensor's max.
- bf16 ``SwitchMoE``: the same routes (routing is fp32 in both), outputs
  within 2e-2 of max(1, max|ref|): both round the expert products to bf16
  at different points.
- The MoE LM: logits 1e-5; two AdamW steps (lr 1e-2) with the aux loss:
  losses and ``aux_loss`` 1e-5, parameters 1e-3 (Adam's first steps
  normalise each gradient entry, so an entry near zero moves by up to the
  learning rate); greedy tokens exactly.
- dp 2 × ep 2, sp 2 × ep 2, tp 2 × ep 2 and DDP at dp 4, against the
  unsharded JAX step on the global batch: losses (the mean of the ranks'
  under DDP) and ``aux_loss`` 1e-5 relative, gathered parameters 1e-3,
  each rank's banks E/ep experts wide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.decode import greedy_generate as jax_generate
from edl_tpu.models.moe import SwitchMoE as JaxMoE
from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu.train import create_state as jax_create_state
from edl_tpu.train import cross_entropy_loss as jax_ce
from edl_tpu.train import make_train_step as jax_train_step
from edl_tpu_torch import convert
from edl_tpu_torch.models import SwitchMoE, TransformerLM, greedy_generate
from edl_tpu_torch.train import (
    adamw,
    create_state,
    cross_entropy_loss,
    make_train_step,
)
from test_torch_sharding_rules import run_stage

B, S, D, E = 2, 16, 32, 4
MARGIN = 1e-4
TOL_OUT = dict(rtol=2e-5, atol=2e-6)
TOL_AUX = 1e-6
TOL_GRAD = 1e-4
TOL_BF16 = 2e-2
TOL_LOGITS = 1e-5
TOL_LOSS = 1e-5
TOL_PARAM = 1e-3
LM_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64,
              num_experts=4, moe_every=2)
LR, WD = 1e-2, 0.1


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_moe(k, cf=1.25, e=E, d_ff=64, dtype=jnp.float32):
    return JaxMoE(num_experts=e, d_ff=d_ff, capacity_factor=cf, top_k=k,
                  dtype=dtype)


def _port_moe(params, k, cf=1.25, e=E, d_ff=64, dtype=torch.float32):
    d = params["router"]["kernel"].shape[0]
    moe = SwitchMoE(d, e, d_ff, capacity_factor=cf, top_k=k, dtype=dtype,
                    device="cpu")
    return convert.load_params(moe, params)


def _jax_keep(params, x, k, cf, e):
    """The JAX module's kept routes ``[B, S, k]``, from its own operations
    (``edl_tpu/models/moe.py:47-72``)."""
    b, s, _ = x.shape
    capacity = max(1, int(cf * k * s / e))
    probs = jax.nn.softmax(x @ params["router"]["kernel"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    oh_k = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    oh_cm = jnp.transpose(oh_k, (0, 2, 1, 3)).reshape(b, k * s, e)
    pos_cm = jnp.cumsum(oh_cm, axis=1) * oh_cm
    pos = jnp.transpose(pos_cm.reshape(b, k, s, e), (0, 2, 1, 3))
    keep = (pos > 0) & (pos <= capacity)
    return np.asarray(keep.any(axis=-1))


def _margins(params, x, k):
    """The smallest gap between consecutive probabilities among each
    token's k + 1 best experts."""
    probs = np.asarray(jax.nn.softmax(x @ params["router"]["kernel"], -1))
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


def _moe_case(k, seed, cf=1.25, s=S):
    x = np.random.RandomState(seed).randn(B, s, D).astype(np.float32)
    params = _np_tree(_jax_moe(k, cf).init(jax.random.PRNGKey(seed),
                                           jnp.asarray(x))["params"])
    assert _margins(params, x, k) > MARGIN
    return x, params


@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 1.0)])
def test_switch_moe_matches_jax(k, cf):
    """Forward, dropped routes, aux and gradients; at these capacity
    factors some routes drop (top-1 at the JAX default)."""
    x, params = _moe_case(k, seed=10 + k, cf=cf)
    g = np.random.RandomState(20 + k).randn(B, S, D).astype(np.float32)
    jmoe = _jax_moe(k, cf)

    def objective(p, xx):
        out, mut = jmoe.apply({"params": p}, xx, mutable=["losses"])
        (aux,) = jax.tree.leaves(mut["losses"])
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (want, want_aux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))

    moe = _port_moe(params, k, cf)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe(xt, return_aux=True)
    ((out * torch.from_numpy(g)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               **TOL_OUT)
    assert abs(aux.item() - float(want_aux)) <= TOL_AUX * float(want_aux)
    keep = moe.route(torch.from_numpy(x)).keep.numpy()
    want_keep = _jax_keep(params, jnp.asarray(x), k, cf, E)
    np.testing.assert_array_equal(keep, want_keep)
    assert not keep.all()  # the case drops routes: the queues decide
    dropped = ~keep.any(axis=-1)
    assert np.all(out.detach().numpy()[dropped] == 0.0)
    jg = convert.to_state_dict(_np_tree(jg))
    grads = {"router.kernel": moe.router.kernel.grad, "wi": moe.wi.grad,
             "wo": moe.wo.grad}
    assert set(grads) == set(jg)
    for name, got in grads.items():
        want_g = jg[name].numpy()
        err = np.abs(got.numpy() - want_g).max()
        assert err <= TOL_GRAD * np.abs(want_g).max(), name
    err = np.abs(xt.grad.numpy() - np.asarray(jgx)).max()
    assert err <= TOL_GRAD * np.abs(np.asarray(jgx)).max()


def test_choice_major_serves_both_first_choices():
    """``tests/test_moe.py::test_choice_major_capacity_priority``: two
    experts, capacity 1, token 0 prefers e0 then e1, token 1 e1 then e0.
    Both are served by their first choice; the second choices find the
    slots taken."""
    x = np.asarray([[[1.0, 0.0], [0.0, 1.0]]], np.float32)
    jmoe = JaxMoE(num_experts=2, d_ff=8, capacity_factor=0.5, top_k=2,
                  dtype=jnp.float32)
    params = _np_tree(jmoe.init(jax.random.PRNGKey(3), jnp.asarray(x))
                      ["params"])
    params["router"]["kernel"] = np.asarray([[2.0, 1.0], [1.0, 2.0]],
                                            np.float32)
    want = np.asarray(jax.jit(jmoe.apply)({"params": params},
                                          jnp.asarray(x)))
    moe = _port_moe(params, 2, cf=0.5, e=2, d_ff=8)
    with torch.no_grad():
        r = moe.route(torch.from_numpy(x))
        got = moe(torch.from_numpy(x))
    assert r.capacity == 1
    assert r.experts[0].tolist() == [[0, 1], [1, 0]]
    assert r.keep[0].tolist() == [[True, False], [True, False]]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(got[0, 1].abs().sum()) > 1e-6  # token 1 is not zeroed


@pytest.mark.parametrize("k", [1, 2])
def test_capacity_one_drops_all_but_one_route_an_expert(k):
    """Capacity factor E / (k·S): one slot an expert and row; the kept
    routes are JAX's, every other token's output is exactly zero."""
    cf = E / (k * S)
    x, params = _moe_case(k, seed=30 + k, cf=cf)
    want = np.asarray(_jax_moe(k, cf).apply({"params": params},
                                           jnp.asarray(x)))
    moe = _port_moe(params, k, cf)
    with torch.no_grad():
        r = moe.route(torch.from_numpy(x))
        got = moe(torch.from_numpy(x)).numpy()
    assert r.capacity == 1
    keep = r.keep.numpy()
    np.testing.assert_array_equal(
        keep, _jax_keep(params, jnp.asarray(x), k, cf, E))
    assert keep.sum(axis=(1, 2)).max() <= E
    np.testing.assert_allclose(got, want, **TOL_OUT)
    assert np.all(got[~keep.any(axis=-1)] == 0.0)


def test_bf16_switch_moe_matches_jax():
    x, params = _moe_case(2, seed=40)
    want = np.asarray(_jax_moe(2, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x))).astype(np.float32)
    moe = _port_moe(params, 2, dtype=torch.bfloat16)
    with torch.no_grad():
        got = moe(torch.from_numpy(x))
    assert got.dtype == torch.float32  # x's dtype
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL_BF16 * max(1.0, np.abs(want).max())


def test_bank_init_uses_flax_fan_in():
    """flax's ``lecun_normal`` on a 3-D bank ``[E, in, out]`` draws with
    fan-in ``E · in``: the port's init has that std (a ``[8, 1024,
    2688]`` bank: 0.01105 = 1/sqrt(8·1024))."""
    moe = SwitchMoE(64, 8, 96, device="cpu")
    moe.init_weights(torch.Generator().manual_seed(0))
    for p, fan_in in ((moe.wi, 8 * 64), (moe.wo, 8 * 96),
                      (moe.router.kernel, 64)):
        assert abs(p.std().item() * fan_in ** 0.5 - 1.0) < 0.05
    lm = TransformerLM(device="cpu", dtype=torch.float32, **LM_CFG)
    lm.init_weights(torch.Generator().manual_seed(0))
    wi = lm.layer_1.moe.wi
    assert abs(wi.std().item() * (E * 32) ** 0.5 - 1.0) < 0.05


# -- the MoE TransformerLM ------------------------------------------------------


def _lm_tokens(seed=0, b=4, t=16):
    tok = np.random.RandomState(seed).randint(0, 64, (b, t + 1)).astype(
        np.int32)
    return tok[:, :-1], tok[:, 1:]


@pytest.fixture(scope="module")
def lm_case():
    """The JAX MoE LM, its params (layer_1 is the MoE block) and two AdamW
    steps of the JAX step with ``aux_losses=True`` on the global batch."""
    x, y = _lm_tokens()
    jmodel = JaxLM(dtype=jnp.float32, **LM_CFG)
    state = jax_create_state(jmodel, jax.random.PRNGKey(5), jnp.asarray(x),
                             optax.adamw(LR, weight_decay=WD))
    init = _np_tree(state.params)
    assert "moe" in init["layer_1"] and "mlp" in init["layer_0"]

    def loss_head(logits, t):
        return jax_ce(logits.reshape(-1, logits.shape[-1]), t.reshape(-1))

    step = jax_train_step(loss_head, aux_losses=True, donate=False)
    losses, aux = [], []
    for _ in range(2):
        state, metrics = step(state, (jnp.asarray(x), jnp.asarray(y)))
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    return {"jmodel": jmodel, "init": init, "x": x, "y": y,
            "losses": losses, "aux": aux, "after": _np_tree(state.params)}


def _port_lm(params, **kw):
    model = TransformerLM(dtype=torch.float32, device="cpu", **LM_CFG, **kw)
    return convert.load_params(model, params)


def _lm_loss(logits, t):
    return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              t.reshape(-1))


def test_moe_lm_logits_match_jax(lm_case):
    want = np.asarray(lm_case["jmodel"].apply({"params": lm_case["init"]},
                                              jnp.asarray(lm_case["x"])))
    model = _port_lm(lm_case["init"])
    with torch.no_grad():
        got = model(torch.from_numpy(lm_case["x"]))
    assert len(model.aux_losses) == 1  # one MoE block of two
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LOGITS)


@pytest.mark.parametrize("remat", [None, "save_flash", "save_flash_qkv",
                                   "full"])
def test_two_adamw_steps_with_aux_match_jax(lm_case, remat):
    """Under remat the MoE block's aux loss is the forward's (the
    checkpoint's recompute returns its own, which it drops)."""
    kw = {"remat": True, "remat_policy": remat} if remat else {}
    model = _port_lm(lm_case["init"], **kw)
    state = create_state(model, None, adamw(LR, weight_decay=WD),
                         device="cpu")
    step = make_train_step(_lm_loss, aux_losses=True, numerics=True)
    batch = (torch.from_numpy(lm_case["x"]),
             torch.from_numpy(lm_case["y"]).long())
    losses, aux = [], []
    for _ in range(2):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    np.testing.assert_allclose(losses, lm_case["losses"], rtol=TOL_LOSS)
    np.testing.assert_allclose(aux, lm_case["aux"], rtol=TOL_LOSS)
    assert min(aux) > 0
    want = convert.to_state_dict(lm_case["after"])
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        assert np.abs(got[name].detach().numpy() - w.numpy()).max() \
            <= TOL_PARAM, name


def test_greedy_generate_matches_jax_decode(lm_case):
    prompt = np.random.RandomState(7).randint(0, 64, (3, 6)).astype(np.int32)
    jmodel = lm_case["jmodel"]
    want = np.asarray(jax.jit(lambda p, t: jax_generate(
        jmodel, p, t, max_new_tokens=7))(lm_case["init"],
                                         jnp.asarray(prompt)))
    model = _port_lm(lm_case["init"])
    got = greedy_generate(model, torch.from_numpy(prompt), 7)
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_round_trips_the_moe_paths(lm_case):
    """``layer_1/moe/{router/kernel,wi,wo}`` both ways: into the
    ``state_dict`` names, loaded strictly, and back to the flax tree bit
    for bit."""
    sd = convert.to_state_dict(lm_case["init"])
    assert sd["layer_1.moe.router.kernel"].shape == (32, E)
    assert sd["layer_1.moe.wi"].shape == (E, 32, 64)
    assert sd["layer_1.moe.wo"].shape == (E, 64, 32)
    back = convert.to_flax(_port_lm(lm_case["init"]).state_dict())
    flat_back, flat_want = (convert.flatten(t)
                            for t in (back, lm_case["init"]))
    assert set(flat_back) == set(flat_want)
    for path, arr in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], arr)


def test_aux_loss_metric_is_zero_without_moe():
    cfg = dict(LM_CFG, num_experts=0)
    model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
    state = create_state(model, 0, adamw(LR), device="cpu")
    x, y = _lm_tokens()
    _, metrics = make_train_step(_lm_loss, aux_losses=True)(
        state, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert float(metrics["aux_loss"]) == 0.0
    assert not hasattr(model.layer_1, "moe")


# -- expert parallelism on four gloo ranks ----------------------------------------


@pytest.mark.parametrize("ep", [2, 4, 8])
def test_ep_specs_match_jax_named_sharding(lm_case, ep):
    """``TRANSFORMER_TP_RULES + MOE_EP_RULES`` resolve every parameter of
    the MoE LM to the JAX placement's spec on a ``dp × tp × ep`` mesh of
    the 8 virtual devices: the banks' ``[E]`` axis on ``ep`` where ep
    divides E (4 experts: not at 8, replicated as in JAX), the router
    whole."""
    from edl_tpu.models.moe import MOE_EP_RULES as JAX_EP
    from edl_tpu.parallel import TRANSFORMER_TP_RULES as JAX_TP
    from edl_tpu.parallel import make_mesh as jax_mesh
    from edl_tpu.parallel import shard_params_by_rules as jax_shard
    from edl_tpu_torch.models import MOE_EP_RULES
    from edl_tpu_torch.parallel import sharding_rules as rules

    tp = 2 if ep < 8 else 1
    shape = {"dp": 8 // (ep * tp), "tp": tp, "ep": ep}
    placed = jax_shard(jax_mesh(shape), lm_case["init"],
                       list(JAX_TP) + list(JAX_EP))
    leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
    want = {"/" + "/".join(k.key for k in path): tuple(arr.sharding.spec)
            for path, arr in leaves}
    model = TransformerLM(device="meta", **LM_CFG)
    assert len(want) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        path = rules.param_path(name)
        got = rules.resolve_spec(shape, path, p.shape,
                                 rules.TRANSFORMER_TP_RULES + MOE_EP_RULES)
        pad = (None,) * p.dim()
        assert (got + pad)[:p.dim()] == (want[path] + pad)[:p.dim()], path
    bank = rules.resolve_spec(shape, "/layer_1/moe/wi", (E, 32, 64),
                              MOE_EP_RULES)
    assert bank == (("ep" if E % ep == 0 else None), None, None)


MESHES = {"dp2-ep2": {"dp": 2, "ep": 2}, "sp2-ep2": {"dp": 1, "sp": 2, "ep": 2},
          "tp2-ep2": {"dp": 1, "tp": 2, "ep": 2}, "ddp4": {"dp": 4}}


@pytest.fixture(scope="module")
def stage_runs(lm_case, tmp_path_factory):
    """One launch of four ranks: every mesh's two steps, in order."""
    tmp = tmp_path_factory.mktemp("moe-stage")
    weights = str(tmp / "w.npz")
    convert.save_npz(lm_case["init"], weights)
    data = str(tmp / "data.npz")
    np.savez(data, x=lm_case["x"], y=lm_case["y"])
    ops = [{"op": "moe_steps", "axes": axes, "weights": weights,
            "cfg": LM_CFG, "data": data, "steps": 2, "lr": LR, "wd": WD,
            "out": str(tmp / ("%s.npz" % name))}
           for name, axes in MESHES.items()]
    run_stage(tmp, "moe", 4, {"dp": 4}, ops)
    return {name: [dict(np.load(str(tmp / ("%s.%d.npz" % (name, r)))))
                   for r in range(4)] for name in MESHES}


@pytest.mark.parametrize("name", list(MESHES))
def test_parallel_steps_match_jax_global_batch(lm_case, stage_runs, name):
    ranks = stage_runs[name]
    ep = MESHES[name].get("ep", 1)
    losses = np.mean([r["loss"] for r in ranks], axis=0)
    if name != "ddp4":  # the rules path reports the global mean
        for r in ranks:
            np.testing.assert_allclose(r["loss"], losses, rtol=1e-6)
    np.testing.assert_allclose(losses, lm_case["losses"], rtol=TOL_LOSS)
    for r in ranks:
        np.testing.assert_allclose(r["aux_loss"], lm_case["aux"],
                                   rtol=TOL_LOSS)
        assert tuple(r["shape/layer_1.moe.wi"]) == (E // ep, 32, 64)
        assert tuple(r["shape/layer_1.moe.wo"]) == (E // ep, 64, 32)
    want = convert.to_state_dict(lm_case["after"])
    got = ranks[0]
    assert {k[len("param/"):] for k in got if k.startswith("param/")} \
        == set(want)
    for pname, w in want.items():
        g = got["param/" + pname]
        assert g.shape == tuple(w.shape), pname
        assert np.abs(g - w.numpy()).max() <= TOL_PARAM, pname
