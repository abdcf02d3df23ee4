"""Pipeline parallelism (ROADMAP M16): edl_tpu_torch's GPipe and 1F1B
schedules and the stage-split TransformerLM against edl_tpu's, on the CPU.

The JAX side runs jitted on the 8 virtual CPU devices of ``conftest.py``,
its persistent compilation cache off, calling the reference functions
directly. The port's stages are one launch of four gloo processes of
``tests/torch_lm_parallel_worker.py`` (op ``pp``), each on its own mesh,
while the JAX references compile. The model is ``tests/test_pipeline.py``'s
tiny LM (vocab 64, d_model 32, 2 heads, 4 layers, d_ff 48, fp32) on
B 8, T 16; weights come from the flax init, converted. Tolerances are the
JAX package's own for its pipeline (fp32, summation order only):

- logits at pp 2 and pp 4 against ``pipeline_lm_logits``: 2e-4;
- GPipe at pp 2 × dp 2 against ``jax.value_and_grad(pipeline_lm_loss,
  batch_axis="dp")``: loss rtol 1e-5, gradients atol 2e-4 rtol 2e-3;
- 1F1B against ``pipeline_lm_1f1b_grads``: loss rtol 1e-5, gradients
  atol 3e-4 rtol 2e-3;
- a GQA model's pipeline logits against the flat JAX model: 2e-5;
- three Adam steps over GPipe against optax on the JAX split: losses
  rtol 1e-5;
- the tick schedule, the efficiency bound, the split and merge: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu.ops.attention import attention_reference
from edl_tpu.parallel import make_mesh as jax_mesh
from edl_tpu.parallel import merge_lm_params as jax_merge
from edl_tpu.parallel import pipeline_lm_1f1b_grads as jax_1f1b
from edl_tpu.parallel import pipeline_lm_logits as jax_logits
from edl_tpu.parallel import pipeline_lm_loss as jax_loss
from edl_tpu.parallel import split_lm_params as jax_split
from edl_tpu.parallel.pipeline import pipeline_efficiency as jax_efficiency
from edl_tpu.parallel.pipeline_1f1b import _schedule as jax_schedule
from edl_tpu_torch import convert
from edl_tpu_torch.models import TransformerLM
from edl_tpu_torch.parallel import mesh as tmesh
from edl_tpu_torch.parallel import (
    lm_stage,
    merge_lm_params,
    pipeline_efficiency,
    pipeline_lm_1f1b_grads,
    pipeline_lm_loss,
    split_lm_params,
)
from edl_tpu_torch.parallel.pipeline_1f1b import _schedule
from test_torch_sharding_rules import Stage

CFG = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=4, d_ff=48)
GQA_CFG = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2, d_ff=64,
               num_kv_heads=2)
B, T = 8, 16
TOL_LOGITS = 2e-4
TOL_GQA = 2e-5
TOL_LOSS = 1e-5
TOL_GPIPE = dict(atol=2e-4, rtol=2e-3)
TOL_1F1B = dict(atol=3e-4, rtol=2e-3)
ADAM_LR, ADAM_STEPS = 1e-2, 3

# the port's runs: name -> (mesh, run, M, batch_axis)
RUNS = {
    "logits-pp2": ({"pp": 2, "dp": 2}, "logits", 4, None),
    "logits-pp4": ({"pp": 4}, "logits", 4, None),
    "gpipe-pp2-dp2": ({"pp": 2, "dp": 2}, "gpipe", 2, "dp"),
    "gpipe-pp4-m8": ({"pp": 4}, "gpipe", 8, None),
    "1f1b-pp2-m4": ({"pp": 2, "dp": 2}, "1f1b", 4, None),
    "1f1b-pp4-m4": ({"pp": 4}, "1f1b", 4, None),
    "1f1b-pp4-m8": ({"pp": 4}, "1f1b", 8, None),
    "1f1b-pp2-dp2": ({"pp": 2, "dp": 2}, "1f1b", 4, "dp"),
}


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


def _jax_model(cfg):
    return JaxLM(dtype=jnp.float32, attention_fn=attention_reference, **cfg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _data(seed, vocab=64, shape=(B, T)):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, vocab, shape).astype(np.int32),
            rs.randint(0, vocab, shape).astype(np.int32))


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jax_mesh(axes, devices=jax.devices()[:n])


def _flat_grads(model, split_grads):
    """A JAX split gradient as ``state_dict`` names -> arrays."""
    flat = convert.flatten(_np_tree(jax_merge(model, split_grads)))
    return {k.replace("/", "."): v for k, v in flat.items()}


@pytest.fixture(scope="module")
def case():
    model = _jax_model(CFG)
    x, y = _data(0)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(2),
                                          jnp.asarray(x))["params"])
    return model, params, x, y


@pytest.fixture(scope="module")
def runs(case, tmp_path_factory):
    """The port's runs in one launch of four gloo ranks, and the JAX
    references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("pipeline")
    model, params, x, y = case
    weights = str(tmp / "weights.npz")
    convert.save_npz(params, weights)
    data = str(tmp / "data.npz")
    np.savez(data, x=x, y=y)
    gmodel = _jax_model(GQA_CFG)
    gx, _ = _data(5, shape=(4, 8))
    gparams = _np_tree(jax.jit(gmodel.init)(jax.random.PRNGKey(0),
                                            jnp.asarray(gx))["params"])
    gweights = str(tmp / "gqa.npz")
    convert.save_npz(gparams, gweights)
    gdata = str(tmp / "gqa-data.npz")
    np.savez(gdata, x=gx)
    ops = []
    for name, (axes, run, m, batch_axis) in RUNS.items():
        ops.append({"op": "pp", "axes": axes, "weights": weights, "cfg": CFG,
                    "data": data, "M": m, "run": run,
                    "batch_axis": batch_axis, "out": str(tmp / (name + ".npz"))})
    ops.append({"op": "pp", "axes": {"pp": 2, "dp": 2}, "weights": gweights,
                "cfg": GQA_CFG, "data": gdata, "M": 2, "run": "logits",
                "out": str(tmp / "gqa.npz")})
    ops.append({"op": "pp", "axes": {"pp": 2, "dp": 2}, "weights": weights,
                "cfg": CFG, "data": data, "M": 2, "run": "adam",
                "batch_axis": "dp", "steps": ADAM_STEPS, "lr": ADAM_LR,
                "out": str(tmp / "adam.npz")})
    stage = Stage(tmp, "pipeline", 4, {"dp": 4}, ops)
    try:
        want = _references(model, params, x, y, gmodel, gparams, gx)
    finally:
        stage.wait()
    got = {}
    for name in list(RUNS) + ["gqa", "adam"]:
        got[name] = [dict(np.load(str(tmp / ("%s.%d.npz" % (name, r)))))
                     for r in range(4)]
    return got, want


def _references(model, params, x, y, gmodel, gparams, gx):
    """Every JAX number the tests hold the port against."""
    tok, tgt = jnp.asarray(x), jnp.asarray(y)
    want = {}
    for pp in (2, 4):
        mesh = _jmesh({"pp": pp, "dp": 8 // pp})
        split = jax_split(model, params, pp=pp)
        want["logits-pp%d" % pp] = np.asarray(jax.jit(
            lambda s, t: jax_logits(model, s, t, mesh, num_microbatches=4)
        )(split, tok))
    mesh = _jmesh({"pp": 2, "dp": 2})
    split = jax_split(model, params, pp=2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda s: jax_loss(model, s, tok, tgt, mesh, num_microbatches=2,
                           batch_axis="dp")))(split)
    want["gpipe-pp2-dp2"] = (float(loss), _flat_grads(model, grads))
    for name, pp, m, batch_axis in (("1f1b-pp2-m4", 2, 4, None),
                                    ("1f1b-pp4-m4", 4, 4, None),
                                    ("1f1b-pp4-m8", 4, 8, None),
                                    ("1f1b-pp2-dp2", 2, 4, "dp")):
        mesh = (_jmesh({"pp": 2, "dp": 2}) if batch_axis
                else _jmesh({"pp": pp, "dp": 8 // pp}))
        loss, grads = jax.jit(
            lambda s, t, g, mesh=mesh, m=m, ba=batch_axis: jax_1f1b(
                model, s, t, g, mesh, num_microbatches=m, batch_axis=ba)
        )(jax_split(model, params, pp=pp), tok, tgt)
        want[name] = (float(loss), _flat_grads(model, grads))
    want["gpipe-pp4-m8"] = want["1f1b-pp4-m8"]
    want["gqa"] = np.asarray(gmodel.apply({"params": gparams},
                                          jnp.asarray(gx)))
    # three Adam steps over GPipe's gradient on the JAX split
    mesh = _jmesh({"pp": 2, "dp": 2})
    tx = optax.adam(ADAM_LR)
    split = jax_split(model, params, pp=2)

    @jax.jit
    def step(s, opt):
        loss, g = jax.value_and_grad(
            lambda s: jax_loss(model, s, tok, tgt, mesh, num_microbatches=2,
                               batch_axis="dp"))(s)
        upd, opt = tx.update(g, opt, s)
        return optax.apply_updates(s, upd), opt, loss

    opt = tx.init(split)
    losses = []
    for _ in range(ADAM_STEPS):
        split, opt, loss = step(split, opt)
        losses.append(float(loss))
    want["adam"] = np.asarray(losses)
    return want


# -- without a process group ----------------------------------------------------


def test_schedule_matches_jax_exhaustively():
    """``_schedule`` equals the JAX one at every tick and rank for PP 1-8
    and M from PP to 33 (the JAX function jitted once over one grid of
    ticks and ranks, ``pp`` and ``M`` traced)."""
    grid_t = jnp.arange(2 * (33 + 8 - 1))[:, None]
    grid_r = jnp.arange(8)[None, :]
    decode = jax.jit(lambda pp, m: [jnp.broadcast_to(a, (grid_t.shape[0], 8))
                                    for a in jax_schedule(grid_t, grid_r,
                                                          pp, m)])
    for pp in range(1, 9):
        for m in range(pp, 34):
            want = [np.asarray(a) for a in decode(jnp.int32(pp),
                                                  jnp.int32(m))]
            for t in range(2 * (m + pp - 1)):
                for r in range(pp):
                    got = _schedule(t, r, pp, m)
                    assert got == tuple(type(g)(w[t, r]) for g, w in
                                        zip(got, want)), (pp, m, t, r)


def test_pipeline_efficiency_exact():
    for m in range(1, 40):
        for pp in range(1, 9):
            assert pipeline_efficiency(m, pp) == jax_efficiency(m, pp)


def test_split_merge_round_trip_and_jax_stage_params(case):
    """Split and merge are a selection and a union (exact); every rank's
    dict from the JAX ``LMStageParams`` merges into what the JAX
    ``merge_lm_params`` gives, and loads into ``TransformerLM``."""
    jmodel, params, _, _ = case
    model = TransformerLM(dtype=torch.float32, device="meta", **CFG)
    whole = convert.to_state_dict(params)
    for pp in (1, 2, 4):
        stages = split_lm_params(model, whole, pp)
        assert len(stages) == pp
        assert sorted(stages[0])[0] == "embed.embedding"
        assert "lm_head.kernel" in stages[-1]
        merged = merge_lm_params(model, stages)
        assert merged.keys() == whole.keys()
        for k in whole:
            assert torch.equal(merged[k], whole[k]), k
        split = _np_tree(jax_split(jmodel, params, pp=pp))
        from_jax = [convert.lm_stage_state_dict(split, r) for r in range(pp)]
        for r in range(pp):
            assert from_jax[r].keys() == stages[r].keys()
            stage = lm_stage(model, tmesh.Mesh({"pp": pp}, r, "cpu"))
            assert set(stage.state_dict()) == set(stages[r])
        want = convert.to_state_dict(_np_tree(jax_merge(jmodel, split)))
        got = merge_lm_params(model, from_jax)
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
    flat = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    flat.load_state_dict(merge_lm_params(model, split_lm_params(
        model, whole, 2)), strict=True)


def test_refusals():
    """The JAX package's refusals: a MoE LM, an indivisible depth, fewer
    microbatches than stages, an indivisible batch or microbatch; and the
    mesh's: pp beside tp, sp, ep, fsdp or mp."""
    model = TransformerLM(dtype=torch.float32, device="meta", **CFG)
    with pytest.raises(ValueError, match="divisible"):
        split_lm_params(model, {}, 3)
    moe = TransformerLM(dtype=torch.float32, device="meta", num_experts=2,
                        **CFG)
    with pytest.raises(ValueError, match="homogeneous"):
        lm_stage(moe, tmesh.make_mesh({"pp": 1}, device="cpu"))
    stage = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    stage.init_weights(torch.Generator().manual_seed(0))
    x = torch.zeros((B, T), dtype=torch.int64)
    pp2 = tmesh.Mesh({"pp": 2, "dp": 1}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="num_microbatches"):
        pipeline_lm_1f1b_grads(lm_stage(stage, pp2), x, x, pp2, 1)
    one = tmesh.make_mesh({"pp": 1}, device="cpu")
    st = lm_stage(stage, one)
    with pytest.raises(ValueError, match="not divisible into 3"):
        pipeline_lm_loss(st, x, x, one, 3)
    dp2 = tmesh.Mesh({"pp": 1, "dp": 2}, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="microbatch size 1 not divisible"):
        pipeline_lm_loss(st, x, x, dp2, 8, batch_axis="dp")
    with pytest.raises(ValueError, match="no 'dp' axis"):
        pipeline_lm_loss(st, x, x, tmesh.Mesh({"pp": 1}, 0, "cpu"), 2,
                         batch_axis="dp")
    for axis in ("tp", "sp", "ep", "fsdp", "mp"):
        with pytest.raises(NotImplementedError, match="pp > 1 beside"):
            tmesh.make_mesh({"pp": 2, axis: 2}, device="cpu")


# -- four gloo ranks against the JAX pipelines -----------------------------------


def _stage_grads(rec):
    return {k[len("grad/"):]: v for k, v in rec.items()
            if k.startswith("grad/")}


@pytest.mark.parametrize("name", ["logits-pp2", "logits-pp4"])
def test_logits_match_jax_pipeline(runs, name):
    got, want = runs
    for rec in got[name]:
        np.testing.assert_allclose(rec["logits"], want[name],
                                   atol=TOL_LOGITS, rtol=TOL_LOGITS)


@pytest.mark.parametrize("name", [n for n, r in RUNS.items()
                                  if r[1] != "logits"])
def test_loss_and_grads_match_jax(runs, name):
    """Every rank returns the whole loss; the union of the stages'
    gradients is the JAX gradient (GPipe's ``value_and_grad``, or 1F1B's;
    the pp 4 GPipe run against 1F1B's numbers at M 8)."""
    got, want = runs
    wloss, wgrads = want[name]
    tol = TOL_1F1B if RUNS[name][1] == "1f1b" else TOL_GPIPE
    seen = set()
    for rec in got[name]:
        np.testing.assert_allclose(float(rec["loss"]), wloss, rtol=TOL_LOSS)
        for k, g in _stage_grads(rec).items():
            np.testing.assert_allclose(g, wgrads[k], err_msg=k, **tol)
            seen.add(k)
    assert seen == set(wgrads)


def test_1f1b_holds_at_most_pp_microbatches(runs):
    """At pp 4 and M 8 a 1F1B rank holds at most 4 microbatches' stage
    inputs at once; a GPipe rank holds all 8 microbatches' graphs."""
    got, _ = runs
    onef = [int(r["live_max"]) for r in got["1f1b-pp4-m8"]]
    gpipe = [int(r["live_max"]) for r in got["gpipe-pp4-m8"]]
    assert max(onef) <= 4 and min(onef) >= 1, onef
    assert gpipe == [8, 8, 8, 8], gpipe


def test_gqa_pipeline_logits_match_flat_jax_model(runs):
    got, want = runs
    for rec in got["gqa"]:
        np.testing.assert_allclose(rec["logits"], want["gqa"], atol=TOL_GQA)


def test_adam_steps_match_optax(runs):
    """Three Adam steps over GPipe's gradient at pp 2 × dp 2: the losses
    of optax's on the JAX split; the two dp ranks of a stage agree."""
    got, want = runs
    for rec in got["adam"]:
        np.testing.assert_allclose(rec["loss"], want["adam"], rtol=TOL_LOSS)
    for a, b in ((0, 1), (2, 3)):
        for k, v in got["adam"][a].items():
            if k.startswith("param/"):
                np.testing.assert_array_equal(v, got["adam"][b][k])
