"""The CTR family (ROADMAP M17): edl_tpu_torch's DeepFM, its vocab-sharded
tables over ``mp``, the streaming AUC and DGC ``topk_compression`` against
edl_tpu's, on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``conftest.py``, its
persistent compilation cache off, calling ``edl_tpu.models.ctr``,
``edl_tpu.train.metrics`` and ``edl_tpu.train.compression`` directly. The
port's dp 2 × mp 2 stage is one launch of four gloo processes of
``tests/torch_lm_parallel_worker.py`` (op ``ctr_steps``). Tolerances
(fp32, summation order only):

- DeepFM's logits, BCE and accuracy from converted weights: 1e-5;
- two Adam steps against ``make_train_step`` (world 1, and dp 2 × mp 2
  with ``CTR_EMBEDDING_RULES``): losses 1e-5 relative; parameters 1e-3
  absolute (Adam's first steps normalise each gradient entry, so an entry
  near zero moves by up to the learning rate whatever its size);
- the AUC's histograms exactly, the AUC 1e-6, on streams with ties and
  both edge buckets (no probability within 1e-4 of a bucket edge,
  asserted, so a last-ulp sigmoid cannot move an example);
- ``topk_compression`` chained with SGD, three steps: parameters and
  residuals 1e-6;
- the threshold on more than 2^24 elements against ``numpy.percentile``:
  within one fp32 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models.ctr import CTR_EMBEDDING_RULES as JAX_RULES
from edl_tpu.models.ctr import DeepFM as JaxDeepFM
from edl_tpu.models.ctr import binary_cross_entropy_loss as jax_bce
from edl_tpu.parallel import make_mesh as jax_mesh
from edl_tpu.parallel import shard_batch as jax_shard_batch
from edl_tpu.parallel import shard_params_by_rules as jax_shard
from edl_tpu.train import create_state as jax_create_state
from edl_tpu.train import make_train_step as jax_train_step
from edl_tpu.train import metrics as jax_metrics
from edl_tpu.train.compression import topk_compression as jax_topk
from edl_tpu_torch import convert
from edl_tpu_torch.examples import ctr_train
from edl_tpu_torch.models import DeepFM, binary_cross_entropy_loss
from edl_tpu_torch.train import (
    adam,
    auc_compute,
    auc_init,
    auc_merge,
    auc_update,
    chain,
    create_state,
    make_train_step,
    sgd,
    topk_compression,
)
from edl_tpu_torch.train.compression import percentile_threshold
from test_torch_sharding_rules import Stage

CFG = dict(vocab_size=1000, embed_dim=8, num_fields=26, dense_features=13,
           mlp_dims=(32, 16))
B = 16
LR = 1e-3
TOL = 1e-5
TOL_PARAM = 1e-3
TOL_AUC = 1e-6
TOL_TOPK = 1e-6
EDGE_MARGIN = 1e-4


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


def _batch(seed, b=B):
    rs = np.random.RandomState(seed)
    sparse = rs.randint(0, CFG["vocab_size"], (b, 26)).astype(np.int32)
    dense = rs.randn(b, 13).astype(np.float32)
    labels = rs.randint(0, 2, (b,)).astype(np.int32)
    return sparse, dense, labels


@pytest.fixture(scope="module")
def case():
    model = JaxDeepFM(dtype=jnp.float32, **CFG)
    sparse, dense, labels = _batch(0)
    params = jax.jit(model.init)(jax.random.PRNGKey(1),
                                 (jnp.asarray(sparse), jnp.asarray(dense)))
    params = jax.tree.map(np.asarray, params["params"])
    # a wide table away from zero, so the first-order term counts
    params["wide"]["embedding"] = np.random.RandomState(2).randn(
        *params["wide"]["embedding"].shape).astype(np.float32) * 0.1
    return model, params, (sparse, dense, labels)


def _port(params):
    return convert.load_params(DeepFM(dtype=torch.float32, device="cpu",
                                      **CFG), params)


def test_deepfm_logits_and_loss_match_jax(case):
    model, params, (sparse, dense, labels) = case
    want = np.asarray(model.apply({"params": params},
                                  (jnp.asarray(sparse), jnp.asarray(dense))))
    got = _port(params)(torch.from_numpy(sparse), torch.from_numpy(dense))
    assert got.dtype == torch.float32 and got.shape == (B,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)
    wloss, wm = jax_bce(jnp.asarray(want), jnp.asarray(labels))
    loss, m = binary_cross_entropy_loss(torch.from_numpy(want.copy()),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(wloss), rtol=TOL)
    assert float(m["accuracy"]) == float(wm["accuracy"])


def test_bf16_deepfm_is_the_jax_models(case):
    """The default bf16 compute: both round the FM and MLP to bf16 at
    different points, so the logits agree to bf16's 2e-2 of their
    scale."""
    _, params, (sparse, dense, _) = case
    jmodel = JaxDeepFM(**CFG)
    want = np.asarray(jmodel.apply({"params": params},
                                   (jnp.asarray(sparse), jnp.asarray(dense))))
    model = convert.load_params(DeepFM(device="cpu", **CFG), params)
    got = model(torch.from_numpy(sparse), torch.from_numpy(dense))
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.detach().numpy() - want).max()) <= 2e-2 * scale


def _jax_steps(model, params, batches, mesh=None):
    state = jax_create_state(model, jax.random.PRNGKey(0),
                             (jnp.asarray(batches[0][0]),
                              jnp.asarray(batches[0][1])), optax.adam(LR))
    state = state.replace(params=jax.tree.map(jnp.asarray, params),
                          opt_state=optax.adam(LR).init(params))
    step = jax_train_step(jax_bce)
    losses = []
    if mesh is not None:
        with mesh:
            state = state.replace(
                params=jax_shard(mesh, state.params, JAX_RULES))
            for sparse, dense, labels in batches:
                batch = jax_shard_batch(mesh, ((sparse, dense), labels))
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))
    else:
        for sparse, dense, labels in batches:
            state, metrics = step(state, ((jnp.asarray(sparse),
                                           jnp.asarray(dense)),
                                          jnp.asarray(labels)))
            losses.append(float(metrics["loss"]))
    flat = convert.flatten(jax.tree.map(np.asarray, state.params))
    return losses, {k.replace("/", "."): v for k, v in flat.items()}


def test_two_adam_steps_match_jax(case):
    model, params, first = case
    batches = [first, _batch(3)]
    want_losses, want_params = _jax_steps(model, params, batches)
    port = _port(params)
    state = create_state(port, None, adam(LR), device="cpu")
    step = make_train_step(binary_cross_entropy_loss)
    for (sparse, dense, labels), want in zip(batches, want_losses):
        state, metrics = step(state, ((torch.from_numpy(sparse),
                                       torch.from_numpy(dense)),
                                      torch.from_numpy(labels)))
        np.testing.assert_allclose(float(metrics["loss"]), want, rtol=TOL)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name],
                                   atol=TOL_PARAM, err_msg=name)


def test_dp2_mp2_steps_match_jax_sharded_step(case, tmp_path):
    """Four gloo ranks at dp 2 × mp 2, the tables split over mp: each
    rank holds half of each table's rows, and two Adam steps on the
    global batch of 32 give the JAX step's losses on ``{"dp": 2, "mp":
    2}`` and its parameters."""
    model, params, _ = case
    sparse, dense, labels = _batch(7, 2 * B)
    weights = str(tmp_path / "w.npz")
    convert.save_npz(params, weights)
    data = str(tmp_path / "d.npz")
    np.savez(data, sparse=sparse, dense=dense, labels=labels)
    out = str(tmp_path / "ctr.npz")
    stage_op = {"op": "ctr_steps", "axes": {"dp": 2, "mp": 2},
                "weights": weights, "cfg": CFG, "data": data, "steps": 2,
                "lr": LR, "out": out}
    stage = Stage(tmp_path, "ctr", 4, {"dp": 4}, [stage_op])
    try:
        mesh = jax_mesh({"dp": 2, "mp": 2}, devices=jax.devices()[:4])
        want_losses, want_params = _jax_steps(
            model, params, [(sparse, dense, labels)] * 2, mesh)
    finally:
        stage.wait()
    recs = [np.load(str(tmp_path / ("ctr.%d.npz" % r))) for r in range(4)]
    half = CFG["vocab_size"] // 2
    for rec in recs:
        np.testing.assert_allclose(rec["loss"], want_losses, rtol=TOL)
        assert tuple(rec["shape/embedding"]) == (half, CFG["embed_dim"])
        assert tuple(rec["shape/wide"]) == (half, 1)
    for name, want in want_params.items():
        np.testing.assert_allclose(recs[0]["param/" + name], want,
                                   atol=TOL_PARAM, err_msg=name)


def _stream(seed, n):
    """Logits with ties (a 0.25 grid off zero), far-out values in both
    edge buckets, and labels; no probability within EDGE_MARGIN of an
    edge."""
    rs = np.random.RandomState(seed)
    logits = (np.round(rs.randn(n) * 3 * 4) + 0.5) / 4
    logits[:5] = -40.0    # probability 0: bucket 0
    logits[5:10] = 40.0   # probability 1: clipped into the last bucket
    logits = logits.astype(np.float32)
    labels = rs.randint(0, 2, n).astype(np.int32)
    scaled = 1.0 / (1.0 + np.exp(-logits.astype(np.float64))) * 2048
    inner = (scaled > 1) & (scaled < 2047)
    frac = np.abs(scaled - np.round(scaled))[inner]
    assert frac.min() > EDGE_MARGIN
    return logits, labels


def test_auc_matches_jax():
    jstate = jax_metrics.auc_init()
    tstate = auc_init(device="cpu")
    parts = []
    for seed in range(3):
        logits, labels = _stream(seed, 500)
        jstate = jax_metrics.auc_update(jstate, jnp.asarray(logits),
                                        jnp.asarray(labels))
        tstate = auc_update(tstate, torch.from_numpy(logits),
                            torch.from_numpy(labels))
        parts.append(auc_update(auc_init(device="cpu"),
                                torch.from_numpy(logits),
                                torch.from_numpy(labels)))
    np.testing.assert_array_equal(tstate.pos.numpy(), np.asarray(jstate.pos))
    np.testing.assert_array_equal(tstate.neg.numpy(), np.asarray(jstate.neg))
    assert tstate.pos[0] + tstate.neg[0] >= 5
    assert tstate.pos[-1] + tstate.neg[-1] >= 5
    want = float(jax_metrics.auc_compute(jstate))
    assert abs(float(auc_compute(tstate)) - want) <= TOL_AUC
    merged = auc_merge(auc_merge(parts[0], parts[1]), parts[2])
    np.testing.assert_array_equal(merged.pos.numpy(), tstate.pos.numpy())
    assert abs(float(auc_compute(merged)) - want) <= TOL_AUC
    empty = float(jax_metrics.auc_compute(jax_metrics.auc_init()))
    assert float(auc_compute(auc_init(device="cpu"))) == empty


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.5, 1.0])
def test_topk_compression_matches_optax_chain(ratio):
    """Three steps of ``chain(topk_compression(r), sgd)`` against
    ``optax.chain(topk_compression(r), optax.sgd)``: the [64, 32] and
    [300] tensors compress (at 0.01 the [50] one passes dense, below
    1/ratio), ratio 1 passes everything."""
    rs = np.random.RandomState(int(ratio * 100))
    shapes = {"w": (64, 32), "v": (300,), "b": (50,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jtx = optax.chain(jax_topk(ratio), optax.sgd(0.1))
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jtx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    ttx = chain(topk_compression(ratio), sgd(0.1))
    topt = ttx.init(tparams.values())
    for g in grads:
        upd, jopt = jtx.update(jax.tree.map(jnp.asarray, g), jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        ttx.update(topt)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]),
                                       atol=TOL_TOPK, err_msg=k)
    resid = jopt[0].residual
    for i, k in enumerate(tparams):
        np.testing.assert_allclose(topt.states[0].residual[i].numpy(),
                                   np.asarray(resid[k]), atol=TOL_TOPK)
    if ratio == 1.0:
        assert all(not r.any() for r in topt.states[0].residual)


@pytest.mark.parametrize("ratio", [0.0, -0.5, 1.5])
def test_topk_compression_refuses_ratios(ratio):
    with pytest.raises(ValueError, match="ratio must be in"):
        topk_compression(ratio)
    with pytest.raises(ValueError, match="ratio must be in"):
        jax_topk(ratio)


def test_threshold_above_2_24_elements_matches_numpy():
    """numpy's linear percentile of 17 M |g| (torch.quantile refuses more
    than 2^24), within one fp32 ulp, at DGC's 99th and a grid point."""
    x = np.abs(np.random.RandomState(9).randn(17_000_000).astype(np.float32))
    t = torch.from_numpy(x)
    for q in (99.0, 50.0, 100.0 * (1.0 - 0.01)):
        want = np.float32(np.percentile(x, q))
        got = percentile_threshold(t, q)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(want)) <= float(np.spacing(want)), q


def test_example_auc_rises_on_the_cpu(capsys):
    """The ported example at a small vocab: every 50 steps a line, and the
    final train AUC above the first reading and above 0.51."""
    auc = ctr_train.main(["--device", "cpu", "--vocab", "1000",
                          "--steps", "100"])
    lines = capsys.readouterr().out.splitlines()
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [ln.split()[1] for ln in steps] == ["50", "100"]
    first = float(steps[0].split()[-1])
    assert lines[-1] == "final train-auc %.4f" % auc
    assert auc > first and auc > 0.51, lines
