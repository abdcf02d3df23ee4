"""Training a batch-norm model: edl_tpu_torch's step, stage, trainer, bench
and the flagship example against edl_tpu's.

The same numpy weights (flax variables converted by ``edl_tpu_torch.
convert``) and the same numpy batches go through the JAX step or trainer
and the port's, fp32 on the CPU. Tolerances: parameters, running averages
and losses within 1e-4 relative (``max|port - jax| / max(1, max|jax|)``)
after the steps compared: both sides compute in fp32 and differ in
summation order only, which two SGD steps at lr 0.1 with momentum carry
into the weights; the global norms of the numerics bundle 1e-4 relative.

Child processes (the gloo stage, the trainer's workers, the bench and the
example) run in sessions of their own and are killed with their session
in ``finally``; every wait has a timeout.
"""

import functools
import hashlib
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.checkpoint import AdjustRegistry as JaxAdjustRegistry
from edl_tpu.checkpoint import linear_scaled_lr as jax_linear_scaled_lr
from edl_tpu.models import resnet as jresnet
from edl_tpu.obs import numerics as jnumerics
from edl_tpu.train import ElasticTrainer as JaxElasticTrainer
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.models import resnet as tresnet
from edl_tpu_torch.obs import numerics as tnumerics
from edl_tpu_torch.obs import profile as tprofile
from edl_tpu_torch.train import step as tstep
from edl_tpu_torch.train.optim import sgd
from edl_tpu_torch.utils.net import find_free_ports
from test_torch_replicate import rigged, store  # noqa: F401  (fixtures)
from test_torch_resnet import flax_variables, images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
CHILD_TIMEOUT = 120
N_CLASSES = 10


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


@pytest.fixture()
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    return monkeypatch


def _models():
    return (jresnet.ResNet(stage_sizes=(1, 1), width=8,
                           num_classes=N_CLASSES, dtype=jnp.float32),
            tresnet.ResNet((1, 1), width=8, num_classes=N_CLASSES,
                           dtype=torch.float32))


def _labels(n, seed=2):
    return np.random.RandomState(seed).randint(0, N_CLASSES, n).astype(np.int32)


def _skewed(batch, size, seed):
    """Images whose two halves have different means (+1 and -1): a BN
    over one half alone normalises with the wrong statistics."""
    x = images(batch, size, seed)
    x[: batch // 2] += 1.0
    x[batch // 2:] -= 1.0
    return x


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return float(err / max(1.0, np.abs(want).max()))


def _jax_state(jmodel, v, tx):
    """The JAX ``TrainState`` of variables ``v`` (built directly: an eager
    ``model.init`` would compile every op of the model once more)."""
    params = jax.tree.map(jnp.asarray, v["params"])
    return jstep.TrainState(
        step=jnp.zeros((), jnp.int32), apply_fn=jmodel.apply, params=params,
        tx=tx, opt_state=tx.init(params),
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]))


def _assert_state_close(tmodel, jstate, tol=TOL):
    back = convert.to_flax(tresnet_state(tmodel))
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    errs = jax.tree.map(lambda a, b: _rel(a, np.asarray(b)), back, want)
    worst = max(jax.tree.leaves(errs))
    assert worst <= tol, worst


def tresnet_state(model):
    """The model's state dict without a data-parallel prefix."""
    return {k.removeprefix("module."): v for k, v in model.state_dict().items()}


def _kill(procs):
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait(timeout=30)


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _spawn(cmd, log, **env):
    with open(log, "w") as fh:
        return subprocess.Popen(cmd, env=_child_env(**env), cwd=REPO,
                                stdout=fh, stderr=subprocess.STDOUT,
                                start_new_session=True)


def _wait_ok(procs, logs):
    try:
        for proc in procs:
            proc.wait(timeout=CHILD_TIMEOUT)
    finally:
        _kill(procs)
    for proc, log in zip(procs, logs):
        with open(log) as fh:
            text = fh.read()
        assert proc.returncode == 0, text[-3000:]


# -- the step ----------------------------------------------------------------


@pytest.mark.parametrize("numerics", [False, True],
                         ids=["plain", "numerics"])
def test_two_steps_match_jax_step(numerics, clean_env):
    """Two ``make_train_step`` steps of ``sgd(0.1, momentum=0.9)``:
    parameters, running averages and losses against the JAX step. With
    ``numerics=True`` (GNS halves on by default) neither package splits a
    batch-stats model's batch: neither bundle has ``half_sq``."""
    jmodel, tmodel = _models()
    x1, x2 = images(4, 32, 1), images(4, 32, 3)
    y1, y2 = _labels(4, 2), _labels(4, 4)
    v = flax_variables(jmodel, x1)
    convert.load_params(tmodel, v)
    jstate = _jax_state(jmodel, v, optax.sgd(0.1, momentum=0.9))
    jrun = jstep.make_train_step(jstep.cross_entropy_loss, {"train": True},
                                 donate=False, numerics=numerics)
    state = tstep.create_state(tmodel, None, sgd(0.1, momentum=0.9),
                               device="cpu")
    trun = tstep.make_train_step(tstep.cross_entropy_loss, {"train": True},
                                 numerics=numerics)
    for x, y in ((x1, y1), (x2, y2)):
        jstate, jm = jrun(jstate, (x, y))
        state, tm = trun(state, (torch.from_numpy(x),
                                 torch.from_numpy(y).long()))
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= TOL
        _assert_state_close(state.apply_fn, jstate)
        if numerics:
            jb = jm[jnumerics.METRICS_KEY]
            tb = tm[tnumerics.METRICS_KEY]
            assert "half_sq" not in jb and "half_sq" not in tb
            for key in ("loss", "grad_norm", "param_norm", "update_ratio"):
                assert float(tb[key]) == pytest.approx(float(jb[key]),
                                                       rel=TOL), key
            assert float(tb["nonfinite"]) == float(jb["nonfinite"]) == 0
    assert state.apply_fn.training


def test_masked_step_refuses_batch_stats_models():
    jmodel, tmodel = _models()
    x = images(2, 32)
    v = flax_variables(jmodel, x)
    jstate = _jax_state(jmodel, v, optax.sgd(0.1))
    mask = np.ones((2,), bool)
    with pytest.raises(ValueError, match="batch_stats"):
        jstep.make_masked_train_step(jstep.cross_entropy_loss,
                                     {"train": True})(
            jstate, (x, _labels(2)), mask)
    state = tstep.create_state(tmodel, None, sgd(0.1), device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        tstep.make_masked_train_step(tstep.cross_entropy_loss,
                                     {"train": True})(
            state, (torch.from_numpy(x), torch.from_numpy(_labels(2)).long()),
            torch.from_numpy(mask))


def test_eval_steps_use_running_averages_and_donate_false_copies_buffers():
    """The eval steps normalise with the running averages (the JAX eval
    step applies the stored ``batch_stats``; the train kwargs are the
    trainer's), and a ``donate=False`` step leaves the given state's
    buffers as they were."""
    jmodel, tmodel = _models()
    x, y = images(4, 32), _labels(4)
    v = flax_variables(jmodel, x)
    convert.load_params(tmodel, v)
    jstate = _jax_state(jmodel, v, optax.sgd(0.1))
    want = jstep.make_eval_step(jstep.cross_entropy_loss,
                                {"train": False})(jstate, (x, y))
    state = tstep.create_state(tmodel, None, sgd(0.1), device="cpu")
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    got = tstep.make_eval_step(tstep.cross_entropy_loss,
                               {"train": True})(state, batch)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=TOL)
    mask = torch.ones(4, dtype=torch.bool)
    got, n = tstep.make_masked_eval_step(tstep.cross_entropy_loss,
                                         {"train": True})(state, batch, mask)
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=TOL)
    before = {k: t.clone() for k, t in tmodel.named_buffers()}
    new, _ = tstep.make_train_step(tstep.cross_entropy_loss, {"train": True},
                                   donate=False)(state, batch)
    assert new.apply_fn is not tmodel
    assert all(torch.equal(t, before[k]) for k, t in tmodel.named_buffers())
    assert not all(torch.equal(t, before[k])
                   for k, t in new.apply_fn.named_buffers())


def test_step_cost_counts_the_convolutions():
    """``CostCounter`` over one train step: FlopCounterMode's formulas,
    2 FLOPs per multiply-add, for every conv forward, its weight gradient
    and its input gradient (none for the first conv, whose input needs no
    gradient), and the head's three products."""
    _jm, tmodel = _models()
    x, y = torch.from_numpy(images(4, 32)), torch.from_numpy(_labels(4)).long()
    tmodel.init_weights(torch.Generator().manual_seed(0))
    state = tstep.create_state(tmodel, None, sgd(0.1), device="cpu")
    outs = {}
    hooks = [m.register_forward_hook(
        lambda m, i, o, name=name: outs.__setitem__(name, o.shape))
        for name, m in tmodel.named_modules() if isinstance(m, tresnet.Conv)]
    cost, _ = tprofile.step_cost(
        tstep.make_train_step(tstep.cross_entropy_loss, {"train": True}),
        state, (x, y))
    for h in hooks:
        h.remove()
    want = 0
    for name, shape in outs.items():
        k = dict(tmodel.named_modules())[name].kernel
        fwd = 2 * shape.numel() * k[0].numel()
        want += fwd * (2 if name == "Conv_0" else 3)
    d, c = tmodel.Dense_0.kernel.shape
    want += 3 * 2 * 4 * d * c
    assert cost["flops"] == want
    assert any("convolution_backward" in op for op in cost["by_op"])
    assert tprofile.roofline(cost, "cpu", tprofile.peak_flops("cpu")) == {}


# -- stage-wide batch norm over a gloo group ---------------------------------

_STAGE_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from edl_tpu_torch import convert
from edl_tpu_torch.models.resnet import ResNet
from edl_tpu_torch.parallel import data_parallel, make_mesh
from edl_tpu_torch.train import create_state, cross_entropy_loss, sgd
from edl_tpu_torch.train import make_train_step

rank, ports, data, out = int(sys.argv[1]), sys.argv[2].split(","), *sys.argv[3:5]
model = ResNet((1, 1), width=8, num_classes=10, dtype=torch.float32)
convert.load_params(model, data + ".weights.npz")
state = create_state(model, None, sgd(0.1, momentum=0.9), device="cpu")
step = make_train_step(cross_entropy_loss, {"train": True})
batches = np.load(data + ".batches.npz")
for i, port in enumerate(ports):
    # a new group each step, as a hot restage joins its new stage
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + port,
                            world_size=2, rank=rank)
    state.apply_fn = data_parallel(model, make_mesh(device="cpu"))
    x, y = batches["x%d" % i], batches["y%d" % i]
    half = x.shape[0] // 2
    rows = slice(rank * half, (rank + 1) * half)
    state, m = step(state, (torch.from_numpy(x[rows]),
                            torch.from_numpy(y[rows]).long()))
    loss = torch.stack([m["loss"]])
    dist.all_reduce(loss)
    dump = {k: v.numpy() for k, v in model.state_dict().items()}
    dump["loss"] = loss.numpy() / 2
    np.savez(out % (rank, i), **dump)
    dist.destroy_process_group()
"""


def test_stage_wide_batch_norm_over_gloo(tmp_path):
    """Two ranks over gloo, each with half of a batch whose halves have
    different means: one step equals the JAX step on the whole batch, and
    the ranks' buffers are equal bit for bit. Then the group is destroyed
    and joined again in the same processes and the next step holds the
    same checks (the group is resolved at every forward)."""
    jmodel, tmodel = _models()
    xs = [_skewed(8, 32, 1), _skewed(8, 32, 5)]
    ys = [_labels(8, 2), _labels(8, 6)]
    v = flax_variables(jmodel, xs[0])
    data = str(tmp_path / "data")
    convert.save_npz(v, data + ".weights.npz")
    np.savez(data + ".batches.npz", x0=xs[0], y0=ys[0], x1=xs[1], y1=ys[1])
    out = str(tmp_path / "out.%d.%d.npz")
    ports = ",".join(str(p) for p in find_free_ports(2))
    logs = [str(tmp_path / ("rank%d.log" % r)) for r in range(2)]
    procs = [_spawn([sys.executable, "-c", _STAGE_WORKER, str(r), ports, data,
                     out], logs[r]) for r in range(2)]
    _wait_ok(procs, logs)

    jstate = _jax_state(jmodel, v, optax.sgd(0.1, momentum=0.9))
    jrun = jstep.make_train_step(jstep.cross_entropy_loss, {"train": True},
                                 donate=False)
    for i in range(2):
        jstate, jm = jrun(jstate, (xs[i], ys[i]))
        ranks = [dict(np.load(out % (r, i))) for r in range(2)]
        for key in ranks[0]:
            if key.endswith(".mean") or key.endswith(".var"):
                np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        assert _rel(ranks[0].pop("loss"), float(jm["loss"])) <= TOL
        tmodel.load_state_dict({k: torch.from_numpy(a)
                                for k, a in ranks[0].items()})
        _assert_state_close(tmodel, jstate)


# -- the checkpoint carries the buffers ----------------------------------------


def _trained_state(seed):
    _jm, model = _models()
    model.init_weights(torch.Generator().manual_seed(seed))
    state = tstep.create_state(model, None, sgd(0.1, momentum=0.9,
                                                nesterov=True), device="cpu")
    step = tstep.make_train_step(tstep.cross_entropy_loss, {"train": True})
    x = torch.from_numpy(_skewed(4, 32, seed))
    state, _ = step(state, (x, torch.from_numpy(_labels(4, seed)).long()))
    return state


def _sd(state):
    return {k: v.clone() for k, v in state.apply_fn.state_dict().items()}


def test_restores_bring_the_buffers_back(rigged):
    """A version of a BN model restores its running averages (and its
    parameters) bit for bit: into the kept module of a hot restage (its
    buffers moved on since the save), from the local tier; and into a
    fresh pod's new model, from the peer tier (the replica a holder got
    from the saver)."""
    from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
    from edl_tpu_torch.checkpoint import replicate as repl
    from edl_tpu_torch.checkpoint.manager import _M_RESTORES

    state = _trained_state(0)
    saved = _sd(state)
    mngr = CheckpointManager(rigged.durable, local_dir=str(rigged.tmp / "lA"))
    try:
        mngr.save(state, TrainStatus(epoch=0, step=1, world_size=1))
        mngr.wait()
        assert mngr._replicator.flush(15.0)
        with torch.no_grad():  # the kept module trains on past the save
            for buf in state.apply_fn.buffers():
                buf.add_(1.0)
        kept, status = mngr.restore(state)
        assert status.step == 1 and kept is state
    finally:
        mngr.close()
    got = _sd(kept)
    assert all(torch.equal(got[k], saved[k]) for k in saved)
    assert repl.newest_replicated_step(rigged.client, rigged.job) == 1

    os.environ["EDL_POD_ID"] = "podC"  # a new pod, no local version
    fresh = _trained_state(1)
    peer = _M_RESTORES.value(tier="peer")
    mngr = CheckpointManager(rigged.durable, local_dir=str(rigged.tmp / "lC"))
    try:
        restored, status = mngr.restore(fresh)
    finally:
        mngr.close()
    assert status.step == 1 and _M_RESTORES.value(tier="peer") == peer + 1
    got = _sd(restored)
    assert all(torch.equal(got[k], saved[k]) for k in saved)


# -- the elastic trainer, world 2 then 1 -------------------------------------

_TRAINER_WORKER = r"""
import hashlib, json, os, sys
import numpy as np, torch
from torch.distributed.checkpoint.state_dict import get_model_state_dict
from edl_tpu_torch import convert
from edl_tpu_torch.checkpoint import manager
from edl_tpu_torch.models.resnet import ResNet
from edl_tpu_torch.train import (AdjustRegistry, ElasticTrainer,
                                 cross_entropy_loss, linear_scaled_lr, sgd)

weights, data, ckpt, epochs, out = sys.argv[1:6]
rank = int(os.environ["EDL_WORKER_RANK"])
world = int(os.environ["EDL_NUM_WORKERS"])
batches = np.load(data)

def digest(module):
    sd = get_model_state_dict(module)
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes()
                              ).hexdigest() for k, v in sorted(sd.items())}

rec = {}
restore = manager.CheckpointManager.restore
def recording(self, template, step=None):
    state, status = restore(self, template, step)
    if status is not None:
        rec["restored"] = digest(state.apply_fn)
    return state, status
manager.CheckpointManager.restore = recording

def data_fn(epoch):
    for i in range(2):
        x, y = batches["x%d_%d" % (epoch, i)], batches["y%d_%d" % (epoch, i)]
        half = x.shape[0] // world
        yield x[rank * half:(rank + 1) * half], y[rank * half:(rank + 1) * half]

model = ResNet((1, 1), width=8, num_classes=10, dtype=torch.float32)
convert.load_params(model, weights)
adjusts = AdjustRegistry()
adjusts.register(linear_scaled_lr(0.1, 1))
losses = {}
state = ElasticTrainer(
    model, lambda o: sgd(o["lr"], momentum=0.9, nesterov=True),
    cross_entropy_loss,
    ckpt_dir=ckpt, adjusts=adjusts, apply_kwargs={"train": True}, seed=None,
    log=False, device="cpu",
).fit(data_fn, int(epochs),
      on_epoch_end=lambda e, m: losses.__setitem__(e, float(m["loss"])))
rec.update(losses=losses, final=digest(state.apply_fn), step=int(state.step))
with open(out % rank, "w") as fh:
    json.dump(rec, fh)
"""


def _run_stage(tmp_path, world, epochs, args, tag):
    port = find_free_ports(1)[0]
    out = str(tmp_path / (tag + ".%d.json"))
    logs = [str(tmp_path / ("%s-%d.log" % (tag, r))) for r in range(world)]
    procs = [_spawn(
        [sys.executable, "-c", _TRAINER_WORKER, *args, str(epochs), out],
        logs[r], EDL_JOB_ID="rn", EDL_POD_ID="pod-%d" % r,
        EDL_STAGE="stage-" + tag, EDL_WORKER_RANK=str(r),
        EDL_NUM_WORKERS=str(world), EDL_COORDINATOR="127.0.0.1:%d" % port,
    ) for r in range(world)]
    _wait_ok(procs, logs)
    recs = []
    for r in range(world):
        with open(out % r) as fh:
            recs.append(json.load(fh))
    return recs


def test_trainer_two_to_one_matches_jax_trainer(tmp_path, clean_env):
    """``ElasticTrainer`` with ``apply_kwargs={"train": True}`` and SGD
    with Nesterov momentum (the flagship job's): two gloo workers train epochs 0-1 (lr 0.2 under
    ``linear_scaled_lr``) and checkpoint, their buffers equal bit for
    bit; one worker resumes at world 1 (lr 0.1), its restored parameters
    and buffers equal bit for bit to what the world-2 stage saved, and
    trains epochs 2-3. Per-epoch losses against the JAX trainer on the
    global batches in one process."""
    jmodel, _ = _models()
    sample = np.zeros((4, 32, 32, 3), np.float32)
    v = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                      sample))
    weights = str(tmp_path / "init.npz")
    convert.save_npz(v, weights)
    batches = {}
    for epoch in range(4):
        for i in range(2):
            batches["x%d_%d" % (epoch, i)] = _skewed(8, 32, 10 * epoch + i)
            batches["y%d_%d" % (epoch, i)] = _labels(8, 10 * epoch + i)
    data = str(tmp_path / "batches.npz")
    np.savez(data, **batches)
    args = [weights, data, str(tmp_path / "ckpt")]
    first = _run_stage(tmp_path, 2, 2, args, "w2")
    second = _run_stage(tmp_path, 1, 4, args, "w1")
    assert first[0]["final"] == first[1]["final"]
    assert second[0]["restored"] == first[0]["final"]
    assert second[0]["step"] == 8
    got = {int(e): l for r in (first[0], second[0])
           for e, l in r["losses"].items()}

    def data_fn(epoch):
        for i in range(2):
            yield batches["x%d_%d" % (epoch, i)], batches["y%d_%d" % (epoch, i)]

    want = {}
    adjusts = JaxAdjustRegistry()
    adjusts.register(jax_linear_scaled_lr(0.1, 1))
    for world, epochs in (("2", 2), ("1", 4)):
        clean_env.setenv("EDL_NUM_WORKERS", world)
        JaxElasticTrainer(
            jmodel, lambda o: optax.sgd(o["lr"], momentum=0.9, nesterov=True),
            jstep.cross_entropy_loss, sample_input=sample, adjusts=adjusts,
            apply_kwargs={"train": True}, ckpt_dir=str(tmp_path / "jax"),
            log=False,
        ).fit(data_fn, epochs, on_epoch_end=lambda e, m: want.setdefault(
            e, float(m["loss"])))
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for epoch in want:
        assert _rel(got[epoch], want[epoch]) <= TOL, (epoch, got, want)


# -- the bench and the example -----------------------------------------------

MEASURE_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "batch",
                "steps", "input", "remat", "numerics", "step_ms", "roofline"}


def _run_cli(args, tmp_path, timeout=CHILD_TIMEOUT, **env):
    log = str(tmp_path / "cli.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, *args], env=_child_env(**env), cwd=REPO,
            stdout=subprocess.PIPE, stderr=err, text=True,
            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        _kill([proc])
    with open(log) as fh:
        assert proc.returncode == 0, fh.read()[-3000:]
    return out


def test_bench_cpu_debug_and_unavailable(tmp_path):
    out = _run_cli(["-m", "edl_tpu_torch.tools.bench", "--device", "cpu"],
                   tmp_path)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["metric"] == "resnet50_vd_train_throughput_cpu_debug"
    assert MEASURE_KEYS <= set(rec) and rec["value"] > 0
    assert rec["vs_baseline"] == 0.0 and np.isfinite(rec["loss"])
    assert rec["roofline"].startswith("not measured")
    if torch.cuda.is_available():
        return  # the honest-unavailable record needs a machine without one
    out = _run_cli(["-m", "edl_tpu_torch.tools.bench"], tmp_path)
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["metric"] == "resnet50_vd_train_throughput_gpu_unavailable"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0


def test_resnet_collective_example_runs(tmp_path):
    """The port's flagship example on the CPU: ResNet50_vd at 32x32,
    batch 8, one epoch of one step, the rank-0 epoch line and the epoch's
    checkpoint (the resume path is the trainer test's)."""
    ckpt = str(tmp_path / "ckpt")
    script = os.path.join(REPO, "edl_tpu_torch", "examples",
                          "resnet_collective.py")
    out = _run_cli([script, "--device", "cpu", "--steps_per_epoch", "1",
                    "--epochs", "1"], tmp_path, EDL_CKPT_PATH=ckpt)
    assert out.startswith("epoch 0 loss ")
    assert np.isfinite(float(out.split()[3]))
    assert sorted(os.listdir(ckpt)) == ["1"]


def test_fsdp_axis_of_size_one_keeps_the_model_whole():
    """``{"dp": -1, "fsdp": 1}`` (the flagship job's mesh): the model
    stays whole on the mesh's device; a mesh without the axis still
    refuses, naming ROADMAP item 5."""
    from edl_tpu_torch.parallel import make_mesh, shard_params_fsdp

    mesh = make_mesh({"dp": -1, "fsdp": 1}, device="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1}
    _jm, tmodel = _models()
    tmodel.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    assert shard_params_fsdp(mesh, tmodel) is tmodel
    assert all(torch.equal(v, before[k])
               for k, v in tmodel.state_dict().items())
    with pytest.raises(NotImplementedError, match="item 5"):
        shard_params_fsdp(make_mesh(device="cpu"), tmodel)
