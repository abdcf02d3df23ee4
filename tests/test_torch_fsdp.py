"""FSDP (ROADMAP M5): edl_tpu_torch's sharded parameters and optimizer
state against edl_tpu's, on the CPU.

The port's stages are gloo processes of ``tests/torch_fsdp_worker.py`` (or
of ``ElasticTrainer`` workers), each in a session of its own, killed with
its session in ``finally``; every wait has a timeout. The JAX side runs on
the 8 virtual CPU devices of ``conftest.py``, its persistent compilation
cache off. Tolerances, each relative (``max|got - want| / max(1,
max|want|)`` for arrays):

- ``_fsdp_spec``: the same spec as the JAX function, exactly;
- the dp x fsdp ResNet step (``__graft_entry__.py:70-86``): loss,
  gathered parameters, momentum and ``batch_stats`` after two SGD steps
  within 1e-5 of the JAX step on a ``{"dp": 2, "fsdp": 2}`` mesh (fp32;
  the two differ in summation order only);
- ``ElasticTrainer(fsdp=True)`` across a 2 -> 1 and a 1 -> 2 resize:
  per-epoch losses within 1e-4 of ``edl_tpu``'s trainer (the tolerance of
  ``test_torch_elastic.py``);
- sharded checkpoints: exact, across fsdp sizes, a DDP version, async
  saves and the peer tier;
- hot restage under fsdp: hot = cold within 1e-6;
- the numerics bundle at fsdp 2 against world 1 on the same global
  batch: within 1e-6 (the shards' sums of squares are added over the
  group before the root: float32 reassociation only); the memory plan's
  state bytes at fsdp 2 at most 0.55 of fsdp 1's.
"""

import json
import os
import shutil
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.parallel import mesh as jmesh
from edl_tpu.train import ElasticTrainer as JaxElasticTrainer
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.checkpoint import replicate as repl
from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.parallel import mesh as tmesh
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.utils.net import find_free_ports
from test_torch_launch import Rig, churn
from test_torch_replicate import ChildStore
from test_torch_resnet import flax_variables
from test_torch_resnet_train import (
    REPO, _jax_state, _labels, _models, _rel, _skewed, _spawn, _wait_ok)

TOL_STEP = 1e-5
TOL_TRAINER = 1e-4
TOL_HOT_VS_COLD = 1e-6
TOL_BUNDLE = 1e-6
PLAN_SHARE = 0.55
WORKER = os.path.join(REPO, "tests", "torch_fsdp_worker.py")


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


def _stage(tmp_path, tag, world, ops, axes=None, env=None, group=False):
    """One port stage of ``world`` gloo ranks running ``ops``; the dump of
    its last ``dump`` op."""
    cfg = {"world": world, "port": find_free_ports(1)[0], "axes": axes,
           "env": env, "group": group, "ops": ops}
    path = str(tmp_path / ("%s.json" % tag))
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    logs = [str(tmp_path / ("%s-%d.log" % (tag, r))) for r in range(world)]
    _wait_ok([_spawn([sys.executable, WORKER, path, str(r)], logs[r])
              for r in range(world)], logs)
    dumps = [op["out"] for op in ops if op["op"] == "dump"]
    return dict(np.load(dumps[-1])) if dumps else None


def _flax_tree(dump, prefix):
    """The dump's ``prefix`` entries as a flax tree (conv kernels HWIO)."""
    sd = {k[len(prefix):].removesuffix("/momentum_buffer"): torch.from_numpy(v)
          for k, v in dump.items() if k.startswith(prefix)}
    return convert.to_flax(sd)


# -- (i) the placement ---------------------------------------------------------

SPECS = [((), 2), ((1,), 2), ((7,), 2), ((8,), 8), ((8,), 3), ((5, 7), 2),
         ((6, 4), 2), ((4, 6), 4), ((16, 16), 4), ((2, 3), 3), ((1, 8), 8),
         ((4, 4, 4), 2), ((3, 3, 8, 16), 2), ((16, 8, 3, 3), 2),
         ((3, 3, 3, 16), 4), ((9, 6, 6), 3), ((2048, 1000), 8),
         ((1000,), 8), ((12, 10), 5), ((3, 3), 1)]


@pytest.mark.parametrize("shape,size", SPECS,
                         ids=["%s-%d" % ("x".join(map(str, s)) or "scalar", n)
                              for s, n in SPECS])
def test_fsdp_spec_matches_jax(shape, size):
    """The dim the port shards (exactly the JAX function's spec: the
    largest dim the axis divides, the first of equal ones, else
    replicated); FSDP2's placement is that dim, or dim 0 where the JAX
    spec replicates."""
    want = tuple(jmesh._fsdp_spec(shape, size, "fsdp"))
    assert tmesh._fsdp_spec(shape, size) == want
    if shape:
        dim = tmesh.fsdp_placement(shape, size).dim
        assert dim == (want.index("fsdp") if want else 0)


def test_mesh_axes_and_refusals():
    """Without a process group: one rank, ``-1`` fills, axes of size 1 are
    kept; tp, sp and ep are axes of the mesh now (M12, M14, M15: at 2 they
    do not cover one rank), and fsdp does not combine with tp, sp or ep;
    nor pp and mp with anything but dp."""
    mesh = tmesh.make_mesh({"fsdp": -1}, device="cpu")
    assert mesh.shape == {"dp": 1, "fsdp": 1} and mesh.device_mesh is None
    assert (mesh.dp_rank, mesh.dp_size, mesh.fsdp_rank) == (0, 1, 0)
    mesh = tmesh.make_mesh({"sp": 1, "tp": -1, "dp": 1}, device="cpu")
    assert list(mesh.shape) == ["dp", "tp", "sp"]
    assert (mesh.tp_rank, mesh.sp_rank, mesh.group("tp")) == (0, 0, None)
    for axis in ("tp", "sp", "ep"):
        with pytest.raises(ValueError, match="do not cover 1 ranks"):
            tmesh.make_mesh({"dp": 1, axis: 2}, device="cpu")
    mesh = tmesh.make_mesh({"ep": -1, "sp": 1, "dp": 1}, device="cpu")
    assert list(mesh.shape) == ["dp", "sp", "ep"]
    assert (mesh.ep_rank, mesh.ep_size, mesh.group("ep")) == (0, 1, None)
    for axis in ("tp", "sp", "ep"):
        with pytest.raises(NotImplementedError,
                           match="fsdp > 1 beside tp, sp or ep"):
            tmesh.make_mesh({"fsdp": 2, axis: 2}, device="cpu")
    with pytest.raises(ValueError, match="only one axis"):
        tmesh.make_mesh({"dp": -1, "fsdp": -1}, device="cpu")
    # pp is the outermost axis and mp the innermost (M16, M17); each
    # combines with dp only
    mesh = tmesh.make_mesh({"dp": -1, "pp": 1}, device="cpu")
    assert list(mesh.shape) == ["pp", "dp"]
    assert (mesh.pp_rank, mesh.pp_size, mesh.group("pp")) == (0, 1, None)
    mesh = tmesh.make_mesh({"mp": 1, "dp": -1}, device="cpu")
    assert list(mesh.shape) == ["dp", "mp"]
    assert (mesh.mp_rank, mesh.mp_size, mesh.group("mp")) == (0, 1, None)
    assert tmesh.Mesh({"pp": 2, "dp": 2}, 2, "cpu").coords == {"pp": 1,
                                                               "dp": 0}
    assert tmesh.Mesh({"dp": 2, "mp": 2}, 1, "cpu").coords == {"dp": 0,
                                                               "mp": 1}
    for axis in ("pp", "mp"):
        with pytest.raises(ValueError, match="do not cover 1 ranks"):
            tmesh.make_mesh({"dp": 1, axis: 2}, device="cpu")
    for axis in ("fsdp", "tp", "sp", "ep", "mp"):
        with pytest.raises(NotImplementedError, match="pp > 1 beside"):
            tmesh.make_mesh({"pp": 2, axis: 2}, device="cpu")
    for axis in ("fsdp", "tp", "sp", "ep"):
        with pytest.raises(NotImplementedError, match="mp > 1 beside"):
            tmesh.make_mesh({"mp": 2, axis: 2}, device="cpu")


# -- (ii) the dp x fsdp ResNet step against the JAX step -------------------------


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    """Weights, two global batches of 8 (skewed halves), and the JAX
    step's state after each on a ``{"dp": 2, "fsdp": 2}`` mesh of four
    virtual devices (``__graft_entry__.py:70-86``)."""
    tmp = tmp_path_factory.mktemp("fsdp-step")
    jmodel, _ = _models()
    xs = [_skewed(8, 32, 1), _skewed(8, 32, 5)]
    ys = [_labels(8, 2), _labels(8, 6)]
    v = flax_variables(jmodel, xs[0])
    weights = str(tmp / "weights.npz")
    convert.save_npz(v, weights)
    data = str(tmp / "data.npz")
    np.savez(data, x0=xs[0], y0=ys[0], x1=xs[1], y1=ys[1])
    mesh = jmesh.make_mesh({"dp": 2, "fsdp": 2}, devices=jax.devices()[:4])
    state = _jax_state(jmodel, v, optax.sgd(0.1, momentum=0.9))
    run = jstep.make_train_step(jstep.cross_entropy_loss, {"train": True},
                                donate=False)
    losses = []
    with mesh:
        state = state.replace(
            params=jmesh.shard_params_fsdp(mesh, state.params),
            opt_state=jmesh.shard_params_fsdp(mesh, state.opt_state))
        for x, y in zip(xs, ys):
            state, m = run(state, jmesh.shard_batch(mesh, (x, y)))
            losses.append(float(m["loss"]))
    return {"tmp": tmp, "weights": weights, "data": data, "losses": losses,
            "params": state.params, "momentum": state.opt_state[0].trace,
            "batch_stats": state.batch_stats, "stages": {}}


def _step_stage(case, axes, model="resnet"):
    """The port's two steps (with the numerics bundle) at ``axes``, once
    per module."""
    key = (model, json.dumps(axes, sort_keys=True))
    if key not in case["stages"]:
        world = int(np.prod(list(axes.values())))
        data = case["data"] if model == "resnet" else case["lm_data"]
        tag = "%s-%s" % (model, "-".join("%s%d" % kv for kv in axes.items()))
        case["stages"][key] = _stage(case["tmp"], tag, world, [
            {"op": "build", "model": model, "shard": True,
             "weights": case["weights"] if model == "resnet" else None,
             "seed": None if model == "resnet" else 0},
            {"op": "steps", "model": model, "data": data, "n": 2,
             "numerics": True},
            {"op": "dump", "out": str(case["tmp"] / (tag + ".npz"))},
        ], axes=axes, group=True)
    return case["stages"][key]


@pytest.mark.parametrize("axes", [{"dp": 2, "fsdp": 2}, {"dp": 1, "fsdp": 2}],
                         ids=["dp2-fsdp2", "fsdp2"])
def test_dp_fsdp_step_matches_jax_step(step_case, axes):
    """Two SGD steps (0.1, momentum 0.9) of the small ResNet-vd sharded by
    ``shard_params_fsdp`` over four ranks (dp 2 x fsdp 2: batch norm over
    the dp sub-group) and over two (fsdp 2): each global loss, the
    gathered parameters, momentum and running averages against the JAX
    step on its dp x fsdp mesh."""
    got = _step_stage(step_case, axes)
    assert bool(got["sharded"])
    for i, want in enumerate(step_case["losses"]):
        assert _rel(got["loss"][i], want) <= TOL_STEP, (i, got["loss"], want)
    model = _flax_tree(got, "model/")
    want = {"params": step_case["params"],
            "batch_stats": step_case["batch_stats"]}
    errs = jax.tree.map(lambda a, b: _rel(a, np.asarray(b)), model, want)
    assert max(jax.tree.leaves(errs)) <= TOL_STEP, errs
    momentum = _flax_tree(got, "optim/")
    errs = jax.tree.map(lambda a, b: _rel(a, np.asarray(b)), momentum,
                        step_case["momentum"])
    assert max(jax.tree.leaves(errs)) <= TOL_STEP, errs


# -- (vi) the numerics bundle and the memory plan under shards ------------------


@pytest.mark.parametrize("model", ["resnet", "lm"])
def test_numerics_bundle_and_plan_at_fsdp2_match_world1(step_case, model):
    """The bundle (grad norm, param norm, update ratio, non-finite count;
    for the LM, which has no batch norm, the GNS halves' squared norms
    too) at fsdp 2 against world 1 on the same global batch; each rank's
    plan state bytes at fsdp 2 against world 1's."""
    if model == "lm":
        rng = np.random.RandomState(7)
        toks = [rng.randint(0, 256, (8, 65)).astype(np.int64)
                for _ in range(2)]
        path = str(step_case["tmp"] / "lm.npz")
        np.savez(path, x0=toks[0][:, :-1], y0=toks[0][:, 1:],
                 x1=toks[1][:, :-1], y1=toks[1][:, 1:])
        step_case["lm_data"] = path
    one = _step_stage(step_case, {"dp": 1, "fsdp": 1}, model)
    two = _step_stage(step_case, {"dp": 1, "fsdp": 2}, model)
    keys = sorted(k for k in one if k.startswith("bundle/"))
    assert "bundle/grad_norm" in keys and (
        ("bundle/half_sq" in keys) == (model == "lm")), keys
    for key in keys:
        np.testing.assert_allclose(two[key], one[key], rtol=TOL_BUNDLE,
                                   atol=0, err_msg=key)
    assert float(np.max(two["bundle/nonfinite"])) == 0
    share = two["state_bytes"] / one["state_bytes"][0]
    assert len(share) == 2 and np.all(share <= PLAN_SHARE), share


def test_step_cost_counts_the_unsharded_flops(step_case):
    """``CostCounter`` over the first step at dp 2 x fsdp 2 and at fsdp 2
    counts the model's FLOPs at each rank's rows (FSDP2's all-gathers and
    reduce-scatters are not FLOPs): at fsdp 2 (every rank the whole
    batch) exactly world 1's, at dp 2 exactly half of it."""
    one = _step_stage(step_case, {"dp": 1, "fsdp": 1})
    assert float(one["flops"]) > 0
    assert float(_step_stage(step_case, {"dp": 1, "fsdp": 2})["flops"]) \
        == float(one["flops"])
    assert 2 * float(_step_stage(step_case, {"dp": 2, "fsdp": 2})["flops"]) \
        == float(one["flops"])


# -- (iv) sharded checkpoints ------------------------------------------------


def _assert_same(got, want):
    keys = sorted(k for k in want if k.startswith(("model/", "optim/")))
    assert keys and sorted(k for k in got if k.startswith(
        ("model/", "optim/"))) == keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_sharded_versions_reshard_exactly(step_case, async_save):
    """A version saved at fsdp 2 restores at fsdp 1 (a one-rank group),
    and what fsdp 1 saves restores at fsdp 2: parameters, running
    averages and momentum equal to the gathered saved state bit for
    bit."""
    tmp = step_case["tmp"] / ("reshard-%d" % async_save)
    tmp.mkdir()
    first, second = str(tmp / "ck2"), str(tmp / "ck1")
    base = {"op": "build", "model": "resnet", "shard": True}
    saved = _stage(tmp, "w2", 2, [
        dict(base, seed=0),
        {"op": "steps", "data": step_case["data"], "n": 1},
        {"op": "save", "dir": first, "step": 1, "async": async_save},
        {"op": "dump", "out": str(tmp / "w2.npz")}])
    one = _stage(tmp, "w1", 1, [
        dict(base, seed=1),
        {"op": "restore", "dir": first},
        {"op": "dump", "out": str(tmp / "w1.npz")},
        {"op": "save", "dir": second, "step": 2, "async": async_save}],
        group=True)
    assert int(one["restored"]) == 1 and bool(one["sharded"])
    _assert_same(one, saved)
    two = _stage(tmp, "w2b", 2, [
        dict(base, seed=2),
        {"op": "restore", "dir": second},
        {"op": "dump", "out": str(tmp / "w2b.npz")}])
    assert int(two["restored"]) == 2
    _assert_same(two, saved)


def test_torn_sharded_version_falls_back_for_every_rank(step_case):
    """One rank's file of the newest fsdp-2 version is torn: both ranks
    fail the collective load together, quarantine it, and restore the
    previous version, bit for bit."""
    tmp = step_case["tmp"] / "torn"
    tmp.mkdir()
    ck = str(tmp / "ck")
    saved = _stage(tmp, "save", 2, [
        {"op": "build", "model": "resnet", "seed": 0, "shard": True},
        {"op": "steps", "data": step_case["data"], "n": 1},
        {"op": "save", "dir": ck, "step": 1},
        {"op": "dump", "out": str(tmp / "save.npz")},
        {"op": "steps", "data": step_case["data"], "n": 1},
        {"op": "save", "dir": ck, "step": 2}])
    shard = os.path.join(ck, "2", sorted(
        n for n in os.listdir(os.path.join(ck, "2"))
        if n.startswith("__1_"))[0])
    with open(shard, "r+b") as fh:
        fh.truncate(8)
    got = _stage(tmp, "restore", 2, [
        {"op": "build", "model": "resnet", "seed": 4, "shard": True},
        {"op": "restore", "dir": ck},
        {"op": "dump", "out": str(tmp / "restore.npz")}])
    assert int(got["restored"]) == 1
    _assert_same(got, saved)
    assert sorted(os.listdir(ck)) == ["1", "2.corrupt"]


def test_durable_mirror_merges_the_pods_parts(tmp_path):
    """Each pod mirrors its part of a sharded version into the durable
    tier: the second pod's files join the first's in the same step dir."""
    parts = {"A": {"__0_0.distcp": b"a", "dcp.metadata": b"m",
                   "status.json": b"{}"},
             "B": {"__1_0.distcp": b"b", "dcp.metadata": b"m",
                   "status.json": b"{}"}}
    durable = str(tmp_path / "durable")
    for pod, files in parts.items():
        step_dir = tmp_path / pod / "7"
        step_dir.mkdir(parents=True)
        for name, data in files.items():
            (step_dir / name).write_bytes(data)
        replicator = repl.Replicator(str(tmp_path / pod), k=0,
                                     durable_path=durable)
        replicator._mirror_durable(7, str(step_dir),
                                   repl.step_manifest(str(step_dir)))
    assert sorted(os.listdir(os.path.join(durable, "7"))) == [
        "__0_0.distcp", "__1_0.distcp", "dcp.metadata", "status.json"]


def test_ddp_version_loads_at_fsdp(step_case):
    """A version written at world 2 with DDP (whole tensors, rank 0's
    writes) loads into a sharded state at fsdp 2 and at fsdp 1."""
    tmp = step_case["tmp"] / "ddp"
    tmp.mkdir()
    ck = str(tmp / "ck")
    saved = _stage(tmp, "ddp", 2, [
        {"op": "build", "model": "resnet", "seed": 0, "ddp": True},
        {"op": "steps", "data": step_case["data"], "n": 1},
        {"op": "save", "dir": ck, "step": 1},
        {"op": "dump", "out": str(tmp / "ddp.npz")}], axes={"dp": 2})
    assert not bool(saved["sharded"])
    for world in (2, 1):
        got = _stage(tmp, "fsdp%d" % world, world, [
            {"op": "build", "model": "resnet", "seed": 3, "shard": True},
            {"op": "restore", "dir": ck},
            {"op": "dump", "out": str(tmp / ("fsdp%d.npz" % world))}],
            group=True)
        assert int(got["restored"]) == 1 and bool(got["sharded"])
        _assert_same(got, saved)


def test_pod_local_shards_restore_from_peers(step_case, clean_env):
    """Two one-rank pods at fsdp 2 with pod-local dirs: each pod's dir holds
    its rank's shards of the version (neither is complete alone) and
    each pod pushes them to the other's holder. Then pod A dies with its
    local dir and its holder, and the durable dir is deleted: pod B alone
    (world 1) restores the version from its own partial dir and the peer
    replica of A's shards, bit for bit."""
    tmp = step_case["tmp"] / "peer"
    tmp.mkdir()
    store = ChildStore()
    job = "fsdp-peer"
    client = StoreClient(store.endpoint, timeout=5.0)
    holders, regs = {}, {}
    try:
        for pod in ("podA", "podB"):
            holders[pod] = repl.ReplicaServer(
                str(tmp / (pod + ".replicas")), client, job, pod).start()
            regs[pod] = Registry(client, job).register(
                repl.PEERS_SERVICE, pod, holders[pod].endpoint.encode(),
                ttl=30.0)
        durable = str(tmp / "durable")

        def env(pod):
            return {"EDL_STORE_ENDPOINT": store.endpoint, "EDL_JOB_ID": job,
                    "EDL_POD_ID": pod, "EDL_CKPT_REPLICAS": "1",
                    "EDL_WORKER_RANK_IN_POD": "0",
                    "EDL_CKPT_LOCAL_DIR": str(tmp / ("local" + pod))}

        saved = _stage(tmp, "save", 2, [
            {"op": "build", "model": "resnet", "seed": 0, "shard": True},
            {"op": "steps", "data": step_case["data"], "n": 1},
            {"op": "save", "dir": durable, "step": 1},
            {"op": "dump", "out": str(tmp / "save.npz")}],
            env=[env("podA"), env("podB")])
        from edl_tpu_torch.checkpoint.manager import _candidate, version_files

        parts = [str(tmp / ("local%s" % p) / "1") for p in ("podA", "podB")]
        assert all(not _candidate(p) for p in parts)
        assert version_files(parts[0]) == version_files(parts[1])
        assert ("podA", 1) in holders["podB"].held()
        # pod A is gone with its dirs; so is the durable tier
        regs.pop("podA").stop(delete=True)
        holders.pop("podA").stop()
        for path in (tmp / "localpodA", tmp / "podA.replicas", durable):
            shutil.rmtree(str(path), ignore_errors=True)
        got = _stage(tmp, "restore", 1, [
            {"op": "build", "model": "resnet", "seed": 5, "shard": True},
            {"op": "restore", "dir": durable},
            {"op": "dump", "out": str(tmp / "restore.npz")}],
            env=[env("podB")])
        assert int(got["restored"]) == 1
        _assert_same(got, saved)
        assert _candidate(parts[1])
    finally:
        for reg in regs.values():
            reg.stop(delete=True)
        for holder in holders.values():
            holder.stop()
        client.close()
        store.stop()


# -- (iii) ElasticTrainer(fsdp=True) against the JAX trainer --------------------

_TRAINER = r"""
import json, os, sys
import numpy as np, torch
from edl_tpu_torch import convert
from edl_tpu_torch.models.resnet import ResNet
from edl_tpu_torch.train import ElasticTrainer, cross_entropy_loss, sgd

weights, data, ckpt, epochs, out = sys.argv[1:6]
batches = np.load(data)
model = ResNet((1, 1), width=8, num_classes=10, dtype=torch.float32)
convert.load_params(model, weights)
trainer = ElasticTrainer(
    model, sgd(0.1, momentum=0.9), cross_entropy_loss, ckpt_dir=ckpt,
    apply_kwargs={"train": True}, seed=None, fsdp=True,
    mesh_axes={"dp": 1, "fsdp": -1}, log=False, device="cpu")

def data_fn(epoch):
    mesh = trainer.mesh  # dp 1: every rank of the fsdp group, every row
    for i in range(2):
        x, y = batches["x%d_%d" % (epoch, i)], batches["y%d_%d" % (epoch, i)]
        rows = x.shape[0] // mesh.dp_size
        sl = slice(mesh.dp_rank * rows, (mesh.dp_rank + 1) * rows)
        yield x[sl], y[sl]

losses = {}
state = trainer.fit(data_fn, int(epochs), on_epoch_end=lambda e, m:
                    losses.__setitem__(e, float(m["loss"])))
with open(out % int(os.environ["EDL_WORKER_RANK"]), "w") as fh:
    json.dump({"losses": losses, "step": int(state.step),
               "mesh": trainer.mesh.shape}, fh)
"""


def _trainer_stage(tmp_path, world, epochs, args, tag):
    port = find_free_ports(1)[0]
    out = str(tmp_path / (tag + ".%d.json"))
    logs = [str(tmp_path / ("%s-%d.log" % (tag, r))) for r in range(world)]
    _wait_ok([_spawn(
        [sys.executable, "-c", _TRAINER, *args, str(epochs), out], logs[r],
        EDL_JOB_ID="fsdp", EDL_POD_ID="pod-%d" % r, EDL_STAGE="stage-" + tag,
        EDL_WORKER_RANK=str(r), EDL_NUM_WORKERS=str(world),
        EDL_COORDINATOR="127.0.0.1:%d" % port,
    ) for r in range(world)], logs)
    recs = []
    for r in range(world):
        with open(out % r) as fh:
            recs.append(json.load(fh))
    return recs


def test_trainer_resizes_match_jax_trainer(tmp_path, clean_env):
    """``ElasticTrainer(fsdp=True, mesh_axes={"dp": 1, "fsdp": -1})`` on
    the small ResNet-vd: epochs 0-1 at fsdp 2, then 2-3 at fsdp 1 (2 -> 1);
    and epochs 0-1 at fsdp 1, then 2-3 at fsdp 2 (1 -> 2). The resumed
    stage restores the version the other sharding wrote. Per-epoch
    losses against ``edl_tpu``'s trainer with ``fsdp=True`` on its 8
    virtual devices over the same resize (Orbax restores its version onto
    the new mesh)."""
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
    got = {}
    for name, worlds in (("shrink", (2, 1)), ("grow", (1, 2))):
        args = [weights, data, str(tmp_path / ("ck-" + name))]
        first = _trainer_stage(tmp_path, worlds[0], 2, args, name + "-a")
        second = _trainer_stage(tmp_path, worlds[1], 4, args, name + "-b")
        assert [r["mesh"] for r in first + second] == [
            {"dp": 1, "fsdp": w} for w in (worlds[0],) * worlds[0]
            + (worlds[1],) * worlds[1]]
        assert second[0]["step"] == 8
        got[name] = {int(e): loss for r in (first[0], second[0])
                     for e, loss in r["losses"].items()}

    def data_fn(epoch):
        for i in range(2):
            yield batches["x%d_%d" % (epoch, i)], batches["y%d_%d" % (epoch, i)]

    want = {}
    for epochs in (2, 4):
        JaxElasticTrainer(
            jmodel, optax.sgd(0.1, momentum=0.9), jstep.cross_entropy_loss,
            sample_input=sample, apply_kwargs={"train": True},
            mesh_axes={"dp": 1, "fsdp": -1}, fsdp=True,
            ckpt_dir=str(tmp_path / "jax"), log=False,
        ).fit(data_fn, epochs, on_epoch_end=lambda e, m: want.setdefault(
            e, float(m["loss"])))
    assert sorted(want) == [0, 1, 2, 3]
    for name, losses in got.items():
        assert sorted(losses) == [0, 1, 2, 3], (name, losses)
        for epoch in want:
            assert _rel(losses[epoch], want[epoch]) <= TOL_TRAINER, (
                name, epoch, losses, want)


# -- (v) hot restage under fsdp ---------------------------------------------


def _restage_run(work, hot):
    from edl_tpu_torch.chaos import drill

    with Rig(work, hot=hot, TEST_HOLD_EPOCHS="1,2", TEST_EPOCHS="4",
             TEST_FSDP="1") as rig:
        rc = churn(rig)
        restages = []
        for name in rig.outputs():
            if name.startswith("restages."):
                with open(os.path.join(rig.out, name)) as fh:
                    restages.extend(json.load(fh))
        losses = {e: v for e, (v, _s) in drill.read_losses(rig.out).items()}
        return rc, losses, restages


def test_hot_restage_under_fsdp_matches_cold(tmp_path):
    """The hot-restage drill of ``test_torch_hot_restage.py`` (1 -> 2 -> 1
    on the port's store and launcher) with ``ElasticTrainer(fsdp=True)``:
    the kept process rebuilds its sharded module and optimizer for each
    new mesh (``state == "rebuild"``) before the restore, and its losses
    equal the same schedule run cold, epoch by epoch."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        hot = pool.submit(_restage_run, tmp_path / "hot", True)
        cold = pool.submit(_restage_run, tmp_path / "cold", False)
        (h_rc, h_loss, h_restages), (c_rc, c_loss, c_restages) = \
            hot.result(), cold.result()
    assert h_rc == 0 and c_rc == 0 and c_restages == []
    assert [(r["from_world"], r["world"], r["state"]) for r in h_restages] \
        == [(1, 2, "rebuild"), (2, 1, "rebuild")]
    assert sorted(h_loss) == sorted(c_loss) == [0, 1, 2, 3]
    for epoch in c_loss:
        assert abs(h_loss[epoch] - c_loss[epoch]) <= TOL_HOT_VS_COLD * abs(
            c_loss[epoch]), (epoch, h_loss, c_loss)
