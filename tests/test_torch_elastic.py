"""Parity: the port's elastic training plane vs edl_tpu's, on the CPU.

The same numpy inputs go through the JAX package and the port: the worker
env contract, ``batched``/``shuffled``/``prefetch_to_device``, the adjust
registry, the checkpoint manager's contract (the cases of
``tests/test_checkpoint.py`` mirrored on the DCP layout), and
``ElasticTrainer`` itself on a small TransformerLM (2 layers, d_model 64,
4 heads, vocab 256, seq 64, fp32) from converted initial weights: at
world 1 with a restart, and across a 2 → 1 resize whose first stage runs
in two gloo processes, each fed its half of the global batch.

Tolerances: per-epoch losses 1e-4 relative (the two frameworks sum in
another order; the JAX run shards its batch over 8 virtual devices);
exact equality where nothing is computed (env, batching, adjustments,
restored bytes).
"""

import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.chaos.scenario import corrupt_checkpoint_version
from edl_tpu.checkpoint import AdjustRegistry as JaxAdjustRegistry
from edl_tpu.checkpoint import TrainStatus as JaxTrainStatus
from edl_tpu.checkpoint import linear_scaled_lr as jax_linear_scaled_lr
from edl_tpu.cluster import job_env as jax_job_env
from edl_tpu.data import prefetch as jax_prefetch
from edl_tpu.models.transformer import TransformerLM as JaxLM
from edl_tpu.train import ElasticTrainer as JaxElasticTrainer
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.checkpoint import (
    AdjustRegistry,
    CheckpointManager,
    TrainStatus,
    linear_scaled_lr,
)
from edl_tpu_torch.checkpoint import manager as tmanager
from edl_tpu_torch.cluster import job_env
from edl_tpu_torch.data import batched, prefetch_to_device, shuffled
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.parallel import (
    batch_sharding,
    data_parallel,
    device_put_global,
    make_mesh,
    shard_batch,
    shard_params_fsdp,
)
from edl_tpu_torch.train import (
    ElasticTrainer,
    adamw,
    create_state,
    cross_entropy_loss,
    make_train_step,
    worker_barrier,
)
from edl_tpu_torch.train import context as tcontext
from edl_tpu_torch.utils.net import find_free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128)
B, T = 8, 64  # B divides the JAX run's 8 virtual devices
BATCHES = 3  # per epoch
TOL_LOSS = 1e-4
SUBPROCESS_TIMEOUT = 90


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
    """No launcher contract in the environment (the tests set their own)."""
    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    return monkeypatch


def _subprocess_env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


# -- worker env, data helpers, adjustments ---------------------------------

_ENVS = {
    "unset": {},
    "launcher": {
        "EDL_JOB_ID": "job-a", "EDL_POD_ID": "pod-b", "EDL_STAGE": "stg",
        "EDL_WORKER_RANK": "3", "EDL_WORKER_RANK_IN_POD": "1",
        "EDL_NUM_WORKERS": "4", "EDL_COORDINATOR": "10.0.0.1:7001",
        "EDL_WORKER_ENDPOINTS": "10.0.0.1:7001,10.0.0.2:7002,,",
        "EDL_STORE_ENDPOINT": "10.0.0.9:2379", "EDL_CKPT_PATH": "/ck",
        "EDL_CKPT_LOCAL_DIR": "/local", "EDL_COMPILE_CACHE_DIR": "/cache",
        "EDL_NODES_RANGE": "1:4", "EDL_NPROC_PER_NODE": "2",
    },
    "malformed-window": {
        "EDL_JOB_ID": "job-a", "EDL_NUM_WORKERS": "6",
        "EDL_NODES_RANGE": "9:2", "EDL_NPROC_PER_NODE": "junk",
    },
    "fixed-window": {
        "EDL_JOB_ID": "job-a", "EDL_NODES_RANGE": "3",
        "EDL_COMPILE_CACHE_DIR": "none",
    },
}


@pytest.mark.parametrize("name", sorted(_ENVS))
def test_worker_and_job_env_match_jax(clean_env, name):
    for key, value in _ENVS[name].items():
        clean_env.setenv(key, value)
    want, got = jax_job_env.WorkerEnv(), job_env.WorkerEnv()
    assert vars(got) == vars(want)
    assert got.is_rank0 == want.is_rank0
    assert job_env.WorkerEnv.present() == jax_job_env.WorkerEnv.present()
    assert job_env.job_identity("d", "p") == jax_job_env.job_identity("d", "p")

    def job(cls):
        try:
            return vars(cls())
        except ValueError as exc:  # no job id, or a malformed window
            return type(exc)

    assert job(job_env.JobEnv) == job(jax_job_env.JobEnv)


def test_local_device_count_is_cuda_devices(clean_env):
    clean_env.setattr(torch.cuda, "device_count", lambda: 0)
    assert job_env.local_device_count() == 0  # no made-up 1 without CUDA
    clean_env.setattr(torch.cuda, "device_count", lambda: 4)
    assert job_env.local_device_count() == 4
    clean_env.setenv("EDL_DEVICES_PER_PROC", "3")
    assert job_env.local_device_count() == 3 == jax_job_env.local_device_count()


def _records(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3).astype(np.float32), np.int32(i)) for i in range(n)]


@pytest.mark.parametrize("n,batch_size,drop", [
    (10, 4, False), (10, 4, True), (8, 4, False), (3, 5, False), (0, 2, False),
])
def test_batched_matches_jax(n, batch_size, drop):
    recs = _records(n)
    want = list(jax_prefetch.batched(iter(recs), batch_size, drop_remainder=drop))
    got = list(batched(iter(recs), batch_size, drop_remainder=drop))
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        for g, w in zip(gb, wb):
            np.testing.assert_array_equal(g, w)
    plain = list(batched(iter(range(n)), batch_size, drop_remainder=drop))
    jplain = list(jax_prefetch.batched(iter(range(n)), batch_size,
                                       drop_remainder=drop))
    assert [b.tolist() for b, _ in plain] == [b.tolist() for b, _ in jplain]


@pytest.mark.parametrize("n,buffer_size,seed", [
    (100, 16, 3), (100, 16, 4), (3, 100, 0), (50, 1, 7),
])
def test_shuffled_matches_jax(n, buffer_size, seed):
    src = list(range(n))
    got = list(shuffled(iter(src), buffer_size=buffer_size, seed=seed))
    assert got == list(jax_prefetch.shuffled(iter(src), buffer_size, seed))
    assert sorted(got) == src


def test_adjust_registry_matches_jax():
    def extra(status, world):
        return {"batch_per_worker": 32, "epoch_seen": getattr(status, "epoch", None)}

    for reg_cls, lin, status_cls in (
        (JaxAdjustRegistry, jax_linear_scaled_lr, JaxTrainStatus),
        (AdjustRegistry, linear_scaled_lr, TrainStatus),
    ):
        reg = reg_cls()
        reg.register(lin(0.1, base_world_size=8))
        reg.register(extra)
        reg.register(lambda status, world: None)  # no overrides
        out = [reg.resolve(status_cls(epoch=e), w) for e, w in ((1, 16), (3, 4))]
        out.append(reg.resolve(None, 8))
        if reg_cls is JaxAdjustRegistry:
            want = out
    assert out == want
    assert out[0]["lr"] == pytest.approx(0.2)
    assert out[2] == {"lr": 0.1, "batch_per_worker": 32, "epoch_seen": None}


# -- prefetch and the mesh -------------------------------------------------


def test_prefetch_to_device_matches_jax():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i)
               for i in range(5)]
    want = [jax.tree.map(np.asarray, b)
            for b in jax_prefetch.prefetch_to_device(iter(batches), depth=2)]
    got = list(prefetch_to_device(iter(batches), depth=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert all(isinstance(t, torch.Tensor) for t in g)
        for gt, wt in zip(g, w):
            np.testing.assert_array_equal(gt.numpy(), wt)
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter(batches), depth=0, device="cpu"))


def test_prefetch_reraises_and_stops_when_abandoned():
    def boom():
        yield np.zeros(2)
        raise KeyError("source failed")

    with pytest.raises(KeyError, match="source failed"):
        list(prefetch_to_device(boom(), depth=1, device="cpu"))

    pulled = []

    def endless():
        i = 0
        while True:
            pulled.append(i)
            yield np.full(2, i)
            i += 1

    before = set(threading.enumerate())
    it = prefetch_to_device(endless(), depth=2, device="cpu")
    assert next(it)[0] == 0
    feeders = [t for t in threading.enumerate()
               if t.name == "edl-prefetch" and t not in before]
    assert len(feeders) == 1
    it.close()  # the consumer leaves mid-epoch
    feeders[0].join(timeout=5.0)
    assert not feeders[0].is_alive()
    assert len(pulled) <= 5  # depth + 1 staged, then the feeder stopped


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(prefetch_to_device(iter([np.zeros(2)])))


def test_one_rank_mesh_places_without_a_group():
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"dp": 1} and mesh.device == torch.device("cpu")
    assert make_mesh({"dp": -1, "tp": 1}, device="cpu").size == 1
    host = np.arange(6, dtype=np.float32).reshape(3, 2)
    placed = shard_batch(mesh, (host, {"m": host}))
    np.testing.assert_array_equal(placed[0].numpy(), host)
    np.testing.assert_array_equal(placed[1]["m"].numpy(), host)
    host[0, 0] = 99.0  # placement copies
    assert placed[0][0, 0] == 0.0
    g = device_put_global(torch.ones(2), batch_sharding(mesh))
    assert g.device.type == "cpu"
    model = torch.nn.Linear(2, 2)
    assert data_parallel(model, mesh) is model
    with pytest.raises(ValueError):
        make_mesh({"dp": 2}, device="cpu")


# -- the checkpoint manager (tests/test_checkpoint.py:43-270, mirrored) -----


def _make_state(seed=0, lr=1e-3):
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    return create_state(model, seed, adamw(lr), device="cpu")


def _train(state, steps, seed=0):
    step = make_train_step(cross_entropy_loss)
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        tok = torch.from_numpy(rng.randint(0, CFG["vocab_size"], (2, 17)))
        state, _ = step(state, (tok[:, :-1], tok[:, 1:]))
    return state


def _params(state):
    return {k: v.detach().clone() for k, v in state.params.items()}


def _assert_same_state(got, want):
    for name, p in want.params.items():
        assert torch.equal(got.params[name], p), name
    gs, ws = (s.opt_state.optimizer.state_dict()["state"] for s in (got, want))
    assert sorted(gs) == sorted(ws)
    for idx in ws:
        for slot in ws[idx]:
            assert torch.equal(gs[idx][slot], ws[idx][slot]), (idx, slot)
    assert int(got.step) == int(want.step)
    assert got.opt_state.count == want.opt_state.count


class TestCheckpointManager:
    def test_save_restore_roundtrip(self, tmp_path):
        state = _train(_make_state(), 3)
        with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
            mngr.save(state, TrainStatus(epoch=2, step=3, world_size=1))
            mngr.wait()
            # different weights, and the new world's learning rate
            template = _make_state(seed=1, lr=2e-3)
            restored, status = mngr.restore(template)
        assert restored is template
        assert status is not None and status.epoch == 2 and status.step == 3
        _assert_same_state(restored, state)
        group = restored.opt_state.optimizer.param_groups[0]
        assert group["lr"] == 2e-3  # the factory's, not the saved 1e-3
        assert (tmp_path / "ckpt" / "3" / "status.json").is_file()
        # restored at the same learning rate, training continues exactly
        # as the original does
        with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
            same_lr, _ = mngr.restore(_make_state(seed=1))
        a, b = _train(same_lr, 2, seed=7), _train(state, 2, seed=7)
        for name, p in b.params.items():
            torch.testing.assert_close(a.params[name], p, rtol=0, atol=0)

    def test_empty_dir_restores_template(self, tmp_path):
        state = _make_state()
        before = _params(state)
        with CheckpointManager(str(tmp_path / "none")) as mngr:
            restored, status = mngr.restore(state)
            assert mngr.read_status() is None and mngr.latest_step() is None
        assert status is None and restored is state
        # a fresh optimizer stays fresh: nothing initialised its moments
        assert not state.opt_state.optimizer.state
        for name, p in before.items():
            assert torch.equal(state.params[name], p)

    def test_single_tier_restores_count_as_durable(self, tmp_path):
        state = _make_state()
        before = tmanager._M_RESTORES.value(tier="durable")
        with CheckpointManager(str(tmp_path / "ckpt")) as mngr:
            assert mngr.durable_path is None
            mngr.save(state, TrainStatus(epoch=1, step=1))
            mngr.restore(state)
        assert tmanager._M_RESTORES.value(tier="durable") == before + 1

    def test_retention(self, tmp_path):
        state = _make_state()
        with CheckpointManager(str(tmp_path / "keep"), max_to_keep=2) as mngr:
            for s in (1, 2, 3):
                mngr.save(state, TrainStatus(epoch=s, step=s))
            mngr.wait()
            assert mngr.latest_step() == 3
            assert mngr.all_steps() == [2, 3]
            with pytest.raises(FileExistsError):
                mngr.save(state, TrainStatus(epoch=3, step=3))
        assert sorted(os.listdir(tmp_path / "keep")) == ["2", "3"]


class _Capture:
    def __enter__(self):
        import logging

        self.records = []
        records = self.records

        class Handler(logging.Handler):
            def emit(self, record):
                records.append(record)

        self.handler = Handler(level=logging.WARNING)
        self.log = logging.getLogger("edl_tpu_torch.checkpoint.manager")
        self.log.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self.handler)


class TestTornWriteRecovery:
    def _two_versions(self, path, state):
        with CheckpointManager(path) as mngr:
            mngr.save(state, TrainStatus(epoch=0, step=1), step=1)
            mngr.save(state, TrainStatus(epoch=1, step=2), step=2)

    def test_restore_falls_back_past_corrupt_newest(self, tmp_path):
        path = str(tmp_path / "torn")
        state = _train(_make_state(), 2)
        self._two_versions(path, state)
        corrupt_checkpoint_version(path, 2)
        before = tmanager._M_RESTORE_FALLBACKS.value()
        with _Capture() as cap, CheckpointManager(path) as mngr:
            restored, status = mngr.restore(_make_state(seed=1))
            assert status is not None and status.step == 1
            _assert_same_state(restored, state)
            assert tmanager._M_RESTORE_FALLBACKS.value() == before + 1
            assert any("unreadable" in r.getMessage() for r in cap.records)
            # the torn version is quarantined, not deleted, and a
            # post-resume re-save of step 2 cannot collide
            assert mngr.all_steps() == [1]
            assert (tmp_path / "torn" / "2.corrupt").is_dir()
            mngr.save(restored, TrainStatus(epoch=1, step=2), step=2)
            assert mngr.latest_step() == 2

    def test_read_status_falls_back_too(self, tmp_path):
        path = str(tmp_path / "torn2")
        state = _make_state()
        with CheckpointManager(path) as mngr:
            mngr.save(state, TrainStatus(epoch=3, step=1), step=1)
            mngr.save(state, TrainStatus(epoch=4, step=2), step=2)
        corrupt_checkpoint_version(path, 2)
        with CheckpointManager(path) as mngr:
            got = mngr.read_status()
        assert got is not None and got.epoch == 3

    def test_all_versions_corrupt_raises(self, tmp_path):
        path = str(tmp_path / "torn3")
        with CheckpointManager(path) as mngr:
            mngr.save(_make_state(), TrainStatus(step=1), step=1)
        corrupt_checkpoint_version(path, 1)
        with CheckpointManager(path) as mngr:
            with pytest.raises(Exception):
                mngr.restore(_make_state(seed=1))

    def test_explicit_step_does_not_fall_back(self, tmp_path):
        path = str(tmp_path / "torn4")
        self._two_versions(path, _make_state())
        corrupt_checkpoint_version(path, 2)
        with CheckpointManager(path) as mngr:
            with pytest.raises(Exception):
                mngr.restore(_make_state(seed=1), step=2)
            assert mngr.all_steps() == [1, 2]  # nothing purged

    def test_fingerprint_mismatch_quarantines(self, tmp_path):
        """Bytes that load but are not what the trainer saved (the stamped
        parameter norm disagrees) quarantine like a torn version; a second
        quarantine of the same step takes a unique name."""
        path = tmp_path / "fp"
        state = _train(_make_state(), 1)
        self._two_versions(str(path), state)

        def tamper():
            doc_path = path / "2" / "status.json"
            doc = json.loads(doc_path.read_text())
            doc["meta"]["numerics"]["param_norm"] *= 1.01
            doc_path.write_text(json.dumps(doc))

        for quarantined in ("2.corrupt", "2.corrupt.1"):
            tamper()
            with _Capture() as cap, CheckpointManager(str(path)) as mngr:
                _, status = mngr.restore(_make_state(seed=1))
                assert status.step == 1
                assert any("fingerprint mismatch" in r.getMessage()
                           for r in cap.records)
                assert (path / quarantined).is_dir()
                mngr.save(state, TrainStatus(epoch=1, step=2), step=2)


def _raises_naming(fn, item):
    with pytest.raises(NotImplementedError, match=item):
        fn()


# each feature of slice 3b, and the ROADMAP item a deferred one's refusal
# names; None: ported, it runs (the checkpoint tiers of item 4:
# test_torch_ckpt_tiers.py, test_torch_replicate.py; the emergency save and
# hot restage: test_torch_hot_restage.py; FSDP, item 5: test_torch_fsdp.py;
# the AOT ladder and the cache pull, M22: test_torch_aot.py)
_DEFERRED = {
    "async_save": None, "local_dir": None, "local_dir_env": None,
    "emergency_replicate": None, "trainer_fsdp": None,
    "mesh_fsdp": None, "shard_params_fsdp": None,
    "aot_ladder": None, "cache_pull": None,
}


def _ladder_env():
    from edl_tpu_torch.cluster.job_env import WorkerEnv

    env = WorkerEnv()
    env.world_size, env.min_nodes, env.max_nodes = 1, 1, 2
    env.compile_cache_dir = "/cache"
    return env


def _lm_state(model):
    from edl_tpu_torch.train import create_state

    return create_state(model, 0, adamw(1e-3), device="cpu")


def _plane():
    from edl_tpu_torch.obs.memory import MemoryPlan, MemoryPlane

    plane = MemoryPlane(device="cpu")
    plane.plan = MemoryPlan(argument=1.0, world=1)
    return plane


@pytest.mark.parametrize("what", sorted(_DEFERRED))
def test_deferred_features_name_slice_3b(tmp_path, clean_env, what):
    path = str(tmp_path / "ck")
    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    calls = {
        "async_save": lambda: CheckpointManager(path, async_save=True),
        "local_dir": lambda: CheckpointManager(path, local_dir=path + "l"),
        "local_dir_env": lambda: (
            clean_env.setenv("EDL_CKPT_LOCAL_DIR", path + "l"),
            CheckpointManager(path)),
        "emergency_replicate": lambda: CheckpointManager(
            path).emergency_replicate(1.0),
        "trainer_fsdp": lambda: ElasticTrainer(
            model, adamw(1e-3), cross_entropy_loss, fsdp=True, device="cpu"),
        "mesh_fsdp": lambda: make_mesh({"dp": 1, "fsdp": -1}, device="cpu"),
        "shard_params_fsdp": lambda: shard_params_fsdp(
            make_mesh({"dp": 1, "fsdp": -1}, device="cpu"), model),
        "aot_ladder": lambda: ElasticTrainer(
            model, adamw(1e-3), cross_entropy_loss, device="cpu"
        )._start_ladder(_ladder_env(), _lm_state(model), _plane()),
        "cache_pull": lambda: tcontext._pull_cache_entries(_ladder_env()),
    }
    if _DEFERRED[what] is not None:
        _raises_naming(calls[what], _DEFERRED[what])
        return
    out = calls[what]()
    if isinstance(out, tuple):
        out = out[-1]  # (setenv, manager)
    if what == "emergency_replicate":
        assert out is False  # no local tier: no peer to push to
    elif what == "trainer_fsdp":
        # the whole world shards the state: {"dp": 1, "fsdp": -1}
        assert out._fsdp and out._mesh_axes == {"dp": 1, "fsdp": -1}
    elif what == "mesh_fsdp":
        assert out.shape == {"dp": 1, "fsdp": 1} and out.device_mesh is None
    elif what == "shard_params_fsdp":
        # a one-worker stage without a process group keeps the model whole
        assert out is model and not any(
            type(p).__name__ == "DTensor" for p in model.parameters())
    elif what == "async_save":
        assert out._async and out.durable_path is None
    elif what == "aot_ladder":
        # world 1 in a 1:2 window: the ladder plans world 2
        try:
            assert out is not None and out._worlds == [2]
        finally:
            out.close()
    elif what == "cache_pull":
        assert out is None  # no store: nothing to pull, nothing raised
    else:
        assert out.path == path + "l" and out.durable_path == path


# -- ElasticTrainer against the JAX trainer ---------------------------------


def _lm_data(rows):
    """``data_fn(epoch)``: BATCHES global next-token batches of ``rows``
    rows, seeded by the epoch."""

    def data_fn(epoch):
        rng = np.random.RandomState(100 + epoch)
        for _ in range(BATCHES):
            tok = rng.randint(0, CFG["vocab_size"], (rows, T + 1)).astype(np.int32)
            yield tok[:, :-1], tok[:, 1:]

    return data_fn


def _jax_init_params(rows):
    model = JaxLM(dtype=jnp.float32, **CFG)
    params = model.init(jax.random.PRNGKey(0), np.zeros((rows, T), np.int32))
    return jax.tree.map(np.asarray, params["params"])


def _collect(out):
    return lambda epoch, metrics: out.setdefault(epoch, float(metrics["loss"]))


def _assert_losses_close(got, want):
    assert sorted(got) == sorted(want)
    for epoch in want:
        rel = abs(got[epoch] - want[epoch]) / abs(want[epoch])
        assert rel <= TOL_LOSS, (epoch, got[epoch], want[epoch], rel)


def test_fit_and_resume_match_jax_trainer(tmp_path, clean_env):
    """World 1: the port's trainer from the JAX trainer's initial weights
    gives the same per-epoch losses, and a second ``fit`` resumes after
    the last checkpointed epoch (``test_fit_resumes_from_checkpoint``'s
    contract: it trains epochs 2 and 3 only)."""
    params = _jax_init_params(B)

    def jax_trainer():
        return JaxElasticTrainer(
            JaxLM(dtype=jnp.float32, **CFG), optax.adamw(1e-3),
            jstep.cross_entropy_loss, sample_input=np.zeros((B, T), np.int32),
            ckpt_dir=str(tmp_path / "jax"), log=False,
        )

    def port_trainer():
        model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
        convert.load_params(model, params)
        return ElasticTrainer(
            model, adamw(1e-3), cross_entropy_loss,
            ckpt_dir=str(tmp_path / "port"), seed=None, log=False,
            device="cpu",
        )

    data = _lm_data(B)
    want, got = {}, {}
    s1 = jax_trainer().fit(data, 2, on_epoch_end=_collect(want))
    t1 = port_trainer().fit(data, 2, on_epoch_end=_collect(got))
    assert int(t1.step) == int(s1.step) == 2 * BATCHES
    resumed = []
    s2 = jax_trainer().fit(data, 4, on_epoch_end=_collect(want))
    t2 = port_trainer().fit(
        data, 4,
        on_epoch_end=lambda e, m: (resumed.append(e), _collect(got)(e, m)),
    )
    assert resumed == [2, 3]
    assert int(t2.step) == int(s2.step) == 4 * BATCHES
    _assert_losses_close(got, want)


def test_fit_record_stream_and_evaluate(clean_env):
    """``batch_size`` packs records (ragged tail dropped in fit, padded
    and masked in evaluate, which covers every record once)."""

    def records(epoch, n=22):
        rng = np.random.RandomState(epoch)
        for _ in range(n):
            tok = rng.randint(0, CFG["vocab_size"], T + 1).astype(np.int32)
            yield tok[:-1], tok[1:]

    model = TransformerLM(dtype=torch.float32, device="cpu", **CFG)
    trainer = ElasticTrainer(model, adamw(1e-2), cross_entropy_loss,
                             batch_size=4, log=False, device="cpu")
    seen = {}
    state = trainer.fit(records, 3, on_epoch_end=_collect(seen))
    assert int(state.step) == 3 * (22 // 4)
    assert seen[2] < seen[0]
    got = trainer.evaluate(state, lambda: records(9, n=10))
    # the reference: every record once, one by one
    losses = []
    with torch.no_grad():
        for x, y in records(9, n=10):
            logits = state.apply_fn(torch.from_numpy(x[None]))
            losses.append(cross_entropy_loss(logits, torch.from_numpy(y[None]))[0])
    assert got["loss"] == pytest.approx(float(torch.stack(losses).mean()), rel=1e-5)


_RESIZE_WORKER = r"""
import json, os, sys
import numpy as np, torch
from edl_tpu_torch import convert
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import (AdjustRegistry, ElasticTrainer, adamw,
                                 cross_entropy_loss, linear_scaled_lr)

weights, ckpt, epochs, out, cfg, rows, t, batches = sys.argv[1:9]
cfg, rows, t, batches = json.loads(cfg), int(rows), int(t), int(batches)
rank = int(os.environ["EDL_WORKER_RANK"])
world = int(os.environ["EDL_NUM_WORKERS"])

def data_fn(epoch):
    rng = np.random.RandomState(100 + epoch)
    for _ in range(batches):
        tok = rng.randint(0, cfg["vocab_size"], (rows, t + 1)).astype(np.int32)
        mine = tok.reshape(world, rows // world, t + 1)[rank]  # my half
        yield mine[:, :-1], mine[:, 1:]

model = TransformerLM(dtype=torch.float32, device="cpu", **cfg)
convert.load_params(model, weights)
adjusts = AdjustRegistry()
adjusts.register(linear_scaled_lr(1e-3, 1))
losses = {}
state = ElasticTrainer(
    model, lambda o: adamw(o["lr"]), cross_entropy_loss, ckpt_dir=ckpt,
    adjusts=adjusts, seed=None, device="cpu",
).fit(data_fn, int(epochs),
      on_epoch_end=lambda e, m: losses.__setitem__(e, float(m["loss"])))
with open(out % rank, "w") as fh:
    json.dump({"losses": losses, "step": int(state.step),
               "lr": state.opt_state.optimizer.param_groups[0]["lr"]}, fh)
"""


def _run_workers(tmp_path, world, epochs, weights, ckpt, tag):
    port = find_free_ports(1)[0]
    out = str(tmp_path / (tag + "-%d.json"))
    args = [weights, ckpt, str(epochs), out, json.dumps(CFG), str(B),
            str(T), str(BATCHES)]
    procs = []
    for rank in range(world):
        env = _subprocess_env(
            EDL_JOB_ID="resize", EDL_POD_ID="pod-%d" % rank,
            EDL_STAGE="stage-" + tag, EDL_WORKER_RANK=str(rank),
            EDL_NUM_WORKERS=str(world),
            EDL_COORDINATOR="127.0.0.1:%d" % port,
        )
        log = open(str(tmp_path / ("%s-%d.log" % (tag, rank))), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", _RESIZE_WORKER, *args], env=env, cwd=REPO,
            stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + SUBPROCESS_TIMEOUT
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        text = (tmp_path / ("%s-%d.log" % (tag, rank))).read_text()
        assert proc.returncode == 0, text[-3000:]
    with open(out % 0) as fh:
        return json.load(fh), (tmp_path / (tag + "-0.log")).read_text()


def test_resize_two_to_one_matches_jax_trainer(tmp_path, clean_env):
    """Two gloo workers, each fed its half of the global batch, train
    epochs 0-1 at lr 2e-3 and checkpoint; one worker resumes at world 1
    (lr 1e-3 under ``linear_scaled_lr``) and trains epochs 2-3. The JAX
    trainer runs the same schedule in one process on the concatenated
    batches (``EDL_NUM_WORKERS`` 2, then 1)."""
    rows = B
    params = _jax_init_params(rows)
    weights = str(tmp_path / "init.npz")
    convert.save_npz(params, weights)
    ckpt = str(tmp_path / "ckpt")
    first, _ = _run_workers(tmp_path, 2, 2, weights, ckpt, "w2")
    second, log = _run_workers(tmp_path, 1, 4, weights, ckpt, "w1")
    assert "resumed at epoch 2 (world=1, lr=0.001)" in log
    assert first["lr"] == pytest.approx(2e-3) and second["lr"] == pytest.approx(1e-3)
    assert second["step"] == 4 * BATCHES
    got = {int(e): v for e, v in {**first["losses"], **second["losses"]}.items()}

    want = {}
    adjusts = JaxAdjustRegistry()
    adjusts.register(jax_linear_scaled_lr(1e-3, 1))
    for world, epochs in (("2", 2), ("1", 4)):
        clean_env.setenv("EDL_NUM_WORKERS", world)
        JaxElasticTrainer(
            JaxLM(dtype=jnp.float32, **CFG),
            lambda o: optax.adamw(o["lr"]), jstep.cross_entropy_loss,
            sample_input=np.zeros((rows, T), np.int32), adjusts=adjusts,
            ckpt_dir=str(tmp_path / "jax"), log=False,
        ).fit(_lm_data(rows), epochs, on_epoch_end=_collect(want))
    _assert_losses_close(got, want)


_BARRIER_WORKER = r"""
from edl_tpu_torch.train.context import worker_barrier
worker_barrier("test-barrier", timeout=60.0)
worker_barrier("test-barrier", timeout=60.0)  # the same name, round 2
print("passed")
"""


def test_worker_barrier_through_the_jax_store(store, clean_env):
    """Two port workers meet at the barrier through the JAX package's
    store; without a store, or at world 1, it returns at once."""
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _BARRIER_WORKER],
            env=_subprocess_env(
                EDL_JOB_ID="barrier", EDL_STAGE="s", EDL_WORKER_RANK=str(r),
                EDL_NUM_WORKERS="2", EDL_STORE_ENDPOINT=store.endpoint),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for r in range(2)
    ]
    outs = [p.communicate(timeout=SUBPROCESS_TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 and "passed" in o for p, o in zip(procs, outs)), outs
    clean_env.setattr(tcontext, "_env", None)
    clean_env.setenv("EDL_NUM_WORKERS", "2")
    worker_barrier("no-store", timeout=0.1)  # no store: a no-op
    clean_env.setenv("EDL_NUM_WORKERS", "1")
    clean_env.setenv("EDL_STORE_ENDPOINT", store.endpoint)
    worker_barrier("world-1", timeout=0.1)


def test_init_is_a_noop_at_world_one(clean_env):
    clean_env.setattr(tcontext, "_env", None)
    clean_env.setenv("EDL_NUM_WORKERS", "1")
    clean_env.setenv("EDL_COORDINATOR", "127.0.0.1:1")
    env = tcontext.init()  # the card by default, but no group to join
    assert env.world_size == 1 and tcontext.current_env() is env
    assert not torch.distributed.is_initialized()


# -- chip_smoke.py phase elastic: its helpers -------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elastic_child_env_is_the_launchers(chip_smoke, clean_env):
    base = {"PATH": "/bin", "EDL_COORDINATOR": "h:1",
            "EDL_STORE_ENDPOINT": "h:2", "EDL_CKPT_LOCAL_DIR": "/l",
            "EDL_HOT_RESTAGE": "1"}
    t0 = time.time()
    env = chip_smoke.elastic_env("stage2", base)
    assert t0 <= float(env["EDL_SPAWN_TS"]) <= time.time()
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert env["PATH"] == "/bin"
    for key in ("EDL_COORDINATOR", "EDL_STORE_ENDPOINT",
                "EDL_CKPT_LOCAL_DIR", "EDL_HOT_RESTAGE"):
        assert key not in env
    for key, value in env.items():
        if key.startswith("EDL_"):
            clean_env.setenv(key, value)
    worker = job_env.WorkerEnv()
    assert (worker.world_size, worker.global_rank, worker.rank_in_pod) == (1, 0, 0)
    assert worker.is_rank0 and job_env.WorkerEnv.present()
    assert (worker.job_id, worker.pod_id, worker.stage) == (
        "chip-smoke-elastic", "pod-0", "stage-stage2")
    assert chip_smoke.elastic_env("stage1", base)["EDL_JOB_ID"] == worker.job_id
    assert chip_smoke.elastic_env("reference", base)["EDL_JOB_ID"] != worker.job_id


def test_elastic_state_digest(chip_smoke, tmp_path):
    """The digest names every tensor a checkpoint holds, survives a save
    and restore bit for bit, and changes when training moves a value."""
    state = _train(_make_state(), 2)
    digest = chip_smoke.state_digest(torch, state)
    names = list(state.params)
    want = ({"model/" + n for n in names}
            | {"optim/%s/%s" % (n, s) for n in names
               for s in ("exp_avg", "exp_avg_sq", "step")}
            | {"step", "count"})
    assert set(digest) == want
    assert all(len(v) == 64 for v in digest.values())
    with CheckpointManager(str(tmp_path / "d")) as mngr:
        mngr.save(state, TrainStatus(epoch=0, step=2))
        restored, _ = mngr.restore(_make_state(seed=3))
    assert chip_smoke.state_digest(torch, restored) == digest
    moved = chip_smoke.state_digest(torch, _train(restored, 1))
    assert all(moved[k] != digest[k] for k in ("step", "count",
                                                "model/" + names[0]))
