"""Proactive compile-cache warming of the port (``edl_tpu_torch/launch/
warm.py``), on the CPU, mirroring ``tests/test_warm.py``.

The warmer's cases drive ``CacheWarmer`` directly with the marker-dropping
toy worker (``tests/toy_worker.py``, no torch in the warmed processes);
the gate is the port's (workers on the CPU: ``CUDA_VISIBLE_DEVICES`` set
empty, or ``EDL_PREWARM_FORCE=1``); a warm-only ``ElasticTrainer`` worker
exits 0 after its second step without a checkpoint; and the port's
launcher with ``--prewarm`` runs one shadow stage of world 2 beside its
live stage of world 1. Shadow stages, launchers and the store run in
sessions of their own, killed by session in ``finally``.

Tolerances: exact (worlds, claims, exit codes, step counts).
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from conftest import TOY_WORKER, incarnations
from edl_tpu_torch.store.client import StoreClient
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


def _job_env(tmp_path, store_endpoint="", nodes_range="1:3", job="warmjob"):
    from edl_tpu_torch.cluster.job_env import JobEnv

    return JobEnv(
        job_id=job,
        store_endpoint=store_endpoint,
        nodes_range=nodes_range,
        nproc_per_node=1,
        log_dir=str(tmp_path / "logs"),
        compile_cache_dir=str(tmp_path / "cache"),
    )


@pytest.fixture(autouse=True)
def _no_warm_delay(monkeypatch):
    # the live-stage-first delay is timing policy, not under test here
    monkeypatch.setenv("EDL_PREWARM_DELAY", "0")


def _wait(pred, timeout=30.0, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _toy_env(out):
    return {"TEST_OUT_DIR": str(out), "TEST_EXIT_AFTER": "0.2",
            "CUDA_VISIBLE_DEVICES": ""}


class TestCacheWarmer:
    def test_anticipated_world_sizes(self):
        from edl_tpu_torch.cluster.job_env import JobEnv
        from edl_tpu_torch.launch.warm import anticipated_world_sizes

        je = JobEnv(job_id="j", nodes_range="2:5", nproc_per_node=2)
        assert anticipated_world_sizes(je) == [4, 6, 8, 10]
        je1 = JobEnv(job_id="j", nodes_range="3")
        assert anticipated_world_sizes(je1) == [3]

    def test_warms_grow_sizes_first(self, tmp_path):
        from edl_tpu_torch.launch.warm import CacheWarmer

        out = tmp_path / "markers"
        out.mkdir()
        warmer = CacheWarmer(
            _job_env(tmp_path), pod_id="podA", training_script=TOY_WORKER,
            extra_worker_env=_toy_env(out),
        )
        try:
            warmer.note_world(1)
            assert _wait(lambda: len(warmer.warmed) == 2)
        finally:
            warmer.stop()
        # grows first, largest grow first (current world 1 is skipped)
        assert warmer.warmed == [3, 2]
        runs = incarnations(str(out))
        assert runs["warm-2"] == {0: 2, 1: 2}
        assert runs["warm-3"] == {0: 3, 1: 3, 2: 3}

    def test_store_claim_dedupes_across_pods(self, tmp_path, store):
        from edl_tpu_torch.launch.warm import CacheWarmer

        client = StoreClient(store.endpoint, timeout=5.0)
        assert client.cas("/warmdedupe/warm/2", 0, b"other-pod")
        out = tmp_path / "markers"
        out.mkdir()
        warmer = CacheWarmer(
            _job_env(tmp_path, store_endpoint=store.endpoint,
                     job="warmdedupe"),
            pod_id="podB", training_script=TOY_WORKER,
            extra_worker_env=_toy_env(out),
        )
        try:
            warmer.note_world(1)
            assert _wait(lambda: len(warmer.warmed) == 1)
        finally:
            warmer.stop()
        assert warmer.warmed == [3]  # 2 was claimed elsewhere, skipped
        assert client.get("/warmdedupe/warm/3") == b"done:podB"
        client.close()

    def test_oversized_shadow_stages_skipped(self, tmp_path, monkeypatch):
        from edl_tpu_torch.launch.warm import CacheWarmer

        monkeypatch.setenv("EDL_PREWARM_MAX_WORLD", "2")
        out = tmp_path / "markers"
        out.mkdir()
        warmer = CacheWarmer(
            _job_env(tmp_path), pod_id="podC", training_script=TOY_WORKER,
            extra_worker_env=_toy_env(out),
        )
        try:
            warmer.note_world(1)
            assert _wait(lambda: len(warmer.warmed) == 1)
            time.sleep(0.5)
        finally:
            warmer.stop()
        assert warmer.warmed == [2]  # 3 exceeds the cap, never spawned

    def test_disabled_without_flag_or_cache_or_free_devices(
            self, tmp_path, monkeypatch):
        from edl_tpu_torch.launch.warm import make_warmer_if_enabled

        monkeypatch.delenv("EDL_PREWARM", raising=False)
        monkeypatch.delenv("EDL_PREWARM_FORCE", raising=False)
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
        cpu = {"CUDA_VISIBLE_DEVICES": ""}
        je = _job_env(tmp_path)
        assert make_warmer_if_enabled(je, "p", TOY_WORKER, [], cpu,
                                      False) is None
        # enabled by flag, but a 1-size window has nothing to warm
        je_fixed = _job_env(tmp_path, nodes_range="2:2")
        assert make_warmer_if_enabled(je_fixed, "p", TOY_WORKER, [], cpu,
                                      True) is None
        # workers on the card: the live stage owns it
        assert make_warmer_if_enabled(je, "p", TOY_WORKER, [], {},
                                      True) is None
        assert make_warmer_if_enabled(
            je, "p", TOY_WORKER, [], {"CUDA_VISIBLE_DEVICES": "0"},
            True) is None
        # no compile cache dir: nothing to warm into
        je_none = _job_env(tmp_path)
        je_none.compile_cache_dir = ""
        assert make_warmer_if_enabled(je_none, "p", TOY_WORKER, [], cpu,
                                      True) is None
        for knobs in ({}, {"EDL_PREWARM": "1"}):
            for key, value in knobs.items():
                monkeypatch.setenv(key, value)
            w = make_warmer_if_enabled(je, "p", TOY_WORKER, [], cpu,
                                       not knobs)
            assert w is not None
            w.stop()
        # the launcher's own env decides when the worker env says nothing
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
        w = make_warmer_if_enabled(je, "p", TOY_WORKER, [], {}, True)
        assert w is not None
        w.stop()
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
        monkeypatch.setenv("EDL_PREWARM_FORCE", "1")
        w = make_warmer_if_enabled(je, "p", TOY_WORKER, [], {}, True)
        assert w is not None
        w.stop()


WARM_TRAINER = """
import sys
sys.path.insert(0, %(repo)r)
import numpy as np, torch
from edl_tpu_torch.chaos import drill
from edl_tpu_torch.models import MLP
from edl_tpu_torch.train import ElasticTrainer, cross_entropy_loss, sgd
from edl_tpu_torch.train import loop as train_loop
steps = drill.count_steps(train_loop)
t = ElasticTrainer(MLP(8, (8,), 4), sgd(0.1), cross_entropy_loss,
                   ckpt_dir=%(ckpt)r, batch_size=8, device="cpu")
def data(epoch):
    rng = np.random.RandomState(epoch)
    for _ in range(50):
        yield rng.randn(8).astype(np.float32), rng.randint(0, 4)
try:
    t.fit(data, epochs=3)
finally:
    print("steps run: %%d" %% steps[0])
print("UNREACHABLE-IN-WARM-MODE")
"""


def test_warm_only_trainer_exits_after_two_steps_without_ckpt(tmp_path):
    """``EDL_WARM_ONLY=1``: ``ElasticTrainer.fit`` runs two steps, exits
    0, and never creates the checkpoint dir."""
    script = tmp_path / "warm_trainer.py"
    script.write_text(WARM_TRAINER % {"repo": REPO,
                                      "ckpt": str(tmp_path / "ckpt")})
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update(EDL_WARM_ONLY="1", EDL_JOB_ID="wj", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(script)], env=env, capture_output=True,
        text=True, timeout=120, start_new_session=True,
    )
    assert res.returncode == 0, res.stderr[-1500:]
    assert "warm-only stage (world=1): two steps run; exiting" in res.stdout
    assert "steps run: 2" in res.stdout
    assert "UNREACHABLE-IN-WARM-MODE" not in res.stdout
    assert not (tmp_path / "ckpt").exists()


def test_launcher_prewarm_runs_a_shadow_stage(tmp_path, store):
    """``--prewarm`` end to end on the port's launcher: a one-pod job in a
    1:2 window warms world 2 (marker files, a ``done:`` claim) beside its
    live stage of world 1."""
    out = tmp_path / "markers"
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update(TEST_OUT_DIR=str(out), TEST_EXIT_AFTER="6",
               PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               EDL_PREWARM_DELAY="0")
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.launch",
         "--job_id", "prewarmjob", "--store", store.endpoint,
         "--nodes_range", "1:2", "--ttl", "2.0", "--prewarm",
         "--compile_cache_dir", str(tmp_path / "cache"), TOY_WORKER],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
    )
    try:
        out_text, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
    assert proc.returncode == 0, out_text[-1500:]
    runs = incarnations(str(out))
    assert runs["warm-2"] == {0: 2, 1: 2}, runs
    live = [s for s in runs if not s.startswith("warm-")]
    assert len(live) == 1 and runs[live[0]] == {0: 1}
    client = StoreClient(store.endpoint, timeout=5.0)
    try:
        assert client.get("/prewarmjob/warm/2").startswith(b"done:")
    finally:
        client.close()
