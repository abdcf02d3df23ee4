"""The port's checkpoint manager with async saves and the pod-local tier,
on the CPU.

Async saves stage the state off the live tensors before ``save`` returns
(no torn save: an in-place update of every parameter and AdamW moment
right after ``save`` does not reach the version), run DCP's collectives on
the stage's checkpoint group at world > 1 (two gloo ranks stepping DDP
while the write is in flight), finalize on a thread of the manager's own
(``status.json``, rename), and bound the drain's emergency save by its
budget (``finished=False`` when it runs out). The local tier mirrors the
durable path without a store (``tests/test_checkpoint.py``'s case over
the port), a hot restage tears its group down only after the in-flight
save has finalized, and the port's launcher runs the replica holder beside
the restage planes (prewarming, standby shells, the cache exchange).

Tolerances: exact equality everywhere (restored bytes, digests, paths).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import adamw, create_state, cross_entropy_loss, make_train_step
from edl_tpu_torch.utils.net import find_free_ports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128)
SUBPROCESS_TIMEOUT = 120


@pytest.fixture()
def clean_env(monkeypatch):
    """No launcher contract in the environment (the tests set their own)."""
    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    return monkeypatch


@pytest.fixture()
def slow_writes(monkeypatch):
    """Every DCP file write waits ``delay[0]`` seconds first, so an async
    save is still in flight when the test acts."""
    from torch.distributed.checkpoint import FileSystemWriter

    delay = [0.5]
    write_data = FileSystemWriter.write_data

    def slow(self, plan, planner):
        time.sleep(delay[0])
        return write_data(self, plan, planner)

    monkeypatch.setattr(FileSystemWriter, "write_data", slow)
    return delay


@pytest.fixture()
def flight(clean_env, tmp_path):
    """This process's flight records, in a directory of the test's:
    ``flight(event)`` reads back the records of one event."""
    from edl_tpu_torch.obs import events as obs_events

    clean_env.setenv("EDL_FLIGHT_DIR", str(tmp_path / "flight"))
    obs_events.reset()

    def read(event):
        return [r for r in obs_events.read_segments(str(tmp_path / "flight"))
                if r.get("event") == event]

    yield read
    obs_events.reset()


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


def _digest(state):
    """Every parameter and optimizer-state tensor, copied."""
    out = {"p." + k: v.detach().clone() for k, v in state.params.items()}
    for idx, slots in state.opt_state.optimizer.state_dict()["state"].items():
        for slot, v in slots.items():
            if torch.is_tensor(v):
                out["o.%s.%s" % (idx, slot)] = v.detach().clone()
    return out


def _assert_digest(state, want):
    got = _digest(state)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key


def _bump_in_place(state):
    """What the next optimizer step does to the live tensors."""
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
        for slots in state.opt_state.optimizer.state.values():
            for v in slots.values():
                if torch.is_tensor(v):
                    v.add_(1.0)


def test_async_roundtrip_writes_status(tmp_path, flight):
    state = _train(_make_state(), 2)
    want = _digest(state)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True) as mngr:
        assert mngr.save(state, TrainStatus(epoch=0, step=2)) == 2
        mngr.wait()
        assert mngr.latest_step() == 2
        doc = json.loads((tmp_path / "ck" / "2" / "status.json").read_text())
        assert doc["step"] == 2 and doc["epoch"] == 0
        assert not [n for n in os.listdir(tmp_path / "ck") if n.startswith(".tmp")]
        [done] = flight("ckpt_finalize")
        assert done["step"] == 2 and done["ok"] and done["write_s"] > 0
        restored, status = mngr.restore(_make_state(seed=1))
    assert status.step == 2
    _assert_digest(restored, want)


def test_async_save_is_not_torn(tmp_path, clean_env, slow_writes):
    """The next optimizer step updates parameters and AdamW moments in
    place while the write is still running; the version holds what
    ``save`` was given."""
    state = _train(_make_state(), 2)
    want = _digest(state)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True) as mngr:
        mngr.save(state, TrainStatus(epoch=0, step=2))
        assert mngr.latest_step() is None  # still in flight
        _bump_in_place(state)
        mngr.wait()
        restored, _ = mngr.restore(_make_state(seed=1))
    _assert_digest(restored, want)


def test_async_save_waits_for_the_one_in_flight(tmp_path, flight, slow_writes):
    state = _train(_make_state(), 1)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True,
                           max_to_keep=2) as mngr:
        mngr.save(state, TrainStatus(epoch=0, step=1))
        mngr.save(state, TrainStatus(epoch=1, step=2))
        # the second save waited for the first to finalize, and says so
        # apart from its staging
        first, second = flight("ckpt_save")
        assert first["wait_prev_s"] == 0.0 and second["wait_prev_s"] >= 0.2
        assert second["seconds"] >= second["wait_prev_s"] + second["stage_s"]
        assert mngr.all_steps() == [1]
        mngr.wait()
        assert mngr.all_steps() == [1, 2]


def test_emergency_save_async_within_budget(tmp_path, clean_env):
    state = _train(_make_state(), 1)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True) as mngr:
        step, finished = mngr.emergency_save(
            state, TrainStatus(step=1, meta={"emergency": True}), budget_s=60.0)
        assert (step, finished) == (1, True)
        assert mngr.latest_step() == 1
        # a step the newest version covers is not saved again
        assert mngr.emergency_save(state, TrainStatus(step=1), 1.0) == (1, True)


def test_emergency_save_async_unfinished_past_budget(tmp_path, clean_env,
                                                    slow_writes):
    slow_writes[0] = 2.0
    state = _train(_make_state(), 1)
    with CheckpointManager(str(tmp_path / "ck"), async_save=True) as mngr:
        step, finished = mngr.emergency_save(
            state, TrainStatus(step=1), budget_s=0.2)
        assert (step, finished) == (1, False)
        assert mngr.latest_step() is None
        mngr.wait()  # the write goes on in the background and finalizes
        assert mngr.latest_step() == 1


def test_local_tier_without_store_still_mirrors_durable(tmp_path, clean_env):
    """A local tier without the worker env contract (no store, no job)
    cannot push to peers — but the durable mirror is a purely local copy
    and must still run."""
    state = _train(_make_state(), 2)
    want = _digest(state)
    with CheckpointManager(
        str(tmp_path / "durable"), local_dir=str(tmp_path / "local")
    ) as mngr:
        assert mngr.durable_path == str(tmp_path / "durable")
        assert mngr._replicator is not None  # mirror-only (k=0)
        assert not mngr._replicator.peers_armed
        mngr.save(state, TrainStatus(epoch=1, step=2))
        mngr.wait()
        # saves land in the LOCAL tier immediately...
        assert (tmp_path / "local" / "2").is_dir()
        # ...and the background mirror lands them in the durable dir
        deadline = time.time() + 15
        while time.time() < deadline and not (tmp_path / "durable" / "2").is_dir():
            time.sleep(0.05)
        assert (tmp_path / "durable" / "2").is_dir()
        assert mngr._replicator.lag() == 0  # mirror-only never lags
        restored, status = mngr.restore(_make_state(seed=1))
    assert status is not None and status.step == 2
    _assert_digest(restored, want)
    # the env var arms the same tier
    clean_env.setenv("EDL_CKPT_LOCAL_DIR", str(tmp_path / "local2"))
    with CheckpointManager(str(tmp_path / "durable")) as mngr:
        assert mngr.path == str(tmp_path / "local2") and mngr._tier == "local"


def test_ladder_falls_to_durable_when_the_local_tier_is_gone(tmp_path, clean_env):
    """The freshness-first walk: the local copy is lost, the durable
    mirror holds the version; the restore is labelled ``durable`` and the
    version lands in the local tier."""
    from edl_tpu_torch.obs import events as obs_events

    state = _train(_make_state(), 2)
    want = _digest(state)
    with CheckpointManager(str(tmp_path / "durable"),
                           local_dir=str(tmp_path / "local")) as mngr:
        mngr.save(state, TrainStatus(epoch=1, step=2))
        mngr.wait()
        deadline = time.time() + 15
        while time.time() < deadline and not (tmp_path / "durable" / "2").is_dir():
            time.sleep(0.05)
    import shutil

    shutil.rmtree(tmp_path / "local")
    clean_env.setenv("EDL_FLIGHT_DIR", str(tmp_path / "flight"))
    obs_events.reset()
    try:
        with CheckpointManager(str(tmp_path / "durable"),
                               local_dir=str(tmp_path / "local")) as mngr:
            restored, status = mngr.restore(_make_state(seed=1))
    finally:
        obs_events.reset()
    assert status.step == 2 and (tmp_path / "local" / "2").is_dir()
    _assert_digest(restored, want)
    recs = [json.loads(line) for f in (tmp_path / "flight").rglob("*.jsonl")
            for line in f.read_text().splitlines()]
    tiers = [r.get("tier") for r in recs if r.get("event") == "ckpt_restore"]
    assert tiers == ["durable"], recs


class _Store:
    """The two reads the drain wait makes, over a dict."""

    def __init__(self, kv):
        self.kv = kv

    def range(self, prefix):
        return [(k, v, 0, 0) for k, v in sorted(self.kv.items())
                if k.startswith(prefix)], 1

    def get(self, key):
        return self.kv.get(key)


@pytest.mark.parametrize("how", ["leaves", "deadline"])
def test_restore_waits_for_a_draining_pod(tmp_path, clean_env, flight, how):
    """Before the ladder's walk, the restore waits while another pod with a
    preemption notice is still registered (its drain may be pushing the
    newest version to this pod's holder): until it leaves, or at most until
    its notice's deadline. Its own notice, a pod that already left and a
    notice past its deadline cost no wait."""
    import threading

    now = time.time()
    hold = 0.4
    kv = {}
    for pod, deadline, registered in (
            ("me-000000", now + 30, True), ("gone-0000", now + 30, False),
            ("late-0000", now - 1, True),
            ("drain-000", now + (30 if how == "leaves" else hold), True)):
        kv["/job/preempt/" + pod] = json.dumps(
            {"deadline": deadline, "budget": 30.0, "ts": now}).encode()
        if registered:
            kv["/job/pod_resource/" + pod] = b"{}"
    clean_env.setenv("EDL_JOB_ID", "job")
    clean_env.setenv("EDL_POD_ID", "me-000000")
    leave = threading.Timer(
        hold, kv.pop, ("/job/pod_resource/drain-000", None))
    if how == "leaves":
        leave.start()
    try:
        with CheckpointManager(str(tmp_path / "durable"),
                               local_dir=str(tmp_path / "local")) as mngr:
            t0 = time.monotonic()
            mngr._await_drains(_Store(kv))
            waited = time.monotonic() - t0
    finally:
        leave.cancel()
    assert hold - 0.05 <= waited < hold + 2.0, waited
    recs = flight("ckpt_drain_wait")
    assert [r["pods"] for r in recs] == [["drain-00"]], recs


_DDP_WORKER = r"""
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint import FileSystemWriter
from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.parallel import data_parallel, make_mesh
from edl_tpu_torch.train import adamw, create_state, cross_entropy_loss, make_train_step
from edl_tpu_torch.train import context

ckpt, out, cfg = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
env = context.init(device="cpu")
rank = env.global_rank
seen = {}
real_async_save = dcp.async_save

def spy(*a, **kw):
    seen["pg_is_ckpt_group"] = kw.get("process_group") is context.checkpoint_group()
    seen["pg_is_default"] = kw.get("process_group") is dist.group.WORLD
    return real_async_save(*a, **kw)

dcp.async_save = spy
write_data = FileSystemWriter.write_data

def slow(self, plan, planner):
    time.sleep(1.0)  # the DDP steps below run while this write is open
    return write_data(self, plan, planner)

FileSystemWriter.write_data = slow
mesh = make_mesh(device="cpu")
state = create_state(TransformerLM(dtype=torch.float32, device="cpu", **cfg),
                     0, adamw(1e-3), device="cpu")
state.apply_fn = data_parallel(state.apply_fn, mesh)
step = make_train_step(cross_entropy_loss)
rng = np.random.RandomState(rank)

def batch():
    tok = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (2, 17)))
    return tok[:, :-1], tok[:, 1:]

for _ in range(2):
    state, _ = step(state, batch())

def digest(s):
    return {k: v.detach().clone() for k, v in s.params.items()}

want = digest(state)
mngr = CheckpointManager(ckpt, async_save=True)
mngr.save(state, TrainStatus(epoch=0, step=2))
in_flight = mngr.latest_step() is None
for _ in range(3):  # DDP all-reduces on the default group meanwhile
    state, _ = step(state, batch())
mngr.wait()
fresh = create_state(TransformerLM(dtype=torch.float32, device="cpu", **cfg),
                     1, adamw(1e-3), device="cpu")
fresh.apply_fn = data_parallel(fresh.apply_fn, mesh)
restored, status = mngr.restore(fresh)
mngr.close()
got = digest(restored)
same = all(torch.equal(got[k], v) for k, v in want.items())
with open(out % rank, "w") as fh:
    json.dump({"same": same, "in_flight": in_flight, "step": status.step,
               "groups_differ": context.checkpoint_group() is not dist.group.WORLD,
               "files": sorted(os.listdir(ckpt)), **seen}, fh)
"""


def _run_session(argv, env, log_path, timeout):
    """A child in a session of its own, killed with its group at the end."""
    log = open(log_path, "w")
    proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)
    return proc, log


def test_async_save_on_its_own_group_while_ddp_steps(tmp_path, clean_env):
    """Two gloo ranks: the background write's collectives run on the
    checkpoint group while DDP steps all-reduce on the default group."""
    port = find_free_ports(1)[0]
    out = str(tmp_path / "out-%d.json")
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
            env.update(
                PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", EDL_JOB_ID="tiers", EDL_STAGE="s1",
                EDL_POD_ID="pod-%d" % rank, EDL_WORKER_RANK=str(rank),
                EDL_NUM_WORKERS="2", EDL_COORDINATOR="127.0.0.1:%d" % port,
            )
            procs.append(_run_session(
                [sys.executable, "-c", _DDP_WORKER, str(tmp_path / "ck"), out,
                 json.dumps(CFG)],
                env, str(tmp_path / ("w%d.log" % rank)), SUBPROCESS_TIMEOUT))
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()
    for rank, (proc, _) in enumerate(procs):
        text = (tmp_path / ("w%d.log" % rank)).read_text()
        assert proc.returncode == 0, text[-3000:]
        with open(out % rank) as fh:
            rec = json.load(fh)
        assert rec["same"] and rec["in_flight"] and rec["step"] == 2, rec
        assert rec["pg_is_ckpt_group"] and not rec["pg_is_default"], rec
        assert rec["groups_differ"], rec
        assert rec["files"] == ["2"], rec  # no torn temp dir left


def test_hot_restage_waits_for_the_save_in_flight(tmp_path, clean_env,
                                                  monkeypatch, slow_writes):
    """The stage is superseded right after an epoch's async save: the
    trainer's manager finalizes that save before the process group is
    torn down for the next stage."""
    from edl_tpu_torch.cluster.model import Cluster
    from edl_tpu_torch.train import ElasticTrainer
    from edl_tpu_torch.train import context as ctx
    from edl_tpu_torch.train import loop

    slow_writes[0] = 1.0
    ckpt = tmp_path / "ck"
    saved, seen = [], []
    real_save = CheckpointManager.save

    def save(self, *a, **kw):
        saved.append(real_save(self, *a, **kw))
        return saved[-1]

    class Monitor:
        pending_since = None

        def __init__(self, env):
            pass

        @property
        def restage_pending(self):
            return bool(saved) and not seen

        def wait_for_my_stage(self, pod_id, timeout=20.0):
            return Cluster(stage="stage-2")

        def mark_adopted(self, *a):
            pass

        def arm(self, stage):
            pass

        def close(self):
            pass

    def reinit(cluster, pod_id, rank_in_pod, device="cuda"):
        seen.append(sorted(os.listdir(ckpt)))
        return ctx.init(device=device)

    def no_capture(*a, **kw):
        raise RuntimeError("no capture plane in this test")

    clean_env.setenv("EDL_HOT_RESTAGE", "1")
    clean_env.setenv("EDL_STORE_ENDPOINT", "127.0.0.1:1")
    monkeypatch.setattr(CheckpointManager, "save", save)
    monkeypatch.setattr(ctx, "StageMonitor", Monitor)
    monkeypatch.setattr(ctx, "reinit_for_stage", reinit)
    monkeypatch.setattr(loop.obs_profile, "CaptureController", no_capture)

    def data_fn(epoch):
        rng = np.random.RandomState(epoch)
        for _ in range(2):
            tok = rng.randint(0, CFG["vocab_size"], (2, 17)).astype(np.int64)
            yield tok[:, :-1], tok[:, 1:]

    trainer = ElasticTrainer(
        TransformerLM(dtype=torch.float32, device="cpu", **CFG), adamw(1e-3),
        cross_entropy_loss, ckpt_dir=str(ckpt), async_save=True,
        device="cpu", log=False,
    )
    state = trainer.fit(data_fn, 2)
    # the restage saw epoch 0's version finalized and no write in flight
    assert seen == [["2"]], seen
    assert int(state.step) == 4 and sorted(os.listdir(ckpt)) == ["2", "4"]


def test_refuse_deferred_planes_runs_the_holder(clean_env, tmp_path):
    """The port's launcher runs the replica holder beside every other
    pod-scoped plane: with a local tier, prewarming, standby shells and a
    named compile cache dir asked for, all of them start."""
    from test_torch_replicate import ChildStore

    from edl_tpu_torch.cluster.job_env import JobEnv
    from edl_tpu_torch.cluster.model import Cluster
    from edl_tpu_torch.launch.launcher import ElasticLauncher
    from edl_tpu_torch.obs import http as obs_http

    clean_env.setenv("EDL_CKPT_LOCAL_BASE", str(tmp_path / "local"))
    clean_env.setenv("EDL_CKPT_REPLICAS", "1")
    clean_env.setenv("EDL_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    clean_env.setenv("EDL_PREWARM_DELAY", "3600")  # started, not spawning
    clean_env.setenv("CUDA_VISIBLE_DEVICES", "")  # CPU workers: free
    srv = ChildStore()
    launcher = None
    try:
        job = JobEnv(job_id="j", store_endpoint=srv.endpoint)
        launcher = ElasticLauncher(job, sys.executable, prewarm=True,
                                   standby=True, ttl=1.0)
        launcher._note_stage_for_warmer(Cluster(pods=[], stage="s"))
        launcher._start_pod_planes()
        assert launcher.ckpt_replicas is not None
        assert launcher.extra_worker_env["EDL_CKPT_LOCAL_DIR"] == \
            os.path.join(str(tmp_path / "local"), launcher.pod.pod_id)
        assert launcher.warmer
        assert launcher.standby_pool._idle[0].poll() is None
        assert launcher.cache_exchange.cache_dir == str(tmp_path / "cache")
    finally:
        if launcher is not None:
            launcher._stop_pod_planes()
            launcher._obs_gauges.release()
            obs_http.release_health("launcher", launcher._health_fn)
            launcher.client.close()
        srv.stop()


def test_torn_metadata_falls_back_to_the_previous_version(tmp_path, clean_env):
    """A version whose DCP ``.metadata`` is torn: DCP raises its
    ``CheckpointException``, a ``BaseException``, which the restore's
    fallback must still catch — the previous version restores and the
    torn one is quarantined."""
    state = _train(_make_state(), 1)
    want = _digest(state)
    path = tmp_path / "ck"
    with CheckpointManager(str(path)) as mngr:
        mngr.save(state, TrainStatus(epoch=0, step=1))
        mngr.save(_train(state, 1, seed=3), TrainStatus(epoch=1, step=2))
    (path / "2" / ".metadata").write_bytes(b"\xde\xad" * 64)
    with CheckpointManager(str(path)) as mngr:
        restored, status = mngr.restore(_make_state(seed=1))
    assert status.step == 1 and (path / "2.corrupt").is_dir()
    _assert_digest(restored, want)


_AGREE_WORKER = r"""
import json, os, sys
import torch
from edl_tpu_torch.checkpoint import CheckpointManager
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import adamw, create_state
from edl_tpu_torch.train import context

dirs, out, cfg = json.loads(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
env = context.init(device="cpu")
rank = env.global_rank
state = create_state(TransformerLM(dtype=torch.float32, device="cpu", **cfg),
                     5 + rank, adamw(1e-3), device="cpu")
with CheckpointManager(dirs[rank]) as mngr:  # rank 1's tiers hold nothing
    state, status = mngr.restore(state)
    mine = status.step if status is not None else None
    status = mngr.agree(state, status)
digest = {k: v.detach().double().sum().item() for k, v in state.params.items()}
moments = sum(v.double().sum().item()
              for slots in state.opt_state.optimizer.state.values()
              for v in slots.values() if torch.is_tensor(v))
with open(out % rank, "w") as fh:
    json.dump({"mine": mine, "agreed": status.step, "digest": digest,
               "moments": moments, "step": int(state.step),
               "count": state.opt_state.count}, fh)
"""


def test_ranks_agree_on_one_restored_version(tmp_path, clean_env):
    """Rank 0's pod-local tier holds a version, rank 1's holds none: after
    ``agree`` both ranks hold rank 0's restored state and status."""
    state = _train(_make_state(), 2)
    with CheckpointManager(str(tmp_path / "a")) as mngr:
        mngr.save(state, TrainStatus(epoch=0, step=2))
    port = find_free_ports(1)[0]
    out = str(tmp_path / "agree-%d.json")
    dirs = json.dumps([str(tmp_path / "a"), str(tmp_path / "b")])
    procs = []
    try:
        for rank in range(2):
            env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
            env.update(
                PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1", EDL_JOB_ID="agree", EDL_STAGE="s1",
                EDL_POD_ID="pod-%d" % rank, EDL_WORKER_RANK=str(rank),
                EDL_NUM_WORKERS="2", EDL_COORDINATOR="127.0.0.1:%d" % port,
            )
            procs.append(_run_session(
                [sys.executable, "-c", _AGREE_WORKER, dirs, out, json.dumps(CFG)],
                env, str(tmp_path / ("a%d.log" % rank)), SUBPROCESS_TIMEOUT))
        deadline = time.monotonic() + SUBPROCESS_TIMEOUT
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()
    recs = []
    for rank, (proc, _) in enumerate(procs):
        assert proc.returncode == 0, \
            (tmp_path / ("a%d.log" % rank)).read_text()[-3000:]
        with open(out % rank) as fh:
            recs.append(json.load(fh))
    assert [r["mine"] for r in recs] == [2, None]
    assert [r["agreed"] for r in recs] == [2, 2]
    assert recs[0]["digest"] == recs[1]["digest"]
    assert recs[0]["moments"] == recs[1]["moments"]
    assert recs[0]["step"] == recs[1]["step"] == 2
    assert recs[0]["count"] == recs[1]["count"] == 2
    want = {k: v.double().sum().item() for k, v in state.params.items()}
    assert recs[0]["digest"] == want
