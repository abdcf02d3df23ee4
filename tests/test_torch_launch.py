"""The port's launcher and store on the CPU, against the JAX package's.

Every store server and launcher runs in a child process of its own
session (``start_new_session``), started by :class:`Rig`, which kills each
child's whole process group in ``finally``; the workers the launchers
spawn run in sessions of their own and die with their launcher
(``PR_SET_PDEATHSIG``). No test signals its own process or group.

- The port launcher, around ``torch_hot_restage_worker.py``, writes the
  same permanent store keys under ``/{job}/`` as the JAX launcher does
  for the same schedule (one pod, a second joins, the joiner is
  SIGKILLed), with pod ids and stage tokens masked.
- The launcher starts the pod-scoped planes a knob asks for (standby
  shells, the prewarmer, the compile-cache exchange, the replica holder).
- ``terminate_local_workers`` ends a worker's whole process tree without
  ``psutil``, SIGKILLing what ignores SIGTERM.
- The backend rule for ranks that outnumber their host's cards.
"""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

from conftest import TOY_WORKER

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_hot_restage_worker.py")
STEPS_PER_EPOCH = 3  # the worker's BATCHES
CHILD_TIMEOUT = 90.0


class Rig:
    """A store server and launcher pods of one package (``edl_tpu`` or
    ``edl_tpu_torch``), each a child process in its own session."""

    def __init__(self, work, pkg="edl_tpu_torch", hot=False, **env):
        self.work = str(work)
        self.pkg = pkg
        self.hot = hot
        self.out = os.path.join(self.work, "out")
        self.ckpt = os.path.join(self.work, "ckpt")
        os.makedirs(self.out, exist_ok=True)
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith("EDL_")}
        self.env.update({
            "PYTHONPATH": REPO + os.pathsep + self.env.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1",
            # a CPU worker loads no kernel library: no cache to exchange
            "EDL_COMPILE_CACHE_DIR": "none",
            "EDL_DEVICES_PER_PROC": "1",
            "EDL_CKPT_PATH": self.ckpt,
            "TEST_OUT_DIR": self.out,
        })
        self.env.update(env)
        self.procs = []
        self.endpoint = None
        try:
            srv = self._spawn(
                [sys.executable, "-m", pkg + ".store.server",
                 "--host", "127.0.0.1", "--port", "0"],
                stderr=subprocess.PIPE,
            )
            deadline = time.monotonic() + CHILD_TIMEOUT
            for line in srv.stderr:
                found = re.search(rb"store serving on port (\d+)", line)
                if found:
                    self.endpoint = "127.0.0.1:%d" % int(found.group(1))
                    break
                if time.monotonic() > deadline:
                    break
            assert self.endpoint, "store server did not start"
        except BaseException:
            self.close()
            raise

    def _spawn(self, cmd, **kwargs):
        proc = subprocess.Popen(cmd, env=self.env, cwd=self.work,
                                start_new_session=True, **kwargs)
        self.procs.append(proc)
        return proc

    def pod(self, job="j"):
        cmd = [sys.executable, "-m", self.pkg + ".launch", "--job_id", job,
               "--store", self.endpoint, "--nodes_range", "1:2",
               "--ttl", "1.0", "--log_dir", os.path.join(self.work, "logs")]
        if self.hot:
            cmd.append("--hot_restage")
        return self._spawn(cmd + [WORKER])

    def kill(self, proc, sig=signal.SIGKILL):
        """Signal one pod's launcher (its own session: never ours)."""
        assert proc.pid != os.getpid() and proc.pid != os.getpgrp()
        os.kill(proc.pid, sig)

    def has_version(self, epoch):
        """Epoch ``epoch``'s checkpoint is in place."""
        return os.path.isdir(os.path.join(
            self.ckpt, str((epoch + 1) * STEPS_PER_EPOCH)))

    def held(self, epoch):
        return os.path.exists(os.path.join(self.out, "hold.%d" % epoch))

    def keys(self, job="j"):
        """Every key under ``/{job}/``, with its lease (0: permanent)."""
        from edl_tpu_torch.store.client import StoreClient

        client = StoreClient(self.endpoint, timeout=10.0)
        try:
            items, _ = client.range("/%s/" % job)
        finally:
            client.close()
        return {key: lease for key, _v, _r, lease in items}

    def outputs(self):
        return sorted(os.listdir(self.out))

    def close(self):
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            if proc.stderr is not None:
                proc.stderr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def wait_for(cond, what, timeout=CHILD_TIMEOUT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError("timed out waiting for " + what)


def churn(rig):
    """One pod; at epoch 1 a second joins; at epoch 2 the joiner is
    SIGKILLed. Each change waits for the previous epoch's checkpoint and
    for the workers to hold at the epoch's start. Returns the first pod's
    exit code."""
    first = rig.pod()
    wait_for(lambda: rig.has_version(0) and rig.held(1), "epoch 0 and hold 1")
    joiner = rig.pod()
    wait_for(lambda: rig.has_version(1) and rig.held(2), "epoch 1 and hold 2")
    rig.kill(joiner)
    joiner.wait(timeout=CHILD_TIMEOUT)
    return first.wait(timeout=CHILD_TIMEOUT)


_HEX = re.compile(r"[0-9a-f]{8,32}")


def masked_permanent_keys(keys):
    """Permanent keys with pod ids and stage tokens masked (leased keys
    come and go with their leases' timing)."""
    return sorted({_HEX.sub("<id>", k) for k, lease in keys.items()
                   if lease == 0})


def _run_churn(work, pkg):
    with Rig(work, pkg=pkg, TEST_HOLD_EPOCHS="1,2", TEST_EPOCHS="3") as rig:
        rc = churn(rig)
        return rc, rig.keys(), rig.outputs()


def test_port_launcher_writes_the_jax_launchers_keys(tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        runs = {pkg: pool.submit(_run_churn, tmp_path / pkg, pkg)
                for pkg in ("edl_tpu", "edl_tpu_torch")}
        runs = {pkg: fut.result() for pkg, fut in runs.items()}
    for pkg, (rc, _keys, outs) in runs.items():
        assert rc == 0, pkg
        assert any(o.startswith("done.") for o in outs), (pkg, outs)
    jax_keys = masked_permanent_keys(runs["edl_tpu"][1])
    port_keys = masked_permanent_keys(runs["edl_tpu_torch"][1])
    assert port_keys == jax_keys
    assert "/j/job/status" in port_keys and "/j/drain/token" in port_keys
    assert "/j/events/<id>/published.<id>" in port_keys


@pytest.fixture()
def plane_launcher(monkeypatch, tmp_path):
    """``make()``: a port ``ElasticLauncher`` on a port store child (its own
    session), built under the env the test set; every pod-scoped plane it
    started is stopped and the store killed when the test ends."""
    from test_torch_replicate import ChildStore

    from edl_tpu_torch.cluster.job_env import JobEnv
    from edl_tpu_torch.launch.launcher import ElasticLauncher
    from edl_tpu_torch.obs import http as obs_http

    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EDL_PREWARM_DELAY", "3600")  # started, not spawning
    srv = ChildStore()
    made = []

    def make():
        job = JobEnv(job_id="planes", store_endpoint=srv.endpoint)
        launcher = ElasticLauncher(job, TOY_WORKER, ttl=1.0)
        made.append(launcher)
        return launcher

    try:
        yield make
    finally:
        for launcher in made:
            launcher._stop_pod_planes()
            launcher._obs_gauges.release()
            obs_http.release_health("launcher", launcher._health_fn)
            launcher.client.close()
        srv.stop()


# the ids name the ROADMAP items that refused these planes before the port
# ran them
@pytest.mark.parametrize("knobs, plane", [
    pytest.param({"EDL_STANDBY": "1"}, "standby_pool", id="knobs0-M23"),
    pytest.param({"EDL_PREWARM": "1", "CUDA_VISIBLE_DEVICES": ""}, "warmer",
                 id="knobs1-M22"),
    pytest.param({"EDL_COMPILE_CACHE_DIR": "NAMED"}, "cache_exchange",
                 id="knobs2-M22"),
    pytest.param({"EDL_CKPT_LOCAL_BASE": "LOCAL"}, "ckpt_replicas",
                 id="knobs3-item 4"),
])
def test_launcher_refuses_planes_not_ported(monkeypatch, tmp_path,
                                            plane_launcher, knobs, plane):
    """Each pod-scoped plane a knob asks for starts in the port's
    launcher: the standby shells (a live shell), the prewarmer (at the
    first adopted stage), the exchange over a named cache dir and the
    replica holder; the knob switched off, it does not."""
    from edl_tpu_torch.cluster.model import Cluster

    values = {"NAMED": str(tmp_path / "cache"), "LOCAL": str(tmp_path / "l")}
    for key, value in knobs.items():
        monkeypatch.setenv(key, values.get(value, value))
    stage = Cluster(pods=[], stage="s")
    launcher = plane_launcher()
    launcher._note_stage_for_warmer(stage)
    launcher._start_pod_planes()
    started = getattr(launcher, plane)
    assert started
    if plane == "standby_pool":
        assert started._idle and started._idle[0].poll() is None
    if plane == "cache_exchange":
        assert started.cache_dir == values["NAMED"]
    # the way out: the knob switched off
    for key in knobs:
        monkeypatch.delenv(key)
    monkeypatch.setenv("EDL_STANDBY", "0")
    monkeypatch.setenv("EDL_CACHE_EXCHANGE", "0")
    monkeypatch.setenv("EDL_CKPT_REPLICAS", "0")
    off = plane_launcher()
    off._note_stage_for_warmer(stage)
    off._start_pod_planes()
    assert not getattr(off, plane)


def test_launcher_runs_with_the_default_cache_dir(monkeypatch,
                                                  plane_launcher):
    """The job-scoped default cache dir is a cache dir like a named one:
    the launcher serves it through the exchange (the JAX launcher's rule);
    ``EDL_CACHE_EXCHANGE=0`` keeps the dir without the exchange, and
    ``none`` has no dir."""
    launcher = plane_launcher()
    assert launcher.job_env.compile_cache_dir  # the job-scoped default
    launcher._start_pod_planes()
    assert launcher.cache_exchange.cache_dir == \
        launcher.job_env.compile_cache_dir
    monkeypatch.setenv("EDL_CACHE_EXCHANGE", "0")
    quiet = plane_launcher()
    quiet._start_pod_planes()
    assert quiet.cache_exchange is None
    monkeypatch.delenv("EDL_CACHE_EXCHANGE")
    monkeypatch.setenv("EDL_COMPILE_CACHE_DIR", "none")
    bare = plane_launcher()
    assert bare.job_env.compile_cache_dir == ""
    bare._start_pod_planes()
    assert bare.cache_exchange is None


_TREE = r"""
import os, signal, subprocess, sys, time
if sys.argv[1] == "stubborn":
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
child = subprocess.Popen([sys.executable, "-c",
    "import signal, time; signal.signal(signal.SIGTERM, signal.SIG_IGN); "
    "time.sleep(120)"])
with open(sys.argv[2], "w") as fh:
    fh.write(str(child.pid))
time.sleep(120)
"""


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    with open("/proc/%d/stat" % pid) as fh:  # a zombie is dead
        return fh.read().split(")")[-1].split()[0] != "Z"


@pytest.mark.parametrize("kind", ["polite", "stubborn"])
def test_terminate_ends_the_tree_without_psutil(tmp_path, kind, monkeypatch):
    from edl_tpu_torch.cluster.model import Worker
    from edl_tpu_torch.launch import process

    monkeypatch.setitem(sys.modules, "psutil", None)  # importing it raises
    marker = str(tmp_path / "grandchild")
    proc = subprocess.Popen([sys.executable, "-c", _TREE, kind, marker],
                            start_new_session=True)
    try:
        wait_for(lambda: os.path.exists(marker) and open(marker).read(),
                 "the grandchild", timeout=30)
        grandchild = int(open(marker).read())
        assert os.getpgid(proc.pid) == proc.pid != os.getpgrp()
        wp = process.WorkerProc(Worker("127.0.0.1:1", 0, 0), proc)
        t0 = time.monotonic()
        process.terminate_local_workers([wp], grace=1.0)
        took = time.monotonic() - t0
        assert wp.exit_code is not None
        wait_for(lambda: not _alive(grandchild), "the grandchild's end",
                 timeout=10)
        if kind == "polite":
            assert wp.exit_code == -signal.SIGTERM and took < 1.0
        else:
            assert wp.exit_code == -signal.SIGKILL and took >= 1.0
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)


def test_terminate_skips_reaped_workers(tmp_path):
    from edl_tpu_torch.cluster.model import Worker
    from edl_tpu_torch.launch import process

    proc = subprocess.Popen([sys.executable, "-c", "pass"],
                            start_new_session=True)
    proc.wait(timeout=30)
    wp = process.WorkerProc(Worker("127.0.0.1:1", 0, 0), proc)
    process.terminate_local_workers([wp], grace=0.5)  # nothing to signal
    assert wp.exit_code == 0


def _env(endpoints, rank, nproc=1):
    from edl_tpu_torch.cluster.job_env import WorkerEnv

    env = WorkerEnv.__new__(WorkerEnv)
    env.worker_endpoints = endpoints
    env.global_rank = rank
    env.rank_in_pod = rank % nproc  # pods of nproc ranks, in rank order
    env.nproc_per_node = nproc
    return env


H1 = ["10.0.0.1:%d" % p for p in range(1, 9)]
H2 = ["10.0.0.2:%d" % p for p in range(1, 9)]


@pytest.mark.parametrize("endpoints, nproc, cards, want", [
    (H1[:2], 2, 1, "gloo"),  # one pod of two ranks on one card
    (H1[:2], 2, 2, "nccl"),  # a card each
    (H1[:2], 1, 1, "gloo"),  # two one-rank pods on one card
    (H1[:2], 1, 2, "gloo"),  # two one-rank pods of a two-card host: card 0
    (H1[:1] + H2[:1], 1, 1, "nccl"),  # one rank a host
    (H1[:2] + H2[:1], 1, 1, "gloo"),  # [h1, h1, h2]: one stage, one backend
    (H1[:4] + H2[:4], 4, 4, "nccl"),
    (H1[:8], 8, 4, "gloo"),
])
def test_group_backend_rule(endpoints, nproc, cards, want):
    from edl_tpu_torch.train.context import group_backend

    # every rank of the stage decides alike
    for rank in range(len(endpoints)):
        env = _env(endpoints, rank, nproc)
        assert group_backend(env, "cuda", cards) == want, rank
        assert group_backend(env, "cpu", cards) == "gloo"
    # gloo exactly when two ranks would share a card under init's
    # assignment (card rank_in_pod % cards on the rank's host)
    cards_used = [(ep.rsplit(":", 1)[0], (r % nproc) % cards)
                  for r, ep in enumerate(endpoints)]
    assert (want == "gloo") == (len(set(cards_used)) < len(cards_used))


def test_group_backend_without_endpoints_counts_the_pod():
    from edl_tpu_torch.train.context import group_backend

    assert group_backend(_env([], 0, nproc=2), "cuda", 1) == "gloo"
    assert group_backend(_env([], 0, nproc=2), "cuda", 2) == "nccl"


def test_launch_main_module_runs_only_as_a_script():
    out = subprocess.run(
        [sys.executable, "-c", "import edl_tpu_torch.launch.__main__"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), start_new_session=True,
    )
    assert out.returncode == 0, out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.launch", "--help"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), start_new_session=True,
    )
    assert out.returncode == 0 and "--hot_restage" in out.stdout.replace(
        "--hot-restage", "--hot_restage")
