"""Hot-standby worker shells of the port (``edl_tpu_torch/launch/
standby.py``), on the CPU, mirroring ``tests/test_standby.py``, and the
restage planes together in one two-pod launch.

The pool's mechanics (spawn, activate, fallback, replacement, teardown)
run with a probe script: an activated shell runs the script in its own
pid under the spec's env, with ``torch`` and the package's modules
already imported and no ``jax*`` or ``edl_tpu.*`` module loaded, and it
pulls the compile-cache entries a peer's exchange serves before the
script starts. The launcher integration runs its workers through the
shells. The two-pod launch (the port's store and launcher around
``tests/torch_hot_restage_worker.py``): pod A with ``--prewarm`` and a
named cache dir holding a kernel library warms world 2 in a shadow stage
and publishes world 2's rung plan; pod B joins with ``--standby`` and an
empty named dir, and B's worker — the shell's pid — finds A's library in
its dir, byte-identical, before its first step. Every shell, launcher and
store runs in a session of its own, killed by session in ``finally``.

Tolerances: exact (pids, bytes, digests, keys).
"""

import hashlib
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from conftest import TOY_WORKER, incarnations
from edl_tpu_torch.launch.standby import StandbyPool, standby_enabled
from edl_tpu_torch.store.client import StoreClient
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_hot_restage_worker.py")

# a worker script that proves which pid ran it and what env it saw
PROBE = """
import json, os, sys
out = os.environ["PROBE_OUT"]
cache = os.environ.get("EDL_COMPILE_CACHE_DIR", "")
with open(out, "w") as f:
    json.dump({
        "pid": os.getpid(),
        "rank": os.environ.get("EDL_WORKER_RANK"),
        "spawn_only": os.environ.get("SPAWN_ONLY"),
        "argv": sys.argv,
        "preloaded": [m for m in ("numpy", "torch", "edl_tpu_torch.train",
                                  "edl_tpu_torch.ops._build")
                      if m in sys.modules],
        "leaked": sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "optax", "edl_tpu")),
        "cache": sorted(os.listdir(cache)) if os.path.isdir(cache) else None,
        "pulled": os.environ.get("EDL_CACHE_PULLED"),
    }, f)
"""


@pytest.fixture(scope="module")
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


def _spawn_env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update({"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    env.update(extra or {})
    return env


@pytest.fixture()
def pool_of():
    """``pool_of(env, count)``: a pool whose shells are killed by session
    when the test ends."""
    pools = []

    def make(env, count=1):
        pool = StandbyPool(env, count=count)
        pools.append((pool, [p.pid for p in pool._idle]))
        return pool

    yield make
    for pool, pids in pools:
        pool.stop()
        for pid in pids:
            try:
                os.killpg(pid, signal.SIGKILL)  # the shell's own session
            except (ProcessLookupError, PermissionError):
                pass


def _alive(pid):
    try:
        with open("/proc/%d/stat" % pid) as fh:
            return fh.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


class TestPoolMechanics:
    def test_activate_runs_script_in_shell_pid(self, tmp_path, pool_of):
        script = tmp_path / "probe.py"
        script.write_text(PROBE)
        out = tmp_path / "probe.json"
        pool = pool_of(_spawn_env({"SPAWN_ONLY": "1"}))
        shell_pid = pool._idle[0].pid
        proc = pool.activate(
            _spawn_env({"PROBE_OUT": str(out), "EDL_WORKER_RANK": "3"}),
            str(script), ["--flag", "x"],
        )
        assert proc is not None and proc.pid == shell_pid
        assert proc.wait(timeout=60) == 0
        rec = json.loads(out.read_text())
        assert rec["pid"] == shell_pid  # the shell became the worker
        assert rec["rank"] == "3"
        assert rec["spawn_only"] is None  # the env replaced wholesale
        assert rec["argv"] == [str(script), "--flag", "x"]
        assert rec["preloaded"] == ["numpy", "torch", "edl_tpu_torch.train",
                                    "edl_tpu_torch.ops._build"]
        assert rec["leaked"] == []

    def test_activation_replaces_consumed_shell_via_ensure(self, tmp_path,
                                                           pool_of):
        script = tmp_path / "probe.py"
        script.write_text(PROBE)
        pool = pool_of(_spawn_env())
        first = pool.activate(
            _spawn_env({"PROBE_OUT": str(tmp_path / "a.json")}),
            str(script), [],
        )
        assert first is not None and first.wait(timeout=60) == 0
        assert not pool._idle  # consumed
        pool.ensure()
        assert len(pool._idle) == 1
        assert pool._idle[0].pid != first.pid

    @pytest.mark.parametrize("var, value", [
        ("CUDA_VISIBLE_DEVICES", ""), ("EDL_COMPILE_CACHE_DIR", "/x")])
    def test_env_mismatch_declines(self, pool_of, var, value):
        """A variable the shell acted on before activation (the visible
        cards, the kernel-library dir it resolved) changed: cold spawn."""
        pool = pool_of(_spawn_env())
        env = _spawn_env({var: value})
        assert pool.activate(env, TOY_WORKER, []) is None

    def test_dead_shell_falls_back_to_none(self, pool_of):
        pool = pool_of(_spawn_env())
        pool._idle[0].kill()
        pool._idle[0].wait()
        assert pool.activate(_spawn_env(), TOY_WORKER, []) is None

    def test_stop_kills_idle_shells(self, pool_of):
        pool = pool_of(_spawn_env(), count=2)
        pids = [p.pid for p in pool._idle]
        assert all(_alive(pid) for pid in pids)
        pool.stop()
        assert not any(_alive(pid) for pid in pids)

    def test_log_path_redirect(self, tmp_path, pool_of):
        script = tmp_path / "noisy.py"
        script.write_text("print('worker says hi')\n")
        log = tmp_path / "worker.log"
        pool = pool_of(_spawn_env())
        proc = pool.activate(_spawn_env(), str(script), [], str(log))
        assert proc is not None and proc.wait(timeout=60) == 0
        assert "worker says hi" in log.read_text()

    def test_enabled_flag_logic(self, monkeypatch):
        monkeypatch.delenv("EDL_STANDBY", raising=False)
        assert not standby_enabled()
        assert standby_enabled(True)
        monkeypatch.setenv("EDL_STANDBY", "1")
        assert standby_enabled()
        monkeypatch.setenv("EDL_STANDBY", "0")
        assert not standby_enabled(True)  # env force-off beats the flag

    def test_activation_pulls_peer_entries_before_the_script(
            self, tmp_path, store, pool_of):
        """The shell's activation path pulls what a peer's exchange serves
        into the stage's cache dir, then runs the script, and tells
        ``train.init`` not to pull again (``EDL_CACHE_PULLED=1``)."""
        from edl_tpu_torch.train import aot

        served = tmp_path / "served"
        served.mkdir()
        (served / "libflash_fwd-0011223344556677.so").write_bytes(b"lib" * 99)
        mine = tmp_path / "mine"
        client = StoreClient(store.endpoint)
        xchg = aot.CacheExchange(str(served), client, "sbpull", "podA",
                                 host="127.0.0.1").start()
        try:
            deadline = time.monotonic() + 10
            while "podA" not in aot.read_manifests(client, "sbpull"):
                assert time.monotonic() < deadline
                time.sleep(0.05)
            script = tmp_path / "probe.py"
            script.write_text(PROBE)
            out = tmp_path / "probe.json"
            env = {"EDL_COMPILE_CACHE_DIR": str(mine)}
            pool = pool_of(_spawn_env(env))
            proc = pool.activate(_spawn_env(dict(
                env, PROBE_OUT=str(out), EDL_STORE_ENDPOINT=store.endpoint,
                EDL_JOB_ID="sbpull", EDL_POD_ID="podB")), str(script), [])
            assert proc is not None and proc.wait(timeout=60) == 0
        finally:
            xchg.stop()
            client.close()
        rec = json.loads(out.read_text())
        assert rec["cache"] == ["libflash_fwd-0011223344556677.so"]
        assert rec["pulled"] == "1"
        assert (mine / rec["cache"][0]).read_bytes() == b"lib" * 99


def _launcher(store, job, out_dir, args=(), exit_after=None, extra=None,
              log=None):
    env = _spawn_env({"TEST_OUT_DIR": str(out_dir), "EDL_STANDBY": "1"})
    if exit_after is not None:
        env["TEST_EXIT_AFTER"] = str(exit_after)
    env.update(extra or {})
    return subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.launch", "--job_id", job,
         "--store", store.endpoint, "--nodes_range", "1:2",
         "--nproc_per_node", "1", "--ttl", "1.0", *args],
        env=env, cwd=str(out_dir), start_new_session=True,
        stdout=open(log, "wb") if log else subprocess.DEVNULL,
        stderr=subprocess.STDOUT,
    )


def _kill(*procs):
    for proc in procs:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)


def test_single_pod_completes_through_standby(store, tmp_path):
    log = str(tmp_path / "pod.log")
    launcher = _launcher(store, "sb1", tmp_path, [TOY_WORKER],
                         exit_after=0.5, log=log)
    try:
        assert launcher.wait(timeout=90) == 0
    finally:
        _kill(launcher)
    assert len(incarnations(str(tmp_path))) == 1
    text = open(log).read()
    shell = re.search(r"standby shell pid=(\d+) spawned", text)
    assert shell and "standby pid=%s activated" % shell.group(1) in text
    # no standby shell outlives its launcher
    pids = [int(p) for p in re.findall(r"standby shell pid=(\d+)", text)]
    deadline = time.monotonic() + 10
    while any(_alive(pid) for pid in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not any(_alive(pid) for pid in pids)


def test_two_pods_fill_the_joiners_cache_before_its_first_step(
        store, tmp_path):
    """The restage planes in one launch: A (``--prewarm``, a named cache
    dir holding a kernel library) trains alone, warms world 2 in a shadow
    stage and publishes world 2's rung plan; B (``--standby``, an empty
    named dir) joins; B's worker is its shell and finds A's library in its
    dir, byte-identical, before its first step; the job completes."""
    from edl_tpu_torch.ops import _build

    out = tmp_path / "out"
    out.mkdir()
    dirs = {p: tmp_path / ("cache" + p) for p in "AB"}
    for d in dirs.values():
        d.mkdir()
    lib = _build.library_name("flash_fwd")
    (dirs["A"] / lib).write_bytes(os.urandom(4096))
    extra = {"CUDA_VISIBLE_DEVICES": "", "EDL_PREWARM_DELAY": "0",
             "EDL_CKPT_PATH": str(tmp_path / "ckpt"), "TEST_EPOCHS": "2",
             "TEST_HOLD_EPOCHS": "1", "TEST_RECORD_CACHE": "1",
             "EDL_STANDBY": "0"}
    logs = {p: str(tmp_path / ("pod%s.log" % p)) for p in "AB"}
    a = _launcher(store, "planes", out, ["--prewarm", "--compile_cache_dir",
                                         str(dirs["A"]), WORKER],
                  extra=extra, log=logs["A"])
    b = None
    client = StoreClient(store.endpoint)
    try:
        deadline = time.monotonic() + 90
        while not (os.path.exists(out / "hold.1")
                   and client.get("/planes/mem/plan/2")
                   and (client.get("/planes/warm/2") or b"").startswith(
                       b"done:")):
            assert time.monotonic() < deadline, open(logs["A"]).read()[-3000:]
            assert a.poll() is None, open(logs["A"]).read()[-3000:]
            time.sleep(0.1)
        rung = json.loads(client.get("/planes/mem/plan/2"))
        b = _launcher(store, "planes", out, ["--standby", "--compile_cache_dir",
                                             str(dirs["B"]), WORKER],
                      extra=dict(extra, EDL_STANDBY="1"), log=logs["B"])
        assert a.wait(timeout=120) == 0, open(logs["A"]).read()[-3000:]
        assert b.wait(timeout=60) == 0, open(logs["B"]).read()[-3000:]
        keys = {k for k, _v, _r, _l in client.range("/planes/")[0]}
    finally:
        client.close()
        _kill(a, *([b] if b else []))
    assert rung["world"] == 2 and rung["argument"] > 0
    assert "/planes/aot/2" in keys
    recs = {n: json.loads(open(out / n).read())
            for n in os.listdir(out) if n.startswith("cache.")}
    joined = [r for r in recs.values() if r["cache_dir"] == str(dirs["B"])]
    assert len(joined) == 1, recs
    rec = joined[0]
    digest = hashlib.sha256(
        (dirs["A"] / lib).read_bytes()).hexdigest()
    assert rec["entries"] == {lib: digest} and rec["steps"] == 0
    assert rec["pulled_env"] == "1" and rec["rx_bytes"] == 4096
    assert rec["leaked"] == []
    text = open(logs["B"]).read()
    assert "standby pid=%d activated" % rec["pid"] in text
    warm = sorted(n for n in os.listdir(tmp_path / "out")
                  if n.startswith("pid.warm-2."))
    assert warm == ["pid.warm-2.0", "pid.warm-2.1"]
