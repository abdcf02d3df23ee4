"""The port's ``edl_top`` and ``edl_profile`` (``edl_tpu_torch/tools/``)
against the JAX package's (``tools/edl_top.py``, ``tools/edl_profile.py``).

- ``edl_top --once`` against a live port store (a child process) holding
  one job's stage events, worker meters and an obs endpoint: the JAX
  test's frame (``tests/test_obs.py``), and the same snapshot from both
  tools' ``--json`` (the volatile scrape fields aside).
- ``edl_profile --local --device cpu`` writes a ``torch.profiler`` trace
  and prints the JAX tool's keys; ``--local`` without a card raises.
- ``edl_profile --request`` through both CLIs is answered by a port
  worker's ``CaptureController`` stepping in this process: one result
  per pod, its Chrome trace on disk.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import profile as obs_profile
from edl_tpu_torch.obs.metrics import default_registry
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.tools import edl_profile as port_profile
from edl_tpu_torch.tools import edl_top as port_top
from edl_tpu_torch.utils import telemetry
from test_torch_replicate import ChildStore

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import edl_profile as jax_profile  # noqa: E402 — tools/ on sys.path
import edl_top as jax_top  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCAL_KEYS = {"metric", "value", "unit", "device", "platform", "step_flops",
              "flops_total", "captured_steps", "trace_files", "trace_dir",
              "loss"}


@pytest.fixture(scope="module")
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


def _seed_job(client, job):
    t = time.time()
    telemetry.record_event(client, job, "stageaaa", "drain", "p1", ts=t - 30)
    telemetry.record_event(client, job, "stageaaa", "published", "p1",
                           ts=t - 29)
    telemetry.record_stage(client, job, "stageaaa", {"world": 2, "ts": t - 29})
    telemetry.record_event(client, job, "stagebbb", "drain", "p1", ts=t - 20)
    telemetry.record_event(client, job, "stagebbb", "published", "p1",
                           ts=t - 19)
    telemetry.record_event(client, job, "stagebbb", "first_step", "w0",
                           ts=t - 18)
    telemetry.record_stage(client, job, "stagebbb", {"world": 2, "ts": t - 19})
    for rank, sps in ((0, 12.5), (1, 11.75)):
        client.put("/%s/metrics/stagebbb/w%d" % (job, rank), json.dumps(
            {"sps": sps, "steps": 40, "batch": 8, "t0": t - 18, "t1": t - 1,
             "world": 2}).encode())


def test_top_once_against_a_live_port_store(store, capsys):
    default_registry().counter(
        "edl_store_requests_total", "store RPCs dispatched, by method"
    ).inc(5, method="put")
    obs = obs_http.ObsServer("store", host="127.0.0.1", port=0,
                             health_fn=lambda: {"revision": 1}).start()
    client = StoreClient(store.endpoint, timeout=5.0)
    job = "topjob"
    try:
        _seed_job(client, job)
        obs_http.register_endpoint(client, job, "store", "s0",
                                   "127.0.0.1:%d" % obs.port)
        assert port_top.main(["--store", store.endpoint, "--job", job,
                              "--once"]) == 0
        out = capsys.readouterr().out
        assert "stage=stagebbb"[:14] in out
        assert "w0" in out and "12.5" in out
        assert "w1" in out and ("11.8" in out or "11.75" in out)
        assert "store.s0" in out and "ok" in out
        assert "stageaaa"[:8] in out  # transition line
        assert "downtime" in out
        snaps = {}
        for name, tool in (("jax", jax_top), ("port", port_top)):
            assert tool.main(["--store", store.endpoint, "--job", job,
                              "--once", "--json"]) == 0
            snaps[name] = json.loads(capsys.readouterr().out)
        for snap in snaps.values():
            snap.pop("ts")
            # scraped live (uptime, counters, the store's replication
            # status): who was scraped, and which fields each row has
            snap["endpoints"] = [(row["name"], row["endpoint"], row["up"],
                                  sorted(row)) for row in snap["endpoints"]]
            snap["shards"] = [(row["endpoint"], sorted(row))
                              for row in snap["shards"]]
        assert snaps["port"] == snaps["jax"]
        assert [r[:3] for r in snaps["port"]["endpoints"]] == [
            ("store.s0", "127.0.0.1:%d" % obs.port, True)]
    finally:
        client.close()
        obs.stop()


def test_top_gather_flags_dropped_telemetry(store):
    client = StoreClient(store.endpoint, timeout=5.0)
    try:
        client.put("/dropjob/events/s/first_step.w0", b"garbage")
        snap = port_top.gather(client, "dropjob")
        assert snap["dropped"] == 1
        assert "malformed" in port_top.render(snap)
    finally:
        client.close()


def test_profile_local_on_the_cpu_writes_a_trace(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.tools.edl_profile", "--local",
         "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert LOCAL_KEYS <= set(doc)
    assert (doc["metric"], doc["platform"], doc["device"]) == (
        "profile_plane_selftest", "cpu", "cpu")
    assert doc["trace_files"] >= 1 and doc["captured_steps"] == 5
    assert doc["trace_dir"].startswith(str(tmp_path))
    assert doc["step_flops"] > 0 and doc["flops_total"] > doc["step_flops"]
    (trace,) = [os.path.join(d, f) for d, _s, fs in os.walk(doc["trace_dir"])
                for f in fs]
    with open(trace) as f:
        assert json.load(f)["traceEvents"]


def test_profile_local_wants_a_card_unless_told_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_profile.main(["--local", "--steps", "1", "--out",
                           str(tmp_path)])


class _Env:
    job_id = "profjob"
    pod_id = "pod-a"
    rank_in_pod = 0
    global_rank = 0

    def __init__(self, endpoint):
        self.store_endpoint = endpoint


@pytest.mark.parametrize("tool", [jax_profile, port_profile],
                         ids=["jax-cli", "port-cli"])
def test_profile_request_answered_by_a_port_worker(store, tmp_path, tool,
                                                   capsys):
    import torch

    env = _Env(store.endpoint)
    env.job_id = "profjob-%s" % tool.__name__.split(".")[0]
    telemetry_ = obs_profile.StepTelemetry()
    controller = obs_profile.CaptureController(env, telemetry=telemetry_)
    stop = threading.Event()

    def worker():
        w = torch.zeros(32, 32)
        while not stop.is_set():
            w = w + torch.tanh(w @ w)
            telemetry_.observe_step()
            controller.on_step()
            time.sleep(0.01)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        rc = tool.main(["--store", store.endpoint, "--job", env.job_id,
                        "--request", "--steps", "3", "--timeout", "60",
                        "--out", str(tmp_path), "--json"])
        results = json.loads(capsys.readouterr().out)
        assert rc == 0
        (name,) = results
        doc = results[name]
        assert name == "pod-a" and doc["steps"] == 3
        assert doc["dir"].startswith(str(tmp_path))
        assert os.path.isfile(doc["trace"])
        # --once reads the published result back
        assert tool.main(["--store", store.endpoint, "--job", env.job_id,
                          "--once", "--json"]) == 0
        assert json.loads(capsys.readouterr().out) == results
    finally:
        stop.set()
        thread.join(timeout=10)
        controller.close()
        telemetry_.close()
