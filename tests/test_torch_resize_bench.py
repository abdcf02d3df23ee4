"""The port's resize-cost benchmark (``python -m
edl_tpu_torch.tools.resize_bench``) against ``tools/resize_bench.py``, on
the CPU.

- ``analyze`` is the JAX tool's: the same report, exactly, from the JAX
  tests' two telemetry dumps (``tests/test_resize_bench.py``'s
  ``test_analyze_pure`` and its restore/compile split).
- One CPU run of the tool for each schedule, the MLP workers on the
  port's store, harness and launcher (the tool in a child of its own
  session, killed with its session in ``finally``): ``1,r`` (SIGKILL the
  one pod, start a replacement) and ``1,2`` (a grow). Every stage is
  metered with samples/s > 0, no telemetry entry is dropped, and the
  transition's marks come in order: drain <= published <= ready <=
  first step, and for the grow drain <= killed <= published as well (the
  survivor's launcher records ``killed`` when it kills its own workers;
  after the ``r`` no pod survives to record it). The run takes at most
  ``RUN_BOUND_S`` seconds of wall clock.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from edl_tpu_torch.tools import resize_bench as port_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_BOUND_S = 120.0


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_resize_bench", os.path.join(REPO, "tools", "resize_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pure_dump():
    """``tests/test_resize_bench.py::test_analyze_pure``'s dump."""
    data = {
        "events": {
            "aaa": {
                "drain": {"p1": 100.0},
                "published": {"p1": 100.1},
                "first_step": {"w0": 103.0, "w1": 104.0},
            },
            "bbb": {
                "drain": {"p2": 200.0},
                "killed": {"p1": 200.5, "p2": 200.4},
                "published": {"p1": 201.0},
                "first_step": {"w0": 208.0, "w1": 207.0},
            },
            "ccc": {"drain": {"p9": 300.0}},  # never converged: ignored
        },
        "stages": {
            "aaa": {"world": 2, "pods": 2, "ts": 100.1},
            "bbb": {"world": 4, "pods": 4, "ts": 201.0},
        },
        "metrics": {
            "aaa": {"w0": {"sps": 50.0, "world": 2},
                    "w1": {"sps": 50.0, "world": 2}},
            "bbb": {"w%d" % i: {"sps": 48.0, "world": 4} for i in range(4)},
            "ddd": {"w0": {"sps": 49.0, "world": 2},
                    "w1": {"sps": 47.0, "world": 2}},
        },
    }
    data["events"]["ddd"] = {
        "drain": {"p1": 300.0},
        "published": {"p1": 301.0},
        "first_step": {"w0": 303.0},
    }
    data["stages"]["ddd"] = {"world": 2, "pods": 2, "ts": 301.0}
    return data


def _split_dump():
    """``tests/test_resize_bench.py``'s restore/compile split dump."""
    return {
        "events": {
            "aaa": {
                "published": {"p1": 100.0},
                "first_step": {"w0": 105.0},
            },
            "bbb": {
                "drain": {"p1": 200.0},
                "killed": {"p1": 200.2},
                "published": {"p1": 201.0},
                "ready": {"w0": 203.5},
                "first_step": {"w0": 204.0},
            },
        },
        "stages": {
            "aaa": {"world": 2, "pods": 2, "ts": 100.0},
            "bbb": {"world": 1, "pods": 1, "ts": 201.0},
        },
        "metrics": {
            "aaa": {"w0": {"sps": 50.0, "world": 2}},
            "bbb": {"w0": {"sps": 50.0, "world": 1}},
        },
        "cache": {
            "bbb": {"w0": {"hit": 2, "miss": 0, "write": 0}},
        },
    }


@pytest.mark.parametrize("dump", [_pure_dump, _split_dump],
                         ids=["pure", "restore-compile-split"])
def test_analyze_matches_jax(dump):
    want = _jax_bench().analyze(dump())
    got = port_bench.analyze(dump())
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def _run_tool(args, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               EDL_RUN_ARCHIVE=str(tmp_path / "runs"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.tools.resize_bench",
         "--device", "cpu", *args],
        cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    t0 = time.monotonic()
    try:
        out, err = proc.communicate(timeout=RUN_BOUND_S + 60)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, out, err, time.monotonic() - t0


@pytest.mark.parametrize("schedule,killed", [("1,r", False), ("1,2", True)],
                         ids=["restart", "grow"])
def test_cpu_run_orders_the_transition(schedule, killed, tmp_path):
    rc, out, err, wall = _run_tool(
        ["--schedule", schedule, "--interval", "12", "--tail", "8",
         "--ttl", "1.0"], tmp_path)
    assert rc == 0, err[-3000:]
    assert wall <= RUN_BOUND_S, wall
    report = json.loads(out.strip().splitlines()[-1])
    assert report["metric"] == "resize_downtime"
    assert report["telemetry_dropped"] == 0
    assert report["platform"] == "cpu" and report["device"] == "cpu"
    stages = report["stages"][:2]
    assert [s["world"] for s in stages] == [1, 1 if schedule == "1,r" else 2]
    for s in stages:
        assert s["samples_per_s"] > 0 and s["first_step_ts"] is not None, s
    cur = stages[1]
    marks = [cur["drain_ts"], cur["published_ts"], cur["ready_ts"],
             cur["first_step_ts"]]
    assert None not in marks and marks == sorted(marks), cur
    if killed:
        assert cur["drain_ts"] <= cur["killed_ts"] <= cur["published_ts"], cur
    else:
        assert cur["killed_ts"] is None, cur
    t = report["transitions"][0]
    assert 0 < t["downtime_s"] < RUN_BOUND_S
    assert t["spawn_to_first_step_s"] > 0 and t["restore_s"] > 0
    # the run archived one bundle of the report, backend the device
    with open(tmp_path / "runs" / "index.jsonl") as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert [(r["kind"], r["backend"]) for r in rows] == [
        ("resize_bench", "cpu")]
    assert report["bundle"] == rows[0]["bundle"]
