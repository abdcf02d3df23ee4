"""The port's trace merge (``edl_tpu_torch.obs.merge``), ``edl_timeline``
and ``edl_trace`` against the JAX package's (``edl_tpu/obs/merge.py``,
``tools/edl_timeline.py``, ``tools/edl_trace.py``).

One synthetic run directory — a launcher's and a worker's flight
segments with a leader election, drain, publish, spawn, a restage and a
train lane, a linked restage trace over two processes (the shape
``tests/test_trace.py`` stitches), a span tracer's own export, a torn
export of a killed process and a chaos log — goes through both
packages' tools, which give equal documents: the merged Chrome trace,
the timeline's JSON, text and Chrome output (also over an archived
bundle), and the trace's critical paths, list and goodput cross-check.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

import test_goodput
import test_trace
from edl_tpu.obs import archive as jax_archive
from edl_tpu.obs import merge as jax_merge
from edl_tpu_torch.obs import merge as port_merge
from edl_tpu_torch.obs.trace import SpanTracer
from edl_tpu_torch.tools import edl_timeline as port_timeline
from edl_tpu_torch.tools import edl_trace as port_trace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

import edl_timeline as jax_timeline  # noqa: E402 — tools/ on sys.path
import edl_trace as jax_trace  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = 1_700_000_000.0


def make_run(run):
    """The run directory: flight/, traces/ and chaos.log."""
    flight, traces = os.path.join(run, "flight"), os.path.join(run, "traces")
    ev = test_goodput._ev
    test_goodput._write_flight(flight, "launcher", 10, [
        {"ts": BASE + 0.0, "event": "leader", "leader": True},
        {"ts": BASE + 0.1, "event": "drain", "token": "abc",
         "cause": "bootstrap"},
        {"ts": BASE + 0.2, "event": "publish", "stage": "abc", "world": 1},
        {"ts": BASE + 0.3, "event": "spawn", "stage": "abc", "world": 1},
    ])
    test_goodput._write_flight(flight, "worker-0", 200, [
        ev(BASE + 1.0, "worker-0", 200, "restage", None, 0.0),
        ev(BASE + 3.0, "worker-0", 200, "train", "restage", 2.0),
        ev(BASE + 9.0, "worker-0", 200, None, "train", 6.0),
    ])
    os.makedirs(traces)

    class _Dir:  # test_trace's writer takes a pathlib-like dir
        def __truediv__(self, name):
            return os.path.join(traces, name)

    test_trace._synthetic_restage(_Dir(), base=BASE + 1.0)
    tracer = SpanTracer(component="worker-0")
    with tracer.span("train_step", step=1):
        pass
    tracer.export(os.path.join(traces, "worker-0-200b.trace.json"))
    with open(os.path.join(traces, "killed-300.trace.json"), "w") as f:
        f.write('{"traceEvents": [tr')  # a killed process's torn export
    with open(os.path.join(run, "chaos.log"), "w") as f:
        f.write(json.dumps({
            "ts": BASE + 5.0, "point": "train.step", "action": "kill",
            "who": "worker", "pid": 200, "ctx": {"step": "4"}}) + "\n")
    return flight, traces


@pytest.fixture()
def run(tmp_path):
    path = str(tmp_path / "run")
    make_run(path)
    return path


def _call(tool, args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = tool.main(args)
    return rc, out.getvalue()


def both(jax_tool, port_tool, args, outputs=()):
    """Both tools on ``args`` (each writing its own copy of ``outputs``,
    the ``-o`` files): equal exit codes, stdout and output documents."""
    got = {}
    for name, tool in (("jax", jax_tool), ("port", port_tool)):
        a = [x.format(out=name) if "{out}" in x else x for x in args]
        rc, out = _call(tool, a)
        docs = []
        for path in outputs:
            with open(path.format(out=name)) as f:
                docs.append(json.load(f))
        got[name] = (rc, out, docs)
    assert got["port"] == got["jax"]
    return got["port"]


def test_merge_gives_equal_documents(run):
    paths = port_merge.expand_inputs([], os.path.join(run, "traces"))
    assert paths == jax_merge.expand_inputs([], os.path.join(run, "traces"))
    for rebase in (True, False):
        doc = port_merge.merge_traces(paths, rebase=rebase)
        assert doc == jax_merge.merge_traces(paths, rebase=rebase)
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"op:restage", "worker_boot", "train_step"} <= names
    out = os.path.join(run, "merged-{out}.json")
    rc, _, (merged,) = both(jax_merge, port_merge,
                            ["--dir", os.path.join(run, "traces"), "-o", out],
                            outputs=[out])
    assert rc == 0
    assert min(e["ts"] for e in merged["traceEvents"]
               if e.get("ph") != "M") == 0
    assert both(jax_merge, port_merge,
                ["--dir", os.path.join(run, "none"), "-o", out])[0] == 2


@pytest.mark.parametrize("args", [[], ["--json"], ["--max-events", "3"]])
def test_timeline_gives_equal_documents(run, args):
    rc, out, _ = both(jax_timeline, port_timeline, [run] + args)
    assert rc == 0
    if args == ["--json"]:
        doc = json.loads(out)
        assert doc["attribution"]["states"]["train"] > 0
    elif not args:
        assert "TIMELINE" in out and "ATTRIBUTION" in out


def test_timeline_chrome_trace_and_bundle(run, tmp_path, monkeypatch):
    out = str(tmp_path / "timeline-{out}.json")
    rc, _, (doc,) = both(jax_timeline, port_timeline, [run, "-o", out],
                         outputs=[out])
    assert rc == 0
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"train", "train_step", "worker_boot"} <= names
    # an archived bundle, by name under EDL_RUN_ARCHIVE
    root = str(tmp_path / "runs")
    bundle = jax_archive.RunArchive(root).archive(
        "chaos-worker-kill", "cpu", backend="cpu",
        flight_dir=os.path.join(run, "flight"),
        trace_dir=os.path.join(run, "traces"),
        chaos_log=os.path.join(run, "chaos.log"))
    monkeypatch.setenv("EDL_RUN_ARCHIVE", root)
    rc, by_name, _ = both(jax_timeline, port_timeline,
                          [os.path.basename(bundle), "--json"])
    assert rc == 0
    assert json.loads(by_name)["attribution"]["states"]["train"] > 0
    assert both(jax_timeline, port_timeline,
                [str(tmp_path / "empty")])[0] == 2


@pytest.mark.parametrize("args", [
    [], ["--op", "restage"], ["--json"], ["--list"],
    ["--op", "restage", "--goodput", "--json"]])
def test_trace_gives_equal_documents(run, args):
    rc, out, _ = both(jax_trace, port_trace, [run] + args)
    assert rc == 0
    if args == ["--json"]:
        (op,) = json.loads(out)["ops"]
        assert op["op"] == "restage" and op["complete"] is True
    if args == ["--op", "restage"]:
        assert "worker_boot" in out and "first_step" in out


def test_trace_empty_dir_and_modules(run, tmp_path):
    assert both(jax_trace, port_trace, [str(tmp_path / "empty")])[0] == 2
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = []
    for module in ("tools.edl_trace", "edl_tpu_torch.tools.edl_trace",
                   "tools.edl_timeline", "edl_tpu_torch.tools.edl_timeline"):
        proc = subprocess.run([sys.executable, "-m", module, run],
                              capture_output=True, text=True, cwd=REPO,
                              env=env, timeout=60)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout)
    assert outs[0] == outs[1] and "critical path" in outs[1]
    assert outs[2] == outs[3] and "ATTRIBUTION" in outs[3]
