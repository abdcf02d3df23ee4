"""Parity: the port's monitor plane (``edl_tpu_torch/obs/monitor.py``,
``python -m edl_tpu_torch.tools.edl_monitord``) against the JAX
package's, on the CPU.

- ``builtin_rules()`` of both packages are equal field by field (the
  port now carries ``ckpt-replica-stale`` too).
- One seeded scrape series of three targets over 160 one-second ticks,
  watched by one rule of each kind (threshold, rate, quantile, absent,
  restart, zscore), fed to both packages' ``Monitor``: the same
  transitions at the same sample indices, the alert records equal
  exactly (tolerance 0: the same float arithmetic over the same
  samples), and the ``alerts/{rule}`` docs each publishes into one port
  store (through its own package's client) have the same keys and
  values apart from the job.
- The JAX ``tests/test_monitor.py`` cases (rule model, every rule kind,
  completion suppression, ring retention, publication, the scraper's
  satellites, the alert invariants, the daemon CLI, the hook registry),
  run on the port's copies as written (``torch_jax_tables``), each
  against a port store in a child process. Left out: the three
  rule-catalogue lint cases, which lint the JAX package's DESIGN.md
  through ``edl_tpu.analysis`` (not ported, ROADMAP §1).
- ``python -m edl_tpu_torch.tools.edl_monitord --once`` against a port
  worker (``train.init`` with ``EDL_OBS_PORT``) in a child process: it
  discovers and scrapes the worker's ``/metrics`` and retains its
  goodput series.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_jax_tables
from test_torch_replicate import ChildStore

from edl_tpu.obs import metrics as jmetrics
from edl_tpu.obs import monitor as jmon
from edl_tpu_torch.obs import metrics as tmetrics
from edl_tpu_torch.obs import monitor as tmon
from edl_tpu_torch.store.client import StoreClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TABLES = torch_jax_tables.load("test_monitor")
CASES = torch_jax_tables.cases(JAX_TABLES, classes=(
    "TestRuleModel", "TestThresholdRules", "TestRateRules",
    "TestServingRules", "TestQuantileStaleness", "TestAbsentAndRestart",
    "TestCompletionSuppression", "TestRetention", "TestAlertPublication",
    "TestScraperSatellites", "TestAlertInvariants", "TestMonitordCli",
    "TestOnFireRegistry"))
T0 = 1_000_000.0
TICKS = 160


@pytest.fixture()
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.mark.parametrize("case", CASES)
def test_jax_monitor_case_on_the_port(case, request):
    torch_jax_tables.run(JAX_TABLES, case, request)


def test_builtin_rules_equal_field_by_field():
    want = [r.to_dict() for r in jmon.builtin_rules()]
    got = [r.to_dict() for r in tmon.builtin_rules()]
    assert got == want
    assert "ckpt-replica-stale" in {r["name"] for r in got}


def _rules(mon_mod):
    Rule = mon_mod.Rule
    return [
        Rule("gauge-high", kind="threshold", metric="edl_x_gauge", op=">",
             value=0.8, for_s=2.0, resolve_s=1.0),
        Rule("steps-stalled", kind="rate", metric="edl_x_steps_total",
             op="<", value=0.5, window_s=8.0, for_s=3.0,
             require_advance=True),
        Rule("latency-p90", kind="quantile", metric="edl_x_latency_seconds",
             q=0.9, op=">", value=2.0, window_s=6.0, for_s=1.0),
        Rule("target-dead", kind="absent", stale_s=5.0),
        Rule("worker-restart", kind="restart",
             metric="edl_x_process_start_time_seconds", resolve_s=3.0),
        Rule("loss-spike", kind="zscore", metric="edl_x_loss", op=">",
             value=4.0, window_s=30.0),
    ]


def _series():
    """The seeded scrape series: ``[(tick, target, up, series)]``."""
    rs = np.random.RandomState(7)
    out = []
    steps = {t: 0.0 for t in ("w0", "w1", "w2")}
    hist = {t: [0.0, 0.0, 0.0] for t in steps}  # le=1, le=4, +Inf
    start = {t: T0 - 100.0 for t in steps}
    for i in range(TICKS):
        for target in sorted(steps):
            up = not (target == "w2" and 50 <= i < 80)  # w2 goes silent
            if target == "w1" and i == 90:
                start[target] = T0 + i  # w1 restarts
                steps[target] = 0.0
            if not (60 <= i < 75):  # every counter stalls together
                steps[target] += float(rs.poisson(2.0))
            slow = 100 <= i < 115
            obs = rs.exponential(3.0 if slow else 0.4, size=3)
            hist[target][0] += float((obs <= 1.0).sum())
            hist[target][1] += float((obs <= 4.0).sum())
            hist[target][2] += 3.0
            loss = 2.0 - 0.005 * i + 0.05 * rs.randn()
            if i in (120, 140) and target == "w0":
                loss += 5.0  # a spike
            gauge = 0.5 + 0.25 * np.sin(i / 9.0) + 0.1 * rs.randn()
            series = {
                "edl_x_gauge": {'{pod="%s"}' % target: float(gauge)},
                "edl_x_steps_total": {"": steps[target]},
                "edl_x_latency_seconds_bucket": {
                    '{le="1"}': hist[target][0],
                    '{le="4"}': hist[target][1],
                    '{le="+Inf"}': hist[target][2]},
                "edl_x_loss": {"": float(loss)},
                "edl_x_process_start_time_seconds": {"": start[target]},
            }
            out.append((i, target, up, series if up else {}))
    return out


def _drive(mon_mod, metrics_mod, client=None, job="parity"):
    mon = mon_mod.Monitor(client, job, rules=_rules(mon_mod), interval=1.0,
                          registry=metrics_mod.MetricsRegistry())
    seen = []
    by_tick = {}
    for i, target, up, series in _series():
        by_tick.setdefault(i, []).append((target, up, series))
    for i in range(TICKS):
        ts = T0 + i
        for target, up, series in by_tick[i]:
            mon.ingest(target, series, up=up, ts=ts)
        for doc in mon.evaluate(now=ts):
            seen.append((i, doc))
    mon.stop()
    return seen


def test_seeded_series_fires_the_same_transitions():
    want = _drive(jmon, jmetrics)
    got = _drive(tmon, tmetrics)
    assert [(i, d["rule"], d["state"]) for i, d in got] == [
        (i, d["rule"], d["state"]) for i, d in want]
    assert got == want
    # the series reaches every kind's firing
    fired = {d["rule"] for _i, d in want if d["state"] == "firing"}
    assert fired == {r.name for r in _rules(tmon)}


def test_published_alert_docs_have_the_same_keys():
    from edl_tpu.store.client import StoreClient as JaxStoreClient

    srv = ChildStore()
    jc = JaxStoreClient(srv.endpoint, timeout=5.0)
    tc = StoreClient(srv.endpoint, timeout=5.0)
    try:
        _drive(jmon, jmetrics, jc, job="jax-job")
        _drive(tmon, tmetrics, tc, job="port-job")
        want = tmon.read_alerts(tc, "jax-job")
        got = tmon.read_alerts(tc, "port-job")
        assert got and sorted(got) == sorted(want)
        for rule in want:
            assert sorted(got[rule]) == sorted(want[rule])
            assert got[rule] == want[rule], rule
        # the JAX reader reads the port's records alike
        assert jmon.read_alerts(jc, "port-job") == got
    finally:
        jc.close()
        tc.close()
        srv.stop()


_WORKER = r"""
import sys, time
from edl_tpu_torch.obs import goodput
from edl_tpu_torch.train import context
context.init(device="cpu")
goodput.enter("train")
time.sleep(0.5)
print("ready", flush=True)
time.sleep(120)
"""


def test_monitord_once_scrapes_a_port_worker(store, tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "EDL_OBS_PORT": "0", "EDL_JOB_ID": "monjob",
                "EDL_STORE_ENDPOINT": store.endpoint, "EDL_POD_ID": "p0",
                "EDL_STAGE": "s0", "EDL_COMPILE_CACHE_DIR": "none"})
    worker = subprocess.Popen([sys.executable, "-c", _WORKER], env=env,
                              cwd=REPO, stdout=subprocess.PIPE, text=True,
                              start_new_session=True)
    try:
        assert worker.stdout.readline().strip() == "ready"
        cli_env = {k: v for k, v in env.items() if not k.startswith("EDL_")}
        out = subprocess.run(
            [sys.executable, "-m", "edl_tpu_torch.tools.edl_monitord",
             "--store", store.endpoint, "--job", "monjob", "--once",
             "--json", "--monitor-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=60, cwd=REPO,
            env=cli_env)
    finally:
        if worker.poll() is None:
            os.killpg(worker.pid, 9)
        worker.wait(timeout=30)
        worker.stdout.close()
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert doc["health"]["job"] == "monjob"
    # the worker and the monitor's own registry
    assert doc["health"]["targets"] == 2
    from edl_tpu_torch.obs import events as obs_events

    samples = [e for e in obs_events.read_segments(
        str(tmp_path), suffix=tmon.SERIES_SUFFIX) if e.get("event") == "sample"]
    workers = [s for s in samples if s["target"] != tmon.SELF_TARGET]
    assert len(workers) == 1 and workers[0]["up"]
    assert "edl_goodput_seconds_total" in workers[0]["series"]
