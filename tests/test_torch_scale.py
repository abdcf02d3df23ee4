"""Parity: the port's scale plane (``edl_tpu_torch/scale``) against the
JAX package's (``edl_tpu/scale``), on the CPU.

- ``decide_world``, ``allocate``, ``release_targets`` and ``fit_alpha``
  of both packages over one seeded table of 600 random job stats, pools
  and sample sets: the decisions, allocations and fits are equal exactly
  (tolerance 0: both are the same float arithmetic).
- The JAX ``tests/test_scale.py`` cases (the goodput model, the decision
  grammar, the arbiter, gang sequencing, the knobs, the job grammar and
  the daemon's store contract), run on the port's copies as written
  (``torch_jax_tables``), each against a port store in a child process.
- One ``Scaler.poll_once`` of each package, with the same
  ``stats_override``, against one port store: the published
  ``scale/target`` docs are equal apart from ``ts``, and the port's
  decision flight record carries the ``op_trace_id("scale", seq)`` the
  launcher stamps on its reconcile.
- ``python -m edl_tpu_torch.tools.edl_scaled --once --json`` decides as
  the JAX ``tools/edl_scaled.py`` does on one store.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_jax_tables
from test_torch_replicate import ChildStore

from edl_tpu.scale import arbiter as jarb
from edl_tpu.scale import decide as jdec
from edl_tpu.scale import scaler as jscaler
from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.scale import arbiter as tarb
from edl_tpu_torch.scale import decide as tdec
from edl_tpu_torch.scale import scaler as tscaler
from edl_tpu_torch.store.client import StoreClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_ROWS = 600
JAX_TABLES = torch_jax_tables.load("test_scale")
CASES = torch_jax_tables.cases(JAX_TABLES, classes=(
    "TestModel", "TestDecideWorld", "TestAllocate", "TestReleaseTargets",
    "TestFitAlpha", "TestKnobs", "TestJobSpec", "TestScalerContract"))


@pytest.fixture()
def store():
    """A fresh port store in a child process, as a client (the JAX
    module's ``store`` fixture is an in-process server's client)."""
    srv = ChildStore()
    client = StoreClient(srv.endpoint, timeout=5.0)
    try:
        yield client
    finally:
        client.close()
        srv.stop()


@pytest.mark.parametrize("case", CASES)
def test_jax_scale_case_on_the_port(case, request):
    torch_jax_tables.run(JAX_TABLES, case, request)


def _row(rs):
    """One random (stats, params, pool) row for both packages."""
    world = int(rs.randint(0, 9))
    stats = dict(
        world=world,
        per_pod_rate=float(rs.uniform(0.1, 10.0)),
        goodput_ratio=float(rs.choice([1.0, rs.uniform(0.0, 1.0)])),
        gns=(None if rs.rand() < 0.3 else float(10 ** rs.uniform(-2, 2))),
        stragglers=int(rs.choice([0, 0, rs.randint(0, 50)])),
    )
    params = dict(
        alpha=float(rs.uniform(0.0, 0.5)),
        gns=float(10 ** rs.uniform(-2, 2)),
        batch_per_pod=float(rs.choice([1.0, rs.uniform(0.5, 4.0)])),
        hysteresis=float(rs.uniform(0.0, 0.3)),
        cooldown_s=float(rs.choice([0.0, 10.0, 30.0])),
    )
    lo = int(rs.randint(1, 4))
    hi = lo + int(rs.randint(0, 8))
    capacity = int(rs.randint(0, 12))
    last = None
    if rs.rand() < 0.5:
        last = dict(kind=str(rs.choice([jdec.GROW, jdec.SHRINK, jdec.HOLD,
                                        jdec.PREEMPT])),
                    target=int(rs.randint(0, 9)), cause="x", score=1.0,
                    seq=int(rs.randint(1, 9)), job_id="j",
                    ts=float(rs.uniform(900.0, 1000.0)))
    mem_cap = None if rs.rand() < 0.6 else int(rs.randint(1, 9))
    return stats, params, lo, hi, capacity, last, mem_cap


def _decide(pkg, row):
    stats, params, lo, hi, capacity, last, mem_cap = row
    dec = pkg.decide_world(
        pkg.JobStats(**stats), capacity, lo, hi, pkg.ScaleParams(**params),
        last=None if last is None else pkg.Decision(**last), now=1000.0,
        mem_cap=mem_cap)
    return dataclasses.asdict(dec)


def test_decide_world_agrees_over_a_seeded_table():
    rs = np.random.RandomState(17)
    kinds = set()
    for i in range(TABLE_ROWS):
        row = _row(rs)
        want, got = _decide(jdec, row), _decide(tdec, row)
        assert got == want, (i, row)
        kinds.add(want["kind"])
    # the table reaches every branch of the grammar
    assert kinds == {jdec.GROW, jdec.SHRINK, jdec.HOLD, jdec.PREEMPT}


def _demand_rows(rs):
    """A random pool: each job's demand as plain values, and a capacity."""
    rows = []
    for j in range(int(rs.randint(1, 5))):
        stats, params, lo, hi, _cap, _last, _mem = _row(rs)
        rows.append(dict(
            job_id="job%d" % j, min_world=lo, max_world=hi,
            priority=int(rs.randint(0, 3)),
            weight=float(rs.choice([1.0, rs.uniform(0.2, 3.0)])),
            stats=None if rs.rand() < 0.2 else stats, params=params,
            active=bool(rs.rand() < 0.9)))
    return rows, int(rs.randint(0, 16))


def _demands(pkg, arb, rows):
    return [arb.JobDemand(**dict(
        row, stats=None if row["stats"] is None else pkg.JobStats(
            **row["stats"]),
        params=pkg.ScaleParams(**row["params"]))) for row in rows]


def test_allocate_and_release_agree_over_a_seeded_table():
    rs = np.random.RandomState(29)
    for i in range(TABLE_ROWS):
        rows, cap = _demand_rows(rs)
        want = jarb.allocate(_demands(jdec, jarb, rows), cap)
        got = tarb.allocate(_demands(tdec, tarb, rows), cap)
        assert got == want, (i, rows, cap)
        actuals = {row["job_id"]: int(rs.randint(0, 9)) for row in rows}
        assert tarb.release_targets(got, actuals) == jarb.release_targets(
            want, actuals), (i, want, actuals)


def test_fit_alpha_agrees_over_a_seeded_table():
    rs = np.random.RandomState(31)
    for i in range(TABLE_ROWS):
        alpha = float(rs.uniform(0.0, 0.6))
        samples = []
        for _ in range(int(rs.randint(0, 12))):
            n = int(rs.randint(0, 9))
            rate = 100.0 / (1.0 + alpha * (n - 1)) * float(rs.uniform(0.9, 1.1))
            if rs.rand() < 0.1:
                rate = -rate  # garbage the fit must drop
            samples.append((n, rate))
        default = float(rs.choice([0.05, 0.2]))
        assert tdec.fit_alpha(samples, default) == jdec.fit_alpha(
            samples, default), (i, samples)


def test_params_from_env_agree(monkeypatch):
    env = {"EDL_SCALE_ALPHA": "0.125", "EDL_SCALE_GNS": "7.5",
           "EDL_SCALE_HYSTERESIS": "0.05", "EDL_SCALE_COOLDOWN": "12"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert dataclasses.asdict(tdec.params_from_env()) == dataclasses.asdict(
        jdec.params_from_env())


def _poll(pkg, endpoint, job_id, stats, tmp_path):
    """One sweep of ``pkg``'s scaler through its own package's store
    client; the docs are read back through the port's."""
    from edl_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from edl_tpu.store.client import StoreClient as JaxStoreClient
    from edl_tpu_torch.obs.metrics import MetricsRegistry as PortRegistry

    jax_side = pkg is jscaler
    reg = JaxRegistry() if jax_side else PortRegistry()
    client = (JaxStoreClient if jax_side else StoreClient)(endpoint,
                                                          timeout=5.0)
    reader = StoreClient(endpoint, timeout=5.0)
    params = (jdec if pkg is jscaler else tdec).ScaleParams(
        alpha=0.05, gns=32.0, hysteresis=0.02, cooldown_s=10.0)
    scaler = pkg.Scaler(
        client, [pkg.JobSpec(job_id, min_world=1, max_world=4)],
        capacity=3, params=params, stats_override=lambda job: dict(stats),
        flight_dir=str(tmp_path / ("flight-" + job_id)),
        registry=reg, scrape_timeout=0.1)
    try:
        acted = scaler.poll_once(now=1000.0)
        meta = Registry(reader, job_id).get_server("scale", "target")
        doc = json.loads(meta.value.decode())
        dmeta = Registry(reader, job_id).get_server("scale", "decision")
        decision = json.loads(dmeta.value.decode()) if dmeta else None
    finally:
        scaler.stop()
        client.close()
        reader.close()
    return [(d.kind, d.target, d.seq) for d in acted], doc, decision


@pytest.mark.parametrize("stats", [
    {"world": 1, "gns": 32.0},       # rich: grow to the pool
    {"world": 3, "gns": 0.03},       # poor: shrink to one pod
])
def test_one_poll_publishes_equal_targets(stats, tmp_path):
    from edl_tpu_torch.obs import events as obs_events
    from edl_tpu_torch.obs import trace as obs_trace

    srv = ChildStore()
    try:
        j = _poll(jscaler, srv.endpoint, "jax-job", stats, tmp_path)
        t = _poll(tscaler, srv.endpoint, "port-job", stats, tmp_path)
    finally:
        srv.stop()
    assert t[0] == j[0] and len(t[0]) == 1
    jdoc, tdoc = dict(j[1]), dict(t[1])
    assert set(jdoc) == set(tdoc) and "ts" in tdoc
    jdoc.pop("ts"), tdoc.pop("ts")
    assert tdoc == jdoc
    if j[2] is not None or t[2] is not None:
        assert sorted(t[2]) == sorted(j[2])
    recs = [e for e in obs_events.read_segments(
        str(tmp_path / "flight-port-job"))
        if e.get("event") == "scale_decision"]
    assert [r["trace_id"] for r in recs] == [
        obs_trace.op_trace_id("scale", str(tdoc["seq"]))]


def test_edl_scaled_once_matches_the_jax_cli():
    """``python -m edl_tpu_torch.tools.edl_scaled --once --json`` and the
    JAX ``tools/edl_scaled.py``, each on its own job of one port store
    whose cluster holds one pod, in a pool of 2: the same decisions,
    apart from the job and the time."""
    from edl_tpu_torch.cluster.model import Cluster, Pod

    srv = ChildStore()
    try:
        client = StoreClient(srv.endpoint, timeout=5.0)
        for job in ("jax-job", "port-job"):
            cluster = Cluster.from_pods([Pod(pod_id="p0", rank=0)],
                                        stage="s1")
            Registry(client, job).set_permanent("cluster", "current",
                                                cluster.to_json())
        client.close()
        env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        outs = {}
        for job, module in (("jax-job", "tools.edl_scaled"),
                            ("port-job", "edl_tpu_torch.tools.edl_scaled")):
            out = subprocess.run(
                [sys.executable, "-m", module, "--store", srv.endpoint,
                 "--job", job + ":1:2", "--capacity", "2", "--once", "--json"],
                capture_output=True, text=True, timeout=60, cwd=REPO, env=env)
            assert out.returncode == 0, out.stderr
            outs[job] = [{k: v for k, v in d.items()
                          if k not in ("job_id", "ts")}
                         for d in json.loads(out.stdout)]
    finally:
        srv.stop()
    assert outs["port-job"] == outs["jax-job"]
    assert [d["kind"] for d in outs["port-job"]] == ["grow"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_funded_grow_waits_for_the_published_shrink(pkg):
    """autoscale-multijob's grant: the preempted job's leader writes its
    released pods' preempt notices, then (a drain later) publishes the
    shrunk generation. The port's scaler holds the preempting gang's
    grow until that publish; the JAX scaler discounts the noticed pods
    at once and releases the grow in between, so the gang can publish
    before the shrink does (``priority_admission_ordered`` red). Both
    admit once the shrink is published, and both read a job whose whole
    roster is noticed (a pause) as world 0."""
    from edl_tpu_torch.cluster.model import Cluster, Pod
    from edl_tpu_torch.obs.metrics import MetricsRegistry

    mod = {"jax": jscaler, "port": tscaler}[pkg]
    srv = ChildStore()
    store = StoreClient(srv.endpoint, timeout=5.0)
    reg = Registry(store, "a")

    def publish(pods):
        reg.set_permanent("cluster", "current", Cluster.from_pods(
            [Pod(pod_id=p, rank=i) for i, p in enumerate(pods)],
            stage="s%d" % len(pods)).to_json())

    publish(["p0", "p1", "p2"])
    scaler = mod.Scaler(
        srv.endpoint, [mod.JobSpec("a", min_world=1, max_world=3)],
        capacity=3,
        params=mod.scale_decide.ScaleParams(alpha=0.05, gns=30.0,
                                            hysteresis=0.02, cooldown_s=0.0),
        stats_override=lambda job: {"gns": 30.0, "per_pod_rate": 1.0,
                                    "goodput_ratio": 1.0},
        registry=MetricsRegistry(), scrape_timeout=0.1)
    try:
        assert scaler.poll_once(now=1000.0) == []
        scaler.add_job(mod.JobSpec("b", min_world=2, max_world=2,
                                   priority=10))
        acted = scaler.poll_once(now=1010.0)
        assert [(d.job_id, d.kind, d.target) for d in acted] == [
            ("a", mod.scale_decide.SHRINK, 1)]
        # the leader's release: two notices, the 3-pod stage still out
        for pid in ("p1", "p2"):
            reg.set_permanent("preempt", pid, b'{"cause": "autoscale"}')
        acted = [(d.job_id, d.kind, d.target)
                 for d in scaler.poll_once(now=1011.0)]
        if pkg == "jax":
            assert acted == [("b", mod.scale_decide.GROW, 2)]  # too early
            return
        assert acted == []
        publish(["p0"])  # the shrink is real
        acted = scaler.poll_once(now=1012.0)
        assert [(d.job_id, d.kind, d.target) for d in acted] == [
            ("b", mod.scale_decide.GROW, 2)]
        # a pause: every published pod noticed reads as world 0
        reg.set_permanent("preempt", "p0", b'{"cause": "autoscale"}')
        assert scaler._actual_world("a") == 0
    finally:
        scaler.stop()
        store.close()
        srv.stop()
