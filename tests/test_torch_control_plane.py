"""The jax-free control-plane copies of the port against the JAX
package's: the cluster model's JSON, the memory plan docs and the fit
gate, the obs HTTP endpoints, and the telemetry records, each fed the
same inputs on both sides."""

import json
import random
import urllib.request

import pytest

from edl_tpu.cluster import model as jax_model
from edl_tpu.obs import http as jax_http
from edl_tpu.obs import memory as jax_memory
from edl_tpu_torch.cluster import model as port_model
from edl_tpu_torch.obs import http as port_http
from edl_tpu_torch.obs import memory as port_memory


def _cluster(mod, seed):
    rng = random.Random(seed)
    pods = []
    for p in range(rng.randint(1, 4)):
        pod = mod.Pod(pod_id="pod%02d" % p, addr="10.0.0.%d" % p,
                      rank=p, stage="s%d" % seed)
        for r in range(rng.randint(1, 3)):
            pod.workers.append(mod.Worker("10.0.0.%d:%d" % (p, 7000 + r),
                                          rank_in_pod=r))
        pods.append(pod)
    return mod.Cluster.from_pods(pods, "stage-%d" % seed)


@pytest.mark.parametrize("seed", range(6))
def test_cluster_json_is_the_same(seed):
    jax_c, port_c = _cluster(jax_model, seed), _cluster(port_model, seed)
    assert port_c.to_json() == jax_c.to_json()
    back = port_model.Cluster.from_json(jax_c.to_json())
    assert back.to_json() == jax_c.to_json()
    assert back.world_size == jax_c.world_size
    assert back.coordinator == jax_c.coordinator
    assert back.worker_endpoints() == jax_c.worker_endpoints()
    assert back.pod_ids() == jax_c.pod_ids()
    assert len(port_model.new_uuid()) == len(jax_model.new_uuid()) == 16


def _plans(mod, seed):
    rng = random.Random(seed)
    plans = {}
    for world in range(1, 6):
        if rng.random() < 0.2:
            continue
        plans[world] = mod.MemoryPlan(
            argument=rng.uniform(0, 8e9), output=rng.uniform(0, 4e9),
            temp=rng.uniform(0, 8e9), alias=rng.uniform(0, 2e9),
            generated_code=rng.uniform(0, 1e6), world=world, ts=1.5,
            limit=rng.choice([0.0, 16e9, 32e9]))
    return plans


@pytest.mark.parametrize("seed", range(8))
def test_memory_plans_and_fit_gate_match(seed, monkeypatch):
    monkeypatch.delenv("EDL_MEM_MARGIN", raising=False)
    jax_p, port_p = _plans(jax_memory, seed), _plans(port_memory, seed)
    assert {w: p.to_doc() for w, p in port_p.items()} == {
        w: p.to_doc() for w, p in jax_p.items()}
    for limit in (0.0, 12e9, 40e9):
        assert port_memory.fit_cap(port_p, limit) == jax_memory.fit_cap(
            jax_p, limit)
    # a doc one side publishes, the other reads
    for w, p in jax_p.items():
        got = port_memory.MemoryPlan.from_doc(json.loads(json.dumps(p.to_doc())))
        assert got.to_doc() == p.to_doc()
    assert port_memory.PLAN_KINDS == jax_memory.PLAN_KINDS
    assert port_memory.MEM_SERVICE == jax_memory.MEM_SERVICE


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.read().decode()


def test_obs_endpoints_serve_the_same_documents(monkeypatch):
    monkeypatch.setenv("EDL_OBS_PORT", "0")
    servers = {}
    try:
        for name, mod in (("jax", jax_http), ("port", port_http)):
            servers[name] = mod.start_from_env(
                "worker", health_fn=lambda: {"rank": 3, "stage": "abc"})
            assert servers[name] is not None
        docs = {name: json.loads(_get("http://%s/healthz" % srv.endpoint))
                for name, srv in servers.items()}
        assert set(docs["port"]) == set(docs["jax"])
        assert docs["port"]["component"] == "worker"
        assert docs["port"]["rank"] == 3
        text = _get("http://%s/metrics" % servers["port"].endpoint)
        parsed = port_http.parse_metrics_text(text)
        assert "edl_build_info" in parsed
        assert "edl_process_start_time_seconds" in parsed
        got, want = (json.loads(m.endpoint_payload("h:1"))
                     for m in (port_http, jax_http))
        assert set(got) == set(want) and got["endpoint"] == want["endpoint"]
        assert port_http.obs_prefix("j") == jax_http.obs_prefix("j")
    finally:
        jax_http.stop_all()
        port_http.stop_all()


@pytest.mark.parametrize("plans,want", [
    # the live world's plan alone, fitting: no evidence against world 2
    ({1: dict(argument=10e9, temp=1e9, limit=80e9)}, None),
    # every judged world fits
    ({1: dict(argument=10e9, limit=80e9), 2: dict(argument=9e9,
                                                   limit=80e9)}, None),
    # a judged world over its limit: growth stops below it
    ({1: dict(argument=10e9, limit=80e9), 2: dict(argument=79e9,
                                                   limit=80e9)}, 1),
    # no judgeable plan (no limit stamped): unknown never gates
    ({1: dict(argument=10e9)}, None),
])
def test_launcher_fit_gate_refuses_growth_only_on_evidence(
        plans, want, monkeypatch):
    """The port launcher's memory gate caps the next generation only
    when a published plan is over its device's limit; a worker that
    published its live world's fitting plan alone (before its AOT ladder
    publishes the neighbours', or without one) does not block a grow."""
    import types

    from edl_tpu_torch.launch import launcher

    docs = {w: port_memory.MemoryPlan(world=w, **kw) for w, kw in plans.items()}
    monkeypatch.setattr(launcher.obs_memory, "read_plans",
                        lambda client, job: docs)
    fake = types.SimpleNamespace(
        client=None,
        job_env=types.SimpleNamespace(job_id="j", nproc_per_node=1))
    assert launcher.ElasticLauncher._mem_fit_cap(fake) == want
