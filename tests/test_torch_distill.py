"""The student side of elastic distillation and the teacher's registration:
``edl_tpu_torch.distill`` against ``edl_tpu.distill`` on the CPU.

The port's copies keep the JAX package's store keys, frames, fault points
and metrics, so each case runs the two packages side by side, or across
each other, and wants the same answers:

- a teacher registered by one package is balanced and discovered by the
  other's service and client, through one store;
- the two ``BalanceTable``s publish the same assignments for the same
  sequence of teachers, clients, drains and sick reports;
- ``RetryBudget``, ``HedgePolicy`` and ``BreakerBoard`` go through the
  same states for the same calls under one fixed clock;
- the two ``DistillReader``s yield bit-identical epochs in ``sample``,
  ``sample_list`` and ``batch`` modes over fixed echo teachers;
- the ``teacher-failover`` drill's steps on the port's stack, with its
  armed ``distill.predict`` delay: every batch once, in order;
- the port server's ``distill.serving.predict`` kill, drop and delay look
  to a JAX client as the JAX server's do;
- a preemption notice for a teacher's pod drains it out of the
  assignments within the chaos scenario's 2.0 s grace;
- ``fetch_model``: local paths, ``file://``, right and wrong sha256 and
  the cache give the same results and errors.

The stores are ``python -m edl_tpu_torch.store.server`` children in
sessions of their own (``ChildStore``), as are the killed teachers.
"""

import json
import os
import random
import signal
import subprocess
import sys
import time
import types

import jax
import numpy as np
import pytest

from edl_tpu.chaos import plane as jchaos
from edl_tpu.distill import discovery as jdisc
from edl_tpu.distill import fetch as jfetch
from edl_tpu.distill import reader as jreader
from edl_tpu.distill import resilience as jres
from edl_tpu.distill import serving as jserving
from edl_tpu_torch.chaos import plane as tchaos
from edl_tpu_torch.distill import discovery as tdisc
from edl_tpu_torch.distill import fetch as tfetch
from edl_tpu_torch.distill import reader as treader
from edl_tpu_torch.distill import resilience as tres
from edl_tpu_torch.distill import serving as tserving
from edl_tpu_torch.cluster.contract import PREEMPT_SERVICE
from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.store.client import StoreClient
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "jax": types.SimpleNamespace(disc=jdisc, serving=jserving,
                                 reader=jreader, chaos=jchaos),
    "port": types.SimpleNamespace(disc=tdisc, serving=tserving,
                                  reader=treader, chaos=tchaos),
}
# the chaos scenario's bound from a drain mark to the assignments
# (edl_tpu/chaos/scenario.py DRAIN_GRACE_S)
DRAIN_GRACE_S = 2.0
WAIT_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Another test file in the same worker may have armed JAX's
    persistent compilation cache with a key function this JAX version
    cannot call (``edl_tpu.train.aot.enable_portable_cache_keys``)."""
    from jax._src import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()


@pytest.fixture(scope="module")
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


@pytest.fixture()
def clean_env(monkeypatch):
    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    return monkeypatch


def _until(cond, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out waiting for " + what
        time.sleep(0.02)


# -- discovery across the packages -------------------------------------------


@pytest.mark.parametrize("registers,balances", [("port", "jax"),
                                                ("jax", "port")])
def test_teacher_is_balanced_and_discovered_across_packages(
        store, clean_env, registers, balances):
    """One package's ``TeacherRegister`` in a store; the other's
    ``DiscoveryService`` assigns it and its ``DiscoveryClient`` sees it;
    deregistering takes it out again."""
    r, b = PKGS[registers], PKGS[balances]
    job = "xdisc-%s" % registers
    server = r.serving.PredictServer(r.serving.EchoPredictBackend()).start()
    reg = r.disc.TeacherRegister(store.endpoint, job, "teacher",
                                 server.endpoint, ttl=5.0)
    svc = b.disc.DiscoveryService(store.endpoint, job, ["teacher"])
    client = b.disc.DiscoveryClient(store.endpoint, job, "teacher",
                                    client_id="student-0", ttl=5.0)
    try:
        assert client.wait_servers(timeout=WAIT_S) == [server.endpoint]
        assert svc.owned_services() == ["teacher"]
        reg.stop()
        reg = None
        _until(lambda: client.get_servers()[1] == [], "the deregistration")
    finally:
        client.stop()
        svc.stop()
        if reg is not None:
            reg.stop()
        server.stop()


class _FakeRegistry:
    """The calls a ``BalanceTable`` makes of its registry: watches whose
    callbacks the test drives, and the writes it records."""

    def __init__(self):
        self.callbacks = {}
        self.writes = []

    def watch_service(self, service, on_change):
        self.callbacks[service] = on_change
        return types.SimpleNamespace(cancel=lambda: None)

    def set_permanent(self, service, name, value):
        self.writes.append(("put", service, name, json.loads(value)))

    def remove(self, service, name):
        self.writes.append(("remove", service, name))
        return True


def test_balance_tables_publish_the_same_assignments():
    """300 seeded events (teachers join, leave, drain and come back,
    students join and leave, breakers report teachers sick and clear
    them) through both packages' ``BalanceTable``s: the same writes in
    the same order. And ``assign`` gives the same answer for every
    teacher/client count up to 12 x 12."""
    for nt in range(13):
        for nc in range(13):
            teachers = ["t%02d" % i for i in range(nt)]
            clients = ["c%02d" % i for i in range(nc)]
            assert (tdisc.BalanceTable.assign(teachers, clients)
                    == jdisc.BalanceTable.assign(teachers, clients))
    regs = {name: _FakeRegistry() for name in PKGS}
    tables = {name: PKGS[name].disc.BalanceTable(regs[name], "teacher")
              for name in PKGS}
    rng = random.Random(11)
    teachers, clients, sick = {}, set(), set()
    nxt = 0
    meta = lambda v: types.SimpleNamespace(value=v)  # noqa: E731
    for _ in range(300):
        op = rng.random()
        if op < 0.25 or not teachers:
            teachers["10.0.0.%d:9000" % nxt] = b"1"
            nxt += 1
            service = "distill/teachers/teacher"
        elif op < 0.35:
            teachers.pop(rng.choice(sorted(teachers)))
            service = "distill/teachers/teacher"
        elif op < 0.45:
            name = rng.choice(sorted(teachers))
            teachers[name] = jdisc.DRAINING if teachers[name] == b"1" else b"1"
            service = "distill/teachers/teacher"
        elif op < 0.65:
            clients.add("student-%d" % rng.randrange(8))
            service = "distill/clients/teacher"
        elif op < 0.75 and clients:
            clients.discard(rng.choice(sorted(clients)))
            service = "distill/clients/teacher"
        elif op < 0.9:
            sick.add("%s|student-0" % rng.choice(sorted(teachers)))
            service = "distill/sick/teacher"
        else:
            if sick:
                sick.discard(rng.choice(sorted(sick)))
            service = "distill/sick/teacher"
        snapshot = {
            "distill/teachers/teacher": {n: meta(v) for n, v in teachers.items()},
            "distill/clients/teacher": {n: meta(b"1") for n in clients},
            "distill/sick/teacher": {n: meta(b"1") for n in sick},
        }[service]
        for name in PKGS:
            regs[name].callbacks[service](dict(snapshot))
    assert len(regs["port"].writes) > 100
    assert regs["port"].writes == regs["jax"].writes
    assert tables["port"].snapshot() == tables["jax"].snapshot()


# -- resilience under a fixed clock -------------------------------------------


def _clocked(monkeypatch, module, clock):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        monotonic=lambda: clock[0], time=lambda: clock[0],
        sleep=lambda s: None))


def test_resilience_primitives_go_through_the_same_states(monkeypatch,
                                                         clean_env):
    """400 seeded calls on a ``RetryBudget``, a ``HedgePolicy`` and a
    ``BreakerBoard`` of each package, the clock stepping with the calls:
    every return value and every state the same."""
    clock = [1000.0]
    for module in (jres, tres):
        _clocked(monkeypatch, module, clock)
    objs = {
        name: (mod.RetryBudget(ratio=0.25, burst=3.0),
               mod.HedgePolicy(budget_ratio=0.1, min_delay_ms=20.0, burst=2.0),
               mod.BreakerBoard(failures=3, open_s=0.5))
        for name, mod in (("jax", jres), ("port", tres))
    }
    rng = random.Random(5)
    teachers = ["a:1", "b:2", "c:3"]
    trace = {name: [] for name in objs}
    for _ in range(400):
        clock[0] += rng.choice((0.0, 0.01, 0.1, 0.3))
        op = rng.randrange(9)
        latency = rng.uniform(0.001, 0.2)
        teacher = rng.choice(teachers)
        overload = rng.random() < 0.3
        for name, (budget, hedge, board) in objs.items():
            out = trace[name]
            if op == 0:
                budget.note_primary()
                hedge.note_primary()
            elif op == 1:
                out.append(budget.try_spend())
            elif op == 2:
                hedge.note_latency(latency)
            elif op == 3:
                out.append((hedge.delay_s(), hedge.try_hedge()))
            elif op == 4:
                hedge.note_win(overload)
            elif op == 5:
                out.append(board.admits(teacher))
                board.starting(teacher)
            elif op == 6:
                board.record_success(teacher)
            elif op == 7:
                board.record_failure(teacher, overload=overload)
            else:
                out.append(board.admits(teacher))
            out.append((budget.primaries, budget.spent, hedge.hedges,
                        hedge.wins, board.snapshot()))
    assert trace["port"] == trace["jax"]
    assert {s for snap in trace["port"] if isinstance(snap, tuple)
            and len(snap) == 5 for s in snap[4].values()} >= {"open",
                                                             "closed"}


# -- the readers --------------------------------------------------------------


def _generators(mode):
    """A seeded generator factory of each mode: samples of (x [6] fp32,
    y int64), lists of 5 samples, batches of [7, 6]/[7] (ragged last)."""
    def gen():
        rs = np.random.RandomState(3)
        if mode == "sample":
            for _ in range(37):
                yield (rs.randn(6).astype(np.float32),
                       np.int64(rs.randint(100)))
        elif mode == "sample_list":
            for _ in range(9):
                yield [(rs.randn(6).astype(np.float32),
                        np.int64(rs.randint(100))) for _ in range(5)]
        else:
            for i in range(11):
                n = 7 if i < 10 else 3
                yield (rs.randn(n, 6).astype(np.float32),
                       rs.randint(100, size=n).astype(np.int64))
    return gen


def _flatten(obj):
    if isinstance(obj, (list, tuple)):
        return [x for item in obj for x in _flatten(item)]
    return [np.asarray(obj)]


@pytest.mark.parametrize("mode", ["sample", "sample_list", "batch"])
def test_readers_yield_bit_identical_epochs(clean_env, mode):
    """Each package's ``DistillReader`` over two of its own echo teachers
    (fixed), teacher batch 4, two epochs: the same values, dtypes and
    shapes in the same order."""
    epochs = {}
    for name, pkg in PKGS.items():
        servers = [pkg.serving.PredictServer(
            pkg.serving.EchoPredictBackend()).start() for _ in range(2)]
        reader = pkg.reader.DistillReader(
            feeds=("x", "y"), teacher_batch_size=4, require_num=2)
        reader.set_fixed_teacher(*[s.endpoint for s in servers])
        getattr(reader, "set_%s_generator" % mode)(_generators(mode))
        try:
            epochs[name] = [_flatten(list(reader())) for _ in range(2)]
        finally:
            reader.stop()
            for s in servers:
                s.stop()
    for jep, tep in zip(epochs["jax"], epochs["port"]):
        assert len(jep) == len(tep) > 0
        for a, b in zip(jep, tep):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def _delays_injected() -> float:
    """The port chaos plane's injections at ``distill.predict``."""
    from edl_tpu_torch.obs import metrics as obs_metrics

    series = obs_metrics.default_registry().snapshot().get(
        "edl_chaos_faults_injected_total", {})
    return sum(v for k, v in series.items() if "distill.predict" in k)


def test_teacher_failover_steps_on_the_port_stack(store, clean_env):
    """The JAX ``teacher-failover`` drill's steps with the port's store
    client, discovery, reader and chaos plane (every predict delayed
    30 ms by the armed ``distill.predict`` rule): teacher 1 dies at the
    5th batch, a replacement joins at the 9th, and the 24 batches arrive
    once each, in order."""
    job = "failover"
    tchaos.configure({"seed": 0, "rules": [
        {"point": "distill.predict", "proc": "student", "action": "delay",
         "delay_s": 0.03, "times": 0}]}, who="student")
    num_batches, batch = 24, 8
    t1 = tserving.PredictServer(tserving.EchoPredictBackend()).start()
    t2 = tserving.PredictServer(tserving.EchoPredictBackend()).start()
    svc = tdisc.DiscoveryService(store.endpoint, job, ["teacher"])
    reg1 = tdisc.TeacherRegister(store.endpoint, job, "teacher", t1.endpoint)
    reg2 = tdisc.TeacherRegister(store.endpoint, job, "teacher", t2.endpoint)
    probe = tdisc.DiscoveryClient(store.endpoint, job, "teacher",
                                  client_id="chaos-probe")
    replacement = []

    def batches():
        for i in range(num_batches):
            yield (np.full((batch, 4), float(i), np.float32),)

    reader = treader.DistillReader(feeds=("x",), teacher_batch_size=batch,
                                   require_num=2)
    reader.set_dynamic_teacher(store.endpoint, job, "teacher")
    reader.set_batch_generator(batches)
    seen = []
    before = _delays_injected()
    try:
        probe.wait_servers(timeout=WAIT_S)
        for i, out in enumerate(reader()):
            seen.append(int(out[0][0][0]))
            assert np.array_equal(out[1], np.full(batch, 4.0 * i, np.float32))
            if i == 4:
                reg1.stop()
                t1.stop()
            if i == 8 and not replacement:
                srv = tserving.PredictServer(
                    tserving.EchoPredictBackend()).start()
                replacement.append((srv, tdisc.TeacherRegister(
                    store.endpoint, job, "teacher", srv.endpoint)))
    finally:
        reader.stop()
        probe.stop()
        for srv, reg in replacement:
            reg.stop()
            srv.stop()
        reg2.stop()
        svc.stop()
        t2.stop()
        tchaos.disarm()
    assert seen == list(range(num_batches))
    assert _delays_injected() - before >= num_batches


_CHILD_SERVER = r"""
import sys, time
pkg = sys.argv[1]
if pkg == "jax":
    from edl_tpu.chaos.plane import arm_from_env
    from edl_tpu.distill.serving import EchoPredictBackend, PredictServer
else:
    from edl_tpu_torch.chaos.plane import arm_from_env
    from edl_tpu_torch.distill.serving import EchoPredictBackend, PredictServer
arm_from_env("teacher")
server = PredictServer(EchoPredictBackend()).start()
print(server.endpoint, flush=True)
time.sleep(120)
"""


def _jax_client_call(endpoint):
    """What a JAX ``PredictClient`` sees: ``("ok", echo, seconds)`` or
    ``("raised", exception class name, seconds)``."""
    client = jserving.PredictClient(endpoint, timeout=10.0)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t0 = time.monotonic()
    try:
        out = client.predict({"x": x})
        return ("ok", out["echo_x"].tolist(), time.monotonic() - t0)
    except Exception as exc:  # noqa: BLE001 — the outcome under test
        return ("raised", type(exc).__name__, time.monotonic() - t0)
    finally:
        client.close()


@pytest.mark.parametrize("action", ["delay", "drop"])
def test_serving_fault_point_looks_the_same_to_a_jax_client(clean_env,
                                                            action):
    """``distill.serving.predict`` armed in-process with a delay (0.3 s)
    or a drop on each package's server: the JAX client's outcome is the
    same (the echo after the delay; the same exception), and a ping does
    not fire the point."""
    outcomes = {}
    for name, pkg in PKGS.items():
        pkg.chaos.configure({"seed": 0, "rules": [
            {"point": "distill.serving.predict", "proc": "teacher",
             "action": action, "delay_s": 0.3,
             "match": {"method": "predict"}}]}, who="teacher")
        server = pkg.serving.PredictServer(
            pkg.serving.EchoPredictBackend()).start()
        try:
            ping = jserving.PredictClient(server.endpoint, timeout=10.0)
            assert ping.ping()
            ping.close()
            outcomes[name] = _jax_client_call(server.endpoint)
        finally:
            server.stop()
            pkg.chaos.disarm()
    kinds = {name: o[:2] for name, o in outcomes.items()}
    assert kinds["port"] == kinds["jax"]
    if action == "delay":
        assert kinds["port"][0] == "ok"
        assert all(o[2] >= 0.3 for o in outcomes.values())
    else:
        assert kinds["port"][0] == "raised"


def test_serving_fault_point_kill_looks_the_same_to_a_jax_client(clean_env):
    """A kill rule at ``distill.serving.predict``: each package's teacher
    process exits 137 mid-request, and the JAX client gets the same
    exception from both."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "JAX_PLATFORMS": "cpu",
        "EDL_CHAOS": json.dumps({"seed": 0, "rules": [
            {"point": "distill.serving.predict", "proc": "teacher",
             "action": "kill"}]}),
    })
    outcomes, codes = {}, {}
    for name in PKGS:
        child = subprocess.Popen(
            [sys.executable, "-c", _CHILD_SERVER, name], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            start_new_session=True)
        try:
            endpoint = child.stdout.readline().strip()
            assert endpoint, "%s server did not start" % name
            outcomes[name] = _jax_client_call(endpoint)[:2]
            codes[name] = child.wait(timeout=30)
        finally:
            if child.poll() is None:
                os.killpg(child.pid, signal.SIGKILL)
            child.wait(timeout=30)
            child.stdout.close()
    assert codes == {"jax": 137, "port": 137}
    assert outcomes["port"] == outcomes["jax"]
    assert outcomes["port"][0] == "raised"


def test_preemption_notice_drains_the_teacher_within_grace(store, clean_env):
    """A port teacher registered with its pod id; the pod's ``preempt/``
    key appears: the registration flips to draining and the balancer
    takes the teacher out of the student's assignment within
    ``DRAIN_GRACE_S``, while the other teacher stays."""
    job = "drain"
    servers = [tserving.PredictServer(tserving.EchoPredictBackend()).start()
               for _ in range(2)]
    regs = [tdisc.TeacherRegister(store.endpoint, job, "teacher",
                                  servers[0].endpoint, pod_id="pod-a"),
            tdisc.TeacherRegister(store.endpoint, job, "teacher",
                                  servers[1].endpoint, pod_id="pod-b")]
    svc = tdisc.DiscoveryService(store.endpoint, job, ["teacher"])
    client = tdisc.DiscoveryClient(store.endpoint, job, "teacher",
                                   client_id="student-0")
    sc = StoreClient(store.endpoint, timeout=5.0)
    try:
        _until(lambda: sorted(client.get_servers()[1])
               == sorted(s.endpoint for s in servers), "both teachers")
        t0 = time.monotonic()
        Registry(sc, job).set_permanent(PREEMPT_SERVICE, "pod-a", json.dumps(
            {"deadline": time.time() + 30, "budget": 30.0,
             "ts": time.time()}).encode())
        _until(lambda: client.get_servers()[1] == [servers[1].endpoint],
               "the drain", timeout=DRAIN_GRACE_S)
        assert time.monotonic() - t0 <= DRAIN_GRACE_S
        marks = {m.name: m.value for m in Registry(sc, job).get_service(
            tdisc.TEACHER_SERVICE % "teacher")}
        assert marks == {servers[0].endpoint: tdisc.DRAINING,
                         servers[1].endpoint: b"1"}
    finally:
        sc.close()
        client.stop()
        svc.stop()
        for reg in regs:
            reg.stop()
        for s in servers:
            s.stop()


# -- fetch --------------------------------------------------------------------


def _fetch_outcome(module, uri, **kw):
    try:
        return ("ok", module.fetch_model(uri, **kw))
    except module.FetchError as exc:
        return ("FetchError", str(exc))


def test_fetch_model_matches_jax(tmp_path, clean_env):
    """A local path and ``file://`` come back in place, with or without
    their sha256; a wrong sha256 and a missing file raise the same
    ``FetchError``; a cached copy whose sha256 matches is reused (an
    unknown scheme cannot reach the network, so the cache hit is the
    only way that call can answer), and the env contract names the same
    knobs."""
    art = tmp_path / "teacher.msgpack"
    art.write_bytes(b"edl teacher params" * 100)
    digest = tfetch.sha256_of(str(art))
    assert digest == jfetch.sha256_of(str(art))
    wrong = "0" * 64
    calls = [
        (str(art), {}),
        ("file://" + str(art), {}),
        (str(art), {"sha256": digest}),
        ("file://" + str(art), {"sha256": digest.upper()}),
        (str(art), {"sha256": wrong}),
        (str(tmp_path / "missing.msgpack"), {}),
    ]
    for uri, kw in calls:
        assert _fetch_outcome(tfetch, uri, **kw) == _fetch_outcome(
            jfetch, uri, **kw), (uri, kw)
    assert _fetch_outcome(tfetch, str(art))[1] == str(art)
    # the cache: {cache}/{sha256[:32]}/{basename}
    uri = "nosuch://host/teacher.msgpack"
    for name, module in (("jax", jfetch), ("port", tfetch)):
        cache = tmp_path / ("cache-" + name)
        hit = cache / digest[:32] / "teacher.msgpack"
        hit.parent.mkdir(parents=True)
        hit.write_bytes(art.read_bytes())
        assert module.fetch_model(uri, sha256=digest,
                                  cache_dir=str(cache)) == str(hit)
        # a stale cached copy is dropped, and the scheme is refused
        hit.write_bytes(b"torn")
        kind, msg = _fetch_outcome(module, uri, sha256=digest,
                                   cache_dir=str(cache))
        assert kind == "FetchError" and not hit.exists()
    clean_env.setenv("EDL_DISTILL_MODEL_URI", "file://" + str(art))
    clean_env.setenv("EDL_DISTILL_MODEL_SHA256", digest)
    assert tfetch.fetch_from_env() == jfetch.fetch_from_env() == str(art)
