"""The AOT resize ladder (memory plans) and the compile-cache exchange of
the port (``edl_tpu_torch/train/aot.py``, ``ops/_build.py``), on the CPU,
against ``edl_tpu/train/aot.py``.

Every case of ``tests/test_aot.py`` that applies runs here over the port
under its JAX name: rung enumeration, the manifest, the ladder (the
planner in place of the compiler; it plans every rung of the window,
where the JAX ladder skips a grow beyond the devices it can see), the
exchange on real sockets and a real store, and the chaos drill. The JAX package's portable keys and jit-seam
patches are XLA's; their counterpart here is ``ops/_build``'s resolution
of the kernel-library dir (cache dir, then ``ops/build/`` copied in, then
``nvcc``: a stub here), with its hit/miss/write counts.

The cross pairs hold the two packages to one store and one wire: a JAX
ladder's claim and a port ladder's claim dedupe each other and publish
the same rung keys, a port ``CacheExchange`` serves the JAX
``pull_missing`` and the reverse, byte-identical, and both scanners give
equal manifests for one directory. The rung plans are exact against the
plans measured by stages at those worlds (DDP, and fsdp 1 ↔ 2: two gloo
ranks of ``tests/torch_fsdp_worker.py``), and the launcher's fit gate
reads them. ``train.init``'s pull fills a worker's cache dir from a peer,
once per process. The store is a port store server, a child in a session of its
own (``test_torch_replicate.ChildStore``).

Tolerances: exact everywhere (bytes, digests, keys, plan bytes).
"""

import hashlib
import json
import os
import sys
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from edl_tpu_torch.chaos.plane import configure as chaos_configure
from edl_tpu_torch.obs import memory as port_memory
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.train import aot
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Compile this module's JAX code afresh: another test file in the same
    worker may have armed JAX's persistent compilation cache with a key
    function (``edl_tpu.train.aot.enable_portable_cache_keys``) that this
    JAX version cannot call."""
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


def _env_stub(**over):
    base = dict(
        world_size=2, nproc_per_node=1, min_nodes=1, max_nodes=3,
        global_rank=0, pod_id="podA", job_id="aotjob", store_endpoint="",
    )
    base.update(over)
    return SimpleNamespace(**base)


def _ladder(env, fn, **kw):
    kw.setdefault("delay", 0.0)
    return aot.AotLadder(env, fn, **kw)


def _wait_until(pred, timeout=10.0, every=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(every)
    return pred()


# -- rung enumeration ---------------------------------------------------------

class TestNeighborWorlds:
    def test_nearest_first_shrink_before_grow(self):
        assert aot.neighbor_worlds(4, 1, 1, 6) == [3, 5, 2, 6]

    def test_window_clamps(self):
        assert aot.neighbor_worlds(1, 1, 1, 3) == [2, 3]
        assert aot.neighbor_worlds(3, 1, 1, 3) == [2, 1]
        assert aot.neighbor_worlds(4, 1, 4, 4) == []

    def test_nproc_scales_worlds(self):
        assert aot.neighbor_worlds(4, 2, 1, 4) == [2, 6, 8]

    def test_non_divisible_world_is_a_noop(self):
        assert aot.neighbor_worlds(5, 2, 1, 4) == []

    @pytest.mark.parametrize("args", [(4, 1, 1, 6), (1, 1, 1, 3),
                                      (3, 1, 1, 3), (4, 2, 1, 4),
                                      (5, 2, 1, 4), (2, 4, 1, 8)])
    def test_same_rungs_as_jax(self, args):
        from edl_tpu.train import aot as jaot

        assert aot.neighbor_worlds(*args) == jaot.neighbor_worlds(*args)


# -- manifest / digest machinery ----------------------------------------------

class TestManifest:
    def test_scan_digests_entries_and_skips_sidecars(self, tmp_path):
        (tmp_path / "key1-cache").write_bytes(b"exec one")
        (tmp_path / "key2-cache").write_bytes(b"exec two")
        (tmp_path / "key1-cache-atime").write_bytes(b"12345678")
        (tmp_path / ".hidden").write_bytes(b"x")
        (tmp_path / ("key3" + aot._TMP_MARK + ".99")).write_bytes(b"torn")
        m = aot.scan_manifest(str(tmp_path))
        assert sorted(m) == ["key1-cache", "key2-cache"]
        assert m["key1-cache"]["sha"] == hashlib.sha256(b"exec one").hexdigest()
        assert m["key2-cache"]["size"] == len(b"exec two")

    def test_scan_missing_dir_is_empty(self, tmp_path):
        assert aot.scan_manifest(str(tmp_path / "nope")) == {}

    def test_in_flight_builds_are_not_entries(self, tmp_path):
        # ops/_build writes <lib>.<pid>.tmp, then renames it into place
        (tmp_path / "libflash_fwd-0123456789abcdef.so").write_bytes(b"lib")
        (tmp_path / "libflash_bwd-0123456789abcdef.so.77.tmp").write_bytes(b"x")
        assert sorted(aot.scan_manifest(str(tmp_path))) == [
            "libflash_fwd-0123456789abcdef.so"]

    def test_manifest_equals_jax_scanners(self, tmp_path):
        from edl_tpu.train import aot as jaot

        rs = np.random.RandomState(0)
        for i in range(4):
            (tmp_path / ("lib%d-cache" % i)).write_bytes(
                rs.bytes(1000 + 97 * i))
        (tmp_path / "lib0-cache-atime").write_bytes(b"01234567")
        (tmp_path / ("lib9" + aot._TMP_MARK + ".5")).write_bytes(b"torn")
        assert aot.scan_manifest(str(tmp_path)) == \
            jaot.scan_manifest(str(tmp_path))


# -- the kernel-library cache dir (ops/_build.py) -----------------------------

@pytest.fixture()
def build_rig(tmp_path, monkeypatch):
    """``ops/_build`` over a private checkout dir and cache dir, with a
    stub in place of ``nvcc`` that writes a library and records its
    calls; the resolved dir is reset before and after."""
    from edl_tpu_torch.ops import _build

    checkout = tmp_path / "ops_build"
    checkout.mkdir()
    cache = tmp_path / "cache"
    calls = []

    class Run:
        returncode = 0
        stdout = "ptxas info: stub"

    def fake_run(cmd, **kwargs):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as fh:
            fh.write(b"built " + os.path.basename(cmd[-1]).encode())
        return Run()

    monkeypatch.setattr(_build, "BUILD_DIR", str(checkout))
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setenv("EDL_COMPILE_CACHE_DIR", str(cache))
    yield SimpleNamespace(build=_build, checkout=checkout, cache=cache,
                          calls=calls)


class TestLibraryCacheDir:
    def _counts(self, b):
        return b.cache_event_counts()

    def test_cache_dir_resolves_once_at_first_build(self, build_rig,
                                                    monkeypatch):
        b = build_rig.build
        assert b._cache_dir is None  # nothing at import
        assert b.cache_dir() == str(build_rig.cache)
        monkeypatch.setenv("EDL_COMPILE_CACHE_DIR", "/elsewhere")
        assert b.cache_dir() == str(build_rig.cache)  # kept: a hot restage

    @pytest.mark.parametrize("value", ["", "none"])
    def test_without_a_named_dir_the_checkout_is_the_cache(
            self, build_rig, monkeypatch, value):
        monkeypatch.setenv("EDL_COMPILE_CACHE_DIR", value)
        assert build_rig.build.cache_dir() == str(build_rig.checkout)

    def test_build_then_hit(self, build_rig):
        b = build_rig.build
        before = self._counts(b)
        lib, log = b.build("flash_fwd")
        assert lib == str(build_rig.cache / b.library_name("flash_fwd"))
        assert log == "ptxas info: stub" and len(build_rig.calls) == 1
        assert open(lib, "rb").read() == b"built flash_fwd.cu"
        again, log2 = b.build("flash_fwd")
        assert again == lib and log2 == "" and len(build_rig.calls) == 1
        after = self._counts(b)
        assert {k: after[k] - before[k] for k in after} == {
            "hit": 1, "miss": 1, "write": 1}
        assert not [n for n in os.listdir(build_rig.cache)
                    if n.endswith(".tmp")]

    def test_checkout_library_is_copied_in_without_nvcc(self, build_rig):
        b = build_rig.build
        name = b.library_name("flash_bwd")
        (build_rig.checkout / name).write_bytes(b"shipped bytes")
        before = self._counts(b)
        lib, log = b.build("flash_bwd")
        assert lib == str(build_rig.cache / name) and log == ""
        assert open(lib, "rb").read() == b"shipped bytes"
        assert build_rig.calls == []  # nvcc never ran
        after = self._counts(b)
        assert {k: after[k] - before[k] for k in after} == {
            "hit": 0, "miss": 1, "write": 1}

    def test_a_pulled_library_is_a_hit(self, build_rig):
        b = build_rig.build
        build_rig.cache.mkdir()
        (build_rig.cache / b.library_name("flash_fwd")).write_bytes(b"peer")
        # another source version's library sits inert beside it
        (build_rig.cache / "libflash_fwd-ffffffffffffffff.so").write_bytes(b"x")
        lib, _ = b.build("flash_fwd")
        assert open(lib, "rb").read() == b"peer" and build_rig.calls == []

    def test_preload_without_nvcc_loads_what_resolves(self, build_rig,
                                                      monkeypatch):
        b = build_rig.build
        opened = []
        monkeypatch.setattr(b.ctypes, "CDLL", lambda path: opened.append(path)
                            or path)
        assert b.preload() == []  # nothing anywhere: nothing built
        assert build_rig.calls == [] and opened == []
        (build_rig.checkout / b.library_name("flash_fwd")).write_bytes(b"lib")
        assert b.preload() == ["flash_fwd"]
        assert opened == [str(build_rig.cache / b.library_name("flash_fwd"))]
        assert build_rig.calls == []
        assert b.load("flash_fwd") == opened[0]  # the preloaded library

    def test_sources_are_the_kernels(self, build_rig):
        assert build_rig.build.sources() == ["flash_bwd", "flash_fwd"]


# -- the ladder ---------------------------------------------------------------

class TestAotLadder:
    @pytest.fixture(autouse=True)
    def _one_device_per_proc(self, monkeypatch):
        monkeypatch.setenv("EDL_DEVICES_PER_PROC", "1")

    def test_multi_device_processes_scale_rungs(self, monkeypatch):
        # world counts PROCESSES and the port's ladder plans every rung
        # of the window: EDL_DEVICES_PER_PROC (a JAX grow of 12 devices
        # over 8 is skipped there) changes no rung here
        monkeypatch.setenv("EDL_DEVICES_PER_PROC", "4")
        compiled = []
        before = aot._M_AOT.value(outcome="ok")
        ladder = _ladder(_env_stub(), compiled.append).start()
        assert _wait_until(lambda: len(ladder.compiled) == 2)
        ladder.close()
        assert compiled == [1, 3]
        assert aot._M_AOT.value(outcome="ok") == before + 2

    def test_compiles_neighbor_worlds_in_order(self):
        compiled = []
        ladder = _ladder(_env_stub(), compiled.append).start()
        assert _wait_until(lambda: len(ladder.compiled) == 2)
        ladder.close()
        assert compiled == [1, 3]
        assert ladder.compiled == [1, 3]

    def test_default_devices_plan_every_rung_of_the_window(self):
        # a torch rank is not bound to a device of its own: the window's
        # grows are planned without a device bound
        compiled = []
        ladder = aot.AotLadder(_env_stub(world_size=1), compiled.append,
                               delay=0.0).start()
        assert _wait_until(lambda: len(ladder.compiled) == 2)
        ladder.close()
        assert compiled == [2, 3]

    def test_nonzero_rank_without_store_defers(self):
        compiled = []
        ladder = _ladder(_env_stub(global_rank=1), compiled.append).start()
        time.sleep(0.3)
        ladder.close()
        assert compiled == []

    def test_failed_compile_is_counted_never_raised(self):
        def boom(world):
            raise RuntimeError("planner says no")

        before = aot._M_AOT.value(outcome="failed")
        ladder = _ladder(_env_stub(), boom).start()
        assert _wait_until(
            lambda: aot._M_AOT.value(outcome="failed") >= before + 2
        )
        ladder.close()
        assert ladder.compiled == []

    def test_indivisible_rung_is_skipped_not_failed(self):
        def indivisible(world):
            raise aot.RungUnavailable("dim 0 (5) not divisible over fsdp=2")

        before_f = aot._M_AOT.value(outcome="failed")
        before_s = aot._M_AOT.value(outcome="skipped_indivisible")
        ladder = _ladder(_env_stub(), indivisible).start()
        assert _wait_until(
            lambda: aot._M_AOT.value(outcome="skipped_indivisible")
            >= before_s + 2
        )
        ladder.close()
        assert aot._M_AOT.value(outcome="failed") == before_f
        assert ladder.compiled == []

    def test_store_claim_dedupes_across_pods(self, store):
        client = StoreClient(store.endpoint)
        a_worlds, b_worlds = [], []
        env_a = _env_stub(store_endpoint=store.endpoint, job_id="dedupe")
        env_b = _env_stub(store_endpoint=store.endpoint, pod_id="podB",
                          job_id="dedupe")
        try:
            ladder_a = _ladder(env_a, a_worlds.append, client=client).start()
            assert _wait_until(lambda: len(ladder_a.compiled) == 2)
            ladder_a.close()
            before = aot._M_AOT.value(outcome="skipped_claimed")
            ladder_b = _ladder(env_b, b_worlds.append, client=client).start()
            assert _wait_until(
                lambda: aot._M_AOT.value(outcome="skipped_claimed")
                >= before + 2
            )
            ladder_b.close()
        finally:
            client.close()
        assert a_worlds == [1, 3]
        assert b_worlds == []

    def test_peer_failure_releases_rung_to_deferred_retry(
        self, store, monkeypatch
    ):
        monkeypatch.setattr(aot.AotLadder, "_RETRY_DELAY", 0.3)
        from edl_tpu_torch.discovery.registry import Registry

        client = StoreClient(store.endpoint)
        try:
            regs = [
                Registry(client, "retry").register_if_absent(
                    "aot", str(w), b"podA.0", ttl=60.0
                )[0]
                for w in (1, 3)
            ]
            before = aot._M_AOT.value(outcome="skipped_claimed")
            compiled = []
            ladder = _ladder(
                _env_stub(pod_id="podB", store_endpoint=store.endpoint,
                          job_id="retry"),
                compiled.append, client=client,
            ).start()
            assert _wait_until(
                lambda: aot._M_AOT.value(outcome="skipped_claimed")
                >= before + 2
            )
            for reg in regs:  # the peer's rungs fail: claims released
                reg.stop(delete=True)
            assert _wait_until(lambda: len(ladder.compiled) == 2)
            ladder.close()
            assert compiled == [1, 3]
        finally:
            client.close()

    def test_grow_beyond_visible_devices_is_skipped(self):
        # the JAX ladder skips a grow beyond its visible devices; a torch
        # rank has no device of its own, so the port plans the rung and
        # its plan says whether the grow fits
        compiled = []
        ladder = _ladder(_env_stub(), compiled.append, worlds=[12]).start()
        assert _wait_until(lambda: len(ladder.compiled) == 1)
        ladder.close()
        assert compiled == [12]

    def test_ladder_seconds_land_in_aot_compile_state(self):
        from edl_tpu_torch.obs import metrics as obs_metrics

        counter = obs_metrics.default_registry().counter(
            "edl_goodput_seconds_total")
        before = counter.value(state="aot_compile", cause="w1")
        ladder = _ladder(_env_stub(), lambda w: time.sleep(0.05)).start()
        assert _wait_until(lambda: len(ladder.compiled) == 2)
        ladder.close()
        assert counter.value(state="aot_compile", cause="w1") > before

    def test_chaos_drop_on_compile_point_is_a_counted_failure(self):
        chaos_configure(
            {"rules": [{"point": "train.aot.compile", "action": "drop",
                        "times": 0}]},
            who="pytest",
        )
        try:
            compiled = []
            before = aot._M_AOT.value(outcome="failed")
            ladder = _ladder(_env_stub(), compiled.append).start()
            assert _wait_until(
                lambda: aot._M_AOT.value(outcome="failed") >= before + 2
            )
            ladder.close()
            assert compiled == []
        finally:
            chaos_configure({"rules": []}, who="pytest")


@pytest.mark.parametrize("first", ["jax", "port"])
def test_jax_and_port_ladders_dedupe_and_publish_one_key_set(
        store, monkeypatch, first):
    """A JAX ladder and a port ladder of one job on one port store: the
    first claims and finishes both rungs, the second finds them done, and
    the store holds the same ``aot/{world}`` keys either way."""
    from edl_tpu.store.client import StoreClient as JaxClient
    from edl_tpu.train import aot as jaot

    monkeypatch.setenv("EDL_DEVICES_PER_PROC", "1")
    job = "mixed-" + first
    done = {"jax": [], "port": []}
    clients = {"jax": JaxClient(store.endpoint),
               "port": StoreClient(store.endpoint)}

    def run(pkg, pod):
        env = _env_stub(store_endpoint=store.endpoint, job_id=job, pod_id=pod)
        if pkg == "jax":
            ladder = jaot.AotLadder(env, done[pkg].append,
                                    client=clients[pkg], delay=0.0)
        else:
            ladder = _ladder(env, done[pkg].append, client=clients[pkg])
        ladder.start()
        return ladder

    try:
        second = "port" if first == "jax" else "jax"
        ladder = run(first, "pod-" + first)
        assert _wait_until(lambda: len(ladder.compiled) == 2)
        ladder.close()
        ladder = run(second, "pod-" + second)
        time.sleep(0.5)
        ladder.close()
        rows, _ = clients["port"].range("/%s/aot/" % job)
        keys = {k: v for k, v, _r, _l in rows}
    finally:
        for c in clients.values():
            c.close()
    assert done[first] == [1, 3] and done[second] == []
    assert keys == {"/%s/aot/1" % job: b"done:pod-" + first.encode(),
                    "/%s/aot/3" % job: b"done:pod-" + first.encode()}


# -- the planner ---------------------------------------------------------------

LM = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128)


def _lm_state():
    """World 1 of the LM of ``tests/torch_fsdp_worker.py``: AdamW's state
    made by one step, no process group (the module whole)."""
    from edl_tpu_torch.models.transformer import TransformerLM
    from edl_tpu_torch.train import adamw, create_state, cross_entropy_loss
    from edl_tpu_torch.train import make_train_step

    state = create_state(TransformerLM(dtype=torch.float32, device="cpu", **LM),
                         0, adamw(1e-3), device="cpu")
    x, y = _lm_batch()
    state, _ = make_train_step(cross_entropy_loss)(
        state, (torch.from_numpy(x), torch.from_numpy(y)))
    return state


def _lm_batch():
    rs = np.random.RandomState(0)
    tok = rs.randint(0, LM["vocab_size"], (8, 17))
    return tok[:, :-1], tok[:, 1:]


def _plans(state, live_world, worlds, **kw):
    live = port_memory.harvest_plan(state, "cpu", world=live_world)
    got = {}
    plan_for = aot.make_neighbor_planner(
        state, live, on_planned=lambda p, w: got.__setitem__(w, p), **kw)
    for w in worlds:
        plan_for(w)
    return live, got


@pytest.fixture(scope="module")
def world2_stages(tmp_path_factory):
    """Two gloo ranks of ``tests/torch_fsdp_worker.py``: the LM sharded at
    fsdp 2, one step, its rung plan for world 1 and its state bytes; then
    the LM under DDP, the same."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_fsdp import _stage

    tmp = tmp_path_factory.mktemp("rungs")
    x, y = _lm_batch()
    data = str(tmp / "lm.npz")
    np.savez(data, x0=x, y0=y)
    outs = {k: str(tmp / ("%s.npz" % k)) for k in ("fsdp", "ddp")}
    _stage(tmp, "rungs", 2, [
        {"op": "build", "model": "lm", "seed": 0, "shard": True},
        {"op": "steps", "model": "lm", "data": data, "n": 1},
        {"op": "plan", "worlds": [1], "fsdp": True},
        {"op": "dump", "out": outs["fsdp"]},
        {"op": "build", "model": "lm", "seed": 0, "ddp": True},
        {"op": "steps", "model": "lm", "data": data, "n": 1},
        {"op": "plan", "worlds": [1], "fsdp": False, "axes": {"dp": -1}},
        {"op": "dump", "out": outs["ddp"]},
    ], group=True)
    return {k: dict(np.load(v)) for k, v in outs.items()}


def test_fsdp_rung_plans_equal_the_measured_plans(world2_stages):
    """fsdp 1 ↔ 2: world 1's rung for world 2 is the bytes rank 0 of a
    real fsdp-2 stage holds (its padded shards and AdamW's), and that
    stage's rung for world 1 is world 1's measured bytes; ``temp`` is the
    live plan's."""
    fsdp2 = world2_stages["fsdp"]
    assert bool(fsdp2["sharded"])
    state = _lm_state()
    live, rungs = _plans(state, 1, [2], fsdp=True,
                         mesh_axes={"dp": 1, "fsdp": -1})
    assert rungs[2].argument == float(fsdp2["state_bytes"][0])
    assert rungs[2].temp == live.temp and rungs[2].world == 2
    assert float(fsdp2["rung/1"]) == live.argument
    assert float(fsdp2["state_bytes"][0]) < 0.6 * live.argument


def test_ddp_rung_plans_equal_the_measured_plans(world2_stages):
    ddp2 = world2_stages["ddp"]
    state = _lm_state()
    live, rungs = _plans(state, 1, [2, 3])
    assert rungs[2].argument == float(ddp2["state_bytes"][0]) == live.argument
    assert rungs[3].argument == live.argument
    assert float(ddp2["rung/1"]) == live.argument


def test_indivisible_fsdp_rung_raises_like_jax():
    """A parameter whose JAX spec dim (the largest the live fsdp size
    divides) the rung's size does not divide: ``RungUnavailable``, the
    JAX rung's outcome (fsdp 1 → 3 over a [64, 64] kernel)."""
    state = _lm_state()
    live = port_memory.harvest_plan(state, "cpu", world=1)
    plan_for = aot.make_neighbor_planner(
        state, live, mesh_axes={"dp": 1, "fsdp": -1}, fsdp=True)
    with pytest.raises(aot.RungUnavailable, match="not divisible"):
        plan_for(3)
    live.world = 2
    with pytest.raises(ValueError, match="cannot fill"):
        aot.make_neighbor_planner(
            state, live, mesh_axes={"dp": 2, "fsdp": -1}, fsdp=True)(3)


@pytest.mark.parametrize("rung_argument, want", [
    (9e9, None),   # the rung fits: the grow goes through
    (79e9, 1),     # the rung is over its limit: the grow stops below it
    (None, None),  # no rung published: unknown never gates
])
def test_fit_gate_reads_published_rungs(store, rung_argument, want):
    """The launcher's fit gate over what ``MemoryPlane.harvest_rung``
    publishes: the live world's fitting plan and the ladder's rung for
    world 2, stamped with the live limit."""
    from edl_tpu_torch.launch import launcher

    job = "fit-%s" % rung_argument
    client = StoreClient(store.endpoint)
    try:
        plane = port_memory.MemoryPlane(device="cpu", stage="s", rank=0,
                                        client=client, job_id=job)
        plane._limit = 80e9  # the limit a card's allocator would report
        live = port_memory.MemoryPlan(argument=10e9, temp=1e9, world=1,
                                      limit=80e9)
        port_memory.publish_plan(client, job, live)
        if rung_argument is not None:
            rung = plane.harvest_rung(
                port_memory.MemoryPlan(argument=rung_argument, temp=1e9), 2)
            assert rung.limit == 80e9 and plane.plan is None
        plane.close()
        plans = port_memory.read_plans(client, job)
        assert sorted(plans) == ([1] if rung_argument is None else [1, 2])
        fake = SimpleNamespace(
            client=client,
            job_env=SimpleNamespace(job_id=job, nproc_per_node=1))
        assert launcher.ElasticLauncher._mem_fit_cap(fake) == want
    finally:
        client.close()


# -- the exchange -------------------------------------------------------------

@pytest.fixture()
def exchange_rig(store, tmp_path):
    """A served pod-A cache dir + an empty pod-B dir on a real store."""
    client = StoreClient(store.endpoint)
    job = "xjob-" + os.path.basename(str(tmp_path))
    dir_a = tmp_path / "cache_a"
    dir_b = tmp_path / "cache_b"
    dir_a.mkdir()
    dir_b.mkdir()
    entries = {
        "k1-cache": b"executable one" * 100,
        "k2-cache": b"executable two" * 100,
        "k3-cache": b"\x00\x01binary\xff" * 64,
    }
    for name, data in entries.items():
        (dir_a / name).write_bytes(data)
    (dir_a / "k1-cache-atime").write_bytes(b"01234567")  # never shipped
    xchg = aot.CacheExchange(
        str(dir_a), client, job, "podA", host="127.0.0.1"
    ).start()
    assert _wait_until(lambda: "podA" in aot.read_manifests(client, job))
    yield SimpleNamespace(
        store=store, client=client, dir_a=dir_a, dir_b=dir_b, job=job,
        entries=entries, xchg=xchg,
    )
    xchg.stop()
    client.close()


class TestCacheExchange:
    def test_manifest_published_and_readable(self, exchange_rig):
        r = exchange_rig
        manifests = aot.read_manifests(r.client, r.job)
        assert set(manifests) == {"podA"}
        m = manifests["podA"]
        assert sorted(m["entries"]) == sorted(r.entries)
        assert m["endpoint"].endswith(":%d" % r.xchg.port)
        assert "k1-cache-atime" not in m["entries"]

    def test_empty_pod_pulls_everything_byte_identical(self, exchange_rig):
        r = exchange_rig
        rx_before = aot._M_XCHG_BYTES.value(dir="rx")
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB"
        )
        assert stats["pulled"] == len(r.entries)
        assert stats["skipped_bad"] == 0
        assert stats["peers"] == 1
        for name, data in r.entries.items():
            assert (r.dir_b / name).read_bytes() == data
        assert aot._M_XCHG_BYTES.value(dir="rx") == rx_before + stats["bytes"]
        assert stats["bytes"] == sum(len(d) for d in r.entries.values())
        again = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB"
        )
        assert again["pulled"] == 0

    def test_own_manifest_is_never_pulled(self, exchange_rig):
        r = exchange_rig
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podA"
        )
        assert stats == {"pulled": 0, "bytes": 0, "skipped_bad": 0, "peers": 0}

    def test_unchanged_refresh_does_not_republish(self, exchange_rig):
        r = exchange_rig
        key = "/%s/%s/podA" % (r.job, aot.MANIFEST_SERVICE)
        _, rev_before = r.client.get_with_rev(key)
        r.xchg.refresh(force=True)
        r.xchg.refresh(force=True)
        _, rev_after = r.client.get_with_rev(key)
        assert rev_after == rev_before

    def test_refresh_republishes_new_entries(self, exchange_rig):
        r = exchange_rig
        (r.dir_a / "k4-cache").write_bytes(b"late entry" * 50)
        r.xchg.refresh(force=True)
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB"
        )
        assert stats["pulled"] == len(r.entries) + 1
        assert (r.dir_b / "k4-cache").read_bytes() == b"late entry" * 50

    def test_server_refuses_path_shaped_names(self, exchange_rig, tmp_path):
        from edl_tpu_torch.rpc.wire import request_once

        secret = tmp_path / "secret.txt"
        secret.write_bytes(b"not a cache entry")
        resp = request_once(
            exchange_rig.xchg.endpoint,
            {"i": 1, "m": "cache_pull",
             "names": ["../secret.txt", ".hidden", "a/b", "k1-cache"]},
            timeout=5.0,
        )
        assert resp["ok"]
        assert set(resp["entries"]) == {"k1-cache"}

    def test_tampered_entry_is_skipped_not_landed(self, exchange_rig):
        r = exchange_rig
        (r.dir_a / "k1-cache").write_bytes(b"tampered!")
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB"
        )
        assert stats["skipped_bad"] == 1
        assert stats["pulled"] == len(r.entries) - 1
        assert not (r.dir_b / "k1-cache").exists()
        assert not any(aot._TMP_MARK in p.name for p in r.dir_b.iterdir())

    def test_pull_without_store_is_a_noop(self, tmp_path):
        stats = aot.pull_missing(str(tmp_path), endpoint="", job_id="j")
        assert stats["pulled"] == 0

    def test_pull_survives_dead_peer_endpoint(self, exchange_rig):
        r = exchange_rig
        r.client.put(
            "/%s/compile_cache/podGone" % r.job,
            json.dumps({
                "endpoint": "127.0.0.1:1",  # nothing listens there
                "entries": {"kX-cache": "0" * 64},
                "ts": 0,
            }).encode(),
        )
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB",
            deadline=5.0,
        )
        assert stats["pulled"] == len(r.entries)
        assert not (r.dir_b / "kX-cache").exists()

    def test_hostile_manifest_name_never_dialed_or_landed(self, exchange_rig):
        r = exchange_rig
        evil = {"../escape": "0" * 64, ".dotted": "1" * 64, "a/b": "2" * 64}
        r.client.put(
            "/%s/compile_cache/podEvil" % r.job,
            json.dumps({
                "endpoint": r.xchg.endpoint,
                "entries": evil, "ts": 0,
            }).encode(),
        )
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB",
        )
        assert stats["pulled"] == len(r.entries)
        assert stats["peers"] == 1
        assert not (r.dir_b.parent / "escape").exists()
        assert sorted(p.name for p in r.dir_b.iterdir()) == sorted(r.entries)

    def test_byte_capped_response_splits_and_completes(
        self, exchange_rig, monkeypatch
    ):
        monkeypatch.setenv("EDL_CACHE_PULL_MAX_BYTES", "2000")
        r = exchange_rig
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB",
        )
        assert stats["pulled"] == len(r.entries)
        for name, data in r.entries.items():
            assert (r.dir_b / name).read_bytes() == data

    def test_oversize_single_entry_still_ships(self, exchange_rig, monkeypatch):
        monkeypatch.setenv("EDL_CACHE_PULL_MAX_BYTES", "10")
        r = exchange_rig
        stats = aot.pull_missing(
            str(r.dir_b), client=r.client, job_id=r.job, own_pod="podB",
        )
        assert stats["pulled"] == len(r.entries)

    def test_scan_thread_republishes_without_caller(self, store, tmp_path):
        client = StoreClient(store.endpoint)
        try:
            d = tmp_path / "cache_t"
            d.mkdir()
            xchg = aot.CacheExchange(
                str(d), client, "xjob3", "podT", host="127.0.0.1"
            )
            xchg._REFRESH_EVERY = 0.2
            xchg.start()
            try:
                (d / "kN-cache").write_bytes(b"fresh entry")
                assert _wait_until(
                    lambda: "kN-cache" in (
                        aot.read_manifests(client, "xjob3")
                        .get("podT", {}).get("entries") or {}
                    ),
                    timeout=5.0,
                )
            finally:
                xchg.stop()
        finally:
            client.close()

    def test_stop_retracts_manifest(self, store, tmp_path):
        client = StoreClient(store.endpoint)
        try:
            d = tmp_path / "cache_c"
            d.mkdir()
            (d / "kZ-cache").write_bytes(b"entry")
            xchg = aot.CacheExchange(
                str(d), client, "xjob2", "podC", host="127.0.0.1"
            ).start()
            assert _wait_until(
                lambda: "podC" in aot.read_manifests(client, "xjob2")
            )
            xchg.stop()
            assert "podC" not in aot.read_manifests(client, "xjob2")
        finally:
            client.close()


class TestChaosDrill:
    """A corrupted/dropped cache-entry pull degrades to a normal build —
    entries are skipped, nothing lands poisoned, nothing wedges."""

    def test_corrupt_pull_skips_every_entry(self, exchange_rig):
        chaos_configure(
            {"rules": [{"point": "store.cache.exchange",
                        "action": "corrupt", "times": 0}]},
            who="pytest",
        )
        try:
            stats = aot.pull_missing(
                str(exchange_rig.dir_b), client=exchange_rig.client,
                job_id=exchange_rig.job, own_pod="podB",
            )
        finally:
            chaos_configure({"rules": []}, who="pytest")
        assert stats["pulled"] == 0
        assert stats["skipped_bad"] == len(exchange_rig.entries)
        assert list(exchange_rig.dir_b.iterdir()) == []

    def test_dropped_pull_is_contained_and_bounded(self, exchange_rig):
        chaos_configure(
            {"rules": [{"point": "store.cache.exchange",
                        "action": "drop", "times": 0}]},
            who="pytest",
        )
        t0 = time.monotonic()
        try:
            stats = aot.pull_missing(
                str(exchange_rig.dir_b), client=exchange_rig.client,
                job_id=exchange_rig.job, own_pod="podB", deadline=10.0,
            )
        finally:
            chaos_configure({"rules": []}, who="pytest")
        assert time.monotonic() - t0 < 10.0
        assert stats["pulled"] == 0
        assert stats["skipped_bad"] == len(exchange_rig.entries)
        assert list(exchange_rig.dir_b.iterdir()) == []


@pytest.mark.parametrize("server", ["port", "jax"])
def test_exchanges_serve_each_other_byte_identical(store, tmp_path, server):
    """A port ``CacheExchange`` served to the JAX ``pull_missing``, and a
    JAX one to the port's: every entry lands byte-identical, the two
    manifests of one directory are equal, and the pullers' stats agree."""
    from edl_tpu.store.client import StoreClient as JaxClient
    from edl_tpu.train import aot as jaot

    rs = np.random.RandomState(3)
    src = tmp_path / "src"
    src.mkdir()
    entries = {"lib%d-cache" % i: rs.bytes(3000 + 511 * i) for i in range(5)}
    for name, data in entries.items():
        (src / name).write_bytes(data)
    job = "cross-" + server
    serve_pkg, pull_pkg = (aot, jaot) if server == "port" else (jaot, aot)
    clients = {aot: StoreClient(store.endpoint), jaot: JaxClient(store.endpoint)}
    xchg = serve_pkg.CacheExchange(str(src), clients[serve_pkg], job, "podS",
                                   host="127.0.0.1").start()
    try:
        assert _wait_until(
            lambda: "podS" in aot.read_manifests(clients[aot], job))
        m_port = aot.read_manifests(clients[aot], job)["podS"]
        m_jax = jaot.read_manifests(clients[jaot], job)["podS"]
        assert m_port == m_jax
        assert m_port["entries"] == {
            n: e["sha"] for n, e in aot.scan_manifest(str(src)).items()}
        dst = tmp_path / "dst"
        stats = pull_pkg.pull_missing(str(dst), client=clients[pull_pkg],
                                      job_id=job, own_pod="podP")
    finally:
        xchg.stop()
        for c in clients.values():
            c.close()
    assert stats == {"pulled": len(entries),
                     "bytes": sum(len(d) for d in entries.values()),
                     "skipped_bad": 0, "peers": 1}
    for name, data in entries.items():
        assert (dst / name).read_bytes() == data


def test_goodput_accounts_a_ladder_lane_closed_between_stages():
    """A hot-restaged worker runs one ladder a stage: its ``aot`` lane is
    open only while a rung runs and closed in between. The port's
    ``goodput_accounted`` counts no second lost there; the JAX package's
    (the same check without the closes) reads the closed gap as one.
    The main lane covers the whole life, so nothing else is lost."""
    from edl_tpu.chaos import invariants as jinv
    from edl_tpu_torch.chaos import invariants as inv

    def tr(ts, state, prev, dur, component=None):
        ev = {"event": "goodput", "ts": ts, "pid": 7, "state": state,
              "prev": prev, "dur": dur}
        if component:
            ev["component"] = component
        return ev

    events = [tr(0.0, "restage", None, 0.0), tr(5.0, "train", "restage", 5.0),
              tr(40.0, None, "train", 35.0),
              # stage 1's rung at 6 s, stage 2's at 30 s
              tr(6.0, "aot_compile", None, 0.0, "aot"),
              tr(6.05, None, "aot_compile", 0.05, "aot"),
              tr(30.0, "aot_compile", None, 0.0, "aot"),
              tr(30.04, None, "aot_compile", 0.04, "aot")]
    assert inv.goodput_accounted(events).ok
    verdict = jinv.goodput_accounted(events)
    assert not verdict.ok and "aot-7" in verdict.detail


@pytest.mark.parametrize("knob", [None, "pulled", "exchange_off", "warm"])
def test_init_pulls_once_before_the_first_load(store, tmp_path, monkeypatch,
                                               knob):
    """``train.init``'s bounded pull (``context._pull_cache_entries``)
    fills the worker's cache dir from a peer's exchange, once per
    process; it stays away after the shell's pull
    (``EDL_CACHE_PULLED=1``), with ``EDL_CACHE_EXCHANGE=0`` and in a
    warm-only shadow stage."""
    from edl_tpu_torch.cluster.job_env import WorkerEnv
    from edl_tpu_torch.train import context

    served = tmp_path / "served"
    served.mkdir()
    (served / "libflash_fwd-0011223344556677.so").write_bytes(b"lib" * 50)
    mine = tmp_path / "mine"
    job = "initpull-%s" % knob
    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EDL_JOB_ID", job)
    monkeypatch.setenv("EDL_POD_ID", "podB")
    monkeypatch.setenv("EDL_STORE_ENDPOINT", store.endpoint)
    monkeypatch.setenv("EDL_COMPILE_CACHE_DIR", str(mine))
    knobs = {"pulled": ("EDL_CACHE_PULLED", "1"),
             "exchange_off": ("EDL_CACHE_EXCHANGE", "0"),
             "warm": ("EDL_WARM_ONLY", "1")}
    if knob:
        monkeypatch.setenv(*knobs[knob])
    monkeypatch.setattr(context, "_cache_pulled", False)
    client = StoreClient(store.endpoint)
    xchg = aot.CacheExchange(str(served), client, job, "podA",
                             host="127.0.0.1").start()
    try:
        assert _wait_until(lambda: "podA" in aot.read_manifests(client, job))
        context._pull_cache_entries(WorkerEnv())
        got = sorted(os.listdir(mine)) if mine.exists() else []
        (served / "libflash_bwd-0011223344556677.so").write_bytes(b"late")
        xchg.refresh(force=True)
        context._pull_cache_entries(WorkerEnv())  # once per process
        again = sorted(os.listdir(mine)) if mine.exists() else []
    finally:
        xchg.stop()
        client.close()
    want = [] if knob else ["libflash_fwd-0011223344556677.so"]
    assert got == want and again == want
