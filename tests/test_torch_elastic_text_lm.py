"""The port's ``elastic_text_lm`` example and ``edl-status`` against the
JAX package's, on the CPU.

- The example: ``python -m edl_tpu_torch.examples.elastic_text_lm
  --device cpu`` and the JAX ``examples/elastic_text_lm.py``, each
  through its own ``main`` in a child process, 2 epochs of one small
  seeded corpus (4 files of 24 lines), the port starting from the JAX
  example's ``PRNGKey(0)`` parameters converted by ``convert.py``. Every
  step's loss agrees within 1e-4 relative (the printed per-epoch losses
  among them) and the data digests are equal.
- ``python -m edl_tpu_torch.cluster.status`` and ``python -m
  edl_tpu.cluster.status`` print the same text and the same JSON for one
  port store (a child process) holding a job's keys, the dispatcher
  section included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 90.0
TOL_LOSS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_compilation_cache():
    """Compile this module's JAX code afresh: another test file in the same
    worker may have armed JAX's persistent compilation cache with a key
    function (``edl_tpu.train.aot.enable_portable_cache_keys``) that this
    JAX version cannot call."""
    import jax
    from jax._src import compilation_cache

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()


_RUN_EXAMPLE = r"""
import json, sys
pkg, out_path, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
losses = []
if pkg == "jax":
    import runpy
    import edl_tpu.train as train
    make = train.make_train_step
else:
    import edl_tpu_torch.train as train
    from edl_tpu_torch.examples import elastic_text_lm
    make = train.make_train_step

def recording(*args, **kwargs):
    inner = make(*args, **kwargs)
    def step(state, batch):
        state, metrics = inner(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return step

train.make_train_step = recording
if pkg == "jax":
    sys.argv = ["elastic_text_lm.py"] + argv
    runpy.run_path("examples/elastic_text_lm.py", run_name="__main__")
else:
    elastic_text_lm.main(argv)
json.dump(losses, open(out_path, "w"))
"""


def _write_corpus(data_dir, files=4, lines=24):
    """A seeded corpus under the JAX example's file names (its
    ``ensure_corpus`` keeps files that exist)."""
    os.makedirs(data_dir)
    rs = np.random.RandomState(3)
    for i in range(files):
        with open(os.path.join(data_dir, "part-%02d.txt" % i), "w") as f:
            for _ in range(lines):
                n = int(rs.randint(20, 90))
                f.write("".join(chr(c) for c in rs.randint(32, 127, n)) + "\n")


def _run_example(pkg, out_json, argv, env):
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_EXAMPLE, pkg, out_json, *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    return proc


def test_example_matches_the_jax_example(tmp_path):
    import jax
    import jax.numpy as jnp

    from edl_tpu.models import TransformerLM as JaxLM
    from edl_tpu_torch import convert
    from edl_tpu_torch.examples import elastic_text_lm

    data_dir = str(tmp_path / "corpus")
    _write_corpus(data_dir)
    # the JAX example's weights: create_state's PRNGKey(0) draw
    model = JaxLM(dtype=jnp.float32, **elastic_text_lm.MODEL)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((8, 64), jnp.int32))
    npz = str(tmp_path / "params.npz")
    convert.save_npz(jax.tree.map(np.asarray, params["params"]), npz)

    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"})
    args = ["--data_dir", data_dir, "--epochs", "2"]
    procs = {
        "jax": _run_example("jax", str(tmp_path / "jax.json"), args, env),
        "port": _run_example("port", str(tmp_path / "port.json"),
                             args + ["--device", "cpu", "--params", npz],
                             env),
    }
    outs = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT)
            assert proc.returncode == 0, (name, stderr[-2000:])
            outs[name] = stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait(timeout=30)
    losses = {n: json.load(open(str(tmp_path / (n + ".json"))))
              for n in procs}
    assert len(losses["port"]) == len(losses["jax"]) == 2 * 12  # 96 records
    for i, (a, b) in enumerate(zip(losses["port"], losses["jax"])):
        assert abs(a - b) <= TOL_LOSS * abs(b), (i, a, b)

    def lines(text, tag):
        return [line for line in text.splitlines() if tag in line]

    assert lines(outs["port"], "data digest") == lines(outs["jax"],
                                                       "data digest")
    epochs = {n: lines(outs[n], "batches, loss") for n in outs}
    assert len(epochs["port"]) == len(epochs["jax"]) == 2
    for p, j in zip(epochs["port"], epochs["jax"]):
        assert p.split(", loss")[0] == j.split(", loss")[0]
        lp, lj = float(p.rsplit(" ", 1)[1]), float(j.rsplit(" ", 1)[1])
        # printed at 4 decimals: within one unit of the last place
        assert abs(lp - lj) <= 1e-4 + TOL_LOSS * abs(lj), (p, j)


def test_status_cli_matches_the_jax_cli(tmp_path):
    from edl_tpu_torch.cluster.model import Cluster, Pod
    from edl_tpu_torch.data import DataDispatcher, DispatcherClient
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.store.client import StoreClient

    srv = ChildStore()
    disp = DataDispatcher(task_timeout=30.0).start()
    try:
        client = StoreClient(srv.endpoint, timeout=5.0)
        reg = Registry(client, "statusjob")
        cluster = Cluster.from_pods(
            [Pod(pod_id="pod-a", rank=0), Pod(pod_id="pod-b", rank=1)],
            stage="stage-1")
        reg.set_permanent("cluster", "current", cluster.to_json())
        reg.set_permanent("job", "status", b"RUNNING")
        reg.set_permanent("drain", "token", b"7")
        reg.register("data/dispatcher", disp.endpoint, b"1", ttl=30.0)
        c = DispatcherClient(disp.endpoint, "w0")
        c.add_dataset(["a.txt", "b.txt", "c.txt"])
        c.get_task()
        c.close()
        env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
        env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                    "JAX_PLATFORMS": "cpu"})
        outs = {}
        for pkg in ("edl_tpu", "edl_tpu_torch"):
            for extra in ([], ["--json"]):
                out = subprocess.run(
                    [sys.executable, "-m", pkg + ".cluster.status", "--store",
                     srv.endpoint, "--job_id", "statusjob", "--dispatcher",
                     disp.endpoint, *extra],
                    capture_output=True, text=True, timeout=60, cwd=REPO,
                    env=env)
                assert out.returncode == 0, out.stderr
                outs[(pkg, bool(extra))] = out.stdout
        client.close()
    finally:
        disp.stop()
        srv.stop()
    assert outs[("edl_tpu_torch", False)] == outs[("edl_tpu", False)]
    assert outs[("edl_tpu_torch", True)] == outs[("edl_tpu", True)]
    blob = json.loads(outs[("edl_tpu_torch", True)])
    assert blob["dispatcher"]["files"] == 3
    assert blob["dispatcher"]["pending"] == 1
    assert "cluster: stage=stage-1 pods=2" in outs[("edl_tpu_torch", False)]
