"""The port's convergence-under-churn tools against the JAX package's, on
the CPU.

- ``build_text_corpus`` writes the same bytes as
  ``tools/convergence_churn.build_text_corpus`` (every file of the corpus
  directory, byte for byte).
- The char-LM worker (``edl_tpu_torch/tools/convergence_lm_worker.py``)
  run alone (world 1, a port store child, 2 epochs of a 60 KB cut of
  that corpus) reads the JAX worker's batches exactly: the same
  row -> step files of every epoch, the same ``batch_digest``, and its
  per-epoch digests chain to it. Record order comes from the dispatcher,
  not from the framework.
- The digits data: the port's ``load_digits`` (numpy over the
  repository's copy of scikit-learn 1.9.0's ``digits.csv.gz``) gives
  ``sklearn.datasets.load_digits()``'s ``data`` and ``target`` on all
  1,797 rows, exactly; the digits worker runs alone through
  ``ElasticTrainer`` and writes its ``final.json``.
- Three SGD steps of the digits MLP on the worker's first batches, from
  the JAX model's parameters converted by ``convert.py``: losses and
  parameters within 1e-5 (``max|port - jax| / max(1, max|jax|)``; both
  sides compute in fp32 and differ in summation order only).

Child processes run in sessions of their own and are killed with their
session in ``finally``; every wait has a timeout. The JAX compilation
cache is off in this module.
"""

import hashlib
import importlib.util
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import MLP as JaxMLP
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.tools import convergence_churn as port_churn
from edl_tpu_torch.tools import convergence_worker as port_worker
from edl_tpu_torch.train import step as tstep
from edl_tpu_torch.train.optim import sgd
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 180.0
TOL = 1e-5
LM_BYTES = 60_000  # 624 training rows, 18 steps an epoch at batch 36


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


def _jax_churn():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_churn",
        os.path.join(REPO, "tools", "convergence_churn.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def test_build_text_corpus_is_byte_identical(tmp_path):
    want = _jax_churn().build_text_corpus(str(tmp_path / "jax"))
    got = port_churn.build_text_corpus(str(tmp_path / "port"))
    assert got == want
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(port_files) == ["heldout.txt"] + [
        "part-%02d.txt" % p for p in range(6)]
    assert port_files == jax_files


def _run(cmd, env, timeout=CHILD_TIMEOUT):
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    return proc.returncode, out


def _worker_env(store, out_dir, data_dir, ckpt, epochs):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    # one device a process, as tools/convergence_churn.py gives its pods
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               EDL_STORE_ENDPOINT=store.endpoint, EDL_JOB_ID="convlm-test",
               EDL_CKPT_PATH=str(ckpt), TEST_OUT_DIR=str(out_dir),
               TEST_DATA_DIR=str(data_dir), TEST_EPOCHS=str(epochs))
    os.makedirs(out_dir)
    return env


def test_lm_worker_reads_the_jax_workers_batches(tmp_path):
    data = tmp_path / "data"
    port_churn.build_text_corpus(str(data), max_bytes=LM_BYTES)
    epochs = 2
    for pkg, worker, args in (
            ("jax", os.path.join(REPO, "tools", "convergence_lm_worker.py"),
             []),
            ("port", os.path.join(REPO, "edl_tpu_torch", "tools",
                                  "convergence_lm_worker.py"),
             ["--device", "cpu"])):
        store = ChildStore()
        try:
            env = _worker_env(store, tmp_path / pkg, data,
                              tmp_path / (pkg + "-ckpt"), epochs)
            if pkg == "port":
                env["EDL_COMPILE_CACHE_DIR"] = "none"  # no kernel library
            rc, log = _run([sys.executable, worker, *args], env)
        finally:
            store.stop()
        assert rc == 0, (pkg, log[-6000:])
    jax_files, port_files = _files(tmp_path / "jax"), _files(tmp_path / "port")
    pairs = ["pairs.solo.0.%d" % e for e in range(epochs)]
    for name in pairs:
        assert port_files[name] == jax_files[name], name
        assert len(port_files[name].splitlines()) == 624
    import json

    want = json.loads(jax_files["final.json"])
    got = json.loads(port_files["final.json"])
    assert got["batch_digest"] == want["batch_digest"]
    assert (got["steps"], got["epochs"], got["eval_rows"]) == (
        want["steps"], want["epochs"], want["eval_rows"]) == (36, 2, 600)
    chain = hashlib.sha256(b"".join(
        bytes.fromhex(port_files["digest.solo.%d" % e].decode())
        for e in range(epochs))).hexdigest()
    assert chain == want["batch_digest"]
    assert np.isfinite(got["test_loss"]) and 0 <= got["test_accuracy"] <= 1
    # the CPU path launches no kernel; the report is there all the same
    assert json.loads(port_files["launches.solo.0"]) == {
        "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert json.loads(port_files["inc.solo.0.1"]) == {
        "resume_step": 0, "resume_epoch": 0}


def test_digits_match_sklearn():
    from sklearn.datasets import load_digits

    want = load_digits()
    data, target = port_worker.load_digits()
    assert data.shape == (1797, 64) and target.shape == (1797,)
    assert data.dtype == want.data.dtype and target.dtype == want.target.dtype
    assert np.array_equal(data, want.data)
    assert np.array_equal(target, want.target)


def test_digits_worker_runs_alone(tmp_path):
    out = tmp_path / "out"
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               EDL_CKPT_PATH=str(tmp_path / "ckpt"),
               EDL_COMPILE_CACHE_DIR="none", TEST_OUT_DIR=str(out),
               TEST_EPOCHS="3")
    os.makedirs(out)
    rc, log = _run([sys.executable, os.path.join(
        REPO, "edl_tpu_torch", "tools", "convergence_worker.py"),
        "--device", "cpu"], env)
    assert rc == 0, log[-3000:]
    import json

    with open(out / "final.json") as f:
        final = json.load(f)
    # 3 epochs of 24 global steps; the held-out split's 360 rows
    assert final["steps"] == 72 and final["epochs"] == 3
    assert final["world_at_finish"] == 1
    assert 0.5 < final["test_accuracy"] <= 1.0, final
    assert os.path.exists(out / "inc.solo.0.1")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return float(err / max(1.0, np.abs(want).max()))


def test_three_mlp_steps_match_jax():
    x, y, train_idx, _test = port_worker.dataset()
    rows = list(port_worker.train_records(x, y, train_idx, 0, 0, 1))
    batches = [
        (np.stack([r[0] for r in rows[i * 56:(i + 1) * 56]]),
         np.stack([r[1] for r in rows[i * 56:(i + 1) * 56]]))
        for i in range(3)]
    jmodel = JaxMLP(hidden=(64,), features=10)
    params = jmodel.init(jax.random.PRNGKey(0), batches[0][0])["params"]
    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jstep.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32), apply_fn=jmodel.apply,
        params=params, tx=tx, opt_state=tx.init(params))
    jrun = jstep.make_train_step(jstep.make_cross_entropy_loss(),
                                 donate=False)
    tmodel = port_worker.make_model()
    convert.load_params(tmodel, {"params": params})
    state = tstep.create_state(tmodel, None, sgd(0.1, momentum=0.9),
                               device="cpu")
    trun = tstep.make_train_step(tstep.make_cross_entropy_loss())
    for bx, by in batches:
        jstate, jm = jrun(jstate, (bx, by))
        state, tm = trun(state, (torch.from_numpy(bx),
                                 torch.from_numpy(by).long()))
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= TOL
        assert _rel(float(tm["accuracy"]), float(jm["accuracy"])) <= TOL
        back = convert.to_flax(tmodel.state_dict())
        errs = jax.tree.map(lambda a, b: _rel(a, np.asarray(b)), back,
                            jstate.params)
        assert max(jax.tree.leaves(errs)) <= TOL, errs
