"""The distillation examples of ``edl_tpu_torch`` against the JAX package's
``examples/distill_{teacher,student,nlp}.py`` on the CPU.

- The small ResNet teacher's soft labels (``distill_teacher.make_apply``)
  against the JAX teacher's ``softmax(model.apply(..., train=False))`` for
  the same weights with non-trivial ``batch_stats``, both fp32: 1e-5
  absolute (probabilities; only the order of fp32 sums differs).
- The JAX teacher's own artifact (flax ``serialization.to_bytes`` of
  ``{"params", "batch_stats"}``, written here) loads into the port's
  teacher through ``file://`` without flax and gives the JAX soft labels
  (1e-5); ``python -m edl_tpu_torch.examples.distill_teacher --model_uri
  file://...`` serves the same soft labels as the port model with that
  artifact in this process (1e-6: the same code on the same CPU).
- Two steps of ``distill_student`` (CE + KL, SGD 0.01 momentum 0.9, train
  mode) and of ``distill_nlp``'s student (soft-target KL, AdamW 3e-4)
  against the JAX examples' steps from the same weights and batches:
  losses, metrics, parameters and batch-norm statistics within 1e-4 of
  max(1, |reference|) (fp32 through other kernels and sum orders).
- The whole small jobs on the CPU: the port's store server, its
  discovery server, the teacher and the student as processes, every
  epoch's batches in order, rc 0.
"""

import hashlib
import importlib.util
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from edl_tpu.models import TransformerLM as JaxLM
from edl_tpu.models import resnet as jresnet
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.distill.serving import PredictClient
from edl_tpu_torch.examples import distill_nlp, distill_student, distill_teacher
from edl_tpu_torch.train import step as tstep
from edl_tpu_torch.train.optim import adamw, sgd
from test_torch_replicate import ChildStore
from test_torch_resnet import flax_variables, images
from test_torch_resnet_train import _assert_state_close, _jax_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_SOFT = 1e-5
TOL_SERVED = 1e-6
TOL_STEP = 1e-4
JOB_TIMEOUT = 150.0


def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    path = os.path.join(REPO, "examples", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
def small_teacher():
    """The JAX example's small teacher in fp32, its variables (drawn with
    numpy: non-trivial running averages) and a batch of images."""
    jmodel = jresnet.ResNet(stage_sizes=(1, 1), num_classes=10, width=8,
                            dtype=jnp.float32)
    x = images(6, 32, seed=4)
    return jmodel, flax_variables(jmodel, x, seed=2), x


def _jax_soft(jmodel, v, x):
    logits = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(v, x)
    return np.asarray(jax.nn.softmax(logits, axis=-1))


def _port_soft(model, x):
    model.eval()
    with torch.no_grad():
        out = distill_teacher.make_apply(model)(
            {"image": torch.from_numpy(x)})
    return out["soft_label"].numpy()


def test_small_teacher_soft_labels_match_jax(small_teacher):
    jmodel, v, x = small_teacher
    assert float(np.abs(v["batch_stats"]["BatchNorm_0"]["mean"]).max()) > 0
    model, size = distill_teacher.build_model(True, "cpu",
                                              dtype=torch.float32)
    assert size == 32
    convert.load_params(model, v)
    got, want = _port_soft(model, x), _jax_soft(jmodel, v, x)
    assert got.shape == (6, 10) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= TOL_SOFT
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def _child_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(cmd, log, **extra):
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", *cmd], env=dict(_child_env(), **extra),
            cwd=REPO, stdout=fh, stderr=subprocess.STDOUT,
            start_new_session=True)


def _kill(procs):
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait(timeout=30)


def _read(path):
    with open(path, errors="replace") as fh:
        return fh.read()


def _wait_for(log, pattern, proc, timeout=JOB_TIMEOUT):
    deadline = time.monotonic() + timeout
    while True:
        found = re.search(pattern, _read(log))
        if found:
            return found
        assert proc.poll() is None, _read(log)[-3000:]
        assert time.monotonic() < deadline, _read(log)[-3000:]
        time.sleep(0.05)


def test_flax_artifact_loads_through_model_uri(small_teacher, tmp_path):
    jmodel, v, x = small_teacher
    art = tmp_path / "teacher.msgpack"
    art.write_bytes(serialization.to_bytes(
        {"params": v["params"], "batch_stats": v["batch_stats"]}))
    digest = hashlib.sha256(art.read_bytes()).hexdigest()
    uri = "file://" + str(art)
    model, _ = distill_teacher.build_model(True, "cpu", seed=5,
                                           dtype=torch.float32)
    distill_teacher.load_artifact(model, uri, digest)
    assert float(np.abs(_port_soft(model, x) - _jax_soft(jmodel, v, x))
                 .max()) <= TOL_SOFT
    # the example's own entry point, at its default (bf16) compute
    served_model, _ = distill_teacher.build_model(True, "cpu")
    distill_teacher.load_artifact(served_model, uri)
    want = _port_soft(served_model, x)
    store = ChildStore()
    log = str(tmp_path / "teacher.log")
    proc = _spawn(["edl_tpu_torch.examples.distill_teacher", "--small",
                   "--device", "cpu", "--store", store.endpoint,
                   "--model_uri", uri, "--model_sha256", digest], log)
    try:
        ep = _wait_for(log, r"teacher serving on (\S+)", proc).group(1)
        assert "teacher params loaded from %s" % uri in _read(log)
        client = PredictClient(ep, timeout=60.0)
        try:
            got = client.predict({"image": x})["soft_label"]
        finally:
            client.close()
    finally:
        _kill([proc])
        store.stop()
    assert float(np.abs(got - want).max()) <= TOL_SERVED


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1.0, np.abs(want).max()))


def _soft(rs, shape):
    z = rs.standard_normal(shape).astype(np.float32)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_student_steps_match_jax(small_teacher):
    """Two steps of the image student: the JAX example's ``distill_loss``
    under the JAX step against the port's."""
    jds = _jax_example("distill_student")
    jmodel, v, _ = small_teacher
    tmodel, _ = distill_teacher.build_model(True, "cpu", dtype=torch.float32)
    convert.load_params(tmodel, v)
    jstate = _jax_state(jmodel, v, optax.sgd(0.01, momentum=0.9))
    jrun = jstep.make_train_step(jds.distill_loss, {"train": True},
                                 donate=False)
    state = tstep.create_state(tmodel, None, sgd(0.01, momentum=0.9),
                               device="cpu")
    trun = tstep.make_train_step(distill_student.distill_loss,
                                 {"train": True})
    rs = np.random.RandomState(9)
    for seed in (1, 2):
        x = images(8, 32, seed=seed)
        y = rs.randint(0, 10, 8).astype(np.int32)
        soft = _soft(rs, (8, 10))
        jstate, jm = jrun(jstate, (x, (y, soft)))
        state, tm = trun(state, (torch.from_numpy(x), (
            torch.from_numpy(y), torch.from_numpy(soft))))
        for key in ("loss", "accuracy", "kl"):
            assert _rel(float(tm[key]), float(jm[key])) <= TOL_STEP, key
        _assert_state_close(state.apply_fn, jstate, tol=TOL_STEP)


def _jax_kd_loss(logits, soft):
    """``examples/distill_nlp.py``'s ``kd_loss`` (defined inside its
    ``run_student``): pure soft-target KL."""
    log_p = jax.nn.log_softmax(logits, axis=-1)
    kl = jnp.mean(jnp.sum(soft * (jnp.log(soft + 1e-8) - log_p), axis=-1))
    return kl, {}


def test_nlp_student_steps_match_jax():
    """Two steps of distill_nlp's student (2 layers, d_model 64, 4 heads of
    width 16, fp32, AdamW 3e-4) on the example's token stream and random
    soft labels, from the same weights."""
    cfg = dict(vocab_size=distill_nlp.VOCAB, d_model=64, num_heads=4,
               num_layers=2, d_ff=256)
    jmodel = JaxLM(dtype=jnp.float32, **cfg)
    tokens = [t for (t,) in distill_nlp.batches(2, 4)]
    params = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(1), jnp.asarray(tokens[0]))["params"])
    model = distill_nlp.build_lm(2, 64, device="cpu")
    assert model.layer_0.attn.q.kernel.shape == (64, 4, 16)
    convert.load_params(model, params)
    tx = optax.adamw(3e-4)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32),
                              apply_fn=jmodel.apply, params=jp, tx=tx,
                              opt_state=tx.init(jp))
    jrun = jstep.make_train_step(_jax_kd_loss, donate=False)
    state = tstep.create_state(model, None, adamw(3e-4), device="cpu")
    trun = tstep.make_train_step(distill_nlp.kd_loss)
    rs = np.random.RandomState(4)
    for tok in tokens:
        soft = _soft(rs, tok.shape + (distill_nlp.VOCAB,))
        jstate, jm = jrun(jstate, (jnp.asarray(tok), jnp.asarray(soft)))
        state, tm = trun(state, (torch.from_numpy(tok),
                                 torch.from_numpy(soft)))
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= TOL_STEP
    got = convert.flatten(convert.to_flax(state.apply_fn.state_dict()))
    want = convert.flatten(jax.tree.map(np.asarray, jstate.params))
    assert sorted(got) == sorted(want)
    for path in want:
        assert _rel(got[path], want[path]) <= TOL_STEP, path


@pytest.mark.parametrize("job", ["image", "nlp"])
def test_small_job_runs_on_the_cpu(tmp_path, job):
    """The port's store server and discovery server, one teacher and one
    student, each a process on the CPU: the student ends with rc 0 after
    two epochs of 8 batches, in order (image: the labels it trained on
    are the stream's, through a coalescing teacher; nlp: the kd-loss
    falls), and the teacher stops on SIGTERM with rc 0."""
    store = ChildStore()
    logs = {n: str(tmp_path / ("%s.log" % n))
            for n in ("disc", "teacher", "student")}
    if job == "image":
        disc = ["--job_id", "distill"]
        # two students' worth of requests could share a device call
        teacher = ["edl_tpu_torch.examples.distill_teacher", "--small",
                   "--coalesce_ms", "2"]
        rec = str(tmp_path / "student.npz")
        student = ["edl_tpu_torch.examples.distill_student", "--small",
                   "--batch", "8", "--record", rec]
    else:
        disc = ["--job_id", "distill-nlp", "--services", "nlp-teacher"]
        teacher = ["edl_tpu_torch.examples.distill_nlp", "--role", "teacher"]
        student = ["edl_tpu_torch.examples.distill_nlp", "--role", "student",
                   "--batch", "4"]
    common = ["--store", store.endpoint, "--device", "cpu"]
    procs = []
    try:
        procs.append(_spawn(["edl_tpu_torch.distill.discovery_server",
                             "--store", store.endpoint, *disc],
                            logs["disc"]))
        t = _spawn(teacher + common, logs["teacher"])
        procs.append(t)
        _wait_for(logs["teacher"], r"registered under", t)
        s = _spawn(student + common, logs["student"])
        procs.append(s)
        assert s.wait(timeout=JOB_TIMEOUT) == 0, _read(logs["student"])[-3000:]
        t.send_signal(signal.SIGTERM)
        assert t.wait(timeout=60) == 0, _read(logs["teacher"])[-3000:]
    finally:
        _kill(procs)
        store.stop()
    out = _read(logs["student"])
    summary = json.loads(re.search(r"student summary (\{.*\})", out).group(1))
    assert summary["batches_per_epoch"] == [8, 8]
    if job == "image":
        assert re.search(r"epoch 1 loss \d+\.\d+ acc", out)
        rs = np.random.RandomState(0)
        labels = [label for _, label in distill_student.sample_generator(
            rs, 8 * 8 * 2, 32, 10)()]
        got = np.load(rec)["labels"]
        assert got.shape == (16, 8)
        assert np.array_equal(got.reshape(-1), np.asarray(labels, np.int32))
    else:
        assert re.search(r"epoch 1 kd-loss \d+\.\d+", out)
        assert summary["last_kd_loss"] < summary["first_kd_loss"]
        served = json.loads(re.search(r"teacher summary (\{.*\})",
                                      _read(logs["teacher"])).group(1))
        assert served["requests"] >= 16
