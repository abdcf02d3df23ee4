"""The port's distillation cost benches against the JAX package's, on the
CPU.

- ``python -m edl_tpu_torch.tools.distill_qps`` and
  ``tools/distill_qps.py``, one small run each with the same arguments:
  the port's record has the JAX tool's keys and the same batch count.
- ``python -m edl_tpu_torch.tools.distill_retention --device cpu`` with
  ``--backend echo`` and ``--backend torch`` against the JAX tool with
  ``echo`` and ``jax`` (small: 4 batches of 16, one timed epoch, one
  teacher of two stopped mid-run): the port's record has every key of
  the JAX tool's, the ratio is positive and every timed epoch of the
  distill run yielded every batch once, in order (``epochs_exact``).
- ``colocated_distill``: the JAX tool's cpu-debug pair (a two-stage
  ResNet-vd student at width 8, a two-stage ResNeXt 4x4d teacher, 100
  classes) in fp32 from the same numpy variables (converted by
  ``convert.py``) and one batch of 4 at 24x24: the port's co-located
  step (the frozen teacher's forward, then the KD train step) against
  the JAX ``coloc`` step. The KD loss, its KL term and the student's
  parameters and running averages after the step agree within 1e-4
  (``max|port - jax| / max(1, max|jax|)``: fp32 on both sides, summation
  order only). The port's CLI record has every key of the JAX tool's
  (read from the JAX tool's source).

Child processes run in sessions of their own and are killed with their
session in ``finally``; every wait has a timeout. The JAX compilation
cache is off in this module.
"""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.models import resnet as jresnet
from edl_tpu.train import step as jstep
from edl_tpu_torch import convert
from edl_tpu_torch.tools import colocated_distill as tcoloc
from edl_tpu_torch.train import step as tstep
from edl_tpu_torch.train.optim import sgd
from test_torch_resnet import flax_variables, images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240.0
TOL = 1e-4
SMALL = ["--units", "4", "--batch", "16", "--epochs", "1"]


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


def _record(cmd):
    """The last JSON line a tool's child process prints."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=CHILD_TIMEOUT)
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, err[-3000:]
    return json.loads([line for line in out.splitlines()
                       if line.startswith("{")][-1])


def _port(tool, *args):
    return _record([sys.executable, "-m", "edl_tpu_torch.tools." + tool,
                    *args])


def _jax(tool, *args):
    return _record([sys.executable, os.path.join(REPO, "tools",
                                                 tool + ".py"), *args])


def test_distill_qps_has_the_jax_keys():
    args = ["--batches", "12", "--batch_size", "8", "--sample_shape",
            "3,16,16", "--teachers", "2"]
    want, got = _jax("distill_qps", *args), _port("distill_qps", *args)
    assert set(got) == set(want)
    assert got["metric"] == want["metric"] == "distill_reader_qps"
    assert got["batches"] == want["batches"] == 12
    assert got["bytes_per_sample"] == want["bytes_per_sample"]
    assert got["steps_per_s"] > 0


@pytest.mark.parametrize("port_backend,jax_backend",
                         [("echo", "echo"), ("torch", "jax")],
                         ids=["echo", "torch"])
def test_distill_retention_has_the_jax_keys(port_backend, jax_backend):
    want = _jax("distill_retention", "--backend", jax_backend, *SMALL)
    got = _port("distill_retention", "--device", "cpu", "--backend",
                port_backend, *SMALL)
    assert set(want) <= set(got), set(want) - set(got)
    assert got["metric"] == want["metric"] == "distill_retention"
    assert got["backend"] == port_backend and got["platform"] == "cpu"
    assert got["teacher_killed"] is True and got["epochs_exact"] is True
    assert got["value"] > 0 and got["pure_sps"] > 0 and got["distill_sps"] > 0
    # the reference's published ratio; the port rounds after dividing
    assert abs(got["vs_baseline"] - got["value"] / (1514.0 / 1828.0)) <= 2e-3
    assert ("teacher_sps" in got) == (port_backend == "torch")


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    return float(err / max(1.0, np.abs(want).max()))


def test_colocated_step_matches_jax():
    classes = 100
    jstudent = jresnet.ResNet(stage_sizes=(1, 1), num_classes=classes,
                              width=8, dtype=jnp.float32)
    jteacher = jresnet.ResNeXt(stage_sizes=(1, 1), cardinality=4,
                               base_width=4, num_classes=classes,
                               dtype=jnp.float32)
    x = images(4, 24, 5)
    y = np.random.RandomState(6).randint(0, classes, 4).astype(np.int32)
    sv = flax_variables(jstudent, x, seed=0)
    tv = flax_variables(jteacher, x, seed=1)

    tx = optax.sgd(0.1, momentum=0.9)
    params = jax.tree.map(jnp.asarray, sv["params"])
    jstate = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), apply_fn=jstudent.apply,
        params=params, tx=tx, opt_state=tx.init(params),
        batch_stats=jax.tree.map(jnp.asarray, sv["batch_stats"]))
    kd_step = jstep.make_train_step(jstep.make_kd_loss(0.5, 1.0),
                                    {"train": True}, donate=False)
    t_logits = jteacher.apply(tv, x, train=False)
    jstate, jm = kd_step(jstate, (x, (y, t_logits)))

    student, teacher, got_classes = tcoloc.build_models(
        False, dtype=torch.float32)
    assert got_classes == classes
    convert.load_params(student, sv)
    convert.load_params(teacher, tv)
    teacher.eval().requires_grad_(False)
    state = tstep.create_state(student, None, sgd(0.1, momentum=0.9),
                               device="cpu")
    step = tcoloc.make_coloc_step(teacher, 0.5, 1.0)
    state, tm = step(state, (torch.from_numpy(x),
                             torch.from_numpy(y).long()))
    for key in ("loss", "kd_kl", "hard_ce"):
        assert _rel(float(tm[key]), float(jm[key])) <= TOL, key
    back = convert.to_flax(state.apply_fn.state_dict())
    want = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    errs = jax.tree.map(lambda a, b: _rel(a, np.asarray(b)), back, want)
    assert max(jax.tree.leaves(errs)) <= TOL, errs
    # the frozen teacher is untouched: no gradient, the same averages
    assert all(p.grad is None for p in teacher.parameters())
    tback = convert.to_flax(teacher.state_dict())
    assert max(jax.tree.leaves(jax.tree.map(
        lambda a, b: _rel(a, np.asarray(b)), tback, tv))) == 0.0


def _jax_record_keys(tool: str, name: str = "out") -> set:
    """The keys of the dict literal the JAX tool assigns to ``name`` and
    prints (read from its source: compiling its step takes a minute)."""
    import ast

    with open(os.path.join(REPO, "tools", tool + ".py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == name
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no %s = {...} in tools/%s.py" % (name, tool))


def test_colocated_cli_has_the_jax_keys():
    want = _jax_record_keys("colocated_distill")
    got = _port("colocated_distill", "--device", "cpu")
    assert len(want) > 10 and want <= set(got), want - set(got)
    assert got["metric"] == "colocated_distill_retention_cpu_debug"
    assert (got["batch"], got["steps"]) == (4, 2)
    assert got["value"] > 0 and np.isfinite(got["loss"])
