"""The port's ``fit_a_line`` example
(``python -m edl_tpu_torch.examples.fit_a_line``) against the JAX
package's ``examples/fit_a_line.py``, on the CPU, in fp32.

Each example runs through its own ``main`` in a child process (a session
of its own) with the trainers' ``make_train_step`` wrapped to record
every step's loss. The JAX example runs first and also records the
parameters its trainer starts from; the port's starts from those,
converted (``--params``). Both read the same seeded record stream
(``RandomState(1000 * (epoch + 1) + rank)``), so every step's loss
agrees within 1e-5 relative. Without ``--device cpu`` the port's
example wants a card.
"""

import json
import os
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 180.0
TOL_LOSS = 1e-5
EPOCHS = 3
STEPS_PER_EPOCH = 1024 // 128

_RUN_EXAMPLE = r"""
import json, sys
import numpy as np
pkg, out_path, params_path, argv = (sys.argv[1], sys.argv[2], sys.argv[3],
                                    sys.argv[4:])
losses = []
if pkg == "jax":
    import jax
    import edl_tpu.train.loop as loop
else:
    import edl_tpu_torch.train.loop as loop
make = loop.make_train_step

def recording(*args, **kwargs):
    inner = make(*args, **kwargs)
    def step(state, batch):
        if pkg == "jax" and not losses:
            from edl_tpu_torch import convert
            convert.save_npz(jax.tree.map(np.asarray, state.params),
                             params_path)
        state, metrics = inner(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics
    return step

loop.make_train_step = recording
if pkg == "jax":
    import runpy
    sys.argv = ["fit_a_line.py"] + argv
    runpy.run_path("examples/fit_a_line.py", run_name="__main__")
else:
    from edl_tpu_torch.examples import fit_a_line
    fit_a_line.main(argv + ["--params", params_path])
json.dump(losses, open(out_path, "w"))
"""


def _run(pkg, tmp_path, argv):
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env.update({"PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
                "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2",
                "JAX_ENABLE_COMPILATION_CACHE": "false",
                "EDL_CKPT_PATH": str(tmp_path / ("ckpt-" + pkg))})
    proc = subprocess.Popen(
        [sys.executable, "-c", _RUN_EXAMPLE, pkg,
         str(tmp_path / (pkg + ".json")), str(tmp_path / "params.npz"),
         *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT)
    finally:
        assert proc.pid not in (os.getpid(), os.getpgrp())
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait(timeout=30)
    assert proc.returncode == 0, (pkg, stderr[-3000:])
    with open(tmp_path / (pkg + ".json")) as f:
        return json.load(f), stdout + stderr


def test_example_matches_the_jax_example(tmp_path):
    argv = ["--epochs", str(EPOCHS)]
    want, _ = _run("jax", tmp_path, argv)
    got, out = _run("port", tmp_path, argv + ["--device", "cpu"])
    assert len(got) == len(want) == EPOCHS * STEPS_PER_EPOCH
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= TOL_LOSS * abs(b), (i, a, b)
    assert got[-1] < got[0]
    assert "done at step %d" % (EPOCHS * STEPS_PER_EPOCH) in out


def test_example_resumes_and_wants_a_card(tmp_path, monkeypatch):
    """A second run over the same checkpoint dir trains only the epochs
    after the last saved one; the default device is the card."""
    from edl_tpu_torch.examples import fit_a_line

    for key in list(os.environ):
        if key.startswith("EDL_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EDL_CKPT_PATH", str(tmp_path / "ckpt"))
    first = fit_a_line.main(["--epochs", "2", "--device", "cpu"])
    assert sorted(first) == [0, 1] and first[1] < first[0]
    again = fit_a_line.main(["--epochs", "3", "--device", "cpu"])
    assert sorted(again) == [2]
    assert fit_a_line.parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_a_line.main(["--epochs", "4"])
