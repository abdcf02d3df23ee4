"""edl_tpu_torch entry points: the teacher CLI, device policy, import
isolation, and chip_smoke.py's refusal without a card."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from edl_tpu_torch.distill import nlp_teacher
from edl_tpu_torch.distill.serving import PredictClient, TorchPredictBackend
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.tools import lm_bench
from edl_tpu_torch.train import adamw, create_state
from edl_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_nlp_teacher_cli_answers_a_predict():
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.distill.nlp_teacher",
         "--config", "small", "--device", "cpu", "--port", "0",
         "--seed", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("nlp teacher serving on "), (
            line + proc.stderr.read() if proc.poll() is not None else line
        )
        port = int(line.strip().rsplit(":", 1)[1])
        client = PredictClient("127.0.0.1:%d" % port, timeout=60.0)
        tokens = np.random.RandomState(0).randint(0, 1024, (3, 64))
        try:
            out = client.predict({"tokens": tokens.astype(np.int32)})
        finally:
            client.close()
        soft = out["soft_label"]
        assert soft.shape == (3, 64, 1024) and soft.dtype == np.float32
        np.testing.assert_allclose(soft.sum(-1), 1.0, atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode == 0


def test_nlp_teacher_refuses_store_registration():
    with pytest.raises(SystemExit):
        nlp_teacher.main(["--device", "cpu", "--store", "127.0.0.1:2379"])


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nlp_teacher.build_teacher("small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchPredictBackend(lambda feeds: feeds)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nlp_teacher.main(["--config", "small"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_bench.main([])
    model = TransformerLM(vocab_size=64, d_model=32, num_heads=2,
                          num_layers=1, d_ff=64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_state(model, 0, adamw(1e-3))


def test_small_config_is_distill_nlp_teacher():
    model = nlp_teacher.build_teacher("small", device="cpu", seed=0)
    assert nlp_teacher.CONFIGS["small"]["seq"] == 64
    assert model.embed.embedding.shape == (1024, 128)
    assert model.num_layers == 4
    assert model.layer_0.attn.q.kernel.shape == (128, 4, 32)
    assert model.layer_0.mlp.gate.kernel.shape == (128, 512)
    assert model.lm_head.kernel.dtype == torch.float32
    flag = nlp_teacher.CONFIGS["flagship"]["model"]
    assert flag["d_ff"] == int(1024 * 8 / 3 / 128) * 128
    assert flag["dtype"] == torch.bfloat16


_IMPORT_ALL = r"""
import importlib, pkgutil, runpy, sys
import edl_tpu_torch
for mod in pkgutil.walk_packages(edl_tpu_torch.__path__, "edl_tpu_torch."):
    importlib.import_module(mod.name)
runpy.run_path(sys.argv[1], run_name="chip_smoke_imported")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "edl_tpu",
                                    "msgpack", "psutil"))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_nothing_of_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL,
         os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LEAKED []" in out.stdout


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_resnet_entry_points_default_to_cuda(monkeypatch):
    """The slice's entry points (the driver entry, the headline bench's
    measurement, the flagship example, the trainer's state) run on the
    card unless told otherwise, and raise without one."""
    from edl_tpu_torch import entry
    from edl_tpu_torch.examples import resnet_collective
    from edl_tpu_torch.models.resnet import ResNet
    from edl_tpu_torch.tools import bench
    from edl_tpu_torch.train import sgd

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (entry.entry, bench.measure,
                 lambda: resnet_collective.main([]),
                 lambda: create_state(ResNet((1, 1), width=8), 0, sgd(0.1))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_resnet_entry_forward_on_cpu():
    """``entry(device="cpu")``: ResNet50_vd's eval forward over its
    parameters and buffers at [8, 64, 64, 3]: finite fp32 logits, the
    same as the module's own eval forward."""
    from edl_tpu_torch import entry

    forward, (params, buffers, x) = entry.entry(device="cpu")
    assert x.shape == (8, 64, 64, 3)
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (8, 64, 64, 3)).astype(np.float32))
    logits = forward(params, buffers, x)
    assert logits.shape == (8, 1000) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    assert len(buffers) == 2 * 55  # mean and var of each of the 55 BNs
