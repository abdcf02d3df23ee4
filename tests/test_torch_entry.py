"""edl_tpu_torch entry points: the teacher CLI, device policy, import
isolation, and chip_smoke.py's refusal without a card."""

import os
import shutil
import subprocess
import sys
import time

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
    """``--store`` registers the teacher: with no store to register in,
    the teacher raises (and stops its server) instead of serving
    unregistered."""
    from edl_tpu_torch.utils.net import find_free_ports

    dead = "127.0.0.1:%d" % find_free_ports(1)[0]
    with pytest.raises(ConnectionError):
        nlp_teacher.main(["--device", "cpu", "--config", "small",
                          "--store", dead])


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


def test_distill_entry_points_default_to_cuda(monkeypatch):
    """The distillation slice's entry points (the three examples, both
    distill_nlp roles) run on the card unless given ``--device cpu``, and
    raise without one before touching a store."""
    from edl_tpu_torch.examples import (
        distill_nlp,
        distill_student,
        distill_teacher,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = ["--store", "127.0.0.1:1"]
    for call in (lambda: distill_teacher.main(store),
                 lambda: distill_teacher.main(store + ["--small"]),
                 lambda: distill_student.main(store + ["--small"]),
                 lambda: distill_nlp.main(store + ["--role", "teacher"]),
                 lambda: distill_nlp.main(store + ["--role", "student"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_discovery_server_cli_serves_and_stops():
    """``python -m edl_tpu_torch.distill.discovery_server`` on a port
    store: it claims its service (the balancer registers) and exits 0 on
    SIGTERM."""
    import signal as _signal

    from test_torch_replicate import ChildStore

    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.distill.discovery import BALANCER_SERVICE
    from edl_tpu_torch.store.client import StoreClient

    store = ChildStore()
    proc = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.distill.discovery_server",
         "--store", store.endpoint, "--job_id", "cli", "--balancer_id",
         "b0"], env=_env(), cwd=REPO, start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    client = StoreClient(store.endpoint, timeout=5.0)
    try:
        reg = Registry(client, "cli")
        deadline = time.monotonic() + 60
        while not reg.get_service(BALANCER_SERVICE):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        assert [m.name for m in reg.get_service(BALANCER_SERVICE)] == ["b0"]
        proc.send_signal(_signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not reg.get_service(BALANCER_SERVICE)
    finally:
        client.close()
        if proc.poll() is None:
            os.killpg(proc.pid, _signal.SIGKILL)
            proc.wait(timeout=30)
        store.stop()


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


def test_lm_parallel_entry_points_default_to_cuda(monkeypatch):
    """The tensor/sequence-parallel and decode slice's entry points (the
    two LM examples, the decode bench, the gloo probe) run on the card
    unless given ``--device cpu``, and raise without one."""
    from edl_tpu_torch.examples import lm_generate, lm_long_context
    from edl_tpu_torch.tools import decode_bench, gloo_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lm_generate.main([]),
                 lambda: lm_long_context.main([]),
                 lambda: decode_bench.main([]),
                 lambda: gloo_probe.probe()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# the data plane and the goodput autoscaler: each module on its own
NEW_PLANE_MODULES = (
    "edl_tpu_torch.data.dataset", "edl_tpu_torch.data.checkpoint",
    "edl_tpu_torch.data.dispatcher", "edl_tpu_torch.data.loader",
    "edl_tpu_torch.examples.elastic_text_lm",
    "edl_tpu_torch.cluster.status", "edl_tpu_torch.obs.monitor",
    "edl_tpu_torch.tools.edl_monitord", "edl_tpu_torch.scale.decide",
    "edl_tpu_torch.scale.arbiter", "edl_tpu_torch.scale.scaler",
    "edl_tpu_torch.tools.edl_scaled",
    # the chaos scenario runner and what it archives and drives
    "edl_tpu_torch.chaos.scenario", "edl_tpu_torch.chaos.consistency",
    "edl_tpu_torch.harness", "edl_tpu_torch.harness.resize",
    "edl_tpu_torch.obs.archive", "edl_tpu_torch.distill.slo",
    "edl_tpu_torch.tools.chaos_run", "edl_tpu_torch.tools.serve_slo",
    # the read side of the port's runs: register, merge, the sentinel,
    # the CLIs, the suite runner and fit_a_line
    "edl_tpu_torch.discovery.register", "edl_tpu_torch.obs.merge",
    "edl_tpu_torch.obs.regress", "edl_tpu_torch.tools.edl_trace",
    "edl_tpu_torch.tools.edl_timeline", "edl_tpu_torch.tools.edl_report",
    "edl_tpu_torch.tools.edl_top", "edl_tpu_torch.tools.edl_profile",
    "edl_tpu_torch.tools.run_suite", "edl_tpu_torch.examples.fit_a_line",
)

_IMPORT_ONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "edl_tpu",
                                    "msgpack", "psutil"))
print("LEAKED", bad)
"""


@pytest.mark.parametrize("module", NEW_PLANE_MODULES)
def test_plane_module_imports_nothing_of_jax(module):
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ONE, module],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


def test_elastic_text_lm_defaults_to_cuda(monkeypatch):
    """The data plane's example runs on the card unless given
    ``--device cpu``, and raises without one before it joins a job."""
    from edl_tpu_torch.examples import elastic_text_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        elastic_text_lm.main([])


def _chaos_run(*args):
    return subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.tools.chaos_run", *args],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)


def test_chaos_run_list_and_unknown_match_the_jax_tool():
    """``--list`` names the JAX tool's scenarios with the same first doc
    lines; an unknown name exits non-zero naming every scenario, as
    ``tools/chaos_run.py`` does."""
    env = dict(_env(), JAX_PLATFORMS="cpu")
    jax_list = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "chaos_run.py"),
         "--list"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120)
    port_list = _chaos_run("--list")
    assert port_list.returncode == jax_list.returncode == 0
    assert port_list.stdout == jax_list.stdout
    assert len(port_list.stdout.splitlines()) == 17
    unknown = _chaos_run("--scenario", "no-such-drill", "--device", "cpu")
    assert unknown.returncode != 0
    assert "unknown scenario 'no-such-drill'" in unknown.stderr
    assert "worker-kill" in unknown.stderr and not unknown.stdout


def test_chaos_run_defaults_to_the_card(monkeypatch, tmp_path):
    """Without ``--device`` the rig's trainee trains on ``cuda``; the
    port's rig hands the device to its pods and sets no JAX knob."""
    from edl_tpu_torch.chaos import scenario
    from edl_tpu_torch.tools import chaos_run

    seen = []

    def fake(name, seed, workdir, archive_to="auto", device="cuda"):
        seen.append(device)
        return scenario.ScenarioOutcome(name, seed, True, [], {})

    monkeypatch.setattr(chaos_run, "run_scenario", fake)
    monkeypatch.setenv("EDL_RUN_ARCHIVE", "0")
    assert chaos_run.main(["--scenario", "worker-kill",
                           "--workdir", str(tmp_path)]) == 0
    assert chaos_run.main(["--scenario", "worker-kill", "--device", "cpu",
                           "--workdir", str(tmp_path)]) == 0
    assert seen == ["cuda", "cpu"]
    rig = scenario.Rig.__new__(scenario.Rig)
    rig.chaos_log = rig.ckpt_dir = rig.flight_dir = rig.trace_dir = "x"
    rig.seed, rig.store_endpoints, rig.job_id = 0, "h:1", "j"
    rig.workdir, rig.standby = str(tmp_path), None
    for device, cache in (("cuda", None), ("cpu", "none")):
        rig.device = device
        harness = rig.harness(None)
        assert harness.extra_env["EDL_CHAOS_DEVICE"] == device
        assert harness.extra_env.get("EDL_COMPILE_CACHE_DIR") == cache
        assert harness.device == device
        assert not any(k.startswith("JAX") for k in harness.extra_env)


# the read side's CLIs: each answers --help naming its flags
READ_SIDE_CLIS = {
    "edl_tpu_torch.discovery.register": ("--teacher", "--wait_alive"),
    "edl_tpu_torch.obs.merge": ("--dir", "--no-rebase"),
    "edl_tpu_torch.tools.edl_trace": ("--op", "--goodput"),
    "edl_tpu_torch.tools.edl_timeline": ("--max-events", "--output"),
    "edl_tpu_torch.tools.edl_report": ("--check", "--import-legacy"),
    "edl_tpu_torch.tools.edl_top": ("--once", "--json"),
    "edl_tpu_torch.tools.edl_profile": ("--request", "--local", "--device"),
    "edl_tpu_torch.tools.run_suite": ("--round", "--skip", "--probe_budget"),
    "edl_tpu_torch.examples.fit_a_line": ("--epochs", "--device",
                                          "--params"),
}


@pytest.mark.parametrize("module", sorted(READ_SIDE_CLIS))
def test_read_side_cli_help(module):
    out = subprocess.run(
        [sys.executable, "-m", module, "--help"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in READ_SIDE_CLIS[module]:
        assert flag in out.stdout, (module, flag)


def test_read_side_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """``edl_profile --local`` and ``fit_a_line`` run on the card unless
    given ``--device cpu``, and raise without one; the suite runner
    measures nothing without a card."""
    from edl_tpu_torch.examples import fit_a_line
    from edl_tpu_torch.tools import edl_profile, run_suite

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("EDL_CKPT_PATH", str(tmp_path / "ckpt"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edl_profile.main(["--local", "--steps", "1", "--out",
                          str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_a_line.main(["--epochs", "1"])
    assert fit_a_line.parse_args([]).device == "cuda"
    monkeypatch.setattr(run_suite, "probe", lambda budget: None)
    assert run_suite.main(["--results", str(tmp_path / "r")]) == 1
    assert not os.path.exists(tmp_path / "r")
