"""The port's register CLI (``python -m edl_tpu_torch.discovery.register``)
against the JAX package's (``python -m edl_tpu.discovery.register``).

``tests/test_cli.py``'s three register cases, each run through both
CLIs against one port store (a child process of its own session):
register and deregister on SIGTERM, a dead endpoint exits 1 having
registered nothing, and ``--teacher`` registers under the
``distill/teachers/`` namespace. The cross case: the port CLI registers
a teacher and the JAX package's ``Registry`` and ``DiscoveryClient``
(with the port's discovery server balancing) see it.
"""

import os
import signal
import subprocess
import sys
import time

import pytest

from edl_tpu.discovery.registry import Registry as JaxRegistry
from edl_tpu.distill.discovery import DiscoveryClient as JaxDiscoveryClient
from edl_tpu_torch.discovery.registry import Registry
from edl_tpu_torch.distill.discovery import TEACHER_SERVICE
from edl_tpu_torch.store.client import StoreClient
from test_torch_replicate import ChildStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("edl_tpu.discovery.register", "edl_tpu_torch.discovery.register")


@pytest.fixture(scope="module")
def store():
    srv = ChildStore()
    try:
        yield srv
    finally:
        srv.stop()


class Spawned:
    """``python -m module args`` in a session of its own, killed as a
    group in :meth:`stop`."""

    def __init__(self, module, *args):
        env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args], env=env, cwd=REPO,
            start_new_session=True)

    def terminate(self, timeout=20):
        self.proc.terminate()
        return self.proc.wait(timeout=timeout)

    def stop(self):
        assert self.proc.pid not in (os.getpid(), os.getpgrp())
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=10)


def _wait_for(cond, timeout=30.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        result = cond()
        if result:
            return result
        time.sleep(0.2)
    raise AssertionError("timed out waiting for %s" % msg)


@pytest.mark.parametrize("cli", CLIS)
def test_register_cli_registers_and_deregisters(store, cli):
    job = "j-" + cli.split(".")[0]
    proc = Spawned(cli, "--store", store.endpoint, "--job_id", job,
                   "--service", "svc",
                   "--endpoint", store.endpoint)  # the store's port is alive
    client = StoreClient(store.endpoint)
    registry = Registry(client, job)
    try:
        servers = _wait_for(lambda: registry.get_service("svc"),
                            msg="registration")
        assert [s.name for s in servers] == [store.endpoint]
        assert servers[0].value == b"1"
        assert proc.terminate() == 0
        _wait_for(lambda: not registry.get_service("svc"),
                  msg="deregistration")
    finally:
        proc.stop()
        client.close()


@pytest.mark.parametrize("cli", CLIS)
def test_register_cli_dead_endpoint_exits_nonzero(store, cli):
    """--wait_alive expiring on a dead endpoint exits 1 without
    registering anything."""
    job = "dead-" + cli.split(".")[0]
    proc = Spawned(cli, "--store", store.endpoint, "--job_id", job,
                   "--service", "svc",
                   "--endpoint", "127.0.0.1:1",  # reserved: nothing listens
                   "--wait_alive", "1.0")
    try:
        assert proc.proc.wait(timeout=60) == 1
    finally:
        proc.stop()
    client = StoreClient(store.endpoint)
    try:
        assert not Registry(client, job).get_service("svc")
    finally:
        client.close()


@pytest.mark.parametrize("cli", CLIS)
def test_register_cli_teacher_namespace(store, cli):
    job = "distill-" + cli.split(".")[0]
    proc = Spawned(cli, "--store", store.endpoint, "--job_id", job,
                   "--service", "teacher", "--teacher",
                   "--endpoint", store.endpoint)
    client = StoreClient(store.endpoint)
    registry = Registry(client, job)
    try:
        servers = _wait_for(
            lambda: registry.get_service(TEACHER_SERVICE % "teacher"),
            msg="teacher registration")
        assert [s.name for s in servers] == [store.endpoint]
        assert not registry.get_service("teacher")
    finally:
        proc.stop()
        client.close()


def test_port_cli_teacher_seen_by_jax_discovery(store):
    """The port CLI registers a teacher; the JAX package's registry reads
    the same key and value, and a JAX ``DiscoveryClient`` gets it
    assigned by the port's balancer."""
    from edl_tpu.store import StoreClient as JaxStoreClient

    job = "distill-cross"
    balancer = Spawned("edl_tpu_torch.distill.discovery_server",
                       "--store", store.endpoint, "--job_id", job,
                       "--services", "teacher")
    teacher = Spawned("edl_tpu_torch.discovery.register",
                      "--store", store.endpoint, "--job_id", job,
                      "--service", "teacher", "--teacher",
                      "--endpoint", store.endpoint)
    jclient = JaxStoreClient(store.endpoint)
    student = JaxDiscoveryClient(store.endpoint, job, "teacher",
                                 client_id="student-cross")
    try:
        servers = _wait_for(
            lambda: JaxRegistry(jclient, job).get_service(
                TEACHER_SERVICE % "teacher"), msg="teacher registration")
        assert [(s.name, s.value) for s in servers] == [
            (store.endpoint, b"1")]
        assert student.wait_servers(timeout=30.0) == [store.endpoint]
    finally:
        student.stop()
        jclient.close()
        for p in (teacher, balancer):
            p.stop()
