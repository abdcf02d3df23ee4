"""Parity: the port's elastic data plane (``edl_tpu_torch/data``: the
splitters, ``DataCheckpoint``, ``DataDispatcher`` with its client, the
loader) against the JAX package's (``edl_tpu/data``), on the CPU.

- The splitter's records and ``DataCheckpoint`` dicts of both packages
  are equal for one seeded corpus and one seeded progress history.
- Every client/server pairing (JAX and port clients on JAX and port
  dispatchers) runs one scripted epoch: add, get, report, a timeout
  requeue at the reported offset with the late ack refused,
  ``failure_max`` dropping a task, a drain, the epoch's end,
  ``progress``, ``new_epoch`` and ``set_progress``. The four runs return
  the same responses, and every frame on the wire (requests and
  responses, as ``pack_frame`` wrote them) is byte-identical.
- A registry snapshot written by one package's dispatcher into a port
  store (through its own package's client) is recovered by the other's:
  done survives, the in-flight task is back in todo, the reported cursor
  is kept.
- The JAX ``tests/test_data.py`` dataset, checkpoint, dispatcher and
  loader cases, run on the port's copies as written
  (``torch_jax_tables``), their stores children of their own sessions.
  (Its prefetch cases are the JAX feed's; the port's ``prefetch`` has
  its own tests.)
"""

import json
import time

import numpy as np
import pytest

import torch_jax_tables
from test_torch_replicate import ChildStore

from edl_tpu.data import checkpoint as jckpt
from edl_tpu.data import dataset as jds
from edl_tpu.data import dispatcher as jdisp
from edl_tpu_torch.data import checkpoint as tckpt
from edl_tpu_torch.data import dataset as tds
from edl_tpu_torch.data import dispatcher as tdisp

JAX_TABLES = torch_jax_tables.load("test_data")
CASES = torch_jax_tables.cases(JAX_TABLES, classes=(
    "TestDataset", "TestDataCheckpoint", "TestDispatcher",
    "TestElasticLoader"))
data_files = JAX_TABLES.data_files  # the JAX module's fixture
PKGS = {"jax": jdisp, "port": tdisp}


class _ChildStoreServer:
    """``StoreServer(port=0).start()`` for the JAX cases: a port store in
    a child process of its own session."""

    def __init__(self, port=0, **_kw):
        self._srv = None

    def start(self):
        self._srv = ChildStore()
        self.endpoint = self._srv.endpoint
        return self

    def stop(self):
        self._srv.stop()


JAX_TABLES.StoreServer = _ChildStoreServer


@pytest.mark.parametrize("case", CASES)
def test_jax_data_case_on_the_port(case, request):
    torch_jax_tables.run(JAX_TABLES, case, request)


def _corpus(tmp_path, files=3, lines=17):
    rs = np.random.RandomState(5)
    paths = []
    for i in range(files):
        p = tmp_path / ("part-%02d.txt" % i)
        words = ["".join(chr(97 + c) for c in rs.randint(0, 26, rs.randint(
            1, 12))) for _ in range(lines)]
        p.write_bytes(b"".join(w.encode() + (b"\r\n" if j % 3 else b"\n")
                               for j, w in enumerate(words)))
        paths.append(str(p))
    return paths


def test_splitters_and_datasets_yield_equal_records(tmp_path):
    paths = _corpus(tmp_path)
    list_path = tmp_path / "files.txt"
    list_path.write_text("\n".join(paths) + "\n\n")
    for path in paths:
        want = list(jds.TxtFileSplitter().split(path))
        assert list(tds.TxtFileSplitter().split(path)) == want
        assert tds.TxtFileSplitter().count(path) == len(want)
    jd = jds.FileListDataset.from_file_list(str(list_path),
                                            jds.TxtFileSplitter())
    td = tds.FileListDataset.from_file_list(str(list_path),
                                            tds.TxtFileSplitter())
    assert td.files == jd.files and len(td) == len(jd) == len(paths)
    for i in range(len(paths)):
        assert list(td.read_file(i, 5)) == list(jd.read_file(i, 5))


def test_data_checkpoints_equal_along_one_history():
    rs = np.random.RandomState(11)
    j, t = jckpt.DataCheckpoint(), tckpt.DataCheckpoint()
    for _ in range(200):
        op = rs.randint(0, 4)
        f = int(rs.randint(0, 6))
        if op == 0:
            n = int(rs.randint(0, 100))
            j.record_progress(f, n), t.record_progress(f, n)
        elif op == 1:
            j.file_done(f), t.file_done(f)
        elif op == 2 and rs.rand() < 0.1:
            j.next_epoch(), t.next_epoch()
        assert t.to_dict() == j.to_dict()
        assert t.to_json() == j.to_json()
        assert t.start_offset(f) == j.start_offset(f)
        assert t.is_file_done(f) == j.is_file_done(f)
    # each reads the other's serialised form
    assert tckpt.DataCheckpoint.from_json(j.to_json()).to_dict() == j.to_dict()
    assert jckpt.DataCheckpoint.from_dict(t.to_dict()).to_dict() == t.to_dict()


def _scripted(client_mod, endpoint, files):
    """One scripted epoch against a dispatcher started with
    ``task_timeout=0.3, failure_max=2``; returns every response. Task 0
    is reported at record 7 and left to time out (its late ack refused),
    task 1's ack sends task 2 to a second worker, which reports record 4
    and drains; task 2 then fails every time it is handed out; every other task is reported and acked."""
    out = []
    w0 = client_mod.DispatcherClient(endpoint, "w0")
    w1 = client_mod.DispatcherClient(endpoint, "w1")
    try:
        out.append(w0.add_dataset(files))
        out.append(w0.state())
        timed_out = drained = False
        while True:
            resp = w0.get_task()
            out.append(resp)
            if resp.get("epoch_done"):
                break
            if resp.get("wait"):
                time.sleep(0.05)
                continue
            tid = resp["task"]["id"]
            if tid == 0 and not timed_out:
                timed_out = True
                out.append(w0.report(tid, 7))
                time.sleep(1.0)  # the deadline expires: requeued at 7
                out.append(w0.task_done(tid))  # the late ack is refused
            elif tid == 2:
                out.append(w0.task_failed(tid))
            elif tid == 1 and not drained:
                drained = True
                out.append(w0.task_done(tid))
                got = w1.get_task()  # task 2, its first hand-out
                out.append(got)
                out.append(w1.report(got["task"]["id"], 4))
                out.append(w1.drain_worker())  # handed back at once
            else:
                out.append(w0.report(tid, 2))
                out.append(w0.task_done(tid))
        out.append(w0.state())
        out.append(w0.progress())
        out.append(w0.new_epoch(1))
        out.append(w0.set_progress(1, {0: 5, 2: 3}, [1]))
        out.append(w0.progress())
        out.append(w0.state())
        out.append(w1.get_task())
    finally:
        w0.close()
        w1.close()
    return out


def test_every_pairing_runs_one_script_with_identical_frames(
        tmp_path, monkeypatch):
    files = _corpus(tmp_path, files=4)
    runs = {}
    for server in ("jax", "port"):
        for client in ("jax", "port"):
            frames = []
            for name, mod in PKGS.items():
                def recording(payload, _pack=mod.pack_frame):
                    data = _pack(payload)
                    frames.append(bytes(data))
                    return data

                monkeypatch.setattr(mod, "pack_frame", recording)
            disp = PKGS[server].DataDispatcher(task_timeout=0.3,
                                               failure_max=2).start()
            try:
                responses = _scripted(PKGS[client], disp.endpoint, files)
            finally:
                disp.stop()
                monkeypatch.undo()
            runs[(server, client)] = (responses, frames)
    want_resp, want_frames = runs[("jax", "jax")]
    handed = [(r["task"]["id"], r["task"]["start_record"])
              for r in want_resp if isinstance(r, dict) and "task" in r]
    # requeued at the reported offsets: the timed-out task and the
    # drained one (which then fails twice and is dropped)
    assert (0, 7) in handed and handed.count((2, 4)) == 2
    assert want_resp[3] is True and want_resp[4] is False  # the late ack
    states = [r for r in want_resp if isinstance(r, dict) and "failed" in r]
    assert states[1]["failed"] == 1  # the epoch's end
    for pairing, (responses, frames) in runs.items():
        assert responses == want_resp, pairing
        assert len(frames) == len(want_frames), pairing
        for i, (got, want) in enumerate(zip(frames, want_frames)):
            assert got == want, (pairing, i)


def _snapshot_then_recover(writer, reader, tmp_path, job):
    """``writer``'s dispatcher snapshots into a port store; ``reader``'s
    recovers it. Returns the recovered state and the tasks it hands out."""
    from edl_tpu.discovery.registry import Registry as JaxRegistry
    from edl_tpu.store.client import StoreClient as JaxStoreClient
    from edl_tpu_torch.discovery.registry import Registry as PortRegistry
    from edl_tpu_torch.store.client import StoreClient as PortStoreClient

    stacks = {"jax": (JaxStoreClient, JaxRegistry),
              "port": (PortStoreClient, PortRegistry)}
    tmp_path.mkdir()
    files = _corpus(tmp_path, files=4)
    srv = ChildStore()
    try:
        cls, reg_cls = stacks[writer]
        sc = cls(srv.endpoint, timeout=5.0)
        disp = PKGS[writer].DataDispatcher(
            task_timeout=60.0, registry=reg_cls(sc, job)).start()
        c = PKGS[writer].DispatcherClient(disp.endpoint, "w0")
        c.add_dataset(files)
        c.task_done(c.get_task()["task"]["id"])
        in_flight = c.get_task()["task"]
        c.report(in_flight["id"], 9)
        c.set_progress(0, {in_flight["file_idx"]: 9}, [0])  # snapshots
        c.close()
        disp.stop()  # the "crash"
        sc.close()
        cls, reg_cls = stacks[reader]
        sc = cls(srv.endpoint, timeout=5.0)
        disp = PKGS[reader].DataDispatcher(
            task_timeout=60.0, registry=reg_cls(sc, job)).start()
        c = PKGS[reader].DispatcherClient(disp.endpoint, "w1")
        state = c.state()
        handed = []
        while True:
            resp = c.get_task()
            if resp.get("epoch_done"):
                break
            handed.append((resp["task"]["path"], resp["task"]["start_record"]))
            c.task_done(resp["task"]["id"])
        c.close()
        disp.stop()
        sc.close()
    finally:
        srv.stop()
    return state, handed, in_flight


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_snapshot_is_recovered_by_the_other_package(writer, reader,
                                                      tmp_path):
    state, handed, in_flight = _snapshot_then_recover(
        writer, reader, tmp_path / "a", "snap-%s" % writer)
    same, same_handed, _ = _snapshot_then_recover(
        reader, reader, tmp_path / "b", "same-%s" % reader)
    assert state["done"] == 1 and state["todo"] == 3, state
    assert (in_flight["path"], 9) in handed
    assert [s.split("/")[-1] for s, _ in handed] == [
        s.split("/")[-1] for s, _ in same_handed]
    assert [n for _, n in handed] == [n for _, n in same_handed]
    assert json.dumps(state, sort_keys=True) == json.dumps(
        same, sort_keys=True)
