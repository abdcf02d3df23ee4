"""Elastic data + train worker for the port, launched by
``tests/test_torch_elastic_data.py`` under ``python -m
edl_tpu_torch.launch`` (the port of ``tests/data_train_worker.py``), in
one of two modes (env ``TEST_MODE``):

- ``coverage``: every worker streams its dispatcher share and logs each
  consumed (epoch, file, record) with its time to a per-incarnation
  file; the test
  churns pods and checks per-epoch coverage and exactly-once afterwards.
- ``train``: single-worker training where the model checkpoint (the
  port's ``CheckpointManager``) carries the :class:`DataCheckpoint`
  inside ``TrainStatus.meta``; on restart the worker restores the pair
  atomically and rewinds the dispatcher with ``set_progress`` so model
  and data roll back to the same instant — the test SIGKILLs it
  mid-epoch and checks the final parameters equal an uninterrupted
  run's bit for bit.
"""

import glob
import hashlib
import json
import os
import sys
import time

MODE = os.environ.get("TEST_MODE", "coverage")
OUT = os.environ["TEST_OUT_DIR"]
DATA = os.environ["TEST_DATA_DIR"]
EPOCHS = int(os.environ.get("TEST_EPOCHS", "3"))
CKPT_DIR = os.environ.get("TEST_CKPT_DIR", "")
CKPT_EVERY = int(os.environ.get("TEST_CKPT_EVERY", "5"))
STEP_DELAY = float(os.environ.get("TEST_STEP_DELAY", "0"))

SERVICE = "data/dispatcher"
BATCH = 4
DIM = 32

from edl_tpu_torch.cluster.job_env import WorkerEnv  # noqa: E402
from edl_tpu_torch.data import (  # noqa: E402
    DataCheckpoint,
    DataDispatcher,
    DispatcherClient,
    ElasticDataLoader,
    TxtFileSplitter,
)
from edl_tpu_torch.discovery.registry import Registry  # noqa: E402
from edl_tpu_torch.store import StoreClient  # noqa: E402

env = WorkerEnv()
store = StoreClient(env.store_endpoint)
registry = Registry(store, env.job_id)

dispatcher = None
lead = None
if env.is_rank0:
    # the leader hosts the dispatcher; a restarted leader recovers the
    # epoch and task state from the registry snapshot; the per-epoch task
    # order is a function of (seed, epoch)
    dispatcher = DataDispatcher(
        registry=registry, task_timeout=2.0, shuffle_seed=7
    ).start()
    lead = DispatcherClient(dispatcher.endpoint, "leader")
    if lead.state()["files"] == 0:
        lead.add_dataset(sorted(glob.glob(os.path.join(DATA, "*.txt"))))
    registry.register(SERVICE, dispatcher.endpoint, b"1", ttl=1.5)
    endpoint = dispatcher.endpoint
else:
    endpoint = None
    deadline = time.time() + 60
    while time.time() < deadline and endpoint is None:
        for meta in registry.get_service(SERVICE):
            try:
                probe = DispatcherClient(meta.name, "probe", timeout=2.0)
                probe.state()
                probe.close()
                endpoint = meta.name
                break
            except Exception:
                continue
        if endpoint is None:
            time.sleep(0.1)
    assert endpoint, "no live dispatcher endpoint"

client = DispatcherClient(
    endpoint, "w%d-%d" % (env.global_rank, os.getpid())
)
loader = ElasticDataLoader(client, TxtFileSplitter(), report_every=1)


def run_coverage():
    from edl_tpu_torch.train import worker_barrier

    log_path = os.path.join(
        OUT,
        "consume.%s.%d.%d.log" % (env.stage or "solo", env.global_rank,
                                  os.getpid()),
    )
    start_epoch = client.state()["epoch"]
    with open(log_path, "w", buffering=1) as logf:
        for epoch in range(start_epoch, EPOCHS):
            for file_idx, rec_idx, _record in loader.epoch():
                logf.write("%d %d %d %.6f\n"
                           % (epoch, file_idx, rec_idx, time.time()))
                if STEP_DELAY:
                    time.sleep(STEP_DELAY)  # pace so the test churns mid-epoch
            # drain everyone BEFORE the leader refills, or a straggler
            # steals next epoch's tasks into this one
            worker_barrier("epoch-done-%d" % epoch, timeout=120)
            if env.is_rank0 and epoch + 1 < EPOCHS:
                lead.new_epoch(epoch + 1)
            worker_barrier("epoch-adv-%d" % epoch, timeout=120)


def featurize(record: bytes):
    import numpy as np

    digest = hashlib.sha256(record).digest()
    x = np.frombuffer(digest, np.uint8).astype(np.float32) / 255.0
    y = float(sum(digest) % 97) / 97.0
    return x[:DIM], y


def run_train():
    import numpy as np
    import torch

    from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus

    def step(params, X, y):
        w = params["w"].clone().requires_grad_(True)
        b = params["b"].clone().requires_grad_(True)
        loss = torch.mean((X @ w + b - y) ** 2)
        gw, gb = torch.autograd.grad(loss, (w, b))
        return ({"w": params["w"] - 0.1 * gw, "b": params["b"] - 0.1 * gb},
                loss.detach())

    params = {"w": torch.zeros(DIM), "b": torch.zeros(())}
    dc = DataCheckpoint()
    step_no = 0
    mgr = CheckpointManager(CKPT_DIR, max_to_keep=2) if CKPT_DIR else None
    if mgr is not None and mgr.latest_step() is not None:
        params, status = mgr.restore(params)
        assert status is not None
        step_no = status.step
        dc = DataCheckpoint.from_dict(status.meta["data"])
        # rewind the dispatcher to the checkpoint instant: model and data
        # state roll back TOGETHER (the exactness stop-resume needs)
        client.set_progress(dc.epoch, dc.offsets, sorted(dc.done_files))

    losses = open(
        os.path.join(OUT, "losses.%d.log" % os.getpid()), "w", buffering=1
    )
    for epoch in range(dc.epoch, EPOCHS):
        buf = []
        for file_idx, rec_idx, record in loader.epoch():
            buf.append(featurize(record))
            dc.record_progress(file_idx, rec_idx + 1)
            if len(buf) == BATCH:
                X = torch.from_numpy(np.stack([b[0] for b in buf]))
                y = torch.from_numpy(np.array([b[1] for b in buf], np.float32))
                params, loss = step(params, X, y)
                buf = []
                step_no += 1
                losses.write("%d %.8f\n" % (step_no, float(loss)))
                if STEP_DELAY:
                    time.sleep(STEP_DELAY)  # pace so tests can kill mid-run
                if mgr is not None and step_no % CKPT_EVERY == 0:
                    mgr.save(
                        params,
                        TrainStatus(
                            epoch=epoch, step=step_no,
                            meta={"data": dc.to_dict()},
                        ),
                        step=step_no,
                    )
                    mgr.wait()
        # epoch boundary: the partial batch is dropped (static shapes);
        # advance + persist so a restart resumes in the next epoch
        dc.next_epoch()
        if epoch + 1 < EPOCHS:
            lead.new_epoch(epoch + 1)
        if mgr is not None:
            mgr.save(
                params,
                TrainStatus(
                    epoch=epoch + 1, step=step_no,
                    meta={"data": dc.to_dict()},
                ),
                step=step_no,
            )
            mgr.wait()
    final = {
        "w": [float(v) for v in params["w"]],
        "b": float(params["b"]),
        "steps": step_no,
    }
    with open(os.path.join(OUT, "final.json"), "w") as f:
        json.dump(final, f)
    losses.close()
    if mgr is not None:
        mgr.close()


try:
    if MODE == "coverage":
        run_coverage()
    else:
        run_train()
finally:
    client.close()
    if lead is not None:
        lead.close()
    if dispatcher is not None:
        dispatcher.stop()
    store.close()
sys.exit(0)
