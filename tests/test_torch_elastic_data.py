"""Elastic data + train on the port's control plane, on the CPU: the
ports of the JAX ``tests/test_elastic_data_train.py`` drills (the
example and ``edl-status`` against the JAX package's are in
``test_torch_elastic_text_lm.py``).

- Coverage: two launcher pods of ``tests/torch_data_train_worker.py``
  (``python -m edl_tpu_torch.launch`` around a port store, each a child
  process in its own session) stream three epochs through the port's
  dispatcher; one pod is SIGKILLed mid-epoch and a new pod joins. Every
  (file, record) of every epoch is consumed, exactly once in epochs no
  restart touched. In churned epochs a record is read again only where
  an incarnation that was killed read it within ``FLUSH_S`` of its last
  record: a re-dispatched task resumes at the last reported record its
  dispatcher flushed to the store (the timeout loop's tick, 0.5 s at the
  worker's 2 s task timeout, with ``EDL_DATA_SNAPSHOT_EVERY=0.1``).
- Exact resume: one worker checkpointing its model with the
  ``DataCheckpoint`` in ``TrainStatus.meta`` is SIGKILLed mid-epoch under
  the launcher and relaunched; its final parameters equal an
  uninterrupted run's bit for bit.
"""

import collections
import json
import os
import sys
import time

from test_torch_launch import CHILD_TIMEOUT, Rig, wait_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_data_train_worker.py")
FILES = 3
LINES = 80
FLUSH_S = 0.5 + 0.1 + 0.2  # tick + cadence + the kill's own latency


class DataRig(Rig):
    """The port's store and launcher pods around the data worker."""

    def pod(self, job="jdata", nodes="1:3"):
        cmd = [sys.executable, "-m", "edl_tpu_torch.launch", "--job_id", job,
               "--store", self.endpoint, "--nodes_range", nodes,
               "--ttl", "0.8", "--log_dir", os.path.join(self.work, "logs"),
               WORKER]
        return self._spawn(cmd)

    def job_status(self, job):
        from edl_tpu_torch.store.client import StoreClient

        client = StoreClient(self.endpoint, timeout=10.0)
        try:
            return client.get("/%s/job/status" % job)
        finally:
            client.close()


def make_corpus(root) -> str:
    data_dir = os.path.join(str(root), "corpus")
    os.makedirs(data_dir, exist_ok=True)
    for i in range(FILES):
        with open(os.path.join(data_dir, "part-%02d.txt" % i), "w") as f:
            for j in range(LINES):
                f.write("file %d line %d payload\n" % (i, j))
    return data_dir


def _consumed(out):
    """``(per-epoch counts of (file, record), stages seen per epoch,
    {log: [(epoch, file, record, ts)]})`` from the consumption logs."""
    per_epoch = collections.defaultdict(collections.Counter)
    epoch_stages = collections.defaultdict(set)
    logs = {}
    for name in os.listdir(out):
        if not name.startswith("consume."):
            continue
        stage = name.split(".")[1]
        rows = logs.setdefault(name, [])
        with open(os.path.join(out, name)) as f:
            for line in f:
                parts = line.split()
                if len(parts) != 4:
                    continue  # a line the kill cut short
                e, fi, ri = map(int, parts[:3])
                rows.append((e, fi, ri, float(parts[3])))
                per_epoch[e][(fi, ri)] += 1
                epoch_stages[e].add(stage)
    return per_epoch, epoch_stages, logs


def test_coverage_exactly_once_under_churn(tmp_path):
    epochs = 3
    data_dir = make_corpus(tmp_path)
    with DataRig(tmp_path, TEST_MODE="coverage", TEST_DATA_DIR=data_dir,
                 TEST_EPOCHS=str(epochs), TEST_STEP_DELAY="0.01",
                 EDL_DATA_SNAPSHOT_EVERY="0.1") as rig:
        first, second = rig.pod(), rig.pod()

        def midway():
            per_epoch, stages, _logs = _consumed(rig.out)
            return (sum(per_epoch[0].values()) >= 40
                    and len(stages[0]) == 1
                    and len([n for n in os.listdir(rig.out)
                             if n.startswith("consume.")]) >= 2)

        wait_for(midway, "both workers streaming epoch 0")
        rig.kill(second)  # a dead machine, mid-epoch
        second.wait(timeout=CHILD_TIMEOUT)
        wait_for(lambda: len(_consumed(rig.out)[1][0]) >= 2,
                 "a new stage after the kill")
        third = rig.pod()
        assert first.wait(timeout=CHILD_TIMEOUT) == 0
        assert third.wait(timeout=CHILD_TIMEOUT) == 0
        assert rig.job_status("jdata") == b"COMPLETE"

    per_epoch, epoch_stages, logs = _consumed(rig.out)
    want = {(f, r) for f in range(FILES) for r in range(LINES)}
    # where each record was read, with how long before its reader's end
    reads = collections.defaultdict(list)
    for name, rows in logs.items():
        end = rows[-1][3] if rows else 0.0
        for e, fi, ri, ts in rows:
            reads[(e, fi, ri)].append((ts, end - ts, name))
    total_dupes = 0
    for e in range(epochs):
        counts = per_epoch[e]
        missing = want - set(counts)
        assert not missing, "epoch %d missing %d records, e.g. %s" % (
            e, len(missing), sorted(missing)[:5])
        assert not set(counts) - want
        dupes = sum(c - 1 for c in counts.values())
        if len(epoch_stages[e]) == 1:
            # no restart touched this epoch: exactly-once, no excuses
            assert dupes == 0, "stable epoch %d has %d duplicates" % (e, dupes)
        total_dupes += dupes
        for (fi, ri), n in counts.items():
            if n == 1:
                continue
            # every read but the last was a killed reader's unflushed tail
            earlier = sorted(reads[(e, fi, ri)])[:-1]
            assert all(before <= FLUSH_S for _ts, before, _n in earlier), (
                e, fi, ri, sorted(reads[(e, fi, ri)]))
    assert len(epoch_stages[0]) >= 2, "the kill did not land in epoch 0"


def _final(out):
    path = os.path.join(out, "final.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _static_run(work, common):
    with DataRig(work, TEST_CKPT_DIR=os.path.join(str(work), "ckpt"),
                 **common) as rig:
        assert rig.pod(job="jstatic", nodes="1:1").wait(
            timeout=CHILD_TIMEOUT) == 0
        return _final(rig.out)


def test_exact_resume_matches_static_run(tmp_path):
    from concurrent.futures import ThreadPoolExecutor

    data_dir = make_corpus(tmp_path)
    # 60 steps an epoch: a periodic save every 25 never lands on an
    # epoch end's step (the port's manager refuses to overwrite a version)
    common = dict(TEST_MODE="train", TEST_DATA_DIR=data_dir, TEST_EPOCHS="2",
                  TEST_CKPT_EVERY="25")
    ckpt = str(tmp_path / "churn_ckpt")
    with ThreadPoolExecutor(1) as pool:
        # the uninterrupted run, beside the churned one
        static = pool.submit(_static_run, tmp_path / "static", common)
        with DataRig(tmp_path / "churn", TEST_CKPT_DIR=ckpt,
                     TEST_STEP_DELAY="0.03", **common) as rig:
            pod = rig.pod(job="jresume", nodes="1:1")

            def has_ckpt():
                try:
                    return any(d.isdigit() for d in os.listdir(ckpt))
                except OSError:
                    return False

            wait_for(has_ckpt, "the first checkpoint")
            time.sleep(0.3)  # a few steps past the checkpoint
            assert _final(rig.out) is None, "the job finished before the kill"
            rig.kill(pod)
            pod.wait(timeout=CHILD_TIMEOUT)
            assert rig.pod(job="jresume", nodes="1:1").wait(
                timeout=CHILD_TIMEOUT) == 0
            churned = _final(rig.out)
        static = static.result()
    assert static is not None and churned is not None
    assert churned["steps"] == static["steps"]
    assert churned["b"] == static["b"]
    assert churned["w"] == static["w"], (
        "kill-resume must be invisible to the training trajectory")
