"""The port's ElasticTrainer under the JAX package's launcher and store.

``ResizeHarness`` starts launcher pods (``python -m edl_tpu.launch``, the
jax-free control plane) around ``torch_et_churn_worker.py``, which imports
only ``edl_tpu_torch``. Churn is event-driven, as in
``tests/test_harness.py``: one pod trains and checkpoints, a second joins
(the stage restarts at world 2: gloo process group, the start barrier
through the store), then the joiner is SIGKILLed (the survivor restarts
at world 1). The job completes, every epoch is trained once per stage that
resumed, and the step counter ends where an uninterrupted run ends.
"""

import glob
import json
import os
import time

from conftest import store  # noqa: F401 (fixture)

from edl_tpu.harness import ResizeHarness

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_et_churn_worker.py")
EPOCHS, STEPS_PER_EPOCH = 6, 64 // 8
CEILING_S = 120.0


def test_port_trainer_resumes_across_launcher_churn(store, tmp_path):  # noqa: F811
    out_dir = str(tmp_path / "out")
    os.makedirs(out_dir)
    harness = ResizeHarness(
        store.endpoint,
        "torch-et-churn",
        WORKER,
        nodes_range="1:2",
        ttl=0.8,
        log_dir=str(tmp_path / "logs"),
        extra_env={
            "TEST_OUT_DIR": out_dir,
            "EDL_CKPT_PATH": str(tmp_path / "ckpt"),
            "EDL_DEVICES_PER_PROC": "1",
            # a CPU worker loads no kernel library: no cache to exchange
            "EDL_COMPILE_CACHE_DIR": "none",
            "OMP_NUM_THREADS": "1",
            "TEST_EPOCH_PAUSE": "1.0",
        },
    )
    deadline = time.monotonic() + CEILING_S

    def marks():
        return [os.path.basename(m)
                for m in glob.glob(os.path.join(out_dir, "ep.*"))]

    def wait_for(cond, what):
        while time.monotonic() < deadline:
            if cond():
                return
            if harness.job_complete():
                return  # job raced ahead; the assertions below decide
            time.sleep(0.2)
        raise AssertionError("timed out waiting for " + what)

    try:
        harness.start_pod()
        # milestone 1: the first incarnation checkpointed epoch 0
        wait_for(lambda: len(marks()) >= 1, "first epoch marker")
        first_stages = {m.split(".")[1] for m in marks()}
        # churn: a pod joins -> restage at world 2, both resume
        joiner = harness.start_pod()
        wait_for(
            lambda: any(m.split(".")[1] not in first_stages
                        and m.split(".")[3] == "2" and int(m.split(".")[4]) > 0
                        for m in marks()),
            "a resumed marker from the world-2 stage",
        )
        # churn again: SIGKILL the joiner -> the survivor resumes alone
        harness.kill_pod(joiner)
        wait_for(harness.job_complete, "job completion after churn")
        assert harness.job_complete(), "job did not complete after churn"
    finally:
        harness.shutdown()

    by_stage = {}
    worlds = {}
    for m in marks():
        _, stg, rank, world, epoch = m.split(".")
        worlds[stg] = int(world)
        if rank == "0":
            by_stage.setdefault(stg, []).append(int(epoch))
    for stg, epochs in by_stage.items():
        # each stage trains each epoch once, consecutively from its resume
        assert sorted(epochs) == list(range(min(epochs), max(epochs) + 1)), (
            stg, epochs)
    assert set(e for es in by_stage.values() for e in es) == set(range(EPOCHS))
    assert any(min(es) > 0 for es in by_stage.values()), by_stage
    assert 2 in worlds.values(), worlds
    # the world-2 stage met at its start barrier through the store
    two = [s for s, w in worlds.items() if w == 2]
    met = []
    for path in glob.glob(os.path.join(out_dir, "barrier.*")):
        _, stg, _rank = os.path.basename(path).split(".")
        with open(path) as fh:
            met.append((stg, json.load(fh)))
    assert {stg for stg, _ in met} == set(worlds)
    for stg, rounds in met:
        want = {"%s:elastic-trainer-start" % stg: 1} if stg in two else {}
        assert rounds == want, (stg, rounds)
    done = glob.glob(os.path.join(out_dir, "done.*"))
    assert done, "no completion marker"
    steps = {open(f).read() for f in done}
    assert steps == {str(EPOCHS * STEPS_PER_EPOCH)}, steps
