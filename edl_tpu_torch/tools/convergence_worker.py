"""Convergence worker: real-data training through the full elastic stack.

The port of ``tools/convergence_worker.py``, launched under
``edl_tpu_torch.launch`` by ``edl_tpu_torch/tools/convergence_churn.py``.
It trains an MLP classifier on the digits dataset (1,797 real 8x8
handwritten-digit scans — the in-image-classification, no-egress analogue
of the reference's ImageNet runs, reference README.md:144-147) through
``ElasticTrainer``: per-epoch checkpoints, stop-resume across resizes,
epoch-seeded deterministic shuffling (the reference's
``pass_id_as_seed`` contract, train_with_fleet.py:458-464).

The data is the repository's copy of scikit-learn 1.9.0's
``digits.csv.gz`` (the UCI optical-digits test set, CC BY 4.0; see
README.md), read with numpy: :func:`load_digits` gives what
``sklearn.datasets.load_digits()`` gives as ``data`` and ``target``.

The GLOBAL batch is fixed (``TEST_GLOBAL_BATCH``); each incarnation takes
``global/world`` rows per process from its ``[rank::world]`` shard, so the
optimization trajectory is world-size-invariant up to record order — the
property that makes "churn must not change the final metric" a fair
assert. After training, every rank joins a sharded ``evaluate()`` over the
held-out split and rank 0 writes ``final.json``.

Environment: ``TEST_OUT_DIR`` (required), ``TEST_EPOCHS`` (40),
``TEST_GLOBAL_BATCH`` (56), ``TEST_EPOCH_PAUSE`` (0 s), ``EDL_CKPT_PATH``;
``--device`` (``cuda`` unless ``cpu`` is named).
"""

import argparse
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

DIGITS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "digits.csv.gz")
# 1344 = 24 * GLOBAL_BATCH (56), and divisible by every scheduled world
# size (1..4): every epoch is exactly 24 full global steps with no record
# dropped, for any world
N_TRAIN = 1344
N_TEST = 360


def load_digits():
    """``(data, target)``: float64 ``[1797, 64]`` pixels in 0-16 and int
    labels, as ``sklearn.datasets.load_digits()`` returns them."""
    import numpy as np

    with gzip.open(DIGITS, "rt") as f:
        values = np.loadtxt(f, delimiter=",")
    return values[:, :-1], values[:, -1].astype(int, copy=False)


def dataset():
    """``(x, y, train_idx, test_idx)``: pixels scaled to [0, 1], the
    labels, and the JAX worker's seeded split."""
    import numpy as np

    data, target = load_digits()
    x = (data / 16.0).astype(np.float32)  # [1797, 64] in [0, 1]
    y = target.astype(np.int32)
    split = np.random.RandomState(0).permutation(len(x))
    return x, y, split[:N_TRAIN], split[N_TRAIN:N_TRAIN + N_TEST]


def train_records(x, y, train_idx, epoch: int, rank: int, world: int):
    """This rank's records of ``epoch``: the epoch-seeded shuffle, then
    every ``world``-th record from ``rank``."""
    import numpy as np

    order = np.random.RandomState(1000 + epoch).permutation(train_idx)
    for i in order[rank::world]:
        yield (x[i], y[i])


def make_model(device=None):
    from edl_tpu_torch.models import MLP

    return MLP(64, hidden=(64,), features=10, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    out = os.environ["TEST_OUT_DIR"]
    epochs = int(os.environ.get("TEST_EPOCHS", "40"))
    global_batch = int(os.environ.get("TEST_GLOBAL_BATCH", "56"))
    pause = float(os.environ.get("TEST_EPOCH_PAUSE", "0"))

    from edl_tpu_torch.cluster.job_env import WorkerEnv

    # incarnation marker FIRST (before the process group's join, which can
    # outlive a short-lived stage): convergence_churn counts distinct
    # stages = cluster generations this job ran under, proving churn landed
    pre = WorkerEnv()
    marker = "inc.%s.%d.%d" % (pre.stage or "solo", pre.global_rank,
                               pre.world_size)
    with open(os.path.join(out, marker), "w") as f:
        f.write("1")

    from edl_tpu_torch.train import (
        ElasticTrainer, current_env, init, make_cross_entropy_loss, sgd,
    )

    env = init(device=args.device)
    world = max(env.world_size, 1)
    rank = env.global_rank
    assert global_batch % world == 0, (global_batch, world)
    assert N_TRAIN % global_batch == 0
    x, y, train_idx, test_idx = dataset()

    def test_records():
        for i in test_idx[rank::world]:
            yield (x[i], y[i])

    def on_epoch_end(epoch, _metrics):
        if pause:
            time.sleep(pause)  # stretch the run so churn lands mid-training

    trainer = ElasticTrainer(
        make_model(),
        sgd(0.1, momentum=0.9),
        make_cross_entropy_loss(),
        batch_size=global_batch // world,
        ckpt_dir=os.environ["EDL_CKPT_PATH"],
        seed=0,
        log=False,
        device=args.device,
    )
    state = trainer.fit(
        lambda epoch: train_records(x, y, train_idx, epoch, rank, world),
        epochs=epochs, on_epoch_end=on_epoch_end)
    metrics = trainer.evaluate(state, test_records)
    if current_env().is_rank0:
        with open(os.path.join(out, "final.json"), "w") as f:
            json.dump(
                {
                    "test_accuracy": metrics.get("accuracy"),
                    "test_loss": metrics.get("loss"),
                    "steps": int(state.step),
                    "epochs": epochs,
                    "world_at_finish": world,
                },
                f,
            )


if __name__ == "__main__":
    main()
