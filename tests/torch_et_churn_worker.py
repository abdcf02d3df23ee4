"""ElasticTrainer worker of the port for the launcher churn test: the
counterpart of ``et_churn_worker.py``, importing only ``edl_tpu_torch``.

Trains a tiny TransformerLM on the CPU through ``ElasticTrainer`` with
per-epoch checkpoints (gloo carries the gradients at world > 1), and drops
markers so the test can tell which epochs ran in which (stage, world)
incarnation, that a respawned incarnation resumed rather than restarted,
and that the stage's start barrier went through the store.
"""

import json
import os
import time

import numpy as np
import torch

from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import ElasticTrainer, adamw, cross_entropy_loss
from edl_tpu_torch.train import context

out_dir = os.environ["TEST_OUT_DIR"]
stage = os.environ.get("EDL_STAGE", "nostage")
rank = os.environ.get("EDL_WORKER_RANK", "0")
world = os.environ.get("EDL_NUM_WORKERS", "1")
pause = float(os.environ.get("TEST_EPOCH_PAUSE", "0.5"))
EPOCHS, RECORDS, BATCH, SEQ, VOCAB = 6, 64, 8, 16, 64


def records(epoch):
    rng = np.random.RandomState(100 + epoch)
    for _ in range(RECORDS):
        tok = rng.randint(0, VOCAB, SEQ + 1).astype(np.int64)
        yield tok[:-1], tok[1:]


def mark(epoch, _metrics):
    name = "ep.%s.%s.%s.%d" % (stage, rank, world, epoch)
    with open(os.path.join(out_dir, name), "w") as f:
        f.write("1")
    # the barriers this incarnation met (by the first epoch's end: the
    # trainer's start barrier)
    with open(os.path.join(out_dir, "barrier.%s.%s" % (stage, rank)), "w") as f:
        json.dump({"%s:%s" % key: n for key, n in context._barrier_rounds.items()}, f)
    time.sleep(pause)  # stretch the epoch so churn lands mid-training


torch.manual_seed(0)
trainer = ElasticTrainer(
    TransformerLM(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=1,
                  d_ff=64, dtype=torch.float32, device="cpu"),
    adamw(1e-3),
    cross_entropy_loss,
    batch_size=BATCH,
    ckpt_dir=os.environ["EDL_CKPT_PATH"],
    log=False,
    device="cpu",
)
state = trainer.fit(records, epochs=EPOCHS, on_epoch_end=mark)
with open(os.path.join(out_dir, "done.%s.%s" % (stage, rank)), "w") as f:
    f.write(str(int(state.step)))
