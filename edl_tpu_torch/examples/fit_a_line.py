"""Minimal end-to-end job: linear regression under the elastic launcher.

The port of ``examples/fit_a_line.py`` (≙ reference example/fit_a_line —
its smoke workload), expressed through the high-level ``ElasticTrainer``:
one constructor + one ``fit`` call covers env join, mesh build,
checkpoint restore/save, device-prefetched input, stage barrier, and
rank-0 logs. The records of (epoch, rank) come from
``RandomState(1000 * (epoch + 1) + rank)``, the JAX example's stream, so
both packages see the same rows. Run standalone (on the card unless
``--device cpu``)::

    PYTHONPATH=. python -m edl_tpu_torch.examples.fit_a_line [--device cpu]

or elastically (any pod count; kill/add pods mid-run)::

    python -m edl_tpu_torch.store.server --port 2379 &
    PYTHONPATH=. python -m edl_tpu_torch.launch --job_id fit \\
        --store 127.0.0.1:2379 --nodes_range 1:4 \\
        edl_tpu_torch/examples/fit_a_line.py

``--params F.npz`` starts from converted weights (``convert.py``'s flat
``/``-keyed names) in place of the seeded init. Rank 0 logs each
epoch's last loss (the trainer's ``epoch N loss X`` lines) and ``done at
step N``; ``main`` returns the losses of the epochs it trained.
"""

import argparse
import os
import tempfile

import numpy as np

from edl_tpu_torch import convert
from edl_tpu_torch.models.mlp import LinearRegression
from edl_tpu_torch.train import ElasticTrainer, mse_loss, sgd
from edl_tpu_torch.train.context import current_env

D = 13


def records(epoch):
    """Epoch+rank-seeded synthetic stream: resumes replay the exact order
    a killed run would have seen (pass_id-as-seed), and each worker feeds
    DISTINCT rows (local-rows contract: the global batch concatenates
    every worker's rows)."""
    rs = np.random.RandomState(1000 * (epoch + 1) + current_env().global_rank)
    w = np.arange(1.0, D + 1.0, dtype=np.float32)
    for _ in range(1024):
        x = rs.randn(D).astype(np.float32)
        y = np.float32(x @ w + 0.1 * rs.randn())
        yield x, np.asarray([y], np.float32)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--params", default=None,
                        help="start from these converted weights (.npz)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns ``{epoch: last loss}`` of the epochs this run
    trained."""
    args = parse_args(argv)
    ckpt_dir = os.environ.get("EDL_CKPT_PATH") or os.path.join(
        tempfile.gettempdir(), "fit_a_line_ckpt"
    )
    model = LinearRegression(D, features=1)
    if args.params:
        convert.load_params(model, args.params)
    trainer = ElasticTrainer(
        model,
        sgd(1e-2),
        mse_loss,
        batch_size=args.batch,
        ckpt_dir=ckpt_dir,
        seed=None if args.params else 0,
        device=args.device,
    )
    losses = {}

    def on_epoch_end(epoch, metrics):
        losses[epoch] = float(metrics["loss"])

    state = trainer.fit(records, epochs=args.epochs, on_epoch_end=on_epoch_end)
    if current_env().is_rank0:
        print("done at step %d" % int(state.step), flush=True)
    return losses


if __name__ == "__main__":
    main()
