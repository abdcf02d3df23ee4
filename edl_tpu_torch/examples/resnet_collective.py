"""ResNet50_vd elastic collective training: the flagship benchmark job.

The port of ``examples/resnet_collective.py`` (the reference's headline
workload, example/collective/resnet50/train_with_fleet.py: join from the
env, build, load the checkpoint, the epoch loop, the per-epoch save).
Each (re)start joins the stage from the launcher's env, re-resolves the
learning rate for the stage's world size (``linear_scaled_lr`` through the
``AdjustRegistry``), builds the model from one seed on every rank, places
it on a ``{"dp": -1, "fsdp": 1}`` mesh and wraps it for data parallelism
(the JAX example's ``shard_params_fsdp`` over an fsdp axis of size 1
keeps every tensor whole: DDP is that placement here, FSDP is
``ElasticTrainer(fsdp=True)``), restores the newest
checkpoint (parameters, batch-norm buffers and the optimizer's momentum,
at any world size) and trains SGD with Nesterov momentum from the next
epoch. Batch norm is stage-wide: every BN reduces its statistics over the
stage's ranks, so a world-N step is a world-1 step on the ranks' rows
concatenated.

Synthetic ImageNet-shaped data: the records of (epoch, rank) come from
``RandomState(1000 * (epoch + 1) + rank)``, the JAX example's stream, so
both packages see the same images and labels; sizes shrink on the CPU
(batch 8 at 32x32). Elastic run on the port's control plane, from the
repo root::

    python -m edl_tpu_torch.store.server --port 2379 &
    PYTHONPATH=. python -m edl_tpu_torch.launch --store 127.0.0.1:2379 \\
        --job_id rn50 --nodes_range 1:2 --ckpt_path /tmp/rn50 \\
        edl_tpu_torch/examples/resnet_collective.py --epochs 4

``--device cpu`` runs it on the CPU (gloo). The JAX harness that drives a
resize schedule (``edl_tpu.harness.resize``) is not ported.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from edl_tpu_torch.checkpoint import (
    AdjustRegistry,
    CheckpointManager,
    TrainStatus,
    linear_scaled_lr,
)
from edl_tpu_torch.data import batched, prefetch_to_device
from edl_tpu_torch.models.resnet import ResNet50_vd
from edl_tpu_torch.parallel import (
    batch_sharding,
    data_parallel,
    make_mesh,
)
from edl_tpu_torch.train import (
    create_state,
    init,
    make_cross_entropy_loss,
    make_train_step,
    sgd,
    worker_barrier,
)
from edl_tpu_torch.utils.device import resolve_device

adjusts = AdjustRegistry()


def records(epoch: int, rank: int, count: int, size: int):
    """``count`` (image, label) records of (epoch, rank): the reference's
    pass_id-as-seed stream (train_with_fleet.py:458-464). For a fixed
    world size every epoch's stream is deterministic, so an epoch-boundary
    resume replays the data the killed job would have seen."""
    rs = np.random.RandomState(1000 * (epoch + 1) + rank)
    for _ in range(count):
        img = rs.standard_normal((size, size, 3)).astype(np.float32)
        yield img, np.int64(rs.randint(1000))


def _global_mean(metrics, world: int):
    """The last step's loss and accuracy over the global batch (every
    rank holds the same number of rows)."""
    packed = torch.stack([metrics["loss"].float(),
                          metrics["accuracy"].float()])
    if world > 1:
        dist.all_reduce(packed)
        packed /= world
    return packed.tolist()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--steps_per_epoch", type=int, default=10)
    parser.add_argument("--base_lr", type=float, default=0.1)
    parser.add_argument("--batch_per_worker", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    env = init(device=args.device)
    on_gpu = dev.type == "cuda"
    batch = args.batch_per_worker or (128 if on_gpu else 8)
    size = 224 if on_gpu else 32

    # lr scales linearly with world size, re-resolved every (re)start:
    # the elastic hyper-parameter adjustment contract
    adjusts.register(linear_scaled_lr(args.base_lr, base_world_size=1))

    ckpt_dir = env.ckpt_path or os.path.join(tempfile.gettempdir(), "rn50_ckpt")
    mesh = make_mesh({"dp": -1, "fsdp": 1}, device=args.device)
    with CheckpointManager(ckpt_dir) as mngr:
        resolved = adjusts.resolve(None, env.world_size)
        lr = resolved.get("lr", args.base_lr)
        # one seed on every rank: the ranks start from the same weights
        # (data parallelism also broadcasts rank 0's); per-worker data
        # differs through the rank term of records()
        state = create_state(
            ResNet50_vd(num_classes=1000), 0,
            sgd(lr, momentum=0.9, nesterov=True), device=mesh.device,
        )
        state.apply_fn = data_parallel(state.apply_fn, mesh)
        state, status = mngr.restore(state)
        start_epoch = status.next_epoch() if status else 0
        if env.is_rank0 and status:
            print("resumed at epoch %d (world=%d, lr=%.4f)"
                  % (start_epoch, env.world_size, lr))

        # acc1 + acc5, the reference table metrics (README.md:70)
        step = make_train_step(make_cross_entropy_loss(5), {"train": True})
        sharding = batch_sharding(mesh, "dp")
        worker_barrier("train-start")
        for epoch in range(start_epoch, args.epochs):
            # fixed-shape host batches, transfers kept in flight behind
            # the step (two in flight)
            src = (b for b, _ in batched(
                records(epoch, env.global_rank,
                        args.steps_per_epoch * batch, size),
                batch, drop_remainder=True))
            metrics = None
            for device_batch in prefetch_to_device(src, depth=2,
                                                   sharding=sharding):
                state, metrics = step(state, device_batch)
            loss, acc = _global_mean(metrics, env.world_size)
            if env.is_rank0:
                print("epoch %d loss %.4f acc %.3f" % (epoch, loss, acc),
                      flush=True)
            # collective: rank 0 writes the version, every rank joins
            mngr.save(state, TrainStatus(epoch=epoch, step=int(state.step)))
        mngr.wait()


if __name__ == "__main__":
    main()
