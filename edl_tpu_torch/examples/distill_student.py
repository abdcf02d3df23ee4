"""Distillation student: train a ResNet against a discovered teacher fleet.

The port of ``examples/distill_student.py`` (the reference's flagship
service-distill workload: ResNeXt teachers on separate cards feeding
ResNet50_vd students): the student's ``DistillReader`` streams samples
through the teacher fleet, discovered live from the store (teachers can
join, die or drain in the middle of an epoch), and the train step distills
on the returned ``soft_label`` beside the hard labels: CE plus KL, SGD
0.01 with momentum 0.9, the model in training mode::

    python -m edl_tpu_torch.store.server --port 2379 &
    python -m edl_tpu_torch.distill.discovery_server --store 127.0.0.1:2379 &
    python -m edl_tpu_torch.examples.distill_teacher --store 127.0.0.1:2379 --small &
    python -m edl_tpu_torch.examples.distill_student --store 127.0.0.1:2379 --small

``--small`` trains ``ResNet(stage_sizes=(1, 1), num_classes=10, width=8)``
at 32x32, the default ResNet50_vd at 224x224 (bf16 compute); ``--device
cpu`` trains on the CPU. Each epoch is 8 batches of ``--batch``
samples, as in the JAX example; the ragged tail is dropped. One line per epoch (``epoch %d loss %.4f acc %.3f kl %.4f``),
then one ``student summary`` JSON line: batches per epoch, img/s, the
reader's wait per batch and the mean teacher predict latency the pipeline
saw. ``--record PATH`` saves an ``.npz``: the first batch's soft labels
(``soft0``), every batch's labels (``labels`` [batches, batch]), the wall-clock time
each batch reached the train step (``ts``) and each epoch began
(``epoch_t0``). The process
arms the chaos plane as ``student`` (``EDL_CHAOS``: ``distill.predict``,
``distill.reader.epoch``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

BATCHES = 8  # an epoch, as in the JAX example

def distill_loss(logits, targets):
    """targets = (hard_label, soft_label): CE + KL to the teacher."""
    hard, soft = targets
    log_p = F.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(log_p, -1, hard.long()[:, None]))
    kl = torch.mean(torch.sum(soft * (torch.log(soft + 1e-8) - log_p), dim=-1))
    accuracy = (logits.argmax(dim=-1) == hard).float().mean()
    return ce + kl, {"accuracy": accuracy, "kl": kl}


def sample_generator(rng, n: int, size: int, classes: int):
    """The JAX example's stream: ``n`` (image [size, size, 3] fp32, label
    int64) samples from ``rng``, image first."""

    def gen():
        for _ in range(n):
            image = rng.randn(size, size, 3).astype(np.float32)
            label = np.int64(rng.randint(classes))
            yield image, label

    return gen


def _batched(stream, batch_size):
    """Group (image, label, soft_label) samples into fixed-size numpy
    batches; drops the ragged tail (the JAX example keeps shapes static)."""
    images, labels, softs = [], [], []
    for sample in stream:
        image, label, soft = sample
        images.append(image)
        labels.append(label)
        softs.append(soft)
        if len(images) == batch_size:
            yield (np.stack(images), np.asarray(labels, np.int32),
                   np.stack(softs))
            images, labels, softs = [], [], []


def main(argv=None) -> None:
    from edl_tpu_torch.chaos.plane import arm_from_env
    from edl_tpu_torch.distill import DistillReader
    from edl_tpu_torch.examples.distill_teacher import build_model
    from edl_tpu_torch.obs import metrics as obs_metrics
    from edl_tpu_torch.train import create_state, init, make_train_step, sgd

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--store", required=True)
    parser.add_argument("--job_id", default="distill")
    parser.add_argument("--service", default="teacher")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--small", action="store_true", help="tiny CPU model")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--record", default=None)
    args = parser.parse_args(argv)

    arm_from_env("student")
    env = init(device=args.device)
    model, size = build_model(args.small, args.device)
    classes = 10 if args.small else 1000
    rng = np.random.RandomState(env.global_rank)

    reader = DistillReader(
        feeds=["image", "label"],
        fetchs=["soft_label"],
        teacher_batch_size=args.batch,
    )
    reader.set_dynamic_teacher(args.store, args.job_id, args.service)
    reader.set_sample_generator(
        sample_generator(rng, args.batch * BATCHES, size, classes))

    state = create_state(model, None, sgd(0.01, momentum=0.9),
                         device=args.device)
    dev = state.step.device
    step = make_train_step(distill_loss, {"train": True})

    per_epoch, waits, secs = [], [], []
    record = {"labels": [], "ts": [], "epoch_t0": []}
    try:
        for epoch in range(args.epochs):
            n, wait_s = 0, 0.0
            record["epoch_t0"].append(time.time())
            stream = _batched(reader(), args.batch)
            t_epoch = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                batch = next(stream, None)
                wait_s += time.perf_counter() - t0
                if batch is None:
                    break
                images, labels, soft = batch
                record["ts"].append(time.time())
                record["labels"].append(labels)
                if "soft0" not in record:
                    record["soft0"] = soft
                state, metrics = step(state, (
                    torch.from_numpy(images).to(dev),
                    (torch.from_numpy(labels).to(dev),
                     torch.from_numpy(soft).to(dev)),
                ))
                n += 1
            loss = float(metrics["loss"])  # waits for the epoch's last step
            secs.append(time.perf_counter() - t_epoch)
            waits.append(wait_s)
            per_epoch.append(n)
            print(
                "epoch %d loss %.4f acc %.3f kl %.4f"
                % (epoch, loss, float(metrics["accuracy"]),
                   float(metrics["kl"])),
                flush=True,
            )
    finally:
        reader.stop()
    if args.record:
        np.savez(args.record, **{k: np.asarray(v) for k, v in record.items()})
    predict = obs_metrics.default_registry().snapshot().get(
        "edl_distill_predict_seconds", {})
    n_batches = sum(per_epoch)
    print("student summary %s" % json.dumps({
        "batches_per_epoch": per_epoch,
        "img_per_s": n_batches * args.batch / sum(secs) if secs else None,
        "img_per_s_by_epoch": [n * args.batch / t
                               for n, t in zip(per_epoch, secs)],
        "reader_wait_ms_per_batch": 1e3 * sum(waits) / max(1, n_batches),
        "reader_wait_ms_per_batch_by_epoch": [
            1e3 * w / max(1, n) for n, w in zip(per_epoch, waits)],
        "teacher_predict_ms": (1e3 * predict["sum"] / predict["count"]
                               if predict.get("count") else None),
        "predicts": predict.get("count"),
    }), flush=True)


if __name__ == "__main__":
    main()
