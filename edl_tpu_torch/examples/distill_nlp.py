"""NLP distillation: a TransformerLM teacher distills a smaller student.

The port of ``examples/distill_nlp.py``: the teacher (4 layers, d_model
128) serves per-token soft distributions from its final layer; the
student (2 layers, d_model 64, so heads of width 16) trains on pure
soft-target KL through a :class:`~edl_tpu_torch.distill.DistillReader`
that discovers the teachers from the store. Both are fp32, as in the JAX
example; the student's attention runs K1 forward and K2/K3 backward at
head width 16, the teacher's K1 at 32. Teacher and student run as
separate processes so the teacher fleet scales independently::

    python -m edl_tpu_torch.store.server --port 2379 &
    python -m edl_tpu_torch.distill.discovery_server --store 127.0.0.1:2379 &
    python -m edl_tpu_torch.examples.distill_nlp --role teacher --store 127.0.0.1:2379 &
    python -m edl_tpu_torch.examples.distill_nlp --role student --store 127.0.0.1:2379

A teacher started without ``--store`` serves unregistered; register it
from outside (as the reference registers an external teacher)::

    python -m edl_tpu_torch.examples.distill_nlp --role teacher &
    python -m edl_tpu_torch.discovery.register --store 127.0.0.1:2379 \\
        --job_id distill-nlp --service nlp-teacher --teacher \\
        --endpoint HOST:PORT

``--device cpu`` runs either role on the CPU. The student prints
``epoch %d kd-loss %.4f`` per epoch, as the JAX example does, and at its
end one ``student summary`` JSON line (batches per epoch, the first and
last batch's kd-loss, the tasks re-queued, the flash kernels' launches);
a stopped teacher prints the predicts it served and its launches
likewise.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.ops.attention import launch_counts

VOCAB = 1024
SEQ = 64


def build_lm(num_layers: int, d_model: int, device="cuda", seed: int = 0):
    """The example's TransformerLM (4 heads, d_ff 4·d_model, fp32) on
    ``device`` with weights drawn from ``seed``."""
    from edl_tpu_torch.models.transformer import TransformerLM
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = TransformerLM(
        vocab_size=VOCAB, d_model=d_model, num_heads=4,
        num_layers=num_layers, d_ff=4 * d_model, dtype=torch.float32,
        device=dev,
    )
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))


def kd_loss(logits, soft):
    """Pure soft-target distillation: per-token KL to the teacher."""
    log_p = F.log_softmax(logits, dim=-1)
    kl = torch.mean(
        torch.sum(soft * (torch.log(soft + 1e-8) - log_p), dim=-1)
    )
    return kl, {}


def _counted(name: str) -> int:
    """The total of counter ``name`` over its labels in this process."""
    from edl_tpu_torch.obs import metrics as obs_metrics

    return int(sum(obs_metrics.default_registry().snapshot()
                   .get(name, {}).values()))


def run_teacher(args) -> None:
    from edl_tpu_torch.distill.nlp_teacher import (
        make_apply,
        serve_until_signalled,
    )
    from edl_tpu_torch.distill.serving import PredictServer, TorchPredictBackend

    model = build_lm(num_layers=4, d_model=128, device=args.device).eval()
    backend = TorchPredictBackend(make_apply(model), device=args.device)
    server = PredictServer(backend, port=args.port).start()
    print("nlp teacher serving on %s" % server.endpoint, flush=True)
    serve_until_signalled(server, args.store, args.job_id, args.service)
    served = _counted("edl_distill_serve_requests_total")
    print("teacher summary %s" % json.dumps(
        {"requests": served, "launches": launch_counts()}), flush=True)


def batches(n_batches: int, batch: int, seed: int = 0):
    """The example's token stream: ``n_batches`` of int32 [batch, SEQ]."""
    rng = np.random.RandomState(seed)
    for _ in range(n_batches):
        yield (rng.randint(0, VOCAB, (batch, SEQ)).astype(np.int32),)


def run_student(args) -> None:
    from edl_tpu_torch.chaos.plane import arm_from_env
    from edl_tpu_torch.distill import DistillReader
    from edl_tpu_torch.train import adamw, create_state, init, make_train_step

    arm_from_env("student")
    init(device=args.device)
    model = build_lm(num_layers=2, d_model=64, device=args.device, seed=1)
    state = create_state(model, None, adamw(3e-4), device=args.device)
    dev = state.step.device

    reader = DistillReader(
        feeds=["tokens"], fetchs=["soft_label"],
        teacher_batch_size=args.batch,
    )
    reader.set_dynamic_teacher(args.store, args.job_id, args.service)
    reader.set_batch_generator(lambda: batches(args.batches, args.batch))

    step = make_train_step(kd_loss)
    losses, per_epoch = [], []
    try:
        for epoch in range(args.epochs):
            metrics, n = None, 0
            for (tokens, soft) in reader():
                state, metrics = step(state, (
                    torch.from_numpy(tokens).to(dev),
                    # the fetched arrays view the reply's read-only frame
                    torch.from_numpy(np.require(soft, requirements="W"))
                    .to(dev),
                ))
                losses.append(float(metrics["loss"]))
                n += 1
            per_epoch.append(n)
            if metrics is not None:
                print("epoch %d kd-loss %.4f" % (epoch, float(metrics["loss"])),
                      flush=True)
    finally:
        reader.stop()
    print("student summary %s" % json.dumps({
        "batches_per_epoch": per_epoch,
        "first_kd_loss": losses[0] if losses else None,
        "last_kd_loss": losses[-1] if losses else None,
        "requeues": _counted("edl_distill_task_requeues_total"),
        "launches": launch_counts(),
    }), flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--role", choices=("teacher", "student"), required=True)
    parser.add_argument("--store", default=None,
                        help="the store (the student's discovery; a "
                        "teacher registers in it when given)")
    parser.add_argument("--job_id", default="distill-nlp")
    parser.add_argument("--service", default="nlp-teacher")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if args.role == "student" and not args.store:
        parser.error("the student discovers its teachers: --store is "
                     "required")
    if args.role == "teacher":
        run_teacher(args)
    else:
        run_student(args)


if __name__ == "__main__":
    main()
