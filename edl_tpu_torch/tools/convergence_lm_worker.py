"""Char-LM convergence worker: churn that actually perturbs data order.

The port of ``tools/convergence_lm_worker.py``. The digits workload
(``convergence_worker.py``) is world-size-invariant by construction —
every stage sees identical global batches, so its gap proves stop-resume
mechanics, not robustness to perturbed data. THIS worker feeds a
byte-level TransformerLM (vocab 256, d_model 48, 4 heads, 2 layers, d_ff
128, fp32) through the elastic data layer (``DataDispatcher`` +
``ElasticDataLoader`` mid-file task offsets): workers PULL uneven record
shares whose assignment depends on world size and timing, so a churn
schedule provably changes which rows land in which global batch (the
churn tool asserts the batch digests differ between static and churn runs) —
the scaled analogue of the reference's ResNet50-under-900s-churn accuracy
claim (README.md:144-147). On the card the model's attention runs the
flash kernels K1-K3 at head width 12 in fp32 (the width-16 body on
zero-padded copies), causal over 48 tokens.

Global sync-SGD over uneven shares rides ``make_masked_train_step`` under
DDP: each epoch the workers drain their dispatcher share into memory,
agree on the global step count through the store, and pad+mask their
tail batches. Every rank's loss is scaled by ``world * n_rank / n_global``
(the step's valid rows here and over the stage), so DDP's average of the
ranks' gradients is the gradient of the mean over exactly the valid rows
of the global batch, as the JAX step takes it over its sharded batch.

Per-incarnation markers: ``inc.<stage>.<rank>.<world>`` holding the
resume step and epoch; ``pairs.<stage>.<rank>.<epoch>`` (row -> step);
``launches.<stage>.<rank>`` (this process's kernel launches so far,
rewritten each epoch); rank 0 writes ``digest.<stage>.<epoch>`` per epoch
(sha256 over its batches of the epoch) and ``final.json`` with held-out
next-char accuracy and ``batch_digest`` (the chain of the epochs'
digests, the JAX worker's).

Environment: ``TEST_OUT_DIR``, ``TEST_DATA_DIR`` (required),
``TEST_EPOCHS`` (6), ``TEST_GLOBAL_BATCH`` (36), ``TEST_SEQ`` (48),
``TEST_EPOCH_PAUSE`` (0 s after each epoch's checkpoint: the churn tool's
``--pause``, which the JAX worker leaves unread, stretches each epoch by
the same wall time whatever the device's speed, so a churn schedule
lands between epochs of every stage), ``EDL_CKPT_PATH``; ``--device``
(``cuda`` unless ``cpu`` is named).
"""

import argparse
import hashlib
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

MODEL = dict(vocab_size=256, d_model=48, num_heads=4, num_layers=2,
             d_ff=128)


def row_to_tokens(record: bytes, seq: int):
    import numpy as np

    t = np.frombuffer(record[: seq + 1], dtype=np.uint8)
    if len(t) < seq + 1:
        t = np.pad(t, (0, seq + 1 - len(t)))
    return t.astype(np.int32)


def padded(rows, s: int, local_batch: int, seq: int):
    """Step ``s``'s chunk of ``rows`` padded to ``local_batch`` rows:
    ``(tokens [local_batch, seq + 1], mask, chunk)``."""
    import numpy as np

    chunk = rows[s * local_batch: (s + 1) * local_batch]
    mask = np.zeros((local_batch,), bool)
    mask[: len(chunk)] = True
    filled = list(chunk)
    while len(filled) < local_batch:
        filled.append(np.zeros(seq + 1, np.int32))
    return np.stack(filled), mask, chunk


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    out = os.environ["TEST_OUT_DIR"]
    data_dir = os.environ["TEST_DATA_DIR"]
    epochs = int(os.environ.get("TEST_EPOCHS", "6"))
    global_batch = int(os.environ.get("TEST_GLOBAL_BATCH", "36"))
    seq = int(os.environ.get("TEST_SEQ", "48"))
    pause = float(os.environ.get("TEST_EPOCH_PAUSE", "0"))

    import torch
    import torch.distributed as dist

    from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
    from edl_tpu_torch.cluster.job_env import WorkerEnv
    from edl_tpu_torch.data import (
        DataCheckpoint,
        DataDispatcher,
        DispatcherClient,
        ElasticDataLoader,
        TxtFileSplitter,
        discover_dispatcher,
        publish_dispatcher,
    )
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.models import TransformerLM
    from edl_tpu_torch.parallel import data_parallel, make_mesh
    from edl_tpu_torch.store import StoreClient
    from edl_tpu_torch.train import (
        adamw,
        create_state,
        cross_entropy_loss,
        init,
        make_masked_eval_step,
        make_masked_train_step,
        worker_barrier,
    )

    pre = WorkerEnv()
    env = init(device=args.device)
    world = max(env.world_size, 1)
    rank = env.global_rank
    stage = pre.stage or "solo"
    assert global_batch % world == 0, (global_batch, world)
    local_batch = global_batch // world

    store = StoreClient(env.store_endpoint)
    registry = Registry(store, env.job_id or "convlm")

    # -- data plane: rank 0 hosts the dispatcher, everyone pulls ----------
    train_files = sorted(
        os.path.join(data_dir, f)
        for f in os.listdir(data_dir)
        if f.startswith("part-")
    )
    dispatcher = leader_client = None
    if env.is_rank0:
        dispatcher = DataDispatcher(registry=registry).start()
        leader_client = DispatcherClient(dispatcher.endpoint, "leader")
        if leader_client.state()["files"] == 0:
            leader_client.add_dataset(train_files)
        publish_dispatcher(registry, dispatcher.endpoint, ttl=2.0)
        endpoint = dispatcher.endpoint
    else:
        # liveness-probed: a dead stage's endpoint may linger until its
        # lease expires, and adopting it would crash-loop this stage
        endpoint = discover_dispatcher(registry, timeout=60.0)

    # -- model, data parallel over the stage --------------------------------
    mesh = make_mesh({"dp": -1}, device=args.device)
    dev = mesh.device
    model = TransformerLM(dtype=torch.float32, device=dev, **MODEL)
    # seed 0 on every rank (DDP also broadcasts rank 0's parameters)
    state = create_state(model, 0, adamw(3e-3), device=dev)
    state.apply_fn = data_parallel(state.apply_fn, mesh)
    scale = [1.0]  # this rank's share of the step's valid rows, see above

    def scaled_loss(logits, labels):
        loss, metrics = cross_entropy_loss(logits, labels)
        return loss * scale[0], metrics

    tstep = make_masked_train_step(scaled_loss)
    estep = make_masked_eval_step(cross_entropy_loss)

    mgr = CheckpointManager(os.environ["EDL_CKPT_PATH"], max_to_keep=2)
    client = DispatcherClient(endpoint, "worker-%d-%s" % (
        rank, env.pod_id or "solo"))
    loader = ElasticDataLoader(client, TxtFileSplitter())

    start_epoch = 0
    state_r, status = mgr.restore(state)
    if status is not None:
        state = state_r
        start_epoch = status.epoch
        if env.is_rank0:
            dc = DataCheckpoint.from_dict(status.meta.get("data", {}))
            leader_client.set_progress(dc.epoch, dc.offsets,
                                       sorted(dc.done_files))
    elif env.is_rank0:
        # NO checkpoint but a RECOVERED dispatcher (kill before the first
        # save): the model restarts from scratch, so the data must too —
        # leaving the dispatcher mid-epoch 0 would hide the already-
        # consumed rows from the fresh model
        leader_client.set_progress(0, {}, [])
    worker_barrier("data-ready")

    marker = "inc.%s.%d.%d" % (stage, rank, world)
    with open(os.path.join(out, marker), "w") as f:
        f.write(json.dumps({"resume_step": int(state.step),
                            "resume_epoch": start_epoch}))

    def write_launches():
        from edl_tpu_torch.ops.attention import launch_counts

        with open(os.path.join(out, "launches.%s.%d" % (stage, rank)),
                  "w") as f:
            json.dump(launch_counts(), f)

    def agree_counts(epoch: int, n_rows: int) -> list:
        """Every rank publishes its row count for this (stage, epoch) and
        reads all of them: the counts, by rank. Every process then runs
        the same number of collective steps even with uneven shares."""
        svc = "convsteps/%s:%d" % (stage, epoch)
        registry.register(svc, str(rank), str(n_rows).encode(), ttl=120.0)
        deadline = time.time() + 120
        while time.time() < deadline:
            entries = registry.get_service(svc)
            if len(entries) >= world:
                by_rank = {int(e.name): int(e.value.decode())
                           for e in entries}
                return [by_rank[r] for r in sorted(by_rank)]
            time.sleep(0.1)
        raise RuntimeError("step agreement timed out")

    def steps_of(counts):
        return max(math.ceil(c / max(local_batch, 1)) for c in counts)

    def valid(counts, s):
        return [min(max(c - s * local_batch, 0), local_batch) for c in counts]

    def to_device(t, mask):
        x = torch.from_numpy(t).to(dev, torch.int64)
        return (x[:, :-1], x[:, 1:]), torch.from_numpy(mask).to(dev)

    digest_all = hashlib.sha256()
    start_epoch = client.state()["epoch"]  # a recovered dispatcher may be mid-epoch
    if status is not None and status.epoch >= epochs:
        # a stage that restores the last epoch's checkpoint (a resize
        # landed between it and the job's end) has no epoch left: the
        # dispatcher still reads the last epoch, every file done, and
        # another save at the same step would find the version there
        start_epoch = epochs
    for epoch in range(start_epoch, epochs):
        rows = [row_to_tokens(rec, seq) for _f, _r, rec in loader.epoch()]
        counts = agree_counts(epoch, len(rows))
        steps = steps_of(counts)
        epoch_digest = hashlib.sha256()
        # row->global-step assignment in a world- and stage-independent
        # form: "<epoch> <rowhash> <step>" lines. The churn tool compares the
        # sorted union across ranks/stages between the static and churn
        # runs — equal multisets would mean churn did NOT perturb which
        # rows shared a batch; different ones are the perturbation proof.
        pair_lines = []
        metrics = None
        for s in range(steps):
            t, mask, chunk = padded(rows, s, local_batch, seq)
            for row in chunk:
                pair_lines.append(
                    "%d %s %d"
                    % (epoch,
                       hashlib.sha256(row.tobytes()).hexdigest()[:12], s)
                )
            epoch_digest.update(t.tobytes())
            n = valid(counts, s)
            scale[0] = world * n[rank] / max(sum(n), 1)
            batch, mask_dev = to_device(t, mask)
            state, metrics, _n = tstep(state, batch, mask_dev)
        if metrics is not None:
            float(metrics["loss"])  # the epoch's steps have run
        digest_all.update(epoch_digest.digest())
        with open(os.path.join(out, "pairs.%s.%d.%d" % (
                stage, rank, epoch)), "w") as f:
            f.write("\n".join(pair_lines))
        if env.is_rank0:
            with open(os.path.join(out, "digest.%s.%d" % (stage, epoch)),
                      "w") as f:
                f.write(epoch_digest.hexdigest())
        write_launches()
        # drain BEFORE the leader refills, or a straggler steals tasks
        worker_barrier("epoch-done-%d" % epoch)
        if env.is_rank0 and epoch + 1 < epochs:
            leader_client.new_epoch(epoch + 1)
        prog = None
        if env.is_rank0:
            prog = leader_client.progress()
        dc = DataCheckpoint(
            epoch=prog["epoch"] if prog else epoch + 1,
            offsets=prog["offsets"] if prog else {},
            done_files=prog["done"] if prog else [],
        )
        mgr.save(
            state,
            TrainStatus(
                epoch=epoch + 1, step=int(state.step), world_size=world,
                meta={"data": dc.to_dict()},
            ),
            step=int(state.step),
        )
        mgr.wait()
        worker_barrier("epoch-advanced-%d" % epoch)
        if pause:
            time.sleep(pause)

    # -- held-out eval: every rank covers eval rows [rank::world] ----------
    with open(os.path.join(data_dir, "heldout.txt"), "rb") as f:
        eval_rows = [
            row_to_tokens(line, seq) for line in f.read().splitlines()
            if len(line) >= seq + 1
        ]
    mine = eval_rows[rank::world]
    esteps = steps_of(agree_counts(10_000, len(mine)))
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    for s in range(esteps):
        t, mask, _chunk = padded(mine, s, local_batch, seq)
        batch, mask_dev = to_device(t, mask)
        m, n_valid = estep(state, batch, mask_dev)
        n_valid = n_valid.double()
        sums += torch.stack([m["loss"].double() * n_valid,
                             m["accuracy"].double() * n_valid, n_valid])
    if world > 1:
        dist.all_reduce(sums)  # the sums over every rank's rows
    loss_sum, acc_sum, n_sum = sums.tolist()
    write_launches()
    if env.is_rank0:
        with open(os.path.join(out, "final.json"), "w") as f:
            json.dump(
                {
                    "test_accuracy": acc_sum / max(n_sum, 1.0),
                    "test_loss": loss_sum / max(n_sum, 1.0),
                    "eval_rows": int(n_sum),
                    "steps": int(state.step),
                    "epochs": epochs,
                    "world_at_finish": world,
                    "batch_digest": digest_all.hexdigest(),
                },
                f,
            )

    mgr.close()
    client.close()
    if leader_client is not None:
        leader_client.close()
    if dispatcher is not None:
        dispatcher.stop()
    store.close()


if __name__ == "__main__":
    main()
