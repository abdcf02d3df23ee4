"""LM training over the elastic data layer: dispatcher + exact resume.

The port of ``examples/elastic_text_lm.py``: rank 0 hosts the data
dispatcher and publishes its endpoint in the store; every worker streams
its share of the file list through ``ElasticDataLoader``, packing text
lines into fixed-shape token batches. A worker that dies mid-file times
out and its task is re-dispatched to a survivor *at the exact record
offset*; a joining worker starts pulling tasks immediately — no global
re-shard, no repeated or dropped records. Each worker trains its own
replica of the model (no gradient exchange), as the JAX example does.

The model is the JAX example's at its full width (byte vocabulary 256,
d_model 64, 4 heads, 2 layers, d_ff 256, fp32) with AdamW(1e-3); on the
card its attention runs the flash kernels K1-K3 (head width 16, fp32,
causal over the 63-token inputs).

Under the port's launcher, from the repo root::

    python -m edl_tpu_torch.store.server --port 2379 &
    PYTHONPATH=. python -m edl_tpu_torch.launch --job_id lm \\
        --store 127.0.0.1:2379 --nodes_range 1:4 \\
        edl_tpu_torch/examples/elastic_text_lm.py --data_dir corpus/

Standalone (single process, synthetic corpus)::

    python -m edl_tpu_torch.examples.elastic_text_lm [--device cpu]

``--ckpt_dir`` (one worker) saves the model and the dispatcher's progress
in one checkpoint every epoch and rewinds both on a restart.
``--params F.npz`` starts from converted weights (``convert.save_npz`` of
a flax tree, e.g. the JAX example's ``PRNGKey(0)`` draw) instead of the
draw from a generator seeded with 0.
"""

import argparse
import hashlib
import os
import tempfile

import numpy as np

VOCAB = 256  # byte-level tokens
MODEL = dict(vocab_size=VOCAB, d_model=64, num_heads=4, num_layers=2,
             d_ff=256)


def ensure_corpus(data_dir, files=4, lines_per_file=200):
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(files):
        path = os.path.join(data_dir, "part-%02d.txt" % i)
        if not os.path.exists(path):
            with open(path, "w") as f:
                for j in range(lines_per_file):
                    f.write("file %d line %d: the quick brown fox\n" % (i, j))
        paths.append(path)
    return paths


def token_batches(loader, batch, seq):
    """Pack byte-tokenized records into fixed [batch, seq] arrays (ragged
    tail dropped — static shapes)."""
    buf = []
    for _file_idx, _rec_idx, record in loader.epoch():
        tokens = np.frombuffer(record[:seq], dtype=np.uint8)
        if len(tokens) < seq:
            tokens = np.pad(tokens, (0, seq - len(tokens)))
        buf.append(tokens.astype(np.int32))
        if len(buf) == batch:
            yield np.stack(buf)
            buf = []


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", default=None)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq", type=int, default=64)
    parser.add_argument(
        "--ckpt_dir", default=None,
        help="rank 0 checkpoints model + dispatcher progress together "
        "each epoch and rewinds both on restart (one worker only)",
    )
    parser.add_argument("--params", default=None,
                        help="start from these weights (convert.save_npz)")
    parser.add_argument("--report_every", type=int, default=256,
                        help="records between the loader's progress reports")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def run(args) -> dict:
    """The example's whole flow; returns what it trained and read:
    ``state``, ``losses`` and ``batches`` by epoch, the data ``digest``
    and each epoch's ``epoch_digests``, the ``rank`` and the epoch it
    started from."""
    import torch

    from edl_tpu_torch import convert
    from edl_tpu_torch.data import (
        DataDispatcher,
        DispatcherClient,
        ElasticDataLoader,
        TxtFileSplitter,
        discover_dispatcher,
        publish_dispatcher,
    )
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.models import TransformerLM
    from edl_tpu_torch.store import StoreClient
    from edl_tpu_torch.train import (
        adamw,
        create_state,
        cross_entropy_loss,
        init,
        make_train_step,
        worker_barrier,
    )
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    env = init(device=args.device)
    data_dir = args.data_dir or os.path.join(
        tempfile.gettempdir(), "elastic_lm_corpus"
    )
    files = ensure_corpus(data_dir)

    dispatcher = None
    leader_client = None
    store = registry = None
    if env.store_endpoint:
        store = StoreClient(env.store_endpoint)
        registry = Registry(store, env.job_id or "lm")
    if env.is_rank0:
        # registry-backed: snapshot per mutation, recover on restart — a
        # re-elected leader resumes the epoch at the exact task offsets
        dispatcher = DataDispatcher(registry=registry).start()
        leader_client = DispatcherClient(dispatcher.endpoint, "leader")
        if leader_client.state()["files"] == 0:  # fresh job, not a recovery
            leader_client.add_dataset(files)
        if registry is not None:
            publish_dispatcher(registry, dispatcher.endpoint, ttl=5.0)
        endpoint = dispatcher.endpoint
    else:
        # liveness-probed: a dead stage's endpoint may linger until its
        # lease expires (see edl_tpu_torch.data.discover_dispatcher)
        endpoint = discover_dispatcher(registry, timeout=60.0)

    mgr = None
    if args.ckpt_dir and env.is_rank0:
        if env.world_size > 1:
            # the example trains per-worker replicas, and the checkpoint
            # manager's saves are collective over the stage's group
            print("--ckpt_dir supported for single-worker runs only; skipping")
        else:
            from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
            from edl_tpu_torch.data import DataCheckpoint

            mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2)

    worker_barrier("data-ready")

    model = TransformerLM(dtype=torch.float32, device=dev, **MODEL)
    if args.params:
        convert.load_params(model, convert.load_npz(args.params))
        rng = None  # keep the converted weights
    else:
        # seed 0, as the JAX example's PRNGKey(0) (another draw: --params
        # carries that one over)
        rng = torch.Generator(device=dev).manual_seed(0)
    state = create_state(model, rng, adamw(1e-3), device=dev)

    def lm_loss(logits, labels):
        return cross_entropy_loss(
            logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)
        )

    step = make_train_step(lm_loss)
    client = DispatcherClient(
        endpoint, "worker-%d-%s" % (env.global_rank, env.pod_id or "solo")
    )
    loader = ElasticDataLoader(client, TxtFileSplitter(),
                               report_every=args.report_every)

    if mgr is not None:
        state_r, status = mgr.restore(state)
        if status is not None:
            # one atomic restore covers model AND data position; rewinding
            # the dispatcher keeps them consistent (stop-resume exactness)
            state = state_r
            dc = DataCheckpoint.from_dict(status.meta.get("data", {}))
            leader_client.set_progress(
                dc.epoch, dc.offsets, sorted(dc.done_files)
            )
            print("rank 0 resumed from step %d epoch %d"
                  % (status.step, status.epoch))
        else:
            # recovered dispatcher but NO checkpoint (died before the
            # first save): model restarts from scratch, so rewind the
            # data to scratch too — consistency cuts both ways
            leader_client.set_progress(0, {}, [])

    # a recovered dispatcher may already be mid-epoch N: rejoin it there
    start_epoch = client.state()["epoch"]
    digest = hashlib.sha256()
    out = {"rank": env.global_rank, "start_epoch": start_epoch,
           "losses": {}, "batches": {}, "epoch_digests": {}}
    for epoch in range(start_epoch, args.epochs):
        n = 0
        metrics = None
        epoch_digest = hashlib.sha256()
        for batch_tokens in token_batches(loader, args.batch, args.seq):
            digest.update(batch_tokens.tobytes())
            epoch_digest.update(batch_tokens.tobytes())
            x = torch.from_numpy(batch_tokens).to(dev, torch.int64)
            # next-token targets without the roll-around on the last column
            state, metrics = step(state, (x[:, :-1], x[:, 1:]))
            n += 1
        out["batches"][epoch] = n
        out["epoch_digests"][epoch] = epoch_digest.hexdigest()[:12]
        if metrics is not None:
            out["losses"][epoch] = float(metrics["loss"])
            print(
                "rank %d epoch %d: %d batches, loss %.4f"
                % (env.global_rank, epoch, n, out["losses"][epoch])
            )
        # everyone must be drained BEFORE the leader refills the queues,
        # or a straggler would steal next epoch's tasks into this one
        worker_barrier("epoch-done-%d" % epoch)
        if env.is_rank0 and epoch + 1 < args.epochs:
            leader_client.new_epoch(epoch + 1)
        if mgr is not None:
            prog = leader_client.progress()
            dc = DataCheckpoint(
                epoch=prog["epoch"], offsets=prog["offsets"],
                done_files=prog["done"],
            )
            mgr.save(
                state,
                TrainStatus(
                    epoch=epoch + 1, step=int(state.step),
                    world_size=env.world_size,
                    meta={"data": dc.to_dict()},
                ),
                step=int(state.step),
            )
            mgr.wait()
        worker_barrier("epoch-advanced-%d" % epoch)
    out["digest"] = digest.hexdigest()[:12]
    print("rank %d data digest %s" % (env.global_rank, out["digest"]))

    if mgr is not None:
        mgr.close()
    client.close()
    if leader_client is not None:
        leader_client.close()
    if dispatcher is not None:
        dispatcher.stop()
    if store is not None:
        store.close()
    out["state"] = state
    return out


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
