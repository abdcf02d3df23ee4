"""CTR training: DeepFM with mesh-sharded embedding tables and the streaming
AUC, the port of ``examples/ctr_train.py``.

Synthetic Criteo-shaped data (26 sparse fields, 13 dense) with learnable
structure: the label depends on a few 'strong' feature ids and on the
first dense feature, so the AUC rises. The tables' vocab shards over the
``mp`` axis when the stage has an even number of ranks above one
(``{"dp": -1, "mp": 2}``); the ranks of an ``mp`` group draw the same
rows (their data is seeded by ``dp`` index). The train AUC comes from the
step's own logits, merged over ``dp``.

Elastic run on the port's control plane::

    python -m edl_tpu_torch.store.server --port 2379 &
    python -m edl_tpu_torch.launch --job_id ctr --store 127.0.0.1:2379 \\
        edl_tpu_torch/examples/ctr_train.py

``--device cpu`` runs it on the CPU (gloo); by default it runs on the card
and raises without one.
"""

import argparse

import torch

FIELDS, DENSE = 26, 13


def synthetic_batch(gen: torch.Generator, batch: int, vocab: int, device):
    """Criteo-shaped synthetic click data: the label's logit is ``3 ·
    (share of fields whose id is a multiple of 7) + 0.5 · dense[:, 0] -
    1``, as in the JAX example."""
    sparse = torch.randint(0, vocab, (batch, FIELDS), generator=gen,
                           device=device)
    dense = torch.randn(batch, DENSE, generator=gen, device=device)
    signal = (sparse % 7 == 0).float().mean(dim=1)
    logit = 3.0 * signal + 0.5 * dense[:, 0] - 1.0
    u = torch.rand(batch, generator=gen, device=device)
    labels = (u < torch.sigmoid(logit)).to(torch.int32)
    return (sparse, dense), labels


def global_auc(auc_state, mesh) -> float:
    """The AUC of every ``dp`` rank's histograms summed (the ``mp`` ranks
    of a group saw the same rows)."""
    from edl_tpu_torch.parallel.collectives import all_reduce_
    from edl_tpu_torch.train import AUCState, auc_compute

    group = mesh.group("dp") if mesh.dp_size > 1 else None
    merged = AUCState(*(all_reduce_(t.clone(), group) for t in auc_state))
    return float(auc_compute(merged))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--vocab", type=int, default=100_000)
    parser.add_argument("--embed_dim", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from edl_tpu_torch.models import (
        CTR_EMBEDDING_RULES,
        DeepFM,
        binary_cross_entropy_loss,
    )
    from edl_tpu_torch.parallel import make_mesh, shard_params_by_rules
    from edl_tpu_torch.train import (
        adam,
        auc_init,
        auc_update,
        create_state,
        init,
        make_train_step,
    )
    from edl_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    env = init(device=args.device)
    n = env.world_size
    # dp for the batch; mp shards the embedding vocab when >1 rank
    mp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh({"dp": -1, "mp": mp}, device=args.device)
    model = DeepFM(vocab_size=args.vocab, embed_dim=args.embed_dim,
                   num_fields=FIELDS, dense_features=DENSE, device=mesh.device)
    state = create_state(model, 0, adam(1e-3), device=mesh.device)
    shard_params_by_rules(mesh, model, CTR_EMBEDDING_RULES)

    # the loss head also surfaces the step's logits, so the train AUC
    # reuses the forward the gradient already paid for
    def loss_with_logits(logits, labels):
        loss, m = binary_cross_entropy_loss(logits, labels)
        return loss, {**m, "logits": logits}

    step = make_train_step(loss_with_logits)
    auc_state = auc_init(device=mesh.device)
    gen = torch.Generator(device=mesh.device).manual_seed(mesh.dp_rank)
    for i in range(args.steps):
        x, y = synthetic_batch(gen, args.batch, args.vocab, mesh.device)
        state, metrics = step(state, (x, y))
        auc_state = auc_update(auc_state, metrics.pop("logits"), y)
        if (i + 1) % 50 == 0:
            auc = global_auc(auc_state, mesh)
            if env.is_rank0:
                print("step %d loss %.4f train-auc %.4f"
                      % (i + 1, float(metrics["loss"]), auc), flush=True)
    auc = global_auc(auc_state, mesh)
    if env.is_rank0:
        print("final train-auc %.4f" % auc, flush=True)
    return auc


if __name__ == "__main__":
    main()
