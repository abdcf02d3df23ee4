"""One rank of a tensor- or sequence-parallel test stage of the port, on the
CPU (gloo).

    python tests/torch_lm_parallel_worker.py CONFIG.json RANK

``CONFIG.json`` holds ``world``, ``port``, ``axes`` (the mesh) and ``ops``,
run in order by every rank; an op with its own ``axes`` runs on that mesh
(its groups built then, by every rank):

- ``{"op": "tp_steps", "weights": NPZ, "cfg": {...}, "data": NPZ,
  "steps": n, "lr": x, "wd": x, "out": NPZ}``: the fp32 TransformerLM of
  ``cfg`` from converted weights, sharded by ``TRANSFORMER_TP_RULES``,
  ``n`` AdamW steps on ``x``/``y`` (every rank the whole batch: dp 1);
  rank 0 writes every step's loss (``loss``) and the gathered parameters
  (``param/<state_dict name>``);
- ``{"op": "generate", "weights": NPZ, "cfg": {...}, "data": NPZ,
  "new": n, "out": NPZ}``: the same model's logits on ``prompt`` and
  ``greedy_generate``'s tokens; every rank writes ``out`` with
  ``.<rank>`` before the suffix (its cache after the prefill included);
- ``{"op": "attn", "kind": "ring"|"ulysses", "data": NPZ, "cases": [...],
  "out": NPZ}``: for each case name, the global ``q``/``k``/``v``/``g``
  ``<case>/q`` ... of ``data``, this rank's sequence shard through
  ``ring_attention_sharded`` / ``ulysses_attention_sharded`` (causal as
  ``<case>/causal``) and its backward with ``g``'s shard; every rank
  writes its shards of ``o``, ``dq``, ``dk``, ``dv`` per case;
- ``{"op": "ulysses_errors", "out": JSON}``: the messages of Ulysses'
  ``H % sp`` and kv-divisibility errors;
- ``{"op": "moe_steps", "axes": {...}, "weights": NPZ, "cfg": {...},
  "data": NPZ, "steps": n, "lr": x, "wd": x, "out": NPZ}``: the fp32 MoE
  TransformerLM of ``cfg`` from converted weights, sharded by
  ``TRANSFORMER_TP_RULES + MOE_EP_RULES`` (ring attention over ``sp``
  when the mesh has it), ``n`` AdamW steps under
  ``make_train_step(aux_losses=True)`` on this rank's block of the
  global ``x``/``y`` (its ``dp`` rows, its ``sp`` chunk with global
  positions); at ``{"dp": world}`` the model is wrapped by
  ``data_parallel`` instead (DDP). Every rank writes ``out`` with
  ``.<rank>``: its losses (``loss``), ``aux_loss``, its local ``wi``/``wo``
  shapes; rank 0 also the gathered parameters (``param/<name>``).
- ``{"op": "pp", "axes": {...}, "weights": NPZ, "cfg": {...}, "data":
  NPZ, "M": m, "run": "logits"|"gpipe"|"1f1b"|"adam", "batch_axis":
  null|"dp", "out": NPZ}``: this rank's ``LMStage`` of the fp32
  TransformerLM of ``cfg`` (its dict from ``split_lm_params`` of the
  converted weights) on the mesh ``axes`` (``pp`` first), over ``x``
  (and ``y``): ``logits`` writes ``pipeline_lm_logits``; ``gpipe`` /
  ``1f1b`` the loss of ``pipeline_lm_loss`` / ``pipeline_lm_1f1b_grads``,
  the stage's gradients (``grad/<name>``) and ``live_max``; ``adam``
  (``steps``, ``lr``) the losses of that many Adam steps over GPipe and
  the stage's parameters after them (``param/<name>``). Every rank
  writes ``out`` with ``.<rank>``.
- ``{"op": "ctr_steps", "axes": {...}, "weights": NPZ, "cfg": {...},
  "data": NPZ, "steps": n, "lr": x, "out": NPZ}``: the fp32 DeepFM of
  ``cfg`` from converted weights, its tables split over ``mp`` by
  ``CTR_EMBEDDING_RULES``, ``n`` Adam steps on this rank's ``dp`` rows
  of the global ``sparse``/``dense``/``labels``; every rank writes its
  losses and its table shapes, rank 0 the gathered parameters.
"""

import json
import os
import sys

cfg = json.load(open(sys.argv[1]))
RANK = int(sys.argv[2])

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

WORLD = cfg["world"]
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % cfg["port"],
                        world_size=WORLD, rank=RANK)

import functools  # noqa: E402

from edl_tpu_torch import convert  # noqa: E402
from edl_tpu_torch.models import (  # noqa: E402
    MOE_EP_RULES,
    TransformerLM,
    greedy_generate,
)
from edl_tpu_torch.models.decode import decode_model, init_cache  # noqa: E402
from edl_tpu_torch.parallel import (  # noqa: E402
    TRANSFORMER_TP_RULES,
    data_parallel,
    gather_params,
    lm_stage,
    make_mesh,
    pipeline_lm_1f1b_grads,
    pipeline_lm_logits,
    pipeline_lm_loss,
    ring_attention_sharded,
    seq_positions,
    shard_params_by_rules,
    shard_seq,
    split_lm_params,
    ulysses_attention,
    ulysses_attention_sharded,
)
from edl_tpu_torch.train import (  # noqa: E402
    adam,
    adamw,
    create_state,
    cross_entropy_loss,
    make_train_step,
)

mesh = make_mesh(cfg["axes"], device="cpu")


def _model(op, **kw):
    model = TransformerLM(dtype=torch.float32, device="meta", **op["cfg"],
                          **kw)
    model.to_empty(device="cpu")
    convert.load_params(model, op["weights"])
    return model


def _rank_path(path):
    root, ext = os.path.splitext(path)
    return "%s.%d%s" % (root, RANK, ext)


def tp_steps(op):
    data = np.load(op["data"])
    model = _model(op)
    state = create_state(model, None, adamw(op["lr"], weight_decay=op["wd"]),
                         device="cpu")
    shard_params_by_rules(mesh, model, TRANSFORMER_TP_RULES)

    def loss_head(logits, y):
        return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  y.reshape(-1))

    step = make_train_step(loss_head)
    batch = (torch.from_numpy(data["x"]), torch.from_numpy(data["y"]).long())
    losses = []
    for _ in range(op["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    params = gather_params(mesh, model)
    if RANK == 0:
        np.savez(op["out"], loss=np.asarray(losses),
                 **{"param/" + k: v.numpy() for k, v in params.items()})


@torch.no_grad()
def generate(op):
    data = np.load(op["data"])
    model = _model(op)
    shard_params_by_rules(mesh, model, TRANSFORMER_TP_RULES)
    prompt = torch.from_numpy(data["prompt"])
    logits = model(prompt)
    tokens = greedy_generate(model, prompt, op["new"])
    b, plen = prompt.shape
    dm = decode_model(model, plen + op["new"])
    _, cache = dm(prompt, None, init_cache(model, b, plen + op["new"]))
    np.savez(_rank_path(op["out"]), logits=logits.numpy(),
             tokens=tokens.numpy(),
             **{"cache/" + k: v.float().numpy() for k, v in cache.items()})


def attn(op):
    data = np.load(op["data"])
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[op["kind"]]
    sp, r = mesh.sp_size, mesh.sp_rank
    out = {}
    for case in op["cases"]:
        shards = []
        for name in ("q", "k", "v", "g"):
            full = torch.from_numpy(data["%s/%s" % (case, name)])
            t = full.shape[2] // sp
            shards.append(full[:, :, r * t:(r + 1) * t].clone())
        q, k, v, g = shards
        for t in (q, k, v):
            t.requires_grad_(True)
        o = fn(q, k, v, mesh, causal=bool(data["%s/causal" % case]))
        o.backward(g)
        out.update({"%s/o" % case: o.detach().numpy(),
                    "%s/dq" % case: q.grad.numpy(),
                    "%s/dk" % case: k.grad.numpy(),
                    "%s/dv" % case: v.grad.numpy()})
    np.savez(_rank_path(op["out"]), **out)


def ulysses_errors(op):
    msgs = {}
    # 3 q heads over sp 2; 3 kv heads under 4 q heads
    for name, h, h_kv in (("heads", 3, 3), ("kv", 4, 3)):
        q = torch.zeros(1, h, 4, 8)
        k = torch.zeros(1, h_kv, 4, 8)
        try:
            ulysses_attention(q, k, k, axis_name=mesh.group("sp"))
            msgs[name] = None
        except ValueError as exc:
            msgs[name] = str(exc)
    if RANK == 0:
        with open(op["out"], "w") as fh:
            json.dump(msgs, fh)


def _lm_loss(logits, y):
    return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              y.reshape(-1))


def moe_steps(op):
    mesh = make_mesh(op["axes"], device="cpu")
    data = np.load(op["data"])
    kw = {}
    if mesh.sp_size > 1:
        kw["attention_fn"] = functools.partial(ring_attention_sharded,
                                               mesh=mesh, sp_axis="sp")
    model = _model(op, **kw)
    state = create_state(model, None, adamw(op["lr"], weight_decay=op["wd"]),
                         device="cpu")
    ddp = not mesh.model_parallel and mesh.dp_size == WORLD
    if ddp:
        state.apply_fn = data_parallel(model, mesh)
    else:
        shard_params_by_rules(mesh, model,
                              TRANSFORMER_TP_RULES + MOE_EP_RULES)
    x = shard_seq(mesh, data["x"])
    y = shard_seq(mesh, data["y"]).long()
    if mesh.sp_size > 1:
        x = (x, seq_positions(mesh, x.shape[0], x.shape[1]))
    step = make_train_step(_lm_loss, aux_losses=True)
    losses, aux = [], []
    for _ in range(op["steps"]):
        state, metrics = step(state, (x, y))
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    params = ({k: v.detach() for k, v in model.named_parameters()} if ddp
              else gather_params(mesh, model))
    out = {"loss": np.asarray(losses), "aux_loss": np.asarray(aux)}
    for name, p in model.named_parameters():
        if name.endswith((".moe.wi", ".moe.wo")):
            out["shape/" + name] = np.asarray(p.shape)
    if RANK == 0:
        out.update({"param/" + k: v.numpy() for k, v in params.items()})
    np.savez(_rank_path(op["out"]), **out)


def ctr_steps(op):
    from edl_tpu_torch.models import (CTR_EMBEDDING_RULES, DeepFM,
                                      binary_cross_entropy_loss)

    mesh = make_mesh(op["axes"], device="cpu")
    data = np.load(op["data"])
    model = convert.load_params(
        DeepFM(dtype=torch.float32, device="cpu", **op["cfg"]), op["weights"])
    state = create_state(model, None, adam(op["lr"]), device="cpu")
    shard_params_by_rules(mesh, model, CTR_EMBEDDING_RULES)
    rows = data["labels"].shape[0] // mesh.dp_size
    mine = slice(mesh.dp_rank * rows, (mesh.dp_rank + 1) * rows)
    batch = ((torch.from_numpy(data["sparse"][mine]),
              torch.from_numpy(data["dense"][mine])),
             torch.from_numpy(data["labels"][mine]))
    step = make_train_step(binary_cross_entropy_loss)
    losses = []
    for _ in range(op["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    params = gather_params(mesh, model)
    out = {"loss": np.asarray(losses),
           "shape/embedding": np.asarray(model.embedding.embedding.shape),
           "shape/wide": np.asarray(model.wide.embedding.shape)}
    if RANK == 0:
        out.update({"param/" + k: v.numpy() for k, v in params.items()})
    np.savez(_rank_path(op["out"]), **out)


def pp(op):
    mesh = make_mesh(op["axes"], device="cpu")
    data = np.load(op["data"])
    model = TransformerLM(dtype=torch.float32, device="meta", **op["cfg"])
    stage = lm_stage(model, mesh)
    stage.to_empty(device="cpu")
    whole = convert.load_npz(op["weights"])
    stage.load_state_dict(
        split_lm_params(model, whole, mesh.pp_size)[mesh.pp_rank])
    x = torch.from_numpy(data["x"])
    y = torch.from_numpy(data["y"]) if "y" in data.files else None
    args = dict(num_microbatches=op["M"], batch_axis=op.get("batch_axis"))
    out, stats = {}, {}
    if op["run"] == "logits":
        out["logits"] = pipeline_lm_logits(stage, x, mesh, **args).numpy()
    elif op["run"] == "gpipe":
        out["loss"] = pipeline_lm_loss(stage, x, y, mesh, stats=stats,
                                       **args).numpy()
        grads = {n: p.grad for n, p in stage.named_parameters()}
    elif op["run"] == "1f1b":
        loss, grads = pipeline_lm_1f1b_grads(stage, x, y, mesh, stats=stats,
                                             **args)
        out["loss"] = loss.numpy()
    else:
        tx = adam(op["lr"])
        opt = tx.init(stage.parameters())
        losses = []
        for _ in range(op["steps"]):
            losses.append(float(pipeline_lm_loss(stage, x, y, mesh, **args)))
            tx.update(opt)
        out["loss"] = np.asarray(losses)
        out.update({"param/" + n: p.detach().numpy()
                    for n, p in stage.named_parameters()})
    if op["run"] in ("gpipe", "1f1b"):
        out.update({"grad/" + n: g.numpy() for n, g in grads.items()})
        out["live_max"] = np.asarray(stats["live_max"])
    np.savez(_rank_path(op["out"]), **out)


OPS = {"tp_steps": tp_steps, "generate": generate, "attn": attn,
       "ulysses_errors": ulysses_errors, "moe_steps": moe_steps, "pp": pp,
       "ctr_steps": ctr_steps}
for op in cfg["ops"]:
    OPS[op["op"]](op)
dist.barrier()
dist.destroy_process_group()
