"""One rank of an FSDP test stage of the port, on the CPU (gloo).

    python tests/torch_fsdp_worker.py CONFIG.json RANK

Every op but ``dump`` runs with DTensor's redistribution refused: the
port's path never redistributes a DTensor (gloo does not carry DTensor's
collectives for tensors on the card), and this holds it to that on the
CPU too.

``CONFIG.json`` holds ``world``, ``port``, ``axes`` (the mesh; default
``{"dp": 1, "fsdp": -1}``), ``group`` (join a process group even at world
1: a one-rank FSDP stage), ``env`` (one dict of environment variables per
rank, applied first) and ``ops``, run in order by every rank:

- ``{"op": "build", "model": "resnet"|"lm", "weights": NPZ|null,
  "seed": int, "shard": bool, "ddp": bool}``: the small ResNet-vd
  (``stage_sizes=(1, 1)``, width 8, 10 classes, fp32) or the 2-layer
  TransformerLM of ``test_torch_elastic.py``, from converted weights or
  ``init_weights(seed)``, sharded by ``shard_params_fsdp`` or wrapped by
  ``data_parallel``; SGD 0.1 momentum 0.9 (ResNet) or AdamW 1e-3 (LM);
- ``{"op": "steps", "data": NPZ, "n": int, "numerics": bool}``: ``n``
  steps on batches ``x<i>``/``y<i>``, this rank's ``dp`` rows of each,
  the first under ``obs.profile.CostCounter`` (its FLOPs: ``flops``);
- ``{"op": "save", "dir": DIR, "step": int, "async": bool}`` and
  ``{"op": "restore", "dir": DIR}``: ``CheckpointManager`` (its local tier
  from ``EDL_CKPT_LOCAL_DIR`` when the env sets it); a save is waited for
  and, with a local tier, pushed to the peer holders;
- ``{"op": "dump", "out": NPZ}``: rank 0 writes the gathered state
  (``model/<name>``, ``optim/<name>/<slot>``), every step's global loss
  (``loss``), the numerics bundles (``bundle/<key>``), the restored step
  and this rank's state bytes (``state_bytes``, per rank).
"""

import contextlib
import json
import os
import sys

cfg = json.load(open(sys.argv[1]))
RANK = int(sys.argv[2])
os.environ.update((cfg.get("env") or [{}] * cfg["world"])[RANK])

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

WORLD = cfg["world"]
if WORLD > 1 or cfg.get("group"):
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d"
                            % cfg["port"], world_size=WORLD, rank=RANK)

from torch.distributed.checkpoint.state_dict import (  # noqa: E402
    StateDictOptions, get_state_dict)

from edl_tpu_torch import convert  # noqa: E402
from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus  # noqa: E402
from edl_tpu_torch.models.resnet import ResNet  # noqa: E402
from edl_tpu_torch.models.transformer import TransformerLM  # noqa: E402
from edl_tpu_torch.obs import memory  # noqa: E402
from edl_tpu_torch.obs import numerics  # noqa: E402
from edl_tpu_torch.obs import profile  # noqa: E402
from edl_tpu_torch.parallel import (  # noqa: E402
    data_parallel, make_mesh, shard_params_fsdp)
from edl_tpu_torch.train import (  # noqa: E402
    adamw, create_state, cross_entropy_loss, make_train_step, sgd)

LM = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2, d_ff=128)

from torch.distributed.tensor import _dispatch  # noqa: E402

_redistribute = _dispatch.redistribute_local_tensor


def _refused(*args, **kwargs):
    raise RuntimeError("a DTensor was redistributed on the port's path")

mesh = make_mesh(cfg.get("axes") or {"dp": 1, "fsdp": -1}, device="cpu")
state = None
losses, bundles, restored, flops = [], [], -1, 0.0
for op in cfg["ops"]:
    kind = op["op"]
    _dispatch.redistribute_local_tensor = \
        _redistribute if kind == "dump" else _refused
    if kind == "build":
        if op["model"] == "resnet":
            model = ResNet((1, 1), width=8, num_classes=10,
                           dtype=torch.float32)
            tx = sgd(0.1, momentum=0.9)
        else:
            model = TransformerLM(dtype=torch.float32, device="cpu", **LM)
            tx = adamw(1e-3)
        if op.get("weights"):
            convert.load_params(model, op["weights"])
        if op.get("shard"):
            shard_params_fsdp(mesh, model)
        state = create_state(model, op.get("seed"), tx, device="cpu")
        if op.get("ddp"):
            state.apply_fn = data_parallel(state.apply_fn, mesh)
    elif kind == "steps":
        kwargs = {"train": True} if op.get("model", "resnet") == "resnet" \
            else None
        step = make_train_step(cross_entropy_loss, kwargs,
                               numerics=op.get("numerics", False))
        data = np.load(op["data"])
        for i in range(op["n"]):
            x, y = data["x%d" % i], data["y%d" % i]
            rows = x.shape[0] // mesh.dp_size
            sl = slice(mesh.dp_rank * rows, (mesh.dp_rank + 1) * rows)
            counter = profile.CostCounter() if i == 0 else \
                contextlib.nullcontext()
            with counter:
                state, m = step(state, (torch.from_numpy(x[sl]),
                                        torch.from_numpy(y[sl]).long()))
            if i == 0:
                flops = counter.cost.get("flops", 0.0)
            bundle = m.pop(numerics.METRICS_KEY, None)
            loss = m["loss"].reshape(1).clone()
            if dist.is_initialized():
                dist.all_reduce(loss)  # the ranks of an fsdp group agree
                loss /= dist.get_world_size()
            losses.append(float(loss))
            if bundle is not None:
                bundles.append({k: np.asarray(v.tolist()) for k, v in
                                bundle.items()})
    elif kind == "save":
        with CheckpointManager(op["dir"], async_save=op.get("async", False)
                               ) as mngr:
            mngr.save(state, TrainStatus(epoch=0, step=op["step"]))
            mngr.wait()
            if mngr._replicator is not None:
                assert mngr._replicator.flush(30.0)
    elif kind == "restore":
        with CheckpointManager(op["dir"]) as mngr:
            state, status = mngr.restore(state)
        restored = -1 if status is None else status.step
    elif kind == "dump":
        opts = StateDictOptions(full_state_dict=True)
        model_sd, optim_sd = get_state_dict(
            state.apply_fn, state.opt_state.optimizer, options=opts)
        nbytes = torch.tensor([memory.state_bytes(state)], dtype=torch.float64)
        gathered = [torch.zeros_like(nbytes) for _ in range(WORLD)]
        if dist.is_initialized():
            dist.all_gather(gathered, nbytes)
        else:
            gathered = [nbytes]
        if RANK == 0:
            out = {"model/" + k: v.detach().numpy()
                   for k, v in model_sd.items()}
            for name, slots in optim_sd["state"].items():
                for slot, v in slots.items():
                    if torch.is_tensor(v) and v.dim():
                        out["optim/%s/%s" % (name, slot)] = v.numpy()
            out["loss"] = np.asarray(losses)
            out["restored"] = np.asarray(restored)
            out["flops"] = np.asarray(flops)
            out["state_bytes"] = torch.cat(gathered).numpy()
            out["sharded"] = np.asarray(any(
                type(p).__name__ == "DTensor"
                for p in state.apply_fn.parameters()))
            for key in (bundles[0] if bundles else {}):
                out["bundle/" + key] = np.stack([b[key] for b in bundles])
            np.savez(op["out"], **out)
if dist.is_initialized():
    dist.barrier()
    dist.destroy_process_group()
