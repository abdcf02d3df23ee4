"""ElasticTrainer worker of the port for the launcher drills of
``test_torch_launch.py``: hot restage, drain and the launcher's key set.

Trains a tiny TransformerLM on the CPU through ``ElasticTrainer`` with
per-epoch checkpoints. Each rank trains its slice of one seeded global
batch a step, so the losses of a stage do not depend on how the global
batch is split. The hold points of ``edl_tpu_torch.chaos.drill`` make a
drill's schedule deterministic:

- ``TEST_HOLD_EPOCHS`` (comma list): the first stage to reach epoch ``e``
  holds there until the job's drain token moves past its stage;
- ``TEST_DRAIN_EPOCH``: once the first step of that epoch has run, the
  first stage there holds until its pod's preemption notice is in the
  store.

``TEST_FSDP=1`` trains with ``fsdp=True`` (``{"dp": 1, "fsdp": -1}``):
every rank of the stage takes the whole global batch.

It writes ``loss.<epoch>.<stage>.<rank>``, ``pid.<stage>.<rank>`` and, at
the end, ``done.<stage>.<rank>`` (the final step) into ``TEST_OUT_DIR``,
and its hot restages into ``restages.<pid>``. With ``TEST_RECORD_CACHE=1``
it also writes ``cache.<stage>.<rank>`` when its data is first asked for
(before its first step): the compile cache dir's entries and their
sha256, ``EDL_CACHE_PULLED``, the bytes the exchange pulled into this
process, its steps so far and any JAX module it loaded.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch

from edl_tpu_torch.chaos import drill
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.train import ElasticTrainer, adamw, cross_entropy_loss
from edl_tpu_torch.train import context
from edl_tpu_torch.train import loop as train_loop

OUT = os.environ["TEST_OUT_DIR"]
HOLDS = {int(e) for e in os.environ.get("TEST_HOLD_EPOCHS", "").split(",") if e}
DRAIN_EPOCH = int(os.environ.get("TEST_DRAIN_EPOCH", "-1"))
EPOCHS = int(os.environ.get("TEST_EPOCHS", "4"))
FSDP = os.environ.get("TEST_FSDP") == "1"
BATCHES, GLOBAL, SEQ, VOCAB = 3, 8, 16, 64
SETTLE = 1.0  # after a hold: the trainer's own watch sees the change too
STEPS = drill.count_steps(train_loop)  # train steps this process has run


def _write(name, text):
    with open(os.path.join(OUT, name), "w") as fh:
        fh.write(text)


def _record_cache(env):
    from edl_tpu_torch.train import aot

    cache = os.environ.get("EDL_COMPILE_CACHE_DIR", "")
    entries = {}
    if cache and os.path.isdir(cache):
        for name in sorted(os.listdir(cache)):
            with open(os.path.join(cache, name), "rb") as fh:
                entries[name] = hashlib.sha256(fh.read()).hexdigest()
    _write("cache.%s.%d" % (env.stage, env.global_rank), json.dumps({
        "pid": os.getpid(), "cache_dir": cache, "entries": entries,
        "pulled_env": os.environ.get("EDL_CACHE_PULLED", ""),
        "rx_bytes": aot._M_XCHG_BYTES.value(dir="rx"), "steps": STEPS[0],
        "leaked": sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "optax", "edl_tpu")),
    }))


_recorded = []


def data_fn(epoch):
    env = context.current_env()
    if os.environ.get("TEST_RECORD_CACHE") == "1" and not _recorded:
        _recorded.append(epoch)
        _record_cache(env)
    if epoch in HOLDS:
        drill.hold_at_epoch(OUT, epoch, SETTLE)
    base = STEPS[0]
    rng = np.random.RandomState(100 + epoch)
    rows = GLOBAL // trainer.mesh.dp_size
    lo = trainer.mesh.dp_rank * rows
    for i in range(BATCHES):
        tok = rng.randint(0, VOCAB, (GLOBAL, SEQ + 1)).astype(np.int64)
        yield tok[lo:lo + rows, :-1], tok[lo:lo + rows, 1:]
        if epoch == DRAIN_EPOCH and i == 0:
            drill.hold_for_notice(OUT, STEPS, base, SETTLE, 60.0)


def on_epoch_end(epoch, metrics):
    drill.write_loss(OUT, epoch, metrics["loss"])


env = context.current_env()
_write("pid.%s.%d" % (env.stage, env.global_rank), str(os.getpid()))
trainer = ElasticTrainer(
    TransformerLM(vocab_size=VOCAB, d_model=32, num_heads=2, num_layers=1,
                  d_ff=64, dtype=torch.float32, device="cpu"),
    adamw(1e-3),
    cross_entropy_loss,
    ckpt_dir=os.environ["EDL_CKPT_PATH"],
    fsdp=FSDP,
    log=True,
    device="cpu",
)
try:
    state = trainer.fit(data_fn, epochs=EPOCHS, on_epoch_end=on_epoch_end)
finally:
    if trainer.restages:
        _write("restages.%d" % os.getpid(), json.dumps(trainer.restages))
env = context.current_env()
_write("done.%s.%d" % (env.stage, env.global_rank), str(int(state.step)))
