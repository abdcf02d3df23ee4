"""The TransformerLM distillation teacher: per-token soft labels over RPC.

The port of the teacher role of ``examples/distill_nlp.py``: a
``TransformerLM`` behind ``PredictServer(TorchPredictBackend(...))``
answering ``predict({"tokens": int32 [n, T]})`` with
``{"soft_label": softmax(logits, -1)}`` as fp32 ``[n, T, vocab]``.

    python -m edl_tpu_torch.distill.nlp_teacher --config flagship --port 9000
    python -m edl_tpu_torch.distill.nlp_teacher --config small --device cpu \
        --store 127.0.0.1:2379 --job_id distill-nlp --service nlp-teacher

Configs: ``small`` is distill_nlp's teacher exactly (fp32); ``flagship``
is the LM of ``tools/lm_bench.py`` (bf16, ~215 M parameters). Weights
come from a seeded ``torch.Generator`` or, with ``--params``, from an
``.npz`` of flax param paths (:mod:`edl_tpu_torch.convert`). With
``--store`` the endpoint registers under ``--service`` in the job's
keyspace (:class:`~edl_tpu_torch.distill.discovery.TeacherRegister`:
students discover it through the balancer, and a preemption notice for
``EDL_POD_ID`` drains it); SIGTERM or SIGINT deregisters it and stops the
server. Without ``--store``, point students at the printed endpoint.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional

import torch

from edl_tpu_torch.chaos.plane import arm_from_env
from edl_tpu_torch.convert import load_params
from edl_tpu_torch.distill.discovery import TeacherRegister
from edl_tpu_torch.distill.serving import PredictServer, TorchPredictBackend
from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.utils.device import resolve_device

# model kwargs and the sequence length each config is sized for
CONFIGS = {
    # tools/lm_bench.py "flagship": d_ff = int(1024 * 8 / 3 / 128) * 128;
    # a serving teacher stores its weights in bf16 (the products are the same)
    "flagship": {
        "model": dict(vocab_size=32000, d_model=1024, num_heads=16,
                      num_layers=12, d_ff=2688, dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16),
        "seq": 2048,
    },
    # examples/distill_nlp.py build_lm(num_layers=4, d_model=128)
    "small": {
        "model": dict(vocab_size=1024, d_model=128, num_heads=4,
                      num_layers=4, d_ff=512, dtype=torch.float32),
        "seq": 64,
    },
}


def build_teacher(config: str = "flagship", device="cuda", seed: int = 0,
                  params: Optional[str] = None) -> TransformerLM:
    """The config's TransformerLM on ``device``: weights from ``params``
    (an ``.npz`` path) or seeded random."""
    dev = resolve_device(device)
    model = TransformerLM(device=dev, **CONFIGS[config]["model"])
    if params is not None:
        load_params(model, params)
    else:
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def make_apply(model: TransformerLM):
    """``feeds {"tokens": [n, T]} -> {"soft_label": fp32 [n, T, vocab]}``."""

    def apply(feeds):
        logits = model(feeds["tokens"])
        return {"soft_label": torch.softmax(logits, dim=-1)}

    return apply


def serve_until_signalled(server: PredictServer, store: Optional[str],
                          job_id: str, service: str) -> None:
    """Register ``server`` under ``service`` when a store is given, wait
    for SIGTERM or SIGINT, then deregister and stop it (the server stops
    too when the registration fails). The process arms
    the chaos plane as ``teacher`` (``EDL_CHAOS``: the fault point
    ``distill.serving.predict``)."""
    arm_from_env("teacher")  # the chaos plane; a no-op without EDL_CHAOS
    stop = threading.Event()
    # handlers first: a signal that lands once the endpoint is registered
    # must deregister it
    prev = {sig: signal.signal(sig, lambda *a: stop.set())
            for sig in (signal.SIGTERM, signal.SIGINT)}
    reg = None
    try:
        if store:
            reg = TeacherRegister(store, job_id, service, server.endpoint)
        stop.wait()
    finally:
        for sig, handler in prev.items():
            signal.signal(sig, handler)
        if reg is not None:
            reg.stop()
        server.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--params", default=None,
        help=".npz of /-joined flax param paths (default: seeded random)",
    )
    parser.add_argument("--store", default=None,
                        help="register the endpoint in this store")
    parser.add_argument("--job_id", default="distill-nlp")
    parser.add_argument("--service", default="nlp-teacher")
    args = parser.parse_args(argv)
    model = build_teacher(args.config, args.device, args.seed, args.params)
    backend = TorchPredictBackend(make_apply(model), device=args.device)
    server = PredictServer(backend, port=args.port).start()
    print("nlp teacher serving on %s" % server.endpoint, flush=True)
    serve_until_signalled(server, args.store, args.job_id, args.service)


if __name__ == "__main__":
    main()
