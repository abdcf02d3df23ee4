"""The TransformerLM distillation teacher: per-token soft labels over RPC.

The port of the teacher role of ``examples/distill_nlp.py``: a
``TransformerLM`` behind ``PredictServer(TorchPredictBackend(...))``
answering ``predict({"tokens": int32 [n, T]})`` with
``{"soft_label": softmax(logits, -1)}`` as fp32 ``[n, T, vocab]``.

    python -m edl_tpu_torch.distill.nlp_teacher --config flagship --port 9000
    python -m edl_tpu_torch.distill.nlp_teacher --config small --device cpu

Configs: ``small`` is distill_nlp's teacher exactly (fp32); ``flagship``
is the LM of ``tools/lm_bench.py`` (bf16, ~215 M parameters). Weights
come from a seeded ``torch.Generator`` or, with ``--params``, from an
``.npz`` of flax param paths (:mod:`edl_tpu_torch.convert`). Teacher
registration in the coordination store (``--store``) comes with a later
slice; point students at the printed endpoint.
"""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional

import torch

from edl_tpu_torch.convert import load_params
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
    args = parser.parse_args(argv)
    model = build_teacher(args.config, args.device, args.seed, args.params)
    backend = TorchPredictBackend(make_apply(model), device=args.device)
    server = PredictServer(backend, port=args.port).start()
    print("nlp teacher serving on %s" % server.endpoint, flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
    server.stop()


if __name__ == "__main__":
    main()
