"""Distillation teacher: serve a ResNet's soft targets, self-register.

The port of ``examples/distill_teacher.py``: a ResNet behind the framed-TCP
predict server (``TorchPredictBackend``, optionally coalescing concurrent
students' requests into one device call), heartbeating its endpoint into
the coordination store so students discover it dynamically. Start or
stop any number of these at any time: the students' balance loop
adapts::

    python -m edl_tpu_torch.store.server --port 2379 &
    python -m edl_tpu_torch.distill.discovery_server --store 127.0.0.1:2379 &
    python -m edl_tpu_torch.examples.distill_teacher --store 127.0.0.1:2379

``--small`` serves ``ResNet(stage_sizes=(1, 1), num_classes=10, width=8)``
at 32x32, the default ResNet50_vd at 224x224 (bf16 compute, as in the JAX
example). Weights are drawn from seed 0, or loaded from
``--model_uri`` / ``EDL_DISTILL_MODEL_URI`` (with ``--model_sha256`` /
``EDL_DISTILL_MODEL_SHA256``) through :func:`~edl_tpu_torch.distill.
fetch_model`: the JAX teacher's own artifact, flax ``to_bytes`` msgpack of
``{"params", "batch_stats"}``, read without flax
(:func:`edl_tpu_torch.convert.from_flax_bytes`). ``--device cpu`` serves
on the CPU. A teacher started with ``EDL_POD_ID`` drains (leaves every
assignment) when its pod gets a preemption notice.
"""

from __future__ import annotations

import argparse
import os

import torch

from edl_tpu_torch import convert
from edl_tpu_torch.distill import (
    CoalescingBackend,
    PredictServer,
    TorchPredictBackend,
    fetch_model,
)
from edl_tpu_torch.distill.nlp_teacher import serve_until_signalled
from edl_tpu_torch.models.resnet import ResNet, ResNet50_vd
from edl_tpu_torch.utils.device import resolve_device


def build_model(small: bool, device="cuda", seed: int = 0, dtype=None):
    """``(model, image size)``: the example's ResNet on ``device`` with
    weights drawn from ``seed``; ``dtype`` overrides the compute dtype
    (bf16 by default, as in the JAX models)."""
    dev = resolve_device(device)
    kw = {} if dtype is None else {"dtype": dtype}
    if small:
        model, size = ResNet((1, 1), num_classes=10, width=8, device=dev,
                             **kw), 32
    else:
        model, size = ResNet50_vd(num_classes=1000, device=dev, **kw), 224
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    return model, size


def load_artifact(model, uri: str, sha256=None) -> None:
    """Fetch the flax ``to_bytes`` artifact at ``uri`` and load its
    ``params`` and ``batch_stats`` into ``model``."""
    path = fetch_model(uri, sha256=sha256)
    with open(path, "rb") as fh:
        tree = convert.from_flax_bytes(fh.read())
    convert.load_params(model, {"params": tree["params"],
                                "batch_stats": tree["batch_stats"]})


def make_apply(model):
    """``feeds {"image": [n, H, W, 3]} -> {"soft_label": [n, classes]}``:
    the softmax of the eval-mode logits (running batch-norm statistics)."""

    def apply(feeds):
        logits = model(feeds["image"], train=False)
        return {"soft_label": torch.softmax(logits.float(), dim=-1)}

    return apply


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--store", required=True)
    parser.add_argument("--job_id", default="distill")
    parser.add_argument("--service", default="teacher")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--small", action="store_true", help="tiny CPU model")
    parser.add_argument("--device", default="cuda")
    parser.add_argument(
        "--model_uri", default=None,
        help="fetch trained params from this URI (local/file/http/gs; "
        "flax to_bytes msgpack of {'params', 'batch_stats'}); also read "
        "from EDL_DISTILL_MODEL_URI",
    )
    parser.add_argument("--model_sha256", default=None)
    parser.add_argument(
        "--coalesce_ms", type=float, default=0.0,
        help="megabatching window: coalesce concurrent student requests "
        "into one device call (0 = off)",
    )
    args = parser.parse_args(argv)

    model, _ = build_model(args.small, args.device)
    uri = args.model_uri or os.environ.get("EDL_DISTILL_MODEL_URI")
    if uri:
        load_artifact(model, uri, args.model_sha256
                      or os.environ.get("EDL_DISTILL_MODEL_SHA256"))
        print("teacher params loaded from %s" % uri, flush=True)
    model.eval()

    backend = TorchPredictBackend(make_apply(model), device=args.device)
    if args.coalesce_ms > 0:
        backend = CoalescingBackend(backend, max_wait_ms=args.coalesce_ms)
    server = PredictServer(backend, port=args.port).start()
    print("teacher serving on %s" % server.endpoint, flush=True)
    serve_until_signalled(server, args.store, args.job_id, args.service)


if __name__ == "__main__":
    main()
