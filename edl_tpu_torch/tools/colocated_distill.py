"""Co-located distillation benchmark: teacher + student on the SAME card.

The port of ``tools/colocated_distill.py``. The reference's middle
benchmark row (README.md:71): a ResNeXt101_32x16d_wsl teacher and a
ResNet50_vd student sharing the same 8 V100s drop pure-train throughput
from 1828 to 656 img/s (ratio 0.359) for +1.9 acc1. There the teacher runs
behind Paddle Serving on the same GPUs. The JAX tool fuses the frozen
teacher's forward into the student's jitted KD step; the port runs them
as one eager step on one stream: the teacher's forward under
``torch.no_grad`` (frozen, eval mode), then the student's KD train step
(``make_kd_loss``) on the teacher's logits — no RPC, no host round trip.

Measures on ``--device`` (``cuda`` by default: ResNeXt101_32x16d and
ResNet50_vd at 224x224, batch 256; ``cpu``: the JAX tool's two-stage
debug models at 24x24, batch 4):

  1. the pure student train step (CE loss), img/s;
  2. the co-located KD step (teacher forward + student forward, backward
     and update), img/s;

and prints ONE JSON line (the JAX tool's keys) with both, the retention
ratio and ``vs_baseline`` = ratio / 0.359, the reference's published
ratio on 8 V100s (>1.0: more of the pure throughput is kept under
co-location than the reference kept). ``--teacher_dtype bf16`` (the
default) stores the frozen teacher's weights and statistics in bf16; its
head upcasts, so the soft targets stay fp32.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

REF_PURE = 1828.0 / 8  # img/s per V100, reference README.md:70
REF_COLOC_RATIO = 656.0 / 1828.0  # README.md:71


def build_models(on_gpu: bool, dtype=None):
    """``(student, teacher, classes)``: ResNet50_vd and ResNeXt101_32x16d
    on the card, the JAX tool's debug pair on the CPU. ``dtype`` is the
    compute type (the models' own, bf16, when None)."""
    from edl_tpu_torch.models import (
        ResNet, ResNet50_vd, ResNeXt, ResNeXt101_32x16d,
    )

    kw = {} if dtype is None else {"dtype": dtype}
    if on_gpu:
        return (ResNet50_vd(num_classes=1000, **kw),
                ResNeXt101_32x16d(num_classes=1000, **kw), 1000)
    return (ResNet(stage_sizes=(1, 1), num_classes=100, width=8, **kw),
            ResNeXt(stage_sizes=(1, 1), cardinality=4, base_width=4,
                    num_classes=100, **kw),
            100)


def make_coloc_step(teacher, alpha: float = 0.5, temperature: float = 1.0):
    """``step(state, (x, y)) -> (state, metrics)``: the frozen teacher's
    logits on ``x`` (no graph), then the student's KD train step on
    them, one eager step on the current stream."""
    import torch

    from edl_tpu_torch.train import make_kd_loss, make_train_step

    kd_step = make_train_step(make_kd_loss(alpha, temperature),
                              {"train": True})

    def step(state, batch):
        x, y = batch
        with torch.no_grad():
            t_logits = teacher(x, train=False)
        return kd_step(state, (x, (y, t_logits)))

    return step


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.colocated_distill",
        description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument(
        "--teacher_dtype", choices=("bf16", "f32"), default="bf16",
        help="storage dtype of the frozen teacher's weights and "
        "statistics: bf16 halves the teacher's weight traffic a step "
        "(its compute is bf16 already; the fp32 head upcasts, so the "
        "soft targets stay fp32); f32 for A/B",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    import torch

    from edl_tpu_torch.train import create_state, cross_entropy_loss, sgd
    from edl_tpu_torch.train import make_train_step
    from edl_tpu_torch.train.step import init_weights
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    batch = args.batch or (256 if on_gpu else 4)
    size = 224 if on_gpu else 24
    steps = args.steps if on_gpu else 2
    warmup = 5 if on_gpu else 1

    student, teacher, classes = build_models(on_gpu)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, size, size, 3), generator=gen).to(dev)
    y = torch.randint(0, classes, (batch,), generator=gen).to(dev)

    teacher.to(dev)
    init_weights(teacher, 1, dev)
    teacher.eval().requires_grad_(False)
    if args.teacher_dtype == "bf16":
        # a frozen KD teacher tolerates bf16 weights and statistics: the
        # student consumes softmax(T-logits), and the fp32 head keeps the
        # logits themselves fp32
        teacher.to(torch.bfloat16)

    def sync(t):
        return float(t)  # a host fetch: every queued step has run

    def timed(step, state, fetch):
        for _ in range(warmup):
            state, metrics = step(state, (x, y))
        sync(fetch(metrics))
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step(state, (x, y))
        sync(fetch(metrics))
        return batch * steps / (time.perf_counter() - t0), metrics

    # --- phase 1: pure train ---
    state = create_state(student, 0, sgd(0.1, momentum=0.9), device=dev)
    pure_step = make_train_step(cross_entropy_loss, {"train": True})
    pure, _ = timed(pure_step, state.copy(), lambda m: m["loss"])

    # --- phase 2: co-located KD ---
    co, metrics = timed(make_coloc_step(teacher, args.alpha,
                                        args.temperature),
                        state, lambda m: m["kd_kl"])

    ratio = co / pure
    out = {
        "metric": "colocated_distill_retention_%s"
        % ("gpu" if on_gpu else "cpu_debug"),
        "value": round(ratio, 3),
        "unit": "coloc/pure throughput ratio",
        "vs_baseline": round(ratio / REF_COLOC_RATIO, 3) if on_gpu else 0.0,
        "pure_img_s": round(pure, 1),
        "coloc_img_s": round(co, 1),
        "ref_ratio": round(REF_COLOC_RATIO, 3),
        "ref_pure_img_s_per_gpu": round(REF_PURE, 1),
        "ref_coloc_img_s_per_gpu": round(656.0 / 8, 1),
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "batch": batch,
        "steps": steps,
        "teacher_dtype": args.teacher_dtype,
        "loss": float(metrics["loss"]),
        "kd_kl": float(metrics["kd_kl"]),
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
