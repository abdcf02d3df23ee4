"""TransformerLM training throughput: tokens/s and MFU on one card.

The port of ``tools/lm_bench.py``: an AdamW (1e-3) train step of the
flagship decoder (RoPE, SwiGLU, bf16 compute, fp32 master weights,
attention through the hand-written flash kernels, remat ``save_flash`` by
default) on seeded random weights and tokens, nothing downloaded.

    python -m edl_tpu_torch.tools.lm_bench                # the card
    python -m edl_tpu_torch.tools.lm_bench --device cpu   # debug sizes

On the card the defaults are the flagship (batch 8, seq 2048, d_model
1024, 16 heads of 64, 12 layers, d_ff 2688, vocab 32000; 214,983,680
parameters); ``--device cpu`` takes the JAX tool's off-TPU debug sizes
(batch 2, seq 128, d_model 64, 2 layers, vocab 256, 3 steps). Sync
discipline: the loss is fetched to the host after the timed steps.

The step's FLOPs are counted from the shapes (:func:`step_flops`; the
port has no XLA cost analysis): matrix products only, 2 per
multiply-add. Forward: the projections and MLP of every block, the LM
head, and attention's ``4 * head_dim`` per visible (query, key) pair of
the causal mask. Backward: twice the forward's dense products, and the
backward kernels' ``14 * head_dim`` per pair (dq 6, dk/dv 8). Recompute:
the blocks' dense products under ``save_flash`` (without q/k/v under
``save_flash_qkv``), plus attention's forward under ``full``. MFU is that
over the step time against the H100's bf16 dense peak, 989 TFLOP/s.

Prints ONE JSON line; its ``launches`` are the kernel wrappers' counts
over the run (warm-up steps included; 0 on the CPU, where the wrappers
take the plain path).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from edl_tpu_torch.models.transformer import TransformerLM
from edl_tpu_torch.ops.attention import launch_counts
from edl_tpu_torch.train import adamw, create_state, cross_entropy_loss
from edl_tpu_torch.train import make_train_step
from edl_tpu_torch.utils.device import resolve_device

H100_BF16_PEAK_FLOPS = 989e12  # NVIDIA H100 SXM data sheet, dense
WARMUP = 3  # untimed steps before the timed ones


def config(args, on_gpu: bool) -> dict:
    """The run's sizes: the flags, else the card's or the CPU's defaults."""
    d_model = args.d_model or (1024 if on_gpu else 64)
    return {
        "batch": args.batch or (8 if on_gpu else 2),
        "seq": args.seq or (2048 if on_gpu else 128),
        "steps": args.steps if on_gpu else 3,
        "d_model": d_model,
        "num_heads": max(1, d_model // 64),
        "num_kv_heads": args.kv_heads,
        "num_layers": args.layers or (12 if on_gpu else 2),
        "d_ff": int(d_model * 8 / 3 / 128) * 128 or 128,
        "vocab_size": 32000 if on_gpu else 256,
        "remat": args.remat,
    }


def build_model(cfg: dict, device) -> TransformerLM:
    return TransformerLM(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
        d_ff=cfg["d_ff"], num_kv_heads=cfg["num_kv_heads"],
        remat=cfg["remat"] != "none",
        remat_policy=None if cfg["remat"] in ("none", "full") else cfg["remat"],
        device=device,
    )


def lm_loss(logits, targets):
    return cross_entropy_loss(
        logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)
    )


def build(cfg: dict, device="cuda", seed: int = 0, lr: float = 1e-3):
    """``(state, step, (x, y))``: the model with seeded weights, AdamW, the
    donating train step and one seeded batch of next-token pairs."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    state = create_state(model, seed, adamw(lr), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(
        0, cfg["vocab_size"], (cfg["batch"], cfg["seq"] + 1), device=dev,
        generator=gen,
    )
    return state, make_train_step(lm_loss), (tokens[:, :-1], tokens[:, 1:])


def step_flops(cfg: dict) -> float:
    """Matrix-product FLOPs of one train step (see the module docstring)."""
    b, t, d = cfg["batch"], cfg["seq"], cfg["d_model"]
    h = cfg["num_heads"]
    kv = cfg["num_kv_heads"] or h
    hd = d // h
    tokens = b * t
    qkv = 2 * tokens * d * hd * (h + 2 * kv)
    out = 2 * tokens * h * hd * d
    mlp = 3 * 2 * tokens * d * cfg["d_ff"]
    blocks = cfg["num_layers"] * (qkv + out + mlp)
    head = 2 * tokens * d * cfg["vocab_size"]
    pairs = cfg["num_layers"] * b * h * t * (t + 1) / 2
    attn_fwd, attn_bwd = 4 * hd * pairs, 14 * hd * pairs
    recompute = {
        "none": 0.0,
        "save_flash": blocks,
        "save_flash_qkv": blocks - cfg["num_layers"] * qkv,
        "full": blocks + attn_fwd,
    }[cfg["remat"]]
    return 3.0 * (blocks + head) + attn_fwd + attn_bwd + recompute


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seq", type=int, default=None)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--d_model", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument(
        "--kv_heads", type=int, default=None,
        help="GQA: fewer kv heads than query heads; the kernels read them "
        "without a materialized repeat",
    )
    p.add_argument(
        "--remat", choices=("save_flash", "save_flash_qkv", "full", "none"),
        default="save_flash",
        help="activation strategy: save_flash (default) recomputes all but "
        "the attention kernel's out+lse; 'none' saves everything; 'full' "
        "is recompute-everything",
    )
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    cfg = config(args, on_gpu)
    state, step, batch = build(cfg, dev)
    steps = cfg["steps"]

    for _ in range(WARMUP):
        state, m = step(state, batch)
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, batch)
    final = float(m["loss"])
    dt = time.perf_counter() - t0
    if final != final:
        raise RuntimeError("NaN loss")

    tokens = cfg["batch"] * cfg["seq"]
    out = {
        "metric": "transformer_lm_train_tokens_per_s_%s"
        % ("gpu" if on_gpu else "cpu_debug"),
        "value": tokens * steps / dt,
        "unit": "tokens/s",
        "vs_baseline": 0.0,  # net-new workload: the reference has no LM
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "batch": cfg["batch"],
        "seq": cfg["seq"],
        "d_model": cfg["d_model"],
        "layers": cfg["num_layers"],
        "remat": cfg["remat"],
        "kv_heads": cfg["num_kv_heads"],
        "loss": final,
        "step_ms": dt / steps * 1e3,
        "steps": steps,
        "warmup": WARMUP,
        "launches": launch_counts(),
    }
    if on_gpu:
        flops = step_flops(cfg)
        out["mfu"] = flops * steps / dt / H100_BF16_PEAK_FLOPS
        out["step_tflops"] = flops / 1e12
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
