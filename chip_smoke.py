#!/usr/bin/env python3
"""Drive edl_tpu_torch's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device  - require CUDA; the card's name, count and power limit.
2. build   - compile every CUDA kernel of the path from ``ops/csrc``.
3. kernels - each kernel against its plain PyTorch version, on the card,
             at the main path's shapes and the edge cases of its contract;
             kernel, plain and library times (CUDA events) and the bound.
4. model   - the flagship TransformerLM (seeded weights, bf16) forward at
             [8, 2048]: finite logits that agree with the same model's
             forward through the plain attention, one flash launch per layer;
             its time, tokens/s and device time by kernel (torch.profiler).
5. serve   - the main path: ``PredictServer(TorchPredictBackend(teacher))``
             on loopback answering ``PredictClient`` requests; soft labels
             sum to 1 and match the backend called directly; each
             request's time split into forward, softmax, backend and wire.

Then one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or outside a checkout of the repo, it exits non-zero and
prints no result. Imports nothing of JAX or of the JAX package.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12

# stated tolerances, kernel vs plain version on the same inputs:
# o differs by the output's rounding (one bf16 ulp is 1.6e-2 on [2, 4)),
# lse only by fp32 summation order
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
# flagship logits, flash vs plain attention in the same bf16 model: the
# two attention outputs differ by an output rounding per layer, which 12
# residual layers carry into the logits (~N(0, 1) at these weights)
TOL_LOGITS_MAX = 0.3
TOL_LOGITS_MEAN = 3e-2
# served soft labels: each row sums to 1 in fp32 over 32000 entries, and
# the same padded batch through the same model reproduces the response
TOL_ROWSUM = 1e-3
TOL_SERVED = 1e-6

# (B, H, Hkv, Tq, Tk, D), causal, dtype
KERNEL_CASES = (
    ((8, 16, 16, 2048, 2048, 64), True, "bfloat16"),   # flagship forward
    ((4, 16, 16, 1024, 1024, 64), True, "bfloat16"),   # served bucket of 4
    ((1, 16, 16, 1024, 1024, 64), True, "bfloat16"),   # served bucket of 1
    ((2, 16, 4, 1024, 1024, 128), True, "bfloat16"),   # GQA, g = 4
    ((2, 16, 16, 1024, 1024, 64), False, "bfloat16"),  # non-causal
    ((2, 16, 16, 1000, 1000, 64), True, "bfloat16"),   # ragged
    ((2, 16, 16, 256, 1024, 64), True, "bfloat16"),    # end-aligned Tq < Tk
    ((2, 16, 16, 96, 64, 64), True, "bfloat16"),       # rows with no key
    ((8, 4, 4, 64, 64, 32), True, "float32"),          # small config
)
FLAGSHIP_CASE = 0
KERNELS = ("flash_fwd",)
SERVE_SEQ = 1024
SERVE_ROWS = (1, 3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(torch, fn, budget_ms: float = 300.0, hold: bool = True) -> float:
    """Mean time of ``fn`` over a run of launches (CUDA events), after a
    warm-up; the run is sized to about ``budget_ms``.

    ``hold``: a spin kernel holds the stream while the host queues the
    whole run, so the events time the device alone and not the rate at
    which Python launches (which bounds a small kernel's back-to-back
    time). Without it the result is the steady throughput of back-to-back
    calls, host included, as a caller looping on ``fn`` sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    n = int(max(3, min(200, budget_ms / max(start.elapsed_time(end), 1e-3))))
    if hold:
        # cycles at the H100's 1.98 GHz boost clock (longer at a lower one)
        hold_ms = min(1000.0, 2.0 * n * host_ms + 1.0)
        torch.cuda._sleep(int(hold_ms * 1.98e6))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_device(torch) -> dict:
    check(torch.cuda.is_available(), "CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    info = {
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "capability": list(torch.cuda.get_device_capability(0)),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def phase_build() -> dict:
    from edl_tpu_torch.ops import _build

    t0 = time.monotonic()
    regs = {}
    for name in KERNELS:
        _lib, log = _build.build(name)
        _build.load(name)
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln]
    out = {"phase": "build", "seconds": time.monotonic() - t0,
           "kernels": list(KERNELS), "ptxas": regs}
    emit(out)
    return out


def _case_inputs(torch, case, seed):
    (b, h, h_kv, tq, tk, d), _causal, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(b, h, tq, d, device="cuda", generator=gen).to(dt)
    k = torch.randn(b, h_kv, tk, d, device="cuda", generator=gen).to(dt)
    v = torch.randn(b, h_kv, tk, d, device="cuda", generator=gen).to(dt)
    return q, k, v


def _bound(case) -> dict:
    (b, h, h_kv, tq, tk, d), causal, dtype = case
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * d * (b * h * tq * 2 + b * h_kv * tk * 2) + 4 * b * h * tq
    pairs = 0.0
    if causal:
        for i in range(tq):
            vis = min(tk, i + (tk - tq) + 1)
            # a row that sees no key: the mean of v over all Tk keys
            pairs += vis if vis > 0 else tk / 2.0
    else:
        pairs = float(tq) * tk
    ops = 4.0 * d * pairs * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return {
        "bytes": nbytes, "ops": ops,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }


def _library_fn(torch, q, k, v, causal):
    """``scaled_dot_product_attention`` on the kernel's inputs, computing
    the same function: where Tq != Tk the end-aligned causal mask goes in
    as an additive bias with the reference's finite mask value."""
    from edl_tpu_torch.ops.attention import NEG_INF

    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk = q.shape[2], k.shape[2]
    gqa = q.shape[1] != k.shape[1]
    if not causal or tq == tk:
        return lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=gqa)
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    kpos = torch.arange(tk, device=q.device)[None, :]
    bias = torch.zeros(tq, tk, dtype=q.dtype, device=q.device)
    bias.masked_fill_(qpos < kpos, NEG_INF)
    return lambda: sdpa(q, k, v, attn_mask=bias, enable_gqa=gqa)


def phase_kernels(torch) -> list:
    from edl_tpu_torch.ops.attention import (
        attention_reference_with_lse,
        flash_forward,
    )

    results = []
    for idx, case in enumerate(KERNEL_CASES):
        (b, h, h_kv, tq, tk, d), causal, dtype = case
        q, k, v = _case_inputs(torch, case, seed=idx)
        with torch.inference_mode():
            o, lse = flash_forward(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ro, rlse = attention_reference_with_lse(q, k, v, causal=causal)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            check(bool(torch.isfinite(o).all()), "flash o not finite %s" % (case,))
            ms = time_ms(torch, lambda: flash_forward(q, k, v, causal=causal))
            plain_ms = time_ms(
                torch,
                lambda: attention_reference_with_lse(q, k, v, causal=causal),
            )
            # yardstick only: one PyTorch call computing the same output
            library = _library_fn(torch, q, k, v, causal)
            library_err = (library().float() - ro.float()).abs().max().item()
            library_ms = time_ms(torch, library)
        rec = {
            "phase": "kernel", "name": "flash_fwd",
            "shape": [b, h, h_kv, tq, tk, d], "causal": causal,
            "dtype": dtype, "max_abs_err": err_o, "lse_max_abs_err": err_lse,
            "tol_o": TOL_O[dtype], "tol_lse": TOL_LSE, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": library_err,
        }
        rec.update(_bound(case))
        emit(rec)
        check(err_o <= TOL_O[dtype],
              "flash o error %.3g > %.3g at %s" % (err_o, TOL_O[dtype], case))
        check(err_lse <= TOL_LSE,
              "flash lse error %.3g > %.3g at %s" % (err_lse, TOL_LSE, case))
        results.append(rec)
        del q, k, v, o, lse, ro, rlse
    torch.cuda.empty_cache()
    return results


def _device_breakdown(torch, fn) -> dict:
    """Device time of one synchronised ``fn()`` by kernel (torch.profiler,
    CUPTI): the total, the wall time, the flash kernel's share and the
    largest kernels. ``device_ms`` is None where the trace holds no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((ev.key, us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in kernels)
    flash = sum(r[1] for r in kernels if "flash_fwd" in r[0])
    return {
        "wall_ms": wall_ms,
        "device_ms": total if kernels else None,
        "device_idle_share": (1.0 - total / wall_ms) if kernels else None,
        "flash_ms": flash, "flash_share": flash / total if total else None,
        "top": [{"kernel": k[:80], "ms": ms, "count": n}
                for k, ms, n in kernels[:8]],
    }


def phase_model(torch, smi: str):
    from edl_tpu_torch.distill.nlp_teacher import CONFIGS, build_teacher
    from edl_tpu_torch.ops.attention import (
        attention,
        attention_reference,
        flash_forward,
    )

    model = build_teacher("flagship", device="cuda", seed=0)
    cfg = CONFIGS["flagship"]
    batch, seq = 8, cfg["seq"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(
        0, cfg["model"]["vocab_size"], (batch, seq), device="cuda",
        generator=gen, dtype=torch.int32,
    )
    layers = [getattr(model, "layer_%d" % i) for i in range(model.num_layers)]
    with torch.inference_mode():
        flash_forward.launches = 0
        logits = model(tokens)
        torch.cuda.synchronize()
        launches = flash_forward.launches
        check(launches == model.num_layers,
              "flash launches %d != %d layers" % (launches, model.num_layers))
        check(tuple(logits.shape) == (batch, seq, cfg["model"]["vocab_size"])
              and logits.dtype == torch.float32, "logits shape/dtype")
        check(bool(torch.isfinite(logits).all()), "flagship logits not finite")
        fwd_ms = time_ms(torch, lambda: model(tokens), budget_ms=500.0,
                         hold=False)
        breakdown = _device_breakdown(torch, lambda: model(tokens))
        for layer in layers:
            layer.attn.attention_fn = attention_reference
        plain_logits = model(tokens)
        plain_fwd_ms = time_ms(torch, lambda: model(tokens), budget_ms=500.0,
                               hold=False)
        for layer in layers:
            layer.attn.attention_fn = attention
        diff = (logits - plain_logits).abs()
        max_diff, mean_diff = diff.max().item(), diff.mean().item()
    out = {
        "phase": "model", "config": "flagship", "tokens": [batch, seq],
        "params": sum(p.numel() for p in model.parameters()),
        "flash_launches": launches, "logits_max_abs": logits.abs().max().item(),
        "vs_plain_max_abs_diff": max_diff, "vs_plain_mean_abs_diff": mean_diff,
        "tol_max": TOL_LOGITS_MAX, "tol_mean": TOL_LOGITS_MEAN,
        "forward_ms": fwd_ms, "tokens_per_s": batch * seq / fwd_ms * 1e3,
        "plain_attention_forward_ms": plain_fwd_ms, "card": smi,
        "profile": breakdown,
    }
    emit(out)
    check(max_diff <= TOL_LOGITS_MAX and mean_diff <= TOL_LOGITS_MEAN,
          "flash vs plain logits differ: max %.3g mean %.3g"
          % (max_diff, mean_diff))
    del logits, plain_logits, diff
    torch.cuda.empty_cache()
    return model


def _serve_split(torch, model, apply, feeds, bucket) -> dict:
    """Device times of one served request's padded batch (CUDA events,
    back to back): the forward alone, and with the softmax to soft labels.
    With the backend's host-clock time (adds the copies to and from the
    card) and the request latency (adds encoding and the socket) they
    split a request's time."""
    import numpy as np

    tokens = feeds["tokens"]
    pad = np.repeat(tokens[-1:], bucket - tokens.shape[0], axis=0)
    dev = torch.from_numpy(np.concatenate([tokens, pad])).to("cuda")
    with torch.inference_mode():
        fwd_ms = time_ms(torch, lambda: model(dev), budget_ms=200.0,
                         hold=False)
        soft_ms = time_ms(torch, lambda: apply({"tokens": dev}),
                          budget_ms=200.0, hold=False)
    return {"forward_ms": fwd_ms, "forward_softmax_ms": soft_ms}


def phase_serve(torch, model):
    import numpy as np

    from edl_tpu_torch.distill.nlp_teacher import make_apply
    from edl_tpu_torch.distill.serving import (
        PredictClient,
        PredictServer,
        TorchPredictBackend,
    )
    from edl_tpu_torch.ops.attention import flash_forward

    apply = make_apply(model)
    backend = TorchPredictBackend(apply, device="cuda")
    server = PredictServer(backend, host="127.0.0.1", port=0).start()
    client = PredictClient("127.0.0.1:%d" % server.port, timeout=300.0)
    rng = np.random.RandomState(2)
    vocab = model.embed.embedding.shape[0]
    requests = [
        {"tokens": rng.randint(0, vocab, (n, SERVE_SEQ)).astype(np.int32)}
        for n in SERVE_ROWS
    ]
    try:
        check(client.ping(), "ping failed")
        responses, latency_ms = [], []
        torch.cuda.synchronize()
        flash_forward.launches = 0  # the main path's run starts here
        for feeds in requests:
            t0 = time.monotonic()
            responses.append(client.predict(feeds))
            latency_ms.append((time.monotonic() - t0) * 1e3)
        launches = flash_forward.launches
        records = []
        for feeds, resp, ms in zip(requests, responses, latency_ms):
            n = feeds["tokens"].shape[0]
            soft = resp["soft_label"]
            check(soft.shape == (n, SERVE_SEQ, vocab)
                  and soft.dtype == np.float32, "soft_label shape/dtype")
            check(bool(np.isfinite(soft).all()), "soft labels not finite")
            rowsum_err = float(np.abs(soft.sum(axis=-1, dtype=np.float64)
                                      - 1.0).max())
            t0 = time.monotonic()
            direct = backend(feeds)["soft_label"]
            backend_ms = (time.monotonic() - t0) * 1e3
            served_err = float(np.abs(soft - direct).max())
            bucket = 1 << (n - 1).bit_length()
            records.append({
                "rows": n, "bucket": bucket,
                "latency_ms": ms, "response_mb": soft.nbytes / 1e6,
                "rowsum_max_err": rowsum_err,
                "vs_direct_max_abs_diff": served_err,
                **_serve_split(torch, model, apply, feeds, bucket),
                "backend_ms": backend_ms,
            })
            check(rowsum_err <= TOL_ROWSUM,
                  "soft label rows sum off by %.3g" % rowsum_err)
            check(served_err <= TOL_SERVED,
                  "served != direct backend by %.3g" % served_err)
    finally:
        client.close()
        server.stop()
    out = {
        "phase": "serve", "seq": SERVE_SEQ, "requests": records,
        "flash_launches": launches, "tol_rowsum": TOL_ROWSUM,
        "tol_served": TOL_SERVED,
    }
    emit(out)
    expect = model.num_layers * len(SERVE_ROWS)
    check(launches == expect,
          "served flash launches %d != %d" % (launches, expect))
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "edl_tpu_torch")):
        sys.stderr.write(
            "chip_smoke.py: run it from a checkout of the repo "
            "(edl_tpu_torch/ not found beside it)\n"
        )
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: CUDA is not available\n")
        return 3
    dev = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    model = phase_model(torch, dev["nvidia_smi"])
    serve = phase_serve(torch, model)
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "edl_tpu")
    )
    check(not leaked, "imported JAX or the JAX package: %s" % leaked)
    flag = kernels[FLAGSHIP_CASE]
    emit({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "edl_tpu/ops/attention.py:163",
        "launches": serve["flash_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in kernels
                           if r["dtype"] == "bfloat16"),
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
        "shape": flag["shape"],
    }]})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
