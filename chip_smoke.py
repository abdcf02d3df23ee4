#!/usr/bin/env python3
"""Drive edl_tpu_torch's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. device  - require CUDA; the card's name, count and power limit.
2. build   - compile every CUDA source of the paths from ``ops/csrc``, one
             ``nvcc`` per source, all started together.
3. kernels - each kernel against its plain PyTorch version, on the card,
             at the main paths' shapes and the edge cases of its contract;
             kernel, plain and library times (CUDA events) and the bound:
             the flash forward, then the backward pair (dq, dk/dv).
4. model   - the flagship TransformerLM (seeded weights, bf16) forward at
             [8, 2048]: finite logits that agree with the same model's
             forward through the plain attention, one flash launch per layer;
             its time, tokens/s and device time by kernel (torch.profiler).
5. serve   - the serving path: ``PredictServer(TorchPredictBackend(
             teacher))`` on loopback answering ``PredictClient`` requests;
             soft labels sum to 1 and match the backend called directly;
             each request's time split into forward, softmax, backend and
             wire.
6. train   - the training path: ``lm_bench``'s AdamW step of the flagship
             (fp32 masters, bf16 compute, remat ``save_flash``) at
             [8, 2048], ten steps on one batch: the loss is finite and
             falls, each step launches 12 flash forwards and 12 of each
             backward kernel (24 forwards under remat ``full``); step time,
             tokens/s, MFU, peak memory and device time by kernel. Then one
             step's loss and gradients at [2, 2048] against the same model
             with the plain attention.

Then one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or outside a checkout of the repo, it exits non-zero and
prints no result. Imports nothing of JAX or of the JAX package.
"""

import concurrent.futures
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
# backward kernels vs plain, relative to max(1, max|ref|): bf16 rounds p
# and ds before the products and the output, the plain version keeps fp32;
# fp32 only sums in another order
TOL_GRAD = {"bfloat16": 2e-2, "float32": 1e-4}
# one training step, flash vs plain attention in the same bf16 model: the
# loss and each parameter's gradient (relative L2 error)
TOL_TRAIN_LOSS = 2e-2
TOL_TRAIN_GRAD = 5e-2

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
# the backward pair runs on the training path: K1's cases but the served
# buckets
BWD_CASES = (0, 3, 4, 5, 6, 7, 8)
SOURCES = ("flash_fwd", "flash_bwd")
SERVE_SEQ = 1024
SERVE_ROWS = (1, 3)
TRAIN_STEPS = 10
GRAD_CHECK_BATCH = 2


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
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = {name: pool.submit(_build.build, name) for name in SOURCES}
        for name, fut in builds.items():
            _lib, log = fut.result()
            _build.load(name)
            regs[name] = [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln]
    out = {"phase": "build", "seconds": time.monotonic() - t0,
           "sources": list(SOURCES), "ptxas": regs}
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


def _visible(case):
    """Visible (query, key) pairs of one (batch, head) under the case's
    mask, and the rows that see no key (causal, Tq > Tk)."""
    (_b, _h, _hkv, tq, tk, _d), causal, _dtype = case
    if not causal:
        return float(tq) * tk, 0
    pairs = sum(max(0, min(tk, i + tk - tq + 1)) for i in range(tq))
    return float(pairs), max(0, tq - tk)


def _bwd_bounds(case) -> dict:
    """The least time of each backward kernel from its own products (dq:
    S, dP and ds·k, 6·D per visible pair; dk/dv: S, dP, pᵀ·dO and dsᵀ·q,
    8·D, plus pᵀ·dO over every key for a row that sees no key) and bytes
    (q, k, v, dO, lse, delta read once, its outputs written once); and the
    fused minimum, 10·D per pair."""
    (b, h, h_kv, tq, tk, d), _causal, dtype = case
    esize = 2 if dtype == "bfloat16" else 4
    pairs, no_key = _visible(case)
    in_bytes = esize * d * (2 * b * h * tq + 2 * b * h_kv * tk) + 8 * b * h * tq
    dv_no_key = 2.0 * d * no_key * tk * b * h
    work = {
        "dq": (6.0 * d * pairs * b * h, in_bytes + esize * d * b * h * tq),
        "dkv": (8.0 * d * pairs * b * h + dv_no_key,
                in_bytes + 2 * esize * d * b * h_kv * tk),
        "fused": (10.0 * d * pairs * b * h + dv_no_key,
                  in_bytes + esize * d * (b * h * tq + 2 * b * h_kv * tk)),
    }
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops = ops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "ops": ops, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
    return out


def _library_bwd(torch, q, k, v, g, causal):
    """The backward alone of ``scaled_dot_product_attention`` on the same
    inputs (a yardstick, never called by the port): ``(fn, grads)``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = _library_fn(torch, *leaves, causal)()
    fn = lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)
    return fn, fn()


def phase_kernels_bwd(torch) -> list:
    from edl_tpu_torch.ops.attention import (
        _block_grads_reference,
        _bwd_delta,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_forward,
    )

    results = []
    for idx in BWD_CASES:
        case = KERNEL_CASES[idx]
        (b, h, h_kv, tq, tk, d), causal, dtype = case
        q, k, v = _case_inputs(torch, case, seed=idx)
        gen = torch.Generator(device="cuda").manual_seed(100 + idx)
        g = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
        scale = d ** -0.5
        with torch.no_grad():
            o, lse = flash_forward(q, k, v, causal=causal)
            delta = _bwd_delta(g, o)
            args = (q, k, v, g, lse, delta, causal, scale)
            dq = flash_bwd_dq(*args)
            dk, dv = flash_bwd_dkv(*args)
            torch.cuda.synchronize()
            ref = _block_grads_reference(*args)
            errs, tols = {}, {}
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                check(bool(torch.isfinite(got).all()),
                      "flash %s not finite %s" % (name, case))
                errs[name] = (got.float() - want.float()).abs().max().item()
                tols[name] = TOL_GRAD[dtype] * max(
                    1.0, want.float().abs().max().item())
            del ref
            ms_dq = time_ms(torch, lambda: flash_bwd_dq(*args))
            ms_dkv = time_ms(torch, lambda: flash_bwd_dkv(*args))
            plain_ms = time_ms(torch, lambda: _block_grads_reference(*args),
                               budget_ms=200.0)
        library, lib_grads = _library_bwd(torch, q, k, v, g, causal)
        with torch.no_grad():
            lib_err = max((a.float() - c.float()).abs().max().item()
                          for a, c in zip(lib_grads, (dq, dk, dv)))
        library_ms = time_ms(torch, library, budget_ms=200.0)
        rec = {
            "phase": "kernel_bwd", "shape": [b, h, h_kv, tq, tk, d],
            "causal": causal, "dtype": dtype, "max_abs_err": errs,
            "tol": tols, "dq_ms": ms_dq, "dkv_ms": ms_dkv,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_vs_kernel_max_abs_diff": lib_err,
            "bounds": _bwd_bounds(case),
        }
        emit(rec)
        for name in errs:
            check(errs[name] <= tols[name], "flash %s error %.3g > %.3g at %s"
                  % (name, errs[name], tols[name], case))
        results.append(rec)
        del q, k, v, g, o, lse, delta, dq, dk, dv, library, lib_grads, args
    torch.cuda.empty_cache()
    return results


def _device_breakdown(torch, fn) -> dict:
    """Device time of one synchronised ``fn()`` by kernel (torch.profiler,
    CUPTI): the total, the wall time under the profiler, the flash
    kernels' times and share and the largest kernels. ``device_ms`` is
    None where the trace holds no device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        # user annotations (e.g. ``Optimizer.step#AdamW.step``) span
        # kernels on the device timeline: they are not kernels themselves
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((ev.key, us / 1e3, ev.count))
    kernels.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in kernels)
    flash = {
        name: sum(r[1] for r in kernels if name in r[0])
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    }
    return {
        "wall_ms": wall_ms,
        "device_ms": total if kernels else None,
        "device_idle_share": (1.0 - total / wall_ms) if kernels else None,
        "flash_ms": flash,
        "flash_share": sum(flash.values()) / total if total else None,
        "top": [{"kernel": k[:80], "ms": ms, "count": n}
                for k, ms, n in kernels[:10]],
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


def _launch_counts():
    from edl_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_forward,
    )

    return {"flash_fwd": flash_forward.launches,
            "flash_bwd_dq": flash_bwd_dq.launches,
            "flash_bwd_dkv": flash_bwd_dkv.launches}


def _zero_counts() -> None:
    from edl_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_forward,
    )

    flash_forward.launches = flash_bwd_dq.launches = flash_bwd_dkv.launches = 0


def _grad_check(torch, cfg) -> dict:
    """One step's loss and gradients of the flagship at [2, 2048], flash
    against plain attention in the same model (no remat: the plain
    attention's fp32 scores of 12 layers fit beside it at this batch)."""
    from edl_tpu_torch.ops.attention import attention, attention_reference
    from edl_tpu_torch.tools import lm_bench

    cfg = dict(cfg, batch=GRAD_CHECK_BATCH, remat="none")
    state, _step, (x, y) = lm_bench.build(cfg, "cuda", seed=1)
    model = state.apply_fn
    layers = [getattr(model, "layer_%d" % i) for i in range(model.num_layers)]
    runs = []
    for fn in (attention, attention_reference):
        for layer in layers:
            layer.attn.attention_fn = fn
        loss, _ = lm_bench.lm_loss(model(x), y)
        loss.backward()
        runs.append((loss.item(), {n: p.grad.float() for n, p in
                                   model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    (flash_loss, flash_g), (plain_loss, plain_g) = runs
    rel = {n: ((flash_g[n] - plain_g[n]).norm()
               / plain_g[n].norm().clamp(min=1e-30)).item() for n in plain_g}
    worst = max(rel, key=rel.get)
    del state, model, runs, flash_g, plain_g
    torch.cuda.empty_cache()
    return {"tokens": [GRAD_CHECK_BATCH, cfg["seq"]],
            "flash_loss": flash_loss, "plain_loss": plain_loss,
            "loss_abs_diff": abs(flash_loss - plain_loss),
            "grad_max_rel_l2": rel[worst], "grad_worst": worst,
            "tol_loss": TOL_TRAIN_LOSS, "tol_grad_rel_l2": TOL_TRAIN_GRAD}


def phase_train(torch, smi: str) -> dict:
    from edl_tpu_torch.tools import lm_bench

    cfg = {"batch": 8, "seq": 2048, "d_model": 1024, "num_heads": 16,
           "num_kv_heads": None, "num_layers": 12, "d_ff": 2688,
           "vocab_size": 32000, "remat": "save_flash"}
    state, step, batch = lm_bench.build(cfg, "cuda", seed=0)
    model = state.apply_fn
    layers = model.num_layers
    losses = []
    state, m = step(state, batch)  # warm-up: allocator, kernel libraries
    losses.append(m["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # the training path's run starts here
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = [float(v) for v in torch.stack(losses).tolist()]
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the host's time to queue one step (no sync): above the step's device
    # time, the host and not the card sets the step time
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    breakdown = _device_breakdown(torch, lambda: step(state, batch))

    model.remat_policy = "full"
    _zero_counts()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    full_launches = _launch_counts()
    model.remat_policy = cfg["remat"]
    del state, step, batch, model, m
    torch.cuda.empty_cache()

    flops = lm_bench.step_flops(cfg)
    tokens = cfg["batch"] * cfg["seq"]
    out = {
        "phase": "train", "config": "flagship", "tokens": [cfg["batch"],
                                                          cfg["seq"]],
        "remat": cfg["remat"], "optimizer": "adamw(1e-3)",
        "steps": TRAIN_STEPS, "losses": losses,
        "launches": launches,
        "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()},
        "launches_full_remat_step": full_launches,
        "step_ms": step_ms, "host_enqueue_ms": enqueue_ms,
        "tokens_per_s": tokens / step_ms * 1e3,
        "step_tflop": flops / 1e12,
        "mfu": flops / (step_ms * 1e-3) / lm_bench.H100_BF16_PEAK_FLOPS,
        "peak_memory_gb": peak_gb, "card": smi, "profile": breakdown,
        # the profiled step's device time against the unprofiled step
        "device_idle_share_steady": (
            1.0 - breakdown["device_ms"] / step_ms
            if breakdown["device_ms"] else None),
        "grad_check": _grad_check(torch, cfg),
    }
    emit(out)
    check(all(v == v and abs(v) != float("inf") for v in losses),
          "training loss not finite: %s" % losses)
    check(losses[-1] < losses[0], "training loss did not fall: %s" % losses)
    want = {"flash_fwd": layers, "flash_bwd_dq": layers,
            "flash_bwd_dkv": layers}
    check(out["launches_per_step"] == want,
          "launches per step %s != %s" % (out["launches_per_step"], want))
    want_full = dict(want, flash_fwd=2 * layers)
    check(full_launches == want_full,
          "remat full launches %s != %s" % (full_launches, want_full))
    gc = out["grad_check"]
    check(gc["loss_abs_diff"] <= TOL_TRAIN_LOSS,
          "flash vs plain loss differs by %.3g" % gc["loss_abs_diff"])
    check(gc["grad_max_rel_l2"] <= TOL_TRAIN_GRAD,
          "flash vs plain gradient of %s: rel L2 %.3g"
          % (gc["grad_worst"], gc["grad_max_rel_l2"]))
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
    bwd = phase_kernels_bwd(torch)
    model = phase_model(torch, dev["nvidia_smi"])
    serve = phase_serve(torch, model)
    del model
    torch.cuda.empty_cache()
    train = phase_train(torch, dev["nvidia_smi"])
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "edl_tpu")
    )
    check(not leaked, "imported JAX or the JAX package: %s" % leaked)
    flag = kernels[FLAGSHIP_CASE]
    bflag = bwd[BWD_CASES.index(FLAGSHIP_CASE)]
    line = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "edl_tpu/ops/attention.py:163",
        "launches": train["launches"]["flash_fwd"],
        "launches_by_path": {"serve": serve["flash_launches"],
                             "train": train["launches"]["flash_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernels
                           if r["dtype"] == "bfloat16"),
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "library_ms": flag["library_ms"],
        "shape": flag["shape"],
    }]
    for name, grads, line_no in (("flash_bwd_dq", ("dq",), 349),
                                 ("flash_bwd_dkv", ("dk", "dv"), 386)):
        key = name[len("flash_bwd_"):]
        line.append({
            "name": name,
            "route": "cuda",
            "source": "edl_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": "edl_tpu/ops/attention.py:%d" % line_no,
            "launches": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"][gname] for r in bwd
                               for gname in grads
                               if r["dtype"] == "bfloat16"),
            "ms": bflag["%s_ms" % key],
            # the plain version and the library call compute dq, dk and
            # dv together
            "plain_ms": bflag["plain_ms"],
            "bound_ms": bflag["bounds"][key]["bound_ms"],
            "bound_by": bflag["bounds"][key]["bound_by"],
            "library_ms": bflag["library_ms"],
            "shape": bflag["shape"],
        })
    emit({"kernels": line})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
