#!/usr/bin/env python3
"""Drive edl_tpu_torch's main path once on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. device  - require CUDA; the card's name, count and power limit.
2. build   - compile every CUDA source of the paths from ``ops/csrc``, one
             ``nvcc`` per source, all started together.
3. kernels - each kernel against its plain PyTorch version, on the card,
             at the main paths' shapes and the edge cases of its contract;
             kernel, plain and library times (CUDA events), the bound and
             the host's time to queue one call: the flash forward (the
             flagship case twice, bit for bit), then the backward pair
             (dq, dk/dv).
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
7. elastic - the elastic training path, in three fresh worker processes
             started with the launcher's ``EDL_*`` environment:
             ``ElasticTrainer.fit`` of the flagship (AdamW under
             ``linear_scaled_lr``, 3 seeded batches an epoch) saves each
             epoch into a temporary directory; stage 1 trains epochs 0-1,
             stage 2 restarts, restores (bit for bit what stage 1 saved,
             the stamped parameter norm) and trains epochs 2-3, the
             reference trains 0-3 without a checkpoint. Stage 2's losses
             agree with the reference's, its steps launch 12/12/12 flash
             kernels, the step counter ends at 12. Then two flagship steps
             through the data-parallel wrapper over a one-rank NCCL group
             equal the bare model's. Checkpoint bytes, save and restore
             seconds, the time to recover (spawn to first finished step),
             the trainer's steady step against phase train's and one
             profiled trainer step's device idle share.

Then one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or outside a checkout of the repo, it exits non-zero and
prints no result. Imports nothing of JAX or of the JAX package.
``python3 chip_smoke.py --elastic-child ROLE CKPT_DIR OUT`` is phase
elastic's worker process, started by the phase itself.
"""

import concurrent.futures
import hashlib
import json
import math
import os
import re
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
# the flagship training configuration of phases train and elastic
FLAGSHIP_TRAIN = {"batch": 8, "seq": 2048, "d_model": 1024, "num_heads": 16,
                  "num_kv_heads": None, "num_layers": 12, "d_ff": 2688,
                  "vocab_size": 32000, "remat": "save_flash"}
# phase elastic: stage 1 trains epochs 0-1 and saves, stage 2 restarts and
# trains epochs 2-3 from that checkpoint, the reference trains 0-3 at once
ELASTIC_EPOCHS = 4
ELASTIC_STAGE1_EPOCHS = 2
ELASTIC_BATCHES = 3  # per epoch
ELASTIC_ROLES = ("stage1", "stage2", "reference")
# the reference run's step profiled for the device idle share (epoch 3's
# second step; the steady step time is read from epochs 1 and 2)
ELASTIC_PROFILE_STEP = 10
# resumed epoch losses against the uninterrupted run's: relative
TOL_RESUME = 1e-3
# DDP over a one-rank group against the bare model, two steps: relative
TOL_DDP = 1e-6


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


def _ptxas_lines(log: str) -> list:
    """Each kernel's registers and spills, and any wgmma serialisation
    ptxas reports (its "Potential Performance Loss" lines), with the
    mangled names cut to kernel<head_dim>."""
    out = []
    for ln in log.splitlines():
        if not ("registers" in ln or "spill" in ln or "Compiling entry" in ln
                or "Potential Performance Loss" in ln):
            continue
        ln = ln.strip()
        m = re.search(r"\d(flash_\w+?_kernel)ILi(\d+)", ln)
        if m:
            ln = re.sub(r"'_Z[^']*'", "%s<%s>" % m.groups(), ln, count=1)
        out.append(ln)
    return out


def phase_build() -> dict:
    from edl_tpu_torch.ops import _build

    t0 = time.monotonic()
    regs = {}
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = {name: pool.submit(_build.build, name) for name in SOURCES}
        for name, fut in builds.items():
            _lib, log = fut.result()
            _build.load(name)
            regs[name] = _ptxas_lines(log)
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
            if idx == FLAGSHIP_CASE:
                # no atomics: a second run gives the same bits
                o2, lse2 = flash_forward(q, k, v, causal=causal)
                check(torch.equal(o, o2) and torch.equal(lse, lse2),
                      "flash forward does not repeat bit for bit")
                del o2, lse2
            ms = time_ms(torch, lambda: flash_forward(q, k, v, causal=causal))
            # the host's side of one call (operand checks, outputs, tensor
            # maps, the launch)
            fwd_host_us = host_us(
                torch, lambda: flash_forward(q, k, v, causal=causal))
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
            "library_max_abs_err": library_err, "fwd_host_us": fwd_host_us,
        }
        rec.update(_bound(case))
        # the products the kernel needs over its time, and its bound over
        # its time (1 = as fast as the card allows)
        rec["tflops"] = rec["ops"] / ms / 1e9
        rec["bound_share"] = rec["bound_ms"] / ms
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


def host_us(torch, fn, n: int = 20) -> float:
    """Mean host time of queueing ``fn`` (µs), with a spin kernel holding
    the stream so that the launches never wait for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(100 * 1.98e6))  # 100 ms at the boost clock
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return out


def phase_kernels_bwd(torch) -> list:
    from edl_tpu_torch.ops.attention import (
        _block_grads_reference,
        _bwd_delta,
        flash_backward,
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
            # the host's side of one backward as the training step calls it
            # (operand checks, padded lse/delta rows, tensor maps, launches)
            bwd_host_us = host_us(torch, lambda: flash_backward(*args))
        library, lib_grads = _library_bwd(torch, q, k, v, g, causal)
        with torch.no_grad():
            lib_err = max((a.float() - c.float()).abs().max().item()
                          for a, c in zip(lib_grads, (dq, dk, dv)))
        library_ms = time_ms(torch, library, budget_ms=200.0)
        bounds = _bwd_bounds(case)
        rec = {
            "phase": "kernel_bwd", "shape": [b, h, h_kv, tq, tk, d],
            "causal": causal, "dtype": dtype, "max_abs_err": errs,
            "tol": tols, "dq_ms": ms_dq, "dkv_ms": ms_dkv,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_vs_kernel_max_abs_diff": lib_err,
            "bounds": bounds,
            # the products each kernel needs over its time, and its bound
            # over its time (1 = as fast as the card allows)
            "dq_tflops": bounds["dq"]["ops"] / ms_dq / 1e9,
            "dkv_tflops": bounds["dkv"]["ops"] / ms_dkv / 1e9,
            "bound_share": {"dq": bounds["dq"]["bound_ms"] / ms_dq,
                            "dkv": bounds["dkv"]["bound_ms"] / ms_dkv},
            "bwd_host_us": bwd_host_us,
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

    cfg = FLAGSHIP_TRAIN
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


def elastic_env(role: str, base=None) -> dict:
    """The environment the launcher gives the one worker of a one-worker
    stage (``edl_tpu/launch/process.py`` ``worker_env``): job, pod, stage,
    rank 0 of 1 and the spawn stamp the time to recover starts from. Each
    stage of the phase is its own stage token, as after a restart; the
    reference run is a job of its own."""
    env = dict(os.environ if base is None else base)
    for key in ("EDL_COORDINATOR", "EDL_STORE_ENDPOINT", "EDL_CKPT_PATH",
                "EDL_CKPT_LOCAL_DIR", "EDL_HOT_RESTAGE", "EDL_WARM_ONLY",
                "EDL_WORKER_ENDPOINTS"):
        env.pop(key, None)
    env.update({
        "EDL_JOB_ID": ("chip-smoke-reference" if role == "reference"
                       else "chip-smoke-elastic"),
        "EDL_POD_ID": "pod-0",
        "EDL_STAGE": "stage-" + role,
        "EDL_WORKER_RANK": "0",
        "EDL_WORKER_RANK_IN_POD": "0",
        "EDL_NUM_WORKERS": "1",
        "EDL_SPAWN_TS": repr(time.time()),
        "PYTHONPATH": HERE + os.pathsep + env.get("PYTHONPATH", ""),
    })
    return env


def state_digest(torch, state) -> dict:
    """sha256 of every tensor a checkpoint of ``state`` holds, by name:
    the parameters, the optimizer's state (AdamW's moments and step
    counts), the train step and the optimizer's update count."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.apply_fn,
                                        state.opt_state.optimizer)
    tensors = {"model/" + k: v for k, v in model_sd.items()}
    for name, slots in optim_sd["state"].items():
        for slot, v in slots.items():
            if torch.is_tensor(v):
                tensors["optim/%s/%s" % (name, slot)] = v
    tensors["step"] = state.step
    tensors["count"] = torch.tensor(state.opt_state.count)
    out = {}
    for key, t in sorted(tensors.items()):
        raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        out[key] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


def elastic_data(cfg: dict):
    """``data_fn(epoch)``: the epoch's ``ELASTIC_BATCHES`` next-token
    batches, seeded by the epoch (the same in every run)."""
    import numpy as np

    def data_fn(epoch):
        rng = np.random.RandomState(1000 + epoch)
        for _ in range(ELASTIC_BATCHES):
            tok = rng.randint(0, cfg["vocab_size"],
                              (cfg["batch"], cfg["seq"] + 1)).astype(np.int64)
            yield tok[:, :-1], tok[:, 1:]

    return data_fn


def _spans(events, name):
    return [ev for ev in events if ev.get("name") == name and "dur" in ev]


def _profiling_step(torch, rec, at_call: int):
    """A ``make_train_step`` whose step number ``at_call`` (0-based) runs
    under the profiler and records its device breakdown in ``rec``."""
    from edl_tpu_torch.train import loop as train_loop

    make = train_loop.make_train_step

    def make_profiled(*args, **kwargs):
        inner = make(*args, **kwargs)
        calls = [0]

        def step(state, batch):
            calls[0] += 1
            if calls[0] - 1 != at_call:
                return inner(state, batch)
            out = []
            rec["profile"] = _device_breakdown(
                torch, lambda: out.append(inner(state, batch)))
            return out[0]

        return step

    train_loop.make_train_step = make_profiled


def _timed(torch, rec, key, module, name):
    """Wrap ``module.name``: its time (synchronised) lands in ``rec[key]``."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec[key] = time.monotonic() - t0
        return out

    setattr(module, name, timed)


def _digesting_restore(torch, rec):
    """Wrap ``CheckpointManager.restore``: the time of the restore the
    trainer makes, then the digest of what it restored and the restored
    parameter norm against the fingerprint stamped at save."""
    from edl_tpu_torch.checkpoint import manager
    from edl_tpu_torch.obs.numerics import host_param_norm

    restore = manager.CheckpointManager.restore

    def digesting(self, template, step=None):
        t0 = time.monotonic()
        state, status = restore(self, template, step)
        torch.cuda.synchronize()
        rec["restore_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        rec["restored_digest"] = state_digest(torch, state)
        rec["restored_epoch"] = status.epoch if status else None
        fp = ((status.meta or {}).get("numerics") or {}) if status else {}
        rec["stamped_param_norm"] = fp.get("param_norm")
        rec["restored_param_norm"] = host_param_norm(state)
        rec["digest_s"] = time.monotonic() - t0
        return state, status

    manager.CheckpointManager.restore = digesting


def elastic_child(torch, role: str, ckpt_dir: str, out_path: str) -> None:
    """One fresh worker process of phase elastic, launched with the
    environment of :func:`elastic_env`: ``ElasticTrainer.fit`` of the
    flagship (AdamW under ``linear_scaled_lr(1e-3, 1)``, per-epoch saves
    into ``ckpt_dir``; the reference saves nothing), to epoch 2 (stage1)
    or 4. Writes what it measured to ``out_path`` as JSON."""
    from edl_tpu_torch.obs import trace as obs_trace
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import (
        AdjustRegistry,
        ElasticTrainer,
        adamw,
        linear_scaled_lr,
    )

    spawn_ts = float(os.environ["EDL_SPAWN_TS"])
    # the interpreter, torch and CUDA's first touch
    rec = {"role": role, "import_s": time.time() - spawn_ts}
    cfg = FLAGSHIP_TRAIN
    from edl_tpu_torch.train import loop as train_loop

    # the weights' init on the card and the optimizer's construction (the
    # first in a process imports torch._dynamo)
    _timed(torch, rec, "create_state_s", train_loop, "create_state")
    if role == "stage2":
        _digesting_restore(torch, rec)
    if role == "reference":
        _profiling_step(torch, rec, ELASTIC_PROFILE_STEP)
    adjusts = AdjustRegistry()
    adjusts.register(linear_scaled_lr(1e-3, 1))
    t0 = time.monotonic()
    model = lm_bench.build_model(cfg, "cuda")
    torch.cuda.synchronize()
    rec["model_build_s"] = time.monotonic() - t0
    trainer = ElasticTrainer(
        model,
        lambda overrides: adamw(overrides["lr"]),
        lm_bench.lm_loss,
        ckpt_dir=None if role == "reference" else ckpt_dir,
        adjusts=adjusts,
        seed=0,
        device="cuda",
    )
    epochs = ELASTIC_STAGE1_EPOCHS if role == "stage1" else ELASTIC_EPOCHS
    losses = {}
    _zero_counts()  # the elastic path's run starts here
    state = trainer.fit(
        elastic_data(cfg), epochs,
        on_epoch_end=lambda e, m: losses.__setitem__(e, float(m["loss"])),
    )
    torch.cuda.synchronize()
    rec["launches"] = _launch_counts()
    rec["losses"] = {str(e): v for e, v in sorted(losses.items())}
    rec["step"] = int(state.step)
    events = obs_trace.get_tracer().to_events()
    first = _spans(events, "first_step")[0]
    # the child's start (the parent's spawn stamp) to its first finished
    # step, less the digest this phase adds inside the restore
    rec["time_to_recover_s"] = (
        (first["ts"] + first["dur"]) / 1e6 - spawn_ts - rec.get("digest_s", 0.0))
    rec["first_step_s"] = first["dur"] / 1e6
    # spawn to init() in fit, and init() to the stage barrier's end
    # (device placement, weights, the restore)
    rec["boot_s"] = _spans(events, "worker_boot")[0]["dur"] / 1e6
    rec["setup_s"] = _spans(events, "train_setup")[0]["dur"] / 1e6
    rec["save_s"] = [ev["dur"] / 1e6 for ev in _spans(events, "ckpt_save")]
    rec["epoch_ms_per_step"] = {
        str(ev["args"]["epoch"]): ev["dur"] / 1e3 / ev["args"]["steps"]
        for ev in _spans(events, "train_epoch")}
    if role == "stage1":
        rec["digest"] = state_digest(torch, state)
    with open(out_path, "w") as fh:
        json.dump(rec, fh)


def _ddp_check(torch) -> dict:
    """Two flagship steps through ``parallel.data_parallel`` over a
    one-rank NCCL process group against the same steps of the bare model:
    the losses must agree (a one-rank all-reduce and the average over one
    rank change nothing)."""
    import torch.distributed as dist

    from edl_tpu_torch.parallel import data_parallel, make_mesh
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.utils.net import find_free_ports

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="tcp://127.0.0.1:%d" % find_free_ports(1)[0],
        world_size=1, rank=0)
    try:
        runs = {}
        for wrapped in (False, True):
            state, step, batch = lm_bench.build(FLAGSHIP_TRAIN, "cuda", seed=0)
            if wrapped:
                state.apply_fn = data_parallel(state.apply_fn,
                                               make_mesh(device="cuda"))
            losses = []
            for _ in range(2):
                state, m = step(state, batch)
                losses.append(m["loss"])
            runs[wrapped] = [float(v) for v in torch.stack(losses).tolist()]
            kind = type(state.apply_fn).__name__
            del state, step, batch, m
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs[True], runs[False]))
    return {"backend": "nccl", "world_size": 1, "wrapper": kind,
            "losses_wrapped": runs[True], "losses_bare": runs[False],
            "max_rel_diff": rel, "bit_equal": runs[True] == runs[False],
            "tol": TOL_DDP}


def phase_elastic(torch, smi: str, train: dict) -> dict:
    """The elastic training path: three fresh processes of the worker the
    launcher would start (``elastic_child``): stage 1 trains to epoch 2
    and checkpoints, stage 2 restarts from that checkpoint and trains to
    epoch 4, the reference trains to epoch 4 without one. Then the DDP
    check. The checkpoint directory is removed afterwards."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="edl-elastic-")
    ckpt = os.path.join(work, "ckpt")
    recs, logs = {}, {}
    try:
        for role in ELASTIC_ROLES:
            out = os.path.join(work, role + ".json")
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--elastic-child", role, ckpt, out],
                capture_output=True, text=True, env=elastic_env(role),
                cwd=HERE, timeout=600,
            )
            logs[role] = proc.stdout.splitlines()
            if proc.returncode != 0:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
                raise AssertionError("elastic %s exited %d"
                                     % (role, proc.returncode))
            with open(out) as fh:
                recs[role] = json.load(fh)
        ckpt_bytes = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(os.path.join(ckpt, str(
                ELASTIC_EPOCHS * ELASTIC_BATCHES)))
            for f in files)
        steps = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ddp = _ddp_check(torch)
    s1, s2, ref = (recs[r] for r in ELASTIC_ROLES)
    resumed = [ln for ln in logs["stage2"] if "resumed at epoch" in ln]
    rel = {e: abs(s2["losses"][e] - ref["losses"][e]) / abs(ref["losses"][e])
           for e in s2["losses"]}
    steps2 = (ELASTIC_EPOCHS - ELASTIC_STAGE1_EPOCHS) * ELASTIC_BATCHES
    per_step = {k: v / steps2 for k, v in s2["launches"].items()}
    steady = [ref["epoch_ms_per_step"][str(e)] for e in (1, 2)]
    steady_ms = sum(steady) / len(steady)
    prof = ref.get("profile") or {}
    out = {
        "phase": "elastic", "config": "flagship",
        "tokens": [FLAGSHIP_TRAIN["batch"], FLAGSHIP_TRAIN["seq"]],
        "optimizer": "adamw, linear_scaled_lr(1e-3, 1)",
        "epochs": ELASTIC_EPOCHS, "batches_per_epoch": ELASTIC_BATCHES,
        "losses": {r: recs[r]["losses"] for r in ELASTIC_ROLES},
        "resumed_line": resumed[0] if resumed else None,
        "resume_rel_diff": rel, "tol_resume": TOL_RESUME,
        "resume_bit_identical": all(
            s2["losses"][e] == ref["losses"][e] for e in s2["losses"]),
        "restored_tensors": len(s2["restored_digest"]),
        "restored_equals_saved": s2["restored_digest"] == s1["digest"],
        "stamped_param_norm": s2["stamped_param_norm"],
        "restored_param_norm": s2["restored_param_norm"],
        "step": s2["step"], "launches": s2["launches"],
        "launches_per_step": per_step,
        "checkpoint_bytes": ckpt_bytes, "checkpoint_steps_kept": steps,
        "save_s": s1["save_s"] + s2["save_s"],
        "restore_s": s2["restore_s"], "digest_s": s2["digest_s"],
        "time_to_recover_s": s2["time_to_recover_s"],
        # the same span in the runs that restore nothing
        "time_to_first_step_s": {r: recs[r]["time_to_recover_s"]
                                 for r in ELASTIC_ROLES},
        "recovery_breakdown_s": {
            r: {k: recs[r].get(k) for k in (
                "import_s", "model_build_s", "boot_s", "setup_s",
                "create_state_s", "restore_s", "digest_s", "first_step_s")}
            for r in ELASTIC_ROLES},
        "epoch_ms_per_step": {r: recs[r]["epoch_ms_per_step"]
                              for r in ELASTIC_ROLES},
        "trainer_step_ms": steady_ms, "train_step_ms": train["step_ms"],
        "trainer_overhead": steady_ms / train["step_ms"],
        "profiled_step": prof,
        "device_idle_share_steady": (
            1.0 - prof["device_ms"] / steady_ms
            if prof.get("device_ms") else None),
        "ddp": ddp, "card": smi,
    }
    emit(out)
    for r in ELASTIC_ROLES:
        vals = list(recs[r]["losses"].values())
        check(all(math.isfinite(v) for v in vals),
              "elastic %s loss not finite: %s" % (r, vals))
    ref_losses = [ref["losses"][str(e)] for e in range(ELASTIC_EPOCHS)]
    check(ref_losses[-1] < ref_losses[0],
          "elastic loss did not fall: %s" % ref_losses)
    check(bool(resumed) and "resumed at epoch %d" % ELASTIC_STAGE1_EPOCHS
          in resumed[0], "stage 2 did not resume at epoch %d: %s"
          % (ELASTIC_STAGE1_EPOCHS, logs["stage2"][-10:]))
    check(sorted(s2["losses"]) == [str(e) for e in range(
        ELASTIC_STAGE1_EPOCHS, ELASTIC_EPOCHS)],
          "stage 2 trained epochs %s" % sorted(s2["losses"]))
    check(out["restored_equals_saved"],
          "stage 2's restored state differs from stage 1's saved state")
    check(max(rel.values()) <= TOL_RESUME,
          "resumed losses differ from the uninterrupted run: %s" % rel)
    check(s2["step"] == ELASTIC_EPOCHS * ELASTIC_BATCHES,
          "step %d after epoch %d" % (s2["step"], ELASTIC_EPOCHS))
    layers = FLAGSHIP_TRAIN["num_layers"]
    want = {k: layers for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    check(per_step == want,
          "elastic launches per step %s != %s" % (per_step, want))
    check(s2["stamped_param_norm"] is not None and abs(
        s2["restored_param_norm"] - s2["stamped_param_norm"])
          <= 1e-4 * s2["stamped_param_norm"],
          "restored param norm %r vs stamped %r" % (
              s2["restored_param_norm"], s2["stamped_param_norm"]))
    check(ddp["max_rel_diff"] <= TOL_DDP,
          "DDP over one NCCL rank changed the losses: %s" % ddp)
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
    if sys.argv[1:2] == ["--elastic-child"]:
        elastic_child(torch, *sys.argv[2:5])
        return 0
    dev = phase_device(torch)
    phase_build()
    kernels = phase_kernels(torch)
    bwd = phase_kernels_bwd(torch)
    model = phase_model(torch, dev["nvidia_smi"])
    serve = phase_serve(torch, model)
    del model
    torch.cuda.empty_cache()
    train = phase_train(torch, dev["nvidia_smi"])
    elastic = phase_elastic(torch, dev["nvidia_smi"], train)
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
                             "train": train["launches"]["flash_fwd"],
                             "elastic": elastic["launches"]["flash_fwd"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernels
                           if r["dtype"] == "bfloat16"),
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "bound_share": flag["bound_share"],
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
            "launches_by_path": {"train": train["launches"][name],
                                 "elastic": elastic["launches"][name]},
            "max_abs_err": max(r["max_abs_err"][gname] for r in bwd
                               for gname in grads
                               if r["dtype"] == "bfloat16"),
            "ms": bflag["%s_ms" % key],
            # the plain version and the library call compute dq, dk and
            # dv together
            "plain_ms": bflag["plain_ms"],
            "bound_ms": bflag["bounds"][key]["bound_ms"],
            "bound_by": bflag["bounds"][key]["bound_by"],
            "bound_share": bflag["bound_share"][key],
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
