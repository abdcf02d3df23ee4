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
             tokens/s, MFU, peak memory and device time by kernel. The
             same ten steps with the numerics bundle (GNS off: 12/12/12)
             and with the half-batch GNS passes, the trainer's default
             (24/24/24), each with its host enqueue and device time. The
             planes on the card: the bundle against a float64 recompute
             from the step's own gradients and parameters, the mean of the
             half-batch gradients against the full batch's, a planted
             non-finite count; ``step_cost``'s FLOPs of the first step
             beside the model count; a ``CaptureController`` window's
             ``torch.profiler`` trace naming the three kernels; the memory
             plan of the first step against ``max_memory_allocated``; an
             impossible allocation caught by ``oom_guard`` with its
             forensics. Then one step's loss and gradients at [2, 2048]
             against the same model with the plain attention.
7. elastic - the elastic training path through the port's own control
             plane: a ``python -m edl_tpu_torch.store.server`` child and
             ``python -m edl_tpu_torch.launch`` pods around the flagship
             worker, cut to 4 of its 12 layers (``ElasticTrainer.fit``,
             AdamW under
             ``linear_scaled_lr``, 3 seeded global batches of [8, 2048]
             an epoch, per-epoch checkpoints). Two jobs run the same
             membership schedule — one pod; at epoch 1 a second joins
             (1 → 2: two ranks on the one card, gloo over its tensors);
             at epoch 2 the joiner is SIGKILLed (2 → 1) — each change
             waiting for the previous epoch's checkpoint:
             (a) cold: the launcher kills and respawns its workers, and
             every new worker restores bit for bit what was saved, its
             parameter norm equals the fingerprint stamped at save, and
             its losses agree with the reference's;
             (b) hot (``--hot_restage``): the first pod's worker keeps
             one pid through the three stages, and its losses equal
             (a)'s epoch by epoch; then (c) SIGTERM to its launcher
             drains it: exit 76, the preemption key, an emergency
             version past the last periodic one, and a new pod of the
             job resumes from it. Every step of every worker launches
             4/4/4 flash kernels. A reference trains the same epochs
             in one process at world 1, with the learning rate the jobs'
             stages set (``linear_scaled_lr`` doubles it at world 2):
             the trainer's steady step, one profiled step's device idle
             share. Two flagship steps
             through the data-parallel wrapper over a one-rank NCCL
             group equal the bare model's. Times to recover (cold: spawn
             and drain-token bump to the first finished step; hot: bump
             to the first finished step, keeping the state; and a warm
             rebuild of the state in the survivor),
             checkpoint bytes, save, restore and emergency-save
             seconds. The trainer runs its four planes at their defaults
             (GNS on: 8/8/8 launches a step): every restore leaves a
             ``numerics_resume`` record with ``ok`` true and a finite
             stamped loss, the goodput ledger passes
             ``goodput_accounted``, the two world-2 ranks' digests agree
             (divergence 0); each job's goodput fraction, by process.
8. tiers   - the checkpoint tiers under the flagship worker of phase
             elastic, on the port's control plane: each pod saves into a
             pod-local dir (``EDL_CKPT_LOCAL_BASE``) with async saves
             (``async_save=True``), its launcher holds one peer's replicas
             (``EDL_CKPT_REPLICAS=1``) and the durable dir is the mirror.
             Pod A starts alone (rank slot 0: the saver); at epoch 1 pod B
             joins (two ranks on the one card, gloo); once a world-2
             version is replicated to B's holder, A's session is
             SIGKILLed and A's local dir, its replica dir and the whole
             durable dir are deleted, and pod C starts. B restores from
             its own holder, C from B's: both from the peer tier, at the
             replicated step (the lost work), with no durable read after
             the kill. After epoch 3's first step the stage's saver pod
             gets SIGTERM: it pushes its last version within the drain
             budget and exits 76, and the survivor restores that version
             from the peer tier and completes the job. Every restore
             equals bit for bit the digest taken when its version was
             staged, its parameter norm the stamped fingerprint; every
             restore's ``numerics_resume`` is ok; ``goodput_accounted``;
             8/8/8 launches a step in every worker. Reports each async
             save's blocking seconds, its wait on the previous save and
             its background write; each push's seconds and GB/s and the
             replica lag; each peer restore (fetch, verify and land; DCP
             load) beside a durable restore of the same version on this
             host; the time from the kill to the first step; the codec's
             cost on one file of the version.
9. trainee - (run beside phase tiers, in a thread of its own)
             ``edl_tpu_torch/chaos/trainee.py`` on the card under the
             port's store and launcher: one pod, 12 steps, a checkpoint
             every 4, an ``EDL_CHAOS`` rule that kills rank 0 at its 7th
             step; a replacement pod resumes and completes the job,
             audited by the port's ``chaos/invariants.py`` (completed,
             shards exactly once, resumed past the fault, numerics
             continuous, goodput accounted).
10. resnet - ResNet50_vd, the JAX package's flagship collective-training
             model: (a) one train step at [8, 64, 64, 3] on the card
             (bf16) against the port's CPU step in fp32 from the same
             seeded weights: logits, loss, running averages, and the
             parameters' updates against what bf16 alone moves them by
             (the same step on the CPU in bf16); (b) the headline bench's
             ``measure()`` (``tools/bench.py``) at batch 256, 224x224,
             pipeline input: img/s, step ms, host enqueue against device
             ms, MFU, peak memory, one profiled step's device time by
             class, the idle share; (c) the port's
             ``examples/resnet_collective.py`` under the port's store and
             launcher, cold, phase elastic's schedule (1 -> 2 -> 1, two
             ranks on the one card over gloo) at 64 images a worker,
             3 steps an epoch, 4 epochs: every restore equals bit for bit
             the digest taken at save (parameters, BN buffers, momentum),
             the world-2 ranks' BN buffers agree after every step, each
             step's global loss agrees with a world-1 run of the schedule
             on the concatenated batches in this process, and the time to
             recover. No kernel of K1-K3 lies on this path.
11. fsdp   - ResNet50_vd at 224x224 under FSDP2 (``parallel.
             shard_params_fsdp``): (a) built on ``meta``, sharded over a
             one-rank NCCL group (its parameters ``DTensor``s), drawn by
             ``init_weights(0)``, five SGD steps at batch 256 against the
             unsharded step from the same draws and batches (cuDNN
             deterministic: bit for bit, else 1e-6 relative), then both
             timed at phase resnet's cuDNN settings: step ms, img/s, peak
             memory, host enqueue against device ms; (b) a sharded DCP
             save and a collective restore into a freshly sharded module,
             bit for bit; (c) ``ElasticTrainer(fsdp=True)`` at fsdp 2:
             two pods on the port's store and launcher, two ranks on the
             card over gloo, three steps at a global batch of 32: each
             rank's parameter and momentum bytes half of (a)'s, the
             losses within 1e-3 of world 1 on the same batches, its
             version restored at fsdp 1 on the card and (a)'s fsdp-1
             version restored at fsdp 2, both bit for bit against the
             gathered saved state. No kernel of K1-K3 lies on this path.
12. distill - elastic distillation through the entry points a user runs,
             each a process on the card: the port's store server,
             ``python -m edl_tpu_torch.distill.discovery_server``,
             ``examples.distill_teacher`` and ``examples.distill_student``
             (ResNet50_vd at 224x224 on both sides, the student 2 epochs
             of 8 batches of 32). (a) Teacher A wedges on its 2nd predict
             and is SIGKILLed a second later without deregistering, and a
             replacement C starts; teacher B (``EDL_POD_ID``) gets its
             pod's preemption notice while the student holds at its second
             epoch's start. Every epoch's 8 batches arrive exactly once and
             in order (the labels against the stream's), B leaves every
             assignment within 2.0 s of its drain mark, and the first
             batch's served soft labels equal this process's forward of
             the same seeded teacher. Reports the student's img/s, the
             reader's wait per batch, a teacher's time per request, the
             time from the kill to the next batch, and, each alone, the
             student's synthetic stream per batch and its train step. (b) ``examples.
             distill_nlp``'s teacher (K1, fp32, head width 32) and student
             (K1-K3, fp32, head width 16) at the example's sizes: each
             side's launches equal layers x requests or steps, and the
             student's kd-loss is finite and falls.

13. lm_parallel - the TransformerLM's tensor parallelism, sequence
             parallelism and KV-cached generation: (a) ``tools.
             decode_bench`` at its GPU sizes (batch 8, prompt 512, 32 new
             tokens, d_model 1024, 12 layers, 16 heads, vocab 32000, bf16;
             kv heads 16, 4, 1): tokens/s, prefill ms and ms a token; the
             bf16 model's prefill and cached-step logits against its own
             full forward over the growing sequence, and its greedy
             tokens against the full forward's argmax where the top-2
             margin is decided; (b) ``examples.lm_generate`` (K1-K3 at
             head width 12, fp32): exit 0, ``OK``, 2 layers x 60 steps of
             each kernel; (c) ``examples.lm_long_context`` at its defaults
             (tp 2 x sp 2, 4 layers) as one pod of four ranks on the card
             (gloo) through the port's store and launcher, against the
             same seeded run at world 1: losses step by step, each sp
             rank s launching s + 1 of each kernel per layer and step,
             the step's ms, host enqueue and one profiled step's device
             time, the ring transport's share; (d) Ulysses at sp 2 (two
             ranks, gloo; H 8, kv 2 and 1, bf16, T 4096) against one
             rank's flash on the whole sequence, out and dq/dk/dv; (e) a
             GQA model at decode_bench's width with one kv head at tp 2
             (the replicate fallback): one AdamW step against world 1,
             then greedy_generate's tokens, fp32; the same two-rank launch
             also runs phase moe's (c).
14. moe    - the Switch MoE FFN (``models/moe.py``): (a) the flagship LM
             with the JAX defaults' MoE (8 experts in every second block:
             six MoE blocks, about 430 M parameters; bf16, ``save_flash``)
             trains 10 steps at [8, 2048] through ``make_train_step(
             aux_losses=True)``: losses finite and falling, the aux loss
             above 0 on every step, 12 launches of each of K1-K3 a step;
             step ms, host enqueue against one profiled step's device time
             by class (attention, matrix products, dispatch, optimizer),
             peak memory, each MoE block's share of dropped routes, and
             one MoE block's forward by part (routing, the expert path,
             its two batched products alone, forward + backward); (b)
             ``SwitchMoE`` at the flagship's widths, top_k 1 and 2, and a
             2-layer MoE LM's two AdamW steps, fp32, on the card and on the
             CPU from the same weights: outputs and losses within 1e-5,
             the served routes equal; (c) expert parallelism at ep 2 (two
             gloo ranks on the card, in phase lm_parallel's tp launch): the
             MoE LM at the flagship's widths cut to 4 layers, fp32, 3
             steps at 2 x 2048 against world 1 on the same card: losses
             and aux losses within 1e-5, gathered parameters within 1e-3,
             each rank holding 4 of the 8 experts.
15. pipeline - pipeline parallelism (``parallel.pipeline``,
             ``pipeline_1f1b``, ``pipeline_lm``): (a) the flagship LM at
             its full width (12 layers, 6 a stage) at pp 2, two gloo ranks
             on the card (phase lm_parallel's launch; the stage-to-stage
             hops staged through pinned host memory), GPipe and 1F1B at
             M 4 and 8 on [8, 2048]: in fp32 each schedule's loss and its
             stages' gradients against the flat model's (relative L2
             1e-4); in bf16 three AdamW steps of each against world 1's
             (losses 1e-3), each step's ms, its hops' ms and MB and their
             share of the step against the ideal bubble
             ``1 - pipeline_efficiency``, each rank's peak memory (1F1B's
             must not grow from M 4 to M 8) and microbatches held, and
             K1-K3's launches per rank (1F1B's K1 twice: the backward
             recomputes its stage); (b) four gloo ranks, 1F1B at pp 2 x dp
             2 and at pp 4, the flagship's widths at 4 layers, fp32,
             against world 1.
16. ctr    - the CTR family: (a) ``python -m edl_tpu_torch.examples.
             ctr_train`` at DeepFM's defaults (vocab 1,000,000, embed 16,
             MLP 256/128/64, bf16), batch 256, 200 Adam steps: exit 0, its
             printed lines, the final train AUC above 0.51 and above its
             step-50 reading; the DeepFM step's ms, peak memory and device
             time by class; (b) mp 2 (phase lm_parallel's launch), the
             tables split over mp, three fp32 Adam steps against world 1:
             losses and gathered parameters within 1e-6; (c)
             ``chain(topk_compression(0.01), sgd)`` three steps on
             DeepFM's parameters, the card against the CPU within 1e-6;
             (d) the DGC threshold of a [32000, 1024] tensor against
             numpy's percentile, within one fp32 ulp.

Then one JSON line of per-kernel results, the ``nvidia-smi`` name and
power-limit line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or outside a checkout of the repo, it exits non-zero and
prints no result. Imports nothing of JAX or of the JAX package.
``python3 chip_smoke.py --elastic-child OUT`` and
``python3 chip_smoke.py --elastic-launched OUT_DIR`` are phase elastic's
worker processes (the reference, and the worker the launcher spawns),
``python3 chip_smoke.py --resnet-launched OUT_DIR -- ARGS`` phase
resnet's, ``python3 chip_smoke.py --fsdp-launched OUT_DIR FSDP1_DIR`` phase
fsdp's, ``python3 chip_smoke.py --lm-launched OUT_DIR RANK PORT``
phase lm_parallel's two-rank workers (they also run phase moe's (c),
phase pipeline's (a) and phase ctr's (b)), ``python3 chip_smoke.py
--pp-launched OUT_DIR RANK PORT`` phase pipeline's four-rank workers, all
started by the phases themselves.
"""

import concurrent.futures
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import threading
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
    ((16, 4, 4, 64, 64, 16), True, "float32"),         # nlp student, D 16
    # widths without a body of their own (zero-padded to the next body):
    ((16, 4, 2, 24, 24, 12), True, "float32"),         # lm_generate, D 12
    ((2, 16, 16, 1024, 1024, 16), True, "bfloat16"),   # bf16 at D 16
    ((2, 4, 2, 1024, 1024, 12), True, "bfloat16"),     # bf16 at D 12
    ((2, 4, 1, 256, 256, 4), True, "float32"),         # GQA dry run, D 4
    # phase lm_parallel's paths at their shapes:
    ((8, 4, 4, 1024, 1024, 32), False, "bfloat16"),    # ring, a full step
    ((2, 4, 1, 4096, 4096, 64), True, "bfloat16"),     # Ulysses, kv 1
    ((2, 8, 1, 256, 256, 64), True, "float32"),        # tp 2 step, kv 1
)
FLAGSHIP_CASE = 0
STUDENT_CASE = 9  # distill_nlp's student: fp32, head width 16
WIDTH_CASES = {"fp32-d12": 10, "bf16-d16": 11, "bf16-d12": 12, "fp32-d4": 13}
# the backward pair runs on the training path: K1's cases but the served
# buckets
BWD_CASES = (0, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
SOURCES = ("flash_fwd", "flash_bwd")
SERVE_SEQ = 1024
SERVE_ROWS = (1, 3)
TRAIN_STEPS = 10
GRAD_CHECK_BATCH = 2
# the flagship training configuration of phases train and elastic
FLAGSHIP_TRAIN = {"batch": 8, "seq": 2048, "d_model": 1024, "num_heads": 16,
                  "num_kv_heads": None, "num_layers": 12, "d_ff": 2688,
                  "vocab_size": 32000, "remat": "save_flash"}
# phases elastic and tiers (one worker) train the flagship cut in depth to
# 4 of its 12 layers, its widths as they are: the script's time limit
ELASTIC_TRAIN = dict(FLAGSHIP_TRAIN, num_layers=4)
# phase elastic: 4 epochs of 3 global batches; a second pod joins when
# the first stage reaches epoch 1, the joiner dies when the second reaches
# epoch 2; the hot job drains after epoch 3's first step
ELASTIC_EPOCHS = 4
ELASTIC_BATCHES = 3  # per epoch
ELASTIC_JOIN_EPOCH = 1
ELASTIC_KILL_EPOCH = 2
ELASTIC_DRAIN_EPOCH = 3
ELASTIC_TTL = 2.0  # the launchers' lease: a SIGKILLed pod is gone after it
ELASTIC_DRAIN_BUDGET = 60.0  # covers one flagship save (5-6.4 s)
ELASTIC_WAIT_S = 300.0  # one membership change, cold starts included
# the worker holds after a hold so the trainer's own store watch has seen
# the change too before the next batch reaches it
ELASTIC_SETTLE_S = 1.0
# the reference run's step profiled for the device idle share (epoch 3's
# second step; the steady step time is read from epochs 1 and 2)
ELASTIC_PROFILE_STEP = 10
# hot against cold, each epoch's loss: relative (predicted bit-identical)
TOL_HOT_VS_COLD = 1e-6
# the cold job against the reference, each epoch's loss: relative. Epoch 0
# is bit-identical; the world-2 epoch splits each batch over two ranks
# (other GEMM shapes, a two-rank gradient average), so the later epochs
# are not. A stage that missed its world's learning rate differs by
# 1.5e-3 to 4.3e-3 (measured on an H100: the world-1 rate throughout
# against the cold job).
TOL_RESUME = 1e-3
# a restored parameter norm against the fingerprint stamped at save
TOL_PARAM_NORM = 1e-4
# DDP over a one-rank group against the bare model, two steps: relative
TOL_DDP = 1e-6
# phase trainee: the port's chaos trainee, one pod, 12 steps, a
# checkpoint every 4; the chaos rule kills rank 0 at its 7th step (step 6)
TRAINEE_STEPS = 12
TRAINEE_CKPT_EVERY = 4
TRAINEE_KILL_AFTER = 7
TRAINEE_WAIT_S = 120.0
# phase tiers: phase elastic's schedule and worker on the checkpoint
# tiers (a pod-local dir per pod under EDL_CKPT_LOCAL_BASE, one peer
# replica, async saves, the durable dir as the mirror). One replication
# pass hashes the 2.58 GB version, sends it, and the holder hashes and
# fsyncs it: 16.1-19.3 s a pass on an H100's host (PERF.md), and a
# peer assembly 13.4-18.5 s, both cut by the default 10 s budget
# (EDL_CKPT_REPL_BUDGET); the phase reports each pass's seconds
TIERS_JOB = "chip-smoke-tiers"
TIERS_REPL_BUDGET = 60.0
# the numerics bundle against its float64 recompute from the same step's
# gradients and parameters: relative (fp32 sums over 2.1e8 elements)
TOL_BUNDLE = 1e-4
# the mean of the two half-batch gradients against the full batch's
# gradient, norms and losses: relative (bf16 products over other row
# groupings and another order of the sums)
TOL_HALVES = 2e-2
# the memory plan published after the first step against
# max_memory_allocated over that step: relative
TOL_PLAN = 2e-2
# phase resnet. (a) one train step of ResNet50_vd at RESNET_CHECK_SHAPE,
# the card (bf16 compute) against the CPU (fp32) from the same weights:
# the logits over max(1, max|cpu|) (bf16 rounds every conv output and
# normalised activation, an ulp is 2^-8 relative, through 50 layers); the
# loss relative; the running averages over max(1, max|cpu|) (fp32
# statistics of those bf16 activations). The parameters' updates, relative
# L2, all as one vector and the worst tensor: bf16 alone moves them by
# 0.15 / 0.23 on the card (the backward's BNs subtract batch means from
# bf16 gradients), so they are held to the same step on the CPU in bf16
# against fp32: at most TOL_RN_UPDATE_RATIO times its error plus
# TOL_RN_UPDATE
RESNET_CHECK_SHAPE = (8, 64, 64, 3)
TOL_RN_LOGITS = 5e-2
TOL_RN_LOSS = 1e-2
TOL_RN_STATS = 2e-2
TOL_RN_UPDATE_RATIO = 1.5
TOL_RN_UPDATE = 2e-2
# (b) the headline bench's measure() at its defaults on the card
RESNET_BENCH_ENV = {"EDL_BENCH_BATCH": "256", "EDL_BENCH_INPUT": "pipeline",
                    "EDL_BENCH_STEPS": "30", "EDL_BENCH_WARMUP": "8"}
# (c) the port's example under the port's launcher, phase elastic's
# schedule (ELASTIC_* above) at 64 images of 224x224 a worker; each step's
# global loss against a world-1 run of the schedule on the concatenated
# batches: relative (bf16 over other batch splits, the world-2 statistics
# as E[x^2] - E[x]^2 over an all-reduce, carried through 12 SGD steps)
RESNET_JOB_BATCH = 64
TOL_RN_JOB = 1e-2
# phase fsdp: ResNet50_vd at 224x224 under FSDP2. (a) five steps at batch
# 256 sharded over a one-rank NCCL group against the unsharded step (cuDNN
# deterministic for both), then timed steps of each; (c) two ranks on the
# card over gloo at a global batch of FSDP_JOB_BATCH, FSDP_JOB_STEPS steps
FSDP_BATCH = 256
FSDP_CHECK_STEPS = 5
FSDP_WARMUP = 3
FSDP_TIMED_STEPS = 10
FSDP_JOB_BATCH = 32
FSDP_JOB_STEPS = 3
TOL_FSDP_STEP = 1e-6  # sharded vs unsharded, relative, when not bit for bit
TOL_FSDP_JOB = 1e-3   # world-2 fsdp-2 losses against world 1
# phase distill: (a) ResNet50_vd teachers at 224x224 serve a ResNet50_vd
# student (2 epochs of 8 batches of 32) through the port's store and
# discovery server. Each teacher gets one warm-up request at the
# student's batch as soon as it serves (its first conv calls pick their
# kernels). Teacher A wedges on its DISTILL_WEDGE_AT-th predict (a chaos
# delay: the first of the student's, which the pool's least-loaded pick
# sends among the epoch's first three) and is SIGKILLed
# DISTILL_KILL_AFTER_S later, mid-epoch,
# without deregistering; a replacement C starts. The student holds
# DISTILL_HOLD_S at its second epoch's start (a chaos delay) while teacher
# B's pod gets its preemption notice: B must leave every assignment within
# DRAIN_GRACE_S of its drain mark (the JAX scenario's bound). The first
# batch's served soft labels against this process's forward of the same
# seeded teacher on the same images: max |diff| over the batch's max
# probability. Both are the same bf16 forward on the same card, so only a
# cuDNN algorithm choice or the bucketed batch can move them; an ulp of
# bf16 is 2^-8 relative and 50 layers carry a few, far below this bound.
# (b) distill_nlp's teacher and student at the example's sizes.
DISTILL_JOB = "chip-smoke-distill"
DISTILL_BATCH = 32
DISTILL_BATCHES = 8  # an epoch of distill_student
DISTILL_EPOCHS = 2
DISTILL_WEDGE_AT = 2  # after the warm-up: A's first from the student
DISTILL_KILL_AFTER_S = 1.0
DISTILL_HOLD_S = 3.0
DRAIN_GRACE_S = 2.0
DISTILL_WAIT_S = 300.0
DISTILL_LATENCY_REQUESTS = 10
TOL_DISTILL_SOFT = 2e-2
NLP_JOB = "chip-smoke-distill-nlp"
NLP_TEACHER_LAYERS = 4
NLP_STUDENT_LAYERS = 2
NLP_EPOCHS = 2
NLP_BATCHES = 8


_EMIT_LOCK = threading.Lock()


def emit(obj) -> None:
    """One JSON line, written whole (phases trainee and tiers run side by
    side)."""
    line = json.dumps(obj) + "\n"
    with _EMIT_LOCK:
        sys.stdout.write(line)
        sys.stdout.flush()


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


def _device_breakdown(torch, fn, classes=None) -> dict:
    """Device time of one synchronised ``fn()`` by kernel (torch.profiler,
    CUPTI): the total, the wall time under the profiler, the flash
    kernels' times and share and the largest kernels; with ``classes``
    (``(name, markers)`` pairs, tried in order) also the time of each
    class of kernel names (``by_class_ms``, the rest under ``other``).
    ``device_ms`` is None where the trace holds no device events."""
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
    host = sorted(
        ((ev.key, ev.self_cpu_time_total / 1e3, ev.count)
         for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: -r[1])[:8]
    flash = {
        name: sum(r[1] for r in kernels if name in r[0])
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    }
    by_class = None
    if classes:
        by_class = {name: 0.0 for name, _ in classes}
        by_class["other"] = 0.0
        for key, ms, _n in kernels:
            name = next((c for c, marks in classes
                         if any(m in key for m in marks)), "other")
            by_class[name] += ms
    return {
        "wall_ms": wall_ms,
        "device_ms": total if kernels else None,
        "device_idle_share": (1.0 - total / wall_ms) if kernels else None,
        "by_class_ms": by_class,
        "flash_ms": flash,
        "flash_share": sum(flash.values()) / total if total else None,
        "top": [{"kernel": k[:80], "ms": ms, "count": n}
                for k, ms, n in kernels[:10]],
        "host_top": [{"op": k[:80], "self_ms": ms, "count": n}
                     for k, ms, n in host],
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
    from edl_tpu_torch.ops.attention import launch_counts

    return launch_counts()


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


def _make_step(numerics: bool, gns):
    """The flagship's train step, with the numerics bundle or without;
    ``gns`` ("0"/"1") is ``EDL_NUMERICS_GNS`` when the step is built (the
    knob is read then, as in the JAX step)."""
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train.step import make_train_step

    saved = os.environ.get("EDL_NUMERICS_GNS")
    if gns is not None:
        os.environ["EDL_NUMERICS_GNS"] = gns
    try:
        return make_train_step(lm_bench.lm_loss, numerics=numerics)
    finally:
        if saved is None:
            os.environ.pop("EDL_NUMERICS_GNS", None)
        else:
            os.environ["EDL_NUMERICS_GNS"] = saved


def _run_steps(torch, state, step, batch, losses=None) -> dict:
    """``TRAIN_STEPS`` steps from a synchronised start: the step time
    (host clock, ending in a fetch of the losses), the launches, the peak
    memory, the host's time to queue one more step (no sync) and that
    step's device time by kernel (torch.profiler)."""
    from edl_tpu_torch.obs.numerics import METRICS_KEY

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    run = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        m.pop(METRICS_KEY, None)
        run.append(m["loss"])
    run = [float(v) for v in torch.stack(run).tolist()]
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    state, _ = step(state, batch)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    breakdown = _device_breakdown(torch, lambda: step(state, batch))
    if losses is not None:
        losses.extend(run)
    return {"state": state, "step_ms": step_ms, "host_enqueue_ms": enqueue_ms,
            "device_ms": breakdown["device_ms"], "launches": launches,
            "launches_per_step": {k: v / TRAIN_STEPS
                                  for k, v in launches.items()},
            "peak_memory_bytes": peak, "profile": breakdown, "losses": run}


def _bundle_check(torch, state, step, batch) -> dict:
    """One step of ``step`` (numerics, GNS on) with its gradients and the
    parameters before and after captured in float64: the bundle against
    its float64 recompute. Before it, the full batch's gradient at the
    same parameters (no update): the mean of the two half-batch
    gradients must have its norm, and the mean of the halves' losses
    its loss."""
    from edl_tpu_torch.obs.numerics import METRICS_KEY
    from edl_tpu_torch.tools import lm_bench

    model = state.apply_fn
    params = [p for p in model.parameters()]
    x, y = batch
    full_loss = lm_bench.lm_loss(model(x), y)[0]
    full_loss.backward()
    full_loss = full_loss.detach()
    full_norm = math.sqrt(sum(float(p.grad.double().square().sum())
                              for p in params))
    full_loss = full_loss.item()
    model.zero_grad(set_to_none=True)
    old = [p.detach().double() for p in params]
    grads = []
    apply = state.apply_gradients

    def capturing(g=None):
        grads.extend(p.grad.detach().double() for p in params)
        return apply(g)

    state.apply_gradients = capturing
    try:
        state, m = step(state, batch)
    finally:
        del state.apply_gradients
    bundle = {k: v.tolist() for k, v in m[METRICS_KEY].items()}
    new = [p.detach().double() for p in params]
    ref = {
        "grad_norm": math.sqrt(sum(float(g.square().sum()) for g in grads)),
        "param_norm": math.sqrt(sum(float(p.square().sum()) for p in new)),
        "update_ratio": (
            math.sqrt(sum(float((a - b).square().sum())
                          for a, b in zip(new, old)))
            / math.sqrt(sum(float(p.square().sum()) for p in old))),
        "nonfinite": float(sum(int((~torch.isfinite(g)).sum()) for g in grads)),
        "loss": float(m["loss"]),
    }
    del grads, old, new
    rel = {k: abs(bundle[k] - ref[k]) / max(abs(ref[k]), 1e-30)
           for k in ("grad_norm", "param_norm", "update_ratio")}
    # the probe's non-finite count on the card: known inf/NaN elements in
    # an fp32 and a bf16 tensor
    from edl_tpu_torch.obs.numerics import device_bundle

    g32 = torch.ones(1 << 20, device="cuda")
    g32[[5, 77, 4096]] = torch.tensor([float("inf"), float("nan"),
                                       -float("inf")], device="cuda")
    g16 = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    g16[[1, 2]] = float("nan")
    probe_count = device_bundle(
        torch.tensor(1.0, device="cuda"), {"a": g32, "b": g16},
        {"a": g32, "b": g16}, {"a": g32, "b": g16})["nonfinite"].item()
    return {"state": state, "bundle": bundle, "float64": ref, "rel": rel,
            "tol_rel": TOL_BUNDLE,
            "halves": {"mean_of_halves_grad_norm": bundle["grad_norm"],
                       "full_batch_grad_norm": full_norm,
                       "grad_norm_rel": abs(bundle["grad_norm"] - full_norm)
                       / full_norm,
                       "mean_of_halves_loss": bundle["loss"],
                       "full_batch_loss": full_loss,
                       "loss_rel": abs(bundle["loss"] - full_loss) / full_loss,
                       "half_sq": bundle["half_sq"], "batch": bundle["batch"],
                       "tol_rel": TOL_HALVES},
            "nonfinite_on_card": {"counted": probe_count, "planted": 5}}


def _capture_check(torch, state, step, batch, out_dir) -> dict:
    """A ``CaptureController.arm_local`` window of 2 steps around the
    flagship step: the ``torch.profiler`` trace it writes, and the
    kernels named in it."""
    import types

    from edl_tpu_torch.obs import profile as obs_profile

    env = types.SimpleNamespace(job_id="chip-smoke", pod_id="train",
                                rank_in_pod=0, global_rank=0,
                                store_endpoint="")
    cap = obs_profile.CaptureController(env)
    cap.arm_local(out_dir, start_after=0, steps=2)
    try:
        for _ in range(3):  # the window opens after the first step
            state, _m = step(state, batch)
            cap.on_step(sync=torch.cuda.synchronize)
    finally:
        cap.close()
    paths = []
    for d, _, files in os.walk(out_dir):
        paths += [os.path.join(d, f) for f in files
                  if f == obs_profile.TRACE_FILE]
    names = set()
    for path in paths:
        with open(path) as fh:
            for ev in json.load(fh).get("traceEvents", []):
                if str(ev.get("cat", "")).lower() == "kernel":
                    names.add(ev.get("name", ""))
    found = {k: sum(1 for n in names if k in n)
             for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return {"state": state, "traces": len(paths),
            "trace_bytes": sum(os.path.getsize(p) for p in paths),
            "kernel_names": len(names), "flash_kernels_named": found}


def _oom_check(torch, flight_dir) -> dict:
    """A deliberately impossible allocation (64 TiB) inside ``oom_guard``:
    the OOM is caught as ``torch.cuda.OutOfMemoryError``, ``is_oom`` holds
    and the forensics bundle and the ``oom`` flight record are written."""
    from edl_tpu_torch.obs import events as obs_events
    from edl_tpu_torch.obs import memory as obs_memory

    saved = os.environ.get(obs_events.ENV_DIR)
    os.environ[obs_events.ENV_DIR] = flight_dir
    obs_events.reset()
    out = {"caught": None}
    try:
        plane = obs_memory.MemoryPlane(device="cuda", stage="chip-smoke")
        try:
            with plane.oom_guard(step=-1):
                torch.empty(1 << 46, dtype=torch.uint8, device="cuda")
        except torch.cuda.OutOfMemoryError as exc:
            out["caught"] = type(exc).__name__
            out["is_oom"] = obs_memory.is_oom(exc)
        plane.close()
    finally:
        obs_events.reset()
        if saved is None:
            os.environ.pop(obs_events.ENV_DIR, None)
        else:
            os.environ[obs_events.ENV_DIR] = saved
    bundles = [n for n in os.listdir(flight_dir)
               if n.startswith("oom-") and n.endswith(".json")]
    docs = []
    for name in bundles:
        with open(os.path.join(flight_dir, name)) as fh:
            docs.append(json.load(fh))
    records = [e for e in obs_events.read_segments(flight_dir)
               if e.get("event") == "oom"]
    out.update(bundles=len(bundles), flight_records=len(records),
               error=(docs[0]["error"][:120] if docs else None),
               bundle_keys=sorted(docs[0]) if docs else [])
    return out


def phase_train(torch, smi: str) -> dict:
    import shutil
    import tempfile

    from edl_tpu_torch.obs import memory as obs_memory
    from edl_tpu_torch.obs import profile as obs_profile
    from edl_tpu_torch.obs.numerics import METRICS_KEY
    from edl_tpu_torch.tools import lm_bench

    cfg = FLAGSHIP_TRAIN
    state, bare, batch = lm_bench.build(cfg, "cuda", seed=0)
    model = state.apply_fn
    layers = model.num_layers
    gns_on = _make_step(True, "1")
    # the warm-up step (allocator, kernel libraries) is the trainer's
    # default step (numerics, GNS on) on the fresh state: its FLOPs are
    # counted and its memory plan measured, as the trainer's first step
    plane = obs_memory.MemoryPlane(device="cuda", stage="chip-smoke")
    plane.arm()
    cost, (state, m) = obs_profile.step_cost(gns_on, state, batch)
    torch.cuda.synchronize()
    plan = plane.harvest(state, world=1)
    first_peak = torch.cuda.max_memory_allocated()
    plane.close()
    m.pop(METRICS_KEY)
    losses = [float(m["loss"])]
    modes = {}
    bare_run = _run_steps(torch, state, bare, batch, losses)
    state = bare_run.pop("state")
    modes["bare"] = bare_run
    launches = bare_run["launches"]
    breakdown = bare_run["profile"]
    step_ms = bare_run["step_ms"]

    model.remat_policy = "full"
    _zero_counts()
    state, _ = bare(state, batch)
    torch.cuda.synchronize()
    full_launches = _launch_counts()
    model.remat_policy = cfg["remat"]

    for name, gns in (("numerics_gns_off", "0"), ("numerics_gns_on", "1")):
        step = gns_on if gns == "1" else _make_step(True, gns)
        state, _ = step(state, batch)  # its own first call
        run = _run_steps(torch, state, step, batch)
        state = run.pop("state")
        run["vs_bare"] = run["step_ms"] / step_ms
        run["device_vs_bare"] = (run["device_ms"] / breakdown["device_ms"]
                                 if breakdown["device_ms"] else None)
        modes[name] = run
    gns_peak = modes["numerics_gns_on"]["peak_memory_bytes"]
    bc = _bundle_check(torch, state, gns_on, batch)
    state = bc.pop("state")
    work = tempfile.mkdtemp(prefix="edl-train-")
    try:
        cc = _capture_check(torch, state, gns_on, batch,
                            os.path.join(work, "profile"))
        state = cc.pop("state")
        del state, bare, gns_on, batch, model, m
        torch.cuda.empty_cache()
        oom = _oom_check(torch, os.path.join(work, "flight"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    flops = lm_bench.step_flops(cfg)
    counted = obs_profile.cost_flops(cost)
    tokens = cfg["batch"] * cfg["seq"]
    out = {
        "phase": "train", "config": "flagship", "tokens": [cfg["batch"],
                                                          cfg["seq"]],
        "remat": cfg["remat"], "optimizer": "adamw(1e-3)",
        "steps": TRAIN_STEPS, "losses": losses,
        "launches": launches,
        "launches_per_step": bare_run["launches_per_step"],
        "launches_full_remat_step": full_launches,
        "step_ms": step_ms, "host_enqueue_ms": bare_run["host_enqueue_ms"],
        "tokens_per_s": tokens / step_ms * 1e3,
        "step_tflop": flops / 1e12,
        "mfu": flops / (step_ms * 1e-3) / lm_bench.H100_BF16_PEAK_FLOPS,
        "peak_memory_gb": bare_run["peak_memory_bytes"] / 1e9, "card": smi,
        "profile": breakdown,
        # the profiled step's device time against the unprofiled step
        "device_idle_share_steady": (
            1.0 - breakdown["device_ms"] / step_ms
            if breakdown["device_ms"] else None),
        "modes": {k: {f: v for f, v in r.items() if f != "profile"}
                  for k, r in modes.items()},
        "mode_profiles_top": {k: {"device": r["profile"]["top"][:5],
                                  "host": r["profile"]["host_top"]}
                              for k, r in modes.items()},
        "bundle_check": bc,
        "step_cost": {
            "counted_tflop": counted / 1e12 if counted else None,
            "model_tflop": flops / 1e12,
            "model_tflop_without_recompute": lm_bench.step_flops(
                dict(cfg, remat="none")) / 1e12,
            "counted_over_model": counted / flops if counted else None,
            "counted_by_op_tflop": {k: v / 1e12 for k, v in sorted(
                (cost.get("by_op") or {}).items())},
            "note": "both count the remat recompute of each block's "
                    "projections and MLP (save_flash), as XLA's count of "
                    "the compiled step does",
        },
        "capture": cc,
        "memory_plan": {
            "plan": plan.to_doc() if plan else None,
            "max_memory_allocated": first_peak,
            "rel": (abs(plan.total() - first_peak) / first_peak
                    if plan else None),
            "tol_rel": TOL_PLAN,
            # how well the first step's plan stands for the steady steps
            "steady_peak_gns_on": gns_peak,
            "steady_peak_bare": bare_run["peak_memory_bytes"],
            "plan_over_steady_gns_on": (plan.total() / gns_peak
                                        if plan else None),
        },
        "oom": oom,
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
    check(modes["numerics_gns_off"]["launches_per_step"] == want,
          "GNS off: launches per step %s != %s"
          % (modes["numerics_gns_off"]["launches_per_step"], want))
    want_gns = {k: 2 * v for k, v in want.items()}
    check(modes["numerics_gns_on"]["launches_per_step"] == want_gns,
          "GNS on: launches per step %s != %s"
          % (modes["numerics_gns_on"]["launches_per_step"], want_gns))
    want_full = dict(want, flash_fwd=2 * layers)
    check(full_launches == want_full,
          "remat full launches %s != %s" % (full_launches, want_full))
    for name, run in modes.items():
        vals = run["losses"]
        check(all(math.isfinite(v) for v in vals),
              "%s: loss not finite: %s" % (name, vals))
    check(max(bc["rel"].values()) <= TOL_BUNDLE
          and bc["bundle"]["nonfinite"] == bc["float64"]["nonfinite"] == 0,
          "bundle vs its float64 recompute: %s" % bc["rel"])
    check(bc["nonfinite_on_card"]["counted"] == 5,
          "non-finite count on the card: %s" % bc["nonfinite_on_card"])
    halves = bc["halves"]
    check(halves["grad_norm_rel"] <= TOL_HALVES
          and halves["loss_rel"] <= TOL_HALVES,
          "mean of the half-batch gradients vs the full batch's: %s" % halves)
    check(counted is not None and counted > 0,
          "step_cost counted no FLOPs: %s" % cost)
    check(all(cc["flash_kernels_named"].values()) and cc["traces"] == 1,
          "profiler trace: %s" % {k: v for k, v in cc.items()})
    check(plan is not None and out["memory_plan"]["rel"] <= TOL_PLAN,
          "memory plan vs max_memory_allocated: %s" % out["memory_plan"])
    check(oom["caught"] == "OutOfMemoryError" and oom.get("is_oom")
          and oom["bundles"] == 1 and oom["flight_records"] == 1
          and "out of memory" in (oom["error"] or "").lower(),
          "OOM forensics: %s" % oom)
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
    the parameters and buffers (batch-norm running averages), the
    optimizer's state (AdamW's moments and step counts, SGD's momentum),
    the train step and the optimizer's update count."""
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
    """Wrap ``module.name``: the time (synchronised) of its first call in
    the process lands in ``rec[key]``."""
    fn = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.monotonic()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        rec.setdefault(key, time.monotonic() - t0)
        return out

    setattr(module, name, timed)


def _digesting_restore(torch, rec, digest: bool = True):
    """Wrap ``CheckpointManager.restore``: the time of the restore the
    trainer makes and the version it restored, then (``digest``) the
    digest of what it restored and the restored parameter norm against
    the fingerprint stamped at save."""
    from edl_tpu_torch.checkpoint import manager
    from edl_tpu_torch.obs.numerics import host_param_norm

    restore = manager.CheckpointManager.restore

    def digesting(self, template, step=None):
        t0 = time.monotonic()
        state, status = restore(self, template, step)
        torch.cuda.synchronize()
        rec["restore_s"] = time.monotonic() - t0
        rec["restored_epoch"] = status.epoch if status else None
        rec["restored_step"] = status.step if status else None
        rec["restored_meta"] = (status.meta or {}) if status else None
        if not digest or status is None:
            # nothing restored; and a digest would build a fresh
            # optimizer's state (get_state_dict's zero-lr step), which
            # moves its bias correction
            return state, status
        t0 = time.monotonic()
        rec["restored_digest"] = state_digest(torch, state)
        fp = ((status.meta or {}).get("numerics") or {}) if status else {}
        rec["stamped_param_norm"] = fp.get("param_norm")
        rec["restored_param_norm"] = host_param_norm(state)
        rec["digest_s"] = time.monotonic() - t0
        return state, status

    manager.CheckpointManager.restore = digesting


def _digesting_save(torch, out_dir):
    """Wrap ``CheckpointManager.save``: every rank digests the state it
    saved (the digest reads each tensor, DDP or not), rank 0 writes it to
    ``digest.<step>.json`` for the restoring workers' check."""
    from edl_tpu_torch.checkpoint import manager
    from edl_tpu_torch.train import context

    save = manager.CheckpointManager.save

    def digesting(self, state, status, step=None):
        saved = save(self, state, status, step)
        digest = state_digest(torch, state)
        if context.current_env().is_rank0:
            _write_json(os.path.join(out_dir, "digest.%d.json" % saved), digest)
        return saved

    manager.CheckpointManager.save = digesting


def _write_json(path, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


def elastic_lr(count: int) -> float:
    """The learning rate of the jobs' ``count``-th update (0-based):
    ``linear_scaled_lr(1e-3, 1)`` at the world of the stage that takes
    it — world 2 from epoch ``ELASTIC_JOIN_EPOCH`` to the kill."""
    grown = (ELASTIC_JOIN_EPOCH * ELASTIC_BATCHES <= count
             < ELASTIC_KILL_EPOCH * ELASTIC_BATCHES)
    return 1e-3 * (2 if grown else 1)


def elastic_child(torch, out_path: str) -> None:
    """The reference run of phase elastic, one fresh process with the
    launcher's environment (:func:`elastic_env`): ``ElasticTrainer.fit``
    of the flagship at world 1 for every epoch, without checkpoints, at
    the learning rate of :func:`elastic_lr`, one step profiled. Writes
    what it measured to ``out_path`` as JSON."""
    from edl_tpu_torch.obs import trace as obs_trace
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import ElasticTrainer, adamw

    spawn_ts = float(os.environ["EDL_SPAWN_TS"])
    # the interpreter, torch and CUDA's first touch
    rec = {"role": "reference", "import_s": time.time() - spawn_ts}
    cfg = ELASTIC_TRAIN
    from edl_tpu_torch.train import loop as train_loop

    # the weights' init on the card and the optimizer's construction (the
    # first in a process imports torch._dynamo)
    _timed(torch, rec, "create_state_s", train_loop, "create_state")
    _profiling_step(torch, rec, ELASTIC_PROFILE_STEP)
    t0 = time.monotonic()
    model = lm_bench.build_model(cfg, "cuda")
    torch.cuda.synchronize()
    rec["model_build_s"] = time.monotonic() - t0
    trainer = ElasticTrainer(
        model,
        adamw(elastic_lr),
        lm_bench.lm_loss,
        ckpt_dir=None,
        seed=0,
        device="cuda",
    )
    losses = {}
    _zero_counts()  # the reference run starts here
    state = trainer.fit(
        elastic_data(cfg), ELASTIC_EPOCHS,
        on_epoch_end=lambda e, m: losses.__setitem__(e, float(m["loss"])),
    )
    torch.cuda.synchronize()
    rec["launches"] = _launch_counts()
    rec["losses"] = {str(e): v for e, v in sorted(losses.items())}
    rec["step"] = int(state.step)
    events = obs_trace.get_tracer().to_events()
    first = _spans(events, "first_step")[0]
    rec["time_to_first_step_s"] = (first["ts"] + first["dur"]) / 1e6 - spawn_ts
    rec["epoch_ms_per_step"] = {
        str(ev["args"]["epoch"]): ev["dur"] / 1e3 / ev["args"]["steps"]
        for ev in _spans(events, "train_epoch")}
    with open(out_path, "w") as fh:
        json.dump(rec, fh)


def launched_child(torch, out_dir: str) -> None:
    """The flagship worker the port's launcher spawns in phase elastic
    (``python3 chip_smoke.py --elastic-launched OUT_DIR`` as its training
    script): ``ElasticTrainer.fit`` with per-epoch checkpoints, this
    rank's rows of each seeded global batch, and the holds that pin the
    membership changes to epoch boundaries (the first stage to reach
    epoch ``ELASTIC_JOIN_EPOCH`` or ``ELASTIC_KILL_EPOCH`` holds there
    until the drain token moves; with ``SMOKE_DRAIN=1`` the first stage
    to take epoch ``ELASTIC_DRAIN_EPOCH``'s first step holds until its
    pod's preemption notice). ``SMOKE_DIGEST=1`` digests every save and
    restore; ``SMOKE_ASYNC=1`` saves asynchronously (phase tiers).
    Writes ``rec.<pid>.json`` (rewritten at every epoch's end, so a
    worker its launcher kills leaves what it did) and
    ``loss.<epoch>.<stage>.<rank>``."""
    import numpy as np

    from edl_tpu_torch.chaos import drill
    from edl_tpu_torch.obs import trace as obs_trace
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import (
        AdjustRegistry,
        ElasticTrainer,
        adamw,
        context,
        linear_scaled_lr,
    )
    from edl_tpu_torch.train import loop as train_loop

    spawn_ts = float(os.environ["EDL_SPAWN_TS"])
    env0 = context.current_env()
    rec = {"pid": os.getpid(), "spawn_ts": spawn_ts,
           "import_s": time.time() - spawn_ts, "rank": env0.global_rank,
           "stage": env0.stage, "world": env0.world_size,
           "hot": context.hot_restage_enabled(), "pod": env0.pod_id,
           "launcher_pid": os.getppid(), "replica_lag_steps": []}
    steps = drill.count_steps(train_loop)
    _timed(torch, rec, "create_state_s", train_loop, "create_state")
    digest = os.environ.get("SMOKE_DIGEST") == "1"
    _digesting_restore(torch, rec, digest=digest)
    if digest:
        _digesting_save(torch, out_dir)
    drain = os.environ.get("SMOKE_DRAIN") == "1"
    cfg = ELASTIC_TRAIN

    def data_fn(epoch):
        env = context.current_env()
        if epoch in (ELASTIC_JOIN_EPOCH, ELASTIC_KILL_EPOCH):
            drill.hold_at_epoch(out_dir, epoch, ELASTIC_SETTLE_S)
        base = steps[0]
        rng = np.random.RandomState(1000 + epoch)
        rows = cfg["batch"] // env.world_size
        lo = env.global_rank * rows
        for i in range(ELASTIC_BATCHES):
            tok = rng.randint(0, cfg["vocab_size"],
                              (cfg["batch"], cfg["seq"] + 1)).astype(np.int64)
            yield tok[lo:lo + rows, :-1], tok[lo:lo + rows, 1:]
            if drain and epoch == ELASTIC_DRAIN_EPOCH and i == 0:
                drill.hold_for_notice(out_dir, steps, base, ELASTIC_SETTLE_S,
                                      ELASTIC_WAIT_S)

    adjusts = AdjustRegistry()
    adjusts.register(linear_scaled_lr(1e-3, 1))
    model = lm_bench.build_model(cfg, "cuda")
    trainer = ElasticTrainer(
        model,
        lambda overrides: adamw(overrides["lr"]),
        lm_bench.lm_loss,
        ckpt_dir=os.environ["EDL_CKPT_PATH"],
        adjusts=adjusts,
        async_save=os.environ.get("SMOKE_ASYNC") == "1",
        seed=0,
        device="cuda",
    )

    def snapshot():
        events = obs_trace.get_tracer().to_events()
        rec["steps"] = steps[0]
        rec["launches"] = _launch_counts()
        rec["first_step_end_ts"] = [
            (ev["ts"] + ev["dur"]) / 1e6 for ev in _spans(events, "first_step")]
        rec["save_s"] = {ev["args"].get("step"): ev["dur"] / 1e6
                         for ev in _spans(events, "ckpt_save")}
        rec["restages"] = trainer.restages
        _write_json(os.path.join(out_dir, "rec.%d.json" % os.getpid()), rec)

    def on_epoch_end(epoch, metrics):
        from edl_tpu_torch.checkpoint import replicate

        drill.write_loss(out_dir, epoch, metrics["loss"])
        # the pod's replica lag as its replicator exports it (before this
        # epoch's save)
        rec["replica_lag_steps"].append(
            [epoch, replicate._M_LAG.value()])
        snapshot()

    _zero_counts()  # this worker's part of the elastic path starts here
    try:
        state = trainer.fit(data_fn, ELASTIC_EPOCHS, on_epoch_end=on_epoch_end)
        torch.cuda.synchronize()
        rec["final_step"] = int(state.step)
    finally:
        if trainer.restages:
            # what a hot restage would pay to rebuild the state instead of
            # keeping it: create_state in this warm process (training is
            # over; the weights it re-initialises are no longer needed)
            t0 = time.monotonic()
            train_loop.create_state(model, 0, adamw(1e-3), device="cuda")
            torch.cuda.synchronize()
            rec["warm_rebuild_s"] = time.monotonic() - t0
        snapshot()


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


class _ControlPlane:
    """One job of phase elastic on the port's own control plane: a
    ``python -m edl_tpu_torch.store.server`` child and
    ``python -m edl_tpu_torch.launch`` pods around
    ``chip_smoke.py --elastic-launched``, each in a session of its own,
    their output in files under ``work``. ``close`` SIGKILLs every
    session it started; the workers die with their launchers
    (``PR_SET_PDEATHSIG``)."""

    def __init__(self, work: str, job: str, hot: bool, **extra) -> None:
        self.work, self.job, self.hot = work, job, hot
        self.out = os.path.join(work, "out")
        self.ckpt = os.path.join(work, "ckpt")
        self.logs = os.path.join(work, "logs")
        for d in (self.out, self.logs):
            os.makedirs(d, exist_ok=True)
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith("EDL_")}
        self.env["PYTHONPATH"] = HERE + os.pathsep + self.env.get(
            "PYTHONPATH", "")
        # the flight recorder of every process: goodput, numerics,
        # restores (the invariants read them)
        self.env["EDL_FLIGHT_DIR"] = os.path.join(work, "flight")
        self.env.update(extra)
        self.procs = []
        self.store_log = os.path.join(self.logs, "store.log")
        self._spawn([sys.executable, "-m", "edl_tpu_torch.store.server",
                     "--host", "127.0.0.1", "--port", "0"], self.store_log)
        self.endpoint = None
        self.store_line = None
        deadline = time.monotonic() + 60
        while self.endpoint is None and time.monotonic() < deadline:
            with open(self.store_log) as fh:
                for line in fh:
                    found = re.search(r"store serving on port (\d+)", line)
                    if found:
                        self.endpoint = "127.0.0.1:" + found.group(1)
                        self.store_line = line.strip()
            time.sleep(0.05)
        check(self.endpoint is not None, "the port's store did not start")

    def _spawn(self, cmd, log, env=None):
        with open(log, "ab") as fh:
            proc = subprocess.Popen(cmd, env=env or self.env, cwd=self.work,
                                    stdout=fh, stderr=subprocess.STDOUT,
                                    start_new_session=True)
        self.procs.append(proc)
        return proc

    def pod(self, script=None, env=None, nodes="1:2", args=()):
        """A launcher pod around ``script`` (argv; default the flagship
        worker), with ``env`` added to the plane's."""
        n = len(self.procs)
        cmd = [sys.executable, "-m", "edl_tpu_torch.launch",
               "--job_id", self.job, "--store", self.endpoint,
               "--nodes_range", nodes, "--ttl", str(ELASTIC_TTL),
               "--drain_budget", str(ELASTIC_DRAIN_BUDGET),
               "--ckpt_path", self.ckpt, "--log_dir", self.logs, *args]
        if self.hot:
            cmd.append("--hot_restage")
        cmd += script or [os.path.abspath(__file__), "--elastic-launched",
                          self.out]
        proc = self._spawn(cmd, os.path.join(self.logs, "pod%d.log" % n),
                           env=dict(self.env, **(env or {})))
        proc.log = os.path.join(self.logs, "pod%d.log" % n)
        return proc

    def versions(self):
        try:
            return sorted(int(n) for n in os.listdir(self.ckpt) if n.isdigit())
        except FileNotFoundError:
            return []

    def reached(self, epoch) -> bool:
        """Epoch ``epoch - 1``'s checkpoint is in place and a stage holds
        at epoch ``epoch``'s start."""
        return ((epoch * ELASTIC_BATCHES) in self.versions()
                and os.path.exists(os.path.join(self.out, "hold.%d" % epoch)))

    def items(self):
        from edl_tpu_torch.store.client import StoreClient

        client = StoreClient(self.endpoint, timeout=10.0)
        try:
            items, _ = client.range("/%s/" % self.job)
        finally:
            client.close()
        return {k: (v, lease) for k, v, _r, lease in items}

    def flight(self):
        """Every flight record of the job's processes (launchers and
        workers, killed ones included)."""
        from edl_tpu_torch.obs import events as obs_events

        return obs_events.read_segments(os.path.join(self.work, "flight"))

    def records(self):
        recs = []
        for name in sorted(os.listdir(self.out)):
            if name.startswith("rec.") and name.endswith(".json"):
                with open(os.path.join(self.out, name)) as fh:
                    recs.append(json.load(fh))
        return sorted(recs, key=lambda r: r["spawn_ts"])

    def close(self) -> None:
        pids = [r["pid"] for r in self.records()]
        for proc in self.procs:
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, 9)
                except ProcessLookupError:
                    pass
            proc.wait(timeout=30)
        deadline = time.monotonic() + 60  # the workers leave the card
        while time.monotonic() < deadline and any(
                os.path.exists("/proc/%d" % pid) for pid in pids):
            time.sleep(0.1)


def _wait(cond, what: str, procs=()) -> None:
    deadline = time.monotonic() + ELASTIC_WAIT_S
    while time.monotonic() < deadline:
        if cond():
            return
        for proc in procs:
            check(proc.poll() is None, "%s: a launcher exited %s before it"
                  % (what, proc.returncode))
        time.sleep(0.1)
    raise AssertionError("phase elastic timed out waiting for " + what)


def _tail(path, n=30) -> str:
    with open(path, errors="replace") as fh:
        return "".join(fh.readlines()[-n:])


def _elastic_job(work: str, hot: bool) -> dict:
    """One job of the schedule: one pod; at epoch ELASTIC_JOIN_EPOCH a
    second joins; at ELASTIC_KILL_EPOCH the joiner is SIGKILLed. Cold:
    the job then runs to its end. Hot: the survivor drains on SIGTERM
    after epoch ELASTIC_DRAIN_EPOCH's first step, and a new pod resumes
    the job from the emergency version."""
    from edl_tpu_torch.chaos import drill

    job = "chip-smoke-" + ("hot" if hot else "cold")
    extra = {"SMOKE_DRAIN": "1"} if hot else {"SMOKE_DIGEST": "1"}
    cp = _ControlPlane(work, job, hot, **extra)
    res = {"job": job, "store": cp.store_line}
    try:
        first = cp.pod()
        _wait(lambda: cp.reached(ELASTIC_JOIN_EPOCH),
              "%s: epoch %d" % (job, ELASTIC_JOIN_EPOCH), [first])
        joiner = cp.pod()
        _wait(lambda: cp.reached(ELASTIC_KILL_EPOCH),
              "%s: epoch %d at world 2" % (job, ELASTIC_KILL_EPOCH),
              [first, joiner])
        os.kill(joiner.pid, 9)  # a dead machine: its lease must expire
        joiner.wait(timeout=60)
        if not hot:
            res["launcher_rc"] = first.wait(timeout=ELASTIC_WAIT_S)
        else:
            _wait(lambda: os.path.exists(os.path.join(cp.out, "hold.drain")),
                  "%s: epoch %d's first step" % (job, ELASTIC_DRAIN_EPOCH),
                  [first])
            res["cursor"] = cp.versions()[-1]
            os.kill(first.pid, 15)  # the preemption notice
            res["drain_rc"] = first.wait(timeout=ELASTIC_WAIT_S)
            res["drained_versions"] = cp.versions()
            emergency = res["drained_versions"][-1]
            with open(os.path.join(cp.ckpt, str(emergency),
                                   "status.json")) as fh:
                res["emergency_status"] = {
                    k: v for k, v in json.load(fh).items() if k != "meta"}
                fh.seek(0)
                meta = json.load(fh).get("meta") or {}
            res["emergency_status"]["emergency"] = meta.get("emergency")
            res["emergency_step"] = emergency
            res["preempt_keys"] = sorted(
                k for k in cp.items() if "/preempt/" in k)
            resumed = cp.pod()
            res["launcher_rc"] = resumed.wait(timeout=ELASTIC_WAIT_S)
        items = cp.items()
        res["job_status"] = (items.get("/%s/job/status" % job) or (b"",))[0]
        res["job_status"] = res["job_status"].decode()
        # the drain token's bump, per new stage (the leader's drain event)
        res["bump_ts"] = {}
        for key, (value, _lease) in items.items():
            found = re.match(r"/%s/events/([0-9a-f]+)/drain\." % job, key)
            if found:
                res["bump_ts"][found.group(1)] = float(value)
        res["keys"] = sorted(re.sub(r"[0-9a-f]{8,32}", "<id>", k)
                             for k, (_v, lease) in items.items() if lease == 0)
        res["records"] = cp.records()
        res["flight"] = cp.flight()
        res["losses"] = drill.read_losses(cp.out)
        res["versions"] = cp.versions()
        if not hot:
            res["saved_digests"] = {}
            for name in os.listdir(cp.out):
                if name.startswith("digest."):
                    with open(os.path.join(cp.out, name)) as fh:
                        res["saved_digests"][int(name.split(".")[1])] = \
                            json.load(fh)
            last = os.path.join(cp.ckpt, str(res["versions"][-1]))
            res["checkpoint_bytes"] = sum(
                os.path.getsize(os.path.join(d, f))
                for d, _, files in os.walk(last) for f in files)
        res["launcher_logs"] = [open(p.log).read() for p in cp.procs[1:]]
        res["worker_logs"] = {
            n: open(os.path.join(cp.logs, n), errors="replace").read()
            for n in os.listdir(cp.logs) if n.startswith("workerlog.")}
    except BaseException:
        for name in sorted(os.listdir(cp.logs)):
            sys.stderr.write("--- %s\n%s" % (
                name, _tail(os.path.join(cp.logs, name))))
        raise
    finally:
        cp.close()
    return res


def _stage_order(res):
    """The job's stages in the order their first worker started."""
    order = []
    for rec in res["records"]:
        for stage in [rec["stage"]] + [r["stage"] for r in rec["restages"]]:
            if stage not in order:
                order.append(stage)
    return sorted(order, key=lambda st: min(
        [r["spawn_ts"] for r in res["records"] if r["stage"] == st]
        + [x["token_seen_ts"] for r in res["records"] for x in r["restages"]
           if x["stage"] == st]))


def _planes_report(events) -> dict:
    """What one job's flight records say of the planes: every restore's
    ``numerics_resume`` check (through the port's
    ``invariants.numerics_continuous``), the goodput ledger
    (``goodput_accounted``, the job's fraction and each process lane's:
    train seconds over the seconds the lane accounted) and the replicas'
    divergence where two ranks published at one step."""
    from edl_tpu_torch.chaos import invariants as inv
    from edl_tpu_torch.obs import goodput as obs_goodput

    resumes = [e for e in events if e.get("event") == "numerics_resume"]
    restores = [e for e in events if e.get("event") == "ckpt_restore"]
    nc = inv.numerics_continuous(events)
    ga = inv.goodput_accounted(events)
    job = obs_goodput.job_goodput(events)
    lanes = {}
    for lane, states in job["attribution"]["lanes"].items():
        total = sum(states.values())
        lanes[lane] = states.get("train", 0.0) / total if total else None
    return {
        "restores": len(restores),
        "numerics_resume": [
            {k: e.get(k) for k in ("step", "ok", "expected_loss",
                                   "actual_loss", "rel", "ref_step")}
            for e in resumes],
        "numerics_continuous": {"ok": nc.ok, "detail": nc.detail},
        "goodput_accounted": {"ok": ga.ok, "detail": ga.detail},
        "goodput_fraction": job["ratio"],
        "goodput_fraction_by_lane": lanes,
        "goodput_states_s": job["attribution"]["states"],
        "replica_divergence": [
            e["divergence"] for e in events
            if e.get("event") == "numerics"
            and e.get("divergence") is not None],
    }


def _check_planes(name: str, rep: dict, world2: bool) -> None:
    resumes = rep["numerics_resume"]
    check(rep["numerics_continuous"]["ok"] and rep["restores"] > 0
          and len(resumes) == rep["restores"],
          "%s: numerics_resume %s for %d restores"
          % (name, rep["numerics_continuous"], rep["restores"]))
    check(all(isinstance(r["expected_loss"], float)
              and math.isfinite(r["expected_loss"]) for r in resumes),
          "%s: a stamped fingerprint without a finite loss: %s"
          % (name, resumes))
    check(rep["goodput_accounted"]["ok"],
          "%s: goodput_accounted: %s" % (name, rep["goodput_accounted"]))
    if world2:
        div = rep["replica_divergence"]
        check(div and all(d == 0.0 for d in div),
              "%s: replica divergence at world 2: %s" % (name, div))


def phase_elastic(torch, smi: str, train: dict) -> dict:
    """The elastic training path on the port's own control plane: the
    reference run, the cold job, the hot job with its drain, and the
    DDP check (see the module docstring). The work directory is removed
    afterwards."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="edl-elastic-")
    try:
        out = os.path.join(work, "reference.json")
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--elastic-child",
             out],
            capture_output=True, text=True, env=elastic_env("reference"),
            cwd=HERE, timeout=600,
        )
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise AssertionError("elastic reference exited %d"
                                 % proc.returncode)
        with open(out) as fh:
            ref = json.load(fh)
        cold = _elastic_job(os.path.join(work, "cold"), hot=False)
        hot = _elastic_job(os.path.join(work, "hot"), hot=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    ddp = _ddp_check(torch)
    layers = ELASTIC_TRAIN["num_layers"]
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    # (a) cold: three stages, a new process for every stage's rank
    c_stages = _stage_order(cold)
    c_recs = cold["records"]
    restorers = [r for r in c_recs if r.get("restored_step") is not None]
    cold_bit_for_bit = [
        r["restored_digest"] == cold["saved_digests"].get(r["restored_step"])
        for r in restorers]
    cold_recover = []
    for r in restorers:
        end = r["first_step_end_ts"][0]
        cold_recover.append({
            "stage": c_stages.index(r["stage"]) + 1, "world": r["world"],
            "rank": r["rank"], "pid": r["pid"],
            "restored_step": r["restored_step"],
            "spawn_to_first_step_s": end - r["spawn_ts"] - r["digest_s"],
            "bump_to_first_step_s": (end - cold["bump_ts"][r["stage"]]
                                     - r["digest_s"]),
            "import_s": r["import_s"], "create_state_s": r["create_state_s"],
            "restore_s": r["restore_s"], "digest_s": r["digest_s"],
            "stamped_param_norm": r["stamped_param_norm"],
            "restored_param_norm": r["restored_param_norm"]})
    norm_ok = [r["stamped_param_norm"] is not None and abs(
        r["restored_param_norm"] - r["stamped_param_norm"])
        <= TOL_PARAM_NORM * r["stamped_param_norm"] for r in restorers]

    # (b) hot: the survivor's restages, the joiner, the resumed pod
    h_recs = hot["records"]
    h_stages = _stage_order(hot)
    survivor = h_recs[0]
    hot_recover = []
    for x in survivor["restages"]:
        hot_recover.append({
            "stage": h_stages.index(x["stage"]) + 1,
            "from_world": x["from_world"], "world": x["world"],
            "state": x["state"], "state_s": x.get("state_s"),
            "bump_to_first_step_s": (x["first_step_end_ts"]
                                     - hot["bump_ts"][x["stage"]]),
            "seen_to_first_step_s": (x["first_step_end_ts"]
                                     - x["token_seen_ts"]),
            "wait_publish_s": x["wait_publish_s"], "reinit_s": x["reinit_s"],
            "restore_s": x.get("restore_s")})
    resumed = h_recs[-1]
    emergency_s = survivor["save_s"].get(str(hot["emergency_step"]))

    c_loss = {e: v for e, (v, _st) in cold["losses"].items()}
    h_loss = {e: v for e, (v, _st) in hot["losses"].items()}
    compared = [e for e in range(ELASTIC_DRAIN_EPOCH)]
    hot_vs_cold = {str(e): abs(h_loss[e] - c_loss[e]) / abs(c_loss[e])
                   for e in compared}
    ref_loss = {int(e): v for e, v in ref["losses"].items()}
    cold_vs_ref = {str(e): abs(c_loss[e] - ref_loss[e]) / abs(ref_loss[e])
                   for e in sorted(c_loss) if e in ref_loss}
    per_proc = {}
    for name, res, stages in (("cold", cold, c_stages), ("hot", hot, h_stages)):
        per_proc[name] = [{
            "pid": r["pid"], "stage": stages.index(r["stage"]) + 1,
            "rank": r["rank"], "world": r["world"],
            "import_s": r["import_s"], "create_state_s": r["create_state_s"],
            "restore_s": r.get("restore_s"), "digest_s": r.get("digest_s"),
            "spawn_to_first_step_s": (r["first_step_end_ts"][0] - r["spawn_ts"]
                                      if r["first_step_end_ts"] else None),
            "steps": r["steps"], "launches": r["launches"]}
            for r in res["records"]]
    launches = {k: sum(p["launches"][k] for name in per_proc
                       for p in per_proc[name]) for k in kernels}
    steps = sum(p["steps"] for name in per_proc for p in per_proc[name])
    steady = [ref["epoch_ms_per_step"][str(e)] for e in (1, 2)]
    steady_ms = sum(steady) / len(steady)
    prof = ref.get("profile") or {}
    planes = {"cold": _planes_report(cold.pop("flight")),
              "hot": _planes_report(hot.pop("flight"))}
    # the trainer's step runs the planes at their defaults (numerics, GNS
    # on): its overhead is against phase train's step of those settings
    train_gns = train["modes"]["numerics_gns_on"]["step_ms"]
    out = {
        "phase": "elastic", "config": "flagship",
        "tokens": [FLAGSHIP_TRAIN["batch"], FLAGSHIP_TRAIN["seq"]],
        "optimizer": "adamw, linear_scaled_lr(1e-3, 1)",
        "epochs": ELASTIC_EPOCHS, "batches_per_epoch": ELASTIC_BATCHES,
        "control_plane": {"store": cold["store"],
                          "launcher": "python -m edl_tpu_torch.launch",
                          "cold_keys": cold["keys"], "hot_keys": hot["keys"]},
        "schedule": {"join_epoch": ELASTIC_JOIN_EPOCH,
                     "kill_epoch": ELASTIC_KILL_EPOCH,
                     "drain_epoch": ELASTIC_DRAIN_EPOCH, "ttl": ELASTIC_TTL},
        "cold": {
            "stages": len(c_stages),
            "worlds": [next(r["world"] for r in c_recs if r["stage"] == st)
                       for st in c_stages],
            "pids": [[r["pid"] for r in c_recs if r["stage"] == st]
                     for st in c_stages],
            "launcher_rc": cold["launcher_rc"],
            "job_status": cold["job_status"],
            "restores_bit_for_bit": cold_bit_for_bit,
            "restored_norm_matches_fingerprint": norm_ok,
            "tol_param_norm": TOL_PARAM_NORM,
            "vs_reference_rel_diff": cold_vs_ref, "tol_resume": TOL_RESUME,
            "restored_tensors": [len(r["restored_digest"]) for r in restorers],
            "time_to_recover": cold_recover,
            "save_s": sorted(v for r in c_recs for v in r["save_s"].values()),
            "losses": {str(e): v for e, v in sorted(c_loss.items())},
        },
        "hot": {
            "stages": len(h_stages),
            "survivor_pid": survivor["pid"],
            "survivor_worlds": [survivor["world"]] + [
                x["world"] for x in survivor["restages"]],
            "pids": [r["pid"] for r in h_recs],
            "time_to_recover": hot_recover,
            "warm_rebuild_s": survivor.get("warm_rebuild_s"),
            "losses": {str(e): v for e, v in sorted(h_loss.items())},
            "hot_vs_cold_rel_diff": hot_vs_cold,
            "bit_identical": all(h_loss[e] == c_loss[e] for e in compared),
            "tol_hot_vs_cold": TOL_HOT_VS_COLD,
        },
        "drain": {
            "launcher_rc": hot["drain_rc"], "cursor": hot["cursor"],
            "emergency_step": hot["emergency_step"],
            "emergency_status": hot["emergency_status"],
            "emergency_save_s": emergency_s,
            "preempt_keys": hot["preempt_keys"],
            "resumed_pid": resumed["pid"],
            "resumed_from_step": resumed.get("restored_step"),
            "resumed_epoch": (resumed.get("restored_epoch") + 1
                              if resumed.get("restored_epoch") is not None
                              else None),
            "resumed_launcher_rc": hot["launcher_rc"],
            "job_status": hot["job_status"],
        },
        "time_to_recover_pr5_s": 23.53,
        "launches": launches, "steps": steps,
        "launches_per_process": per_proc,
        "checkpoint_bytes": cold["checkpoint_bytes"],
        "reference": {
            "losses": ref["losses"],
            "time_to_first_step_s": ref["time_to_first_step_s"],
            "create_state_s": ref["create_state_s"],
            "import_s": ref["import_s"],
            "epoch_ms_per_step": ref["epoch_ms_per_step"],
        },
        "trainer_step_ms": steady_ms, "train_step_ms": train_gns,
        "trainer_overhead": steady_ms / train_gns,
        "train_bare_step_ms": train["step_ms"],
        "planes": planes,
        "profiled_step": prof,
        "device_idle_share_steady": (
            1.0 - prof["device_ms"] / steady_ms
            if prof.get("device_ms") else None),
        "ddp": ddp, "card": smi,
    }
    emit(out)
    # the port's control plane ran the jobs
    check("edl_tpu_torch.store.server" in (cold["store"] or ""),
          "the store is not the port's: %s" % cold["store"])
    for res in (cold, hot):
        for log in res["launcher_logs"]:
            check("edl_tpu_torch.launch" in log and "edl_tpu.launch" not in log,
                  "a launcher log is not the port launcher's")
    # (a)
    check(cold["launcher_rc"] == 0 and cold["job_status"] == "COMPLETE",
          "cold job: launcher %s, job %r" % (cold["launcher_rc"],
                                              cold["job_status"]))
    check(out["cold"]["worlds"] == [1, 2, 1],
          "cold worlds %s" % out["cold"]["worlds"])
    c_pids = [p for ps in out["cold"]["pids"] for p in ps]
    check(len(set(c_pids)) == len(c_pids) == 4,
          "cold: not a new process for every stage's rank: %s"
          % out["cold"]["pids"])
    check(len(restorers) == 3 and all(cold_bit_for_bit),
          "cold restores not bit for bit: %s" % cold_bit_for_bit)
    check(all(norm_ok), "cold restored parameter norms vs stamped: %s"
          % [(r["restored_param_norm"], r["stamped_param_norm"])
             for r in restorers])
    check(sorted(c_loss) == list(range(ELASTIC_EPOCHS)),
          "cold epochs %s" % sorted(c_loss))
    check(len(cold_vs_ref) == ELASTIC_EPOCHS
          and max(cold_vs_ref.values()) <= TOL_RESUME,
          "cold losses differ from the reference: %s" % cold_vs_ref)
    # (b)
    check(out["hot"]["survivor_worlds"] == [1, 2, 1],
          "hot survivor worlds %s" % out["hot"]["survivor_worlds"])
    check([x["state"] for x in hot_recover] == ["keep", "keep"],
          "hot restage states %s" % [x["state"] for x in hot_recover])
    check(len({r["pid"] for r in h_recs}) == 3 and all(
        r["pid"] != survivor["pid"] for r in h_recs[1:]),
          "hot pids %s" % out["hot"]["pids"])
    check(all(v <= TOL_HOT_VS_COLD for v in hot_vs_cold.values()),
          "hot vs cold losses: %s" % hot_vs_cold)
    # (c)
    check(hot["drain_rc"] == 76, "drained launcher exited %s" % hot["drain_rc"])
    check(len(hot["preempt_keys"]) == 1, "preempt keys %s" % hot["preempt_keys"])
    check(hot["emergency_step"] > hot["cursor"]
          and hot["emergency_status"]["emergency"],
          "no emergency version past the cursor %d: %s"
          % (hot["cursor"], hot["drained_versions"]))
    check(resumed.get("restored_step") == hot["emergency_step"]
          and out["drain"]["resumed_epoch"] == ELASTIC_DRAIN_EPOCH,
          "the new pod resumed from %s (epoch %s), not the emergency "
          "version %d" % (resumed.get("restored_step"),
                          out["drain"]["resumed_epoch"],
                          hot["emergency_step"]))
    check(hot["launcher_rc"] == 0 and hot["job_status"] == "COMPLETE",
          "resumed hot job: launcher %s, job %r" % (hot["launcher_rc"],
                                                     hot["job_status"]))
    # the planes: every restore checked, every second accounted for
    for name in ("cold", "hot"):
        _check_planes(name, planes[name], world2=True)
    # the kernels ran on this path: every step of every worker, twice a
    # step (the numerics plane's two half-batch passes, GNS on)
    for name in per_proc:
        for p in per_proc[name]:
            want = {k: 2 * layers * p["steps"] for k in kernels}
            check(p["steps"] > 0 and p["launches"] == want,
                  "%s worker %d: launches %s for %d steps"
                  % (name, p["pid"], p["launches"], p["steps"]))
    for res in (cold, hot):
        vals = [v for v, _ in res["losses"].values()]
        check(all(math.isfinite(v) for v in vals),
              "elastic loss not finite: %s" % vals)
    # stage 1 of both jobs is the reference's first epoch, bit for bit
    check(c_loss[0] == h_loss[0] == ref["losses"]["0"],
          "epoch 0: cold %r, hot %r, reference %r"
          % (c_loss[0], h_loss[0], ref["losses"]["0"]))
    ref_losses = [ref["losses"][str(e)] for e in range(ELASTIC_EPOCHS)]
    check(ref_losses[-1] < ref_losses[0],
          "elastic loss did not fall: %s" % ref_losses)
    check(ddp["max_rel_diff"] <= TOL_DDP,
          "DDP over one NCCL rank changed the losses: %s" % ddp)
    return out


def _events(events, name):
    return [e for e in events if e.get("event") == name]


def _durable_restore(torch, root: str) -> dict:
    """A restore of the one version under ``root`` through a single-tier
    ``CheckpointManager`` (a durable directory on this host),
    in this process, into a fresh flagship state: its seconds and the
    digest of what it restored."""
    from edl_tpu_torch.checkpoint import CheckpointManager
    from edl_tpu_torch.tools import lm_bench

    state, _step, _batch = lm_bench.build(ELASTIC_TRAIN, "cuda", seed=1)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with CheckpointManager(root) as mngr:
        state, status = mngr.restore(state)
    torch.cuda.synchronize()
    out = {"seconds": time.monotonic() - t0, "step": status.step,
           "digest": state_digest(torch, state)}
    del state, _step, _batch
    torch.cuda.empty_cache()
    return out


def _codec_ms(path: str) -> dict:
    """The port's wire codec (``rpc/_msgpack.py``, pure Python) on one
    ``ckpt_push`` body carrying the file ``path`` whole, as the pusher
    sends it and the holder reads it: pack and unpack milliseconds."""
    from edl_tpu_torch.rpc import _msgpack

    with open(path, "rb") as fh:
        data = fh.read()
    body = {"i": 1, "m": "ckpt_push", "src": "pod", "step": 0,
            "manifest": {}, "entries": {"f": data}}
    t0 = time.monotonic()
    packed = _msgpack.packb(body)
    t1 = time.monotonic()
    back = _msgpack.unpackb(packed)
    t2 = time.monotonic()
    check(back["entries"]["f"] == data, "the codec changed a file's bytes")
    return {"bytes": len(data), "pack_ms": (t1 - t0) * 1e3,
            "unpack_ms": (t2 - t1) * 1e3}


def _tiers_job(work: str) -> dict:
    """The schedule of phase tiers on the port's control plane (see the
    module docstring); what the phase checks and reports, raw."""
    import shutil

    from edl_tpu_torch.checkpoint import replicate
    from edl_tpu_torch.chaos import drill
    from edl_tpu_torch.cluster.contract import RANK_SERVICE
    from edl_tpu_torch.store.client import StoreClient

    job = TIERS_JOB
    local_base = os.path.join(work, "local")
    w2_step = (ELASTIC_JOIN_EPOCH + 1) * ELASTIC_BATCHES
    cp = _ControlPlane(
        work, job, False, EDL_CKPT_LOCAL_BASE=local_base,
        EDL_CKPT_REPLICAS="1", EDL_CKPT_REPL_BUDGET=str(TIERS_REPL_BUDGET),
        SMOKE_ASYNC="1", SMOKE_DIGEST="1", SMOKE_DRAIN="1")
    client = StoreClient(cp.endpoint, timeout=10.0)
    res = {"job": job, "local_base": local_base}

    def saver():
        return client.get("/%s/%s/0" % (job, RANK_SERVICE)).decode()

    try:
        first = cp.pod()  # alone: rank slot 0, the saver
        _wait(lambda: cp.reached(ELASTIC_JOIN_EPOCH),
              "tiers: epoch %d" % ELASTIC_JOIN_EPOCH, [first])
        joiner = cp.pod()  # its launcher holds the saver's replicas

        def replicated():
            got = replicate.newest_replicated_step(client, job)
            return got is not None and got >= w2_step and os.path.exists(
                os.path.join(cp.out, "hold.%d" % ELASTIC_KILL_EPOCH))

        _wait(replicated, "tiers: a replicated world-2 version",
              [first, joiner])
        res["replicated_step"] = replicate.newest_replicated_step(client, job)
        victim = saver()
        victim_pids = [r["pid"] for r in cp.records() if r["pod"] == victim]
        # the fault: the saver pod dies (its launcher's session; the
        # worker with it), and its local dir, its replica dir and the
        # durable dir are deleted: recovery may read peers only
        res["kill_ts"] = time.time()
        os.killpg(first.pid, 9)
        first.wait(timeout=60)
        _wait(lambda: not any(os.path.exists("/proc/%d" % p)
                              for p in victim_pids),
              "tiers: the saver's worker to exit")
        shutil.rmtree(cp.ckpt, ignore_errors=True)
        for name in (victim, victim + ".replicas"):
            shutil.rmtree(os.path.join(local_base, name), ignore_errors=True)
        res["deleted_ts"] = time.time()
        third = cp.pod()  # the replacement: no local tier, no durable dir
        _wait(lambda: os.path.exists(os.path.join(cp.out, "hold.drain")),
              "tiers: epoch %d's first step" % ELASTIC_DRAIN_EPOCH,
              [joiner, third])
        # the drain: SIGTERM to the stage's saver pod, whose last version
        # may still be in flight
        drained_pod = saver()
        lpid = [r for r in cp.records() if r["pod"] == drained_pod][-1][
            "launcher_pid"]
        drained = next(p for p in (joiner, third) if p.pid == lpid)
        survivor = third if drained is joiner else joiner
        res["drain_ts"] = time.time()
        os.kill(drained.pid, 15)
        res["drain_rc"] = drained.wait(timeout=ELASTIC_WAIT_S)
        res["launcher_rc"] = survivor.wait(timeout=ELASTIC_WAIT_S)
        items = cp.items()
        res["job_status"] = (items.get("/%s/job/status" % job)
                             or (b"",))[0].decode()
        res["records"] = cp.records()
        res["flight"] = cp.flight()
        res["losses"] = drill.read_losses(cp.out)
        res["saved_digests"] = {}
        for name in os.listdir(cp.out):
            if name.startswith("digest."):
                with open(os.path.join(cp.out, name)) as fh:
                    res["saved_digests"][int(name.split(".")[1])] = \
                        json.load(fh)
        # the replicated version as the peer tier landed it in a
        # survivor's local dir: its files, and the same bytes under a
        # single durable directory for the comparison
        step = res["replicated_step"]
        landed = next(os.path.join(local_base, d, str(step))
                      for d in os.listdir(local_base)
                      if os.path.isdir(os.path.join(local_base, d, str(step))))
        files = sorted((os.path.getsize(os.path.join(landed, f)), f)
                       for f in os.listdir(landed))
        res["version_files"] = len(files)
        res["version_bytes"] = sum(n for n, _ in files)
        res["largest_file"] = files[-1]
        res["codec"] = _codec_ms(os.path.join(landed, files[-1][1]))
        durable_copy = os.path.join(work, "durable-copy")
        shutil.copytree(landed, os.path.join(durable_copy, str(step)))
        res["durable_copy"] = durable_copy
        res["launcher_logs"] = [open(p.log).read() for p in cp.procs[1:]]
    except BaseException:
        for name in sorted(os.listdir(cp.logs)):
            sys.stderr.write("--- %s\n%s" % (
                name, _tail(os.path.join(cp.logs, name))))
        raise
    finally:
        client.close()
        cp.close()
    return res


def phase_tiers(torch, smi: str) -> dict:
    """The checkpoint tiers under the flagship trainer (see the module
    docstring): async saves into pod-local dirs, one peer replica, the
    saver pod killed with its dirs and the durable dir, peer restores bit
    for bit, a drain that pushes its last version. The work directory is
    removed afterwards."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="edl-tiers-")
    t0 = time.monotonic()
    df = subprocess.run(["df", "-h", work], capture_output=True,
                        text=True).stdout.strip()
    try:
        res = _tiers_job(work)
        durable = _durable_restore(torch, res["durable_copy"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    layers = ELASTIC_TRAIN["num_layers"]
    flight = res.pop("flight")
    kill_ts, drain_ts = res["kill_ts"], res["drain_ts"]
    recs = res["records"]
    restores = _events(flight, "ckpt_restore")
    tier_of = {e["pid"]: e for e in restores}
    restorers = [r for r in recs if r.get("restored_step") is not None]
    post_kill = [r for r in restorers if kill_ts < r["spawn_ts"] < drain_ts]
    post_drain = [r for r in restorers if r["spawn_ts"] > drain_ts]
    bit_for_bit = [r["restored_digest"] == res["saved_digests"].get(
        r["restored_step"]) for r in restorers]
    norm_ok = [r["stamped_param_norm"] is not None and abs(
        r["restored_param_norm"] - r["stamped_param_norm"])
        <= TOL_PARAM_NORM * r["stamped_param_norm"] for r in restorers]
    after_kill_tiers = [e.get("tier") for e in restores
                        if e["ts"] > kill_ts]
    saves = [{k: e.get(k) for k in ("pid", "step", "seconds", "wait_prev_s",
                                    "stage_s", "stamp_s", "bytes")}
             for e in _events(flight, "ckpt_save")]
    finals = [{k: e.get(k) for k in ("pid", "step", "ok", "write_s",
                                     "finalize_s")}
              for e in _events(flight, "ckpt_finalize")]
    pushes = [{"pid": e["pid"], "step": e.get("step"),
               "outcome": e.get("outcome"), "emergency": e.get("emergency"),
               "seconds": e.get("dur"),
               "gb_per_s": (res["version_bytes"] / e["dur"] / 1e9
                            if e.get("dur") else None)}
              for e in _events(flight, "ckpt_replicate")]
    held = [{k: e.get(k) for k in ("pid", "src", "step", "holder")}
            for e in _events(flight, "ckpt_replica")]
    fetches = [{k: e.get(k) for k in ("pid", "step", "outcome", "bytes", "dur")}
               for e in _events(flight, "ckpt_peer_fetch")]
    peer_restores = [{"pid": e["pid"], "step": e.get("step"),
                      "land_s": e.get("land_s"), "load_s": e.get("seconds"),
                      "total_s": (e.get("land_s") or 0.0)
                      + (e.get("seconds") or 0.0)}
                     for e in restores if e.get("tier") == "peer"]
    emergency = [{k: e.get(k) for k in ("pid", "outcome", "seconds",
                                        "budget_s")}
                 for e in _events(flight, "ckpt_emergency_repl")]
    recover = [r["first_step_end_ts"][0] - kill_ts for r in post_kill
               if r["first_step_end_ts"]]
    per_proc = [{"pid": r["pid"], "pod": r["pod"][:8], "rank": r["rank"],
                 "world": r["world"], "steps": r["steps"],
                 "launches": r["launches"],
                 "restored_step": r.get("restored_step"),
                 "tier": (tier_of.get(r["pid"]) or {}).get("tier"),
                 "restore_s": r.get("restore_s"),
                 "replica_lag_steps": r["replica_lag_steps"]}
                for r in recs]
    planes = _planes_report(flight)
    states = planes["goodput_states_s"]
    ckpt_share = ((states.get("ckpt_save", 0.0)
                   + states.get("ckpt_restore", 0.0))
                  / sum(states.values())) if states else None
    losses = {e: v for e, (v, _st) in res["losses"].items()}
    durable_same = durable["digest"] == res["saved_digests"].get(
        res["replicated_step"])
    out = {
        "phase": "tiers", "config": "flagship",
        "tokens": [FLAGSHIP_TRAIN["batch"], FLAGSHIP_TRAIN["seq"]],
        "df": df, "repl_budget_s": TIERS_REPL_BUDGET,
        "replicated_step": res["replicated_step"],
        "version_bytes": res["version_bytes"],
        "version_files": res["version_files"],
        "largest_file": res["largest_file"], "codec": res["codec"],
        "saves": saves, "finalizes": finals,
        "pushes": pushes, "held": held, "peer_fetches": fetches,
        "peer_restores": peer_restores,
        "durable_restore_same_version": {
            "seconds": durable["seconds"], "step": durable["step"],
            "bit_for_bit": durable_same},
        "restores": [{"pid": r["pid"], "step": r["restored_step"],
                      "tier": (tier_of.get(r["pid"]) or {}).get("tier"),
                      "after": ("drain" if r in post_drain else "kill"
                                if r in post_kill else "start")}
                     for r in restorers],
        "restores_bit_for_bit": bit_for_bit,
        "restored_norm_matches_fingerprint": norm_ok,
        "tol_param_norm": TOL_PARAM_NORM,
        "tiers_after_kill": after_kill_tiers,
        "kill_to_first_step_s": recover,
        "drain": {"launcher_rc": res["drain_rc"],
                  "emergency_replicate": emergency,
                  "restore_waited": [
                      {k: e.get(k) for k in ("pid", "pods", "seconds")}
                      for e in _events(flight, "ckpt_drain_wait")],
                  "resumed": [{"pid": r["pid"], "step": r["restored_step"],
                               "tier": (tier_of.get(r["pid"]) or {}).get(
                                   "tier")} for r in post_drain]},
        "launcher_rc": res["launcher_rc"], "job_status": res["job_status"],
        "losses": {str(e): v for e, v in sorted(losses.items())},
        "launches_per_process": per_proc,
        "launches": {k: sum(p["launches"][k] for p in per_proc)
                     for k in kernels},
        "planes": planes, "ckpt_share_of_goodput_states": ckpt_share,
        "seconds": time.monotonic() - t0, "card": smi,
    }
    emit(out)
    for log in res["launcher_logs"]:
        check("edl_tpu_torch.launch" in log and "edl_tpu.launch" not in log,
              "tiers: a launcher log is not the port launcher's")
    check(res["launcher_rc"] == 0 and res["job_status"] == "COMPLETE",
          "tiers: launcher %s, job %r" % (res["launcher_rc"],
                                          res["job_status"]))
    check(res["replicated_step"] == (ELASTIC_JOIN_EPOCH + 1)
          * ELASTIC_BATCHES, "tiers: replicated %s" % res["replicated_step"])
    check(len(post_kill) == 2 and all(
        (tier_of.get(r["pid"]) or {}).get("tier") == "peer"
        and r["restored_step"] == res["replicated_step"] for r in post_kill),
          "tiers: after the kill, not two peer restores of the replicated "
          "step (lost work): %s" % out["restores"])
    check("durable" not in after_kill_tiers,
          "tiers: a durable read after the kill: %s" % after_kill_tiers)
    check(len(post_drain) == 1 and (tier_of.get(post_drain[0]["pid"])
                                     or {}).get("tier") == "peer",
          "tiers: after the drain, not one peer restore: %s" % out["restores"])
    check(res["drain_rc"] == 76 and emergency
          and emergency[0]["outcome"] == "ok",
          "tiers: drain exited %s, emergency push %s"
          % (res["drain_rc"], emergency))
    check(post_drain[0]["restored_step"]
          == ELASTIC_DRAIN_EPOCH * ELASTIC_BATCHES,
          "tiers: the drained stage's last version was not restored: %s"
          % out["drain"])
    check(restorers and all(bit_for_bit),
          "tiers: restores not bit for bit: %s" % bit_for_bit)
    check(all(norm_ok), "tiers: restored parameter norms vs stamped: %s"
          % [(r["restored_param_norm"], r["stamped_param_norm"])
             for r in restorers])
    check(durable_same and durable["step"] == res["replicated_step"],
          "tiers: the durable restore of the replicated version differs")
    check(sorted(losses) == list(range(ELASTIC_EPOCHS))
          and all(math.isfinite(v) for v in losses.values()),
          "tiers: losses %s" % losses)
    check(all(f["ok"] for f in finals) and saves,
          "tiers: an async save failed: %s" % finals)
    _check_planes("tiers", planes, world2=True)
    for p in per_proc:
        want = {k: 2 * layers * p["steps"] for k in kernels}
        check(p["steps"] > 0 and p["launches"] == want,
              "tiers worker %d: launches %s for %d steps"
              % (p["pid"], p["launches"], p["steps"]))
    return out


def phase_trainee(torch, smi: str, device: str = "cuda") -> dict:
    """The port's chaos trainee (``edl_tpu_torch/chaos/trainee.py``) on
    the card under the port's store and launcher, no JAX: one pod whose
    worker the ``EDL_CHAOS`` rule kills at its 7th step; the pod leaves
    the job, a replacement pod resumes from the newest checkpoint and
    completes it. Audited by the port's ``chaos/invariants.py``:
    completed, shards_exactly_once, resumed_past_prefault_step,
    numerics_continuous and goodput_accounted."""
    import shutil
    import tempfile

    from edl_tpu_torch.chaos import invariants as inv
    from edl_tpu_torch.store.client import StoreClient

    trainee = os.path.join(HERE, "edl_tpu_torch", "chaos", "trainee.py")
    work = tempfile.mkdtemp(prefix="edl-trainee-")
    job = "chip-smoke-trainee"
    chaos_log = os.path.join(work, "chaos.log")
    spec = {"seed": 0, "rules": [
        {"point": "train.step", "proc": "worker", "action": "kill",
         "match": {"rank": "0"}, "after": TRAINEE_KILL_AFTER}]}
    t0 = time.monotonic()
    cp = _ControlPlane(work, job, False,
                       EDL_CHAOS_TOTAL_STEPS=str(TRAINEE_STEPS),
                       EDL_CHAOS_CKPT_EVERY=str(TRAINEE_CKPT_EVERY),
                       EDL_CHAOS_LOG=chaos_log, EDL_CHAOS_DEVICE=device)
    res = {"phase": "trainee", "script": "edl_tpu_torch/chaos/trainee.py",
           "device": device, "steps": TRAINEE_STEPS,
           "ckpt_every": TRAINEE_CKPT_EVERY, "chaos": spec, "card": smi}
    try:
        pods = "1:1"
        grace = ("--fail_grace", "1.0")
        first = cp.pod([trainee], env={"EDL_CHAOS": json.dumps(spec)},
                       nodes=pods, args=grace)
        res["killed_pod_rc"] = first.wait(timeout=TRAINEE_WAIT_S)
        t_kill = time.monotonic()
        second = cp.pod([trainee], nodes=pods, args=grace)
        res["resumed_pod_rc"] = second.wait(timeout=TRAINEE_WAIT_S)
        res["replacement_s"] = time.monotonic() - t_kill
        client = StoreClient(cp.endpoint, timeout=10.0)
        try:
            ev = inv.Evidence(progress=inv.read_progress(client, job),
                              chaos_log=inv.read_chaos_log(chaos_log))
        finally:
            client.close()
        events = cp.flight()
    except BaseException:
        for name in sorted(os.listdir(cp.logs)):
            sys.stderr.write("--- %s\n%s" % (
                name, _tail(os.path.join(cp.logs, name))))
        raise
    finally:
        cp.close()
        shutil.rmtree(work, ignore_errors=True)
    kills = [e for e in ev.chaos_log
             if e.get("point") == "train.step" and e.get("action") == "kill"]
    prefault = max((int(e["ctx"].get("step", 0)) for e in kills),
                   default=None)
    results = [
        inv.completed(ev, TRAINEE_STEPS),
        inv.shards_exactly_once(ev, TRAINEE_STEPS),
        inv.resumed_past_prefault_step(ev, prefault),
        inv.numerics_continuous(events),
        inv.goodput_accounted(events),
    ]
    planes = _planes_report(events)
    res.update({
        "kills": len(kills), "prefault_step": prefault,
        "restores": sorted(int(r.get("restored", 0))
                           for r in ev.progress["restores"]),
        "invariants": [{"name": r.name, "ok": r.ok, "detail": r.detail}
                       for r in results],
        "goodput_fraction": planes["goodput_fraction"],
        "goodput_fraction_by_lane": planes["goodput_fraction_by_lane"],
        "seconds": time.monotonic() - t0,
    })
    emit(res)
    check(len(kills) == 1 and prefault == TRAINEE_KILL_AFTER - 1,
          "trainee: kills %s" % kills)
    check(res["killed_pod_rc"] != 0 and res["resumed_pod_rc"] == 0,
          "trainee: pod exit codes %s, %s"
          % (res["killed_pod_rc"], res["resumed_pod_rc"]))
    bad = [str(r) for r in results if not r.ok]
    check(not bad, "trainee invariants failed: %s" % bad)
    return res


def _rel_err(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


def _resnet_step(torch, device, dtype, weights, batch):
    """One ``make_train_step`` step of ResNet50_vd (SGD 0.1, momentum 0.9,
    ``{"train": True}``) from ``weights``: the logits, the loss and the
    state dict after the step, on the CPU."""
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.train import create_state, cross_entropy_loss
    from edl_tpu_torch.train import make_train_step, sgd

    model = ResNet50_vd(num_classes=1000, dtype=dtype)
    model.load_state_dict(weights)
    state = create_state(model, None, sgd(0.1, momentum=0.9), device=device)
    seen = []

    def head(logits, y):
        seen.append(logits.detach())
        return cross_entropy_loss(logits, y)

    step = make_train_step(head, {"train": True})
    x, y = (t.to(device) for t in batch)
    state, m = step(state, (x, y))
    return {"logits": seen[0].cpu(), "loss": m["loss"].cpu(),
            "state": {k: v.detach().cpu()
                      for k, v in state.apply_fn.state_dict().items()}}


def _resnet_card_vs_cpu(torch) -> dict:
    """(a) One train step of ResNet50_vd at RESNET_CHECK_SHAPE on the card
    (bf16 compute) against the port's CPU step in fp32 from the same
    seeded weights: logits, loss, the running averages and the
    parameters' updates. The same step on the CPU in bf16 is the
    yardstick of the updates: what bf16 alone moves them by."""
    import numpy as np

    from edl_tpu_torch.models.resnet import ResNet50_vd

    model = ResNet50_vd(num_classes=1000, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    n, size = RESNET_CHECK_SHAPE[0], RESNET_CHECK_SHAPE[1]
    x = torch.from_numpy(np.random.RandomState(0).standard_normal(
        RESNET_CHECK_SHAPE).astype(np.float32))
    y = torch.from_numpy(np.random.RandomState(1).randint(0, 1000, n))
    t0 = time.monotonic()
    card = _resnet_step(torch, "cuda", torch.bfloat16, weights, (x, y))
    cpu = _resnet_step(torch, "cpu", torch.float32, weights, (x, y))
    cpu16 = _resnet_step(torch, "cpu", torch.bfloat16, weights, (x, y))
    stats = [k for k in weights if k.endswith((".mean", ".var"))]
    params = [k for k in weights if k not in stats]
    want = {k: cpu["state"][k] - weights[k] for k in params}

    def update_err(run):
        """Each parameter's update against the fp32 CPU step's (relative
        L2), the worst, and all updates as one vector."""
        errs = {k: float((run["state"][k] - weights[k] - want[k]).norm()
                         / want[k].norm().clamp(min=1e-30)) for k in params}
        got = torch.cat([(run["state"][k] - weights[k]).reshape(-1)
                         for k in params])
        ref = torch.cat([want[k].reshape(-1) for k in params])
        worst = max(errs, key=errs.get)
        return {"global": float((got - ref).norm() / ref.norm()),
                "worst": errs[worst], "worst_name": worst}

    upd, upd16 = update_err(card), update_err(cpu16)
    stats_err = {k: _rel_err(card["state"][k], cpu["state"][k])
                 for k in stats}
    worst_stat = max(stats_err, key=stats_err.get)
    bound = {k: TOL_RN_UPDATE_RATIO * upd16[k] + TOL_RN_UPDATE
             for k in ("global", "worst")}
    res = {
        "shape": list(RESNET_CHECK_SHAPE), "image": size,
        "logits_err": _rel_err(card["logits"], cpu["logits"]),
        "logits_err_cpu_bf16": _rel_err(cpu16["logits"], cpu["logits"]),
        "loss_card": float(card["loss"]), "loss_cpu": float(cpu["loss"]),
        "loss_rel_err": abs(float(card["loss"]) - float(cpu["loss"]))
        / abs(float(cpu["loss"])),
        "stats_err": stats_err[worst_stat], "stats_worst": worst_stat,
        "update": upd, "update_cpu_bf16": upd16, "update_bound": bound,
        "tolerances": {"logits": TOL_RN_LOGITS, "loss": TOL_RN_LOSS,
                       "stats": TOL_RN_STATS,
                       "update": "%g x cpu bf16 + %g" % (
                           TOL_RN_UPDATE_RATIO, TOL_RN_UPDATE)},
        "seconds": time.monotonic() - t0,
    }
    emit({"phase": "resnet_check", **res})
    check(res["logits_err"] <= TOL_RN_LOGITS,
          "resnet card vs cpu: logits %.3g" % res["logits_err"])
    check(res["loss_rel_err"] <= TOL_RN_LOSS,
          "resnet card vs cpu: loss %.3g" % res["loss_rel_err"])
    check(res["stats_err"] <= TOL_RN_STATS,
          "resnet card vs cpu: running averages %.3g (%s)"
          % (res["stats_err"], worst_stat))
    for k in ("global", "worst"):
        check(upd[k] <= bound[k], "resnet card vs cpu: update %s %.3g > %.3g"
              % (k, upd[k], bound[k]))
    return res


def _buffers_digest(torch, module) -> str:
    """sha256 of every batch-norm buffer of ``module``, in name order."""
    h = hashlib.sha256()
    for name, buf in sorted(module.named_buffers()):
        h.update(buf.detach().contiguous().cpu().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def resnet_launched(torch, out_dir: str) -> None:
    """The worker the port's launcher spawns in phase resnet
    (``python3 chip_smoke.py --resnet-launched OUT_DIR -- ARGS``): the
    port's ``examples/resnet_collective.py`` ``main(ARGS)``, observed.
    Every save and restore is digested (parameters, buffers, the
    optimizer's momentum); every step's loss and batch-norm buffers'
    digest are recorded; the first stage to reach epoch
    ``ELASTIC_JOIN_EPOCH`` or ``ELASTIC_KILL_EPOCH`` holds at its start
    until the drain token moves. Writes ``rec.<pid>.json`` at every save
    and at the end."""
    from edl_tpu_torch.chaos import drill
    from edl_tpu_torch.checkpoint import manager
    from edl_tpu_torch.examples import resnet_collective as job
    from edl_tpu_torch.train import context

    spawn_ts = float(os.environ["EDL_SPAWN_TS"])
    env0 = context.current_env()
    rec = {"pid": os.getpid(), "spawn_ts": spawn_ts,
           "import_s": time.time() - spawn_ts, "rank": env0.global_rank,
           "stage": env0.stage, "world": env0.world_size, "restages": [],
           "steps": [], "first_step_end_ts": None}
    _digesting_restore(torch, rec)
    _digesting_save(torch, out_dir)
    cur = {"epoch": None}
    records = job.records

    def held(epoch, rank, count, size):
        if epoch in (ELASTIC_JOIN_EPOCH, ELASTIC_KILL_EPOCH):
            drill.hold_at_epoch(out_dir, epoch, ELASTIC_SETTLE_S)
        yield from records(epoch, rank, count, size)

    def holding_records(epoch, rank, count, size):
        cur["epoch"] = epoch
        return held(epoch, rank, count, size)

    job.records = holding_records
    make = job.make_train_step

    def observed_make(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch):
            state, m = inner(state, batch)
            loss = float(m["loss"])  # synchronises
            if rec["first_step_end_ts"] is None:
                rec["first_step_end_ts"] = time.time()
            rec["steps"].append({
                "epoch": cur["epoch"], "step": int(state.step), "loss": loss,
                "t": time.time(),
                "buffers": _buffers_digest(torch, state.apply_fn)})
            return state, m

        return step

    job.make_train_step = observed_make
    save = manager.CheckpointManager.save

    def recording_save(self, state, status, step=None):
        import torch.distributed as dist

        saved = save(self, state, status, step)
        _write_json(os.path.join(out_dir, "rec.%d.json" % os.getpid()), rec)
        if dist.is_initialized():
            # every rank's record is written before rank 0 reaches the
            # next epoch's hold (after which the phase may kill a rank)
            dist.barrier()
        return saved

    manager.CheckpointManager.save = recording_save
    args = sys.argv[sys.argv.index("--") + 1:]
    try:
        job.main(args)
    finally:
        _write_json(os.path.join(out_dir, "rec.%d.json" % os.getpid()), rec)


def _resnet_reference(torch) -> dict:
    """The elastic job's schedule in this process at world 1: the same
    seeded ResNet50_vd and records, each world-2 epoch on the two ranks'
    batches concatenated, at the learning rate each stage sets
    (``linear_scaled_lr(0.1, 1)``: doubled at world 2). Each step's
    loss."""
    import numpy as np

    from edl_tpu_torch.data import batched
    from edl_tpu_torch.examples import resnet_collective as job
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.train import create_state, make_cross_entropy_loss
    from edl_tpu_torch.train import make_train_step, sgd

    state = create_state(ResNet50_vd(num_classes=1000), 0,
                         sgd(0.1, momentum=0.9, nesterov=True), device="cuda")
    step = make_train_step(make_cross_entropy_loss(5), {"train": True})
    losses = []
    b = RESNET_JOB_BATCH
    for epoch in range(ELASTIC_EPOCHS):
        world = 2 if ELASTIC_JOIN_EPOCH <= epoch < ELASTIC_KILL_EPOCH else 1
        for group in state.opt_state.optimizer.param_groups:
            group["lr"] = 0.1 * world
        ranks = [list(batched(job.records(epoch, r, ELASTIC_BATCHES * b, 224),
                              b, drop_remainder=True)) for r in range(world)]
        for i in range(ELASTIC_BATCHES):
            x = np.concatenate([ranks[r][i][0][0] for r in range(world)])
            y = np.concatenate([ranks[r][i][0][1] for r in range(world)])
            state, m = step(state, (torch.from_numpy(x).cuda(),
                                    torch.from_numpy(y).cuda()))
            losses.append({"epoch": epoch, "world": world,
                           "loss": float(m["loss"])})
    del state
    torch.cuda.empty_cache()
    return {"losses": losses}


def _resnet_job(work: str) -> dict:
    """(c) The port's example on the port's store and launcher, cold: one
    pod; at epoch ELASTIC_JOIN_EPOCH a second joins (two ranks on the one
    card, gloo); at ELASTIC_KILL_EPOCH the joiner is SIGKILLed."""
    cp = _ControlPlane(work, "chip-smoke-resnet", False)
    script = [os.path.abspath(__file__), "--resnet-launched", cp.out, "--",
              "--epochs", str(ELASTIC_EPOCHS),
              "--steps_per_epoch", str(ELASTIC_BATCHES),
              "--batch_per_worker", str(RESNET_JOB_BATCH)]
    res = {"job": cp.job, "store": cp.store_line}
    try:
        first = cp.pod(script)
        _wait(lambda: cp.reached(ELASTIC_JOIN_EPOCH),
              "resnet: epoch %d" % ELASTIC_JOIN_EPOCH, [first])
        joiner = cp.pod(script)
        _wait(lambda: cp.reached(ELASTIC_KILL_EPOCH),
              "resnet: epoch %d at world 2" % ELASTIC_KILL_EPOCH,
              [first, joiner])
        os.kill(joiner.pid, 9)  # a dead machine: its lease must expire
        joiner.wait(timeout=60)
        res["launcher_rc"] = first.wait(timeout=ELASTIC_WAIT_S)
        items = cp.items()
        res["job_status"] = (items.get("/%s/job/status" % cp.job)
                             or (b"",))[0].decode()
        res["bump_ts"] = {}
        for key, (value, _lease) in items.items():
            found = re.match(r"/%s/events/([0-9a-f]+)/drain\." % cp.job, key)
            if found:
                res["bump_ts"][found.group(1)] = float(value)
        res["records"] = cp.records()
        res["versions"] = cp.versions()
        res["saved_digests"] = {}
        for name in os.listdir(cp.out):
            if name.startswith("digest."):
                with open(os.path.join(cp.out, name)) as fh:
                    res["saved_digests"][int(name.split(".")[1])] = \
                        json.load(fh)
        last = os.path.join(cp.ckpt, str(res["versions"][-1]))
        res["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, files in os.walk(last) for f in files)
    except BaseException:
        for name in sorted(os.listdir(cp.logs)):
            sys.stderr.write("--- %s\n%s" % (
                name, _tail(os.path.join(cp.logs, name))))
        raise
    finally:
        cp.close()
    return res


def phase_resnet(torch, smi: str) -> dict:
    """ResNet50_vd, the JAX package's flagship collective-training model:
    (a) the card's step against the CPU's, (b) the headline bench's
    ``measure()``, (c) the port's example elastic 1 -> 2 -> 1 on the
    port's control plane against a world-1 run of the same schedule (see
    the module docstring)."""
    import shutil
    import tempfile

    from edl_tpu_torch.tools import bench

    t0 = time.monotonic()
    check_ab = _resnet_card_vs_cpu(torch)
    torch.cuda.empty_cache()
    saved = {k: os.environ.get(k) for k in RESNET_BENCH_ENV}
    benchmark = torch.backends.cudnn.benchmark
    os.environ.update(RESNET_BENCH_ENV)
    try:
        rec = bench.measure("cuda")
    finally:
        torch.backends.cudnn.benchmark = benchmark
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    rec = {"phase": "resnet_bench", **rec, "card": smi}
    emit(rec)
    check(rec["metric"] == bench.METRIC and rec["value"] > 0
          and math.isfinite(rec["loss"]), "resnet bench: %s" % rec["metric"])
    check(rec.get("device_ms") is not None, "resnet bench: no device time")

    ref = _resnet_reference(torch)
    work = tempfile.mkdtemp(prefix="edl-resnet-")
    try:
        job = _resnet_job(os.path.join(work, "job"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    stages = _stage_order(job)
    recs = job["records"]
    restorers = [r for r in recs if r.get("restored_step") is not None]
    bit_for_bit = [r["restored_digest"]
                   == job["saved_digests"].get(r["restored_step"])
                   for r in restorers]
    recover = [{
        "stage": stages.index(r["stage"]) + 1, "world": r["world"],
        "rank": r["rank"], "restored_step": r["restored_step"],
        "spawn_to_first_step_s": (r["first_step_end_ts"] - r["spawn_ts"]
                                  - r["digest_s"]),
        "bump_to_first_step_s": (r["first_step_end_ts"]
                                 - job["bump_ts"][r["stage"]] - r["digest_s"]),
        "restore_s": r["restore_s"], "import_s": r["import_s"]}
        for r in restorers]
    # the job's global loss per step: the mean of its ranks' losses
    by_step = {}
    bufs = {}
    for r in recs:
        for s in r["steps"]:
            by_step.setdefault(s["step"], []).append(s["loss"])
            if r["world"] == 2:
                bufs.setdefault(s["step"], set()).add(s["buffers"])
    job_losses = [sum(v) / len(v) for _k, v in sorted(by_step.items())]
    # rank 0's step time (the loss fetched each step) between steps of
    # one epoch, by world
    step_s = {}
    for r in recs:
        if r["rank"] == 0:
            steps = r["steps"]
            step_s.setdefault(r["world"], []).extend(
                b["t"] - a["t"] for a, b in zip(steps, steps[1:])
                if a["epoch"] == b["epoch"])
    ref_losses = [r["loss"] for r in ref["losses"]]
    loss_err = [abs(a - b) / abs(b) for a, b in zip(job_losses, ref_losses)]
    out = {
        "phase": "resnet", "model": "ResNet50_vd", "card": smi,
        "check": {k: check_ab[k] for k in ("logits_err", "loss_rel_err",
                                           "stats_err", "update",
                                           "update_cpu_bf16")},
        "bench": {k: rec.get(k) for k in (
            "value", "vs_baseline", "step_ms", "host_enqueue_ms",
            "device_ms", "device_idle_share", "mfu", "step_tflops",
            "peak_memory_bytes", "device_ms_by_class", "power_limit_w")},
        "job": {
            "per_worker_batch": RESNET_JOB_BATCH, "image": 224,
            "epochs": ELASTIC_EPOCHS, "steps_per_epoch": ELASTIC_BATCHES,
            "worlds": [r["world"] for r in ref["losses"]],
            "launcher_rc": job["launcher_rc"],
            "job_status": job["job_status"], "versions": job["versions"],
            "checkpoint_bytes": job["checkpoint_bytes"],
            "restores_bit_for_bit": bit_for_bit,
            "world2_steps": len(bufs),
            "world2_buffer_divergence": sum(len(v) - 1 for v in bufs.values()),
            "step_s_by_world": step_s,
            "losses": job_losses, "reference_losses": ref_losses,
            "loss_rel_err": loss_err, "tol_loss": TOL_RN_JOB,
            "time_to_recover": recover,
        },
        "seconds": time.monotonic() - t0,
    }
    emit(out)
    n = ELASTIC_EPOCHS * ELASTIC_BATCHES
    check(job["launcher_rc"] == 0 and job["job_status"] == "COMPLETE",
          "resnet job: launcher %s, status %r"
          % (job["launcher_rc"], job["job_status"]))
    check(len(restorers) == 3 and all(bit_for_bit),
          "resnet job: restores bit for bit %s" % bit_for_bit)
    check(len(job_losses) == n and len(ref_losses) == n,
          "resnet job: %d steps, reference %d" % (len(job_losses),
                                                   len(ref_losses)))
    check(len(bufs) == ELASTIC_BATCHES
          and all(len(v) == 1 for v in bufs.values()),
          "resnet job: world-2 buffers diverge %s" % bufs)
    check(max(loss_err) <= TOL_RN_JOB,
          "resnet job: losses against the world-1 run %s" % loss_err)
    return out


def _fsdp_batches(torch, n: int, batch: int):
    """``n`` seeded [batch, 224, 224, 3] image batches and their labels,
    drawn on the host (the same in every process)."""
    import numpy as np

    return [(torch.from_numpy(np.random.default_rng(500 + i).standard_normal(
                (batch, 224, 224, 3), dtype=np.float32)),
             torch.from_numpy(np.random.default_rng(600 + i).integers(
                 0, 1000, (batch,)).astype(np.int64)))
            for i in range(n)]


def _one_rank_nccl(torch):
    import torch.distributed as dist

    from edl_tpu_torch.utils.net import find_free_ports

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="tcp://127.0.0.1:%d" % find_free_ports(1)[0],
        world_size=1, rank=0)


def _leave_group(torch) -> None:
    from edl_tpu_torch.train import context

    context._teardown_group()  # the mesh and checkpoint groups with it
    torch.cuda.empty_cache()


def _fsdp_state(torch, sharded: bool):
    """ResNet50_vd (bf16 compute, fp32 masters) from ``init_weights(0)``
    on the card and SGD 0.1 momentum 0.9, as phase resnet's bench builds
    it; ``sharded``: built on ``meta``, sharded by ``shard_params_fsdp``
    over the stage's fsdp axis, then its shards materialised and drawn."""
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.parallel import make_mesh, shard_params_fsdp
    from edl_tpu_torch.train import create_state, sgd

    if not sharded:
        model = ResNet50_vd(num_classes=1000, device=torch.device("cuda"))
        return create_state(model, 0, sgd(0.1, momentum=0.9), device="cuda")
    model = ResNet50_vd(num_classes=1000, device=torch.device("meta"))
    shard_params_fsdp(make_mesh({"dp": 1, "fsdp": -1}, device="cuda"), model)
    model.to_empty(device="cuda")
    return create_state(model, 0, sgd(0.1, momentum=0.9), device="cuda")


def full_digest(torch, state) -> dict:
    """:func:`state_digest` of the whole tensors of a possibly sharded
    state: every rank's ``DTensor`` shards go to rank 0 as host objects
    and are put in their places there (collective; no DTensor collective,
    which gloo does not carry for tensors on the card). {} on a rank
    other than 0."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import get_state_dict
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    model_sd, optim_sd = get_state_dict(state.apply_fn,
                                        state.opt_state.optimizer)
    tensors = {"model/" + k: v for k, v in model_sd.items()}
    for name, slots in optim_sd["state"].items():
        for slot, v in slots.items():
            if torch.is_tensor(v):
                tensors["optim/%s/%s" % (name, slot)] = v
    tensors["step"] = state.step
    parts = {}
    for key, t in tensors.items():
        if isinstance(t, DTensor):
            _shape, offset = compute_local_shape_and_global_offset(
                t.shape, t.device_mesh, t.placements)
            parts[key] = (tuple(t.shape), offset, t.to_local().detach().cpu())
        else:
            parts[key] = (None, None, t.detach().cpu())
    everyone = [parts]
    if dist.is_initialized() and dist.get_world_size() > 1:
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, parts)
        if dist.get_rank() != 0:
            return {}
    out = {}
    for key in sorted(parts):
        shape, _offset, whole = everyone[0][key]
        if shape is not None:
            whole = torch.empty(shape, dtype=whole.dtype)
            for rank_parts in everyone:
                _s, offset, local = rank_parts[key]
                whole[tuple(slice(o, o + n) for o, n in
                            zip(offset, local.shape))] = local
        raw = whole.contiguous().reshape(-1).view(torch.uint8)
        out[key] = hashlib.sha256(raw.numpy().tobytes()).hexdigest()
    return out


def _shard_bytes(torch, state) -> dict:
    """This rank's parameter and momentum bytes (its shards under FSDP)."""
    def local(t):
        t = getattr(t, "_local_tensor", t)
        return t.numel() * t.element_size()

    params = sum(local(p) for p in state.apply_fn.parameters())
    moments = sum(local(v) for slots in
                  state.opt_state.optimizer.state.values()
                  for v in slots.values() if torch.is_tensor(v))
    return {"params": params, "momentum": moments}


def _fsdp_steps(torch, state, batches, timed: int) -> dict:
    """The check steps with cuDNN deterministic (their losses and the
    parameters after them, whole), then, at phase resnet's bench settings
    (cuDNN benchmark), FSDP_WARMUP steps and ``timed`` steps on the last
    batch: step ms, img/s, peak memory, the host's time to queue one step
    and its device time."""
    from torch.distributed.tensor import DTensor

    from edl_tpu_torch.tools import bench
    from edl_tpu_torch.train import cross_entropy_loss, make_train_step

    step = make_train_step(cross_entropy_loss, {"train": True})
    dev = [(x.cuda(), y.cuda()) for x, y in batches]
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    losses = []
    try:
        for b in dev:
            state, m = step(state, b)
            losses.append(m["loss"])
        losses = [float(v) for v in torch.stack(losses).tolist()]
    finally:
        cudnn.deterministic, cudnn.benchmark = False, True
    params = {k: (v.full_tensor() if isinstance(v, DTensor) else v
                  ).detach().clone()
              for k, v in state.apply_fn.named_parameters()}
    for _ in range(FSDP_WARMUP):
        state, m = step(state, dev[-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(timed):
        state, m = step(state, dev[-1])
    float(m["loss"])
    step_ms = (time.perf_counter() - t0) / timed * 1e3
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    state, _ = step(state, dev[-1])
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    prof = bench.device_breakdown(lambda: step(state, dev[-1]))
    cudnn.deterministic, cudnn.benchmark = saved
    return {"state": state, "losses": losses, "params": params,
            "step_ms": step_ms, "img_per_s": FSDP_BATCH / step_ms * 1e3,
            "peak_memory_bytes": peak, "host_enqueue_ms": enqueue_ms,
            "device_ms": prof["device_ms"],
            "kernels_per_step": prof["kernels"]}


def fsdp_launched(torch, out_dir: str, fsdp1_dir: str) -> None:
    """The worker the port's launcher spawns in phase fsdp (``python3
    chip_smoke.py --fsdp-launched OUT_DIR FSDP1_DIR``): ``ElasticTrainer(
    fsdp=True)`` on ResNet50_vd at 224x224, the global batch on every
    rank (``{"dp": 1, "fsdp": -1}``), one epoch of FSDP_JOB_STEPS steps
    and its checkpoint; each step's loss, this rank's shard bytes and the
    gathered state's digest; then phase (a)'s fsdp-1 version restored
    into the same sharded state, digested."""
    import torch.distributed as dist

    from edl_tpu_torch.checkpoint import CheckpointManager
    from edl_tpu_torch.models.resnet import ResNet50_vd
    from edl_tpu_torch.obs import memory
    from edl_tpu_torch.train import ElasticTrainer, cross_entropy_loss, sgd
    from edl_tpu_torch.train import loop

    rank = int(os.environ["EDL_WORKER_RANK"])
    rec = {"pid": os.getpid(), "rank": rank, "steps": [],
           "spawn_ts": float(os.environ.get("EDL_SPAWN_TS", "0"))}
    make = loop.make_train_step

    def observed_make(*args, **kwargs):
        inner = make(*args, **kwargs)

        def step(state, batch):
            state, m = inner(state, batch)
            rec["steps"].append(float(m["loss"]))
            return state, m

        return step

    loop.make_train_step = observed_make
    batches = _fsdp_batches(torch, FSDP_JOB_STEPS, FSDP_JOB_BATCH)
    trainer = ElasticTrainer(
        ResNet50_vd(num_classes=1000), lambda o: sgd(0.1, momentum=0.9),
        cross_entropy_loss, fsdp=True, mesh_axes={"dp": 1, "fsdp": -1},
        ckpt_dir=os.environ["EDL_CKPT_PATH"], apply_kwargs={"train": True},
        seed=0, log=False, device="cuda")
    state = trainer.fit(lambda epoch: ((x.numpy(), y.numpy())
                                       for x, y in batches), 1)
    rec["world"] = dist.get_world_size()
    rec["mesh"] = trainer.mesh.shape
    rec["bytes"] = _shard_bytes(torch, state)
    rec["plan_state_bytes"] = memory.state_bytes(state)
    rec["saved"] = full_digest(torch, state)
    with CheckpointManager(fsdp1_dir) as mngr:
        state, status = mngr.restore(state)
    rec["fsdp1_restored_step"] = status.step if status else None
    rec["fsdp1_restored"] = full_digest(torch, state)
    _write_json(os.path.join(out_dir, "rec.%d.json" % rank), rec)
    dist.barrier()


def phase_fsdp(torch, smi: str) -> dict:
    """ResNet50_vd under FSDP2 (see the module docstring): (a) sharded
    over a one-rank NCCL group against the unsharded step, (b) a sharded
    DCP round trip, (c) two ranks at fsdp 2 through the port's store and
    launcher, and the versions resharded 2 -> 1 and 1 -> 2."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor

    from edl_tpu_torch.checkpoint import CheckpointManager, TrainStatus
    from edl_tpu_torch.train import cross_entropy_loss, make_train_step

    t0 = time.monotonic()
    work = tempfile.mkdtemp(prefix="edl-fsdp-")
    fsdp1_dir = os.path.join(work, "fsdp1")
    batches = _fsdp_batches(torch, FSDP_CHECK_STEPS, FSDP_BATCH)
    bare = _fsdp_steps(torch, _fsdp_state(torch, False), batches,
                       FSDP_TIMED_STEPS)
    bare_bytes = _shard_bytes(torch, bare.pop("state"))
    torch.cuda.empty_cache()
    _one_rank_nccl(torch)
    try:
        state = _fsdp_state(torch, True)
        kinds = {type(p).__name__ for p in state.apply_fn.parameters()}
        check(kinds == {"DTensor"}, "fsdp (a): parameters are %s" % kinds)
        run = _fsdp_steps(torch, state, batches, FSDP_TIMED_STEPS)
        state = run.pop("state")
        a_bytes = _shard_bytes(torch, state)
        # (b) the sharded version and a collective restore into a
        # freshly sharded module
        t_b = time.monotonic()
        with CheckpointManager(fsdp1_dir) as mngr:
            mngr.save(state, TrainStatus(epoch=0, step=int(state.step)))
        saved = full_digest(torch, state)
        want = {k: v.to_local().clone()
                for k, v in state.apply_fn.state_dict().items()
                if isinstance(v, DTensor)}
        want_m = [v.to_local().clone() for slots in
                  state.opt_state.optimizer.state.values()
                  for v in slots.values() if isinstance(v, DTensor)]
        del state
        torch.cuda.empty_cache()
        fresh = _fsdp_state(torch, True)
        with CheckpointManager(fsdp1_dir) as mngr:
            fresh, status = mngr.restore(fresh)
        got = {k: v.to_local() for k, v in
               fresh.apply_fn.state_dict().items()
               if isinstance(v, DTensor)}
        got_m = [v.to_local() for slots in
                 fresh.opt_state.optimizer.state.values()
                 for v in slots.values() if isinstance(v, DTensor)]
        b_equal = (status is not None and sorted(got) == sorted(want)
                   and all(torch.equal(got[k], want[k]) for k in want)
                   and len(got_m) == len(want_m)
                   and all(torch.equal(a, b)
                           for a, b in zip(got_m, want_m))
                   and full_digest(torch, fresh) == saved)
        b_s = time.monotonic() - t_b
        del fresh
    finally:
        _leave_group(torch)
    diffs = [float((run["params"][k] - bare["params"][k]).abs().max()
                   / bare["params"][k].abs().max().clamp(min=1e-30))
             for k in bare["params"]]
    loss_diff = max(abs(a - b) / abs(b)
                    for a, b in zip(run["losses"], bare["losses"]))
    a_bit = (run["losses"] == bare["losses"]
             and all(torch.equal(run["params"][k], bare["params"][k])
                     for k in bare["params"]))
    del run["params"], bare["params"]
    torch.cuda.empty_cache()

    # (c) two ranks on the card at fsdp 2, through the port's control plane
    cp = _ControlPlane(os.path.join(work, "job"), "chip-smoke-fsdp", False)
    script = [os.path.abspath(__file__), "--fsdp-launched", cp.out, fsdp1_dir]
    t_c = time.monotonic()
    try:
        pods = [cp.pod(script, nodes="2:2") for _ in range(2)]
        rcs = [p.wait(timeout=ELASTIC_WAIT_S) for p in pods]
        recs = sorted(cp.records(), key=lambda r: r["rank"])
        versions = cp.versions()
        check(rcs == [0, 0] and len(recs) == 2 and versions,
              "fsdp (c): launchers %s, %d records, versions %s"
              % (rcs, len(recs), versions))
    except BaseException:
        for name in sorted(os.listdir(cp.logs)):
            sys.stderr.write("--- %s\n%s" % (
                name, _tail(os.path.join(cp.logs, name))))
        raise
    finally:
        cp.close()
    c_s = time.monotonic() - t_c
    # the fsdp-2 version restored at fsdp 1 on the card, and the world-1
    # losses of the same global batches
    _one_rank_nccl(torch)
    try:
        one = _fsdp_state(torch, True)
        with CheckpointManager(cp.ckpt) as mngr:
            one, status = mngr.restore(one)
        restored_2to1 = status is not None and \
            full_digest(torch, one) == recs[0]["saved"]
        del one
        torch.cuda.empty_cache()
    finally:
        _leave_group(torch)
    ref = _fsdp_state(torch, False)
    step = make_train_step(cross_entropy_loss, {"train": True})
    ref_losses = []
    for x, y in _fsdp_batches(torch, FSDP_JOB_STEPS, FSDP_JOB_BATCH):
        ref, m = step(ref, (x.cuda(), y.cuda()))
        ref_losses.append(float(m["loss"]))
    del ref
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    job_err = [abs(a - b) / abs(b) for r in recs
               for a, b in zip(r["steps"], ref_losses)]
    half = [(r["bytes"]["params"] + r["bytes"]["momentum"])
            / (a_bytes["params"] + a_bytes["momentum"]) for r in recs]
    out = {
        "phase": "fsdp", "model": "ResNet50_vd", "card": smi,
        "a": {"batch": FSDP_BATCH, "steps": FSDP_CHECK_STEPS,
              "backend": "nccl", "world_size": 1,
              "losses": run["losses"], "losses_unsharded": bare["losses"],
              "bit_for_bit": a_bit, "max_param_rel_diff": max(diffs),
              "max_loss_rel_diff": loss_diff, "tol": TOL_FSDP_STEP,
              "step_ms": run["step_ms"], "img_per_s": run["img_per_s"],
              "step_ms_unsharded": bare["step_ms"],
              "img_per_s_unsharded": bare["img_per_s"],
              "peak_memory_bytes": run["peak_memory_bytes"],
              "peak_memory_bytes_unsharded": bare["peak_memory_bytes"],
              "host_enqueue_ms": run["host_enqueue_ms"],
              "device_ms": run["device_ms"],
              "host_enqueue_ms_unsharded": bare["host_enqueue_ms"],
              "device_ms_unsharded": bare["device_ms"],
              "kernels_per_step": run["kernels_per_step"],
              "kernels_per_step_unsharded": bare["kernels_per_step"],
              "bytes": a_bytes, "bytes_unsharded": bare_bytes},
        "b": {"restored_bit_for_bit": b_equal, "seconds": b_s},
        "c": {"world": [r["world"] for r in recs],
              "mesh": recs[0]["mesh"], "backend": "gloo",
              "global_batch": FSDP_JOB_BATCH, "steps": FSDP_JOB_STEPS,
              "losses": [r["steps"] for r in recs],
              "losses_world1": ref_losses, "loss_rel_err": job_err,
              "tol": TOL_FSDP_JOB,
              "bytes_per_rank": [r["bytes"] for r in recs],
              "plan_state_bytes": [r["plan_state_bytes"] for r in recs],
              "state_share_of_fsdp1": half,
              "version": versions[-1],
              "fsdp2_to_fsdp1_bit_for_bit": restored_2to1,
              "fsdp1_to_fsdp2_bit_for_bit":
                  recs[0]["fsdp1_restored"] == saved,
              "seconds": c_s},
        "seconds": time.monotonic() - t0,
    }
    emit(out)
    check(a_bit or (max(diffs) <= TOL_FSDP_STEP
                    and loss_diff <= TOL_FSDP_STEP),
          "fsdp (a): sharded vs unsharded params %.3g, losses %.3g"
          % (max(diffs), loss_diff))
    check(b_equal, "fsdp (b): the sharded round trip is not bit for bit")
    check(max(job_err) <= TOL_FSDP_JOB,
          "fsdp (c): losses against world 1 %s" % job_err)
    check(all(0.45 <= h <= 0.55 for h in half),
          "fsdp (c): a rank's state is %s of fsdp 1's" % half)
    check(out["c"]["fsdp2_to_fsdp1_bit_for_bit"]
          and out["c"]["fsdp1_to_fsdp2_bit_for_bit"],
          "fsdp (c): resharded restores 2->1 %s, 1->2 %s" % (
              restored_2to1, out["c"]["fsdp1_to_fsdp2_bit_for_bit"]))
    return out


def _log_has(path: str, pattern: str):
    """The first match of ``pattern`` in the file at ``path``, or None."""
    try:
        with open(path, errors="replace") as fh:
            return re.search(pattern, fh.read())
    except FileNotFoundError:
        return None


def _summary(path: str, tag: str) -> dict:
    found = _log_has(path, r"%s summary (\{.*\})" % tag)
    check(found is not None, "%s printed no summary:\n%s" % (tag, _tail(path)))
    return json.loads(found.group(1))


def _distill_images(small: bool, batches: int):
    """The student's stream (``distill_student.sample_generator`` from
    ``RandomState(0)``, rank 0): (images of the first batch, every batch's
    labels [batches, DISTILL_BATCH])."""
    import numpy as np

    from edl_tpu_torch.examples.distill_student import sample_generator

    size, classes = (32, 10) if small else (224, 1000)
    gen = sample_generator(np.random.RandomState(0),
                           DISTILL_BATCH * batches, size, classes)()
    images, labels = [], []
    for i, (image, label) in enumerate(gen):
        if i < DISTILL_BATCH:
            images.append(image)
        labels.append(label)
    return (np.stack(images),
            np.asarray(labels, np.int32).reshape(batches, DISTILL_BATCH))


def _distill_step_ms(torch, device: str, small: bool, images, labels,
                     soft) -> float:
    """The student's train step alone (``distill_student``'s loss, SGD
    0.01 momentum 0.9, train mode) on one resident batch: ms a step over
    10 steps after 3, host clock ending in a synchronise."""
    from edl_tpu_torch.examples.distill_student import distill_loss
    from edl_tpu_torch.examples.distill_teacher import build_model
    from edl_tpu_torch.train import create_state, make_train_step, sgd

    model, _ = build_model(small, device)
    state = create_state(model, None, sgd(0.01, momentum=0.9), device=device)
    step = make_train_step(distill_loss, {"train": True})
    batch = (torch.from_numpy(images).to(device),
             (torch.from_numpy(labels).to(device),
              torch.from_numpy(soft).to(device)))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for i in range(13):
        if i == 3:
            sync()
            t0 = time.perf_counter()
        state, _ = step(state, batch)
    sync()
    return 1e3 * (time.perf_counter() - t0) / 10


def _distill_image_job(torch, cp, work: str, device: str, small: bool) -> dict:
    """Part (a): teachers A and B, the student, A's wedge and SIGKILL, the
    replacement C, B's drain on its pod's preemption notice."""
    import numpy as np

    from edl_tpu_torch.cluster.contract import PREEMPT_SERVICE
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.distill.discovery import (
        ASSIGN_SERVICE,
        DRAINING,
        TEACHER_SERVICE,
    )
    from edl_tpu_torch.distill.serving import PredictClient
    from edl_tpu_torch.examples.distill_teacher import build_model
    from edl_tpu_torch.store.client import StoreClient

    logs = cp.logs
    size_flag = ["--small"] if small else []
    teacher = [sys.executable, "-m", "edl_tpu_torch.examples.distill_teacher",
               "--store", cp.endpoint, "--job_id", DISTILL_JOB,
               "--device", device, *size_flag]
    chaos_log = os.path.join(work, "chaos.log")
    wedge = {"seed": 0, "rules": [
        {"point": "distill.serving.predict", "proc": "teacher",
         "action": "delay", "delay_s": 600.0, "after": DISTILL_WEDGE_AT,
         "match": {"method": "predict"}}]}
    hold = {"seed": 0, "rules": [
        {"point": "distill.reader.epoch", "proc": "student",
         "action": "delay", "delay_s": DISTILL_HOLD_S, "after": 2}]}
    log = {n: os.path.join(logs, "distill_%s.log" % n)
           for n in ("disc", "a", "b", "c", "student")}
    cp._spawn([sys.executable, "-m", "edl_tpu_torch.distill.discovery_server",
               "--store", cp.endpoint, "--job_id", DISTILL_JOB], log["disc"])
    procs = {
        "a": cp._spawn(teacher, log["a"], env=dict(
            cp.env, EDL_CHAOS=json.dumps(wedge), EDL_CHAOS_LOG=chaos_log)),
        "b": cp._spawn(teacher, log["b"], env=dict(cp.env, EDL_POD_ID="pod-b")),
    }
    ep = {}

    def serving(name):
        found = _log_has(log[name], r"teacher serving on (\S+)")
        if found:
            ep[name] = found.group(1)
        return name in ep

    client = StoreClient(cp.endpoint, timeout=10.0)
    reg = Registry(client, DISTILL_JOB)
    # the balancer's view, from the store's watches: (time, registrations)
    # and (time, every client's assignment)
    teachers_seen, assigns_seen = [], []
    tw = reg.watch_service(TEACHER_SERVICE % "teacher", on_change=lambda s: (
        teachers_seen.append((time.time(), {n: m.value for n, m in s.items()}))))
    aw = reg.watch_service(ASSIGN_SERVICE % "teacher", on_change=lambda s: (
        assigns_seen.append((time.time(), {
            n: json.loads(m.value)["servers"] for n, m in s.items()}))))
    rec_path = os.path.join(work, "student.npz")
    # the student's own synthetic stream, alone: its host cost per batch
    t_stream = time.perf_counter()
    images, labels = _distill_images(small, DISTILL_EPOCHS * DISTILL_BATCHES)
    stream_ms = 1e3 * (time.perf_counter() - t_stream) / len(labels)
    feeds = {"image": images, "label": labels[0].astype(np.int64)}
    warm = {}

    def warm_up(name):
        """One request at the student's batch: its time (ms)."""
        pc = PredictClient(ep[name], timeout=120.0)
        try:
            t = time.perf_counter()
            pc.predict(feeds)
            warm[name] = 1e3 * (time.perf_counter() - t)
        finally:
            pc.close()

    out = {}
    try:
        _wait(lambda: serving("a") and serving("b") and len(
            reg.get_service(TEACHER_SERVICE % "teacher")) == 2,
            "teachers A and B to register", procs.values())
        warm_up("a")
        warm_up("b")
        t0 = time.time()
        student = cp._spawn(
            [sys.executable, "-m", "edl_tpu_torch.examples.distill_student",
             "--store", cp.endpoint, "--job_id", DISTILL_JOB,
             "--device", device, "--batch", str(DISTILL_BATCH),
             "--epochs", str(DISTILL_EPOCHS), "--record", rec_path,
             *size_flag],
            log["student"], env=dict(cp.env, EDL_CHAOS=json.dumps(hold)))
        t_wedge = t_kill = t_notice = None
        deadline = time.monotonic() + DISTILL_WAIT_S
        while student.poll() is None:
            check(time.monotonic() < deadline,
                  "distill: the student did not finish:\n%s"
                  % _tail(log["student"]))
            if t_wedge is None and os.path.exists(chaos_log):
                t_wedge = time.time()
            if t_kill is None and t_wedge is not None and (
                    time.time() - t_wedge >= DISTILL_KILL_AFTER_S):
                # A dies mid-request and stays registered (its lease runs)
                os.killpg(procs["a"].pid, 9)
                t_kill = time.time()
                procs["c"] = cp._spawn(teacher, log["c"])
            if "c" in procs and "c" not in warm and serving("c"):
                warm_up("c")
            if t_notice is None and _log_has(log["student"], r"epoch 0 "):
                reg.set_permanent(PREEMPT_SERVICE, "pod-b", json.dumps({
                    "deadline": time.time() + 60.0, "budget": 60.0,
                    "ts": time.time()}).encode())
                t_notice = time.time()
            time.sleep(0.02)
        out["student_rc"] = student.returncode
        check(student.returncode == 0, "distill: student exited %s:\n%s"
              % (student.returncode, _tail(log["student"])))
        check(t_kill is not None and t_notice is not None,
              "distill: kill at %s, notice at %s" % (t_kill, t_notice))
        summary = _summary(log["student"], "student")
        rec = np.load(rec_path)
        # a teacher's time per request: C (the fleet's replacement), called
        # directly with the first batch
        _wait(lambda: serving("c"), "teacher C to serve", [procs["c"]])
        pc = PredictClient(ep["c"], timeout=60.0)
        try:
            lat = []
            for _ in range(DISTILL_LATENCY_REQUESTS + 1):
                t = time.perf_counter()
                pc.predict(feeds)
                lat.append(1e3 * (time.perf_counter() - t))
        finally:
            pc.close()
    except BaseException:
        for name in sorted(log):
            sys.stderr.write("--- %s\n%s" % (name, _tail(log[name])))
        raise
    finally:
        tw.cancel()
        aw.cancel()
        client.close()
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
    # B's drain: the mark (its registration flips to draining), then the
    # first assignment view with B in no client's list
    b = ep["b"]
    t_mark = next((t for t, regs in teachers_seen
                   if regs.get(b) == DRAINING), None)
    check(t_mark is not None, "distill: B was never marked draining")
    b_before = any(b in servers for t, views in assigns_seen if t < t_mark
                   for servers in views.values())
    t_out = next((t for t, views in assigns_seen if t >= t_mark
                  and not any(b in s for s in views.values())), None)
    check(b_before, "distill: B was in no assignment before its drain")
    check(t_out is not None, "distill: B stayed assigned after its drain")
    ts = rec["ts"]
    served_after_kill = [t for t in ts if t > t_kill]
    # the served soft labels against this process's forward of the same
    # seeded teacher on the same images
    model, _ = build_model(small, device)
    model.eval()
    with torch.inference_mode():
        want = torch.softmax(model(torch.from_numpy(images).to(device),
                                   train=False).float(), dim=-1).cpu().numpy()
    del model
    soft_err = float(np.abs(rec["soft0"] - want).max() / want.max())
    step_ms = _distill_step_ms(torch, device, small, images, labels[0], want)
    lat = sorted(lat[1:])
    out.update({
        "batches_per_epoch": summary["batches_per_epoch"],
        "in_order_exactly_once": bool(
            rec["labels"].shape == labels.shape
            and (rec["labels"] == labels).all()),
        # the student had begun its first epoch, which could not end
        # before the wedged batch was served elsewhere
        "kill_in_epoch_1": bool(
            rec["epoch_t0"][0] < t_kill < ts[DISTILL_BATCHES - 1]),
        "batches_before_kill": int((ts < t_kill).sum()),
        "kill_to_next_batch_s": (served_after_kill[0] - t_kill
                                 if served_after_kill else None),
        "notice_to_mark_s": t_mark - t_notice,
        "mark_to_unassigned_s": t_out - t_mark,
        "drain_grace_s": DRAIN_GRACE_S,
        "soft_label_max_err": soft_err, "tol_soft": TOL_DISTILL_SOFT,
        "student_img_per_s": summary["img_per_s"],
        "student_img_per_s_by_epoch": summary["img_per_s_by_epoch"],
        "reader_wait_ms_per_batch": summary["reader_wait_ms_per_batch"],
        "stream_ms_per_batch": stream_ms,
        "student_step_ms": step_ms,
        "reader_wait_ms_per_batch_by_epoch":
            summary["reader_wait_ms_per_batch_by_epoch"],
        "warm_up_ms": warm,
        "student_predict_ms_mean": summary["teacher_predict_ms"],
        "student_predicts": summary["predicts"],
        "teacher_request_ms_median": lat[len(lat) // 2],
        "teacher_request_ms_min": lat[0],
        "job_s": time.time() - t0,
    })
    return out


def _distill_nlp_job(cp, device: str) -> dict:
    """Part (b): distill_nlp's teacher (K1 at head width 32) and student
    (K1-K3 at head width 16) at the example's sizes."""
    logs = cp.logs
    base = [sys.executable, "-m", "edl_tpu_torch.examples.distill_nlp",
            "--store", cp.endpoint, "--job_id", NLP_JOB, "--device", device,
            "--epochs", str(NLP_EPOCHS), "--batches", str(NLP_BATCHES)]
    log = {n: os.path.join(logs, "nlp_%s.log" % n)
           for n in ("disc", "teacher", "student")}
    cp._spawn([sys.executable, "-m", "edl_tpu_torch.distill.discovery_server",
               "--store", cp.endpoint, "--job_id", NLP_JOB,
               "--services", "nlp-teacher"], log["disc"])
    teacher = cp._spawn(base + ["--role", "teacher"], log["teacher"])
    t0 = time.time()
    try:
        _wait(lambda: _log_has(log["teacher"], r"registered under"),
              "the nlp teacher to register", [teacher])
        student = cp._spawn(base + ["--role", "student"], log["student"])
        rc = student.wait(timeout=DISTILL_WAIT_S)
        check(rc == 0, "distill nlp: student exited %s:\n%s"
              % (rc, _tail(log["student"])))
        teacher.terminate()
        check(teacher.wait(timeout=60) == 0, "distill nlp: teacher exit %s"
              % teacher.returncode)
        st = _summary(log["student"], "student")
        tc = _summary(log["teacher"], "teacher")
    except BaseException:
        for name in sorted(log):
            sys.stderr.write("--- %s\n%s" % (name, _tail(log[name])))
        raise
    return {"student": st, "teacher": tc, "job_s": time.time() - t0}


def phase_distill(torch, smi: str, device: str = "cuda",
                  small: bool = False) -> dict:
    """Elastic distillation on the card, through the entry points a user
    runs: the port's store server, ``distill.discovery_server``,
    ``examples.distill_teacher`` / ``distill_student`` (ResNet50_vd at
    224x224 on both sides) and ``examples.distill_nlp``, each a process.
    (a) every epoch's 8 batches exactly once and in order through a
    teacher's death mid-epoch and its replacement, and another teacher's
    drain on its pod's notice; (b) the nlp pair's kernel launches."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="edl-distill-")
    t0 = time.monotonic()
    cp = _ControlPlane(work, DISTILL_JOB, False)
    try:
        image = _distill_image_job(torch, cp, work, device, small)
        nlp = _distill_nlp_job(cp, device)
    finally:
        cp.close()
        shutil.rmtree(work, ignore_errors=True)
    steps = NLP_EPOCHS * NLP_BATCHES
    want_student = {k: NLP_STUDENT_LAYERS * steps
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # one forward a served request: retries re-send a batch
    want_teacher = {"flash_fwd": NLP_TEACHER_LAYERS
                    * nlp["teacher"]["requests"],
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    st = nlp["student"]
    res = {"phase": "distill", "device": device, "card": smi,
           "image": image,
           "nlp": {"batches_per_epoch": st["batches_per_epoch"],
                   "first_kd_loss": st["first_kd_loss"],
                   "last_kd_loss": st["last_kd_loss"],
                   "student_launches": st["launches"],
                   "student_launches_want": want_student,
                   "student_requeues": st["requeues"],
                   "teacher_requests": nlp["teacher"]["requests"],
                   "teacher_launches": nlp["teacher"]["launches"],
                   "teacher_launches_want": want_teacher,
                   "job_s": nlp["job_s"]},
           "seconds": time.monotonic() - t0}
    emit(res)
    want_batches = [DISTILL_BATCHES] * DISTILL_EPOCHS
    check(image["batches_per_epoch"] == want_batches,
          "distill (a): batches per epoch %s" % image["batches_per_epoch"])
    check(image["in_order_exactly_once"],
          "distill (a): the batches' labels are not the stream's, in order")
    check(image["kill_in_epoch_1"],
          "distill (a): teacher A died outside the first epoch")
    check(image["mark_to_unassigned_s"] <= DRAIN_GRACE_S,
          "distill (a): B left the assignments %.3f s after its drain mark"
          % image["mark_to_unassigned_s"])
    check(image["soft_label_max_err"] <= TOL_DISTILL_SOFT,
          "distill (a): served soft labels off by %.3g"
          % image["soft_label_max_err"])
    check(st["batches_per_epoch"] == [NLP_BATCHES] * NLP_EPOCHS,
          "distill (b): batches per epoch %s" % st["batches_per_epoch"])
    check(math.isfinite(st["first_kd_loss"]) and math.isfinite(
        st["last_kd_loss"]) and st["last_kd_loss"] < st["first_kd_loss"],
        "distill (b): kd-loss %s -> %s" % (st["first_kd_loss"],
                                           st["last_kd_loss"]))
    if device == "cuda":
        check(st["launches"] == want_student,
              "distill (b): student launches %s, want %s"
              % (st["launches"], want_student))
        check(nlp["teacher"]["launches"] == want_teacher,
              "distill (b): teacher launches %s, want %s"
              % (nlp["teacher"]["launches"], want_teacher))
    return res


# phase lm_parallel: the LM's tensor and sequence parallelism and its
# decoding. (a) decode_bench at its GPU sizes, and the bf16 model's cached
# logits against its own full forward (flash, K1) over the growing
# sequence: both round k/v and the attention output to bf16 at different
# points, as flash vs plain does in phase model (TOL_LOGITS_*); a greedy
# token must be the full forward's argmax wherever its top-2 margin
# exceeds TOL_LOGITS_MAX.
DECODE_ITERS = 3
DECODE_CHECK = {"batch": 2, "kv": 4}
LM_GENERATE_STEPS = 60
LM_GENERATE_LAYERS = 2
# (c) lm_long_context at its defaults (tp 2 x sp 2: four ranks on the card
# over gloo) against world 1 (tp = sp = 1): the loss, a mean over 16,384
# positions of fp32 cross entropy from logits whose inputs were rounded to
# bf16 at different points (the ring merges partial outputs in fp32, tp
# sums partial products), agrees step by step within 5e-3 relative (about
# one bf16 ulp, 2^-8, and below a step's fall)
LC_STEPS = 6
LC_LAYERS = 4
LC_PROFILE_STEP = LC_STEPS - 1  # its launches count like the others'
TOL_LC_LOSS = 5e-3
# (d) Ulysses at sp 2 against one rank's flash on the whole sequence:
# (B, H, T, D) bf16, kv heads 2 (all-to-all) and 1 (gather and slice); the
# same kernels on the same rows, within the kernels' bf16 tolerance
ULYSSES_SHAPE = (2, 8, 4096, 64)
ULYSSES_KV = (2, 1)
# (e) GQA under tp 2 with decode at decode_bench's width (d_model 1024, 16
# heads, one kv head: the replicate fallback), 2 layers, fp32: one AdamW
# step (lr 1e-4) and the gathered parameters against world 1, then
# greedy_generate's tokens exactly. The two differ in summation order only
# (the partial k/v gradients summed over tp): the loss within 1e-5
# relative; but Adam's first step moves each entry by lr·g/(|g| + eps),
# so an entry whose gradient is within a few eps of zero moves by a
# rounding-dependent share of lr: each update within 1e-2 relative L2 and
# every entry within lr (a wrong head map or a missing tp sum flips the
# sign of most entries' updates: relative L2 of order 1)
TP_CFG = {"vocab_size": 32000, "d_model": 1024, "num_heads": 16,
          "num_layers": 2, "d_ff": 2688, "num_kv_heads": 1}
TP_BATCH = (2, 256)
TP_PROMPT = (2, 16)
TP_NEW = 8
TP_LR = 1e-4
TOL_TP_LOSS = 1e-5
TOL_TP_UPDATE = 1e-2
LM_WORKER_TIMEOUT_S = 480


def _decode_check(torch, cfg) -> dict:
    """(a)'s check: prefill and every cached step's logits against the
    same model's full forward over the final sequence (causal, so each
    position's logits are the growing sequence's)."""
    from edl_tpu_torch.models.decode import decode_model, init_cache
    from edl_tpu_torch.tools import decode_bench

    b, plen, new = DECODE_CHECK["batch"], cfg["prompt"], cfg["new_tokens"]
    model = decode_bench.build_model(cfg, DECODE_CHECK["kv"], "cuda", seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    prompt = torch.randint(0, cfg["vocab"], (b, plen), device="cuda",
                           generator=gen)
    with torch.no_grad():
        dm = decode_model(model, plen + new)
        pos = torch.arange(plen, device="cuda").expand(b, plen)
        pre, cache = dm(prompt, pos, init_cache(model, b, plen + new))
        steps, toks = [], [pre[:, -1].argmax(-1)]
        for i in range(new - 1):
            at = torch.full((b, 1), plen + i, device="cuda")
            logits, cache = dm(toks[-1][:, None], at, cache)
            steps.append(logits[:, 0])
            toks.append(logits[:, 0].argmax(-1))
        seq = torch.cat([prompt] + [t[:, None] for t in toks[:-1]], dim=1)
        full = model(seq)
        torch.cuda.synchronize()
        got = torch.cat([pre, torch.stack(steps, dim=1)], dim=1)
        diff = (got - full).abs()
        top2 = full[:, plen - 1:].topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        want_tok = full[:, plen - 1:].argmax(-1)
        got_tok = torch.stack(toks, dim=1)
        decided = margin > TOL_LOGITS_MAX
        mismatched = int(((got_tok != want_tok) & decided).sum())
    return {"batch": b, "prompt": plen, "new_tokens": new,
            "num_kv_heads": DECODE_CHECK["kv"],
            "logits_max_abs_err": diff.max().item(),
            "logits_mean_abs_err": diff.mean().item(),
            "prefill_max_abs_err": diff[:, :plen].max().item(),
            "step_max_abs_err": diff[:, plen:].max().item(),
            "tol_max": TOL_LOGITS_MAX, "tol_mean": TOL_LOGITS_MEAN,
            "decided_tokens": int(decided.sum()),
            "tokens": int(got_tok.numel()),
            "mismatched_decided_tokens": mismatched}


def _lc_args(steps: int, record: str) -> list:
    return [os.path.join(HERE, "edl_tpu_torch", "examples",
                         "lm_long_context.py"),
            "--steps", str(steps), "--num_layers", str(LC_LAYERS),
            "--record", record, "--profile_step", str(LC_PROFILE_STEP)]


def _long_context(torch) -> dict:
    """(c): the example at tp 2 x sp 2 through the port's store and
    launcher (one pod of four ranks on the card, gloo), and the same
    seeded run at world 1 as a plain process."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="edl-lc-")
    try:
        ref_out = os.path.join(work, "world1.json")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("EDL_")}
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        t0 = time.monotonic()
        proc = subprocess.run([sys.executable] + _lc_args(LC_STEPS, ref_out),
                              capture_output=True, text=True, env=env,
                              cwd=HERE, timeout=LM_WORKER_TIMEOUT_S)
        world1_s = time.monotonic() - t0
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise AssertionError("lm_long_context at world 1 exited %d"
                                 % proc.returncode)
        with open(ref_out) as fh:
            ref = json.load(fh)[0]
        cp = _ControlPlane(work, "chip-smoke-lc", False,
                           EDL_COMPILE_CACHE_DIR="none")
        try:
            out = os.path.join(work, "tp2sp2.json")
            t0 = time.monotonic()
            pod = cp.pod(script=_lc_args(LC_STEPS, out), nodes="1:1",
                         args=("--nproc_per_node", "4"))
            rc = pod.wait(timeout=LM_WORKER_TIMEOUT_S)
            job_s = time.monotonic() - t0
            rank0_log = os.path.join(cp.logs, "workerlog.0")
            if rc != 0:
                sys.stderr.write(_tail(pod.log, 40))
                for r in range(4):
                    log = os.path.join(cp.logs, "workerlog.%d" % r)
                    if os.path.exists(log):
                        sys.stderr.write(_tail(log, 40))
                raise AssertionError("lm_long_context pod exited %d" % rc)
            with open(rank0_log, errors="replace") as fh:
                printed = [ln.strip() for ln in fh
                           if ln.startswith(("step ", "trained "))]
            with open(out) as fh:
                recs = json.load(fh)
        finally:
            cp.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"world1": ref, "ranks": recs, "printed": printed,
            "world1_s": world1_s, "job_s": job_s}


def _two_ranks(out_dir: str) -> list:
    """``chip_smoke.py --lm-launched OUT_DIR RANK PORT`` as two gloo
    ranks sharing the card (sessions of their own, killed in
    ``finally``); their records."""
    from edl_tpu_torch.utils.net import find_free_ports

    port = find_free_ports(1)[0]
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    logs = [os.path.join(out_dir, "lm.%d.log" % r) for r in range(2)]
    procs = []
    try:
        for r in range(2):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--lm-launched", out_dir, str(r), str(port)],
                    env=env, cwd=HERE, stdout=fh, stderr=subprocess.STDOUT,
                    start_new_session=True))
        for proc in procs:
            proc.wait(timeout=LM_WORKER_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait(timeout=30)
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            sys.stderr.write(_tail(log, 60))
            raise AssertionError("lm_parallel rank exited %d"
                                 % proc.returncode)
    recs = []
    for r in range(2):
        with open(os.path.join(out_dir, "lm.%d.json" % r)) as fh:
            recs.append(json.load(fh))
    return recs


def _ulysses_inputs(torch, kv: int):
    b, h, t, d = ULYSSES_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(50 + kv)
    mk = lambda heads: torch.randn(b, heads, t, d, device="cuda",
                                   generator=gen).to(torch.bfloat16)
    return mk(h), mk(kv), mk(kv), mk(h)


def _tp_model(torch, dtype):
    from edl_tpu_torch.models import TransformerLM

    model = TransformerLM(dtype=dtype, device="cuda", **TP_CFG)
    return model.init_weights(torch.Generator(device="cuda").manual_seed(7))


def _tp_data(torch):
    gen = torch.Generator(device="cuda").manual_seed(8)
    tok = torch.randint(0, TP_CFG["vocab_size"], TP_BATCH, device="cuda",
                        generator=gen)
    prompt = torch.randint(0, TP_CFG["vocab_size"], TP_PROMPT, device="cuda",
                           generator=gen)
    return tok, torch.roll(tok, -1, dims=1), prompt


def _tp_run(torch, mesh=None) -> dict:
    """(e)'s run: one AdamW step of the fp32 GQA model (sharded by the
    rules over ``mesh``'s tp when given), then greedy_generate; the
    parameters before and after, gathered."""
    from edl_tpu_torch.models import greedy_generate
    from edl_tpu_torch.parallel import (TRANSFORMER_TP_RULES, gather_params,
                                        shard_params_by_rules)
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import adamw, create_state, make_train_step

    model = _tp_model(torch, torch.float32)
    state = create_state(model, None, adamw(TP_LR), device="cuda")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    if mesh is not None:
        shard_params_by_rules(mesh, model, TRANSFORMER_TP_RULES)
    tok, labels, prompt = _tp_data(torch)
    step = make_train_step(lm_bench.lm_loss)
    torch.cuda.synchronize()
    _zero_counts()  # the tp_step path starts here
    state, metrics = step(state, (tok, labels))
    loss = float(metrics["loss"])
    launches = _launch_counts()
    tokens = greedy_generate(model, prompt, TP_NEW)
    after = (gather_params(mesh, model) if mesh is not None
             else {k: v.detach() for k, v in model.named_parameters()})
    return {"loss": loss, "launches": launches, "tokens": tokens,
            "before": before, "after": after}


def _ulysses_child(torch, out_dir: str, rank: int) -> dict:
    """(d) on this rank's sequence shard: o and the gradients saved for
    the phase to compare; the launches of the ulysses path."""
    from edl_tpu_torch.parallel import make_mesh, ulysses_attention_sharded

    mesh = make_mesh({"dp": 1, "sp": 2}, device="cuda")
    _zero_counts()  # the ulysses path starts here
    for kv in ULYSSES_KV:
        q, k, v, g = _ulysses_inputs(torch, kv)
        t = q.shape[2] // 2
        shard = [x[:, :, rank * t:(rank + 1) * t].clone()
                 for x in (q, k, v, g)]
        for x in shard[:3]:
            x.requires_grad_(True)
        o = ulysses_attention_sharded(*shard[:3], mesh, causal=True)
        o.backward(shard[3])
        torch.save({"o": o.detach().cpu(),
                    "dq": shard[0].grad.cpu(), "dk": shard[1].grad.cpu(),
                    "dv": shard[2].grad.cpu()},
                   os.path.join(out_dir, "ulysses.kv%d.%d.pt" % (kv, rank)))
    return _launch_counts()


def _tp_child(torch, rank: int) -> dict:
    """(e) at tp 2; on rank 0 also its world-1 reference, compared."""
    from edl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"dp": 1, "tp": 2}, device="cuda")
    run = _tp_run(torch, mesh)
    rec = {"loss": run["loss"], "launches": run["launches"],
           "tokens": run["tokens"].tolist()}
    if rank == 0:
        ref = _tp_run(torch, None)
        errs, upd = {}, {}
        for name, want in ref["after"].items():
            got = run["after"][name]
            b = ref["before"][name]
            errs[name] = (got - want).abs().max().item()
            norm = (want - b).norm().item()
            upd[name] = ((got - want).norm().item() / norm if norm
                         else float("inf"))
        rec.update(ref_loss=ref["loss"], ref_tokens=ref["tokens"].tolist(),
                   param_max_abs_err=max(errs.values()),
                   update_rel_l2=max(upd.values()),
                   worst_update=max(upd, key=upd.get))
    return rec


def lm_parallel_child(torch, out_dir: str, rank: int, port: int) -> None:
    """One of two gloo ranks of phase lm_parallel (``--lm-launched``), one
    process for five runs: (d) Ulysses on this rank's sequence shard,
    (e) at tp 2, phase moe's (c) at ep 2, phase pipeline's (a) at pp 2
    and phase ctr's (b) at mp 2, rank 0 also running the world-1
    references on the same card."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=2, rank=rank)
    rec = {"rank": rank, "pid": os.getpid(),
           "ulysses_launches": _ulysses_child(torch, out_dir, rank)}
    rec.update(_tp_child(torch, rank))
    torch.cuda.empty_cache()
    rec["moe_ep"] = _moe_ep_child(torch, rank)
    torch.cuda.empty_cache()
    rec["pipeline"] = _pp_child(torch, rank)
    torch.cuda.empty_cache()
    rec["ctr_mp"] = _ctr_mp_child(torch, rank)
    with open(os.path.join(out_dir, "lm.%d.json" % rank), "w") as fh:
        json.dump(rec, fh)
    dist.barrier()
    dist.destroy_process_group()


def phase_lm_parallel(torch, smi: str) -> dict:
    """The TransformerLM's tensor and sequence parallelism and its
    decoding on the card: (a) decode_bench and the cached logits, (b)
    lm_generate, (c) lm_long_context at tp 2 x sp 2, (d) Ulysses at sp 2,
    (e) GQA under tp 2 with decode. See the module docstring."""
    import shutil
    import tempfile

    from edl_tpu_torch.ops.attention import flash_attention
    from edl_tpu_torch.tools import decode_bench

    t0 = time.monotonic()
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    res = {"phase": "lm_parallel", "card": smi}

    # (a) decode at full width
    cfg = decode_bench.sizes(True)
    records = decode_bench.measure(cfg, "cuda", iters=DECODE_ITERS)
    for rec in records:
        emit(dict(rec, phase="lm_parallel_decode", card=smi))
    check(len(records) == 3 and all(
        math.isfinite(r["value"]) and r["value"] > 0 for r in records),
        "lm_parallel (a): decode records %s" % records)
    res["decode"] = [{k: r[k] for k in (
        "num_kv_heads", "value", "prefill_ms", "decode_ms_per_token",
        "iter_ms", "kv_cache_mb")} for r in records]
    dcheck = _decode_check(torch, cfg)
    res["decode_check"] = dcheck
    torch.cuda.empty_cache()

    # (b) lm_generate on the card
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t1 = time.monotonic()
    gen = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.examples.lm_generate"],
        capture_output=True, text=True, env=env, cwd=HERE,
        timeout=LM_WORKER_TIMEOUT_S)
    found = re.search(r"^launches (\{.*\})$", gen.stdout, re.M)
    res["lm_generate"] = {
        "rc": gen.returncode, "ok": "OK: generation continues" in gen.stdout,
        "launches": (json.loads(found.group(1).replace("'", '"'))
                     if found else None),
        "seconds": time.monotonic() - t1,
        "lines": [ln for ln in gen.stdout.splitlines()
                  if ln.startswith(("step", "generated"))]}
    if gen.returncode != 0:
        sys.stderr.write(gen.stdout[-3000:] + gen.stderr[-6000:])

    # (c) long context
    lc = _long_context(torch)
    per_rank_want = []
    for rec in lc["ranks"]:
        s = rec["coords"]["sp"]
        per_rank_want.append({k: LC_LAYERS * LC_STEPS * (s + 1)
                              for k in kernels})
    w1 = lc["world1"]

    def mean(xs):
        return sum(xs) / len(xs)

    # steady steps: not the first (cuBLAS, the groups) nor the profiled
    steady = slice(1, LC_PROFILE_STEP)
    r0 = lc["ranks"][0]
    res["long_context"] = {
        "mesh": r0["mesh"], "steps": LC_STEPS, "layers": LC_LAYERS,
        "losses": r0["losses"], "losses_world1": w1["losses"],
        "loss_rel_err": [abs(a - b) / abs(b) for a, b in
                         zip(r0["losses"], w1["losses"])],
        "tol": TOL_LC_LOSS,
        "ranks_agree": all(r["losses"] == r0["losses"] for r in lc["ranks"]),
        "launches": [r["launches"] for r in lc["ranks"]],
        "launches_want": per_rank_want,
        "launches_world1": w1["launches"],
        "step_ms": mean(r0["step_s"][steady]) * 1e3,
        "step_ms_world1": mean(w1["step_s"][steady]) * 1e3,
        "enqueue_ms": mean(r0["enqueue_s"][steady]) * 1e3,
        "enqueue_ms_world1": mean(w1["enqueue_s"][steady]) * 1e3,
        # one profiled step each: the card's kernel time in it
        "profiled": [r["profiled"] for r in lc["ranks"]],
        "profiled_world1": w1["profiled"],
        "transport_share": [mean([t / st for t, st in zip(
            r["transport_s"][steady], r["step_s"][steady])])
            for r in lc["ranks"]],
        "transport_ms": [mean(r["transport_s"][steady]) * 1e3
                         for r in lc["ranks"]],
        "tp_collective_share": [mean([t / st for t, st in zip(
            r["tp_collective_s"][steady], r["step_s"][steady])])
            for r in lc["ranks"]],
        "printed": lc["printed"], "job_s": lc["job_s"],
        "world1_s": lc["world1_s"]}

    # (d) Ulysses and (e) GQA under tp: one launch of two ranks (which
    # also runs phase moe's (c))
    work = tempfile.mkdtemp(prefix="edl-lmpar-")
    try:
        ranks = _two_ranks(work)
        errs = {}
        for kv in ULYSSES_KV:
            q, k, v, g = _ulysses_inputs(torch, kv)
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = flash_attention(*leaves, causal=True)
            o.backward(g)
            want = {"o": o.detach(), "dq": leaves[0].grad,
                    "dk": leaves[1].grad, "dv": leaves[2].grad}
            parts = [torch.load(os.path.join(work, "ulysses.kv%d.%d.pt"
                                             % (kv, r))) for r in range(2)]
            for name, w in want.items():
                got = torch.cat([p[name] for p in parts], dim=2).cuda()
                err = (got.float() - w.float()).abs().max().item()
                tol = (TOL_O["bfloat16"] if name == "o" else
                       TOL_GRAD["bfloat16"] * max(
                           1.0, w.float().abs().max().item()))
                errs["kv%d/%s" % (kv, name)] = {"err": err, "tol": tol}
            del q, k, v, g, leaves, o, want, parts
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["ulysses"] = {"shape": list(ULYSSES_SHAPE), "kv": list(ULYSSES_KV),
                      "errors": errs,
                      "launches": [r["ulysses_launches"] for r in ranks]}
    tp = ranks
    t0r = tp[0]
    res["tp"] = {"cfg": TP_CFG, "loss": t0r["loss"],
                 "ref_loss": t0r["ref_loss"],
                 "loss_rel_err": abs(t0r["loss"] - t0r["ref_loss"])
                 / abs(t0r["ref_loss"]),
                 "param_max_abs_err": t0r["param_max_abs_err"],
                 "update_rel_l2": t0r["update_rel_l2"],
                 "worst_update": t0r["worst_update"],
                 "tokens_equal": all(r["tokens"] == t0r["ref_tokens"]
                                     for r in tp),
                 "launches": [r["launches"] for r in tp]}
    res["seconds"] = time.monotonic() - t0
    emit(res)
    res["tp_ranks"] = tp  # phase moe's (c), read there

    check(dcheck["logits_max_abs_err"] <= TOL_LOGITS_MAX
          and dcheck["logits_mean_abs_err"] <= TOL_LOGITS_MEAN,
          "lm_parallel (a): cached logits off by %.3g (mean %.3g)"
          % (dcheck["logits_max_abs_err"], dcheck["logits_mean_abs_err"]))
    check(dcheck["mismatched_decided_tokens"] == 0,
          "lm_parallel (a): %d greedy tokens differ from the full forward's"
          % dcheck["mismatched_decided_tokens"])
    lg = res["lm_generate"]
    check(lg["rc"] == 0 and lg["ok"], "lm_parallel (b): lm_generate rc %d"
          % lg["rc"])
    want_gen = {k: LM_GENERATE_LAYERS * LM_GENERATE_STEPS for k in kernels}
    check(lg["launches"] == want_gen, "lm_parallel (b): launches %s, want %s"
          % (lg["launches"], want_gen))
    lcr = res["long_context"]
    check(lcr["mesh"] == {"dp": 1, "tp": 2, "sp": 2},
          "lm_parallel (c): mesh %s" % lcr["mesh"])
    check(lcr["ranks_agree"], "lm_parallel (c): the ranks' losses differ")
    check(all(math.isfinite(x) for x in lcr["losses"])
          and max(lcr["loss_rel_err"]) <= TOL_LC_LOSS,
          "lm_parallel (c): losses %s vs world 1 %s"
          % (lcr["losses"], lcr["losses_world1"]))
    check(lcr["launches"] == per_rank_want,
          "lm_parallel (c): launches %s, want %s"
          % (lcr["launches"], per_rank_want))
    check(lcr["launches_world1"] == {k: LC_LAYERS * LC_STEPS
                                     for k in kernels},
          "lm_parallel (c): world-1 launches %s" % lcr["launches_world1"])
    check(any(ln.startswith("step 5 loss") for ln in lcr["printed"])
          and any(ln.startswith("trained %d steps" % LC_STEPS)
                  for ln in lcr["printed"]),
          "lm_parallel (c): printed %s" % lcr["printed"])
    for name, e in errs.items():
        check(e["err"] <= e["tol"], "lm_parallel (d): %s error %.3g > %.3g"
              % (name, e["err"], e["tol"]))
    want_uly = {k: len(ULYSSES_KV) for k in kernels}
    check(all(r == want_uly for r in res["ulysses"]["launches"]),
          "lm_parallel (d): launches %s, want %s"
          % (res["ulysses"]["launches"], want_uly))
    tpr = res["tp"]
    check(tpr["loss_rel_err"] <= TOL_TP_LOSS
          and tpr["update_rel_l2"] <= TOL_TP_UPDATE
          and tpr["param_max_abs_err"] <= TP_LR,
          "lm_parallel (e): loss %.3g, update %.3g (%s), param %.3g"
          % (tpr["loss_rel_err"], tpr["update_rel_l2"], tpr["worst_update"],
             tpr["param_max_abs_err"]))
    check(tpr["tokens_equal"], "lm_parallel (e): tp 2 tokens differ")
    want_tp = {k: TP_CFG["num_layers"] for k in kernels}
    check(all(r["launches"] == want_tp for r in tp),
          "lm_parallel (e): launches %s, want %s"
          % (tpr["launches"], want_tp))
    return res


# phase moe. (a) the flagship LM with the JAX defaults' MoE (8 experts
# in every second block: six MoE blocks, about 430 M parameters), bf16,
# save_flash, 10 AdamW steps at [8, 2048] through
# make_train_step(aux_losses=True).
MOE_EXPERTS = 8
MOE_EVERY = 2
MOE_STEPS = TRAIN_STEPS
MOE_LR = 1e-3
# kernel-name markers of the MoE step's device-time classes, in order
MOE_CLASSES = (
    ("attention K1-K3", ("flash_",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "splitK")),
    ("dispatch", ("index", "scatter", "gather", "Gather", "TopK", "topk",
                  "sort", "Sort", "scan", "Scan")),
    ("optimizer", ("multi_tensor",)),
)
# (b) the card against the CPU from the same weights, fp32 (no TF32):
# SwitchMoE at the flagship's widths at top_k 1 and 2, and a 2-layer MoE
# LM's two AdamW steps. The two differ in summation order only: outputs
# within 1e-5 of max(1, max|ref|), losses within 1e-5 relative, the
# served routes equal
MOE_CARD_X = (2, 256)
MOE_CARD_LM = {"vocab_size": 1024, "d_model": 256, "num_heads": 4,
               "num_layers": 2, "d_ff": 512, "num_experts": MOE_EXPERTS,
               "moe_every": MOE_EVERY}
MOE_CARD_BATCH = (2, 128)
TOL_MOE_CARD = 1e-5
# (c) ep 2 (two gloo ranks on the card, in phase lm_parallel's tp launch):
# the MoE LM at the flagship's widths cut to 4 layers, fp32, 3 AdamW steps
# (lr 1e-4) on a batch of 2 x 2048 against world 1 on the same card:
# losses and aux losses within 1e-5 relative, the gathered parameters
# within 1e-3 and each update within phase lm_parallel (e)'s 1e-2 relative
# L2 (Adam normalises each gradient entry), each rank holding 4 of the 8
# experts
MOE_EP_CFG = {"vocab_size": 32000, "d_model": 1024, "num_heads": 16,
              "num_layers": 4, "d_ff": 2688, "num_experts": MOE_EXPERTS,
              "moe_every": MOE_EVERY}
MOE_EP_BATCH = (2, 2048)
MOE_EP_STEPS = 3
MOE_EP_LR = 1e-4
TOL_EP_LOSS = 1e-5
TOL_EP_PARAM = 1e-3


def _moe_ep_run(torch, mesh=None) -> dict:
    """(c)'s run: ``MOE_EP_STEPS`` AdamW steps of the fp32 MoE LM with
    the aux loss (its banks split over ``mesh``'s ep by ``MOE_EP_RULES``
    when given); the losses, aux losses and the parameters before and
    after, gathered."""
    from edl_tpu_torch.models import MOE_EP_RULES, TransformerLM
    from edl_tpu_torch.parallel import gather_params, shard_params_by_rules
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import adamw, create_state, make_train_step

    model = TransformerLM(dtype=torch.float32, device="cuda", **MOE_EP_CFG)
    model.init_weights(torch.Generator(device="cuda").manual_seed(11))
    state = create_state(model, None, adamw(MOE_EP_LR), device="cuda")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    if mesh is not None:
        shard_params_by_rules(mesh, model, MOE_EP_RULES)
    gen = torch.Generator(device="cuda").manual_seed(12)
    tok = torch.randint(0, MOE_EP_CFG["vocab_size"], MOE_EP_BATCH,
                        device="cuda", generator=gen)
    batch = (tok, torch.roll(tok, -1, dims=1))
    step = make_train_step(lm_bench.lm_loss, aux_losses=True)
    losses, aux = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MOE_EP_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux_loss"]))
    step_ms = (time.perf_counter() - t0) / MOE_EP_STEPS * 1e3
    banks = {n: list(p.shape) for n, p in model.named_parameters()
             if n.endswith((".moe.wi", ".moe.wo"))}
    after = (gather_params(mesh, model) if mesh is not None
             else {k: v.detach() for k, v in model.named_parameters()})
    return {"losses": losses, "aux": aux, "step_ms": step_ms,
            "banks": banks, "before": before, "after": after}


def _moe_ep_child(torch, rank: int) -> dict:
    """(c) in a rank of the tp launch: the ep 2 run, and on rank 0 the
    world-1 run on the same card, compared."""
    from edl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"dp": 1, "ep": 2}, device="cuda")
    run = _moe_ep_run(torch, mesh)
    rec = {"mesh": mesh.shape, "ep_rank": mesh.ep_rank,
           "losses": run["losses"], "aux": run["aux"],
           "step_ms": run["step_ms"], "banks": run["banks"]}
    if rank == 0:
        after = {k: v.cpu() for k, v in run.pop("after").items()}
        del run
        torch.cuda.empty_cache()
        ref = _moe_ep_run(torch, None)
        errs, upd = {}, {}
        for name, want in ref["after"].items():
            got = after[name].to(want.device)
            b = ref["before"][name]
            errs[name] = (got - want).abs().max().item()
            norm = (want - b).norm().item()
            upd[name] = ((got - want).norm().item() / norm if norm
                         else float("inf"))
        rec.update(ref_losses=ref["losses"], ref_aux=ref["aux"],
                   ref_step_ms=ref["step_ms"], ref_banks=ref["banks"],
                   param_max_abs_err=max(errs.values()),
                   update_rel_l2=max(upd.values()),
                   worst_update=max(upd, key=upd.get))
        del ref
        torch.cuda.empty_cache()
    return rec


def _moe_card_vs_cpu(torch) -> dict:
    """(b): SwitchMoE at top_k 1 and 2 and the small MoE LM's two fp32
    AdamW steps on the card and on the CPU from the same weights."""
    from edl_tpu_torch.models import SwitchMoE, TransformerLM
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import adamw, create_state, make_train_step

    import copy

    d, f = FLAGSHIP_TRAIN["d_model"], FLAGSHIP_TRAIN["d_ff"]
    out = {"switch": {}}
    gen = torch.Generator().manual_seed(21)
    x = torch.randn(*MOE_CARD_X, d, generator=gen)
    for k in (1, 2):
        runs = {}
        moe = SwitchMoE(d, MOE_EXPERTS, f, top_k=k, dtype=torch.float32,
                        device="cpu")
        moe.init_weights(torch.Generator().manual_seed(22))
        for dev in ("cuda", "cpu"):
            here = copy.deepcopy(moe).to(dev)
            with torch.no_grad():
                y, aux = here(x.to(dev), return_aux=True)
            runs[dev] = (y.cpu(), aux.item(), here.kept.cpu())
        (yc, ac, kc), (yh, ah, kh) = runs["cuda"], runs["cpu"]
        out["switch"]["top%d" % k] = {
            "max_abs_err": (yc - yh).abs().max().item(),
            "scale": max(1.0, yh.abs().max().item()),
            "aux_rel_err": abs(ac - ah) / abs(ah),
            "kept_equal": bool(torch.equal(kc, kh)),
            "dropped_share": 1.0 - kh.float().mean().item()}
    tok = torch.randint(0, MOE_CARD_LM["vocab_size"],
                        (MOE_CARD_BATCH[0], MOE_CARD_BATCH[1] + 1),
                        generator=torch.Generator().manual_seed(23))
    lm = {}
    seeded = TransformerLM(dtype=torch.float32, device="cpu", **MOE_CARD_LM)
    seeded.init_weights(torch.Generator().manual_seed(24))
    for dev in ("cuda", "cpu"):
        model = copy.deepcopy(seeded)
        state = create_state(model, None, adamw(MOE_LR), device=dev)
        step = make_train_step(lm_bench.lm_loss, aux_losses=True)
        batch = (tok[:, :-1].to(dev), tok[:, 1:].to(dev))
        rec = {"losses": [], "aux": [], "kept": []}
        for _ in range(2):
            state, m = step(state, batch)
            rec["losses"].append(float(m["loss"]))
            rec["aux"].append(float(m["aux_loss"]))
            rec["kept"].append([getattr(model, "layer_%d" % i).moe.kept.cpu()
                                for i in range(model.num_layers)
                                if hasattr(getattr(model, "layer_%d" % i),
                                           "moe")])
        lm[dev] = rec
    out["lm"] = {
        "losses": lm["cuda"]["losses"], "losses_cpu": lm["cpu"]["losses"],
        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
            lm["cuda"]["losses"], lm["cpu"]["losses"])),
        "aux": lm["cuda"]["aux"], "aux_cpu": lm["cpu"]["aux"],
        "aux_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
            lm["cuda"]["aux"], lm["cpu"]["aux"])),
        "kept_equal": all(torch.equal(a, b) for sa, sb in zip(
            lm["cuda"]["kept"], lm["cpu"]["kept"]) for a, b in zip(sa, sb))}
    return out


def _moe_block_parts(torch, model, x) -> dict:
    """One MoE block's forward by part at the step's shape (CUDA events,
    the stream held): routing, the whole expert path (dispatch, the two
    batched products, combine) and the two products alone on a buffer of
    the same shape; and the block's forward + backward."""
    moe = next(getattr(model, "layer_%d" % i).moe
               for i in range(model.num_layers)
               if hasattr(getattr(model, "layer_%d" % i), "moe"))
    with torch.no_grad():
        r = moe.route(x)
        e, b, cap = moe.wi.shape[0], x.shape[0], r.capacity
        buf = torch.randn(e, b * cap, x.shape[-1], device=x.device,
                          dtype=moe.dtype)
        wi, wo = moe.wi.to(moe.dtype), moe.wo.to(moe.dtype)
        parts = {
            "route_ms": time_ms(torch, lambda: moe.route(x)),
            "experts_ms": time_ms(torch, lambda: moe.experts_out(x, r)),
            "bmm_ms": time_ms(torch, lambda: torch.bmm(
                torch.nn.functional.gelu(torch.bmm(buf, wi),
                                         approximate="tanh"), wo)),
        }
    xg = x.detach().clone().requires_grad_(True)

    def fwd_bwd():
        out, aux = moe(xg, return_aux=True)
        (out.float().sum() + aux).backward()

    parts["forward_backward_ms"] = time_ms(torch, fwd_bwd)
    moe.zero_grad(set_to_none=True)
    parts["dispatch_combine_ms"] = parts["experts_ms"] - parts["bmm_ms"]
    parts["capacity"] = cap
    return parts


def phase_moe(torch, smi: str, lmp: dict) -> dict:
    """The Switch MoE FFN (see the module docstring): (a) the flagship MoE
    LM's ten training steps with the aux loss, (b) the card against the
    CPU, (c) ep 2 (run by phase lm_parallel's tp launch, read from
    ``lmp``)."""
    from edl_tpu_torch.models import TransformerLM
    from edl_tpu_torch.tools import lm_bench
    from edl_tpu_torch.train import adamw, create_state, make_train_step

    t0 = time.monotonic()
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    cfg = FLAGSHIP_TRAIN
    res = {"phase": "moe", "card": smi}

    # (a) the flagship MoE LM, bf16, save_flash
    model = TransformerLM(
        vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
        num_heads=cfg["num_heads"], num_layers=cfg["num_layers"],
        d_ff=cfg["d_ff"], remat=True, remat_policy=cfg["remat"],
        num_experts=MOE_EXPERTS, moe_every=MOE_EVERY, device="cuda")
    state = create_state(model, 0, adamw(MOE_LR), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg["vocab_size"],
                           (cfg["batch"], cfg["seq"] + 1), device="cuda",
                           generator=gen)
    batch = (tokens[:, :-1], tokens[:, 1:])
    step = make_train_step(lm_bench.lm_loss, aux_losses=True)
    moe_layers = [i for i in range(model.num_layers)
                  if hasattr(getattr(model, "layer_%d" % i), "moe")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()  # the moe path starts here
    losses, aux = [], []
    t1 = time.perf_counter()
    for i in range(MOE_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
        aux.append(m["aux_loss"])
        if i == 0:
            torch.cuda.synchronize()  # the first step builds cuBLAS plans
            t1 = time.perf_counter()
    losses = [float(v) for v in torch.stack(losses).tolist()]
    aux = [float(v) for v in torch.stack(aux).tolist()]
    step_ms = (time.perf_counter() - t1) / (MOE_STEPS - 1) * 1e3
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    dropped = {"layer_%d" % i: 1.0 - getattr(
        model, "layer_%d" % i).moe.kept.float().mean().item()
        for i in moe_layers}
    t1 = time.perf_counter()
    state, _ = step(state, batch)
    enqueue_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.synchronize()
    profile = _device_breakdown(torch, lambda: step(state, batch),
                                classes=MOE_CLASSES)
    params = sum(p.numel() for p in model.parameters())
    h = torch.randn(cfg["batch"], cfg["seq"], cfg["d_model"], device="cuda",
                    generator=gen).to(torch.bfloat16)
    parts = _moe_block_parts(torch, model, h)
    del state, model, h
    torch.cuda.empty_cache()
    res["train"] = {
        "tokens": [cfg["batch"], cfg["seq"]], "layers": cfg["num_layers"],
        "moe_layers": moe_layers, "num_experts": MOE_EXPERTS,
        "parameters": params, "losses": losses, "aux_loss": aux,
        "step_ms": step_ms, "host_enqueue_ms": enqueue_ms,
        "tokens_per_s": cfg["batch"] * cfg["seq"] / step_ms * 1e3,
        "device_ms": profile["device_ms"],
        "device_idle_share": profile["device_idle_share"],
        "device_ms_by_class": profile["by_class_ms"],
        "profile_top": profile["top"], "peak_memory_bytes": peak,
        "launches": launches,
        "launches_per_step": {k: v / MOE_STEPS for k, v in launches.items()},
        "dropped_share": dropped, "block_parts": parts}
    emit(dict(res["train"], phase="moe_train", card=smi))

    # (b) the card against the CPU
    saved_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res["card_vs_cpu"] = _moe_card_vs_cpu(torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved_tf32

    # (c) ep 2, from phase lm_parallel's tp launch
    ep = [r["moe_ep"] for r in lmp["tp_ranks"]]
    e0 = ep[0]
    res["ep"] = {
        "cfg": MOE_EP_CFG, "batch": list(MOE_EP_BATCH),
        "mesh": e0["mesh"], "losses": e0["losses"],
        "losses_world1": e0["ref_losses"],
        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
            e0["losses"], e0["ref_losses"])),
        "aux": e0["aux"], "aux_world1": e0["ref_aux"],
        "aux_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
            e0["aux"], e0["ref_aux"])),
        "ranks_agree": all(r["losses"] == e0["losses"]
                           and r["aux"] == e0["aux"] for r in ep),
        "param_max_abs_err": e0["param_max_abs_err"],
        "update_rel_l2": e0["update_rel_l2"],
        "worst_update": e0["worst_update"],
        "banks": [r["banks"] for r in ep], "banks_world1": e0["ref_banks"],
        "step_ms": [r["step_ms"] for r in ep],
        "step_ms_world1": e0["ref_step_ms"]}
    res["seconds"] = time.monotonic() - t0
    emit(res)

    tr = res["train"]
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "moe (a): losses %s" % losses)
    check(all(math.isfinite(v) and v > 0 for v in aux),
          "moe (a): aux losses %s" % aux)
    want = {k: cfg["num_layers"] * MOE_STEPS for k in kernels}
    check(tr["launches"] == want, "moe (a): launches %s, want %s"
          % (tr["launches"], want))
    check(len(moe_layers) == cfg["num_layers"] // MOE_EVERY,
          "moe (a): MoE blocks %s" % moe_layers)
    for k, sw in res["card_vs_cpu"]["switch"].items():
        check(sw["max_abs_err"] <= TOL_MOE_CARD * sw["scale"]
              and sw["aux_rel_err"] <= TOL_MOE_CARD and sw["kept_equal"],
              "moe (b): SwitchMoE %s card vs CPU %s" % (k, sw))
    lmr = res["card_vs_cpu"]["lm"]
    check(lmr["loss_rel_err"] <= TOL_MOE_CARD
          and lmr["aux_rel_err"] <= TOL_MOE_CARD and lmr["kept_equal"],
          "moe (b): the MoE LM card vs CPU %s" % lmr)
    epr = res["ep"]
    check(epr["ranks_agree"] and epr["loss_rel_err"] <= TOL_EP_LOSS
          and epr["aux_rel_err"] <= TOL_EP_LOSS,
          "moe (c): ep 2 losses %s aux %s vs world 1 %s %s"
          % (epr["losses"], epr["aux"], epr["losses_world1"],
             epr["aux_world1"]))
    check(epr["param_max_abs_err"] <= TOL_EP_PARAM
          and epr["update_rel_l2"] <= TOL_TP_UPDATE,
          "moe (c): parameters %.3g, update %.3g (%s)"
          % (epr["param_max_abs_err"], epr["update_rel_l2"],
             epr["worst_update"]))
    half = MOE_EXPERTS // 2
    check(all(shape[0] == half for banks in epr["banks"]
              for shape in banks.values())
          and all(shape[0] == MOE_EXPERTS
                  for shape in epr["banks_world1"].values()),
          "moe (c): banks %s" % epr["banks"])
    return res


# phase pipeline. (a) pp 2 at the flagship's full width: two gloo ranks
# sharing the card (the lm_parallel launch), hops staged through pinned
# host memory; GPipe and 1F1B at M 4 and 8.
PP_SCHEDULES = (("gpipe", 4), ("gpipe", 8), ("1f1b", 4), ("1f1b", 8))
PP_SEED, PP_DATA_SEED = 21, 22
PP_LR = 1e-4
PP_STEPS = 3
# fp32 compute: the stages' loss and gradients against the flat model's
# (relative L2 over the stage; K1-K3 run their fp32 width-64 bodies)
TOL_PP_FP32 = 1e-4
# bf16 compute: each step's loss against world 1's (the microbatches'
# products round at other shapes than the whole batch's)
TOL_PP_BF16 = 1e-3
# (b) four ranks: 1F1B at pp 2 x dp 2 and at pp 4, the flagship's widths
# cut to 4 layers (the script's time limit), fp32, against world 1
PP4_LAYERS = 4
PP4_RUNS = (({"pp": 2, "dp": 2}, 4, "dp"), ({"pp": 4}, 4, None))
PP_WORKER_TIMEOUT_S = 300


def _pp_cfg(layers=None) -> dict:
    cfg = FLAGSHIP_TRAIN
    return dict(vocab_size=cfg["vocab_size"], d_model=cfg["d_model"],
                num_heads=cfg["num_heads"],
                num_layers=layers or cfg["num_layers"], d_ff=cfg["d_ff"],
                remat=True, remat_policy=cfg["remat"])


def _pp_model(torch, dtype, layers=None):
    from edl_tpu_torch.models import TransformerLM

    model = TransformerLM(device="cuda", dtype=dtype, **_pp_cfg(layers))
    return model.init_weights(
        torch.Generator(device="cuda").manual_seed(PP_SEED))


def _pp_data(torch):
    gen = torch.Generator(device="cuda").manual_seed(PP_DATA_SEED)
    cfg = FLAGSHIP_TRAIN
    tok = torch.randint(0, cfg["vocab_size"], (cfg["batch"], cfg["seq"]),
                        device="cuda", generator=gen)
    return tok, torch.roll(tok, -1, dims=1)


def _pp_reference(torch, model, names, tok, tgt) -> dict:
    """The flat model's loss and the gradients of ``names`` (one stage's
    parameters) on the whole batch, fp32."""
    from edl_tpu_torch.tools import lm_bench

    for p in model.parameters():
        p.grad = None
    loss, _ = lm_bench.lm_loss(model(tok), tgt)
    loss.backward()
    grads = {n: p.grad.detach().clone()
             for n, p in model.named_parameters() if n in names}
    for p in model.parameters():
        p.grad = None
    return {"loss": float(loss), "grads": grads}


def _pp_run(torch, stage, mesh, schedule, m, tok, tgt, batch_axis=None):
    """One step's loss and gradients over ``stage`` by ``schedule``."""
    from edl_tpu_torch.parallel import (pipeline_lm_1f1b_grads,
                                        pipeline_lm_loss)

    stats = {}
    if schedule == "gpipe":
        loss = pipeline_lm_loss(stage, tok, tgt, mesh, m,
                                batch_axis=batch_axis, stats=stats)
    else:
        loss, _ = pipeline_lm_1f1b_grads(stage, tok, tgt, mesh, m,
                                         batch_axis=batch_axis, stats=stats)
    return float(loss), stats["live_max"]


def _rel_l2_parts(stage, ref) -> dict:
    """Sums of squares of the stage's gradients' errors and of the
    reference's (the phase adds the ranks' before the root)."""
    named = dict(stage.named_parameters())
    err = sum(float((p.grad - ref["grads"][n]).double().square().sum())
              for n, p in named.items())
    norm = sum(float(ref["grads"][n].double().square().sum())
               for n in named)
    return {"err_sq": err, "ref_sq": norm}


def _pp_child(torch, rank: int) -> dict:
    """Phase pipeline (a) in a rank of the lm_parallel launch: the fp32
    check of each schedule against the flat model (each rank computes its
    stage's reference itself), then ``PP_STEPS`` bf16 AdamW steps of each
    schedule, timed, with their hops, peak memory and launches; rank 0
    also the bf16 steps at world 1."""
    from edl_tpu_torch.parallel import collectives, lm_stage, make_mesh
    from edl_tpu_torch.train import adamw

    mesh = make_mesh({"pp": 2}, device="cuda")
    tok, tgt = _pp_data(torch)
    rec = {"mesh": mesh.shape, "pp_rank": mesh.pp_rank, "fp32": {},
           "bf16": {}}
    model = _pp_model(torch, torch.float32)
    stage = lm_stage(model, mesh)
    names = {n for n, _ in stage.named_parameters()}
    ref = _pp_reference(torch, model, names, tok, tgt)
    rec["ref_loss_fp32"] = ref["loss"]
    for schedule, m in PP_SCHEDULES:
        loss, live = _pp_run(torch, stage, mesh, schedule, m, tok, tgt)
        rec["fp32"]["%s-m%d" % (schedule, m)] = dict(
            loss=loss, live_max=live, **_rel_l2_parts(stage, ref))
    del model, stage, ref
    torch.cuda.empty_cache()

    model = _pp_model(torch, torch.bfloat16)
    stage = lm_stage(model, mesh)
    init = {n: p.detach().clone() for n, p in stage.named_parameters()}
    for schedule, m in PP_SCHEDULES:
        with torch.no_grad():
            for n, p in stage.named_parameters():
                p.copy_(init[n])
        tx = adamw(PP_LR)
        opt = tx.init(stage.parameters())
        losses, step_s, hop_s, hop_b = [], [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()  # the pipeline_<schedule> path starts here
        for _ in range(PP_STEPS):
            collectives.reset_transport()
            t0 = time.perf_counter()
            loss, live = _pp_run(torch, stage, mesh, schedule, m, tok, tgt)
            tx.update(opt)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            hop_s.append(collectives.PIPELINE["seconds"])
            hop_b.append(collectives.PIPELINE["bytes"])
        rec["bf16"]["%s-m%d" % (schedule, m)] = {
            "losses": losses, "step_s": step_s, "hop_s": hop_s,
            "hop_bytes": hop_b, "live_max": live,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": _launch_counts()}
    del model, stage, init
    torch.cuda.empty_cache()
    if rank == 0:
        from edl_tpu_torch.tools import lm_bench
        from edl_tpu_torch.train import create_state, make_train_step

        model = _pp_model(torch, torch.bfloat16)
        state = create_state(model, None, adamw(PP_LR), device="cuda")
        step = make_train_step(lm_bench.lm_loss)
        losses, step_s = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(PP_STEPS):
            t0 = time.perf_counter()
            state, metrics = step(state, (tok, tgt))
            losses.append(float(metrics["loss"]))
            step_s.append(time.perf_counter() - t0)
        rec["world1"] = {"losses": losses, "step_s": step_s,
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del model, state
        torch.cuda.empty_cache()
    return rec


def pp_launched(torch, out_dir: str, rank: int, port: int) -> None:
    """One of four gloo ranks of phase pipeline (b) (``--pp-launched``):
    1F1B at pp 2 x dp 2 and at pp 4 on the flagship cut to
    ``PP4_LAYERS`` layers, fp32, each rank's stage against the flat
    model's gradients it computes itself."""
    import torch.distributed as dist

    from edl_tpu_torch.parallel import lm_stage, make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:%d" % port,
                            world_size=4, rank=rank)
    tok, tgt = _pp_data(torch)
    model = _pp_model(torch, torch.float32, PP4_LAYERS)
    ref = _pp_reference(torch, model, {n for n, _ in model.named_parameters()},
                        tok, tgt)
    rec = {"rank": rank, "runs": []}
    for axes, m, batch_axis in PP4_RUNS:
        mesh = make_mesh(axes, device="cuda")
        stage = lm_stage(model, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, live = _pp_run(torch, stage, mesh, "1f1b", m, tok, tgt,
                             batch_axis)
        torch.cuda.synchronize()
        rec["runs"].append(dict(
            mesh=mesh.shape, coords=mesh.coords, loss=loss,
            ref_loss=ref["loss"], live_max=live,
            step_s=time.perf_counter() - t0,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            **_rel_l2_parts(stage, ref)))
        del stage
        for p in model.parameters():
            p.grad = None
    with open(os.path.join(out_dir, "pp4.%d.json" % rank), "w") as fh:
        json.dump(rec, fh)
    dist.barrier()
    dist.destroy_process_group()


def _four_ranks(out_dir: str) -> list:
    """``chip_smoke.py --pp-launched OUT_DIR RANK PORT`` as four gloo ranks
    sharing the card (sessions of their own, killed in ``finally``)."""
    from edl_tpu_torch.utils.net import find_free_ports

    port = find_free_ports(1)[0]
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    logs = [os.path.join(out_dir, "pp4.%d.log" % r) for r in range(4)]
    procs = []
    try:
        for r in range(4):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--pp-launched", out_dir, str(r), str(port)],
                    env=env, cwd=HERE, stdout=fh, stderr=subprocess.STDOUT,
                    start_new_session=True))
        for proc in procs:
            proc.wait(timeout=PP_WORKER_TIMEOUT_S)
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait(timeout=30)
    for proc, log in zip(procs, logs):
        if proc.returncode != 0:
            sys.stderr.write(_tail(log, 60))
            raise AssertionError("pipeline rank exited %d" % proc.returncode)
    recs = []
    for r in range(4):
        with open(os.path.join(out_dir, "pp4.%d.json" % r)) as fh:
            recs.append(json.load(fh))
    return recs


def phase_pipeline(torch, smi: str, lmp: dict) -> dict:
    """Pipeline parallelism on the card: (a) from phase lm_parallel's
    two-rank launch, (b) four ranks. See the module docstring."""
    import shutil
    import tempfile

    from edl_tpu_torch.parallel import pipeline_efficiency

    t0 = time.monotonic()
    kernels = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    res = {"phase": "pipeline", "card": smi, "cfg": _pp_cfg(),
           "batch": [FLAGSHIP_TRAIN["batch"], FLAGSHIP_TRAIN["seq"]]}
    ranks = [r["pipeline"] for r in lmp["tp_ranks"]]
    r0 = ranks[0]
    layers = FLAGSHIP_TRAIN["num_layers"] // 2
    fp32, bf16 = {}, {}
    for schedule, m in PP_SCHEDULES:
        key = "%s-m%d" % (schedule, m)
        parts = [r["fp32"][key] for r in ranks]
        fp32[key] = {
            "loss": parts[0]["loss"], "loss_world1": r0["ref_loss_fp32"],
            "loss_rel_err": abs(parts[0]["loss"] - r0["ref_loss_fp32"])
            / abs(r0["ref_loss_fp32"]),
            "ranks_agree": all(p["loss"] == parts[0]["loss"] for p in parts),
            "grad_rel_l2": math.sqrt(sum(p["err_sq"] for p in parts)
                                     / sum(p["ref_sq"] for p in parts)),
            "live_max": [p["live_max"] for p in parts]}
        runs = [r["bf16"][key] for r in ranks]
        w1 = r0["world1"]
        steady = slice(1, PP_STEPS)  # the first step warms cuBLAS

        def mean(xs):
            return sum(xs) / len(xs)

        step_s = mean(runs[0]["step_s"][steady])
        hop_s = [mean(r["hop_s"][steady]) for r in runs]
        per_step = {k: m * layers * (2 if schedule == "1f1b"
                                     and k == "flash_fwd" else 1)
                    for k in kernels}
        bf16[key] = {
            "losses": runs[0]["losses"], "losses_world1": w1["losses"],
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                                zip(runs[0]["losses"], w1["losses"])),
            "ranks_agree": all(r["losses"] == runs[0]["losses"]
                               for r in runs),
            "step_ms": step_s * 1e3,
            "step_ms_world1": mean(w1["step_s"][steady]) * 1e3,
            "hop_ms": [h * 1e3 for h in hop_s],
            "hop_mb": [r["hop_bytes"][-1] / 1e6 for r in runs],
            "hop_share": [h / step_s for h in hop_s],
            "bubble_ideal": 1.0 - pipeline_efficiency(m, 2),
            "peak_gb": [r["peak_gb"] for r in runs],
            "peak_gb_world1": w1["peak_gb"],
            "live_max": [r["live_max"] for r in runs],
            "launches": [r["launches"] for r in runs],
            "launches_want": {k: v * PP_STEPS for k, v in per_step.items()}}
    res["fp32"], res["bf16"] = fp32, bf16

    work = tempfile.mkdtemp(prefix="edl-pp4-")
    try:
        t1 = time.monotonic()
        four = _four_ranks(work)
        four_s = time.monotonic() - t1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["four"] = []
    for i, (axes, m, batch_axis) in enumerate(PP4_RUNS):
        runs = [r["runs"][i] for r in four]
        res["four"].append({
            "mesh": runs[0]["mesh"], "layers": PP4_LAYERS, "M": m,
            "batch_axis": batch_axis, "schedule": "1f1b",
            "loss": runs[0]["loss"], "loss_world1": runs[0]["ref_loss"],
            "loss_rel_err": abs(runs[0]["loss"] - runs[0]["ref_loss"])
            / abs(runs[0]["ref_loss"]),
            "ranks_agree": all(r["loss"] == runs[0]["loss"] for r in runs),
            # each dp replica of a stage computed the whole gradient:
            # count each stage once (dp index 0)
            "grad_rel_l2": math.sqrt(
                sum(r["err_sq"] for r in runs
                    if r["coords"].get("dp", 0) == 0)
                / sum(r["ref_sq"] for r in runs
                      if r["coords"].get("dp", 0) == 0)),
            "live_max": [r["live_max"] for r in runs],
            "step_ms": [r["step_s"] * 1e3 for r in runs],
            "peak_gb": [r["peak_gb"] for r in runs]})
    res["four_s"] = four_s
    res["seconds"] = time.monotonic() - t0
    emit(res)

    for key, r in fp32.items():
        check(r["ranks_agree"] and r["loss_rel_err"] <= TOL_PP_FP32
              and r["grad_rel_l2"] <= TOL_PP_FP32,
              "pipeline (a): fp32 %s loss %.3g, gradients %.3g" % (
                  key, r["loss_rel_err"], r["grad_rel_l2"]))
    for key, r in bf16.items():
        check(r["ranks_agree"] and r["loss_rel_err"] <= TOL_PP_BF16,
              "pipeline (a): bf16 %s losses %s vs world 1 %s"
              % (key, r["losses"], r["losses_world1"]))
        check(all(got == r["launches_want"] for got in r["launches"]),
              "pipeline (a): %s launches %s, want %s per rank"
              % (key, r["launches"], r["launches_want"]))
    for key in ("1f1b-m4", "1f1b-m8"):
        check(max(bf16[key]["live_max"]) <= 2,
              "pipeline (a): %s held %s microbatches" % (
                  key, bf16[key]["live_max"]))
    check(max(bf16["1f1b-m8"]["peak_gb"])
          <= max(bf16["1f1b-m4"]["peak_gb"]) * 1.05,
          "pipeline (a): 1F1B's peak grew from M 4 %s to M 8 %s" % (
              bf16["1f1b-m4"]["peak_gb"], bf16["1f1b-m8"]["peak_gb"]))
    for r in res["four"]:
        check(r["ranks_agree"] and r["loss_rel_err"] <= TOL_PP_FP32
              and r["grad_rel_l2"] <= TOL_PP_FP32
              and max(r["live_max"]) <= r["mesh"]["pp"],
              "pipeline (b): %s %s" % (r["mesh"], r))
    return res


# phase ctr. (a) the ported example at DeepFM's defaults (vocab 1,000,000,
# embed 16, MLP 256/128/64, bf16) at batch 256: 200 Adam steps at world 1;
# its final train AUC (cumulative over the run) above CTR_AUC_MIN and above
# its first reading (step 50). The synthetic label's logit is 3 x the share
# of ids that are multiples of 7 plus 0.5 x dense[:, 0]: at a vocab of 1 M
# few ids repeat in 51,200 rows, so the dense term carries most of it (the
# port's CPU run: 0.5045 at step 50, 0.5234 at step 200).
CTR_VOCAB = 1_000_000
CTR_STEPS = 200
CTR_AUC_MIN = 0.51
CTR_TIMED_STEPS = 20
# (b) mp 2 (the lm_parallel launch), fp32, against world 1 on the card
CTR_MP_STEPS = 3
CTR_BATCH = 256
TOL_CTR_MP = 1e-6
# (c) chain(topk_compression(0.01), sgd) on DeepFM's parameters, card
# against CPU; (d) the threshold of a [32000, 1024] tensor against numpy
CTR_TOPK_STEPS = 3
CTR_TOPK_RATIO = 0.01
TOL_CTR_TOPK = 1e-6
THRESH_SHAPE = (32000, 1024)


def _ctr_run(torch, mesh=None) -> dict:
    """(b)'s run: ``CTR_MP_STEPS`` Adam steps of the fp32 DeepFM at its
    defaults on one seeded batch (its tables split over ``mesh``'s mp
    when given): losses and the parameters after, gathered."""
    from edl_tpu_torch.examples import ctr_train
    from edl_tpu_torch.models import (CTR_EMBEDDING_RULES, DeepFM,
                                      binary_cross_entropy_loss)
    from edl_tpu_torch.parallel import gather_params, shard_params_by_rules
    from edl_tpu_torch.train import adam, create_state, make_train_step

    model = DeepFM(vocab_size=CTR_VOCAB, dtype=torch.float32, device="cuda")
    state = create_state(model, 0, adam(1e-3), device="cuda")
    if mesh is not None:
        shard_params_by_rules(mesh, model, CTR_EMBEDDING_RULES)
    gen = torch.Generator(device="cuda").manual_seed(31)
    batch = ctr_train.synthetic_batch(gen, CTR_BATCH, CTR_VOCAB, "cuda")
    step = make_train_step(binary_cross_entropy_loss)
    losses = []
    for _ in range(CTR_MP_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    rows = model.embedding.embedding.shape[0]
    after = (gather_params(mesh, model) if mesh is not None
             else {k: v.detach() for k, v in model.named_parameters()})
    return {"losses": losses, "rows": rows, "after": after}


def _ctr_mp_child(torch, rank: int) -> dict:
    """Phase ctr (b) in a rank of the lm_parallel launch: mp 2, and on
    rank 0 world 1 on the same card, compared."""
    from edl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"dp": 1, "mp": 2}, device="cuda")
    run = _ctr_run(torch, mesh)
    rec = {"mesh": mesh.shape, "losses": run["losses"], "rows": run["rows"]}
    if rank == 0:
        ref = _ctr_run(torch, None)
        rec.update(ref_losses=ref["losses"], ref_rows=ref["rows"],
                   param_max_abs_err=max(
                       (run["after"][k] - v).abs().max().item()
                       for k, v in ref["after"].items()))
    return rec


def _topk_params(torch, device):
    """DeepFM's parameters at its defaults (zeros) as leaves on
    ``device``, and ``CTR_TOPK_STEPS`` seeded gradients for them."""
    from edl_tpu_torch.models import DeepFM

    shapes = [(n, p.shape) for n, p in
              DeepFM(vocab_size=CTR_VOCAB, device="meta").named_parameters()]
    gen = torch.Generator().manual_seed(41)
    init = [torch.randn(s, generator=gen) for _, s in shapes]
    grads = [[torch.randn(s, generator=gen) for _, s in shapes]
             for _ in range(CTR_TOPK_STEPS)]
    params = [torch.nn.Parameter(t.to(device)) for t in init]
    return [n for n, _ in shapes], params, grads


def _topk_chain(torch, device) -> dict:
    """(c): ``CTR_TOPK_STEPS`` updates of ``chain(topk_compression,
    sgd)`` on ``device``; the parameters and residuals after, on the
    host, and the mean time of an update there."""
    from edl_tpu_torch.train import chain, sgd, topk_compression

    names, params, grads = _topk_params(torch, device)
    tx = chain(topk_compression(CTR_TOPK_RATIO), sgd(0.1))
    opt = tx.init(params)
    times = []
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = gi.to(device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        tx.update(opt)
        if device == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"params": [p.detach().cpu() for p in params],
            "residual": [r.cpu() for r in opt.states[0].residual],
            "update_ms": sum(times[1:]) / max(1, len(times) - 1) * 1e3,
            "names": names}


def phase_ctr(torch, smi: str, lmp: dict) -> dict:
    """The CTR family on the card: (a) the ported example, (b) mp 2, (c)
    DGC on the card against the CPU, (d) the threshold against numpy. See
    the module docstring."""
    import numpy as np

    from edl_tpu_torch.examples import ctr_train
    from edl_tpu_torch.models import DeepFM, binary_cross_entropy_loss
    from edl_tpu_torch.train import adam, create_state, make_train_step
    from edl_tpu_torch.train.compression import percentile_threshold

    t0 = time.monotonic()
    res = {"phase": "ctr", "card": smi}
    # (a) the example as a user runs it, its printed lines kept
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    t1 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.examples.ctr_train",
         "--vocab", str(CTR_VOCAB), "--steps", str(CTR_STEPS),
         "--batch", str(CTR_BATCH)],
        capture_output=True, text=True, env=env, cwd=HERE,
        timeout=LM_WORKER_TIMEOUT_S)
    if run.returncode != 0:
        sys.stderr.write(run.stdout[-3000:] + run.stderr[-6000:])
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith(("step ", "final "))]
    readings = [float(ln.split()[-1]) for ln in lines]
    auc = readings[-1] if readings else float("nan")
    res["example"] = {"rc": run.returncode, "auc": auc, "lines": lines,
                      "auc_min": CTR_AUC_MIN,
                      "seconds": time.monotonic() - t1}
    # the DeepFM step alone at the example's sizes: ms, peak memory
    model = DeepFM(vocab_size=CTR_VOCAB, device="cuda")
    state = create_state(model, 0, adam(1e-3), device="cuda")
    step = make_train_step(binary_cross_entropy_loss)
    gen = torch.Generator(device="cuda").manual_seed(32)
    batch = ctr_train.synthetic_batch(gen, CTR_BATCH, CTR_VOCAB, "cuda")
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    for _ in range(CTR_TIMED_STEPS):
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    res["step_ms"] = (time.perf_counter() - t1) / CTR_TIMED_STEPS * 1e3
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["step_breakdown"] = _device_breakdown(
        torch, lambda: step(state, batch),
        classes=(("embedding", ("index", "embedding", "gather", "scatter")),
                 ("matmul", ("gemm", "nvjet", "cutlass", "xmma")),
                 ("optimizer", ("multi_tensor", "adam", "Adam"))))
    del model, state
    torch.cuda.empty_cache()
    # (b) mp 2, from the lm_parallel launch
    mp = [r["ctr_mp"] for r in lmp["tp_ranks"]]
    m0 = mp[0]
    res["mp"] = {"mesh": m0["mesh"], "losses": m0["losses"],
                 "losses_world1": m0["ref_losses"],
                 "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(
                     m0["losses"], m0["ref_losses"])),
                 "ranks_agree": all(r["losses"] == m0["losses"] for r in mp),
                 "rows": [r["rows"] for r in mp], "rows_world1": m0["ref_rows"],
                 "param_max_abs_err": m0["param_max_abs_err"]}
    # (c) DGC: the card against the CPU
    card, cpu = _topk_chain(torch, "cuda"), _topk_chain(torch, "cpu")
    res["topk"] = {
        "ratio": CTR_TOPK_RATIO, "steps": CTR_TOPK_STEPS,
        "param_max_abs_err": max((a - b).abs().max().item() for a, b in
                                 zip(card["params"], cpu["params"])),
        "residual_max_abs_err": max((a - b).abs().max().item() for a, b in
                                    zip(card["residual"], cpu["residual"])),
        "kept_share": {n: float((r == 0).float().mean()) for n, r in
                       zip(card["names"], card["residual"])},
        "update_ms": card["update_ms"], "update_ms_cpu": cpu["update_ms"]}
    # (d) the threshold of 32.8 M entries against numpy's percentile
    g = torch.randn(THRESH_SHAPE, generator=torch.Generator().manual_seed(43))
    mag = g.abs()
    want = np.float32(np.percentile(mag.numpy(), 100.0 * (1 - CTR_TOPK_RATIO)))
    dev = mag.cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = float(percentile_threshold(dev, 100.0 * (1 - CTR_TOPK_RATIO)))
    res["threshold"] = {"shape": list(THRESH_SHAPE), "got": got,
                        "numpy": float(want), "ulp": float(np.spacing(want)),
                        "numpy_version": np.__version__,
                        "ms": (time.perf_counter() - t1) * 1e3}
    res["seconds"] = time.monotonic() - t0
    emit(res)

    ex = res["example"]
    check(ex["rc"] == 0 and len(readings) == CTR_STEPS // 50 + 1
          and lines[-1].startswith("final train-auc ")
          and auc > CTR_AUC_MIN and auc > readings[0],
          "ctr (a): rc %d, train AUC %s (bound %.2f)"
          % (ex["rc"], lines, CTR_AUC_MIN))
    mpr = res["mp"]
    check(mpr["ranks_agree"] and mpr["loss_rel_err"] <= TOL_CTR_MP
          and mpr["param_max_abs_err"] <= TOL_CTR_MP
          and mpr["rows"] == [CTR_VOCAB // 2] * 2
          and mpr["rows_world1"] == CTR_VOCAB,
          "ctr (b): mp 2 against world 1 %s" % mpr)
    tk = res["topk"]
    check(tk["param_max_abs_err"] <= TOL_CTR_TOPK
          and tk["residual_max_abs_err"] <= TOL_CTR_TOPK,
          "ctr (c): DGC card against CPU %s" % tk)
    th = res["threshold"]
    check(abs(th["got"] - th["numpy"]) <= th["ulp"],
          "ctr (d): threshold %s" % th)
    return res


def _lm_paths(lmp: dict, name: str) -> dict:
    """Phase lm_parallel's launches of kernel ``name`` by path: the ring
    (every rank of the tp 2 x sp 2 job), Ulysses and the tp 2 step (both
    ranks), lm_generate's training."""
    return {"ring": sum(r[name] for r in lmp["long_context"]["launches"]),
            "ulysses": sum(r[name] for r in lmp["ulysses"]["launches"]),
            "tp_step": sum(r[name] for r in lmp["tp"]["launches"]),
            "lm_generate": lmp["lm_generate"]["launches"][name]}


def _pp_paths(pipe: dict, name: str) -> dict:
    """Phase pipeline (a)'s launches of kernel ``name`` by schedule: the
    bf16 steps of both ranks at every M."""
    return {"pipeline_" + sched: sum(
        n[name] for key, r in pipe["bf16"].items() if key.startswith(sched)
        for n in r["launches"]) for sched in ("gpipe", "1f1b")}


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
    # The card's machine runs Python with PYTHONDONTWRITEBYTECODE and no
    # bytecode beside torch's sources, so every interpreter compiled them
    # anew: most of a worker's import_s and create_state_s (torch.optim
    # imports torch._dynamo) in phase elastic's records. From here on
    # this process and every one it starts keep their bytecode in the
    # checkout's .pycache/.
    cache = os.path.join(HERE, ".pycache")
    sys.pycache_prefix = cache
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = cache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    if sys.argv[1:2] == ["--elastic-child"]:
        elastic_child(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--elastic-launched"]:
        launched_child(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--resnet-launched"]:
        resnet_launched(torch, sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--fsdp-launched"]:
        fsdp_launched(torch, sys.argv[2], sys.argv[3])
        return 0
    if sys.argv[1:2] == ["--lm-launched"]:
        lm_parallel_child(torch, sys.argv[2], int(sys.argv[3]),
                          int(sys.argv[4]))
        return 0
    if sys.argv[1:2] == ["--pp-launched"]:
        pp_launched(torch, sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
        return 0
    # each phase's wall seconds, emitted before the kernels line
    marks = [time.monotonic()]
    seconds = {}

    def done(name):
        marks.append(time.monotonic())
        seconds[name] = marks[-1] - marks[-2]

    dev = phase_device(torch)
    phase_build()
    done("device+build")
    kernels = phase_kernels(torch)
    bwd = phase_kernels_bwd(torch)
    done("kernels")
    model = phase_model(torch, dev["nvidia_smi"])
    serve = phase_serve(torch, model)
    del model
    torch.cuda.empty_cache()
    done("model+serve")
    train = phase_train(torch, dev["nvidia_smi"])
    done("train")
    elastic = phase_elastic(torch, dev["nvidia_smi"], train)
    done("elastic")
    # phase trainee (its own store and launchers around a quadratic bowl
    # that barely uses the card, mostly waiting on process starts) runs
    # beside phase tiers; an exception of either is raised once both end
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        trainee = pool.submit(phase_trainee, torch, dev["nvidia_smi"])
        tiers = phase_tiers(torch, dev["nvidia_smi"])
        trainee.result()
    done("tiers+trainee")
    phase_resnet(torch, dev["nvidia_smi"])
    done("resnet")
    phase_fsdp(torch, dev["nvidia_smi"])
    done("fsdp")
    distill = phase_distill(torch, dev["nvidia_smi"])
    done("distill")
    lmp = phase_lm_parallel(torch, dev["nvidia_smi"])
    done("lm_parallel")
    moe = phase_moe(torch, dev["nvidia_smi"], lmp)
    done("moe")
    pipe = phase_pipeline(torch, dev["nvidia_smi"], lmp)
    done("pipeline")
    phase_ctr(torch, dev["nvidia_smi"], lmp)
    done("ctr")
    emit({"phase_seconds": seconds, "total_s": marks[-1] - marks[0]})
    leaked = sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "edl_tpu")
    )
    check(not leaked, "imported JAX or the JAX package: %s" % leaked)
    flag = kernels[FLAGSHIP_CASE]
    bflag = bwd[BWD_CASES.index(FLAGSHIP_CASE)]
    w16, bw16 = kernels[STUDENT_CASE], bwd[BWD_CASES.index(STUDENT_CASE)]
    nlp = distill["nlp"]
    line = [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "edl_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "edl_tpu/ops/attention.py:163",
        "launches": train["launches"]["flash_fwd"],
        "launches_by_path": {"serve": serve["flash_launches"],
                             "train": train["launches"]["flash_fwd"],
                             "elastic": elastic["launches"]["flash_fwd"],
                             "tiers": tiers["launches"]["flash_fwd"],
                             "distill_student":
                                 nlp["student_launches"]["flash_fwd"],
                             "distill_teacher":
                                 nlp["teacher_launches"]["flash_fwd"],
                             **_lm_paths(lmp, "flash_fwd"),
                             "moe": moe["train"]["launches"]["flash_fwd"],
                             **_pp_paths(pipe, "flash_fwd")},
        "max_abs_err": max(r["max_abs_err"] for r in kernels
                           if r["dtype"] == "bfloat16"),
        "ms": flag["ms"],
        "plain_ms": flag["plain_ms"],
        "bound_ms": flag["bound_ms"],
        "bound_by": flag["bound_by"],
        "bound_share": flag["bound_share"],
        "library_ms": flag["library_ms"],
        "shape": flag["shape"],
        # the distillation student's case, fp32 at head width 16
        "width16": {k: w16[k] for k in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        # widths without a body of their own, zero-padded to the next one
        "widths": {name: {k: kernels[i][k] for k in (
            "shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")} for name, i in WIDTH_CASES.items()},
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
                                 "elastic": elastic["launches"][name],
                                 "tiers": tiers["launches"][name],
                                 "distill_student":
                                     nlp["student_launches"][name],
                                 **_lm_paths(lmp, name),
                                 "moe": moe["train"]["launches"][name],
                                 **_pp_paths(pipe, name)},
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
            "width16": {
                "shape": bw16["shape"], "dtype": bw16["dtype"],
                "max_abs_err": max(bw16["max_abs_err"][g] for g in grads),
                "ms": bw16["%s_ms" % key], "plain_ms": bw16["plain_ms"],
                "bound_ms": bw16["bounds"][key]["bound_ms"],
                "bound_by": bw16["bounds"][key]["bound_by"],
                "library_ms": bw16["library_ms"]},
            "widths": {wname: {
                "shape": r["shape"], "dtype": r["dtype"],
                "max_abs_err": max(r["max_abs_err"][g] for g in grads),
                "ms": r["%s_ms" % key], "plain_ms": r["plain_ms"],
                "bound_ms": r["bounds"][key]["bound_ms"],
                "bound_by": r["bounds"][key]["bound_by"],
                "library_ms": r["library_ms"]}
                for wname, i in WIDTH_CASES.items()
                for r in (bwd[BWD_CASES.index(i)],)},
        })
    emit({"kernels": line})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"],
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
