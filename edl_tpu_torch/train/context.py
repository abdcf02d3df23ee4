"""Worker-side job bootstrap: join the distributed runtime, barrier.

The port of ``edl_tpu/train/context.py``, the parts a stop-resume worker
runs. :func:`init` reads the ``EDL_*`` contract the launcher sets
(``edl_tpu/launch/process.py``) and, in a multi-worker stage, joins
``torch.distributed`` where the JAX package calls
``jax.distributed.initialize``: rank 0's published coordinator endpoint
hosts the rendezvous (``tcp://`` init), NCCL on the card, gloo when the
caller asks for the CPU.

Each elastic stage restarts worker processes, so ``init`` is a
fresh-process bootstrap; the stage token is part of every barrier key.
The in-process half (``reinit_for_stage``, ``StageMonitor``,
``HealthMonitor``: hot restage and graceful drain) comes with slice 3b.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Optional

from edl_tpu_torch.cluster.job_env import WorkerEnv
from edl_tpu_torch.utils.exceptions import EdlBarrierError
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("train.context")

_env: Optional[WorkerEnv] = None
_distributed_up = False  # torch.distributed joined by a previous init()
_cache_noted = False

# the default of jax.distributed.initialize: a dead peer must not wedge the
# rendezvous for torch's 30 minutes; the launcher's deadline does the rest
DIST_INIT_TIMEOUT = datetime.timedelta(seconds=300)


def hot_restage_enabled() -> bool:
    """True when the job runs in hot-restage mode (``EDL_HOT_RESTAGE=1``):
    surviving workers would adopt new stages in-process. The port's
    trainer refuses it until slice 3b."""
    return os.environ.get("EDL_HOT_RESTAGE") == "1"


def warm_only() -> bool:
    """True inside a cache-warming shadow stage (``EDL_WARM_ONLY=1``,
    spawned by the launcher's warmer): the training script runs a couple
    of steps and exits 0 without checkpoint writes or store traffic.
    ``ElasticTrainer.fit`` honors this automatically."""
    return os.environ.get("EDL_WARM_ONLY") == "1"


_boot_recorded = False


def _record_boot_span(obs_trace) -> None:
    """Once per process: a ``worker_boot`` restage-trace segment from the
    launcher's spawn stamp (``EDL_SPAWN_TS``) to now — the interpreter +
    import cold start, which no in-process code can otherwise observe."""
    global _boot_recorded
    if _boot_recorded:
        return
    _boot_recorded = True
    raw = os.environ.get("EDL_SPAWN_TS", "")
    if not raw:
        return
    try:
        age = time.time() - float(raw)
    except ValueError:
        return
    if not 0.0 < age < 3600.0:
        return  # a clock step or an inherited stale stamp: drop it
    obs_trace.get_tracer().record(
        "worker_boot", time.monotonic() - age, age
    )


def _note_compile_cache(env: WorkerEnv) -> None:
    """The JAX package points XLA's persistent cache at
    ``EDL_COMPILE_CACHE_DIR``; the port compiles nothing at run time (eager
    PyTorch, kernels built once per source), so the directory has no use
    until the ``torch.compile`` question of ROADMAP M22 is settled."""
    global _cache_noted
    if env.compile_cache_dir and not _cache_noted:
        _cache_noted = True
        logger.info(
            "EDL_COMPILE_CACHE_DIR=%s is not used: the port has no compile "
            "cache until ROADMAP M22", env.compile_cache_dir,
        )


def init(env: Optional[WorkerEnv] = None, device="cuda") -> WorkerEnv:
    """Join the job: returns the worker env; in multi-worker stages also
    joins ``torch.distributed`` (rank 0's endpoint is the coordinator) and,
    on the card, selects this worker's device (``rank_in_pod``).

    ``device`` picks the backend: NCCL for ``"cuda"`` (the default; raises
    without CUDA), gloo for ``"cpu"``. A one-worker stage builds no
    process group, as the JAX package builds no distributed client.

    Idempotent per process: user scripts call it for the env, and
    ``ElasticTrainer.fit`` calls it again — only the first call joins.
    Stop-resume gives every stage a fresh process, so the guard never
    carries across stages.
    """
    global _env, _distributed_up
    env = env or WorkerEnv()
    _env = env
    if env.stage and not warm_only():
        # distributed tracing: this worker's restage window — boot, the
        # process-group join, restore, first step — stitches into the
        # stage's restage trace (the trace id derives from the stage token)
        from edl_tpu_torch.obs import trace as obs_trace

        obs_trace.begin_process_op(
            "restage", env.stage, rank=str(env.global_rank)
        )
        _record_boot_span(obs_trace)
    _note_compile_cache(env)
    if _distributed_up or env.world_size <= 1 or not env.coordinator:
        return env
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(env.rank_in_pod)
    logger.info(
        "worker %d/%d joining stage %s (coordinator %s, %s)",
        env.global_rank, env.world_size, env.stage[:8] or "-",
        env.coordinator, backend,
    )
    from edl_tpu_torch.obs import trace as obs_trace

    # restage-trace segment: the join barriers on the slowest joiner
    with obs_trace.child_span("dist_init", world=str(env.world_size)):
        dist.init_process_group(
            backend,
            init_method="tcp://" + env.coordinator,
            world_size=env.world_size,
            rank=env.global_rank,
            timeout=DIST_INIT_TIMEOUT,
        )
    _distributed_up = True
    return env


def current_env() -> WorkerEnv:
    return _env if _env is not None else WorkerEnv()


_barrier_rounds: dict = {}


def worker_barrier(name: str, timeout: float = 600.0, ttl: float = 10.0) -> None:
    """Control-plane barrier across all workers of the current stage.

    Capability parity with the reference's leader-hosted ``Barrier`` RPC
    (python/edl/utils/pod_server.py:63, pod_client.py:37), built on the
    store instead of a dedicated server: every worker registers
    ``barrier/{stage}:{name}#{round}/{rank}`` (leased) and waits until all
    ``world_size`` ranks are present. The per-process round counter makes
    the same barrier name reusable back-to-back: keys from round N (left
    to lease expiry) can never satisfy round N+1. All ranks hit barriers
    in program order, so counters agree across processes; a restarted
    worker resets to round 0 together with everyone else because restarts
    only happen at stage changes and the stage is part of the key.
    """
    env = current_env()
    if env.world_size <= 1 or not env.store_endpoint:
        return
    from edl_tpu_torch.discovery.registry import Registry
    from edl_tpu_torch.store.client import connect_store

    round_key = (env.stage, name)
    seq = _barrier_rounds.get(round_key, 0)
    _barrier_rounds[round_key] = seq + 1
    service = "barrier/%s:%s#%d" % (env.stage or "static", name, seq)
    client = connect_store(env.store_endpoint, timeout=min(timeout, 30.0))
    try:
        registry = Registry(client, env.job_id or "job")
        # push-based wait: the store watch wakes us on every membership
        # change (the reference polls its leader barrier RPC at ~3 Hz,
        # pod_client.py:37; early rounds here polled at 20 Hz)
        full = threading.Event()
        seen = [0]

        def on_change(snapshot):
            seen[0] = len(snapshot)
            if len(snapshot) >= env.world_size:
                full.set()

        watch = registry.watch_service(service, on_change=on_change)
        reg = registry.register(service, str(env.global_rank), b"1", ttl=ttl)
        try:
            if not full.wait(timeout):
                raise EdlBarrierError(
                    "barrier %r timed out: %d/%d workers"
                    % (name, seen[0], env.world_size)
                )
        finally:
            watch.cancel()
            reg.stop(delete=False)  # leave the key; lease expiry cleans up
    finally:
        client.close()
