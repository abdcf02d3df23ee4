"""Instrumented elastic training worker for the resize-cost benchmark.

The port of ``tools/resize_bench_worker.py``. A real collective train job
(eager DDP step over the stage, joined through ``train.init``) that feeds
the stage telemetry: per-stage ``ready`` and ``first_step`` events and
steady-state samples/s meters (``edl_tpu_torch/utils/telemetry.py``). The
launcher kills and respawns it across resizes; each incarnation measures
its own stage.

The model follows the device: ResNet50_vd at 224x224 (ImageNet-shaped,
full width, 1000 classes) on the card, a flat MLP on the CPU so that
transition timing, not FLOPs, dominates there. Runs ``--steps`` steps and
exits 0, or forever with ``--steps 0`` (the default: the harness's
schedule bounds the run).

After its first step the worker publishes the stage's kernel-cache ledger
and arms the AOT ladder (``train/aot.py``: the neighbour worlds' memory
plans, built from this step's measured plan) when a compile cache is set;
``EDL_AOT=0`` turns the ladder off. A shadow stage of the prewarmer
(``EDL_WARM_ONLY``) runs two steps and exits. The JAX worker's
``EDL_DEBUG_STEP_HLO`` probe has no counterpart: an eager step has no
executable to hash.

    python -m edl_tpu_torch.launch ... \\
        edl_tpu_torch/tools/resize_bench_worker.py [--device cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=0, help="0 = run forever")
    parser.add_argument("--batch_per_worker", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def build(device: str, rank: int, batch_per_worker=None):
    """``(model, (x, y), apply_kwargs, batch)`` for ``device``: ResNet50_vd
    on 224x224 images on the card, the MLP on 256 features on the CPU.
    The rows are drawn from a CPU generator seeded with ``rank``, so the
    workers feed distinct rows (LOCAL-rows contract: the global batch is
    every rank's rows)."""
    import torch

    from edl_tpu_torch.models import MLP, ResNet50_vd

    on_gpu = torch.device(device).type == "cuda"
    batch = batch_per_worker or (128 if on_gpu else 32)
    gen = torch.Generator().manual_seed(rank)
    if on_gpu:
        num_classes = 1000
        model = ResNet50_vd(num_classes=num_classes)
        x = torch.randn((batch, 224, 224, 3), generator=gen)
        apply_kwargs = {"train": True}
    else:  # flat MLP: the first step stays in seconds on one CPU core
        num_classes = 100
        model = MLP(256, hidden=(256, 256), features=num_classes)
        x = torch.randn((batch, 256), generator=gen)
        apply_kwargs = None
    y = torch.randint(0, num_classes, (batch,), generator=gen)
    return model, (x, y), apply_kwargs, batch


def main(argv=None):
    args = parse_args(argv)

    from edl_tpu_torch.obs import events as obs_events
    from edl_tpu_torch.obs import goodput as obs_goodput
    from edl_tpu_torch.obs.memory import MemoryPlane
    from edl_tpu_torch.parallel import data_parallel, make_mesh, shard_batch
    from edl_tpu_torch.train import (
        aot, create_state, cross_entropy_loss, init, make_train_step, sgd,
        warm_only,
    )
    from edl_tpu_torch.utils.device import resolve_device
    from edl_tpu_torch.utils.telemetry import (
        WorkerMeter, record_cache_stats, record_event,
    )

    dev = resolve_device(args.device)
    env = init(device=args.device)
    model, rows, apply_kwargs, batch_per_worker = build(
        dev.type, env.global_rank, args.batch_per_worker)
    mesh = make_mesh({"dp": -1}, device=args.device)
    # the parameters must be the same on every rank: one seed for the
    # init (DDP also broadcasts rank 0's), the rank only in the data
    state = create_state(model, 0, sgd(0.1, momentum=0.9),
                         device=mesh.device)
    state.apply_fn = data_parallel(state.apply_fn, mesh)
    batch = shard_batch(mesh, rows)
    step = make_train_step(cross_entropy_loss, apply_kwargs)
    meter = WorkerMeter(env, batch_per_step=batch_per_worker)

    warm = warm_only()
    ladder = mem_plane = None
    client = meter._store()
    if not warm and client is not None:
        # 'ready' splits the restage lane for analyze(): publish -> ready
        # is process, imports, init and state build ("restore"); ready ->
        # first_step is the first step (kernel-library loads, cuDNN's
        # first calls)
        record_event(client, env.job_id, env.stage, "ready",
                     "w%d" % env.global_rank)
        mem_plane = MemoryPlane(device=mesh.device, stage=env.stage,
                                rank=env.global_rank, client=client,
                                job_id=env.job_id or "")
        mem_plane.arm()
    last_flight = 0.0
    k = 0
    while args.steps == 0 or k < args.steps:
        state, metrics = step(state, batch)
        # a host fetch of the loss: the step has run on the device
        float(metrics["loss"])
        if not warm:
            # goodput: the first step closes the restage interval
            # train.init opened; the throttled heartbeat bounds a
            # SIGKILLed incarnation's open train interval to <= 1 s, so
            # an archived run's flight segments attribute wall-clock
            # like a real job's
            if k == 0:
                obs_goodput.enter("train", cause="first_step")
            now = time.monotonic()
            if now - last_flight >= 1.0:
                last_flight = now
                obs_events.record("train_heartbeat", step=k)
        if k == 0 and not warm:
            # first step done: this stage's cache ledger (hit = a library
            # found or pulled, miss + write = built here) and the ladder
            client = meter._store()
            if client is not None:
                record_cache_stats(client, env.job_id, env.stage,
                                   env.global_rank, aot.cache_event_counts())
            plan = (mem_plane.harvest(state, world=env.world_size)
                    if mem_plane is not None else None)
            if aot.aot_enabled() and env.compile_cache_dir and plan:
                try:
                    ladder = aot.AotLadder(env, aot.make_neighbor_planner(
                        state, plan, on_planned=mem_plane.harvest_rung,
                    )).start()
                except Exception as exc:  # noqa: BLE001
                    print("aot ladder unavailable: %s" % exc)
        if warm and k >= 1:
            # a shadow stage of launch/warm.py: two steps at this world
            print("warm-only: two steps ran at world=%d" % env.world_size)
            sys.exit(0)
        if not warm:
            meter.step()
        k += 1
    meter.close()
    if not warm:
        obs_goodput.close(cause="bench_done")
    if ladder is not None:
        ladder.close()
    if mem_plane is not None:
        mem_plane.close()
    if env.is_rank0:
        print("bench worker done: %d steps, %.1f samples/s/worker"
              % (k, meter.samples_per_s() or 0.0))


if __name__ == "__main__":
    main()
