"""ElasticTrainer: the one-call elastic training loop.

The port of ``edl_tpu/train/loop.py``. ``fit``:

  - joins the elastic job from the launcher env (``train.init``:
    ``torch.distributed`` at world > 1),
  - peeks at the checkpoint's ``TrainStatus`` and resolves the
    hyper-parameter adjustments for the CURRENT world size
    (``AdjustRegistry``, e.g. a linear-scaled lr) before building the
    optimizer — the elastic-resize contract,
  - builds the state (``create_state``), wraps the model for data
    parallelism (rank 0's parameters broadcast, gradients averaged), or
    with ``fsdp=True`` shards its parameters and optimizer state over the
    mesh's ``fsdp`` axis (FSDP2, ``parallel.shard_params_fsdp``),
  - restores the latest checkpoint (keyed by names, so it loads at any
    world size) and resumes at the next epoch,
  - barriers the stage through the store, then runs the epoch loop over
    ``prefetch_to_device`` and saves per epoch.

A stage change (resize) is handled the stop-resume way by default: the
launcher kills and respawns the process, and ``fit`` resumes from the
last checkpoint under the new world size with re-resolved
hyper-parameters. Under ``EDL_HOT_RESTAGE=1`` the process survives the
change instead (``_hot_restage``): the process group is torn down and
joined again, the module and its optimizer are kept, and the newest
checkpoint is restored into them. With a store, a preemption
notice drains the worker between steps (``_drain_exit``): an emergency
checkpoint within the notice's budget, then ``DRAINED_EXIT``.

The JAX loop's four observability planes ride every stage: the goodput
ledger (``compile`` until the first finished step, then ``train`` /
``data_wait``), the numerics probe (the step's bundle, the post-restore
loss check), the profile plane (the first step's FLOPs, windowed MFU,
store-driven ``torch.profiler`` windows) and the memory plane (the first
step's plan, census, OOM forensics). What is not ported yet is named in
one line when ``fit`` starts (``NOT_PORTED``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

from edl_tpu_torch.checkpoint import AdjustRegistry, CheckpointManager, TrainStatus
from edl_tpu_torch.data import batched, prefetch_to_device
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import goodput as obs_goodput
from edl_tpu_torch.obs import memory as obs_memory
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import numerics as obs_numerics
from edl_tpu_torch.obs import profile as obs_profile
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.parallel import (
    batch_sharding,
    data_parallel,
    make_mesh,
    shard_batch,
    shard_params_fsdp,
)
from edl_tpu_torch.train import context as ctx
from edl_tpu_torch.train.context import init, warm_only, worker_barrier
from edl_tpu_torch.train.optim import Transform
from edl_tpu_torch.train.step import TrainState, create_state, make_train_step

_M_STEP_SECONDS = obs_metrics.histogram(
    "edl_train_step_seconds",
    "train step wall time, dispatch-to-dispatch (includes input wait)",
)
_M_STEPS = obs_metrics.counter(
    "edl_train_steps_total", "train steps dispatched"
)
_M_EPOCHS = obs_metrics.counter(
    "edl_train_epochs_total", "epochs completed"
)
_M_FIRST_STEP = obs_metrics.gauge(
    "edl_train_first_step_seconds",
    "first step of the stage (jit trace + compile or cache load)",
)
_M_DRAINS = obs_metrics.counter(
    "edl_train_drains_total", "graceful worker drains (preemption notices honored)"
)

DataFn = Callable[[int], Iterable]  # epoch -> records or ready batches

# the JAX loop's best-effort planes this port does not run yet
NOT_PORTED = ("AOT ladder (M22)",)


class _RestageRequested(Exception):
    """Raised out of the step loop when the stage this process runs under
    has been superseded (hot-restage mode only)."""


def _unwrapped(module: torch.nn.Module) -> torch.nn.Module:
    """The model inside a data-parallel wrapper (DDP keeps it as
    ``.module``), or the model itself (FSDP2 shards a module in place: it
    is its own model)."""
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(module, DistributedDataParallel):
        return module.module
    return module


def _retune(state: TrainState, tx: Transform) -> None:
    """Give the kept optimizer the hyper-parameters ``tx`` sets for the
    new world (a re-scaled learning rate), leaving its state alone: the
    restore that follows loads the state and keeps these."""
    probe = tx.init([torch.nn.Parameter(torch.zeros(1))]).optimizer
    hyper = {k: v for k, v in probe.param_groups[0].items() if k != "params"}
    for group in state.opt_state.optimizer.param_groups:
        group.update(hyper)
    state.tx = tx


def _global_mean(metrics: Dict[str, torch.Tensor], world: int) -> Dict[str, torch.Tensor]:
    """The scalar metrics averaged over the ranks with one all-reduce,
    fetched to the host. Every rank's batch has the same number of rows
    (``batched`` fixes the shape, ``drop_remainder`` drops the tail), so
    the mean of the ranks' means is the mean over the global batch, as the
    JAX step computes it."""
    names = sorted(k for k, v in metrics.items() if v.dim() == 0)
    if not names:
        return {}
    packed = torch.stack([metrics[k].float() for k in names])
    if world > 1:
        dist.all_reduce(packed)
        packed /= world
    return dict(zip(names, packed.cpu().unbind()))


class ElasticTrainer:
    """Drive an elastic data-parallel training job end to end.

    ``optimizer`` is either a :class:`~edl_tpu_torch.train.optim.Transform`
    (``adamw(...)``) or a factory ``overrides_dict -> Transform`` — the
    factory form is what makes hyper-parameter adjustment on resize work
    (it is called with the merged ``AdjustRegistry`` output for the
    current world size, e.g. ``{"lr": 0.4}``).

    ``data_fn(epoch)`` returns THIS RANK's data for the epoch: raw records
    when ``batch_size`` is set (packed into fixed-shape batches, ragged
    tail dropped), or ready ``(x, y)`` host batches otherwise. Epoch-seeded
    generators give the reference's ``pass_id_as_seed`` deterministic-
    resume contract (train_with_fleet.py:458-464). Batches shard over
    ``dp``: at ``fsdp`` > 1 the ranks of one ``fsdp`` group pass the same
    rows, those of ``dp`` index ``trainer.mesh.dp_rank`` of
    ``trainer.mesh.dp_size`` (the stage's mesh, set when ``fit`` builds
    it).

    ``fsdp=True`` shards the parameters and the optimizer state over the
    mesh's ``fsdp`` axis (``mesh_axes`` defaults to ``{"dp": 1, "fsdp":
    -1}`` then) with FSDP2; batch-norm running averages stay replicated.
    The module is built on the ``meta`` device from the given one (whose
    storage is released), sharded there, and only its shards are
    materialised on the device, filled from the given module's values
    (``seed=None``) or drawn by its ``init_weights`` one tensor at a
    time: the device never holds the whole model. A stage change
    rebuilds the sharded module and its optimizer for the new mesh
    (``restages[i]["state"] == "rebuild"``) before the checkpoint is
    restored into them; DCP reshards the version to the new ``fsdp``
    size.

    ``seed`` initialises the model's weights (``init_weights``) at every
    stage, as the JAX trainer draws them from ``PRNGKey(seed)``;
    ``seed=None`` keeps the weights the module has (converted ones).
    ``sample_input`` is accepted for the JAX call sites and not needed:
    a torch module is built by its constructor. ``device`` is the card
    unless the caller names the CPU (gloo then carries the collectives).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer,
        loss: Callable,
        sample_input=None,
        mesh_axes: Optional[Dict[str, int]] = None,
        fsdp: bool = False,
        ckpt_dir: Optional[str] = None,
        adjusts: Optional[AdjustRegistry] = None,
        apply_kwargs: Optional[Dict[str, Any]] = None,
        init_kwargs: Optional[Dict[str, Any]] = None,
        batch_size: Optional[int] = None,
        batch_axis: str = "dp",
        async_save: bool = False,
        prefetch_depth: int = 2,
        seed: Optional[int] = 0,
        log: bool = True,
        device="cuda",
    ) -> None:
        if init_kwargs:
            raise TypeError(
                "init_kwargs configure a flax module's init; a torch "
                "module takes its settings in its constructor"
            )
        self._model = model
        self._optimizer = optimizer
        self._loss = loss
        self._fsdp = fsdp
        self._mesh_axes = mesh_axes or ({"dp": 1, "fsdp": -1} if fsdp
                                        else None)
        # fsdp: the module on meta and the host values it is filled from
        self._template: Optional[torch.nn.Module] = None
        self._host: Dict[str, torch.Tensor] = {}
        self.mesh = None  # the stage's mesh, once fit has built it
        self._ckpt_dir = ckpt_dir
        self._adjusts = adjusts
        self._apply_kwargs = apply_kwargs
        self._batch_size = batch_size
        self._batch_axis = batch_axis
        self._async_save = async_save
        self._depth = prefetch_depth
        self._seed = seed
        self._log = log
        self._device = device
        # hot restage: the state a restaged process keeps (module and
        # optimizer), and one record per adopted stage (its times)
        self._kept: Optional[TrainState] = None
        self.restages: List[Dict[str, Any]] = []

    def _make_tx(self, overrides: Dict[str, Any]) -> Transform:
        if isinstance(self._optimizer, Transform):
            return self._optimizer
        return self._optimizer(overrides)

    def fit(
        self,
        data_fn: DataFn,
        epochs: int,
        on_epoch_end: Optional[Callable[[int, Dict], None]] = None,
    ) -> TrainState:
        """Train to ``epochs``, resuming after the last checkpointed
        epoch. ``on_epoch_end(epoch, metrics)`` gets the epoch's last
        step's metrics, averaged over the global batch (0-d CPU
        tensors).

        Under ``EDL_HOT_RESTAGE=1`` this also survives elastic stage
        changes WITHOUT a process restart: a drain-token bump raises out
        of the step loop, the process group is torn down and joined again
        for the new generation, and the loop re-enters from the last
        checkpoint — the same resume contract as stop-resume, minus the
        interpreter, import and state-construction cold start. Anything
        dirty during the handover exits with ``HOT_RESTAGE_EXIT`` so the
        launcher falls back to a cold respawn."""
        if not ctx.hot_restage_enabled():
            return self._fit_stage(data_fn, epochs, on_epoch_end, None)
        env = init(device=self._device)
        monitor = (
            ctx.StageMonitor(env)
            if env.store_endpoint and not warm_only()
            else None
        )
        try:
            while True:
                try:
                    return self._fit_stage(
                        data_fn, epochs, on_epoch_end, monitor
                    )
                except _RestageRequested:
                    self._hot_restage(monitor)
        finally:
            if monitor is not None:
                monitor.close()

    def _hot_restage(self, monitor) -> None:
        """Adopt the new generation in-process, or exit for a respawn."""
        env = ctx.current_env()
        grace = float(os.environ.get("EDL_HOT_GRACE", "20"))
        rec: Dict[str, Any] = {"from_stage": env.stage,
                               "from_world": env.world_size,
                               "token_seen_ts": monitor.pending_since}
        try:
            t0 = time.monotonic()
            cluster = monitor.wait_for_my_stage(env.pod_id, timeout=grace)
            if cluster is None:
                raise RuntimeError(
                    "no published generation includes this pod"
                )
            rec["wait_publish_s"] = time.monotonic() - t0
            # confirm the handoff BEFORE the group's re-init: the
            # launcher's deadline exists to catch workers wedged in dead
            # collectives, which can never reach this line — while the
            # re-init rendezvous legitimately blocks on slow joiners (a
            # cold pod's interpreter+import start) for longer than any
            # sane wedge deadline. init() has its own timeout; a failure
            # there exits via HOT_RESTAGE_EXIT below.
            monitor.mark_adopted(env.pod_id, env.rank_in_pod, cluster.stage)
            t0 = time.monotonic()
            new_env = ctx.reinit_for_stage(
                cluster, env.pod_id, env.rank_in_pod, device=self._device
            )
            rec["reinit_s"] = time.monotonic() - t0
            monitor.arm(new_env.stage)
            rec.update(stage=new_env.stage, world=new_env.world_size)
            self.restages.append(rec)
        except Exception as exc:
            print(
                "elastic-trainer: hot restage failed (%s); requesting "
                "respawn" % exc,
                file=sys.stderr,
            )
            sys.exit(ctx.HOT_RESTAGE_EXIT)

    def _drain_exit(self, health, mngr, state, epoch: int, step: int, env):
        """Honor a preemption notice between steps: emergency checkpoint
        within the notice's budget (best effort — an unfinished save is
        quarantined by restore-side fallback), record the drain, and leave
        with the clean ``DRAINED_EXIT`` code the launcher expects."""
        # drain operation trace (keyed by pod id, same derivation as the
        # launcher's root): the emergency save and drained records below
        # stitch under the pod's drain op
        obs_trace.begin_process_op("drain", env.pod_id)
        obs_goodput.enter("drain", cause="preempt")
        budget = health.drain_budget_left()
        if mngr is not None and env.world_size == 1:
            # DCP saves are COLLECTIVE across the group: a single draining
            # pod of a multi-pod stage cannot checkpoint alone (its peers
            # are not draining and will never join the save), so the
            # partial-drain case pushes its last periodic version to a
            # peer (below) and relies on the proactive restage; the
            # single-process world gets the exact bounded-lost-work
            # snapshot.
            # epoch-1: this epoch is NOT complete — resume replays it from
            # the start with the (further-advanced) emergency state, the
            # same contract as being killed mid-epoch, minus the lost steps
            status = TrainStatus(
                epoch=epoch - 1,
                step=int(state.step),
                world_size=env.world_size,
                meta={"emergency": True, "mid_epoch": epoch},
            )
            mngr.emergency_save(state, status, budget)
        elif mngr is not None:
            # the multi-pod partial drain: this pod cannot checkpoint alone
            # (the save is collective), but it CAN make the versions it
            # already holds survive its departure — a peer replica push is
            # per-pod and non-collective (no-op without a local tier)
            mngr.emergency_replicate(budget)
        _M_DRAINS.inc()
        health.record_drained(step)
        if env.is_rank0 and self._log:
            print(
                "elastic-trainer: preemption notice honored at epoch %d "
                "step %d (budget %.1fs); exiting drained" % (epoch, step, budget)
            )
        obs_goodput.close(cause="drained")
        sys.exit(ctx.DRAINED_EXIT)

    def _build_state(self, env, mesh, mngr, overrides) -> TrainState:
        """This stage's state, not yet wrapped for the group. A process
        that adopted the stage in-process keeps its module and optimizer
        (given this world's hyper-parameters) when a checkpoint will be
        restored into them; otherwise — a fresh process, or nothing to
        restore — the weights are initialised and the optimizer built.
        Under ``fsdp`` the state is always built anew: a kept module's
        shards belong to the torn-down mesh."""
        kept, self._kept = self._kept, None
        t0 = time.monotonic()
        if kept is not None:
            kept.apply_fn = _unwrapped(kept.apply_fn)
        if self._fsdp:
            # a kept module's shards live on the torn-down mesh: rebuilt
            state = create_state(
                self._sharded_module(mesh), self._seed,
                self._make_tx(overrides), device=mesh.device,
            )
            how = "rebuild"
        elif kept is not None and mngr is not None \
                and mngr.latest_step() is not None:
            _retune(kept, self._make_tx(overrides))
            state, how = kept, "keep"
        else:
            state = create_state(
                self._model, self._seed, self._make_tx(overrides),
                device=mesh.device,
            )
            how = "rebuild"
        if kept is not None and self.restages:
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            self.restages[-1].update(state=how,
                                     state_s=time.monotonic() - t0)
        return state

    def _sharded_module(self, mesh) -> torch.nn.Module:
        """A fresh copy of the model sharded over ``mesh`` (FSDP2 when the
        stage has a process group, whole on a one-worker stage without
        one): built on ``meta``, sharded there, materialised shard by
        shard on the device and filled with the given module's values
        (the buffers, and the parameters unless ``init_weights`` will
        draw them)."""
        import copy

        from edl_tpu_torch.parallel.mesh import sharded_init

        if self._template is None:
            keep = dict(self._model.named_buffers())
            if self._seed is None:
                keep.update(self._model.named_parameters())
            self._host = {k: v.detach().to("cpu", copy=True)
                          for k, v in keep.items()}
            self._template = self._model.to("meta")
        module = copy.deepcopy(self._template)
        if dist.is_available() and dist.is_initialized():
            shard_params_fsdp(mesh, module)
        module.to_empty(device=mesh.device)
        values = dict(module.named_parameters())
        values.update(module.named_buffers())
        with torch.no_grad(), sharded_init():
            for name, host in self._host.items():
                values[name].copy_(host.to(mesh.device))
        return module

    def _fit_stage(
        self,
        data_fn: DataFn,
        epochs: int,
        on_epoch_end: Optional[Callable[[int, Dict], None]],
        monitor,
    ) -> TrainState:
        env = init(device=self._device)
        t_setup = time.monotonic()  # train_setup trace segment starts here
        mesh = self.mesh = make_mesh(self._mesh_axes, device=self._device)
        # cache-warming shadow stage: two steps, no checkpoint manager at
        # all (a warm stage must never touch the job's ckpt dir)
        warm = warm_only()
        mngr = (
            CheckpointManager(self._ckpt_dir, async_save=self._async_save)
            if self._ckpt_dir and not warm
            else None
        )
        # health plane: drain-notice watch + step heartbeats. Best-effort
        # by design — a job without a store (or a store that is down right
        # now) trains exactly as before, it just cannot drain gracefully.
        health = None
        if env.store_endpoint and env.job_id and not warm:
            try:
                health = ctx.HealthMonitor(env)
            except Exception as exc:  # noqa: BLE001
                print(
                    "elastic-trainer: health monitor unavailable (%s); "
                    "continuing without graceful drain" % exc,
                    file=sys.stderr,
                )
        if env.is_rank0 and self._log and not self.restages:
            print("elastic-trainer: not ported yet, not run: %s"
                  % ", ".join(NOT_PORTED))
        state = None
        probe = capture = mem_plane = step_telemetry = None
        try:
            # peek the checkpointed status FIRST: adjust callbacks are
            # contractually given (restored_status_or_None, world) so
            # e.g. epoch-aware lr schedules survive stop-resume
            peeked = mngr.read_status() if mngr is not None else None
            overrides = (
                self._adjusts.resolve(peeked, env.world_size)
                if self._adjusts is not None
                else {}
            )
            state = self._build_state(env, mesh, mngr, overrides)
            # data parallelism: rank 0's parameters are broadcast now, and
            # every backward averages the gradients over the ranks (an
            # FSDP module reduces its own and is returned as it is)
            state.apply_fn = data_parallel(state.apply_fn, mesh)
            start_epoch = 0
            status_restored = None
            if mngr is not None:
                t0 = time.monotonic()
                state, status = mngr.restore(state)
                # each rank restored from its own pod's tiers: one version
                # for the whole stage
                status = mngr.agree(state, status)
                status_restored = status
                if self.restages and "restore_s" not in self.restages[-1]:
                    self.restages[-1]["restore_s"] = time.monotonic() - t0
                if status:
                    start_epoch = status.next_epoch()
                    if env.is_rank0 and self._log:
                        print(
                            "elastic-trainer: resumed at epoch %d "
                            "(world=%d%s)"
                            % (
                                start_epoch,
                                env.world_size,
                                "".join(
                                    ", %s=%s" % kv
                                    for kv in sorted(overrides.items())
                                ),
                            )
                        )
            # numerics plane: the step's bundle and its throttled export;
            # the warm shadow stage never publishes (its steps are not
            # training). Shares the health plane's store client for the
            # cross-replica digest when one exists.
            store = health.store_client if health is not None else None
            if not warm and obs_numerics.enabled():
                probe = obs_numerics.NumericsProbe(
                    rank=env.global_rank, client=store,
                    job_id=env.job_id or "",
                )
                if status_restored is not None:
                    # the resume-continuity check against the stamped
                    # fingerprint, after every restore (cold or hot)
                    probe.expect(
                        (status_restored.meta or {}).get("numerics"))
            step = make_train_step(
                self._loss, self._apply_kwargs,
                numerics=obs_numerics.enabled(),
            )
            sharding = batch_sharding(mesh, self._batch_axis)
            worker_barrier("elastic-trainer-start")
            tracer = obs_trace.get_tracer()
            # restage-trace segment: state build + restore + stage barrier
            tracer.record("train_setup", t_setup, time.monotonic() - t_setup)
            # memory plane: the first step's plan, census and watermarks,
            # OOM forensics (a warm shadow stage's plan would be the
            # real stage's, published twice)
            if not warm:
                try:
                    mem_plane = obs_memory.MemoryPlane(
                        device=mesh.device, stage=env.stage,
                        rank=env.global_rank, client=store,
                        job_id=env.job_id or "",
                    )
                    mem_plane.arm()
                except Exception as exc:  # noqa: BLE001 — telemetry
                    print(
                        "elastic-trainer: memory plane unavailable (%s); "
                        "continuing without it" % exc,
                        file=sys.stderr,
                    )
            # goodput: everything from here until the first finished step
            # is attributed to compile (the port has no jit: lazy CUDA
            # init, loading the kernels, the first cuBLAS handles)
            obs_goodput.enter("compile", cause="first_step")
            # profile plane: windowed MFU gauges (armed with the first
            # step's FLOPs) and store-driven torch.profiler windows;
            # EDL_PROFILE_DIR arms one window for the whole fit
            step_telemetry = obs_profile.StepTelemetry()
            if not warm:
                try:
                    capture = obs_profile.CaptureController(
                        env, telemetry=step_telemetry, client=store)
                    profile_dir = os.environ.get("EDL_PROFILE_DIR")
                    if profile_dir:
                        capture.arm_local(profile_dir, start_after=10, steps=5)
                except Exception as exc:  # noqa: BLE001 — profiling is best-effort
                    print(
                        "elastic-trainer: capture plane unavailable (%s); "
                        "continuing without it" % exc,
                        file=sys.stderr,
                    )
            base_step = (int(status_restored.step)
                          if status_restored is not None else 0)
            on_card = mesh.device.type == "cuda"
            sync = (lambda: torch.cuda.synchronize(mesh.device)) if on_card \
                else None
            first_step_done = False
            steps_done = 0  # stage-cumulative, drives the heartbeat
            last_flight = 0.0  # throttled flight-recorder step marker
            for epoch in range(start_epoch, epochs):
                metrics: Dict[str, Any] = {}
                batches = data_fn(epoch)
                if self._batch_size is not None:
                    batches = (
                        b
                        for b, _ in batched(
                            batches, self._batch_size, drop_remainder=True
                        )
                    )
                step_idx = 0
                t_epoch = time.monotonic()
                t_prev = t_epoch
                # explicit iterator: the time blocked in next() is the
                # input pipeline's (data_wait), the step's is train
                batch_iter = iter(prefetch_to_device(
                    batches, depth=self._depth, sharding=sharding
                ))
                try:
                    while True:
                        if first_step_done:
                            obs_goodput.enter("data_wait")
                        try:
                            device_batch = next(batch_iter)
                        except StopIteration:
                            break
                        if first_step_done:
                            obs_goodput.enter("train")
                        if health is not None and health.drain_notice:
                            # drain beats restage: this pod is leaving the
                            # job, not joining the next generation
                            self._drain_exit(
                                health, mngr, state, epoch, steps_done, env
                            )
                        if monitor is not None and monitor.restage_pending:
                            # between steps; the fetched batch is simply
                            # dropped (same loss as a stop-resume kill)
                            raise _RestageRequested()
                        # no host sync: the metrics stay on the device
                        # until the epoch ends
                        guard = (mem_plane.oom_guard(step=steps_done,
                                                     epoch=epoch)
                                 if mem_plane is not None
                                 else contextlib.nullcontext())
                        # the first step runs under the FLOP counter: the
                        # real step, counted (no extra step)
                        counter = (obs_profile.CostCounter()
                                   if not first_step_done
                                   else contextlib.nullcontext())
                        with guard, counter:
                            state, metrics = step(state, device_batch)
                        # pop before any aggregation: the bundle is the
                        # probe's, not a metric
                        bundle = metrics.pop(obs_numerics.METRICS_KEY, None)
                        if probe is not None:
                            # the job's step (the restored one on): the
                            # replicas' digests compare at the same step,
                            # never with a stale one of an earlier stage
                            probe.on_step(base_step + steps_done, bundle)
                        if not first_step_done and on_card:
                            # the stage's cold start ends when its first
                            # step has finished on the card (one sync per
                            # stage)
                            sync()
                        t_now = time.monotonic()
                        dt = t_now - t_prev
                        _M_STEP_SECONDS.observe(dt)
                        _M_STEPS.inc()
                        if not first_step_done:
                            # restage trace: the first completed step is
                            # the operation's closing segment
                            tracer.record("first_step", t_prev, dt, epoch=epoch)
                            obs_trace.end_process_op()
                            _M_FIRST_STEP.set(dt)
                            first_step_done = True
                            obs_goodput.enter("train", cause="first_step")
                            step_telemetry.set_cost(counter.cost,
                                                    device=mesh.device)
                            if mem_plane is not None:
                                mem_plane.harvest(state, world=env.world_size)
                            if self.restages and \
                                    "first_step_end_ts" not in self.restages[-1]:
                                self.restages[-1]["first_step_end_ts"] = time.time()
                        tracer.record(
                            "train_step", t_prev, dt, epoch=epoch, step=step_idx,
                        )
                        step_telemetry.observe_step(dt)
                        if mem_plane is not None:
                            mem_plane.on_step(steps_done)
                        t_prev = t_now
                        step_idx += 1
                        steps_done += 1
                        if t_now - last_flight >= 1.0:
                            # throttled black-box marker: bounds a killed
                            # worker's open goodput interval to <= 1 s
                            last_flight = t_now
                            obs_events.record(
                                "train_heartbeat", step=steps_done, epoch=epoch
                            )
                        if health is not None:
                            health.heartbeat(steps_done, dt)
                        if capture is not None:
                            # the sync makes the closing trace hold the
                            # device work it claims to
                            capture.on_step(sync=sync)
                        if warm and step_idx >= 2:
                            if env.is_rank0 and self._log:
                                print(
                                    "warm-only stage (world=%d): two steps "
                                    "run; exiting" % env.world_size
                                )
                            sys.exit(0)
                finally:
                    batch_iter.close()  # stops the feeder if abandoned
                if first_step_done:
                    # the epoch-end fetch below is step work, not input wait
                    obs_goodput.enter("train")
                metrics = _global_mean(metrics, env.world_size)
                if env.is_rank0 and self._log and metrics:
                    print(
                        "epoch %d %s"
                        % (
                            epoch,
                            " ".join(
                                "%s %.4f" % (k, float(v))
                                for k, v in sorted(metrics.items())
                            ),
                        )
                    )
                if not metrics and env.is_rank0 and self._log:
                    print(
                        "epoch %d produced no full batches "
                        "(fewer than batch_size records?)" % epoch
                    )
                _M_EPOCHS.inc()
                tracer.record(
                    "train_epoch", t_epoch,
                    time.monotonic() - t_epoch,
                    epoch=epoch, steps=step_idx,
                )
                if on_epoch_end is not None:
                    on_epoch_end(epoch, metrics)
                if mngr is not None:
                    mngr.save(
                        state,
                        TrainStatus(epoch=epoch, step=int(state.step)),
                    )
            if mngr is not None:
                mngr.wait()
            obs_goodput.close(cause="complete")
            return state
        except _RestageRequested:
            # the process survives the stage: its module and optimizer
            # carry into the next one (see _build_state)
            self._kept = state
            raise
        finally:
            # every plane closes with the stage: at the end, on a drain
            # (SystemExit) and before a hot restage
            if probe is not None:
                probe.close()
            if capture is not None:
                capture.close()
            if mem_plane is not None:
                mem_plane.close()
            if step_telemetry is not None:
                step_telemetry.close()
            if health is not None:
                health.close()
            if mngr is not None:
                mngr.close()

    def evaluate(self, state: TrainState, data_fn: Callable[[], Iterable]):
        """Run one evaluation pass and return sample-weighted mean metrics
        over every rank's records.

        ``data_fn()`` yields this rank's records (when ``batch_size`` is
        set) or ready host batches, like ``fit``'s per-epoch data. The
        final ragged batch is NOT dropped: ``batched``'s pad+mask keeps
        shapes static and the metric mean weights each batch by its
        valid-row count, so eval covers every record exactly once.
        """
        from edl_tpu_torch.train.step import make_eval_step, make_masked_eval_step

        mesh = make_mesh(self._mesh_axes, device=self._device)
        eval_step = make_eval_step(self._loss, self._apply_kwargs)
        masked_eval_step = make_masked_eval_step(self._loss, self._apply_kwargs)
        pending = []  # (device metrics, n_valid): fetched once at the end
        sharding = batch_sharding(mesh, self._batch_axis)
        batches = data_fn()
        if self._batch_size is not None:
            pairs = batched(batches, self._batch_size)
        else:
            pairs = ((b, None) for b in batches)
        # full batches ride the same overlapped transfer pipeline as fit;
        # the (single, final) ragged batch is set aside
        ragged = []

        def full_batches():
            for b, m in pairs:
                if m is not None and not m.all():
                    ragged.append((b, m))
                else:
                    yield b

        for placed in prefetch_to_device(
            full_batches(), depth=self._depth, sharding=sharding
        ):
            n = float(placed[0].shape[0])
            # no host sync inside the loop: everything is fetched at the end
            pending.append((eval_step(state, placed), n))
        for host_batch, mask in ragged:
            placed = shard_batch(mesh, host_batch, self._batch_axis)
            mask_dev = shard_batch(mesh, mask, self._batch_axis)
            pending.append(masked_eval_step(state, placed, mask_dev))
        names = sorted({k for m, _ in pending for k, v in m.items()
                        if v.dim() == 0})
        # per name the weighted sum, and the weight: summed over the ranks
        totals = torch.zeros(len(names) + 1, dtype=torch.float64,
                             device=mesh.device)
        for metrics, n_valid in pending:
            n_valid = torch.as_tensor(n_valid, dtype=torch.float64,
                                      device=mesh.device)
            for i, name in enumerate(names):
                totals[i] += metrics[name].double() * n_valid
            totals[-1] += n_valid
        if mesh.size > 1:
            dist.all_reduce(totals)
        totals = totals.cpu()
        weight = max(float(totals[-1]), 1.0)
        return {name: float(totals[i]) / weight for i, name in enumerate(names)}
