"""ElasticTrainer: the one-call elastic training loop.

The port of ``edl_tpu/train/loop.py``, stop-resume mode. ``fit``:

  - joins the elastic job from the launcher env (``train.init``:
    ``torch.distributed`` at world > 1),
  - peeks at the checkpoint's ``TrainStatus`` and resolves the
    hyper-parameter adjustments for the CURRENT world size
    (``AdjustRegistry``, e.g. a linear-scaled lr) before building the
    optimizer — the elastic-resize contract,
  - builds the state (``create_state``), wraps the model for data
    parallelism (rank 0's parameters broadcast, gradients averaged),
  - restores the latest checkpoint (keyed by names, so it loads at any
    world size) and resumes at the next epoch,
  - barriers the stage through the store, then runs the epoch loop over
    ``prefetch_to_device`` and saves per epoch.

A stage change (resize) is handled the stop-resume way: the launcher kills
and respawns the process, and ``fit`` resumes from the last checkpoint
under the new world size with re-resolved hyper-parameters. Hot restage
(``EDL_HOT_RESTAGE=1``), graceful drain and the other best-effort planes
of the JAX loop come with slice 3b; ``fit`` names the missing planes in
one line when it starts.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist

from edl_tpu_torch.checkpoint import AdjustRegistry, CheckpointManager, TrainStatus
from edl_tpu_torch.data import batched, prefetch_to_device
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.parallel import (
    batch_sharding,
    data_parallel,
    make_mesh,
    shard_batch,
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

DataFn = Callable[[int], Iterable]  # epoch -> records or ready batches

# the JAX loop's best-effort planes this port does not run yet
NOT_PORTED = (
    "health/drain", "goodput", "memory plane", "profile capture",
    "numerics probe", "AOT ladder", "obs endpoint",
)


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
    resume contract (train_with_fleet.py:458-464).

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
        if fsdp:
            raise NotImplementedError(
                "fsdp=True waits for slice 3b of the port; this slice "
                "trains with data parallelism only"
            )
        if init_kwargs:
            raise TypeError(
                "init_kwargs configure a flax module's init; a torch "
                "module takes its settings in its constructor"
            )
        self._model = model
        self._optimizer = optimizer
        self._loss = loss
        self._mesh_axes = mesh_axes
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
        tensors)."""
        if ctx.hot_restage_enabled():
            raise NotImplementedError(
                "EDL_HOT_RESTAGE=1 (in-process stage adoption) waits for "
                "slice 3b of the port; run the job stop-resume"
            )
        return self._fit_stage(data_fn, epochs, on_epoch_end)

    def _fit_stage(
        self,
        data_fn: DataFn,
        epochs: int,
        on_epoch_end: Optional[Callable[[int, Dict], None]],
    ) -> TrainState:
        env = init(device=self._device)
        t_setup = time.monotonic()  # train_setup trace segment starts here
        mesh = make_mesh(self._mesh_axes, device=self._device)
        # cache-warming shadow stage: two steps, no checkpoint manager at
        # all (a warm stage must never touch the job's ckpt dir)
        warm = warm_only()
        mngr = (
            CheckpointManager(self._ckpt_dir, async_save=self._async_save)
            if self._ckpt_dir and not warm
            else None
        )
        if env.is_rank0 and self._log:
            print("elastic-trainer: not ported yet (slice 3b), not run: %s"
                  % ", ".join(NOT_PORTED))
        # peek the checkpointed status FIRST: adjust callbacks are
        # contractually given (restored_status_or_None, world) so
        # e.g. epoch-aware lr schedules survive stop-resume
        peeked = mngr.read_status() if mngr is not None else None
        overrides = (
            self._adjusts.resolve(peeked, env.world_size)
            if self._adjusts is not None
            else {}
        )
        state = create_state(
            self._model, self._seed, self._make_tx(overrides),
            device=mesh.device,
        )
        # data parallelism: rank 0's parameters are broadcast now, and
        # every backward averages the gradients over the ranks
        state.apply_fn = data_parallel(state.apply_fn, mesh)
        start_epoch = 0
        if mngr is not None:
            state, status = mngr.restore(state)
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
        step = make_train_step(self._loss, self._apply_kwargs)
        sharding = batch_sharding(mesh, self._batch_axis)
        worker_barrier("elastic-trainer-start")
        tracer = obs_trace.get_tracer()
        # restage-trace segment: state build + restore + stage barrier
        tracer.record("train_setup", t_setup, time.monotonic() - t_setup)
        first_step_done = False
        steps_done = 0  # stage-cumulative
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
            for device_batch in prefetch_to_device(
                batches, depth=self._depth, sharding=sharding
            ):
                # no host sync: the metrics stay on the device until
                # the epoch ends
                state, metrics = step(state, device_batch)
                if not first_step_done and mesh.device.type == "cuda":
                    # the stage's cold start ends when its first step
                    # has finished on the card (one sync per stage)
                    torch.cuda.synchronize(mesh.device)
                t_now = time.monotonic()
                dt = t_now - t_prev
                _M_STEP_SECONDS.observe(dt)
                _M_STEPS.inc()
                if not first_step_done:
                    # restage trace: the first completed step is the
                    # operation's closing segment
                    tracer.record("first_step", t_prev, dt, epoch=epoch)
                    obs_trace.end_process_op()
                    _M_FIRST_STEP.set(dt)
                    first_step_done = True
                tracer.record(
                    "train_step", t_prev, dt, epoch=epoch, step=step_idx,
                )
                t_prev = t_now
                step_idx += 1
                steps_done += 1
                if t_now - last_flight >= 1.0:
                    # throttled black-box marker
                    last_flight = t_now
                    obs_events.record(
                        "train_heartbeat", step=steps_done, epoch=epoch
                    )
                if warm and step_idx >= 2:
                    if env.is_rank0 and self._log:
                        print(
                            "warm-only stage (world=%d): two steps "
                            "run; exiting" % env.world_size
                        )
                    sys.exit(0)
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
        return state

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
