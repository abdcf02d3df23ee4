"""Versioned checkpoint/resume across a change of world size, in tiers.

The port of ``edl_tpu/checkpoint/manager.py``, on
``torch.distributed.checkpoint`` (DCP) in place of Orbax. The checkpoint is
the only state that crosses an elastic resize (the reference's
``fleet.save_check_point``/``load_check_point`` with ``TrainStatus``,
train_with_fleet.py:422-428, 563-570); the contract is the JAX package's:

- one directory per integer step (Orbax's layout), holding the DCP files
  of the model's and the optimizer's state plus ``status.json`` (the
  ``TrainStatus``, with the numerics fingerprint);
- a version is written under a temporary name (``.tmp-<step>``) and
  renamed to its step after every rank has written, so a crash mid-save
  leaves the previous version good (Orbax's finalize protocol does the
  same);
- ``save`` is collective at world > 1: the planner puts every replicated
  tensor on rank 0 (``dedup_save_to_lowest_rank``), so rank 0's directory
  holds the whole version, and rank 0 renames. A rank whose directory is
  not rank 0's (another pod's local tier) removes its empty leftovers;
- keys are names, not positions: parameter names carry no
  data-parallel ``module.`` prefix and the optimizer state is keyed by
  parameter name (``torch.distributed.checkpoint.state_dict``), so a
  version saved at world 2 loads at world 1. The optimizer's step counts
  and moments are restored; its hyper-parameters stay what the factory
  set for the new world (a re-scaled learning rate survives the restore).
  Every rank loads the whole version itself (``no_dist``): the state is
  replicated, and a rank never waits in a collective on a peer whose
  tiers held something else;
- ``restore`` walks the versions newest first, falls back past
  unreadable ones and quarantines them (``<step>.corrupt``);
- retention keeps the newest ``max_to_keep`` versions.

**Sharded states** (FSDP2's ``DTensor`` parameters and optimizer state,
``parallel.shard_params_fsdp``). Every rank writes its own shards; the
planner's dedup drops only the copies that ``dp`` replicas hold. In a
shared directory the version is whole as before. In pod-local dirs each
pod's dir keeps its ranks' files, with rank 0's metadata (sent to every
rank) and the status: a partial version, whose metadata names every
file (:func:`version_files`). A restore into a sharded template is a
collective DCP load over the checkpoint group, onto whatever fsdp size
the stage has (DCP reshards). Before it the ranks agree on the newest
step every one of them can make readable — a complete local version,
the local part plus the other pods' parts from the peer replicas, or
the durable copy (which every pod's mirror fills) — so that no rank
waits in the load on a peer that holds another step; a failed load drops
the step for all of them and quarantines it. A whole template restores a
sharded version too (a resize to one rank without a group), through the
same tiers.

**Async saves** (``async_save=True``). ``save`` stages the state off the
live tensors into a host copy it keeps between saves (pinned on the card)
before it returns, so the next optimizer step may update the parameters
and moments in place. DCP's ``async_save`` writes that copy on a thread;
at world > 1 its collectives run over the checkpoint group
(``train.context.checkpoint_group``, gloo), never over the default group
that DDP's all-reduces use. A thread of the manager's own finalizes the
version (status, rename, retention) once the write resolves, then
notifies the replicator. A save that starts while the previous one is in
flight first waits for it, as Orbax does. The ``ckpt_save`` goodput phase
and ``edl_ckpt_save_seconds`` cover the blocking part only.

**Tiers** (the JAX package's DESIGN.md "Checkpoint tiers & peer
replication"). With ``local_dir`` set (or ``EDL_CKPT_LOCAL_DIR``, which the
launcher derives per pod from ``EDL_CKPT_LOCAL_BASE``), saves land in the
pod-local tier and ``path`` demotes to the durable backstop
(``durable_path``). On rank 0 of the pod a
:class:`~edl_tpu_torch.checkpoint.replicate.Replicator` pushes every
finalized step to K ring-successor peers' holders (the launchers'
``ReplicaServer``) and mirrors it into the durable tier. ``restore`` walks
the ladder freshness first: local, peer replicas (assembled from the
``ckpt/replicas/`` manifests), durable. Each restore is labelled with its
tier (``edl_ckpt_restores_total{tier}``, goodput ``ckpt_restore{cause}``,
the flight record's ``tier``, the ``ckpt_restore`` trace segment).

The bytes are DCP's, not Orbax's: a checkpoint of the JAX package does not
load here, nor the other way round; the replica plane moves either.
``emergency_save`` is the drain notice's bounded save (the trainer's
``_drain_exit``), ``emergency_replicate`` the per-pod push of a draining
pod of a multi-pod stage.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import goodput as obs_goodput
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import numerics as obs_numerics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("checkpoint.manager")

_FP_SAVE = _fault_point(
    "ckpt.save",
    "before a checkpoint save: kill (crash mid-save -> torn temp dirs, "
    "the finalize protocol must keep the previous version good) or delay",
)
_FP_RESTORE = _fault_point(
    "ckpt.restore", "before a checkpoint restore: delay (slow storage)"
)
_FP_EMERGENCY = _fault_point(
    "ckpt.emergency",
    "before an emergency (drain-notice) checkpoint: delay (slow storage "
    "eats the drain budget) or kill (preemption lands mid-save; the torn "
    "version must quarantine on restore)",
)

_M_SAVE_SECONDS = obs_metrics.histogram(
    "edl_ckpt_save_seconds", "checkpoint save blocking time"
)
_M_RESTORE_SECONDS = obs_metrics.histogram(
    "edl_ckpt_restore_seconds", "checkpoint restore time"
)
_M_SAVES = obs_metrics.counter("edl_ckpt_saves_total", "checkpoints saved")
_M_RESTORES = obs_metrics.counter(
    "edl_ckpt_restores_total",
    "checkpoints restored, by source tier (local/peer/durable)",
)
_M_SAVE_BYTES = obs_metrics.counter(
    "edl_ckpt_save_bytes_total", "logical array bytes written to checkpoints"
)
_M_RESTORE_BYTES = obs_metrics.counter(
    "edl_ckpt_restore_bytes_total", "logical array bytes restored from checkpoints"
)
_M_SAVE_SIZE = obs_metrics.histogram(
    "edl_ckpt_save_size_bytes", "logical size of each saved checkpoint",
    buckets=obs_metrics.SIZE_BUCKETS,
)
_M_EMERGENCY_SECONDS = obs_metrics.histogram(
    "edl_train_emergency_ckpt_seconds",
    "wall time of drain-notice emergency checkpoints (save + bounded wait)",
)
_M_EMERGENCY = obs_metrics.counter(
    "edl_ckpt_emergency_saves_total",
    "emergency checkpoint actions on a drain notice, by outcome "
    "(skipped/failed/finished/unfinished/replicated/replicate_failed)",
)
_M_RESTORE_FALLBACKS = obs_metrics.counter(
    "edl_ckpt_restore_fallbacks_total",
    "unreadable checkpoint versions skipped during restore",
)

STATUS_FILE = "status.json"
# a DCP file crosses the replica wire whole (one ckpt_push / ckpt_fetch
# frame, at most rpc.wire.MAX_FRAME = 512 MiB), so a version is written
# as files of about this size, one writer thread each
_FILE_BYTES = 128 << 20
_MAX_WRITERS = 16
# DCP names its metadata ``.metadata``, and the replica plane moves no
# dot-file (``replicate._safe_relpath``): every version also carries it
# under this name, and a version landed from a peer or the durable mirror
# gets its ``.metadata`` back before it loads
METADATA_TWIN = "dcp.metadata"


@dataclasses.dataclass
class TrainStatus:
    """Progress metadata carried inside every checkpoint."""

    epoch: int = -1
    step: int = 0
    world_size: int = 1
    sample_offset: int = 0  # samples consumed within the current epoch
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def next_epoch(self) -> int:
        return self.epoch + 1

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrainStatus":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def _is_rank0() -> bool:
    return not _joined() or dist.get_rank() == 0


def _barrier() -> None:
    if not _joined() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _pod_leader() -> bool:
    """Rank 0 of this pod: the rank that finalizes, lands and quarantines
    versions in the pod's local dir, which the pod's ranks share."""
    try:
        return int(os.environ.get("EDL_WORKER_RANK_IN_POD", "0") or 0) == 0
    except ValueError:
        return True


def _sharded(state) -> bool:
    """True when ``state`` holds ``DTensor`` shards (an FSDP-sharded
    module, or a ``name -> tensor`` dict of them): each rank holds part
    of the version, so saves keep every rank's files and loads are
    collective."""
    from torch.distributed.tensor import DTensor

    if isinstance(state, dict):
        tensors = state.values()
    else:
        tensors = state.apply_fn.parameters()
    return any(isinstance(t, DTensor) for t in tensors)


def _gather(obj) -> List[Any]:
    """Every rank's ``obj`` over the checkpoint group (collective); the
    one-rank list without a group."""
    if not _joined() or dist.get_world_size() == 1:
        return [obj]
    from edl_tpu_torch.train import context as _ctx

    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=_ctx.checkpoint_group())
    return out


def _metadata_file(step_dir: str) -> Optional[str]:
    """DCP's ``.metadata`` of a version, put back from its twin when the
    replica plane or a mirror landed the version; None without either."""
    meta = os.path.join(step_dir, ".metadata")
    twin = os.path.join(step_dir, METADATA_TWIN)
    if not os.path.exists(meta) and os.path.exists(twin):
        try:
            _link_or_copy(twin, meta)
        except OSError:
            return None
    return meta if os.path.exists(meta) else None


def version_files(step_dir: str) -> Optional[set]:
    """Every file a version needs: the DCP files its metadata names, the
    metadata's twin and ``status.json``; None when the metadata is
    missing or unreadable. Under shards each pod's local dir holds its
    own ranks' files, so a version there may be partial."""
    import torch.distributed.checkpoint as dcp

    if _metadata_file(step_dir) is None:
        return None
    try:
        md = dcp.FileSystemReader(step_dir).read_metadata()
        names = {info.relative_path for info in md.storage_data.values()}
    except Exception:  # noqa: BLE001 — a torn metadata file: no version
        return None
    return names | {METADATA_TWIN, STATUS_FILE}


def _candidate(step_dir: str) -> bool:
    """A version to try: complete, or torn (its metadata unreadable: the
    load fails and quarantines it). A partial one, whose metadata names
    files that other pods hold, is not."""
    need = version_files(step_dir)
    return need is None or all(
        os.path.exists(os.path.join(step_dir, n)) for n in need)


def _state_dict(state) -> Dict[str, Any]:
    """The DCP view of a ``TrainState``: name-keyed model and optimizer
    state (live tensors, no copies), the step and the optimizer's update
    count. Building it initialises a fresh optimizer's state (a zero-lr
    step over zero gradients), so it can serve as a restore template. A
    plain ``name -> tensor`` dict (the chaos trainee's state) is saved
    and loaded as it is."""
    if isinstance(state, dict):
        return {"tensors": dict(state)}
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.apply_fn, state.opt_state.optimizer)
    return {
        "model": model_sd,
        "optim": optim_sd,
        "step": state.step,
        "count": torch.tensor(state.opt_state.count, dtype=torch.int64),
    }


def _apply(state, sd: Dict[str, Any], count: int) -> None:
    """Load the DCP view ``sd`` (as :func:`_state_dict` built it, now
    holding restored values) into the ``TrainState``: the module's
    parameters and the optimizer's state. The hyper-parameters stay this
    world's (the factory set them from the adjust registry)."""
    from torch.distributed.checkpoint.state_dict import set_state_dict

    optimizer = state.opt_state.optimizer
    hyper = [{k: v for k, v in g.items() if k != "params"}
             for g in optimizer.param_groups]
    set_state_dict(state.apply_fn, optimizer,
                   model_state_dict=sd["model"], optim_state_dict=sd["optim"])
    for group, keep in zip(optimizer.param_groups, hyper):
        group.update(keep)
    with torch.no_grad():
        state.step.copy_(sd["step"])
    state.opt_state.count = count


def _sd_bytes(sd) -> int:
    if torch.is_tensor(sd):
        return sd.numel() * sd.element_size()
    if isinstance(sd, dict):
        return sum(_sd_bytes(v) for v in sd.values())
    if isinstance(sd, (list, tuple)):
        return sum(_sd_bytes(v) for v in sd)
    return 0


def _stage(sd, cache: Dict[tuple, torch.Tensor], key: tuple = ()):
    """A host copy of the state dict ``sd`` that later in-place updates of
    its tensors do not reach. Tensors land in ``cache``'s buffers (keyed
    by their path in ``sd``; pinned when the tensor is on the card, so the
    device-to-host copies run asynchronously until one synchronise), which
    the next save reuses; everything else is deep-copied. A ``DTensor``'s
    local shard is copied, and the copy keeps its placement (the DCP
    writer needs where the shard sits in the whole tensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(sd, DTensor):
        local = _stage(sd.to_local(), cache, key)
        return DTensor(local, sd._spec, requires_grad=False)
    if torch.is_tensor(sd):
        buf = cache.get(key)
        if buf is None or buf.shape != sd.shape or buf.dtype != sd.dtype:
            buf = torch.empty(sd.shape, dtype=sd.dtype, device="cpu",
                              pin_memory=sd.is_cuda)
            cache[key] = buf
        buf.copy_(sd.detach(), non_blocking=sd.is_cuda)
        return buf
    if isinstance(sd, dict):
        return {k: _stage(v, cache, key + (k,)) for k, v in sd.items()}
    if isinstance(sd, list):
        return [_stage(v, cache, key + (i,)) for i, v in enumerate(sd)]
    return copy.deepcopy(sd)


def _passthrough_stager():
    """DCP's stager for a state the manager staged itself: handed on as
    it is, so ``async_save`` makes no second host copy."""
    from torch.distributed.checkpoint.staging import AsyncStager

    class _Staged(AsyncStager):
        _synchronize_after_execute = False

        def stage(self, state_dict):
            return state_dict

    return _Staged()


@contextlib.contextmanager
def _dcp_call():
    """Around a DCP save or load: silence its notice that it runs in one
    process (a one-worker stage has no process group by design)."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        warnings.filterwarnings(
            "ignore", message=".*torch.distributed is unavailable")
        yield


def _link_or_copy(src: str, dst: str) -> None:
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _InFlight:
    """One async save between ``save`` returning and its finalize: set
    ``done`` once a thread of the manager's has waited for DCP's write and
    finalized the version (``ok``), with the seconds each took."""

    def __init__(self, step: int) -> None:
        self.step = step
        self.done = threading.Event()
        self.ok = False
        self.t_start = time.monotonic()
        self.write_s: Optional[float] = None
        self.finalize_s: Optional[float] = None


class CheckpointManager:
    """Step-versioned checkpoints of a ``TrainState`` with retention and,
    when a pod-local tier is armed, the tier ladder.

    A missing or empty directory restores to ``(template, None)``, so a
    first launch and a resume share one code path — mirroring the
    reference's ``load_check_point`` returning a fresh ``TrainStatus``
    when no checkpoint exists (train_with_fleet.py:428). Without a local
    tier, ``path`` is the single durable tier (restores labelled
    ``tier="durable"``)."""

    def __init__(
        self,
        path: str,
        max_to_keep: int = 3,
        async_save: bool = False,
        local_dir: Optional[str] = None,
    ) -> None:
        if local_dir is None:
            local_dir = os.environ.get("EDL_CKPT_LOCAL_DIR", "")
        path = os.path.abspath(os.fspath(path))
        if local_dir:
            self.path = os.path.abspath(os.fspath(local_dir))
            self.durable_path: Optional[str] = path
            self._tier = "local"
        else:
            self.path = path
            self.durable_path = None
            self._tier = "durable"
        self.max_to_keep = max_to_keep
        self._async = async_save
        os.makedirs(self.path, exist_ok=True)
        self._staging: Dict[tuple, torch.Tensor] = {}
        self._inflight: Optional[_InFlight] = None
        # the saver-side replication plane (peer push + durable mirror);
        # None unless the local tier is armed, and on rank 0 of the pod
        self._replicator = None
        if self.durable_path is not None:
            from edl_tpu_torch.checkpoint import replicate as _replicate

            self._replicator = _replicate.make_replicator(
                self.path, durable_path=self.durable_path
            )

    # -- save --------------------------------------------------------------

    def save(self, state, status: TrainStatus, step: Optional[int] = None) -> int:
        """Write ``state`` as version ``step`` (default ``status.step``);
        collective at world > 1. Raises ``FileExistsError`` if that
        version exists. Async: returns once the state is staged; the
        version appears when its write has finalized."""
        import torch.distributed.checkpoint as dcp
        from torch.distributed.checkpoint.default_planner import (
            DefaultSavePlanner,
        )

        if step is None:
            step = int(status.step)
        if _FP_SAVE.armed:
            _FP_SAVE.fire(step=step)
        t0 = time.monotonic()
        final = os.path.join(self.path, str(step))
        tmp = os.path.join(self.path, ".tmp-%d" % step)
        # goodput: the BLOCKING part of the save is checkpoint cost, not
        # train time (an async save returns once its state is staged)
        with obs_trace.child_span("ckpt_save", step=str(step)), \
                obs_goodput.phase("ckpt_save"):
            wait_prev = self._join()
            if os.path.exists(final):
                raise FileExistsError("checkpoint step %d exists: %s" % (step, final))
            t_stamp = time.monotonic()
            status_doc = status.to_dict()
            try:
                # resize continuity sentinel: the status carries a
                # {step, loss, param_norm} numerics fingerprint, which
                # restore re-derives (quarantining mismatches)
                status_doc = obs_numerics.stamp_fingerprint(status_doc, state, step)
            except Exception as exc:  # noqa: BLE001 — the stamp must never fail a save
                logger.warning("numerics fingerprint stamp failed: %s", exc)
            t_stage = time.monotonic()
            sharded = _sharded(state)
            # under shards every pod's local dir keeps its ranks' files;
            # else rank 0's dir holds the version
            pods = sharded and self.durable_path is not None
            sd = _state_dict(state)
            nbytes = _sd_bytes(sd)
            if self._async:
                with torch.no_grad():
                    sd = _stage(sd, self._staging)
                if torch.cuda.is_available() and torch.cuda.is_initialized():
                    torch.cuda.synchronize()
            stage_s = time.monotonic() - t_stage
            if _pod_leader() if pods else _is_rank0():
                shutil.rmtree(tmp, ignore_errors=True)  # a torn earlier try
            _barrier()
            writer = dcp.FileSystemWriter(
                tmp, thread_count=max(1, min(_MAX_WRITERS,
                                             -(-nbytes // _FILE_BYTES))))
            planner = DefaultSavePlanner(dedup_save_to_lowest_rank=True)
            if self._async:
                from edl_tpu_torch.train import context as _ctx

                with _dcp_call():
                    fut = dcp.async_save(
                        sd, storage_writer=writer, planner=planner,
                        process_group=_ctx.checkpoint_group(),
                        no_dist=not _joined(),
                        async_stager=_passthrough_stager(),
                    )
                fut = getattr(fut, "upload_completion", fut)
                self._inflight = _InFlight(step)
                threading.Thread(
                    target=self._finalize_when_written,
                    args=(self._inflight, fut, tmp, final, status_doc, pods),
                    name="edl-ckpt-finalize", daemon=True,
                ).start()
            else:
                with _dcp_call():
                    dcp.save(sd, storage_writer=writer, planner=planner,
                             no_dist=not _joined())
                self._finalize(step, tmp, final, status_doc, pods)
                _barrier()
            dt = time.monotonic() - t0
            _M_SAVE_SECONDS.observe(dt)
            _M_SAVES.inc()
            _M_SAVE_BYTES.inc(nbytes)
            _M_SAVE_SIZE.observe(nbytes)
            # the blocking seconds, and apart: the wait on the previous
            # save, the fingerprint stamp, the staging
            obs_events.record(
                "ckpt_save", step=step, seconds=round(dt, 4), bytes=nbytes,
                wait_prev_s=round(wait_prev, 4), stage_s=round(stage_s, 4),
                stamp_s=round(t_stage - t_stamp, 4),
            )
        if not self._async and self._replicator is not None and \
                (pods or _is_rank0()):
            self._replicator.note_save(step)
        return step

    def _finalize(self, step: int, tmp: str, final: str, status_doc,
                  pods: bool = False) -> None:
        """Rank 0: status, fsync, rename, retention. Another rank removes
        its own directory's leftovers when that directory is not rank 0's
        (every rank's write has resolved after rank 0 wrote DCP's
        ``.metadata``, so a shared directory always shows it).

        With ``pods`` (a sharded state in pod-local dirs) every pod's dir
        keeps its ranks' DCP files: rank 0's ``.metadata`` goes to every
        rank over the checkpoint group (collective), and each pod's leader
        finalizes its dir as a partial version that names every file."""
        if pods:
            meta = None
            if _is_rank0():
                with open(os.path.join(tmp, ".metadata"), "rb") as fh:
                    meta = fh.read()
            if _joined() and dist.get_world_size() > 1:
                from edl_tpu_torch.train import context as _ctx

                box = [meta]
                dist.broadcast_object_list(
                    box, src=0, group=_ctx.checkpoint_group())
                meta = box[0]
            if not _pod_leader():
                return
            os.makedirs(tmp, exist_ok=True)  # a pod whose ranks wrote nothing
            path = os.path.join(tmp, ".metadata")
            if not os.path.exists(path):
                with open(path + ".part", "wb") as fh:
                    fh.write(meta)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(path + ".part", path)
        elif not _is_rank0():
            if os.path.isdir(tmp) and not os.path.exists(
                    os.path.join(tmp, ".metadata")):
                shutil.rmtree(tmp, ignore_errors=True)
            return
        _link_or_copy(os.path.join(tmp, ".metadata"),
                      os.path.join(tmp, METADATA_TWIN))
        with open(os.path.join(tmp, STATUS_FILE), "w") as fh:
            json.dump(status_doc, fh)
            fh.flush()
            os.fsync(fh.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, final)
        _fsync_dir(self.path)
        self._retain()

    def _finalize_when_written(self, pending: _InFlight, fut, tmp, final,
                               status_doc, pods: bool = False) -> None:
        try:
            fut.result()
            pending.write_s = time.monotonic() - pending.t_start
            t0 = time.monotonic()
            self._finalize(pending.step, tmp, final, status_doc, pods)
            pending.finalize_s = time.monotonic() - t0
            pending.ok = True
            if self._replicator is not None and (pods or _is_rank0()):
                # replicates while the job trains, not at its last wait()
                self._replicator.note_save(pending.step)
        except Exception as exc:  # noqa: BLE001 — a failed write leaves the
            # previous version good; the torn temp dir is never a step
            logger.warning("async checkpoint at step %d failed: %s",
                           pending.step, exc)
        finally:
            obs_events.record(
                "ckpt_finalize", fsync=True, step=pending.step, ok=pending.ok,
                write_s=round(pending.write_s or 0.0, 4),
                finalize_s=round(pending.finalize_s or 0.0, 4),
            )
            pending.done.set()

    def _join(self, timeout: Optional[float] = None) -> float:
        """Wait for the in-flight async save (if any) to finalize; the
        seconds waited. A timeout leaves it in flight."""
        pending = self._inflight
        if pending is None:
            return 0.0
        t0 = time.monotonic()
        if not pending.done.wait(timeout):
            return time.monotonic() - t0
        self._inflight = None
        return time.monotonic() - t0

    def _retain(self) -> None:
        if not self.max_to_keep:
            return  # keep every version
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.path, str(s)), ignore_errors=True)

    def wait(self) -> None:
        """Block until the in-flight save (if any) has finalized (its
        finalize notified the replicator)."""
        self._join()

    def _wait_within(self, timeout_s: float) -> bool:
        """``wait()`` bounded by a timeout: True when nothing is left in
        flight and the newest save finalized. On timeout the write goes on
        in the background — the caller exits anyway, and restore-side
        fallback owns the torn-version case."""
        pending = self._inflight
        if pending is None:
            return True
        self._join(max(0.0, timeout_s))
        return pending.done.is_set() and pending.ok

    def emergency_save(
        self, state, status: TrainStatus, budget_s: float,
        step: Optional[int] = None,
    ) -> Tuple[Optional[int], bool]:
        """Best-effort checkpoint on a preemption notice, bounded by
        ``budget_s``: rides the normal (possibly async) save, then waits
        for its finalize only as long as the budget allows. Returns
        ``(step, finished)``; ``finished=False`` means the save may still
        be in flight when the process exits — a torn version is what the
        restore-side quarantine absorbs, so an unfinished emergency save
        degrades to the previous periodic checkpoint. A failed save
        returns ``(None, False)``: a failed emergency save must never turn
        the drain into a crash.

        A step already covered by the newest finalized version (or by the
        save in flight) is not saved again and reported as
        ``(that step, finished)``.
        """
        if step is None:
            step = int(status.step)
        t0 = time.monotonic()
        pending = self._inflight
        if pending is not None and step <= pending.step:
            _M_EMERGENCY.inc(outcome="skipped")
            return pending.step, self._wait_within(budget_s)
        latest = self.latest_step()
        if latest is not None and step <= latest:
            _M_EMERGENCY.inc(outcome="skipped")
            return latest, True
        if _FP_EMERGENCY.armed:
            _FP_EMERGENCY.fire(step=step)
        with obs_goodput.phase("ckpt_save", cause="emergency"):
            try:
                self.save(state, status, step=step)
            except Exception as exc:  # noqa: BLE001 — see the docstring
                logger.warning(
                    "emergency checkpoint at step %d failed: %s", step, exc)
                _M_EMERGENCY.inc(outcome="failed")
                _M_EMERGENCY_SECONDS.observe(time.monotonic() - t0)
                obs_events.record(
                    "ckpt_emergency", fsync=True, step=step, outcome="failed"
                )
                return None, False
            remaining = budget_s - (time.monotonic() - t0)
            finished = self._wait_within(remaining)
        dt = time.monotonic() - t0
        _M_EMERGENCY_SECONDS.observe(dt)
        _M_EMERGENCY.inc(outcome="finished" if finished else "unfinished")
        obs_trace.get_tracer().instant(
            "ckpt_emergency", step=str(step), finished=str(finished).lower(),
        )
        obs_events.record(
            "ckpt_emergency", fsync=True, step=step,
            outcome="finished" if finished else "unfinished",
            seconds=round(dt, 4), budget_s=budget_s,
        )
        logger.info(
            "emergency checkpoint at step %d %s in %.2fs (budget %.1fs)",
            step, "finalized" if finished else "still in flight", dt, budget_s,
        )
        return step, finished

    def emergency_replicate(self, budget_s: float) -> bool:
        """Per-pod, NON-COLLECTIVE emergency durability: push the newest
        finalized local step to peer holders inside ``budget_s``.

        A single draining pod of a multi-pod stage cannot run
        :meth:`emergency_save` (DCP saves are collective — its peers will
        never join), but it can make the versions it already holds
        survive its departure: a replica push needs nobody's cooperation
        but one peer's. Returns True when at least one peer acked a
        complete copy."""
        if self._replicator is None or not self._replicator.peers_armed:
            return False  # mirror-only configs have no peers to push to
        t0 = time.monotonic()
        if self._async:
            # a save may still be finalizing: give it half the budget so
            # the NEWEST version is what survives (flush pushes the
            # newest finalized one)
            self._wait_within(max(0.0, budget_s * 0.5))
        ok = self._replicator.flush(
            max(0.5, budget_s - (time.monotonic() - t0))
        )
        _M_EMERGENCY.inc(outcome="replicated" if ok else "replicate_failed")
        obs_events.record(
            "ckpt_emergency_repl", fsync=True,
            outcome="ok" if ok else "failed",
            seconds=round(time.monotonic() - t0, 4), budget_s=budget_s,
        )
        logger.info(
            "emergency replication %s in %.2fs (budget %.1fs)",
            "complete" if ok else "FAILED", time.monotonic() - t0, budget_s,
        )
        return ok

    # -- restore -----------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return []
        return sorted(
            int(n) for n in names
            if n.isdigit() and os.path.isdir(os.path.join(self.path, n))
        )

    def _candidates(self, step: Optional[int]) -> list:
        """Versions to try, newest first. An explicit ``step`` pins the
        list to that one version (the caller asked for it specifically)."""
        if step is not None:
            return [step]
        return sorted(self.all_steps(), reverse=True)

    def _read_status(self, step: int) -> TrainStatus:
        with open(os.path.join(self.path, str(step), STATUS_FILE)) as fh:
            return TrainStatus.from_dict(json.load(fh))

    def read_status(self, step: Optional[int] = None) -> Optional[TrainStatus]:
        """Read the latest TrainStatus of the primary tier WITHOUT
        restoring model state — cheap (json only), for decisions that must
        happen before the optimizer/state exist (e.g. status-aware
        hyper-parameter adjustment on resume). Unreadable versions fall
        back like :meth:`restore`."""
        candidates = self._candidates(step)
        if not candidates:
            return None
        last_exc: Optional[Exception] = None
        for s in candidates:
            try:
                return self._read_status(s)
            except Exception as exc:  # noqa: BLE001 — any torn version falls back
                last_exc = exc
                if step is None:
                    _M_RESTORE_FALLBACKS.inc()
                    logger.warning(
                        "checkpoint status at step %d unreadable (%s); "
                        "falling back to the previous version", s, exc,
                    )
        raise last_exc

    def _load(self, template, step: int) -> Tuple[TrainStatus, int]:
        """Load version ``step`` into ``template`` in place; its status
        and the bytes loaded."""
        import torch.distributed.checkpoint as dcp

        status = self._read_status(step)
        step_dir = os.path.join(self.path, str(step))
        _metadata_file(step_dir)  # landed by the replica plane: put it back
        sd = _state_dict(template)
        from torch.distributed.checkpoint.api import CheckpointException

        # a sharded template loads collectively: each rank reads the parts
        # of the version its shards cover, whatever sharding wrote them
        # (DCP reshards); a whole one loads alone
        collective = _joined() and _sharded(template)
        group = None
        if collective:
            from edl_tpu_torch.train import context as _ctx

            group = _ctx.checkpoint_group()
        try:
            with _dcp_call():
                dcp.load(sd, storage_reader=dcp.FileSystemReader(step_dir),
                         process_group=group, no_dist=not collective)
        except CheckpointException as exc:
            # DCP's error is a BaseException: as such it would pass every
            # fallback of the ladder and take the job down on one torn file
            raise RuntimeError("DCP load of step %d failed: %s"
                               % (step, exc)) from exc
        if not isinstance(template, dict):  # a dict loaded in place
            _apply(template, sd, int(sd["count"]))
        return status, _sd_bytes(sd)

    def restore(
        self, template, step: Optional[int] = None
    ) -> Tuple[Any, Optional[TrainStatus]]:
        """Restore into ``template`` (a ``TrainState`` built for the new
        world, or a ``name -> tensor`` dict; changed in place);
        ``(template, None)`` when every tier is empty.

        A torn/corrupt newest version (crash mid-write, bad disk) must not
        take the job down when an older good version exists: with no
        explicit ``step``, unreadable versions — and versions whose
        numerics fingerprint does not match what they hold — are skipped
        newest-to-oldest with a warning (counted in
        ``edl_ckpt_restore_fallbacks_total``) and quarantined.

        With a local tier armed, restore walks the TIER LADDER, freshness
        first: candidate steps are gathered from the local dir, the PEER
        replicas advertised in ``ckpt/replicas/`` manifests (the union of
        every source pod's, with the local files) and the DURABLE
        backstop, then tried newest step first with ties preferring the
        cheapest read (local → peer → durable). Missing files are fetched
        or copied into the local tier (digest-verified, merged with the
        local ones, atomic step-dir rename); a landed version that still
        fails DCP's load or its fingerprint is quarantined like any torn
        version and the walk goes on. Only when every tier is exhausted
        does the last error propagate. An explicit ``step`` pins the
        restore to the primary tier. A sharded template restores through
        :meth:`_restore_sharded` (the ranks agree on the step first)."""
        self._join()
        candidates = self._candidates(step)
        if _FP_RESTORE.armed and (candidates or self.durable_path):
            _FP_RESTORE.fire(step=candidates[0] if candidates else -1)
        if step is None and _sharded(template):
            return self._restore_sharded(template)
        last_exc: List[Optional[Exception]] = [None]
        bad: list = []
        if step is not None:
            out = self._try_candidates(
                template, candidates, True, self._tier, last_exc, bad
            )
            if out is not None:
                return out
            raise last_exc[0]
        if self.durable_path is None:
            # the single durable tier: rank 0 quarantines for every rank
            out = self._try_candidates(
                template, candidates, False, self._tier, last_exc, bad
            )
            if out is not None:
                return out
            if last_exc[0] is not None:
                raise last_exc[0]
            return template, None
        return self._restore_ladder(template, last_exc, bad)

    def _restore_ladder(
        self, template, last_exc, bad
    ) -> Tuple[Any, Optional[TrainStatus]]:
        """Freshness-FIRST tier walk: candidate steps are gathered from
        every tier and tried newest step first regardless of tier (a
        stale peer replica must never shadow a newer durable version —
        e.g. a push that failed while the background mirror landed);
        ties prefer the cheapest read: local → peer → durable. Each rank
        walks its own pod's tiers and quarantines in its own local dir."""
        client = self._peer_client()
        try:
            for s, tier, how in self._tier_plan(set(), client):
                t0 = time.monotonic()
                if not self._land(s, tier, how):
                    continue
                out = self._try_candidates(
                    template, [s], False, tier, last_exc, bad,
                    land_s=time.monotonic() - t0,
                )
                if out is not None:
                    return out
                if bad:
                    # quarantine NOW: the same step may exist in the next
                    # tier, and the torn copy must not squat on its name
                    # (nor shadow it as latest_step for future saves)
                    self._purge(bad, shared=False)
                    bad[:] = []
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass
        if last_exc[0] is not None:
            raise last_exc[0]
        return template, None

    # -- restore of a sharded state --------------------------------------

    def _restore_sharded(self, template) -> Tuple[Any, Optional[TrainStatus]]:
        """The ladder for a sharded template, whose load is collective: no
        rank may wait in it on a peer that holds another step. So the ranks
        first agree on the newest step every one of them can make readable
        (its pod's local dir, the peer replicas, the durable tier, freshness
        first and the cheapest tier for it), land it, check that every rank
        did, then load it together; a failed landing or load (torn file,
        fingerprint) drops that step for all and the walk goes on."""
        tried: set = set()
        last_exc: List[Optional[Exception]] = [None]
        client = self._peer_client()
        try:
            while True:
                plan: Dict[int, Tuple[str, Any]] = {}
                for s, tier, how in self._tier_plan(tried, client):
                    plan.setdefault(s, (tier, how))
                common = set.intersection(*(set(p) for p in _gather(
                    sorted(plan))))
                if not common:
                    break
                step = max(common)
                tier, how = plan[step]
                t0 = time.monotonic()
                landed = self._land(step, tier, how) if _pod_leader() else True
                if not all(_gather(landed)):
                    tried.add(step)
                    continue
                bad: list = []
                out = self._try_candidates(
                    template, [step], False, tier, last_exc, bad,
                    land_s=time.monotonic() - t0)
                if out is not None:
                    return out
                # every rank saw the load fail: quarantine the copy (rank 0
                # in a shared dir, the pod's leader in its local dir)
                if self.durable_path is None:
                    self._purge(bad, shared=True)
                elif _pod_leader():
                    self._purge(bad, shared=False)
                tried.add(step)
        finally:
            if client is not None:
                try:
                    client.close()
                except Exception:  # noqa: BLE001
                    pass
        if last_exc[0] is not None:
            raise last_exc[0]
        return template, None

    def _peer_client(self):
        """ONE store client for a whole walk of the ladder: recovery is when
        the control plane is most likely degraded, and per-attempt 5 s
        connects would eat the downtime budget; None without a peer tier."""
        if not self._peer_tier_enabled():
            return None
        try:
            from edl_tpu_torch.store.client import connect_store

            return connect_store(os.environ.get("EDL_STORE_ENDPOINT", ""),
                                 timeout=5.0)
        except Exception as exc:  # noqa: BLE001 — a tier, not a gate
            logger.warning("peer-tier peek failed: %s", exc)
            return None

    def _tier_plan(self, tried: set, client) -> List[Tuple[int, str, Any]]:
        """``[(step, tier, how)]`` this rank can make readable in its
        primary dir, newest step first, ties cheapest first: a complete
        version in the primary dir; the peer replicas that cover a version
        with the local files (``how``: the files to fetch; a sharded
        version's files are spread over its pods); a complete durable
        copy. A partial version (another pod's shards missing) is no
        candidate by itself, and never torn."""
        from edl_tpu_torch.checkpoint import replicate as _replicate

        rank = {self._tier: 0, "peer": 1, "durable": 2}
        plan = [(s, self._tier, None) for s in self.all_steps()
                if _candidate(os.path.join(self.path, str(s)))]
        if self.durable_path is not None:
            if client is not None:
                try:
                    plan += [(s, "peer", how) for s, how in
                             self._peer_shards(client).items()]
                except Exception as exc:  # noqa: BLE001 — a tier, not a gate
                    logger.warning("peer-tier peek failed: %s", exc)
            plan += [(s, "durable", None) for s in
                     _replicate.finalized_steps(self.durable_path)
                     if _candidate(os.path.join(self.durable_path, str(s)))]
        return sorted((e for e in plan if e[0] not in tried),
                      key=lambda e: (-e[0], rank[e[1]]))

    def _peer_shards(self, client) -> Dict[int, Dict[str, Any]]:
        """The steps whose files the peer replicas (every source pod's,
        one save's: the same metadata digest) cover together with this
        pod's local files: ``{step: {name: (sha, [(endpoint, src)])}}``
        for the files to fetch."""
        from edl_tpu_torch.checkpoint import replicate as _replicate

        out: Dict[int, Dict[str, Any]] = {}
        by_step = _replicate.replicas_by_step(
            _replicate.read_replica_manifests(
                client, os.environ.get("EDL_JOB_ID", "")))
        for s, replicas in sorted(by_step.items(), reverse=True):
            local_dir = os.path.join(self.path, str(s))
            local_sha = _replicate.file_sha(
                os.path.join(local_dir, METADATA_TWIN))
            saves: Dict[str, list] = {}
            for endpoint, src, files in replicas:
                sha = (files.get(METADATA_TWIN) or {}).get("sha")
                if sha:
                    saves.setdefault(sha, []).append((endpoint, src, files))
            for sha, group in saves.items():
                if local_sha == sha:
                    need = version_files(local_dir)
                else:
                    need = self._fetched_version_files(s, group)
                have = set(os.listdir(local_dir)) if local_sha == sha else set()
                fetch: Dict[str, Any] = {}
                for endpoint, src, files in group:
                    for name, meta in files.items():
                        # an unreadable metadata: the holders' files are
                        # the version, torn (its load quarantines it)
                        if (need is None or name in need) and name not in have:
                            fetch.setdefault(name, (meta.get("sha"), []))[
                                1].append((endpoint, src))
                if need is None or need <= have | set(fetch):
                    out[s] = fetch
                    break
        return out

    def _fetched_version_files(self, step: int, group) -> Optional[set]:
        """:func:`version_files` of a version this pod holds none of: its
        metadata from a holder, read in a scratch dir."""
        from edl_tpu_torch.checkpoint import replicate as _replicate

        endpoint, src, files = group[0]
        want = {METADATA_TWIN: ((files.get(METADATA_TWIN) or {}).get("sha"),
                                [(endpoint, src)])}
        scratch = os.path.join(self.path, ".meta-%d-%d" % (step, os.getpid()))
        try:
            if not _replicate.fetch_files(scratch, step, want):
                return None
            return version_files(scratch)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)

    def _land(self, step: int, tier: str, how) -> bool:
        """Make version ``step`` complete in the primary dir from ``tier``:
        nothing to do for the primary tier; the missing files from the
        peer replicas (``how``) or from the durable copy otherwise, merged
        with the local ones in a scratch dir that replaces the step's dir
        by rename."""
        if tier == self._tier:
            return True
        from edl_tpu_torch.checkpoint import replicate as _replicate

        dst = os.path.join(self.path, str(step))
        tmp = os.path.join(self.path, ".land-%d-%d" % (step, os.getpid()))
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            os.makedirs(tmp)
            if os.path.isdir(dst):
                for name in os.listdir(dst):
                    if os.path.isfile(os.path.join(dst, name)):
                        _link_or_copy(os.path.join(dst, name),
                                      os.path.join(tmp, name))
            if tier == "peer":
                ok = _replicate.fetch_files(tmp, step, how)
            else:
                src = os.path.join(self.durable_path, str(step))
                for name in os.listdir(src):
                    if not os.path.exists(os.path.join(tmp, name)):
                        shutil.copyfile(os.path.join(src, name),
                                        os.path.join(tmp, name))
                ok = True
            if not (ok and _candidate(tmp)):
                shutil.rmtree(tmp, ignore_errors=True)
                return False
            _fsync_dir(tmp)
            aside = dst + ".old-%d" % os.getpid()
            if os.path.isdir(dst):
                os.replace(dst, aside)
            os.replace(tmp, dst)
            shutil.rmtree(aside, ignore_errors=True)
            _fsync_dir(self.path)
            return True
        except OSError as exc:
            logger.warning("landing step %d from the %s tier failed: %s",
                           step, tier, exc)
            shutil.rmtree(tmp, ignore_errors=True)
            return False

    def _try_candidates(
        self, template, candidates, pinned: bool, tier: str, last_exc, bad,
        land_s: float = 0.0,
    ) -> Optional[Tuple[Any, Optional[TrainStatus]]]:
        """One tier's restore attempt over ``candidates`` (newest first);
        the restored pair, or None with ``last_exc[0]``/``bad`` updated
        for the caller's ladder bookkeeping. ``land_s``: the seconds the
        tier took to land the version in the local dir (peer assembly,
        durable copy), reported with the load's."""
        for s in candidates:
            t0 = time.monotonic()
            try:
                # child_span: stitches into a live restage/drain trace, or
                # roots a standalone ckpt_restore trace; a failed attempt
                # records too, so fallback laps show in the trace
                with obs_trace.child_span(
                    "ckpt_restore", step=str(s), tier=tier
                ), obs_goodput.phase("ckpt_restore", cause=tier):
                    status, nbytes = self._load(template, s)
                    # bytes DCP accepted but the trainer never saved (torn
                    # or tampered state) quarantine like a torn version
                    fp = (status.meta or {}).get("numerics")
                    fp_ok, fp_detail = obs_numerics.verify_fingerprint(
                        template, fp
                    )
                    if not fp_ok:
                        raise RuntimeError(
                            "numerics fingerprint mismatch: %s" % fp_detail
                        )
            except Exception as exc:  # noqa: BLE001 — any torn version falls back
                last_exc[0] = exc
                if not pinned:
                    _M_RESTORE_FALLBACKS.inc()
                    bad.append(s)
                    logger.warning(
                        "checkpoint step %d unreadable (%s); falling back "
                        "to the previous version/tier", s, exc,
                    )
                continue
            dt = time.monotonic() - t0
            _M_RESTORE_SECONDS.observe(dt)
            _M_RESTORES.inc(tier=tier)
            _M_RESTORE_BYTES.inc(nbytes)
            obs_events.record(
                "ckpt_restore", fsync=True, step=s, tier=tier,
                seconds=round(dt, 4), land_s=round(land_s, 4),
                fallbacks=len(bad),
            )
            self._purge(bad, shared=self.durable_path is None)
            if tier != self._tier:
                logger.info("restored step %d from the %s tier", s, tier)
            return template, status
        return None

    def agree(self, template, status: Optional[TrainStatus]
              ) -> Optional[TrainStatus]:
        """Collective at world > 1, after :meth:`restore`: every rank
        restored from its own pod's tiers, and a pod's tiers may hold an
        older version than rank 0's (or none). When the ranks' restored
        steps differ, rank 0's restored state (every tensor of the DCP
        view, loaded back like a restore) and status go to every rank;
        the returned status is rank 0's. A sharded template needs nothing:
        its ranks agreed on the step before their collective load."""
        if not _joined() or dist.get_world_size() == 1 or _sharded(template):
            return status
        mine = int(status.step) if status is not None else -1
        steps: List[Any] = [None] * dist.get_world_size()
        dist.all_gather_object(steps, mine)
        if len(set(steps)) == 1:
            return status
        logger.warning(
            "ranks restored different versions (steps %s); taking rank 0's",
            steps)
        sd = _state_dict(template)
        tensors: List[torch.Tensor] = []

        def collect(node):
            if torch.is_tensor(node):
                tensors.append(node)
            elif isinstance(node, dict):
                for key in sorted(node, key=str):
                    collect(node[key])
            elif isinstance(node, list):
                for item in node:
                    collect(item)

        collect(sd)
        with torch.no_grad():
            for t in tensors:
                dist.broadcast(t, src=0)
        shared = [status.to_dict() if status is not None else None,
                  getattr(getattr(template, "opt_state", None), "count", 0)]
        dist.broadcast_object_list(shared, src=0)
        if not isinstance(template, dict):
            _apply(template, sd, int(shared[1]))
        return TrainStatus.from_dict(shared[0]) if shared[0] else None

    def _peer_tier_enabled(self) -> bool:
        from edl_tpu_torch.checkpoint import replicate as _replicate

        return (
            self.durable_path is not None
            and _replicate.replica_count() > 0
            and bool(os.environ.get("EDL_STORE_ENDPOINT"))
            and bool(os.environ.get("EDL_JOB_ID"))
        )

    def _purge(self, bad_steps, shared: bool) -> None:
        """QUARANTINE versions that failed to restore (rename the step dir
        to ``<step>.corrupt``): left in place they would shadow the good
        version as ``latest_step`` and collide with post-resume re-saves
        of the same step numbers. A rename — never a delete — because the
        failure might be the READER's (a transient storage error), and
        destroying the newest checkpoint on a reader-side fault would turn
        a recoverable incident into data loss. In a ``shared`` directory
        rank 0 renames (every rank has seen the same failures) and the
        ranks meet after it; a pod-local directory is its own rank's."""
        if shared:
            if bad_steps and _is_rank0():
                for s in bad_steps:
                    self._quarantine(s)
            if bad_steps:
                _barrier()
            return
        for s in bad_steps:
            self._quarantine(s)

    def _quarantine(self, s: int) -> None:
        src = os.path.join(self.path, str(s))
        if not os.path.isdir(src):
            return
        # unique destination: the SAME step can be torn again after a
        # resume re-saved it (second crash mid-save) — a taken .corrupt
        # name must not silently leave the bad version live
        dst = "%s.corrupt" % src
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = "%s.corrupt.%d" % (src, n)
        try:
            os.replace(src, dst)
            logger.warning(
                "quarantined unreadable checkpoint version %d -> %s", s, dst,
            )
        except OSError as exc:
            logger.warning(
                "could not quarantine unreadable checkpoint %d: %s", s, exc
            )

    def close(self) -> None:
        """Finish the in-flight save, then stop the replicator."""
        self.wait()
        if self._replicator is not None:
            self._replicator.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
