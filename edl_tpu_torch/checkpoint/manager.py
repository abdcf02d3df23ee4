"""Versioned checkpoint/resume across a change of world size.

The port of ``edl_tpu/checkpoint/manager.py``'s durable single tier, on
``torch.distributed.checkpoint`` (DCP) in place of Orbax. The checkpoint is
the only state that crosses an elastic resize (the reference's
``fleet.save_check_point``/``load_check_point`` with ``TrainStatus``,
train_with_fleet.py:422-428, 563-570); the contract is the JAX package's:

- one directory per integer step under ``path`` (Orbax's layout), holding
  the DCP files of the model's and the optimizer's state plus
  ``status.json`` (the ``TrainStatus``, with the numerics fingerprint);
- a version is written under a temporary name and renamed to its step
  after every rank has written, so a crash mid-save leaves the previous
  version good (Orbax's finalize protocol does the same);
- ``save`` is collective at world > 1: each rank writes what DCP assigns
  it (replicated tensors once), rank 0 renames;
- keys are names, not positions: parameter names carry no
  data-parallel ``module.`` prefix and the optimizer state is keyed by
  parameter name (``torch.distributed.checkpoint.state_dict``), so a
  version saved at world 2 loads at world 1. The optimizer's step counts
  and moments are restored; its hyper-parameters stay what the factory
  set for the new world (a re-scaled learning rate survives the restore);
- ``restore`` walks the versions newest first, falls back past
  unreadable ones and quarantines them (``<step>.corrupt``);
- retention keeps the newest ``max_to_keep`` versions.

The bytes are DCP's, not Orbax's: a checkpoint of the JAX package does not
load here, nor the other way round.

The local and peer tiers (``local_dir``/``EDL_CKPT_LOCAL_DIR``), async
saves and the drain-notice emergency saves come with slice 3b; asking for
them raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import events as obs_events
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
_M_RESTORE_FALLBACKS = obs_metrics.counter(
    "edl_ckpt_restore_fallbacks_total",
    "unreadable checkpoint versions skipped during restore",
)

STATUS_FILE = "status.json"


def _slice_3b(what: str) -> NotImplementedError:
    return NotImplementedError(
        "%s waits for slice 3b of the port; this slice keeps one durable "
        "checkpoint directory with synchronous saves" % what
    )


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


def _state_dict(state) -> Dict[str, Any]:
    """The DCP view of a ``TrainState``: name-keyed model and optimizer
    state (live tensors, no copies), the step and the optimizer's update
    count. Building it initialises a fresh optimizer's state (a zero-lr
    step over zero gradients), so it can serve as a restore template."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_sd, optim_sd = get_state_dict(state.apply_fn, state.opt_state.optimizer)
    return {
        "model": model_sd,
        "optim": optim_sd,
        "step": state.step,
        "count": torch.tensor(state.opt_state.count, dtype=torch.int64),
    }


def _sd_bytes(sd) -> int:
    if torch.is_tensor(sd):
        return sd.numel() * sd.element_size()
    if isinstance(sd, dict):
        return sum(_sd_bytes(v) for v in sd.values())
    if isinstance(sd, (list, tuple)):
        return sum(_sd_bytes(v) for v in sd)
    return 0


@contextlib.contextmanager
def _dcp_call():
    """Around a DCP save or load: silence its notice that it runs in one
    process (a one-worker stage has no process group by design)."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="torch.distributed is disabled")
        yield


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """Step-versioned checkpoints of a ``TrainState`` with retention.

    A missing or empty directory restores to ``(template, None)``, so a
    first launch and a resume share one code path — mirroring the
    reference's ``load_check_point`` returning a fresh ``TrainStatus``
    when no checkpoint exists (train_with_fleet.py:428)."""

    def __init__(
        self,
        path: str,
        max_to_keep: int = 3,
        async_save: bool = False,
        local_dir: Optional[str] = None,
    ) -> None:
        if async_save:
            raise _slice_3b("async_save=True (saves overlapping training)")
        if local_dir is None:
            local_dir = os.environ.get("EDL_CKPT_LOCAL_DIR", "")
        if local_dir:
            raise _slice_3b(
                "the pod-local checkpoint tier (local_dir, "
                "EDL_CKPT_LOCAL_DIR) and its peer replicas"
            )
        self.path = os.path.abspath(os.fspath(path))
        self.durable_path: Optional[str] = None
        self._tier = "durable"
        self.max_to_keep = max_to_keep
        os.makedirs(self.path, exist_ok=True)

    # -- save --------------------------------------------------------------

    def save(self, state, status: TrainStatus, step: Optional[int] = None) -> int:
        """Write ``state`` as version ``step`` (default ``status.step``);
        collective at world > 1. Raises ``FileExistsError`` if that
        version exists."""
        import torch.distributed.checkpoint as dcp

        if step is None:
            step = int(status.step)
        if _FP_SAVE.armed:
            _FP_SAVE.fire(step=step)
        t0 = time.monotonic()
        final = os.path.join(self.path, str(step))
        tmp = os.path.join(self.path, ".tmp-%d" % step)
        with obs_trace.child_span("ckpt_save", step=str(step)):
            if os.path.exists(final):
                raise FileExistsError("checkpoint step %d exists: %s" % (step, final))
            status_doc = status.to_dict()
            try:
                # resize continuity sentinel: the status carries a
                # {step, loss, param_norm} numerics fingerprint, which
                # restore re-derives (quarantining mismatches)
                status_doc = obs_numerics.stamp_fingerprint(status_doc, state, step)
            except Exception as exc:  # noqa: BLE001 — the stamp must never fail a save
                logger.warning("numerics fingerprint stamp failed: %s", exc)
            sd = _state_dict(state)
            if _is_rank0():
                shutil.rmtree(tmp, ignore_errors=True)  # a torn earlier try
            _barrier()
            with _dcp_call():
                dcp.save(sd, storage_writer=dcp.FileSystemWriter(tmp),
                         no_dist=not _joined())
            if _is_rank0():
                # DCP's save returns on every rank after rank 0 wrote the
                # metadata, so every rank's files are in place
                with open(os.path.join(tmp, STATUS_FILE), "w") as fh:
                    json.dump(status_doc, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
                _fsync_dir(tmp)
                os.replace(tmp, final)
                _fsync_dir(self.path)
                self._retain()
            _barrier()
            dt = time.monotonic() - t0
            _M_SAVE_SECONDS.observe(dt)
            _M_SAVES.inc()
            nbytes = _sd_bytes(sd)
            _M_SAVE_BYTES.inc(nbytes)
            _M_SAVE_SIZE.observe(nbytes)
            obs_events.record(
                "ckpt_save", step=step, seconds=round(dt, 4), bytes=nbytes
            )
        return step

    def _retain(self) -> None:
        if not self.max_to_keep:
            return  # keep every version
        for s in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.path, str(s)), ignore_errors=True)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def emergency_save(self, state, status: TrainStatus, budget_s: float,
                       step: Optional[int] = None):
        raise _slice_3b("the drain-notice emergency save")

    def emergency_replicate(self, budget_s: float) -> bool:
        raise _slice_3b("the drain-notice emergency replica push")

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
        """Read the latest TrainStatus WITHOUT restoring model state —
        cheap (json only), for decisions that must happen before the
        optimizer/state exist (e.g. status-aware hyper-parameter
        adjustment on resume). Unreadable versions fall back like
        :meth:`restore`."""
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
        from torch.distributed.checkpoint.state_dict import set_state_dict

        status = self._read_status(step)
        sd = _state_dict(template)
        with _dcp_call():
            dcp.load(sd, storage_reader=dcp.FileSystemReader(
                os.path.join(self.path, str(step))), no_dist=not _joined())
        optimizer = template.opt_state.optimizer
        # the hyper-parameters are this world's (the factory set them from
        # the adjust registry); only the optimizer's state is restored
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in optimizer.param_groups]
        set_state_dict(template.apply_fn, optimizer,
                       model_state_dict=sd["model"], optim_state_dict=sd["optim"])
        for group, keep in zip(optimizer.param_groups, hyper):
            group.update(keep)
        with torch.no_grad():
            template.step.copy_(sd["step"])
        template.opt_state.count = int(sd["count"])
        return status, _sd_bytes(sd)

    def restore(
        self, template, step: Optional[int] = None
    ) -> Tuple[Any, Optional[TrainStatus]]:
        """Restore into ``template`` (a ``TrainState`` built for the new
        world, changed in place); ``(template, None)`` when no version
        exists.

        A torn/corrupt newest version (crash mid-write, bad disk) must not
        take the job down when an older good version exists: with no
        explicit ``step``, unreadable versions — and versions whose
        numerics fingerprint does not match what they hold — are skipped
        newest-to-oldest with a warning (counted in
        ``edl_ckpt_restore_fallbacks_total``) and quarantined once a
        version restores. Only when every version fails does the last
        error propagate. An explicit ``step`` never falls back."""
        candidates = self._candidates(step)
        if _FP_RESTORE.armed and candidates:
            _FP_RESTORE.fire(step=candidates[0])
        last_exc: Optional[Exception] = None
        bad: list = []
        for s in candidates:
            t0 = time.monotonic()
            try:
                with obs_trace.child_span(
                    "ckpt_restore", step=str(s), tier=self._tier
                ):
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
                last_exc = exc
                if step is None:
                    _M_RESTORE_FALLBACKS.inc()
                    bad.append(s)
                    logger.warning(
                        "checkpoint step %d unreadable (%s); falling back "
                        "to the previous version", s, exc,
                    )
                continue
            dt = time.monotonic() - t0
            _M_RESTORE_SECONDS.observe(dt)
            _M_RESTORES.inc(tier=self._tier)
            _M_RESTORE_BYTES.inc(nbytes)
            obs_events.record(
                "ckpt_restore", fsync=True, step=s, tier=self._tier,
                seconds=round(dt, 4), fallbacks=len(bad),
            )
            self._purge(bad)
            return template, status
        if last_exc is not None:
            raise last_exc
        return template, None

    def _purge(self, bad_steps) -> None:
        """QUARANTINE versions that failed to restore (rename the step dir
        to ``<step>.corrupt``): left in place they would shadow the good
        version as ``latest_step`` and collide with post-resume re-saves
        of the same step numbers. A rename — never a delete — because the
        failure might be the READER's (a transient storage error), and
        destroying the newest checkpoint on a reader-side fault would turn
        a recoverable incident into data loss. Operators can inspect or
        restore the quarantined dir. Rank 0 renames; every rank has seen
        the same failures."""
        if bad_steps and _is_rank0():
            for s in bad_steps:
                self._quarantine(s)
        if bad_steps:
            _barrier()

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
        """Nothing to release: saves are synchronous."""

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
