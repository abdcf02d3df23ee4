"""User-facing DistillReader.

Capability parity with the reference's flagship user API
(python/edl/distill/distill_reader.py:68-390): wrap a sample /
sample-list / batch generator so each epoch's data streams through a
fleet of teacher predict servers, yielding the original fields with the
teacher's predictions appended.

Teachers come either fixed (``set_fixed_teacher``) or discovered
dynamically through the balance service (``set_dynamic_teacher`` / env).
Env contract (≙ the reference's ``PADDLE_DISTILL_*``,
distill_reader.py:37, 240-267):

    EDL_DISTILL_STORE          store endpoint for discovery
    EDL_DISTILL_JOB_ID         job scope in the store
    EDL_DISTILL_SERVICE_NAME   teacher service name
    EDL_DISTILL_MAX_TEACHER    cap on teachers used by this reader

Example::

    reader = DistillReader(feeds=("img",), fetchs=("logits",))
    reader.set_fixed_teacher("10.0.0.5:9000")
    reader.set_batch_generator(my_batches)
    for img, label, t_logits in reader():
        ...
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Callable, List, Optional, Sequence

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.distill.worker import DistillPipeline
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("distill.reader")

_FP_EPOCH = _fault_point(
    "distill.reader.epoch",
    "epoch start on the student side: delay or kill (student dies between "
    "epochs; the teacher fleet must shed its load cleanly)",
)


class _FixedDiscovery:
    def __init__(self, endpoints: Sequence[str]) -> None:
        self._endpoints = list(endpoints)

    def __call__(self) -> List[str]:
        return list(self._endpoints)

    def stop(self) -> None:
        pass


class _DynamicDiscovery:
    """Lazily connects a DiscoveryClient; safe to call from the manage loop."""

    def __init__(
        self,
        store_endpoint: str,
        job_id: str,
        service_name: str,
        max_teachers: int,
    ) -> None:
        self._args = (store_endpoint, job_id, service_name, max_teachers)
        self._client = None
        self._stopped = False
        self._lock = threading.Lock()

    def __call__(self) -> List[str]:
        with self._lock:
            if self._stopped:
                return []
            client = self._client
        if client is None:
            # dial OUTSIDE the lock with a double-checked publish (the
            # PR-9 warm/aot discipline): the first call connects to the
            # store, which can take seconds against a sick control
            # plane, and stop() must never wait behind it
            from edl_tpu_torch.distill.discovery import DiscoveryClient

            store, job, service, cap = self._args
            client_id = "%s-%d-%d" % (
                socket.gethostname(), os.getpid(),
                int(time.time() * 1e6) % 10**6,
            )
            fresh = DiscoveryClient(
                store, job, service, client_id, max_teachers=cap
            )
            with self._lock:
                if self._client is None and not self._stopped:
                    self._client = fresh
                    extra = None
                else:
                    extra = fresh  # lost the race, or stopping
            if extra is not None:
                extra.stop()
        with self._lock:
            if self._client is None:
                return []  # stopped mid-dial
            _, servers = self._client.get_servers()
            return servers

    def report_sick(self, endpoint: str) -> None:
        """Breaker-open hook: tell the balancer this teacher is sick so
        *other* readers route around it too (lease-free ejection)."""
        with self._lock:
            client = self._client
        if client is not None:
            client.report_sick(endpoint)

    def clear_sick(self, endpoint: str) -> None:
        with self._lock:
            client = self._client
        if client is not None:
            client.clear_sick(endpoint)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._client is not None:
                self._client.stop()
                self._client = None


class DistillReader:
    def __init__(
        self,
        feeds: Sequence[str],
        fetchs: Optional[Sequence[str]] = None,
        teacher_batch_size: int = 128,
        require_num: int = 3,
        retry: int = 3,
        rpc_timeout: float = 30.0,
        copy_batches: bool = True,
        slo_ms: Optional[float] = None,
    ) -> None:
        """``slo_ms`` stamps a per-request deadline (wire field ``dl``)
        on every predict so teachers can shed work this reader would time
        out on anyway; None defers to ``EDL_SERVE_SLO_MS`` (0 = no
        deadline, the default — a training pipeline usually prefers slow
        answers over re-queues).

        ``copy_batches=False`` skips the defensive per-chunk memcpy in
        batch mode. The yielded arrays are then ALIASED, not copied, so
        the opt-in is safe only when (a) the generator never writes to a
        yielded array's memory after yielding it — fresh slices of a
        buffer that gets refilled in place also violate this — and (b)
        the consumer treats the fields it gets back as read-only (they
        view the generator's data). Steady-state read-only datasets (the
        common case: yield slices of one persistent array) qualify."""
        self._feeds = list(feeds)
        self._fetchs = list(fetchs) if fetchs is not None else None
        self._tbs = teacher_batch_size
        self._require_num = require_num
        self._retry = retry
        self._rpc_timeout = rpc_timeout
        self._copy_batches = copy_batches
        self._slo_ms = slo_ms
        self._discovery = None
        self._generator: Optional[Callable] = None
        self._mode: Optional[str] = None
        self._pipeline: Optional[DistillPipeline] = None
        self._maybe_env_teacher()

    # -- teacher configuration --------------------------------------------

    def _maybe_env_teacher(self) -> None:
        store = os.environ.get("EDL_DISTILL_STORE")
        service = os.environ.get("EDL_DISTILL_SERVICE_NAME")
        if store and service:
            self.set_dynamic_teacher(
                store,
                os.environ.get("EDL_DISTILL_JOB_ID", "distill"),
                service,
                int(os.environ.get("EDL_DISTILL_MAX_TEACHER", "0")),
            )

    def set_fixed_teacher(self, *endpoints: str) -> "DistillReader":
        self._discovery = _FixedDiscovery(endpoints)
        return self

    def set_dynamic_teacher(
        self,
        store_endpoint: str,
        job_id: str = "distill",
        service_name: str = "teacher",
        max_teachers: int = 0,
    ) -> "DistillReader":
        self._discovery = _DynamicDiscovery(
            store_endpoint, job_id, service_name, max_teachers
        )
        return self

    # -- generator configuration ------------------------------------------

    def set_sample_generator(self, gen: Callable) -> "DistillReader":
        self._generator, self._mode = gen, "sample"
        return self

    def set_sample_list_generator(self, gen: Callable) -> "DistillReader":
        self._generator, self._mode = gen, "sample_list"
        return self

    def set_batch_generator(self, gen: Callable) -> "DistillReader":
        self._generator, self._mode = gen, "batch"
        return self

    # -- iteration ---------------------------------------------------------

    def _ensure_pipeline(self) -> DistillPipeline:
        if self._pipeline is None:
            if self._generator is None:
                raise ValueError("no generator set; call set_*_generator first")
            if self._discovery is None:
                raise ValueError(
                    "no teachers: call set_fixed_teacher/set_dynamic_teacher "
                    "or set EDL_DISTILL_STORE + EDL_DISTILL_SERVICE_NAME"
                )
            self._pipeline = DistillPipeline(
                self._generator,
                self._mode,
                self._feeds,
                self._fetchs,
                self._discovery,
                teacher_batch_size=self._tbs,
                require_num=self._require_num,
                retry=self._retry,
                rpc_timeout=self._rpc_timeout,
                copy_batches=self._copy_batches,
                slo_ms=self._slo_ms,
            )
        return self._pipeline

    def __call__(self):
        if _FP_EPOCH.armed:
            _FP_EPOCH.fire()
        return self._accounted_epoch(self._ensure_pipeline().epoch())

    @staticmethod
    def _accounted_epoch(epoch_iter):
        """Attribute time blocked on the teacher fleet to ``data_wait``
        in the goodput ledger — but ONLY when nobody else is driving the
        ledger (state ``None``, i.e. a standalone student script).
        Inside ``ElasticTrainer`` the reader is drained by the prefetch
        feeder thread while the main thread owns the ledger's
        train/data_wait flap; two threads writing one state machine
        would mislabel train time as data_wait, so the embedded case
        defers entirely to the trainer's own accounting (which already
        charges blocked ``next()`` time to data_wait)."""
        from edl_tpu_torch.obs import events as obs_events
        from edl_tpu_torch.obs import goodput as obs_goodput

        led = obs_goodput.ledger()
        n = 0
        while True:
            if led.state() is None:
                with led.phase("data_wait", cause="distill"):
                    try:
                        item = next(epoch_iter)
                    except StopIteration:
                        break
            else:
                try:
                    item = next(epoch_iter)
                except StopIteration:
                    break
            n += 1
            yield item
        obs_events.record("distill_epoch_end", batches=n)

    def stop(self) -> None:
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None
        if self._discovery is not None:
            self._discovery.stop()
