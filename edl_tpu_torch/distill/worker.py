"""Student-side distill pipeline: reader → predict pool → ordered fetch.

Behavior parity with the reference's hot path
(python/edl/distill/distill_worker.py): tasks of ``teacher_batch_size``
samples flow through a pool of predict workers bounded by a semaphore of
``2*require_num + 2`` in-flight tasks; epoch ends are coordinated by a
poison-pill protocol carrying the epoch's task count; failed tasks are
re-queued for other workers (3 RPC retries each); the fetch side restores
task order before yielding.

Deliberate re-design (SURVEY §7 hard parts): the reference uses forked
processes and documents a fork-vs-logging deadlock it must tiptoe around
(distill_reader.py:360-369). Here the pipeline is **threads**: the student
side only does RPC I/O and numpy regrouping (both release the GIL); the
actual FLOPs run on the teacher servers. That removes every fork hazard,
makes teardown exact, and lets the NOP-backend test (reference
distill_reader_test.py) run hundreds of epochs in seconds.

Teacher membership is a :class:`ServerPool` the manage loop updates from
discovery; a worker whose teacher left the pool (or died) drops it and
acquires a live one — the reference's stop-event + server-recycling
behavior (distill_worker.py:57-133) without the event plumbing.
"""

from __future__ import annotations

import heapq
import itertools
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.distill.resilience import (
    BreakerBoard,
    HedgePolicy,
    RetryBudget,
    hedged_call,
)
from edl_tpu_torch.distill.serving import PredictClient
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.utils.exceptions import EdlOverloadError
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.retry import retry_call
from edl_tpu_torch.utils.timeline import make_timeline

logger = get_logger("distill.worker")

_FP_PREDICT = _fault_point(
    "distill.predict",
    "student-side predict RPC: delay or drop (teacher looks sick; the "
    "retry/re-queue/cooldown machinery takes over)",
)

_M_PREDICT = obs_metrics.histogram(
    "edl_distill_predict_seconds",
    "teacher predict RPC latency seen by the student pipeline",
)
_M_TASKS = obs_metrics.counter(
    "edl_distill_tasks_total", "tasks completed by the predict pool"
)
_M_REQUEUES = obs_metrics.counter(
    "edl_distill_task_requeues_total", "tasks re-queued after a sick teacher"
)
_M_COOLDOWNS = obs_metrics.counter(
    "edl_distill_teacher_cooldowns_total", "teacher endpoints put in cooldown"
)


@dataclass
class Task:
    task_id: int
    unit_id: int            # index of the user-level unit (sample list/batch)
    last_in_unit: bool      # task completes its unit
    feeds: Dict[str, np.ndarray]          # what the teacher sees
    payload: List[Tuple]                  # the original samples
    fetchs: Optional[Dict[str, np.ndarray]] = None  # teacher predictions


@dataclass
class _PoisonPill:
    epoch: int
    feed_count: int         # tasks emitted this epoch


class ServerPool:
    """Live teacher endpoints with least-loaded acquisition and cooldown.

    ``version`` bumps on every membership change; workers re-check their
    endpoint against the pool each task, so retired teachers drain within
    one task.

    Resilience hooks: ``admit`` is an external veto predicate (the
    breaker board's ``admits``) consulted by :meth:`acquire` and
    :meth:`has` — an open breaker makes a teacher invisible without
    discovery churn; :meth:`note_qdepth` feeds the teacher-advertised
    queue depths into acquisition, so "least loaded" weighs real backlog
    (this client's in-flight count + everyone else's advertised queue),
    not just this client's own connections."""

    _COOLDOWN = 10.0
    _QDEPTH_TTL = 10.0  # advertised depths older than this are stale

    def __init__(
        self,
        cooldown: Optional[float] = None,
        admit: Optional[Callable[[str], bool]] = None,
    ) -> None:
        if cooldown is not None:
            self._COOLDOWN = cooldown
        self._cond = threading.Condition()
        self._endpoints: List[str] = []
        self._load: Dict[str, int] = {}
        self._bad_until: Dict[str, float] = {}
        self._qdepth: Dict[str, Tuple[float, float]] = {}  # (depth, ts)
        self._admit = admit if admit is not None else (lambda _e: True)
        self.version = 0
        self._closed = False

    def note_qdepth(self, endpoint: str, depth: float) -> None:
        with self._cond:
            self._qdepth[endpoint] = (float(depth), time.time())

    def _advertised(self, endpoint: str, now: float) -> float:
        depth, ts = self._qdepth.get(endpoint, (0.0, 0.0))
        return depth if now - ts <= self._QDEPTH_TTL else 0.0

    def update(self, endpoints: Sequence[str]) -> None:
        with self._cond:
            fresh = sorted(set(endpoints))
            if fresh == self._endpoints:
                return
            self._endpoints = fresh
            self._load = {e: self._load.get(e, 0) for e in fresh}
            # prune only *expired* cooldowns — a sick teacher that flaps out
            # of one discovery poll and back must not shed its cooldown
            now = time.time()
            self._bad_until = {
                e: t for e, t in self._bad_until.items() if t > now
            }
            self.version += 1
            self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def mark_bad(self, endpoint: str) -> None:
        """Put an endpoint in cooldown.  It stays a pool member (so it
        re-admits itself in :meth:`acquire` once the cooldown lapses, with
        no discovery churn required), but ``has`` reports it absent so
        workers holding a client for it drop it within one task."""
        with self._cond:
            self._bad_until[endpoint] = time.time() + self._COOLDOWN
            self._load.pop(endpoint, None)
            if endpoint in self._endpoints:
                self.version += 1
                self._cond.notify_all()

    def has(self, endpoint: str) -> bool:
        with self._cond:
            return (
                endpoint in self._endpoints
                and self._bad_until.get(endpoint, 0) <= time.time()
                and self._admit(endpoint)
            )

    def acquire(
        self,
        timeout: Optional[float] = None,
        exclude: Optional[str] = None,
    ) -> Optional[str]:
        """Least-loaded live endpoint, or None on close/timeout.

        ``exclude`` skips one endpoint — hedged backups must land on a
        *different* teacher than the primary they are racing."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cond:
            while True:
                if self._closed:
                    return None
                now = time.time()
                ok = [
                    e for e in self._endpoints
                    if e != exclude
                    and self._bad_until.get(e, 0) <= now
                    and self._admit(e)
                ]
                if ok:
                    pick = min(
                        ok,
                        key=lambda e: self._load.get(e, 0)
                        + self._advertised(e, now),
                    )
                    self._load[pick] = self._load.get(pick, 0) + 1
                    return pick
                remaining = None if deadline is None else deadline - now
                if remaining is not None and remaining <= 0:
                    return None
                # Bounded wait even with timeout=None: cooldown expiry
                # (_bad_until lapsing) never notifies the condition, so an
                # unbounded wait would hang forever once every teacher is in
                # cooldown and membership is stable.  Wake at the earliest
                # cooldown deadline (or 0.5 s) and re-check.
                wake = 0.5
                pending = [
                    t - now for t in self._bad_until.values() if t > now
                ]
                if pending:
                    wake = min(wake, max(min(pending), 0.01))
                if remaining is not None:
                    wake = min(wake, remaining)
                self._cond.wait(wake)

    def release(self, endpoint: str) -> None:
        with self._cond:
            if endpoint in self._load and self._load[endpoint] > 0:
                self._load[endpoint] -= 1


class DistillPipeline:
    """The concurrent engine behind :class:`DistillReader`.

    ``generator_fn`` is re-invoked once per epoch. ``discover`` is called
    periodically by the manage loop and returns the current teacher
    endpoints."""

    def __init__(
        self,
        generator_fn: Callable,
        mode: str,                       # sample | sample_list | batch
        feeds: Sequence[str],
        fetchs: Optional[Sequence[str]],
        discover: Callable[[], Sequence[str]],
        teacher_batch_size: int = 128,
        require_num: int = 3,
        retry: int = 3,
        discover_interval: float = 1.0,
        rpc_timeout: float = 30.0,
        copy_batches: bool = True,
        slo_ms: Optional[float] = None,
    ) -> None:
        assert mode in ("sample", "sample_list", "batch"), mode
        self._generator_fn = generator_fn
        self._mode = mode
        self._feeds = list(feeds)
        self._fetchs = list(fetchs) if fetchs is not None else None
        self._discover = discover
        self._tbs = teacher_batch_size
        self._require_num = require_num
        self._retry = retry
        self._discover_interval = discover_interval
        self._rpc_timeout = rpc_timeout
        self._copy_batches = copy_batches
        if slo_ms is None:
            try:
                slo_ms = float(os.environ.get("EDL_SERVE_SLO_MS", "0") or 0)
            except ValueError:
                slo_ms = 0.0
        self._slo_s = max(0.0, float(slo_ms)) / 1000.0

        self._task_queue: "queue.Queue" = queue.Queue()
        self._out_queue: "queue.Queue" = queue.Queue()
        self._sem = threading.Semaphore(2 * require_num + 2)
        # resilience plane: breakers veto endpoints in the pool, the retry
        # budget caps in-place RPC retries fleet-wide (re-queues are NOT
        # retries: the epoch contract is exactly-once delivery, so a task
        # that gives up its retries moves to another teacher instead of
        # being dropped), and the hedge policy races a budget-capped
        # backup predict once the primary is past its tracked p95.
        self.breakers = BreakerBoard(
            on_open=self._on_breaker_open, on_close=self._on_breaker_close
        )
        self.retry_budget = RetryBudget(burst=float(2 * require_num + 2))
        self.hedge = HedgePolicy()
        self._pool = ServerPool(admit=self.breakers.admits)
        self._stop = threading.Event()
        self._epoch_consumed = threading.Event()
        self._counter_lock = threading.Lock()
        self._processed = 0          # tasks completed in the current epoch
        self._started = False
        self._threads: List[threading.Thread] = []
        self._error: Optional[BaseException] = None
        # legacy EDL_TIMELINE stderr lines only — the predict interval is
        # span-recorded directly below, so the shim must not feed the
        # tracer too (every op would land in the ring twice)
        self._timeline = make_timeline(feed_tracer=False)
        self._tracer = obs_trace.get_tracer()
        # queue depths sampled at scrape time — THE live signal for "is
        # the student starved or the teacher pool behind"; released on
        # stop() so the registry can't pin a dead pipeline's queues
        # (and their buffered ndarrays).
        self._obs_gauges = obs_metrics.bind_gauges((
            ("edl_distill_task_queue_depth",
             "tasks waiting for a predict worker", self._task_queue.qsize),
            ("edl_distill_out_queue_depth",
             "predicted tasks awaiting ordered fetch", self._out_queue.qsize),
        ))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._threads.append(
            threading.Thread(target=self._manage_loop, name="distill-manage", daemon=True)
        )
        self._threads.append(
            threading.Thread(target=self._reader_loop, name="distill-reader", daemon=True)
        )
        for i in range(self._require_num):
            self._threads.append(
                threading.Thread(
                    target=self._predict_loop, name="distill-predict-%d" % i, daemon=True
                )
            )
        for t in self._threads:
            t.start()

    def stop(self) -> None:
        self._stop.set()
        self._pool.close()
        self._epoch_consumed.set()
        # release any reader blocked on the semaphore
        self._sem.release()
        self._obs_gauges.release()

    def _fail(self, exc: BaseException) -> None:
        if self._error is None:
            self._error = exc
        self.stop()

    # -- breaker → discovery ejection ---------------------------------------

    def _on_breaker_open(self, endpoint: str) -> None:
        """A tripped breaker ejects the teacher twice over: locally the
        pool's admit veto hides it at once, and — when discovery supports
        it — a sick report lets :class:`BalanceTable` route *other*
        readers around it without waiting for its lease to expire."""
        report = getattr(self._discover, "report_sick", None)
        if report is not None:
            try:
                report(endpoint)
            except Exception as exc:  # noqa: BLE001 — advisory path
                logger.warning("sick report for %s failed: %s", endpoint, exc)

    def _on_breaker_close(self, endpoint: str) -> None:
        clear = getattr(self._discover, "clear_sick", None)
        if clear is not None:
            try:
                clear(endpoint)
            except Exception as exc:  # noqa: BLE001 — advisory path
                logger.warning("sick clear for %s failed: %s", endpoint, exc)

    # -- manage loop (teacher membership) ----------------------------------

    def _manage_loop(self) -> None:
        while not self._stop.is_set():
            try:
                endpoints = list(self._discover())
                self._pool.update(endpoints)
            except Exception as exc:  # noqa: BLE001 — discovery may flap
                logger.warning("discovery failed: %s", exc)
            self._stop.wait(self._discover_interval)

    # -- reader loop (epochs → tasks) --------------------------------------

    def _reader_loop(self) -> None:
        ids = itertools.count()
        epoch = 0
        try:
            while not self._stop.is_set():
                count = 0
                for task in self._cut_tasks(ids):
                    self._sem.acquire()
                    if self._stop.is_set():
                        return
                    self._task_queue.put(task)
                    count += 1
                self._task_queue.put(_PoisonPill(epoch, count))
                self._epoch_consumed.wait()
                self._epoch_consumed.clear()
                epoch += 1
        except BaseException as exc:  # noqa: BLE001 — surface via fetch side
            logger.exception("reader loop failed")
            self._fail(exc)

    def _cut_tasks(self, ids):
        """Regroup the user generator's units into teacher-sized tasks
        (≙ reference read_sample/_list/_batch, distill_worker.py:531-610).
        A task never spans two sample_list/batch units, so the fetch side
        can reassemble exact unit boundaries. In sample mode the unit IS
        one sample, so tasks group ``teacher_batch_size`` consecutive
        samples (reference read_sample accumulates across yields,
        distill_worker.py:531-563) — one RPC per sample would waste the
        teacher's MXU on batch-1 inference.

        Batch mode stays in array land end-to-end: tasks carry array
        slices (no per-sample Python tuples), which is where the
        student-side pipeline overhead went in profiling — two O(batch)
        Python loops per unit. Each chunk is copied ONCE here (array-level
        memcpy): the task must own its buffers, both because generators
        may legally reuse a yield buffer and because the fetch side hands
        payload arrays straight back to the consumer. ``copy_batches=
        False`` (DistillReader opt-in) skips that memcpy for generators
        that guarantee fresh buffers per yield — at 256-row image batches
        the copy is a measurable slice of the per-batch overhead."""
        if self._mode == "sample":
            chunk: List[Tuple] = []

            def sample_task(samples):
                tid = next(ids)
                return Task(
                    task_id=tid,
                    unit_id=tid,  # sample-mode tasks are their own unit
                    last_in_unit=True,
                    feeds=self._stack_feeds(samples),
                    payload=samples,
                )

            for unit in self._generator_fn():
                # copy each field NOW: generators may legally reuse their
                # yield buffer, and this task only ships at chunk boundary
                chunk.append(tuple(np.asarray(f).copy() for f in unit))
                if len(chunk) == self._tbs:
                    yield sample_task(chunk)
                    chunk = []
            if chunk:
                yield sample_task(chunk)
            return
        for unit_id, unit in enumerate(self._generator_fn()):
            if self._mode == "batch":
                arrays = tuple(np.asarray(a) for a in unit)
                n = arrays[0].shape[0]
                for a in arrays[1:]:
                    if a.shape[0] != n:
                        raise ValueError(
                            "batch unit %d has mismatched leading dims: %r"
                            % (unit_id, [x.shape for x in arrays])
                        )
                for start in range(0, n, self._tbs):
                    if self._copy_batches:
                        chunk = tuple(
                            a[start : start + self._tbs].copy() for a in arrays
                        )
                    else:
                        chunk = tuple(a[start : start + self._tbs] for a in arrays)
                    yield Task(
                        task_id=next(ids),
                        unit_id=unit_id,
                        last_in_unit=start + self._tbs >= n,
                        feeds={
                            name: chunk[j]
                            for j, name in enumerate(self._feeds)
                        },
                        payload=chunk,
                    )
                continue
            samples = self._unit_to_samples(unit)
            for start in range(0, len(samples), self._tbs):
                chunk = samples[start : start + self._tbs]
                yield Task(
                    task_id=next(ids),
                    unit_id=unit_id,
                    last_in_unit=start + self._tbs >= len(samples),
                    feeds=self._stack_feeds(chunk),
                    payload=chunk,
                )

    def _unit_to_samples(self, unit) -> List[Tuple]:
        if self._mode == "sample":
            return [tuple(unit)]
        return [tuple(s) for s in unit]

    def _stack_feeds(self, samples: List[Tuple]) -> Dict[str, np.ndarray]:
        return {
            name: np.stack([np.asarray(s[j]) for s in samples])
            for j, name in enumerate(self._feeds)
        }

    # -- predict loop ------------------------------------------------------

    def _predict_loop(self) -> None:
        client: Optional[PredictClient] = None
        endpoint: Optional[str] = None
        pool_version = -1
        try:
            while not self._stop.is_set():
                try:
                    item = self._task_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if isinstance(item, _PoisonPill):
                    with self._counter_lock:
                        done = self._processed >= item.feed_count
                        if done:
                            self._processed -= item.feed_count
                    if done:
                        self._out_queue.put(item)
                    else:
                        # tasks (incl. re-queued failures) still in flight
                        self._task_queue.put(item)
                        time.sleep(0.002)
                    continue

                # drop retired teachers between tasks
                if client is not None and (
                    self._pool.version != pool_version
                    and not self._pool.has(endpoint)
                ):
                    self._close_client(client, endpoint)
                    client, endpoint = None, None
                if client is None:
                    endpoint = self._pool.acquire()
                    pool_version = self._pool.version
                    if endpoint is None:  # pool closed
                        self._task_queue.put(item)
                        return
                    try:
                        client = PredictClient(endpoint, timeout=self._rpc_timeout)
                    except OSError as exc:
                        logger.warning("connect %s failed: %s", endpoint, exc)
                        _M_COOLDOWNS.inc()
                        self._pool.mark_bad(endpoint)
                        self._pool.release(endpoint)
                        client, endpoint = None, None
                        self._task_queue.put(item)
                        continue

                self.retry_budget.note_primary()
                self.hedge.note_primary()
                hstate = {"abandoned": False}

                def _attempt():
                    self._timeline.reset()
                    self.breakers.starting(endpoint)
                    t0 = time.monotonic()
                    try:
                        if _FP_PREDICT.armed:
                            _FP_PREDICT.fire(
                                task=item.task_id, endpoint=endpoint
                            )
                        if obs_trace.PROPAGATION.armed:
                            # span-scoped context: client.predict stamps
                            # this span's id into the frame, so the
                            # teacher-side handling span becomes its child
                            with obs_trace.child_span(
                                "distill_predict", task=item.task_id
                            ):
                                item.fetchs = self._predict_once(
                                    client, endpoint, item, hstate
                                )
                            _M_PREDICT.observe(time.monotonic() - t0)
                        else:
                            item.fetchs = self._predict_once(
                                client, endpoint, item, hstate
                            )
                            dt = time.monotonic() - t0
                            _M_PREDICT.observe(dt)
                            self._tracer.record(
                                "distill_predict", t0, dt, task=item.task_id
                            )
                    except EdlOverloadError:
                        self.breakers.record_failure(endpoint, overload=True)
                        self._pool.note_qdepth(endpoint, client.last_qdepth)
                        raise
                    except (ConnectionError, OSError):
                        self.breakers.record_failure(endpoint)
                        raise
                    if not hstate["abandoned"]:
                        # backup-won hedges say nothing about the primary:
                        # neither success nor failure is recorded for it
                        self.breakers.record_success(endpoint)
                        self._pool.note_qdepth(endpoint, client.last_qdepth)
                    self._timeline.record("task_predict", task=item.task_id)

                try:
                    retry_call(
                        _attempt,
                        what="distill.predict",
                        retry_on=(ConnectionError, OSError),
                        retries=max(0, self._retry - 1),
                        base_delay=0.02,
                        max_delay=0.2,
                        # give_up is polled once per caught failure; the
                        # short-circuit order means a breaker-vetoed
                        # endpoint costs no budget token, and an exhausted
                        # budget turns the failure into a re-queue (to a
                        # different teacher) instead of an in-place retry —
                        # fleet-wide retries stay ≤ ratio × primaries + burst
                        give_up=lambda: (
                            self._stop.is_set()
                            or not self.breakers.admits(endpoint)
                            or not self.retry_budget.try_spend()
                        ),
                        on_retry=lambda n, exc: logger.warning(
                            "predict on %s failed (attempt %d): %s",
                            endpoint, n, exc,
                        ),
                    )
                    ok = True
                except EdlOverloadError as exc:
                    # the teacher is alive and shedding — EdlOverloadError
                    # is deliberately not retry_on-shaped, so it lands here
                    # on the first shed. Re-queue: the epoch contract is
                    # exactly-once delivery, and breaker veto + advertised
                    # qdepth weighting steer the next attempt elsewhere.
                    logger.warning(
                        "predict on %s shed (qdepth=%d est_wait=%.0fms): %s",
                        endpoint, exc.qdepth, exc.est_wait_ms, exc,
                    )
                    _M_REQUEUES.inc()
                    self._task_queue.put(item)
                    time.sleep(0.02)  # don't hot-spin a fully shedding fleet
                    continue
                except (ConnectionError, OSError) as exc:
                    logger.warning(
                        "predict on %s exhausted %d attempts: %s",
                        endpoint, self._retry, exc,
                    )
                    ok = False
                if ok and hstate["abandoned"]:
                    # the backup won: the primary RPC is still in flight on
                    # this connection, so its frame stream is desynced.
                    # Closing it unblocks the abandoned thread; next task
                    # dials fresh. No cooldown — slow ≠ dead.
                    self._close_client(client, endpoint)
                    client, endpoint = None, None
                if ok:
                    _M_TASKS.inc()
                    # put-then-count under one lock: a pill holder checking
                    # processed >= feed_count must never observe the count
                    # before the task itself is in the out queue, or the pill
                    # could overtake the epoch's final task and end the epoch
                    # with a unit still in flight.
                    with self._counter_lock:
                        self._out_queue.put(item)
                        self._processed += 1
                else:
                    # teacher is sick: re-queue the task for someone else
                    # (reference distill_worker.py:437-446) and drop it
                    _M_REQUEUES.inc()
                    _M_COOLDOWNS.inc()
                    self._pool.mark_bad(endpoint)
                    self._close_client(client, endpoint)
                    client, endpoint = None, None
                    self._task_queue.put(item)
        except BaseException as exc:  # noqa: BLE001
            logger.exception("predict loop failed")
            self._fail(exc)
        finally:
            if client is not None:
                self._close_client(client, endpoint)

    def _predict_once(
        self,
        client: PredictClient,
        endpoint: str,
        item: Task,
        hstate: Dict[str, bool],
    ) -> Dict[str, np.ndarray]:
        """One predict RPC, hedged once the policy has a p95 to hedge at.

        The backup goes to a *different* teacher over a fresh one-shot
        connection (hedges are budget-rare; a connection cache is not
        worth the complexity). First success wins; a backup win marks the
        held client abandoned via ``hstate`` so the loop discards it."""
        deadline = self._slo_s if self._slo_s > 0 else None

        def primary():
            return client.predict(item.feeds, deadline_s=deadline)

        delay = self.hedge.delay_s()
        if delay is None:  # cold or disabled: plain call, seed the p95
            t0 = time.monotonic()
            out = primary()
            self.hedge.note_latency(time.monotonic() - t0)
            return out

        def backup_factory():
            # acquire BEFORE spending the token: no second teacher means
            # no hedge, and the budget should not be charged for it
            alt = self._pool.acquire(timeout=0.0, exclude=endpoint)
            if alt is None:
                return None
            if not self.hedge.try_hedge():
                self._pool.release(alt)
                return None
            logger.info(
                "hedging task %d: %s slow, backup to %s",
                item.task_id, endpoint, alt,
            )

            def backup():
                try:
                    bclient = PredictClient(alt, timeout=self._rpc_timeout)
                except OSError:
                    self._pool.release(alt)
                    raise
                try:
                    return bclient.predict(item.feeds, deadline_s=deadline)
                finally:
                    bclient.close()
                    self._pool.release(alt)

            return backup

        t0 = time.monotonic()
        out, backup_won, abandoned = hedged_call(
            primary, delay, backup_factory, policy=self.hedge
        )
        if not backup_won:
            self.hedge.note_latency(time.monotonic() - t0)
        if abandoned:
            hstate["abandoned"] = True
        return out

    def _close_client(self, client: PredictClient, endpoint: Optional[str]) -> None:
        client.close()
        if endpoint is not None:
            self._pool.release(endpoint)

    # -- fetch side (caller thread) ----------------------------------------

    def epoch(self):
        """Yield one epoch of units, in order, with predictions appended."""
        self.start()
        expected = getattr(self, "_next_expected", 0)
        pending: List[Tuple[int, Task]] = []
        assembling: List[Task] = []
        pill = None
        try:
            while True:
                if self._error is not None:
                    raise self._error
                if pill is not None and not pending:
                    break  # epoch complete and all tasks drained
                try:
                    item = self._out_queue.get(timeout=0.5)
                except queue.Empty:
                    continue
                if isinstance(item, _PoisonPill):
                    pill = item
                    continue
                heapq.heappush(pending, (item.task_id, item))
                while pending and pending[0][0] == expected:
                    _, task = heapq.heappop(pending)
                    expected += 1
                    self._sem.release()
                    assembling.append(task)
                    if task.last_in_unit:
                        yield from self._assemble(assembling)
                        assembling = []
        finally:
            self._next_expected = expected
            self._epoch_consumed.set()

    def _fetch_names(self, task: Task) -> List[str]:
        if self._fetchs is not None:
            return self._fetchs
        return sorted(task.fetchs or ())

    def _assemble(self, tasks: List[Task]):
        """Reassemble one user unit + teacher predictions, as a list of
        values to yield (≙ reference fetch_sample/_list/_batch,
        distill_worker.py:705-748). Sample mode yields one value per
        sample of its (multi-sample) task; the other modes yield one
        value per unit."""
        names = self._fetch_names(tasks[0])
        preds = [
            np.concatenate([t.fetchs[n] for t in tasks], axis=0)
            if len(tasks) > 1 else tasks[0].fetchs[n]
            for n in names
        ]
        if self._mode == "batch":
            # single-task units pass through with no further copy; the
            # payload arrays are task-owned copies under copy_batches=True
            # (the default) and READ-ONLY aliases of the generator's data
            # under the no-copy opt-in — nothing here may mutate them
            fields = tuple(
                np.concatenate([t.payload[j] for t in tasks], axis=0)
                if len(tasks) > 1 else tasks[0].payload[j]
                for j in range(len(tasks[0].payload))
            )
            return [fields + tuple(preds)]
        samples = [s for t in tasks for s in t.payload]
        per_sample = [
            tuple(s) + tuple(p[i] for p in preds)
            for i, s in enumerate(samples)
        ]
        if self._mode == "sample":
            return per_sample
        return [per_sample]
