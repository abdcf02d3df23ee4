"""Teacher inference serving: a PyTorch model behind the wire protocol.

The port of ``edl_tpu/distill/serving.py``: the same server, client,
admission plane and coalescer, speaking the same EDL1/EDL2 frames, so a
JAX-package ``PredictClient``/``DistillReader`` talks to a port teacher
and back. ``TorchPredictBackend`` takes the place of ``JaxPredictBackend``.
The ``/metrics`` + ``/healthz`` mount (``EDL_OBS_PORT``) and the chaos
fault point ``distill.serving.predict`` are carried.

Replaces the reference's dependency on Paddle Serving
(python/edl/distill/distill_worker.py:23, 228-291 ``PaddlePredictServer``)
with an in-tree server speaking the same framed-msgpack protocol as every
other edl_tpu service.

Design points (not in the reference):

- **bucketed batch padding**: the backend pads the batch dim up to a
  power-of-two bucket (repeating the last row), runs the model, and
  slices the pad back off, so the device sees O(log max_batch) shapes.
- **bf16 on the card**: the model computes in bf16 (model-level choice);
  predictions return as fp32 numpy for the student pipeline.

Request:  ``{"i": n, "m": "predict", "feeds": {name: ndarray}}``
Response: ``{"i": n, "ok": true, "fetchs": {name: ndarray}}``

Serving resilience (DESIGN.md "Serving resilience plane"): the server
runs a deadline-aware admission test before touching the backend.
Requests may stamp ``dl`` (remaining deadline budget, milliseconds,
relative so clocks need not agree); past the bounded admission window
(``EDL_SERVE_QUEUE``) or when the estimated wait already blows the
deadline (or ``EDL_SERVE_SLO_MS`` when no ``dl`` came), the request is
shed with an explicit :class:`EdlOverloadError` — early, before any
decode/dispatch burns compute. Work whose deadline expired while queued
for the device is dropped at dispatch for the same reason. Every
response (success or shed) advertises ``qd`` (queue depth) and ``ew``
(estimated wait, ms) so clients can weigh their balancing by real
backlog instead of connection counts.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from edl_tpu_torch.chaos.plane import fault_point as _fault_point
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import metrics as obs_metrics
from edl_tpu_torch.obs import trace as obs_trace
from edl_tpu_torch.rpc.ndarray import decode_tree, encode_tree_zc
from edl_tpu_torch.rpc.wire import (
    TC_FIELD,
    pack_frame,
    pack_frame_buffers,
    read_frame_blocking,
    send_buffers,
    server_span,
)
from edl_tpu_torch.utils.device import resolve_device
from edl_tpu_torch.utils.exceptions import (
    EdlOverloadError,
    deserialize_exception,
    serialize_exception,
)
from edl_tpu_torch.utils.log import get_logger
from edl_tpu_torch.utils.timeline import make_timeline

_TC = obs_trace.PROPAGATION

logger = get_logger("distill.serving")

_FP_SERVE = _fault_point(
    "distill.serving.predict",
    "teacher-side predict: delay (overloaded teacher), drop (conn reset "
    "mid-request), or kill (the teacher process dies)",
)

_M_SERVE_REQUESTS = obs_metrics.counter(
    "edl_distill_serve_requests_total", "predict RPCs served by this teacher"
)
_M_SERVE_ERRORS = obs_metrics.counter(
    "edl_distill_serve_errors_total", "predict RPCs that raised"
)
_M_SERVE_SECONDS = obs_metrics.histogram(
    "edl_distill_serve_predict_seconds",
    "teacher-side predict latency (dispatch+fetch, device time included)",
)
_M_SHED = obs_metrics.counter(
    "edl_distill_shed_total",
    "predict requests shed by admission control, by cause and teacher port",
)
# labeled (not callback-bound) so several in-process teachers each get
# their own series — edl-top's SERVE panel keys on the port label
_G_QDEPTH = obs_metrics.gauge(
    "edl_distill_serve_queue_depth",
    "admitted-but-unfinished predicts, by teacher port",
)
_G_EST_WAIT = obs_metrics.gauge(
    "edl_distill_serve_est_wait_ms",
    "estimated queue wait advertised in responses, by teacher port",
)

Feeds = Dict[str, np.ndarray]


def _env_int(raw: Optional[str], default: int) -> int:
    try:
        return int(raw or default)
    except ValueError:
        return default


def _env_float(raw: Optional[str], default: float) -> float:
    try:
        return float(raw or default)
    except ValueError:
        return default


class _Admission:
    """The deadline-aware admission test (Tail-at-Scale load shedding).

    Tracks admitted-but-unfinished requests and an EWMA of service time;
    the estimated wait for a newcomer is ``depth * ewma`` (the backend
    serializes on the device lock, so backlog is roughly linear).
    ``try_admit`` sheds when the bounded queue is full or when the
    newcomer's predicted completion already misses its deadline —
    shedding EARLY is the whole point: a request doomed to time out must
    not occupy queue slots other requests could meet their SLO in."""

    def __init__(self, limit: int, slo_ms: float) -> None:
        self.limit = limit
        self.slo_ms = slo_ms
        self._lock = threading.Lock()
        self._inflight = 0
        self._ewma_s = 0.0

    def depth(self) -> int:
        with self._lock:
            return self._inflight

    def est_wait_ms(self) -> float:
        with self._lock:
            return self._inflight * self._ewma_s * 1000.0

    def snapshot(self) -> Tuple[int, float]:
        with self._lock:
            return self._inflight, self._inflight * self._ewma_s * 1000.0

    def try_admit(
        self, deadline_at: Optional[float], now: float
    ) -> Optional[Tuple[str, int, float]]:
        """Admit (returns None, depth incremented) or shed (returns
        ``(cause, qdepth, est_wait_ms)``, depth untouched)."""
        with self._lock:
            qd = self._inflight
            ew_ms = qd * self._ewma_s * 1000.0
            if self.limit > 0 and qd >= self.limit:
                return ("queue", qd, ew_ms)
            if deadline_at is not None:
                # predicted completion = queue ahead + own service time
                predicted = now + (qd + 1) * self._ewma_s
                if predicted > deadline_at:
                    return ("deadline", qd, ew_ms)
            self._inflight += 1
            return None

    def done(self, service_s: Optional[float]) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            if service_s is not None:
                self._ewma_s = (
                    service_s if self._ewma_s == 0.0
                    else 0.8 * self._ewma_s + 0.2 * service_s
                )


def _grow_socket_buffers(sock: socket.socket, size: int = 4 << 20) -> None:
    """Teacher batches are multi-MB; default 64-256KB socket buffers force
    many extra syscall round-trips per frame. The kernel clamps to its
    rmem_max/wmem_max, so this is best-effort."""
    for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
        try:
            sock.setsockopt(socket.SOL_SOCKET, opt, size)
        except OSError:
            pass


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, max(max_batch, n))


class TorchPredictBackend:
    """Wrap ``apply(feeds) -> fetchs`` (dicts of tensors on ``device``)
    with batch-bucket padding.

    Split into a non-blocking ``dispatch`` (copies the padded feeds to the
    device, enqueues the model under ``torch.inference_mode()`` and
    records a CUDA event) and a blocking ``fetch`` (waits on the event,
    returns fp32 numpy sliced back to the request's rows), so callers can
    overlap one request's device compute with another's host-side
    marshaling (``PredictServer`` locks only the dispatch)."""

    def __init__(
        self,
        apply_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
        max_batch: int = 1024,
        device="cuda",
    ) -> None:
        self._apply = apply_fn
        self._max_batch = max_batch
        self.device = resolve_device(device)

    def dispatch(self, feeds: Feeds):
        """Enqueue the padded device call; returns an opaque handle."""
        n = next(iter(feeds.values())).shape[0] if feeds else 0
        if n == 0:
            return (0, {}, None)
        bucket = _bucket(n, self._max_batch)
        if bucket != n:
            feeds = {
                k: np.concatenate(
                    [v, np.repeat(v[-1:], bucket - n, axis=0)], axis=0
                )
                for k, v in feeds.items()
            }
        with torch.inference_mode():
            # arrays off the wire are read-only views of the frame buffer
            tensors = {
                k: torch.from_numpy(np.require(v, requirements=("C", "W")))
                .to(self.device)
                for k, v in feeds.items()
            }
            out = self._apply(tensors)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return (n, out, event)

    def fetch(self, handle) -> Dict[str, np.ndarray]:
        """Block until the dispatched work is done; numpy results."""
        n, out, event = handle
        if n == 0:
            return {}
        if event is not None:
            event.synchronize()
        with torch.inference_mode():
            return {
                k: v[:n].to(torch.float32).cpu().numpy() for k, v in out.items()
            }

    def __call__(self, feeds: Feeds) -> Dict[str, np.ndarray]:
        return self.fetch(self.dispatch(feeds))


class NopPredictBackend:
    """Returns no predictions — the reference's fake teacher for pipeline
    tests (``_TestNopPaddlePredictServer``, distill_worker.py:306-315)."""

    def __call__(self, feeds: Feeds) -> Dict[str, np.ndarray]:
        return {}


class EchoPredictBackend:
    """Deterministic fake teacher: prediction = per-sample feature sum.

    Lets tests assert sample↔prediction pairing survives the concurrent
    pipeline's reordering (stronger than the reference's NOP fake)."""

    def __call__(self, feeds: Feeds) -> Dict[str, np.ndarray]:
        out = {}
        for name, arr in feeds.items():
            flat = np.asarray(arr).reshape(arr.shape[0], -1)
            # float64 ACCUMULATOR without materializing a float64 copy of
            # the batch: this backend exists to isolate pipeline overhead,
            # so its own cost must stay negligible at large batches
            out["echo_" + name] = flat.sum(
                axis=1, dtype=np.float64
            ).astype(np.float32)
        return out


class CoalescingBackend:
    """Cross-request megabatching: concat concurrent predicts into one
    device call.

    The teacher's throughput comes from big batches on the device, but
    each student connection sends ``teacher_batch_size`` rows at a time
    (reference distill_worker.py:487 slices student batches small). With
    many student workers attached, per-request inference wastes the card.
    This wrapper makes the batching dynamic and server-side: callers
    enqueue and block; a dedicated cohort-runner thread (lazily started)
    waits up to ``max_wait_ms`` for requests to accumulate (ending early
    at ``max_rows``), concatenates feeds along axis 0, runs the wrapped
    backend ONCE, and splits the fetches back per caller, FIFO — no
    caller waits more than ``max_wait_ms`` plus the device calls queued
    ahead of it. Requests whose feed keys differ run in separate
    cohorts. Thread-safe by design (``thread_safe = True`` tells
    ``PredictServer`` to skip its serializing lock — otherwise callers
    could never coalesce).

    Composes with ``TorchPredictBackend``'s bucket padding: the cohort's
    total row count is what gets padded, so N small student requests hit
    one big compiled bucket instead of N small ones.
    """

    thread_safe = True

    def __init__(
        self,
        backend: Callable[[Feeds], Dict[str, np.ndarray]],
        max_rows: int = 1024,
        max_wait_ms: float = 2.0,
    ) -> None:
        self._backend = backend
        self._max_rows = max_rows
        self._max_wait = max_wait_ms / 1000.0
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: List[dict] = []
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.batches_run = 0  # observability: device calls issued
        self.requests_served = 0
        self._obs_gauges = obs_metrics.bind_gauges((
            ("edl_distill_coalesce_batches_count",
             "device calls issued by the coalescer", lambda: self.batches_run),
            ("edl_distill_coalesce_requests_count",
             "caller requests coalesced", lambda: self.requests_served),
        ))

    def close(self) -> None:
        """Stop the cohort-runner thread (queued requests still complete).
        Without this the daemon thread pins the backend — and its device
        buffers — for the process lifetime. ``PredictServer.stop`` calls
        it automatically."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        self._obs_gauges.release()  # free this instance from the registry

    def __call__(self, feeds: Feeds) -> Dict[str, np.ndarray]:
        rows = next(iter(feeds.values())).shape[0] if feeds else 0
        item = {
            "feeds": feeds,
            "rows": rows,
            "keys": tuple(sorted(feeds)),
            "event": threading.Event(),
            "result": None,
            "error": None,
        }
        with self._cond:
            if self._closed:
                raise RuntimeError("CoalescingBackend is closed")
            # a dedicated cohort-runner (lazily started) keeps caller
            # latency bounded: a caller-as-leader design starves the
            # leader whenever new requests keep arriving mid-cohort
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run_loop, name="edl-coalesce", daemon=True
                )
                self._worker.start()
            self._queue.append(item)
            self._cond.notify_all()
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _run_loop(self) -> None:
        # one cohort's device work may stay IN FLIGHT (dispatched, not
        # fetched) while the runner collects and dispatches the next —
        # only when the wrapped backend exposes the dispatch/fetch split
        # and only while more work is queued (an in-flight cohort is
        # always resolved before the runner blocks, so no caller can be
        # left waiting on an idle pipeline)
        pending = None  # (cohort, handle) dispatched but not delivered
        while True:
            with self._cond:
                while not self._queue:
                    if pending is not None:
                        break
                    if self._closed:
                        return
                    self._cond.wait()
                if not self._queue:
                    # drained: resolve the in-flight cohort and re-wait
                    cohort = None
                else:
                    if pending is None:
                        # no cohort in flight: wait out the coalescing
                        # window. With one IN FLIGHT, take what is queued
                        # RIGHT NOW instead — waiting here would delay the
                        # pending cohort's delivery past the documented
                        # max_wait latency bound (requests kept arriving
                        # during the in-flight dispatch, so there is
                        # already a cohort's worth of accumulation).
                        deadline = time.time() + self._max_wait
                        while True:
                            rows = sum(i["rows"] for i in self._queue)
                            left = deadline - time.time()
                            if rows >= self._max_rows or left <= 0:
                                break
                            self._cond.wait(left)
                    # one cohort = longest same-keys prefix within max_rows
                    # (order preserved: a later mismatched request waits
                    # its turn)
                    cohort = []
                    taken_rows = 0
                    for it in self._queue:
                        if cohort and it["keys"] != cohort[0]["keys"]:
                            break
                        if cohort and taken_rows + it["rows"] > self._max_rows:
                            break
                        cohort.append(it)
                        taken_rows += it["rows"]
                    del self._queue[: len(cohort)]
            if cohort:
                handle = self._dispatch_cohort(cohort)
            if pending is not None:
                self._deliver(*pending)
                pending = None
            if cohort:
                if handle is not None and self._queue:
                    pending = (cohort, handle)  # overlap with the next
                else:
                    self._deliver(cohort, handle)

    def _dispatch_cohort(self, cohort: List[dict]):
        """Enqueue the cohort's device work; returns a handle, or None if
        the work already failed/completed synchronously (result/error set
        on the items; _deliver(cohort, None) finishes up)."""
        try:
            if len(cohort) == 1:
                merged = cohort[0]["feeds"]
            else:
                keys = cohort[0]["feeds"].keys()
                merged = {
                    k: np.concatenate([it["feeds"][k] for it in cohort])
                    for k in keys
                }
            dispatch = getattr(self._backend, "dispatch", None)
            if dispatch is not None:
                return dispatch(merged)
            self._split_results(cohort, self._backend(merged))
            return None
        except Exception as exc:  # noqa: BLE001 — deliver to every waiter
            for it in cohort:
                it["error"] = exc
            return None

    def _deliver(self, cohort: List[dict], handle) -> None:
        try:
            if handle is not None:
                self._split_results(cohort, self._backend.fetch(handle))
        except Exception as exc:  # noqa: BLE001 — deliver to every waiter
            for it in cohort:
                it["error"] = exc
        finally:
            for it in cohort:
                it["event"].set()

    def _split_results(
        self, cohort: List[dict], fetchs: Dict[str, np.ndarray]
    ) -> None:
        self.batches_run += 1
        self.requests_served += len(cohort)
        off = 0
        for it in cohort:
            n = it["rows"]
            it["result"] = {k: v[off : off + n] for k, v in fetchs.items()}
            off += n


class PredictServer:
    """Thread-per-connection predict server.

    Connection handling is not the bottleneck (inference is); a blocking
    thread design keeps the hot path simple. ``backend`` is any callable
    ``feeds -> fetchs``; calls are serialized under a lock because the
    device is the contended resource — unless the backend declares
    ``thread_safe = True`` (``CoalescingBackend``), in which case
    concurrent connection threads are let through so they can coalesce.
    """

    def __init__(
        self,
        backend: Callable[[Feeds], Dict[str, np.ndarray]],
        host: str = "0.0.0.0",
        port: int = 0,
        queue_limit: Optional[int] = None,
        slo_ms: Optional[float] = None,
    ) -> None:
        self._backend = backend
        # admission plane: queue_limit bounds admitted-but-unfinished
        # requests (0 disables the bound); slo_ms is the implied deadline
        # for requests that stamp no "dl" (0 disables the implied test)
        self._admission = _Admission(
            _env_int(os.environ.get("EDL_SERVE_QUEUE", "64"), 64)
            if queue_limit is None else queue_limit,
            _env_float(os.environ.get("EDL_SERVE_SLO_MS", "0"), 0.0)
            if slo_ms is None else slo_ms,
        )
        self._backend_lock = (
            contextlib.nullcontext()
            if getattr(backend, "thread_safe", False)
            else threading.Lock()
        )
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._host = host
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    @property
    def endpoint(self) -> str:
        """Routable address for registration: wildcard binds advertise this
        host's real IP so students on other hosts can connect."""
        from edl_tpu_torch.utils.net import get_host_ip

        host = self._host if self._host not in ("", "0.0.0.0") else get_host_ip()
        return "%s:%d" % (host, self.port)

    def start(self) -> "PredictServer":
        # teacher processes are long-lived job members: mount /metrics +
        # /healthz when EDL_OBS_PORT opts them in
        self._health_fn = lambda: {
            "predict_port": self.port,
            "requests": _M_SERVE_REQUESTS.value(),
        }
        self._obs = obs_http.start_from_env(
            "teacher", health_fn=self._health_fn
        )
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="edl-predict-accept", daemon=True
        )
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        health_fn = getattr(self, "_health_fn", None)
        if health_fn is not None:
            obs_http.release_health("teacher", health_fn)
        close_backend = getattr(self._backend, "close", None)
        if callable(close_backend):
            close_backend()
        # shutdown before close: a thread blocked in accept() pins the
        # kernel file description, so close() alone leaves the socket in
        # LISTEN and the port unbindable until that accept returns.
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        # close live connections too: lingering ESTABLISHED sockets would
        # otherwise hold the port and block a same-port teacher restart
        with self._conns_lock:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        # wait out the accept and connection threads: a daemon thread still
        # unwinding while the interpreter finalizes aborts the process in
        # torch's teardown (a request mid-predict gets a bounded wait)
        me = threading.current_thread()
        for t in [self._accept_thread, *self._threads]:
            if t is not None and t is not me:
                t.join(timeout=5.0)

    @staticmethod
    def _check_deadline(deadline_at: Optional[float]) -> None:
        """Drop expired work at dispatch: the client has given up by
        now, so running the backend would burn device time nobody reads."""
        if deadline_at is not None and time.monotonic() > deadline_at:
            raise EdlOverloadError("deadline expired while queued")

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(sock, addr), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, sock: socket.socket, addr) -> None:
        # legacy stderr lines only (feed_tracer=False): the predict
        # interval is span-recorded directly below, always-on
        timeline = make_timeline(feed_tracer=False)
        tracer = obs_trace.get_tracer()
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _grow_socket_buffers(sock)
        with self._conns_lock:
            self._conns.add(sock)
        try:
            while not self._stop.is_set():
                req = read_frame_blocking(sock)
                rid = req.get("i", 0)
                method = req.get("m")
                if method == "ping":
                    sock.sendall(pack_frame({"i": rid, "ok": True}))
                    continue
                if _FP_SERVE.armed:
                    # port ctx lets a chaos rule target ONE teacher of an
                    # in-process fleet (match={"port": ...})
                    _FP_SERVE.fire(method=str(method), port=self.port)
                if method != "predict":
                    sock.sendall(
                        pack_frame(
                            {"i": rid, "ok": False,
                             "err": {"etype": "EdlInternalError",
                                     "detail": "unknown method %r" % method}}
                        )
                    )
                    continue
                # -- admission test (shed EARLY: before any decode) --------
                now = time.monotonic()
                dl_ms = req.get("dl")  # remaining deadline budget, ms
                deadline_at = None
                if isinstance(dl_ms, (int, float)) and dl_ms > 0:
                    deadline_at = now + float(dl_ms) / 1000.0
                elif self._admission.slo_ms > 0:
                    deadline_at = now + self._admission.slo_ms / 1000.0
                shed = self._admission.try_admit(deadline_at, now)
                if shed is not None:
                    cause, qd, ew = shed
                    _M_SHED.inc(cause=cause, port=str(self.port))
                    _G_QDEPTH.set(qd, port=str(self.port))
                    _G_EST_WAIT.set(ew, port=str(self.port))
                    exc = EdlOverloadError(
                        "shed (%s): queue %d, est wait %.0f ms"
                        % (cause, qd, ew),
                        qdepth=qd, est_wait_ms=ew,
                    )
                    sock.sendall(pack_frame({
                        "i": rid, "ok": False, "qd": qd,
                        "ew": round(ew, 3),
                        "err": serialize_exception(exc),
                    }))
                    continue
                service_s = None
                try:
                    # arrays arrive pre-resolved from the EDL2 frame
                    feeds = decode_tree(req.get("feeds", {}))
                    t0 = time.monotonic()
                    # per-method server latency + caller-linked span when
                    # the student stamped a "tc" trace context
                    with server_span(
                        "predict", req.get(TC_FIELD), server="distill"
                    ):
                        dispatch = getattr(self._backend, "dispatch", None)
                        if dispatch is not None:
                            # lock only the enqueue: connection B's device
                            # work overlaps connection A's result fetch +
                            # encode + socket send
                            with self._backend_lock:
                                self._check_deadline(deadline_at)
                                timeline.reset()
                                handle = dispatch(feeds)
                            fetchs = self._backend.fetch(handle)
                            timeline.record("predict")
                        else:
                            with self._backend_lock:
                                self._check_deadline(deadline_at)
                                timeline.reset()
                                fetchs = self._backend(feeds)
                                timeline.record("predict")
                    dt = time.monotonic() - t0
                    service_s = dt
                    _M_SERVE_REQUESTS.inc()
                    _M_SERVE_SECONDS.observe(dt)
                    tracer.record("teacher_predict", t0, dt)
                    qd, ew = self._admission.snapshot()
                    payload, atts = encode_tree_zc(
                        {"i": rid, "ok": True, "fetchs": fetchs,
                         "qd": qd - 1, "ew": round(ew, 3)}
                    )
                    buffers = pack_frame_buffers(payload, atts)
                except EdlOverloadError as exc:
                    # deadline expired while queued for the device: the
                    # backend never saw it — a shed, not a server error
                    _M_SHED.inc(cause="expired", port=str(self.port))
                    qd, ew = self._admission.snapshot()
                    buffers = [
                        pack_frame(
                            {"i": rid, "ok": False, "qd": qd - 1,
                             "ew": round(ew, 3),
                             "err": serialize_exception(exc)}
                        )
                    ]
                except Exception as exc:  # noqa: BLE001 — report to client
                    logger.exception("predict failed")
                    _M_SERVE_ERRORS.inc()
                    buffers = [
                        pack_frame(
                            {"i": rid, "ok": False,
                             "err": serialize_exception(exc)}
                        )
                    ]
                finally:
                    self._admission.done(service_s)
                    qd, ew = self._admission.snapshot()
                    _G_QDEPTH.set(qd, port=str(self.port))
                    _G_EST_WAIT.set(ew, port=str(self.port))
                # send outside the try: a mid-send socket error must hit the
                # outer handler and close the (now desynced) connection, not
                # append an error frame into a half-sent EDL2 frame
                send_buffers(sock, buffers)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(sock)
            try:
                sock.close()
            except OSError:
                pass


class PredictClient:
    """Blocking predict client; one TCP connection, sequential requests.

    Retries are the *pipeline's* job (predict_loop re-queues failed tasks,
    matching reference distill_worker.py:437-446); the client only raises.
    """

    def __init__(self, endpoint: str, timeout: float = 30.0) -> None:
        self.endpoint = endpoint
        host, port = endpoint.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)), timeout=timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _grow_socket_buffers(self._sock)
        self._next_id = 0
        # the teacher's advertised backlog, refreshed by every response
        # (success or shed) — queue-aware balancing reads these
        self.last_qdepth = 0
        self.last_wait_ms = 0.0

    def predict(
        self, feeds: Feeds, deadline_s: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """One predict RPC. ``deadline_s`` (remaining budget, seconds) is
        stamped as the relative ``dl`` wire field so the teacher can shed
        at admission / drop expired work; a shed surfaces as
        :class:`EdlOverloadError` (alive server saying back off), every
        other failure stays :class:`ConnectionError` (dead/unknown)."""
        self._next_id += 1
        rid = self._next_id
        req = {"i": rid, "m": "predict", "feeds": feeds}
        if deadline_s is not None and deadline_s > 0:
            req["dl"] = round(deadline_s * 1000.0, 1)
        # trace propagation: one attr load disarmed (wire discipline)
        if _TC.armed:
            tc = obs_trace.inject()
            if tc is not None:
                req[TC_FIELD] = tc
        payload, atts = encode_tree_zc(req)
        send_buffers(self._sock, pack_frame_buffers(payload, atts))
        resp = read_frame_blocking(self._sock)
        qd = resp.get("qd")
        if isinstance(qd, (int, float)):
            self.last_qdepth = int(qd)
        ew = resp.get("ew")
        if isinstance(ew, (int, float)):
            self.last_wait_ms = float(ew)
        if not resp.get("ok"):
            err = resp.get("err", {})
            exc = deserialize_exception(err)
            if isinstance(exc, EdlOverloadError):
                exc.qdepth = self.last_qdepth
                exc.est_wait_ms = self.last_wait_ms
                raise exc
            raise ConnectionError(
                "predict failed at %s: %s" % (self.endpoint, err.get("detail"))
            )
        return decode_tree(resp.get("fetchs", {}))

    def ping(self) -> bool:
        self._next_id += 1
        self._sock.sendall(pack_frame({"i": self._next_id, "m": "ping"}))
        return bool(read_frame_blocking(self._sock).get("ok"))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
