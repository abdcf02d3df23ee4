"""Span tracer: bounded in-process timeline, Chrome-trace-event export.

Replaces the stderr-only ``_RealTimeline`` one-shot profiler
(``utils/timeline.py``, now a shim over this) with a real
tracing plane:

- ``span()`` is a context manager over ``time.monotonic()`` (wall-clock
  NTP steps can't produce negative or bogus durations);
- completed spans land in a ring buffer (``maxlen`` bounded — tracing a
  million-step job costs a fixed few MB, never OOM);
- export is Chrome trace-event JSON (``chrome://tracing`` / Perfetto).
  Timestamps are mapped back to unix-epoch microseconds through a
  (wall, monotonic) anchor captured at tracer creation, so traces from
  DIFFERENT processes of one job line up on one absolute timeline and
  :mod:`edl_tpu.obs.merge` can splice them without clock negotiation.

Env contract:

    EDL_TRACE_DIR        when set, the process tracer auto-exports to
                         ``{dir}/{component}-{pid}.trace.json`` at exit,
                         every ``EDL_TRACE_INTERVAL`` seconds (default
                         10; atomic replace), and on demand via
                         ``export()``. The periodic export is what makes
                         SIGTERM-killed workers — the NORMAL end of every
                         non-final elastic stage — leave their spans
                         behind: atexit never runs under the default
                         SIGTERM disposition.
    EDL_TRACE_PROPAGATE  distributed-tracing master switch: "1" forces
                         wire-level trace-context propagation on, "0"
                         forces it off; unset, propagation follows
                         ``EDL_TRACE_DIR`` (a job that exports traces
                         wants them stitched). Disarmed, every call site
                         pays ONE attribute load per frame — the same
                         discipline as the chaos fault points.

The per-process tracer is a lazy singleton (``get_tracer()``); library
code records into it unconditionally — recording is a deque append, and
the buffer bound makes "always on" safe.

Distributed causal tracing (DESIGN.md "Distributed tracing"): spans can
carry Dapper-style ``trace_id``/``span_id``/``parent_id`` linkage in
their args. Context lives in a contextvar (request-scoped spans: one
store RPC, one predict) layered over a process-wide *operation* context
(the restage/drain window a worker lives in from spawn to first step).
Clients inject the current context as a ``"tc"`` field in EDL1 request
payloads; servers adopt it so their handler spans become children of
the caller's span — see :func:`child_span` and
:func:`edl_tpu_torch.rpc.wire.server_span`. Job-level operations (restage,
drain) derive their trace id DETERMINISTICALLY from a key every
participant already shares (the stage token, the pod id), so the drain
trigger in one launcher, the publish in another, and the restore in a
freshly spawned worker all stitch into one trace with zero extra wire
traffic — ``tools/edl_trace.py`` extracts the cross-process critical
path from the merged exports.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterator, List, NamedTuple, Optional

DEFAULT_MAXLEN = 16384


# -- distributed trace context ------------------------------------------------


class TraceContext(NamedTuple):
    """One node of a distributed trace: ``span_id`` is the node, and any
    span recorded UNDER this context parents to it."""

    trace_id: str
    span_id: str

    def wire(self) -> List[str]:
        """The ``"tc"`` request-payload field (EDL1 convention)."""
        return [self.trace_id, self.span_id]


def context_from_wire(tc) -> Optional["TraceContext"]:
    """Parse a ``"tc"`` payload field; None on anything malformed — a
    hostile or torn field must degrade to an unlinked span, never error
    the server's dispatch loop."""
    if not isinstance(tc, (list, tuple)) or len(tc) < 2:
        return None
    try:
        trace_id, span_id = tc[0], tc[1]
        if isinstance(trace_id, bytes):
            trace_id = trace_id.decode()
        if isinstance(span_id, bytes):
            span_id = span_id.decode()
        if not isinstance(trace_id, str) or not isinstance(span_id, str):
            return None
        if not trace_id or not span_id or len(trace_id) > 64 or len(span_id) > 64:
            return None
        return TraceContext(trace_id, span_id)
    except (TypeError, IndexError, KeyError, UnicodeDecodeError):
        return None


class _Propagation:
    """Arming state for wire-level context propagation.

    ``armed`` is a plain bool attribute so the disarmed cost at every
    call site is one attribute load per frame — the same discipline as
    the chaos fault points and the bound counters in rpc/wire.py.
    """

    __slots__ = ("armed",)

    def __init__(self) -> None:
        self.armed = self._from_env()

    @staticmethod
    def _from_env() -> bool:
        flag = os.environ.get("EDL_TRACE_PROPAGATE", "").strip()
        if flag:
            return flag != "0"
        return bool(os.environ.get("EDL_TRACE_DIR"))

    def rearm(self) -> bool:
        """Re-read the env (tests, and processes that set EDL_TRACE_DIR
        after import)."""
        self.armed = self._from_env()
        return self.armed


PROPAGATION = _Propagation()

# request-scoped context (one RPC, one predict): contextvar so server
# handler threads and nested client calls stay correctly scoped
_ctx: "contextvars.ContextVar[Optional[TraceContext]]" = contextvars.ContextVar(
    "edl_trace_ctx", default=None
)
# process-wide operation context (the restage/drain window this process
# currently lives in): plain module state so EVERY thread — checkpoint
# restore, cache pull, reconnect loops — inherits it without contextvar
# plumbing. Written only by begin/end_process_op.
_op_ctx: Optional[TraceContext] = None


def _span_id() -> str:
    return os.urandom(8).hex()


def op_trace_id(op: str, key: str) -> str:
    """Deterministic trace id for a job-level operation: every process
    that knows ``(op, key)`` — e.g. ("restage", stage_token) — computes
    the same id, so cross-process segments stitch with no negotiation."""
    return hashlib.sha256(("edl:%s:%s" % (op, key)).encode()).hexdigest()[:16]  # edl: blocking-ok(one sha256 over a <64-byte key at operation roots: microseconds, rarer than a lease sweep)


def op_root_id(trace_id: str) -> str:
    """Deterministic span id of an operation's root anchor: segments can
    parent to the root before (or without) ever seeing it recorded."""
    return hashlib.sha256(("root:%s" % trace_id).encode()).hexdigest()[:16]  # edl: blocking-ok(one sha256 over a 16-byte trace id: microseconds, rarer than a lease sweep)


def op_context(op: str, key: str) -> TraceContext:
    tid = op_trace_id(op, key)
    return TraceContext(tid, op_root_id(tid))


def current() -> Optional[TraceContext]:
    """The effective context: an explicit span scope wins, else the
    process's operation window, else None."""
    ctx = _ctx.get()
    return ctx if ctx is not None else _op_ctx


def current_trace_id() -> Optional[str]:
    ctx = current()
    return ctx.trace_id if ctx is not None else None


def inject() -> Optional[List[str]]:
    """The ``"tc"`` field for an outgoing request, or None. Call sites
    guard with ``PROPAGATION.armed`` first so the disarmed hot path pays
    one attribute load, not a function call."""
    ctx = current()
    return ctx.wire() if ctx is not None else None


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Make ``ctx`` current for the block WITHOUT recording a span (e.g.
    so a flight record inherits an operation's trace id)."""
    token = _ctx.set(ctx)
    try:
        yield ctx
    finally:
        _ctx.reset(token)


@contextlib.contextmanager
def child_span(name: str, tc: Optional[TraceContext] = None, **args):
    """Record ``name`` as a child span of ``tc`` (or the current
    context); within the block the new span is the current context, so
    nested spans and injected requests parent to it. With no parent at
    all, the span roots a fresh trace."""
    parent = tc if tc is not None else current()
    if parent is not None:
        ctx = TraceContext(parent.trace_id, _span_id())
        args = dict(args, parent_id=parent.span_id)
    else:
        ctx = TraceContext(_span_id() + _span_id(), _span_id())
    args["trace_id"] = ctx.trace_id
    args["span_id"] = ctx.span_id
    token = _ctx.set(ctx)
    t0 = time.monotonic()
    try:
        yield ctx
    except Exception as exc:
        args["error"] = type(exc).__name__
        raise
    finally:
        _ctx.reset(token)
        get_tracer().record(name, t0, time.monotonic() - t0, **args)


@contextlib.contextmanager
def op_segment(name: str, op: str, key: str, **args):
    """One segment of a deterministic operation trace: a child span of
    the (possibly not-yet-recorded) op root. For processes that touch an
    operation without living inside it — the leader publishing a stage,
    a peer spawning workers."""
    with child_span(name, tc=op_context(op, key), op=op, **args) as ctx:
        yield ctx


def record_op_root(op: str, key: str, **args) -> TraceContext:
    """Record the operation's root anchor span (zero duration — the op's
    extent is its segments') with the deterministic ids; returns the
    root context. Exactly one process should call this per op instance
    (the CAS winner, the promoted standby); everyone else records
    segments that parent to the derived root id."""
    ctx = op_context(op, key)
    get_tracer().record(
        "op:%s" % op, time.monotonic(), 0.0,
        op=op, op_key=key, root=True,
        trace_id=ctx.trace_id, span_id=ctx.span_id, **args,
    )
    return ctx


def begin_process_op(op: str, key: str, **args) -> Optional[TraceContext]:
    """Enter a process-wide operation window (a worker's restage from
    spawn/init to first step, a drain from notice to exit): until
    :func:`end_process_op`, every span recorded without a more specific
    context — and every flight-recorder record — carries this trace.
    Re-entering the SAME op+key is a no-op (init() runs twice)."""
    global _op_ctx
    ctx = op_context(op, key)
    if _op_ctx is not None and _op_ctx.trace_id == ctx.trace_id:
        return _op_ctx
    _op_ctx = ctx
    if args and PROPAGATION.armed:
        get_tracer().instant("op_enter:%s" % op, **args)
    return ctx


def end_process_op() -> None:
    """Leave the process operation window. Callers record their closing
    segment (``first_step``) BEFORE ending the window, so auto-linkage
    (see :meth:`SpanTracer.record`) stitches it into the op trace."""
    global _op_ctx
    _op_ctx = None


def reset_context() -> None:
    """Drop every live context (tests)."""
    global _op_ctx
    _op_ctx = None
    _ctx.set(None)


class _SpanHandle:
    """Context manager minted by :meth:`SpanTracer.span`."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "SpanTracer", name: str, args: Dict) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_SpanHandle":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.args = dict(self.args, error=exc_type.__name__)
        self._tracer.record(
            self.name, self._t0, time.monotonic() - self._t0, **self.args
        )


class SpanTracer:
    """Ring-buffer span recorder for ONE process.

    ``component`` names the process in merged traces (store, launcher,
    worker-0, teacher, ...). All public methods are thread-safe.
    """

    def __init__(
        self,
        component: str = "",
        maxlen: int = DEFAULT_MAXLEN,
        pid: Optional[int] = None,
    ) -> None:
        self.component = component or "proc"
        self.pid = os.getpid() if pid is None else pid
        # (wall, monotonic) anchor: event ts = anchor_wall + (mono - anchor_mono)
        self._anchor_wall = time.time()
        self._anchor_mono = time.monotonic()
        self._events: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **args) -> _SpanHandle:
        """``with tracer.span("train_step", step=i): ...``"""
        return _SpanHandle(self, name, args)

    def record(self, name: str, t0_mono: float, dur_s: float, **args) -> None:
        """Record a completed span (monotonic start + duration seconds).

        With propagation armed and a live trace context (a request scope
        or the process's operation window), spans that do not already
        carry linkage become CHILDREN of it automatically — this is how
        pre-existing instrumentation (ckpt_restore, spawn_workers,
        train_step) stitches into restage traces without per-site edits.
        """
        if PROPAGATION.armed and "trace_id" not in args:
            ctx = current()
            if ctx is not None:
                args = dict(
                    args, trace_id=ctx.trace_id, span_id=_span_id(),
                    parent_id=ctx.span_id,
                )
        ev = {
            "name": name,
            "ph": "X",
            "ts": self._to_epoch_us(t0_mono),
            "dur": max(0.0, dur_s) * 1e6,
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, ts_wall: Optional[float] = None, **args) -> None:
        """Zero-duration marker (drain triggered, stage published, ...).

        ``ts_wall`` back-dates the marker to a known unix timestamp —
        lazily-flushed events (WorkerMeter's first_step after a slow
        store connect) must land at the time they HAPPENED, or the
        merged trace's downtime decomposition is off by the flush delay.
        """
        if PROPAGATION.armed and "trace_id" not in args:
            ctx = current()
            if ctx is not None:
                args = dict(args, trace_id=ctx.trace_id, parent_id=ctx.span_id)
        ev = {
            "name": name,
            "ph": "i",
            "s": "p",
            "ts": ts_wall * 1e6 if ts_wall is not None
            else self._to_epoch_us(time.monotonic()),
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def _to_epoch_us(self, mono: float) -> float:
        return (self._anchor_wall + (mono - self._anchor_mono)) * 1e6

    # -- export ------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_events(self) -> List[dict]:
        """Snapshot as Chrome trace events, process metadata included."""
        with self._lock:
            events = list(self._events)
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": self.pid,
                "args": {"name": self.component},
            }
        ]
        return meta + events

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write ``{"traceEvents": [...]}`` JSON; returns the path.

        Default path needs ``EDL_TRACE_DIR``; without it (and without an
        explicit ``path``) export is a no-op returning None — tracing
        must never error a process that didn't opt in.
        """
        if path is None:
            trace_dir = os.environ.get("EDL_TRACE_DIR")
            if not trace_dir:
                return None
            path = os.path.join(
                trace_dir, "%s-%d.trace.json" % (self.component, self.pid)
            )
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = "%s.tmp.%d" % (path, self.pid)
            with open(tmp, "w") as f:
                # default=str: one numpy scalar passed as a span arg must
                # not poison every future export of the process
                json.dump(
                    {"traceEvents": self.to_events(), "displayTimeUnit": "ms"},
                    f,
                    default=str,
                )
                # postmortems read these after crashes: the atomic rename
                # below only persists the name without a preceding fsync
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — tracing never errors its host
            return None


_tracer: Optional[SpanTracer] = None
_tracer_lock = threading.Lock()


def get_tracer(component: Optional[str] = None) -> SpanTracer:
    """The process tracer (lazy singleton).

    The first caller names the process (later ``component`` args only
    fill in a still-default name); when ``EDL_TRACE_DIR`` is set an
    atexit export hook is registered so every instrumented process
    leaves its timeline behind without explicit teardown.
    """
    global _tracer
    with _tracer_lock:
        if _tracer is None:
            name = component or _default_component()
            _tracer = SpanTracer(component=name)
            if os.environ.get("EDL_TRACE_DIR"):
                atexit.register(_tracer.export)
                _start_periodic_export(_tracer)
        elif component and _tracer.component == "proc":
            _tracer.component = component
        return _tracer


def _start_periodic_export(tracer: SpanTracer) -> None:
    """Flush the ring buffer to disk on a timer: elastic workers die by
    SIGTERM at every resize, which skips atexit — the periodic file
    (atomically replaced) is the trace they leave behind."""
    try:
        interval = float(os.environ.get("EDL_TRACE_INTERVAL", "10"))
    except ValueError:
        interval = 10.0
    if interval <= 0:
        return

    def _loop() -> None:
        while True:
            time.sleep(interval)
            tracer.export()

    threading.Thread(
        target=_loop, name="edl-trace-export", daemon=True
    ).start()


def _default_component() -> str:
    comp = os.environ.get("EDL_OBS_COMPONENT")
    if comp:
        return comp
    if os.environ.get("EDL_WORKER_RANK") is not None and os.environ.get(
        "EDL_JOB_ID"
    ):
        return "worker-%s" % os.environ.get("EDL_WORKER_RANK")
    return "proc"


def span(name: str, **args) -> _SpanHandle:
    """Record a span into the process tracer."""
    return get_tracer().span(name, **args)
