"""Op-latency timeline tracer, env-gated. DEPRECATED shim.

Capability parity with the reference's ``_TimeLine`` distill profiler
(python/edl/distill/timeline.py:19-44): per-pid op-latency lines to stderr
when ``EDL_TIMELINE=1`` (the reference's env was ``DISTILL_READER_PROFILE``),
a zero-cost no-op otherwise. Used at queue get/put and RPC boundaries of the
distill pipeline and the data service.
"""

from __future__ import annotations

import os
import sys
import time


class _ObsTimeline:
    """reset()/record() adapter over :mod:`edl_tpu_torch.obs.trace`.

    Keeps the legacy contract — a ``record(op)`` closes the span opened
    by the previous ``reset()``/``record()`` and prints the stderr line —
    while ALSO recording the span into the process tracer, so
    ``EDL_TIMELINE=1`` runs show up in ``EDL_TRACE_DIR`` exports and the
    merged job timeline.
    """

    __slots__ = ("_pid", "_t0", "_tracer")

    def __init__(self, feed_tracer: bool = True) -> None:
        self._pid = os.getpid()
        self._tracer = None
        if feed_tracer:
            from edl_tpu_torch.obs.trace import get_tracer

            self._tracer = get_tracer()
        self._t0 = time.monotonic()

    def reset(self) -> None:
        self._t0 = time.monotonic()

    def record(self, op: str, **extra) -> None:
        now = time.monotonic()
        if self._tracer is not None:
            self._tracer.record(op, self._t0, now - self._t0, **extra)
        fields = "".join(" %s=%s" % kv for kv in sorted(extra.items()))
        sys.stderr.write(
            "[timeline] pid=%d op=%s span=%.6f ts=%.6f%s\n"
            % (self._pid, op, now - self._t0, time.time(), fields)
        )
        self._t0 = now


class _NopTimeline:
    __slots__ = ()

    def reset(self) -> None:
        pass

    def record(self, op: str, **extra) -> None:
        pass


def make_timeline(feed_tracer: bool = True):
    """Return a tracer; real when EDL_TIMELINE=1 else a no-op.

    .. deprecated:: Use :func:`edl_tpu_torch.obs.trace.span` /
       :func:`edl_tpu_torch.obs.trace.get_tracer` directly — the obs tracer is
       bounded, always-on, and exports mergeable Chrome traces. This
       shim survives only so ``EDL_TIMELINE=1`` keeps printing the
       legacy stderr lines (by default *also* feeding the obs tracer;
       pass ``feed_tracer=False`` at call sites whose interval is
       already span-recorded directly, or the ring holds every op
       twice).
    """
    if os.environ.get("EDL_TIMELINE", "0") == "1":
        return _ObsTimeline(feed_tracer)
    return _NopTimeline()
