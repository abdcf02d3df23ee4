"""Process-local metrics registry: counters, gauges, histograms.

The reference has no metrics plane at all — its elastic claims are
wall-clock demos (README.md:96-151) and its only live signal is a
stderr profiler. This registry is the in-process half of the edl_tpu_torch
observability layer: every long-lived process (store server, launcher,
data dispatcher, distill teacher, train worker) registers instruments
here and mounts :class:`edl_tpu.obs.http.ObsServer` to serve them as
Prometheus text.

Naming convention (lint-enforced by tests/test_obs.py): every metric is
``edl_<component>_<name>_<unit>`` — lowercase, underscore-separated, at
least three segments after the ``edl`` prefix counts as two (component +
name-with-unit). Counters end in ``_total`` per Prometheus convention
(``total`` is the unit segment); durations end in ``_seconds``, sizes in
``_bytes``, depths in ``_depth``/``_tasks``.

Instruments are get-or-create by name (a process has ONE instrument per
name regardless of how many objects instrument it) and observation is
fire-and-forget cheap: a lock + dict update, no I/O — observability must
never take down (or slow down) the thing it observes. Labeled children
(``counter(...).labels(method="put")``) pre-resolve the label lookup so
hot paths pay one dict hit per observation, not a tuple build.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

# edl_<component>_<name>_<unit>: >= 3 underscore segments after "edl"
# would be ideal, but component/name/unit are each >= 1 segment, so the
# enforceable floor is edl_ + two more segments, all [a-z0-9].
METRIC_NAME_RE = re.compile(r"^edl(_[a-z][a-z0-9]*){2,}$")

# Default duration buckets (seconds): micro-RPCs to multi-minute
# checkpoint writes on one fixed grid, so cross-process histograms merge.
DURATION_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)
# Default size buckets (bytes): 64B frames to multi-GB checkpoints.
SIZE_BUCKETS = tuple(float(1 << p) for p in range(6, 33, 2))

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_value(v: float) -> str:
    v = float(v)
    # Prometheus text spellings for non-finite values — int(nan) raises,
    # and one poisoned observation must not break every future scrape
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def _render_labels(key: LabelKey, extra: str = "") -> str:
    parts = ['%s="%s"' % (k, _escape_label(v)) for k, v in key]
    if extra:
        parts.append(extra)
    if not parts:
        return ""
    return "{%s}" % ",".join(parts)


class _Instrument:
    """Shared base: named, helped, thread-safe, optionally labeled."""

    kind = "untyped"

    def __init__(self, name: str, help: str) -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()

    def render(self) -> List[str]:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count. ``inc(n, **labels)``."""

    kind = "counter"

    def __init__(self, name: str, help: str) -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels: str) -> None:
        if n < 0:
            raise ValueError("counter %s cannot decrease" % self.name)
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def labels(self, **labels: str) -> "_BoundCounter":
        return _BoundCounter(self, _label_key(labels))

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            items = [((), 0.0)]
        return [
            "%s%s %s" % (self.name, _render_labels(k), _format_value(v))
            for k, v in items
        ]


class _BoundCounter:
    """Label-resolved counter child: one dict hit per inc, no tuple
    build — for per-frame hot paths (rpc/wire.py)."""

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: Counter, key: LabelKey) -> None:
        self._counter = counter
        self._key = key

    def inc(self, n: float = 1.0) -> None:
        c = self._counter
        with c._lock:
            c._values[self._key] = c._values.get(self._key, 0.0) + n


class Gauge(_Instrument):
    """Point-in-time value. ``set``/``inc``/``dec``, or ``set_fn`` a
    zero-arg callable sampled at render time (queue depths, connection
    counts — the value lives in the owning object, not the metric)."""

    kind = "gauge"

    def __init__(self, name: str, help: str) -> None:
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels: str) -> None:
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels: str) -> None:
        self.inc(-n, **labels)

    def set_fn(self, fn: Callable[[], float]) -> "Gauge":
        """Sample ``fn()`` at render time (unlabeled series only)."""
        with self._lock:
            self._fn = fn
        return self

    def clear_fn(self, fn: Optional[Callable[[], float]] = None) -> None:
        """Drop the render-time callback — owners MUST call this on stop,
        or the process-global registry pins them (and whatever their
        closure reaches, e.g. queued batches) alive forever. With ``fn``
        given, clears only if it is still the registered one, so a
        stopping instance never strips its replacement's callback."""
        with self._lock:
            if fn is None or self._fn is fn:
                self._fn = None

    def value(self, **labels: str) -> float:
        with self._lock:
            fn = self._fn
        if fn is not None and not labels:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a dead owner must not kill render
                return float("nan")
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._values.items())
            fn = self._fn
        if fn is not None:
            try:
                items = [((), float(fn()))] + [i for i in items if i[0]]
            except Exception:  # noqa: BLE001
                pass
        if not items:
            items = [((), 0.0)]
        return [
            "%s%s %s" % (self.name, _render_labels(k), _format_value(v))
            for k, v in items
        ]


class Histogram(_Instrument):
    """Fixed-bucket histogram: cumulative bucket counts + sum + count.

    Buckets are fixed at registration (cross-process merges need one
    grid); observation is O(buckets) increments under the lock.
    """

    kind = "histogram"

    def __init__(
        self, name: str, help: str, buckets: Sequence[float] = DURATION_BUCKETS
    ) -> None:
        super().__init__(name, help)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram %s needs at least one bucket" % name)
        self.buckets: Tuple[float, ...] = tuple(bs)
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sums: Dict[LabelKey, float] = {}
        self._totals: Dict[LabelKey, int] = {}

    def observe(self, v: float, **labels: str) -> None:
        self._observe_key(_label_key(labels), float(v))

    def _observe_key(self, key: LabelKey, v: float) -> None:
        """The one locked observation body, shared with
        :class:`_BoundHistogram` so the labeled and direct paths can
        never diverge."""
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
                self._sums[key] = 0.0
                self._totals[key] = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            self._sums[key] += v
            self._totals[key] += 1

    def time(self, **labels: str) -> "_Timer":
        """``with hist.time(): ...`` observes the block's wall time."""
        return _Timer(self, labels)

    def labels(self, **labels: str) -> "_BoundHistogram":
        """Label-resolved child: per-observation cost is the lock + the
        bucket scan, no tuple build — the per-frame discipline of
        ``_BoundCounter``, for rpc/wire.py's server-side histogram."""
        return _BoundHistogram(self, _label_key(labels))

    def count(self, **labels: str) -> int:
        with self._lock:
            return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        with self._lock:
            return self._sums.get(_label_key(labels), 0.0)

    def render(self) -> List[str]:
        with self._lock:
            keys = sorted(self._counts) or [()]
            snap = {
                k: (list(self._counts.get(k, [])), self._sums.get(k, 0.0),
                    self._totals.get(k, 0))
                for k in keys
            }
        out: List[str] = []
        for key in keys:
            counts, total_sum, total = snap[key]
            if not counts:
                counts = [0] * len(self.buckets)
            cum = 0
            for b, c in zip(self.buckets, counts):
                cum += c
                out.append(
                    "%s_bucket%s %d"
                    % (self.name, _render_labels(key, 'le="%s"' % _format_value(b)), cum)
                )
            out.append(
                "%s_bucket%s %d"
                % (self.name, _render_labels(key, 'le="+Inf"'), total)
            )
            out.append(
                "%s_sum%s %s" % (self.name, _render_labels(key), _format_value(total_sum))
            )
            out.append("%s_count%s %d" % (self.name, _render_labels(key), total))
        return out


class _BoundHistogram:
    """Label-resolved histogram child (see :meth:`Histogram.labels`):
    per-observation cost is the shared locked body, no tuple build."""

    __slots__ = ("_hist", "_key")

    def __init__(self, hist: Histogram, key: LabelKey) -> None:
        self._hist = hist
        self._key = key

    def observe(self, v: float) -> None:
        self._hist._observe_key(self._key, float(v))


class _Timer:
    __slots__ = ("_hist", "_labels", "_t0")

    def __init__(self, hist: Histogram, labels: Dict[str, str]) -> None:
        self._hist = hist
        self._labels = labels

    def __enter__(self) -> "_Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self._hist.observe(time.monotonic() - self._t0, **self._labels)


class MetricsRegistry:
    """Thread-safe instrument registry with Prometheus text rendering.

    Get-or-create semantics: registering an existing name returns the
    existing instrument (type mismatch raises — two subsystems fighting
    over one name is a bug, not a race to tolerate).
    """

    def __init__(self, validate_names: bool = True) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._validate = validate_names

    def _register(self, cls, name: str, help: str, **kwargs) -> _Instrument:
        if self._validate and not METRIC_NAME_RE.match(name):
            raise ValueError(
                "metric name %r violates the edl_<component>_<name>_<unit> "
                "convention (%s)" % (name, METRIC_NAME_RE.pattern)
            )
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, inst.kind, cls.kind)
                    )
                return inst
            inst = cls(name, help, **kwargs)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(
        self,
        name: str,
        help: str = "",
        buckets: Sequence[float] = DURATION_BUCKETS,
    ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def render(self) -> str:
        """The full registry as Prometheus exposition text (version 0.0.4)."""
        with self._lock:
            instruments = [self._instruments[n] for n in sorted(self._instruments)]
        lines: List[str] = []
        for inst in instruments:
            if inst.help:
                lines.append("# HELP %s %s" % (inst.name, inst.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (inst.name, inst.kind))
            lines.extend(inst.render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Scalar view for JSON consumers (healthz, edl-top): name ->
        {rendered-series-suffix: value}; histograms report _count/_sum."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            instruments = list(self._instruments.values())
        for inst in instruments:
            if isinstance(inst, Histogram):
                with inst._lock:
                    out[inst.name] = {
                        "count": float(sum(inst._totals.values())),
                        "sum": float(sum(inst._sums.values())),
                    }
            elif isinstance(inst, (Counter, Gauge)):
                series: Dict[str, float] = {}
                for line in inst.render():
                    name_part, _, value = line.rpartition(" ")
                    series[name_part[len(inst.name):] or ""] = float(value)
                out[inst.name] = series
        return out


class GaugeBinding:
    """Owned set of callback gauges with a single release point.

    The registry is process-global, so a ``set_fn`` closure pins its
    owner (and everything the closure reaches — queues, store state)
    until replaced. This helper makes the pairing impossible to get
    wrong: bind at construction, ``release()`` at stop (identity-guarded
    per gauge, so a replacement instance that already rebound is left
    alone).
    """

    def __init__(
        self,
        specs: Iterable[Tuple[str, str, Callable[[], float]]],
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        reg = registry if registry is not None else _default
        self._bound: List[Tuple[Gauge, Callable[[], float]]] = []
        for name, help_text, fn in specs:
            gauge = reg.gauge(name, help_text)
            gauge.set_fn(fn)
            self._bound.append((gauge, fn))

    def release(self) -> None:
        for gauge, fn in self._bound:
            gauge.clear_fn(fn)


def bind_gauges(
    specs: Iterable[Tuple[str, str, Callable[[], float]]],
    registry: Optional[MetricsRegistry] = None,
) -> GaugeBinding:
    """Register ``(name, help, fn)`` callback gauges; release() on stop."""
    return GaugeBinding(specs, registry)


# -- scrape-side helpers ------------------------------------------------------

_LE_RE = re.compile(r'le="([^"]+)"')


def quantile_from_grid(grid: Dict[float, float], q: float) -> Optional[float]:
    """Estimate quantile ``q`` from one cumulative ``{le: count}`` grid,
    interpolating linearly inside the winning bucket — the classic
    Prometheus ``histogram_quantile`` estimator. Returns None on an
    empty grid or zero observations; the open ``+Inf`` bucket reports
    its lower bound (the largest finite edge)."""
    if not grid:
        return None
    edges = sorted(grid)
    total = grid[edges[-1]]
    if total <= 0:
        return None
    target = q * total
    prev_edge, prev_cum = 0.0, 0.0
    for edge in edges:
        cum = grid[edge]
        if cum >= target:
            if edge == float("inf"):
                return prev_edge  # open bucket: report its lower bound
            if cum == prev_cum:
                return edge
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_edge + frac * (edge - prev_edge)
        prev_edge, prev_cum = edge, cum
    return edges[-1]


def bucket_grid(
    series: Dict[str, float], label_substr: str = ""
) -> Dict[float, float]:
    """Collapse a scraped ``{name}_bucket`` label map onto one cumulative
    ``{le: count}`` grid, summing every label set that contains
    ``label_substr`` (same filter convention as the chaos invariants)."""
    grid: Dict[float, float] = {}
    for labels, value in series.items():
        m = _LE_RE.search(labels)
        if not m or label_substr not in labels:
            continue
        le = float("inf") if m.group(1) == "+Inf" else float(m.group(1))
        grid[le] = grid.get(le, 0.0) + value
    return grid


def histogram_quantile(
    metrics: Dict[str, Dict[str, float]], name: str, q: float
) -> Optional[float]:
    """Estimate quantile ``q`` of histogram ``name`` from a scraped
    metrics dict (``obs.http.fetch_metrics`` shape), aggregating every
    label set onto one cumulative grid. Shared by the ``edl-top``
    hb_p50/hb_p95 columns and the monitor plane's staleness rules — one
    tested implementation instead of per-tool copies."""
    buckets = metrics.get(name + "_bucket")
    if not buckets:
        return None
    return quantile_from_grid(bucket_grid(buckets), q)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    """Get-or-create a counter in the process-default registry."""
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    """Get-or-create a gauge in the process-default registry."""
    return _default.gauge(name, help)


def histogram(
    name: str, help: str = "", buckets: Sequence[float] = DURATION_BUCKETS
) -> Histogram:
    """Get-or-create a histogram in the process-default registry."""
    return _default.histogram(name, help, buckets)
