"""Regression sentinel: declarative per-metric gates over archived runs.

The run archive (:mod:`edl_tpu_torch.obs.archive`) turns every chaos
scenario, bench, and harness job into an indexed row of scalar rollups;
this module is the judgment half: a declarative per-metric table in the
monitor-:class:`~edl_tpu_torch.obs.monitor.Rule` style — each
:class:`Metric` names a rollup, the direction that counts as better, a
relative tolerance, and the minimum baseline sample count — evaluated
against a **rolling baseline** of the last K archived runs sharing the
same ``(kind, backend, world)`` key. The verdicts are
``regressed`` / ``improved`` / ``ok`` / ``insufficient-baseline``;
``python -m edl_tpu_torch.tools.edl_report --check`` exits nonzero on
any ``regressed``, which is the whole PR gate.

Baseline hygiene: rows flagged ``excluded`` (e.g. BENCH_r05's honest
0.0 — a measurement that refused to invent a number), ``stale`` (a
cached result from an older sha), or with failed invariants
(``ok == False``) never enter a baseline and are never themselves
judged — a red chaos run must not poison the bar for the next green
one.

Env contract:

    EDL_REPORT_BASELINE_K   rolling-baseline window (default 5 runs)
    EDL_REPORT_TOLERANCES   per-metric tolerance overrides, e.g.
                            ``restage_s=0.5,mfu=0.02`` (relative
                            fractions, same unit as ``Metric.tolerance``)

The port's copy of ``edl_tpu/obs/regress.py``. Its table gates the
port's headline, ``resnet50_vd_train_throughput_gpu``, and keeps only the
floors that are bars (the north star's 5 % per-chip loss, the numerics
probe's 2 % overhead, the 0.3-point convergence gap, the nominal lane's
5 % shed, the autoscale drill's 65 % goodput loss); no floor is a number
a rig measured.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.utils.log import get_logger

logger = get_logger("obs.regress")

_DIRECTIONS = ("lower", "higher")

VERDICT_REGRESSED = "regressed"
VERDICT_IMPROVED = "improved"
VERDICT_OK = "ok"
VERDICT_INSUFFICIENT = "insufficient-baseline"


@dataclasses.dataclass
class Metric:
    """One row of the regression table (the monitor-Rule idiom).

    ``floor`` is an absolute no-page band for metrics whose SLO is a
    bar, not a ratio: a lower-is-better value at or below ``floor``
    (at or above, for higher-is-better) is unconditionally within SLO
    and never judged relatively — ``per_chip_loss_pct`` hovers around
    zero, where relative deltas explode, but the north-star contract is
    simply "<= 5"."""

    name: str                 # rollup key in the index rows
    direction: str = "lower"  # which way is BETTER: "lower" | "higher"
    tolerance: float = 0.25   # relative slack vs the baseline median
    min_samples: int = 1      # baseline rows required before judging
    floor: Optional[float] = None  # absolute always-ok band (SLO bar)
    severity: str = "warning"

    def __post_init__(self) -> None:
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                "metric %r: unknown direction %r (have: %s)"
                % (self.name, self.direction, ", ".join(_DIRECTIONS))
            )
        if self.tolerance < 0:
            raise ValueError(
                "metric %r: negative tolerance %r" % (self.name, self.tolerance)
            )

    def within_floor(self, value: float) -> bool:
        if self.floor is None:
            return False
        return (
            value <= self.floor
            if self.direction == "lower"
            else value >= self.floor
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


def builtin_metrics() -> List[Metric]:
    """The built-in regression table. Tolerances are sized for shared
    CPU rigs (single-core serialization noise is real); tighten per
    deployment via ``EDL_REPORT_TOLERANCES`` or a custom table. Every
    name matches a rollup the archive derives (archive.py) or a bench
    headline."""
    return [
        # goodput ledger (chaos scenarios, archived harness jobs)
        Metric("goodput_ratio", "higher", 0.15, severity="critical"),
        Metric("restage_s", "lower", 0.40),
        Metric("down_s", "lower", 0.60),
        Metric("traced_restage_s", "lower", 0.40),
        # resize bench
        Metric("resize_downtime", "lower", 0.40, severity="critical"),
        Metric("restage_compile_s", "lower", 0.60),
        Metric("restage_restore_s", "lower", 0.50),
        # the BASELINE north star is an absolute bar (<= 5%), and the
        # value hovers around zero where relative deltas are meaningless
        Metric("per_chip_loss_pct", "lower", 0.50, floor=5.0),
        # store bench
        Metric("store_puts_per_s", "higher", 0.25, severity="critical"),
        Metric("store_put_p99_ms", "lower", 0.50),
        # store bench --reads (standby read-serving lane): wider than the
        # put lane — read throughput on a 1-CPU rig swings with scheduler
        # interleaving of the reader threads (observed ~26% run-to-run)
        Metric("store_reads_per_s", "higher", 0.35, severity="critical"),
        Metric("store_read_p99_ms", "lower", 0.50),
        # checkpoint bench
        Metric("peer_restore_s", "lower", 0.40),
        Metric("durable_restore_s_raw", "lower", 0.40),
        Metric("push_s", "lower", 0.40),
        Metric("save_s", "lower", 0.40),
        # on-chip headline (the port's tools/bench.py; lm benches)
        Metric("resnet50_vd_train_throughput_gpu", "higher", 0.05,
               severity="critical"),
        Metric("mfu", "higher", 0.05),
        # convergence-vs-churn: extra loss a churned run carries over the
        # calm control at the same step budget. Hovers near zero on the
        # quadratic trainee, so the absolute bar does the real gating.
        Metric("convergence_churn_gap", "lower", 0.50, floor=0.3),
        # numerics probe A/B lane (bench.py --numerics-overhead): the
        # fused bundle must stay within the paper bar. Near-zero values
        # make relative deltas meaningless — the 2% floor is the gate.
        Metric("numerics_probe_overhead_pct", "lower", 0.50, floor=2.0),
        # scale plane (autoscale-churn drill): scheduler quality vs the
        # offline oracle replaying the same trace. The floor is the
        # drill's own bar (chaos/scenario.AUTOSCALE_LOSS_BOUND_PCT, 65%);
        # the JAX table's 35 was the band its CPU rigs landed in, a
        # measurement, not a bar.
        Metric("autoscale_goodput_loss_pct", "lower", 0.50, floor=65.0,
               severity="critical"),
        # decision fsync -> reconciled restage publish, worst pair of
        # the run (restage cost dominates; relative gating suffices)
        Metric("decision_to_restage_s", "lower", 0.60),
        # serving resilience plane (serve_slo / serve-slo-churn): goodput
        # (in-SLO answers/s) from the nominal lane, the answered-request
        # tail, and the refused fraction. Shed hovers at zero in the
        # nominal lane, so the absolute 5% floor does the gating there.
        Metric("serve_qps", "higher", 0.25, severity="critical"),
        Metric("serve_p99_ms", "lower", 0.60),
        Metric("serve_shed_pct", "lower", 0.50, floor=5.0),
        # memory plane (hbm-oom drill): runtime high-water mark, and how
        # much of it the first step's measured plan predicted. Peak
        # creeping UP is the regression (a new resident buffer nobody
        # budgeted); a collapse of plan accuracy means plans stopped
        # tracking reality. No floor: the JAX table's 20 was the band its
        # CPU rig's toy trainee landed in, a measurement, not a bar.
        Metric("hbm_peak_gb", "lower", 0.40),
        Metric("hbm_plan_accuracy_pct", "higher", 0.50),
    ]


def baseline_k() -> int:
    try:
        return max(1, int(os.environ.get("EDL_REPORT_BASELINE_K", "5")))
    except ValueError:
        return 5


def tolerance_overrides(text: Optional[str] = None) -> Dict[str, float]:
    """Parse ``metric=frac,metric=frac``; unparseable entries are
    dropped with a warning, never fatal."""
    raw = (
        text if text is not None
        else os.environ.get("EDL_REPORT_TOLERANCES", "")
    ).strip()
    out: Dict[str, float] = {}
    if not raw:
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, val = part.partition("=")
        try:
            out[name.strip()] = float(val)
        except ValueError:
            logger.warning("ignoring malformed tolerance override %r", part)
    return out


def metrics_table(
    overrides: Optional[Dict[str, float]] = None,
    base: Optional[List[Metric]] = None,
) -> List[Metric]:
    metrics = list(base) if base is not None else builtin_metrics()
    overrides = (
        overrides if overrides is not None else tolerance_overrides()
    )
    for m in metrics:
        if m.name in overrides:
            m.tolerance = overrides[m.name]
    return metrics


# -- evaluation ---------------------------------------------------------------


def run_key(row: Dict) -> Tuple[str, str, Optional[int]]:
    """The comparability key: runs are only measured against runs of
    the same kind on the same backend at the same world size."""
    world = row.get("world")
    return (
        str(row.get("kind", "")),
        str(row.get("backend", "")),
        int(world) if isinstance(world, (int, float)) else None,
    )


def usable_baseline(row: Dict) -> bool:
    return (
        not row.get("excluded")
        and not row.get("stale")
        and row.get("ok") is not False
    )


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2.0


def evaluate_run(
    row: Dict,
    prior_rows: List[Dict],
    metrics: Optional[List[Metric]] = None,
    k: Optional[int] = None,
) -> List[Dict]:
    """Judge ONE run against the rolling baseline of its same-key
    predecessors; returns one verdict dict per table metric present in
    the run's rollups."""
    metrics = metrics if metrics is not None else metrics_table()
    k = k if k is not None else baseline_k()
    key = run_key(row)
    base_rows = [
        r for r in prior_rows if run_key(r) == key and usable_baseline(r)
    ][-k:]
    rollups = row.get("rollups") or {}
    verdicts: List[Dict] = []
    for m in metrics:
        value = rollups.get(m.name)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        samples = [
            float((r.get("rollups") or {}).get(m.name))
            for r in base_rows
            if isinstance((r.get("rollups") or {}).get(m.name), (int, float))
            and not isinstance((r.get("rollups") or {}).get(m.name), bool)
        ]
        doc = {
            "metric": m.name,
            "value": float(value),
            "n_baseline": len(samples),
            "direction": m.direction,
            "tolerance_pct": round(m.tolerance * 100, 2),
            "severity": m.severity,
        }
        if m.within_floor(float(value)):
            doc["verdict"] = VERDICT_OK
            doc["floor"] = m.floor
            verdicts.append(doc)
            continue
        if len(samples) < m.min_samples:
            doc["verdict"] = VERDICT_INSUFFICIENT
            verdicts.append(doc)
            continue
        base = _median(samples)
        delta = (float(value) - base) / max(abs(base), 1e-9)
        worse = delta if m.direction == "lower" else -delta
        if worse > m.tolerance:
            verdict = VERDICT_REGRESSED
        elif worse < -m.tolerance:
            verdict = VERDICT_IMPROVED
        else:
            verdict = VERDICT_OK
        doc.update(
            verdict=verdict,
            baseline=round(base, 6),
            delta_pct=round(delta * 100, 2),
        )
        verdicts.append(doc)
    return verdicts


def evaluate_latest(
    rows: List[Dict],
    metrics: Optional[List[Metric]] = None,
    k: Optional[int] = None,
) -> Tuple[List[Dict], bool]:
    """For every ``(kind, backend, world)`` key, judge the NEWEST
    usable run against the rolling baseline of its predecessors.
    Returns ``([{key, bundle, verdicts}, ...], ok)`` — ``ok`` is False
    iff any verdict regressed (``insufficient-baseline`` never gates:
    a first run has nothing to regress against)."""
    metrics = metrics if metrics is not None else metrics_table()
    k = k if k is not None else baseline_k()
    by_key: Dict[Tuple, List[Dict]] = {}
    for row in rows:
        by_key.setdefault(run_key(row), []).append(row)
    out: List[Dict] = []
    for key, krows in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
        # judge the newest usable LIVE run; legacy-import rows are
        # history, never the run under judgment (an --import-legacy run
        # AFTER today's archive must not demote today's run to baseline)
        judged = next(
            (r for r in reversed(krows)
             if usable_baseline(r) and not r.get("legacy")),
            None,
        ) or next((r for r in reversed(krows) if usable_baseline(r)), None)
        if judged is None:
            continue
        judged_at = krows.index(judged)
        # baseline = everything before the judged run, plus legacy rows
        # wherever they landed in the index (chronologically they ARE
        # prior history even when appended after a live run) — legacy
        # first, so the rolling [-k:] window keeps the NEWEST live runs
        prior = [
            r for r in krows if r is not judged and r.get("legacy")
        ] + [
            r for i, r in enumerate(krows)
            if r is not judged and not r.get("legacy") and i < judged_at
        ]
        verdicts = evaluate_run(judged, prior, metrics, k)
        if not verdicts:
            continue
        out.append(
            {
                "key": list(key),
                "bundle": judged.get("bundle") or judged.get("source"),
                "verdicts": verdicts,
            }
        )
    ok = not any(
        v["verdict"] == VERDICT_REGRESSED
        for entry in out
        for v in entry["verdicts"]
    )
    return out, ok
