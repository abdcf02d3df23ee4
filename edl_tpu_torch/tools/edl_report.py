"""edl-report: list, trend, diff and GATE archived runs.

The run archive (``edl_tpu_torch/obs/archive.py``) turns every chaos
scenario, bench, and harness job into a bundle under ``runs/`` plus one
crash-safe line in ``runs/index.jsonl``; this CLI is the read side —
the tool that makes "did PR N make restage slower?" a one-command,
machine-checkable question::

    python -m edl_tpu_torch.tools.edl_report --list
    python -m edl_tpu_torch.tools.edl_report --show chaos-worker-kill-s0-0
    python -m edl_tpu_torch.tools.edl_report --trend restage_s
    python -m edl_tpu_torch.tools.edl_report --diff \\
        chaos-worker-kill-s0-0 chaos-worker-kill-s0-1
    python -m edl_tpu_torch.tools.edl_report --check --json     # exit 1 on regression
    python -m edl_tpu_torch.tools.edl_report --import-legacy bench_results/

``--diff`` joins the two bundles' goodput-attribution tables and their
``tracepath`` restage critical paths, so a regression is *attributed*
to a named goodput lane and trace segment, not just observed.
``--check`` evaluates the declarative regression table
(``edl_tpu_torch/obs/regress.py``) for the newest run of every
``(kind, backend, world)`` key against its rolling baseline and exits
nonzero on any ``regressed`` verdict — the port's suite runner
(``python -m edl_tpu_torch.tools.run_suite``) runs it as its closing
gate. ``--import-legacy`` normalizes the checked-in ``bench_results/``
history (and the repo-root ``BENCH_r*.json`` round summaries beside it)
into index rows so trend lines start from real history — BENCH_r04
arrives flagged stale and BENCH_r05's honest 0.0 arrives
excluded-from-baseline. Every row keeps the backend its file names (the
``_cpu`` / ``_tpu`` in a file name, or a round summary's headline
metric), so a TPU row never enters the baseline of a ``cuda`` run.

The port's copy of ``tools/edl_report.py``; a round summary's backend
comes from its headline metric's suffix, where the JAX tool files every
``BENCH_r*.json`` as ``tpu`` (BENCH_r01 measured the CPU).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.obs import archive as run_archive
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import goodput as obs_goodput
from edl_tpu_torch.obs import regress
from edl_tpu_torch.obs import tracepath

_LEGACY_NAME_RE = re.compile(
    r"^(?P<kind>.+?)_(?P<backend>cpu|tpu)_r(?P<round>\d+)(?P<variant>.*)$"
)
_LEGACY_ROUND_RE = re.compile(r"^(?P<kind>.+?)_r(?P<round>\d+)(?P<variant>.*)$")
_BENCH_SUMMARY_RE = re.compile(r"^BENCH_r(?P<round>\d+)\.json$")


_SUMMARY_BACKENDS = {"cpu": "cpu", "tpu": "tpu", "gpu": "cuda"}


def _summary_backend(doc: Dict) -> str:
    """The backend a ``BENCH_r*.json`` round summary names: its headline
    metric's suffix (``..._cpu``, ``..._tpu``, ``..._gpu``, each maybe
    followed by ``_unavailable``); ``tpu`` when it names none, as the
    JAX rounds' summaries were."""
    parts = str(doc.get("metric", "")).split("_")
    if parts[-1:] == ["unavailable"]:
        parts = parts[:-1]
    return _SUMMARY_BACKENDS.get(parts[-1] if parts else "", "tpu")


def _rows(root: str) -> List[Dict]:
    return run_archive.read_index(root)


def _fmt_world(w) -> str:
    return str(int(w)) if isinstance(w, (int, float)) else "-"


def _key_rollups(rollups: Dict) -> str:
    picks = []
    for name in (
        "goodput_ratio", "restage_s", "resize_downtime", "store_puts_per_s",
        "store_put_p99_ms", "peer_restore_s", "mfu",
    ):
        v = rollups.get(name)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            picks.append("%s=%g" % (name, round(float(v), 4)))
    return " ".join(picks[:3])


def cmd_list(rows: List[Dict], as_json: bool) -> int:
    if as_json:
        print(json.dumps({"runs": rows}, default=str))
        return 0
    if not rows:
        print("no archived runs (archive one: EDL_RUN_ARCHIVE=runs "
              "python tools/chaos_run.py --scenario worker-kill)")
        return 0
    print("%-36s %-4s %-6s %-3s %-5s %s" % (
        "bundle/source", "seq", "backend", "wld", "flags", "rollups"))
    for row in rows:
        flags = "".join(
            c for c, on in (
                ("S", row.get("stale")), ("X", row.get("excluded")),
                ("!", row.get("ok") is False), ("L", row.get("legacy")),
            ) if on
        ) or "-"
        print("%-36s %-4s %-6s %-3s %-5s %s" % (
            (row.get("bundle") or row.get("source") or "?")[:36],
            row.get("seq", "?"),
            row.get("backend", "?"),
            _fmt_world(row.get("world")),
            flags,
            _key_rollups(row.get("rollups") or {}),
        ))
    print("(%d runs; flags: S=stale X=excluded !=invariants-failed "
          "L=legacy-import)" % len(rows))
    return 0


def cmd_show(root: str, name: str, as_json: bool) -> int:
    bundle = run_archive.find_bundle(root, name)
    doc = run_archive.load_manifest(bundle) if bundle else None
    if doc is None:
        # a legacy index row has no bundle directory — show the row
        doc = next(
            (r for r in _rows(root)
             if r.get("bundle") == name or r.get("source") == name),
            None,
        )
    if doc is None:
        print("no bundle or index row named %r under %s" % (name, root),
              file=sys.stderr)
        return 2
    if as_json:
        print(json.dumps(doc, default=str))
        return 0
    print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    return 0


def _trend_rows(
    rows: List[Dict], metric: str, kind: Optional[str],
    backend: Optional[str], world: Optional[int],
) -> Dict[Tuple, List[Dict]]:
    by_key: Dict[Tuple, List[Dict]] = {}
    for row in rows:
        v = (row.get("rollups") or {}).get(metric)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        key = regress.run_key(row)
        if kind and key[0] != kind:
            continue
        if backend and key[1] != backend:
            continue
        if world is not None and key[2] != world:
            continue
        by_key.setdefault(key, []).append(row)
    return by_key


def cmd_trend(
    rows: List[Dict], metric: str, kind: Optional[str],
    backend: Optional[str], world: Optional[int], as_json: bool,
) -> int:
    by_key = _trend_rows(rows, metric, kind, backend, world)
    if as_json:
        print(json.dumps({
            "metric": metric,
            "series": [
                {
                    "key": list(key),
                    "points": [
                        {
                            "bundle": r.get("bundle") or r.get("source"),
                            "seq": r.get("seq"),
                            "ts": r.get("ts"),
                            "value": (r.get("rollups") or {}).get(metric),
                            "stale": bool(r.get("stale")),
                            "excluded": bool(r.get("excluded")),
                        }
                        for r in krows
                    ],
                }
                for key, krows in sorted(by_key.items(), key=lambda kv: repr(kv[0]))
            ],
        }, default=str))
        return 0
    if not by_key:
        print("no indexed run carries rollup %r" % metric, file=sys.stderr)
        return 2
    print("trend %s" % metric)
    for key, krows in sorted(by_key.items(), key=lambda kv: repr(kv[0])):
        print("  (%s, %s, world=%s)" % (key[0], key[1], _fmt_world(key[2])))
        peak = max(
            abs(float((r.get("rollups") or {}).get(metric, 0.0)))
            for r in krows
        ) or 1.0
        for r in krows:
            v = float((r.get("rollups") or {}).get(metric, 0.0))
            bar = "#" * max(1, int(round(abs(v) / peak * 32))) if v else ""
            flags = "".join(
                f for f, on in (
                    (" [stale]", r.get("stale")),
                    (" [excluded]", r.get("excluded")),
                    (" [RED]", r.get("ok") is False),
                ) if on
            )
            print("    %-34s %12g  %s%s" % (
                (r.get("bundle") or r.get("source") or "?")[:34], v, bar, flags,
            ))
    return 0


# -- diff ---------------------------------------------------------------------


def _bundle_lanes(bundle: str) -> Dict[str, float]:
    """Job-level goodput state seconds of one bundle's flight segments."""
    flight = os.path.join(bundle, "flight")
    events = obs_events.read_segments(flight) if os.path.isdir(flight) else []
    if not events:
        return {}
    att = obs_goodput.attribute(events)
    return {s: round(v, 3) for s, v in att["states"].items()}


def _bundle_segments(bundle: str) -> Dict[str, float]:
    """Per-segment covered seconds of the last substantive restage
    critical path in one bundle's trace exports (same op selection as
    the archive-time ``traced_restage_s`` rollup)."""
    tdir = os.path.join(bundle, "traces")
    if not os.path.isdir(tdir):
        return {}
    spans = tracepath.load_spans(
        sorted(glob.glob(os.path.join(tdir, "*.trace.json")))
    )
    ot, _count = run_archive.last_restage_op(spans)
    if ot is None:
        return {}
    out: Dict[str, float] = {}
    for step in tracepath.critical_path(ot):
        name = step.segment.name if step.segment is not None else "(untraced)"
        out[name] = round(out.get(name, 0.0) + (step.t1 - step.t0), 3)
    return out


def _max_delta(a: Dict[str, float], b: Dict[str, float]) -> Optional[Tuple[str, float]]:
    """Name where B's extra seconds WENT: the largest positive delta
    (a regression's cost lands somewhere); when nothing grew, the
    largest shrink (B improved — attribute the win)."""
    deltas = {
        k: round(b.get(k, 0.0) - a.get(k, 0.0), 3)
        for k in set(a) | set(b)
    }
    if not deltas:
        return None
    grew = {k: v for k, v in deltas.items() if v > 0}
    pool = grew or deltas
    name = max(pool, key=lambda k: abs(pool[k]))
    return name, deltas[name]


def cmd_diff(root: str, name_a: str, name_b: str, as_json: bool) -> int:
    pair = []
    for name in (name_a, name_b):
        bundle = run_archive.find_bundle(root, name)
        manifest = run_archive.load_manifest(bundle) if bundle else None
        if bundle is None or manifest is None:
            print("no bundle named %r under %s" % (name, root), file=sys.stderr)
            return 2
        pair.append((bundle, manifest))
    (bundle_a, man_a), (bundle_b, man_b) = pair
    roll_a = man_a.get("rollups") or {}
    roll_b = man_b.get("rollups") or {}
    rollup_delta = {
        k: {
            "a": roll_a.get(k),
            "b": roll_b.get(k),
            "delta": (
                round(float(roll_b[k]) - float(roll_a[k]), 4)
                if isinstance(roll_a.get(k), (int, float))
                and isinstance(roll_b.get(k), (int, float))
                else None
            ),
        }
        for k in sorted(set(roll_a) | set(roll_b))
    }
    lanes_a, lanes_b = _bundle_lanes(bundle_a), _bundle_lanes(bundle_b)
    segs_a, segs_b = _bundle_segments(bundle_a), _bundle_segments(bundle_b)
    lane_pick = _max_delta(lanes_a, lanes_b)
    seg_pick = _max_delta(segs_a, segs_b)
    attribution = {}
    if lane_pick:
        attribution["lane"] = lane_pick[0]
        attribution["lane_delta_s"] = lane_pick[1]
    if seg_pick:
        attribution["segment"] = seg_pick[0]
        attribution["segment_delta_s"] = seg_pick[1]
    if as_json:
        print(json.dumps({
            "a": man_a.get("bundle"), "b": man_b.get("bundle"),
            "rollups": rollup_delta,
            "lanes": {"a": lanes_a, "b": lanes_b},
            "segments": {"a": segs_a, "b": segs_b},
            "attribution": attribution,
        }, default=str))
        return 0
    print("diff %s -> %s" % (man_a.get("bundle"), man_b.get("bundle")))
    print()
    print("ROLLUPS %34s %12s %12s" % ("A", "B", "delta"))
    for k, d in rollup_delta.items():
        print("  %-32s %12s %12s %12s" % (
            k,
            "%g" % d["a"] if isinstance(d["a"], (int, float)) else "-",
            "%g" % d["b"] if isinstance(d["b"], (int, float)) else "-",
            "%+g" % d["delta"] if d["delta"] is not None else "",
        ))
    if lanes_a or lanes_b:
        print()
        print("GOODPUT LANES (job-level state seconds)")
        for k in sorted(set(lanes_a) | set(lanes_b)):
            print("  %-32s %12g %12g %+12g" % (
                k, lanes_a.get(k, 0.0), lanes_b.get(k, 0.0),
                lanes_b.get(k, 0.0) - lanes_a.get(k, 0.0),
            ))
    if segs_a or segs_b:
        print()
        print("RESTAGE CRITICAL-PATH SEGMENTS (covered seconds)")
        for k in sorted(set(segs_a) | set(segs_b)):
            print("  %-32s %12g %12g %+12g" % (
                k, segs_a.get(k, 0.0), segs_b.get(k, 0.0),
                segs_b.get(k, 0.0) - segs_a.get(k, 0.0),
            ))
    if attribution:
        print()
        bits = []
        if "lane" in attribution:
            bits.append("goodput lane '%s' (%+gs)" % (
                attribution["lane"], attribution["lane_delta_s"]))
        if "segment" in attribution:
            bits.append("trace segment '%s' (%+gs)" % (
                attribution["segment"], attribution["segment_delta_s"]))
        print("attribution: " + "; ".join(bits))
    return 0


# -- check --------------------------------------------------------------------


def cmd_check(rows: List[Dict], as_json: bool, k: Optional[int]) -> int:
    entries, ok = regress.evaluate_latest(rows, k=k)
    regressed = sum(
        1 for e in entries for v in e["verdicts"]
        if v["verdict"] == regress.VERDICT_REGRESSED
    )
    if as_json:
        print(json.dumps({
            "metric": "edl_report_check",
            "value": regressed,
            "unit": "regressions",
            "ok": ok,
            "baseline_k": k if k is not None else regress.baseline_k(),
            "runs": entries,
        }, default=str))
    else:
        if not entries:
            print("nothing to check: no indexed runs carry table metrics")
        for entry in entries:
            kind, backend, world = entry["key"]
            print("%s (%s, %s, world=%s)" % (
                entry["bundle"], kind, backend, _fmt_world(world)))
            for v in entry["verdicts"]:
                line = "  %-28s %-22s value=%g" % (
                    v["metric"], v["verdict"].upper(), v["value"])
                if "baseline" in v:
                    line += "  baseline=%g (n=%d)  delta=%+g%% (tol %g%%)" % (
                        v["baseline"], v["n_baseline"], v["delta_pct"],
                        v["tolerance_pct"])
                print(line)
        print("-> %s (%d regression%s)" % (
            "OK" if ok else "REGRESSED", regressed,
            "" if regressed == 1 else "s"))
    return 0 if ok else 1


# -- legacy import ------------------------------------------------------------


def _parse_legacy_file(path: str) -> Optional[Dict]:
    """One checked-in result file -> one index row (or None to skip)."""
    name = os.path.basename(path)
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    doc = None
    try:
        doc = json.loads(text)
    except ValueError:
        # jsonl (sweep files): the last parseable dict line stands in
        for line in reversed(text.splitlines()):
            try:
                cand = json.loads(line)
            except ValueError:
                continue
            if isinstance(cand, dict):
                doc = cand
                break
    if not isinstance(doc, dict):
        return None

    stale = False
    excluded = False
    m = _BENCH_SUMMARY_RE.match(name)
    if m:
        # repo-root BENCH_rNN.json round summaries: {"n", "parsed", ...}
        parsed = doc.get("parsed")
        if not isinstance(parsed, dict):
            return None
        doc = parsed
        kind, backend, rnd = "bench", _summary_backend(doc), int(
            m.group("round"))
    else:
        stem = name.rsplit(".", 1)[0]
        m = _LEGACY_NAME_RE.match(stem)
        if m:
            kind, backend = m.group("kind"), m.group("backend")
            rnd = int(m.group("round"))
        else:
            m = _LEGACY_ROUND_RE.match(stem)
            if m is None:
                return None
            kind, rnd = m.group("kind"), int(m.group("round"))
            backend = "tpu" if "tpu" in stem else "cpu"
        # variant suffixes (_control, _prewarm, _aot, ...) stay in the
        # kind: a control lane must trend against OTHER control runs,
        # never share a baseline with its treatment sibling
        variant = m.group("variant").strip("_")
        if variant:
            kind = "%s_%s" % (kind, variant)
    stale = bool(doc.get("stale"))
    metric = doc.get("metric")
    if isinstance(metric, str) and metric.endswith("_unavailable"):
        # the honest 0.0 (BENCH_r05): kept in the trend, never a baseline
        excluded = True
    rollups = run_archive.rollups_from_bench(doc)
    if not rollups:
        return None
    return {
        "legacy": True,
        "source": name,
        "kind": kind,
        "job_id": backend,
        "backend": backend,
        "world": None,
        "seed": None,
        "seq": rnd,
        "git_sha": doc.get("measured_sha"),
        "ok": None,
        "stale": stale,
        "excluded": excluded,
        "rollups": rollups,
    }


def cmd_import_legacy(root: str, src: str, as_json: bool) -> int:
    if not os.path.isdir(src):
        print("--import-legacy: %s is not a directory" % src, file=sys.stderr)
        return 2
    files = sorted(glob.glob(os.path.join(src, "*.json")))
    files += sorted(glob.glob(os.path.join(src, "*.jsonl")))
    # the repo-root round summaries live NEXT TO bench_results/
    files += sorted(
        glob.glob(os.path.join(os.path.dirname(os.path.abspath(src)),
                               "BENCH_r*.json"))
    )
    os.makedirs(root, exist_ok=True)
    arch = run_archive.RunArchive(root)
    seen = {
        r.get("source") for r in arch.read_index() if r.get("legacy")
    }
    parsed: List[Dict] = []
    skipped: List[str] = []
    for path in files:
        row = _parse_legacy_file(path)
        if row is None:
            skipped.append(os.path.basename(path))
            continue
        if row["source"] in seen:
            continue
        parsed.append(row)
    # chronological per key so rolling baselines read oldest -> newest
    parsed.sort(key=lambda r: (r["kind"], r["backend"], r["seq"], r["source"]))
    for row in parsed:
        arch.append_row(row)
    summary = {
        "metric": "edl_report_import",
        "value": len(parsed),
        "unit": "rows",
        "skipped": len(skipped),
        "stale": sum(1 for r in parsed if r["stale"]),
        "excluded": sum(1 for r in parsed if r["excluded"]),
    }
    if as_json:
        print(json.dumps(summary))
    else:
        print("imported %d legacy rows into %s (%d unparseable/indexless "
              "files skipped, %d flagged stale, %d excluded-from-baseline)"
              % (len(parsed), os.path.join(root, run_archive.INDEX_NAME),
                 len(skipped), summary["stale"], summary["excluded"]))
        for row in parsed:
            flags = ("%s%s" % (
                " [stale]" if row["stale"] else "",
                " [excluded]" if row["excluded"] else "")) or ""
            print("  %-44s -> (%s, %s) r%d%s" % (
                row["source"], row["kind"], row["backend"], row["seq"], flags))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_report",
        description="list, trend, diff and gate archived runs "
        "(edl_tpu_torch/obs/archive.py bundles + regress.py sentinel)",
    )
    parser.add_argument(
        "--runs", default=None,
        help="archive root (default: $EDL_RUN_ARCHIVE, else ./runs)",
    )
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--show", metavar="BUNDLE")
    parser.add_argument("--trend", metavar="METRIC")
    parser.add_argument("--diff", nargs=2, metavar=("A", "B"))
    parser.add_argument(
        "--check", action="store_true",
        help="evaluate the regression table; exit 1 on any regression",
    )
    parser.add_argument("--import-legacy", metavar="DIR", dest="import_legacy")
    parser.add_argument("--kind", default=None, help="trend filter")
    parser.add_argument("--backend", default=None, help="trend filter")
    parser.add_argument("--world", type=int, default=None, help="trend filter")
    parser.add_argument(
        "--baseline-k", type=int, default=None,
        help="rolling-baseline window (default $EDL_REPORT_BASELINE_K or 5)",
    )
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)

    # a READ tool: EDL_RUN_ARCHIVE=0 disables *producers*, but listing
    # what exists must still work — fall back to ./runs, never None
    root = (
        args.runs
        or run_archive.archive_root(default=os.path.join(os.getcwd(), "runs"))
        or os.path.join(os.getcwd(), "runs")
    )
    if args.import_legacy:
        return cmd_import_legacy(root, args.import_legacy, args.json)
    if args.show:
        return cmd_show(root, args.show, args.json)
    if args.diff:
        return cmd_diff(root, args.diff[0], args.diff[1], args.json)
    rows = _rows(root)
    if args.trend:
        return cmd_trend(
            rows, args.trend, args.kind, args.backend, args.world, args.json
        )
    if args.check:
        return cmd_check(rows, args.json, args.baseline_k)
    # default: --list
    return cmd_list(rows, args.json)


if __name__ == "__main__":
    sys.exit(main())
