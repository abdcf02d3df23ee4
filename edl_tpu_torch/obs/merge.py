"""Merge per-process Chrome traces into ONE job timeline.

Every instrumented process exports ``{component}-{pid}.trace.json`` into
``EDL_TRACE_DIR`` (see :mod:`edl_tpu_torch.obs.trace`). This tool splices them:
span timestamps are already unix-epoch-anchored, so alignment is a
common-origin rebase (earliest event across all files becomes t=0 —
Perfetto renders relative microseconds far more readably than 52-bit
epoch values), and pid collisions across hosts are resolved by remapping
each file to its own pid namespace while keeping the component name as
the process label.

Usage::

    python -m edl_tpu_torch.obs.merge --dir /tmp/traces -o job.trace.json
    python -m edl_tpu_torch.obs.merge a.trace.json b.trace.json -o job.trace.json

The output loads in ``chrome://tracing`` / https://ui.perfetto.dev.

The port's copy of ``edl_tpu/obs/merge.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, Iterable, List, Optional

from edl_tpu_torch.utils.log import get_logger

logger = get_logger("obs.merge")


def _load(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return list(doc.get("traceEvents", []))
    if isinstance(doc, list):  # bare event-array form is also legal
        return doc
    raise ValueError("%s is not a Chrome trace" % path)


def merge_traces(paths: Iterable[str], rebase: bool = True) -> dict:
    """Merge trace files into one document; returns the merged dict.

    Files that fail to parse are skipped with a warning (a torn export
    from a killed worker must not hide every other process's timeline).
    """
    merged: List[dict] = []
    origin: Optional[float] = None
    per_file: List[tuple] = []
    for idx, path in enumerate(paths):
        try:
            events = _load(path)
        except (OSError, ValueError) as exc:
            logger.warning("skipping %s: %s", path, exc)
            continue
        per_file.append((idx, path, events))
        for ev in events:
            ts = ev.get("ts")
            if isinstance(ts, (int, float)) and ev.get("ph") != "M":
                origin = ts if origin is None else min(origin, ts)
    if not rebase:
        origin = None
    for idx, path, events in per_file:
        # one pid namespace per file: two hosts' pid 4242 must not
        # interleave into one fake process lane
        pid_map: Dict = {}
        label = os.path.basename(path).replace(".trace.json", "")
        for ev in events:
            ev = dict(ev)
            orig_pid = ev.get("pid", 0)
            if orig_pid not in pid_map:
                pid_map[orig_pid] = (idx + 1) * 100000 + (
                    orig_pid % 100000 if isinstance(orig_pid, int) else 0
                )
            ev["pid"] = pid_map[orig_pid]
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                name = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": "%s [%s]" % (name or label, label)}
            elif origin is not None and isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = ev["ts"] - origin
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    doc = {"traceEvents": merged, "displayTimeUnit": "ms"}
    if origin is not None:
        doc["otherData"] = {"epoch_origin_us": origin}
    return doc


def expand_inputs(inputs: List[str], trace_dir: Optional[str]) -> List[str]:
    paths = list(inputs)
    if trace_dir:
        paths.extend(sorted(glob.glob(os.path.join(trace_dir, "*.trace.json"))))
    return paths


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.obs.merge",
        description="merge per-process edl_tpu traces into one Chrome trace",
    )
    parser.add_argument("traces", nargs="*", help="trace files to merge")
    parser.add_argument(
        "--dir", default=os.environ.get("EDL_TRACE_DIR"),
        help="also merge every *.trace.json here (default: $EDL_TRACE_DIR)",
    )
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument(
        "--no-rebase", action="store_true",
        help="keep absolute unix-epoch microsecond timestamps",
    )
    args = parser.parse_args(argv)
    paths = expand_inputs(args.traces, args.dir)
    if not paths:
        print("no trace files found", file=sys.stderr)
        return 2
    doc = merge_traces(paths, rebase=not args.no_rebase)
    n_procs = len({e["pid"] for e in doc["traceEvents"]})
    with open(args.output, "w") as f:
        json.dump(doc, f)
    print(
        "merged %d file(s), %d events, %d process(es) -> %s"
        % (len(paths), len(doc["traceEvents"]), n_procs, args.output),
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
