"""edl-trace: cross-process critical-path extraction for one run.

The span tracer exports one Chrome trace per process; with propagation
armed (``EDL_TRACE_DIR`` set), spans carry Dapper-style linkage and
job-level operations (restage, drain, store failover, ckpt save/
restore) share deterministic trace ids. This tool merges a run
directory's exports, stitches the cross-process parent/child graph, and
prints each operation's **critical path**: ordered segments with
per-segment durations and the process that owned each one — the answer
to "which hop spent the restage's 3.2 seconds".

Usage::

    python -m edl_tpu_torch.tools.edl_trace RUN_DIR                 # every operation
    python -m edl_tpu_torch.tools.edl_trace RUN_DIR --op restage    # one op family
    python -m edl_tpu_torch.tools.edl_trace RUN_DIR --op restage --goodput
    python -m edl_tpu_torch.tools.edl_trace RUN_DIR --list          # one line per trace
    python -m edl_tpu_torch.tools.edl_trace RUN_DIR --json          # machine-readable

``RUN_DIR`` is scanned two levels deep for ``*.trace.json`` (and, with
``--goodput``, ``*.flight.jsonl``), so pointing it at a chaos scenario
workdir or an ``EDL_TRACE_DIR`` just works. ``--goodput`` cross-checks
each restage path against the goodput ledger: the covered seconds
should match the job lane's non-train attribution over the same window
— the acceptance check the ``critical_path_traced`` chaos invariant
automates.

The port's copy of ``tools/edl_trace.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from edl_tpu_torch.obs import tracepath


def _flight_events(run_dir: str) -> list:
    import glob

    from edl_tpu_torch.obs import events as obs_events

    dirs = set()
    for depth in ("", "*", os.path.join("*", "*")):
        for p in glob.glob(os.path.join(run_dir, depth, "*.flight.jsonl")):
            dirs.add(os.path.dirname(p))
    events: list = []
    for d in sorted(dirs):
        events.extend(obs_events.read_segments(d))
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_trace",
        description="stitch cross-process traces and print per-operation "
        "critical paths",
    )
    parser.add_argument(
        "run_dir", help="run/trace directory (scanned 2 levels deep)"
    )
    parser.add_argument(
        "--op", default=None,
        help="only operations of this name (restage, drain, "
        "store_failover, ...)",
    )
    parser.add_argument(
        "--list", action="store_true", help="one summary line per trace"
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    parser.add_argument(
        "--goodput", action="store_true",
        help="cross-check each op against the goodput ledger's flight "
        "records in the same directory",
    )
    parser.add_argument(
        "--all", action="store_true",
        help="include incomplete operations (default: completed only "
        "when any completed one exists)",
    )
    args = parser.parse_args(argv)

    spans = tracepath.load_run(args.run_dir)
    if not spans:
        print(
            "no linked spans under %s (run with EDL_TRACE_DIR set; "
            "propagation arms automatically)" % args.run_dir,
            file=sys.stderr,
        )
        return 2
    ops = tracepath.extract_ops(spans, op=args.op)
    if not ops:
        print(
            "no %soperation traces found (%d linked spans)"
            % (("%r " % args.op) if args.op else "", len(spans)),
            file=sys.stderr,
        )
        return 2
    if not args.all:
        done = [o for o in ops if o.complete]
        ops = done or ops

    flight = _flight_events(args.run_dir) if args.goodput else []

    if args.json:
        docs = []
        for ot in ops:
            doc = tracepath.to_json(ot)
            if flight:
                doc["goodput"] = tracepath.goodput_compare(ot, flight)
            docs.append(doc)
        print(json.dumps({"run_dir": args.run_dir, "ops": docs}))
        return 0

    if args.list:
        for ot in ops:
            path = tracepath.critical_path(ot)
            print(
                "%-16s %s  %s  %7.3fs  %d seg  %d proc  %s"
                % (
                    ot.op or "(unnamed)",
                    ot.trace_id,
                    time.strftime("%H:%M:%S", time.localtime(ot.t0)),
                    ot.t1 - ot.t0,
                    sum(1 for p in path if p.segment is not None),
                    len(ot.processes),
                    "complete" if ot.complete else "incomplete",
                )
            )
        return 0

    for i, ot in enumerate(ops):
        if i:
            print()
        print(tracepath.render_op(ot))
        if flight:
            cmp = tracepath.goodput_compare(ot, flight)
            if cmp is not None:
                print(
                    "  goodput cross-check: path %.3fs vs restage lane "
                    "%.3fs over the %.3fs pre-first-step window "
                    "(delta %+.3fs)"
                    % (
                        cmp["path_s"], cmp["lane_s"], cmp["window_s"],
                        cmp["delta_s"],
                    )
                )
    return 0


if __name__ == "__main__":
    sys.exit(main())
