"""edl-timeline: postmortem reconstruction of one elastic run.

Merges everything a run left on disk — flight-recorder segments
(``EDL_FLIGHT_DIR``), per-process Chrome traces (``EDL_TRACE_DIR``), and
the chaos injection ledger (``EDL_CHAOS_LOG``) — into one causally
ordered timeline: leader election → preemption notice → drain →
emergency checkpoint → restage → publish → resume, each line stamped
with the process that recorded it. Then prints the goodput attribution
table: every second of the run's wall-clock classified into
train/compile/data_wait/ckpt_save/ckpt_restore/restage/drain/stalled/
down — the percentages partition the window, so the table sums to 100%.

Usage::

    python -m edl_tpu_torch.tools.edl_timeline RUN_DIR         # timeline + table
    python -m edl_tpu_torch.tools.edl_timeline RUN_DIR -o run.trace.json
    python -m edl_tpu_torch.tools.edl_timeline RUN_DIR --json  # machine-readable

``RUN_DIR`` is scanned (two levels deep) for ``*.flight.jsonl``,
``*.trace.json`` and ``chaos.log`` — pointing it at a chaos scenario
workdir (``python -m edl_tpu_torch.tools.chaos_run --workdir DIR``)
just works. An archived
run-bundle is first-class too: pass the bundle dir (``runs/<bundle>``),
its ``run.json`` manifest path, or — with ``EDL_RUN_ARCHIVE`` set —
just the bundle name, and the harvested layout is read directly. The
Chrome trace output renders each process's goodput states as colored
slices alongside the spans the obs tracer recorded, loadable in
``chrome://tracing`` / https://ui.perfetto.dev.

The port's copy of ``tools/edl_timeline.py``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional

from edl_tpu_torch.chaos.invariants import read_chaos_log
from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.obs import goodput as obs_goodput
from edl_tpu_torch.obs import merge as obs_merge
from edl_tpu_torch.obs import tracepath

# events worth a line in the human timeline even with --max-events
_CAUSAL = (
    "leader", "preempt_notice", "drain", "killed", "ckpt_emergency",
    "drained", "pod_drained", "publish", "spawn", "ckpt_restore",
    "ckpt_save", "straggler_ejected", "data_drain_requeue", "data_epoch",
    "alert",  # monitor-plane firing/resolved transitions overlay the lanes
    "profile",  # profiler capture windows (start/done) overlay the lanes
    # numerics plane: the instant a run went numerically bad (nonfinite
    # grads, loss z-spike) and the resume-continuity verdicts — the
    # overlay that puts a divergence next to the fault that caused it
    "nonfinite", "loss_spike", "numerics_resume",
    # scale plane: the autoscaler's decision, the leader's reconcile
    # publish and the preempt-release it issued — the overlay that puts
    # a world-size change next to the decision that ordered it
    "scale_decision", "scale_reconcile", "scale_preempt",
    # consistency plane: the history checker's per-run verdict — a red
    # one belongs on the timeline next to the failover that caused it
    "consistency_verdict",
    # serving plane: a client breaker tripping on (and later re-
    # admitting) a teacher — the overlay that puts a routing change
    # next to the teacher death or overload that caused it
    "breaker_open", "breaker_close",
    # memory plane: the OOM instant (with its forensics-bundle path),
    # a published compile-time plan, and a fit-gate refusal — the
    # overlay that puts an exhaustion next to the plan that failed to
    # predict it or the resize the gate should have refused
    "oom", "mem_plan", "mem_unfit",
)


def resolve_run_dir(run_dir: str) -> str:
    """Accept, besides a plain run directory: an archived bundle's
    ``run.json`` manifest path, and a bare bundle NAME resolved under
    the ``EDL_RUN_ARCHIVE`` root — so ``edl-timeline runs/<bundle>``
    (or just ``<bundle>``) works on harvested runs without re-pointing
    env vars at the original scratch dirs. Resolution is
    ``archive.find_bundle``'s, not a local re-implementation."""
    from edl_tpu_torch.obs import archive as run_archive

    bundle = run_archive.find_bundle(
        run_archive.archive_root() or "", run_dir
    )
    return bundle or run_dir


def discover(run_dir: str) -> Dict[str, List[str]]:
    """Find a run's artifacts: an archived bundle (``run.json``
    present) is read by its known layout — ``flight/``, ``traces/``,
    ``chaos.log`` at the top — anything else is scanned two levels
    deep (a chaos scenario workdir, a live job's scratch dirs)."""
    pats = {
        "flight": "*.flight.jsonl",
        "traces": "*.trace.json",
        "chaos": "chaos.log",
    }
    found: Dict[str, List[str]] = {k: [] for k in pats}
    if os.path.isfile(os.path.join(run_dir, "run.json")):
        found["flight"] = sorted(
            glob.glob(os.path.join(run_dir, "flight", pats["flight"]))
        )
        found["traces"] = sorted(
            glob.glob(os.path.join(run_dir, "traces", pats["traces"]))
        )
        found["chaos"] = sorted(
            glob.glob(os.path.join(run_dir, pats["chaos"]))
        )
        return found
    for depth in ("", "*", os.path.join("*", "*")):
        for kind, pat in pats.items():
            found[kind].extend(
                sorted(glob.glob(os.path.join(run_dir, depth, pat)))
            )
    return found


def load_events(found: Dict[str, List[str]]) -> List[Dict]:
    """One ts-ordered event list: flight records + chaos-ledger entries
    (tagged ``source``)."""
    events: List[Dict] = []
    flight_dirs = sorted({os.path.dirname(p) for p in found["flight"]})
    for d in flight_dirs:
        for ev in obs_events.read_segments(d):
            ev = dict(ev, source="flight")
            events.append(ev)
    for path in found["chaos"]:
        for entry in read_chaos_log(path):
            events.append(
                {
                    "ts": float(entry.get("ts", 0.0)),
                    "event": "chaos_%s" % entry.get("action", "?"),
                    "component": str(entry.get("who", "chaos")),
                    "pid": int(entry.get("pid", 0)),
                    "point": entry.get("point", ""),
                    "ctx": entry.get("ctx", {}),
                    "source": "chaos",
                }
            )
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def render_timeline(
    events: List[Dict], origin: float, max_events: int = 200
) -> str:
    """The causally ordered human view; chatty records (goodput flaps,
    step markers) are elided once the budget is tight, causal events
    never are."""
    interesting = [
        e for e in events
        if e.get("event") in _CAUSAL or e.get("source") == "chaos"
    ]
    picked = {id(e) for e in interesting}
    rest = [e for e in events if id(e) not in picked]
    keep = interesting + rest[: max(0, max_events - len(interesting))]
    keep.sort(key=lambda e: e.get("ts", 0.0))
    lines: List[str] = []
    for ev in keep[:max_events]:
        extra = " ".join(
            "%s=%s" % (k, v)
            for k, v in sorted(ev.items())
            if k not in ("ts", "event", "component", "pid", "source")
        )
        lines.append(
            "%+12.3fs  %-18s %-18s %s"
            % (
                ev.get("ts", 0.0) - origin,
                "%s[%s]" % (ev.get("component", "?"), ev.get("pid", 0)),
                ev.get("event", "?"),
                extra,
            )
        )
    if len(keep) > max_events:
        lines.append("... (%d more events; --max-events)" % (len(keep) - max_events))
    return "\n".join(lines)


def flight_trace_events(events: List[Dict], origin_us: float) -> List[dict]:
    """Flight records as Chrome trace events: goodput state intervals
    become duration slices (one lane per process), everything else an
    instant."""
    out: List[dict] = []
    intervals = obs_goodput.process_intervals(
        [e for e in events if e.get("source") == "flight"]
    )
    pid_base = 90_000_000  # clear of obs_merge's per-file pid namespaces
    lanes = sorted(intervals)
    for i, lane in enumerate(lanes):
        pid = pid_base + i
        out.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": "goodput %s-%d" % lane},
            }
        )
        for t0, t1, state in intervals[lane]:
            out.append(
                {
                    "name": state,
                    "ph": "X",
                    "ts": t0 * 1e6 - origin_us,
                    "dur": (t1 - t0) * 1e6,
                    "pid": pid,
                    "tid": 0,
                }
            )
    lane_pid = {lane: pid_base + i for i, lane in enumerate(lanes)}
    for ev in events:
        if ev.get("event") == obs_goodput.TRANSITION_EVENT:
            continue
        lane = (str(ev.get("component", "proc")), int(ev.get("pid", 0)))
        out.append(
            {
                "name": ev.get("event", "?"),
                "ph": "i",
                "s": "p",
                "ts": float(ev.get("ts", 0.0)) * 1e6 - origin_us,
                "pid": lane_pid.get(lane, pid_base + len(lanes)),
                "tid": 0,
                "args": {
                    k: str(v)
                    for k, v in ev.items()
                    if k not in ("ts", "event", "pid")
                },
            }
        )
    return out


def write_chrome_trace(
    events: List[Dict], trace_paths: List[str], out_path: str, origin: float
) -> int:
    """Splice flight lanes into the per-process obs traces and write one
    Chrome trace; returns the merged event count."""
    merged: List[dict] = []
    if trace_paths:
        doc = obs_merge.merge_traces(trace_paths, rebase=False)
        merged.extend(doc.get("traceEvents", []))
    origin_us = origin * 1e6
    for ev in merged:
        if ev.get("ph") != "M" and isinstance(ev.get("ts"), (int, float)):
            ev["ts"] = ev["ts"] - origin_us
    merged.extend(flight_trace_events(events, origin_us))
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    with open(out_path, "w") as f:
        json.dump(
            {
                "traceEvents": merged,
                "displayTimeUnit": "ms",
                "otherData": {"epoch_origin_us": origin_us},
            },
            f,
        )
    return len(merged)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_timeline",
        description="merge flight recorder + traces + chaos ledger into one "
        "causally ordered timeline with full wall-clock attribution",
    )
    parser.add_argument("run_dir", help="run directory (scanned 2 levels deep)")
    parser.add_argument(
        "-o", "--output", default=None,
        help="also write a merged Chrome trace (goodput lanes + spans)",
    )
    parser.add_argument("--max-events", type=int, default=200)
    parser.add_argument(
        "--json", action="store_true",
        help="emit the attribution + events as one JSON document",
    )
    args = parser.parse_args(argv)

    run_dir = resolve_run_dir(args.run_dir)
    found = discover(run_dir)
    events = load_events(found)
    # distributed tracing: flight rows carry the active trace_id of the
    # operation (restage/drain) they happened under — link them to the
    # stitched op traces BY ID instead of by timestamp proximity
    # named operations only: every request-scoped span without a parent
    # (a distill predict, a standalone periodic ckpt_save) roots its own
    # micro-trace, and thousands of those must not bury the handful of
    # restage/drain/failover rows this table exists to surface
    ops = [
        ot
        for ot in tracepath.extract_ops(tracepath.load_spans(found["traces"]))
        if ot.op
    ]
    op_by_trace = {ot.trace_id: ot.op for ot in ops if ot.trace_id}
    for ev in events:
        tid = ev.get("trace_id")
        if tid in op_by_trace:
            ev["op"] = "%s:%s" % (op_by_trace[tid], str(tid)[:8])
            ev.pop("trace_id", None)  # the short op tag replaces the raw id
    if not events:
        print(
            "no flight segments or chaos ledger under %s (set EDL_FLIGHT_DIR "
            "on the job to record them)" % args.run_dir,
            file=sys.stderr,
        )
        return 2
    goodput = obs_goodput.job_goodput(events)
    attribution = goodput["attribution"]
    origin = attribution["t0"]

    if args.json:
        print(json.dumps(
            {
                "attribution": attribution,
                "rollup": goodput["rollup"],
                "events": events,
            },
            default=str,
        ))
    else:
        print(
            "run %s: %d events, %d process(es), %.1fs wall-clock "
            "(t0 %s)"
            % (
                args.run_dir,
                len(events),
                len(attribution["lanes"]),
                attribution["wall_s"],
                time.strftime("%H:%M:%S", time.localtime(origin)),
            )
        )
        print()
        print("TIMELINE")
        print(render_timeline(events, origin, max_events=args.max_events))
        if ops:
            print()
            print("OPERATIONS (stitched traces; `edl-trace %s` for the "
                  "critical paths)" % args.run_dir)
            for ot in ops:
                path = tracepath.critical_path(ot)
                print(
                    "  %-16s %s  %+10.3fs  %7.3fs  %d seg  %s"
                    % (
                        ot.op or "(unnamed)",
                        ot.trace_id[:8],
                        ot.t0 - origin,
                        ot.t1 - ot.t0,
                        sum(1 for p in path if p.segment is not None),
                        ",".join(ot.processes),
                    )
                )
        print()
        print("ATTRIBUTION (job lane: highest-priority state across processes)")
        print(obs_goodput.render_table(attribution))
        lanes = attribution["lanes"]
        if lanes:
            print()
            print("PER-PROCESS")
            for lane, states in sorted(lanes.items()):
                total = sum(states.values())
                print(
                    "  %-24s %8.1fs  %s"
                    % (
                        lane,
                        total,
                        "  ".join(
                            "%s=%.1fs" % (s, states[s])
                            for s in obs_goodput.PRIORITY
                            if s in states
                        ),
                    )
                )
    if args.output:
        n = write_chrome_trace(events, found["traces"], args.output, origin)
        print(
            "wrote %d trace events -> %s" % (n, args.output), file=sys.stderr
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
