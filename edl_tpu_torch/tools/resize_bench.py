"""Resize-cost benchmark: what does an elastic resize actually cost?

The port of ``tools/resize_bench.py``: it drives the port's store
(``StoreServer``), ``harness/resize.ResizeHarness`` and instrumented
collective workers (``edl_tpu_torch/tools/resize_bench_worker.py``)
through a pod-count schedule, then reads the stage telemetry back and
reports, per stage, steady-state samples/s (and per worker) and, per
transition, the downtime decomposition drain → killed → published →
first step. The question is BASELINE's north star: the img/s each card
loses across a resize, with measured numbers in place of the reference's
wall-clock demo (README.md:108-142).

Output: ONE JSON line on stdout, the JAX tool's keys::

    {"metric": "resize_downtime", "value": <max transition downtime s>,
     "unit": "s", "per_chip_loss_pct": ..., "stages": [...],
     "transitions": [...], ...}

The workers train ResNet50_vd at 224x224 on ``--device cuda`` (the
default) and an MLP on ``--device cpu``. The planes' switches map onto
the port's own: ``--no-aot`` sets ``EDL_AOT=0`` and
``EDL_CACHE_EXCHANGE=0`` (no memory-plan ladder, no kernel-library
exchange), standby shells (``EDL_STANDBY=1``, on unless
``--no-standby``) pre-import torch and the package, ``--prewarm`` turns
on the launcher's shadow stages (``EDL_PREWARM=1``). On the card a run
without ``EDL_COMPILE_CACHE_DIR`` gets a kernel-library directory of its
own, so the ladder and the exchange are armed. With ``EDL_RUN_ARCHIVE``
set the run is archived as one bundle (backend = the device), its kind
suffixed by the planes it turned off or on.

Usage::

    python -m edl_tpu_torch.tools.resize_bench --schedule 1,r --interval 40
    python -m edl_tpu_torch.tools.resize_bench --device cpu --schedule 2,1
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from edl_tpu_torch.harness.resize import ResizeHarness, parse_schedule
from edl_tpu_torch.obs import archive as run_archive
from edl_tpu_torch.store.client import StoreClient
from edl_tpu_torch.store.server import StoreServer
from edl_tpu_torch.utils import telemetry

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "resize_bench_worker.py")


def analyze(data: dict) -> dict:
    """Turn raw telemetry into the stage/transition report."""
    events = data["events"]
    metrics = data["metrics"]
    stage_info = data.get("stages", {})
    cache = data.get("cache", {})

    stages = []
    for stage, evs in events.items():
        if "published" not in evs:
            continue  # drain token that never converged to a generation
        meters = metrics.get(stage, {})
        world = stage_info.get(stage, {}).get("world", 0) or max(
            (m.get("world", 0) for m in meters.values()), default=0
        )
        total_sps = sum(m["sps"] for m in meters.values())
        cstats = cache.get(stage, {})
        stages.append(
            {
                "stage": stage[:8],
                "published_ts": min(evs["published"].values()),
                "drain_ts": min(evs["drain"].values()) if "drain" in evs else None,
                "killed_ts": max(evs["killed"].values()) if "killed" in evs else None,
                # 'ready' = state built, about to jit: the restore/compile
                # boundary of the restage lane
                "ready_ts": max(evs["ready"].values())
                if "ready" in evs else None,
                "first_step_ts": max(evs["first_step"].values())
                if "first_step" in evs else None,
                "world": world or len(meters),
                "workers_metered": len(meters),
                "samples_per_s": round(total_sps, 2),
                "samples_per_s_per_worker": round(total_sps / len(meters), 2)
                if meters else None,
                # persistent-cache ledger reaching the first step: a
                # speculated (AOT-ladder / peer-pulled) stage shows
                # hits > 0, misses == 0 — "cache load", not "compile"
                "cache_hits": sum(c.get("hit", 0) for c in cstats.values()),
                "cache_misses": sum(c.get("miss", 0) for c in cstats.values()),
                "cache_writes": sum(c.get("write", 0) for c in cstats.values()),
            }
        )
    stages.sort(key=lambda s: s["published_ts"])

    transitions = []
    for prev, cur in zip(stages, stages[1:]):
        t = {"from_world": prev["world"], "to_world": cur["world"],
             "stage": cur["stage"]}
        if cur["drain_ts"] and cur["first_step_ts"]:
            t["downtime_s"] = round(cur["first_step_ts"] - cur["drain_ts"], 3)
            if cur["killed_ts"]:
                t["kill_s"] = round(cur["killed_ts"] - cur["drain_ts"], 3)
            t["publish_s"] = round(cur["published_ts"] - cur["drain_ts"], 3)
            t["spawn_to_first_step_s"] = round(
                cur["first_step_ts"] - cur["published_ts"], 3
            )
            if cur["ready_ts"]:
                # the split the AOT ladder exists to move: restore_s is
                # process spawn + imports + init + state build, compile_s
                # is the jit — a real compile, or (speculation paid off)
                # a persistent-cache load
                t["restore_s"] = round(
                    cur["ready_ts"] - cur["published_ts"], 3
                )
                t["compile_s"] = round(
                    cur["first_step_ts"] - cur["ready_ts"], 3
                )
            t["cache_hits"] = cur["cache_hits"]
            t["cache_misses"] = cur["cache_misses"]
        transitions.append(t)

    # the north-star question is RECOVERY, not cross-world comparison: on
    # one host, different world sizes contend differently for the same
    # cores, so per-worker throughput is only comparable between stages of
    # EQUAL world size (e.g. schedule 2,4,2: the two world-2 stages). Loss
    # = earliest vs latest same-world stage; the raw spread across all
    # stages stays available as a diagnostic.
    by_world = {}
    for s in stages:
        if s["samples_per_s_per_worker"]:
            by_world.setdefault(s["world"], []).append(
                s["samples_per_s_per_worker"]
            )
    loss_pct = None
    revisits = {w: v for w, v in by_world.items() if len(v) >= 2}
    if revisits:
        loss_pct = round(
            max((v[0] - v[-1]) / v[0] * 100 for v in revisits.values()), 2
        )
    per_worker = [
        s["samples_per_s_per_worker"]
        for s in stages
        if s["samples_per_s_per_worker"]
    ]
    spread_pct = None
    if len(per_worker) >= 2:
        spread_pct = round(
            (max(per_worker) - min(per_worker)) / max(per_worker) * 100, 2
        )

    downtimes = [t["downtime_s"] for t in transitions if "downtime_s" in t]
    return {
        "metric": "resize_downtime",
        "value": round(max(downtimes), 3) if downtimes else None,
        "unit": "s",
        "per_chip_loss_pct": loss_pct,  # BASELINE north star: <= 5
        "per_worker_spread_pct": spread_pct,  # diagnostic, cross-world
        "stages": stages,
        "transitions": transitions,
    }


def run(schedule, interval, batch_per_worker=None, ttl=1.5,
        nproc_per_node=1, tail=None, device="cuda", prewarm=False,
        standby=True, aot=True) -> dict:
    """Walk a job of resize-bench workers through ``schedule`` (see
    ``harness.resize.parse_schedule``) and return the report."""
    store = StoreServer(port=0).start()
    job_id = "resize-bench-%d" % int(time.time())
    on_gpu = device.startswith("cuda")
    extra_env = {"EDL_DEVICES_PER_PROC": "1"}
    work = tempfile.mkdtemp(prefix="edl-resize-bench-")
    if on_gpu and not os.environ.get("EDL_COMPILE_CACHE_DIR"):
        # a kernel-library dir of the run's own: the exchange and the
        # ladder are armed only where a compile cache is
        extra_env["EDL_COMPILE_CACHE_DIR"] = os.path.join(work, "cache")
    if not on_gpu:
        # a CPU worker loads no kernel library
        extra_env["EDL_COMPILE_CACHE_DIR"] = "none"
    # run archive (EDL_RUN_ARCHIVE): the bench archives ONE bundle with
    # the report as rollups PLUS the workers' flight segments and trace
    # exports, so `edl_report --diff` can attribute a downtime
    # regression to a goodput lane / critical-path segment — the harness
    # hook is disabled (the bench's own archive carries more)
    archive_to = run_archive.archive_root()
    if archive_to:
        extra_env["EDL_FLIGHT_DIR"] = os.path.join(work, "flight")
        extra_env["EDL_TRACE_DIR"] = os.path.join(work, "traces")
        extra_env["EDL_RUN_ARCHIVE"] = "0"
    if not aot:
        # the A/B control: no neighbour-world plans, no cache exchange —
        # every resize builds or copies what its own host lacks
        extra_env["EDL_AOT"] = "0"
        extra_env["EDL_CACHE_EXCHANGE"] = "0"
    elif not on_gpu:
        # single-core-rig tuning: at nice 10 the ladder thread loses the
        # CPU to the co-hosted workers and races the schedule's next
        # resize. On the card the defaults (nice 10, delay 1 s) ride
        # spare host cores and stay.
        extra_env["EDL_AOT_NICE"] = "0"
        extra_env["EDL_AOT_DELAY"] = "0.2"
    if standby:
        # standby worker shells (launch/standby.py): a replacement pod's
        # worker skips the interpreter's and torch's import cold start
        extra_env["EDL_STANDBY"] = "1"
    if prewarm:
        # the launcher's shadow stages (launch/warm.py): a grow lands on
        # a stage that already ran two steps at its world
        extra_env["EDL_PREWARM"] = "1"
        if not on_gpu:
            # single-core-rig tuning, as the ladder's above: nice 0 so
            # the shadow stage outraces the resize, one shadow stage (the
            # largest grow) so none overlaps a transition, delay 25 s so
            # the live stage's own first step comes first
            extra_env["EDL_PREWARM_NICE"] = "0"
            extra_env["EDL_PREWARM_MAX"] = "1"
            extra_env["EDL_PREWARM_DELAY"] = "25"
    worker_args = ["--device", device]
    if batch_per_worker:
        worker_args += ["--batch_per_worker", str(batch_per_worker)]
    harness = ResizeHarness(
        store.endpoint, job_id, WORKER, worker_args,
        nodes_range="1:%d" % max(
            [w for w in schedule if isinstance(w, int)] or [1]
        ),
        nproc_per_node=nproc_per_node,
        ttl=ttl,
        extra_env=extra_env,
        device=device,
    )
    try:
        # workers run forever; the schedule + tail dwell bounds the run
        deadline = len(schedule) * interval + (tail if tail is not None else interval)
        harness.run_schedule(schedule, interval, timeout=deadline)
    finally:
        harness.shutdown()
    client = StoreClient(store.endpoint, timeout=5.0)
    try:
        data = telemetry.collect(client, job_id)
        report = analyze(data)
    finally:
        client.close()
        store.stop()
    report["telemetry_dropped"] = data.get("dropped", 0)
    if report["telemetry_dropped"]:
        print(
            "WARNING: %d malformed telemetry entries dropped — treat this "
            "run's numbers as suspect" % report["telemetry_dropped"],
            file=sys.stderr,
        )
    report["schedule"] = list(schedule)
    report["prewarm"] = bool(prewarm)
    report["standby"] = bool(standby)
    report["aot"] = bool(aot)
    # the JAX tool's key ("cpu" or "tpu" there): where the workers ran
    report["platform"] = "gpu" if on_gpu else "cpu"
    report["device"] = device
    keep = False
    if archive_to:
        worlds = [w for w in schedule if isinstance(w, int)]
        # A/B flags live in the KIND: a --no-aot control lane must trend
        # against other control runs, never share a rolling baseline
        # with its treatment sibling
        kind = "resize_bench"
        if prewarm:
            kind += "_prewarm"
        if not standby:
            kind += "_nostandby"
        if not aot:
            kind += "_noaot"
        bundle = run_archive.maybe_archive_bench(
            kind, report, job_id=device, backend=device,
            world=max(worlds) if worlds else 1,
            flight_dir=extra_env.get("EDL_FLIGHT_DIR"),
            trace_dir=extra_env.get("EDL_TRACE_DIR"),
            root=archive_to,
        )
        if bundle:
            report["bundle"] = os.path.basename(bundle)
            print("archived -> %s" % bundle, file=sys.stderr)
        else:
            # the work dir holds the run's ONLY flight/trace copy: a
            # failed archive (full disk, perms) must not destroy it
            keep = True
            print("archive failed; flight/trace artifacts kept at %s"
                  % work, file=sys.stderr)
    if not keep:
        shutil.rmtree(work, ignore_errors=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.resize_bench",
        description=__doc__.split("\n")[0])
    parser.add_argument(
        "--schedule", default="2,4,2",
        help="comma list of world sizes; an 'r' entry SIGKILLs the "
        "youngest pod and replaces it (constant-capacity recovery "
        "drill, e.g. 1,r,r on a one-card host)",
    )
    parser.add_argument("--interval", type=float, default=25.0)
    parser.add_argument(
        "--tail", type=float, default=None,
        help="seconds held after the schedule's last entry (default: "
        "one interval)",
    )
    parser.add_argument("--batch_per_worker", type=int, default=None)
    parser.add_argument("--ttl", type=float, default=1.5)
    parser.add_argument("--nproc_per_node", type=int, default=1)
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default: ResNet50_vd workers on the card; the run "
        "fails without one) or cpu (MLP workers)",
    )
    parser.add_argument(
        "--prewarm", action="store_true",
        help="enable the launcher's shadow stages for anticipated world "
        "sizes (launch/warm.py)",
    )
    parser.add_argument(
        "--no-standby", action="store_true",
        help="disable the standby worker shells (the cold-spawn control "
        "measurement; standby is on by default)",
    )
    parser.add_argument(
        "--no-aot", action="store_true",
        help="disable the AOT ladder's memory plans and the kernel-cache "
        "exchange (the control measurement; on by default)",
    )
    args = parser.parse_args(argv)

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("resize_bench: CUDA is not available (pass --device cpu "
                  "for the CPU workers)", file=sys.stderr)
            return 2

    report = run(
        parse_schedule(args.schedule),
        args.interval,
        batch_per_worker=args.batch_per_worker,
        ttl=args.ttl,
        nproc_per_node=args.nproc_per_node,
        tail=args.tail,
        device=args.device,
        prewarm=args.prewarm,
        standby=not args.no_standby,
        aot=not args.no_aot,
    )
    for s in report["stages"]:
        print(
            "stage %s world=%d: %.1f samples/s (%.1f/worker)"
            % (s["stage"], s["world"], s["samples_per_s"] or 0,
               s["samples_per_s_per_worker"] or 0),
            file=sys.stderr,
        )
    for t in report["transitions"]:
        print(
            "resize %d->%d: downtime %.2fs (kill %.2fs, publish %.2fs, "
            "spawn-to-step %.2fs = restore %.2fs + first step %.2fs; "
            "cache %d hit / %d miss)"
            % (t["from_world"], t["to_world"], t.get("downtime_s", -1),
               t.get("kill_s", -1), t.get("publish_s", -1),
               t.get("spawn_to_first_step_s", -1), t.get("restore_s", -1),
               t.get("compile_s", -1), t.get("cache_hits", 0),
               t.get("cache_misses", 0)),
            file=sys.stderr,
        )
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
