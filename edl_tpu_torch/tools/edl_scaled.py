"""edl-scaled: the scale-plane daemon — one arbiter for N elastic jobs.

Watches every configured job's goodput ratio, per-pod step rate,
gradient-noise-scale and straggler pressure off the monitor plane, fits
the Pollux-style goodput model per job, splits the shared device pool
cluster-goodput-maximizingly (priority admission, gang floors), and
publishes ``scale/target`` docs the leader launcher reconciles through
drain/restage — grow admits held pods, shrink drains ``preempt/{pod}``
notices with ``cause=autoscale``. See DESIGN.md "Scale plane".

Usage::

    python -m edl_tpu_torch.tools.edl_scaled --store 127.0.0.1:2379 --job train1:1:8
    python -m edl_tpu_torch.tools.edl_scaled --store ... \\
        --job big:2:8:10 --job small:1:4:0 --capacity 8   # shared pool
    python -m edl_tpu_torch.tools.edl_scaled --store ... --job j:1:4 --once --json

``--job`` repeats, one per arbitrated job, as
``job_id[:min[:max[:priority]]]``. ``--capacity`` fixes the pool size;
without it the pool is the sum of the jobs' actual worlds (single-job
fit-to-what-exists mode). ``EDL_SCALE_ALPHA`` / ``EDL_SCALE_GNS`` /
``EDL_SCALE_HYSTERESIS`` / ``EDL_SCALE_COOLDOWN`` tune the model and
damping; ``EDL_FLIGHT_DIR`` / ``EDL_TRACE_DIR`` arm the decision flight
records and the deterministic ``scale`` op trace roots.

The port's copy of ``tools/edl_scaled.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time
from typing import List, Optional

from edl_tpu_torch.obs import events as obs_events
from edl_tpu_torch.scale import scaler as scale_scaler


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_scaled",
        description="goodput-driven autoscaler + multi-job scheduler: "
        "publishes scale/target docs the leader launcher reconciles",
    )
    parser.add_argument("--store", required=True, help="store endpoint(s) ip:port[,ip:port]")
    parser.add_argument(
        "--job", action="append", required=True, metavar="ID[:MIN[:MAX[:PRIO]]]",
        help="arbitrated job spec; repeat for a shared pool",
    )
    parser.add_argument("--interval", type=float, default=5.0, help="decision interval seconds")
    parser.add_argument(
        "--capacity", type=int, default=None,
        help="shared pool size in pods (default: sum of actual worlds)",
    )
    parser.add_argument("--once", action="store_true", help="one sweep, print decisions, exit")
    parser.add_argument("--json", action="store_true", help="with --once: emit JSON")
    args = parser.parse_args(argv)

    jobs = [scale_scaler.JobSpec.parse(spec) for spec in args.job]
    scaler = scale_scaler.Scaler(
        args.store,
        jobs,
        interval=args.interval,
        capacity=args.capacity,
        flight_dir=os.environ.get(obs_events.ENV_DIR, "").strip() or None,
        trace_dir=(os.environ.get("EDL_TRACE_DIR") or "").strip() or None,
    )

    if args.once:
        acted = scaler.poll_once()
        if args.json:
            print(json.dumps([dataclasses.asdict(d) for d in acted]))
        else:
            for d in acted:
                print(
                    "#%d %s %s -> %d pods (%s)"
                    % (d.seq, d.job_id, d.kind, d.target, d.cause)
                )
            if not acted:
                print("no action (all jobs hold)")
        scaler.stop()
        return 0

    stop = []
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(signum, lambda *_a: stop.append(1))
        except ValueError:
            pass
    scaler.start()
    try:
        while not stop:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        scaler.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
