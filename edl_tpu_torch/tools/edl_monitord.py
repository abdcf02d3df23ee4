"""edl-monitord: the monitor-plane daemon for one elastic job.

Discovers every process's ``/metrics`` endpoint from the job's ``obs/``
store keyspace (the same discovery ``edl-top`` uses), scrapes on an
interval, retains the samples as crash-safe ring-file time series under
``--monitor-dir`` / ``EDL_MONITOR_DIR``, evaluates the built-in SLO rule
pack (goodput degraded, straggler ejections, replication lag, checkpoint
restore fallbacks, distill queue saturation, dead endpoints, heartbeat
staleness, restart detection, telemetry corruption) over the retained
window, and publishes firing/resolved alert records to the store's
``alerts/{rule}`` keyspace — where ``edl-top`` renders them and a
goodput-driven autoscaler can subscribe to them.

Usage::

    python -m edl_tpu_torch.tools.edl_monitord --store 127.0.0.1:2379 --job myjob
    python -m edl_tpu_torch.tools.edl_monitord --store ... --job ... --interval 2 \\
        --rules @rules.json          # re-pace / extend the built-in pack
    python -m edl_tpu_torch.tools.edl_monitord --store ... --job ... --once --json

``--rules`` takes inline JSON or ``@file``: a list of rule objects that
override same-named built-ins field-wise and append new ones
(``--no-builtin`` starts from an empty pack instead). With
``EDL_OBS_PORT`` set the daemon mounts its own ``/metrics`` +
``/healthz`` (component ``monitor``) and registers the endpoint, so the
monitor is itself monitorable.

``--auto-capture`` (default on) arms the profiling plane's
alert-triggered snapshots: a ``goodput-degraded`` or ``mfu-degraded``
firing publishes one ``profile/request`` the job's workers answer with a
bounded ``torch.profiler`` window — per-job cooldown
(``--capture-cooldown``) and a lifetime cap (``--capture-max``) bound
the disk a flapping rule can fill. ``--no-auto-capture`` disables.

The port's copy of ``tools/edl_monitord.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import monitor as obs_monitor


def _load_rules(spec: Optional[str], no_builtin: bool) -> List[obs_monitor.Rule]:
    base = [] if no_builtin else obs_monitor.builtin_rules()
    if not spec:
        return base
    text = spec
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            text = f.read()
    return obs_monitor.rules_from_json(text, base=base or None)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_monitord",
        description="scrape-and-retain monitor daemon: SLO rules over every "
        "/metrics endpoint of one elastic job, alerts published to the store",
    )
    parser.add_argument("--store", required=True, help="store endpoint(s) ip:port[,ip:port]")
    parser.add_argument("--job", required=True, help="job id")
    parser.add_argument("--interval", type=float, default=5.0, help="scrape interval seconds")
    parser.add_argument(
        "--retention", type=float, default=300.0,
        help="in-memory retention window seconds (disk ring segments rotate "
        "independently by size)",
    )
    parser.add_argument(
        "--monitor-dir", default=None,
        help="ring-file time-series retention dir (default: $EDL_MONITOR_DIR; "
        "unset = in-memory retention only)",
    )
    parser.add_argument(
        "--rules", default=None,
        help="JSON rule list (inline or @file) overriding/extending the "
        "built-in pack",
    )
    parser.add_argument(
        "--no-builtin", action="store_true",
        help="start from an empty pack instead of the built-in rules",
    )
    parser.add_argument(
        "--list-rules", action="store_true", help="print the effective rule pack and exit"
    )
    parser.add_argument("--once", action="store_true", help="one sweep, print state, exit")
    parser.add_argument(
        "--json", action="store_true", help="with --once/--list-rules: emit JSON"
    )
    parser.add_argument(
        "--auto-capture", dest="auto_capture", action="store_true",
        default=True,
        help="request an on-device profiler capture when goodput-degraded "
        "or mfu-degraded fires (default on)",
    )
    parser.add_argument(
        "--no-auto-capture", dest="auto_capture", action="store_false",
    )
    parser.add_argument(
        "--capture-cooldown", type=float, default=300.0,
        help="seconds between auto-requested captures",
    )
    parser.add_argument(
        "--capture-max", type=int, default=5,
        help="lifetime cap on auto-requested captures for this daemon",
    )
    args = parser.parse_args(argv)

    rules = _load_rules(args.rules, args.no_builtin)
    if args.list_rules:
        if args.json:
            print(json.dumps([r.to_dict() for r in rules], indent=2))
        else:
            for r in rules:
                print(
                    "%-24s %-9s %-9s %s"
                    % (
                        r.name, r.kind, r.severity,
                        "%s %s %g" % (r.metric, r.op, r.value)
                        if r.metric else "stale>%gs" % r.stale_s,
                    )
                )
        return 0

    monitor_dir = args.monitor_dir or os.environ.get(obs_monitor.ENV_DIR, "").strip() or None
    mon = obs_monitor.Monitor(
        args.store,
        args.job,
        rules=rules,
        interval=args.interval,
        retention_s=args.retention,
        monitor_dir=monitor_dir,
    )

    if args.auto_capture and mon.client is not None:
        from edl_tpu_torch.obs import profile as obs_profile

        # alert-triggered snapshots: the firing that says "degraded"
        # auto-requests the on-device trace that says WHY. Subscribed,
        # not assigned — the scale plane hooks the same registry.
        mon.add_on_fire(obs_profile.AutoCapture(
            mon.client, args.job,
            cooldown_s=args.capture_cooldown,
            max_captures=args.capture_max,
        ))

    obs = obs_http.start_from_env("monitor", health_fn=mon.health)
    if obs is not None and mon.client is not None:
        obs_http.register_endpoint(
            mon.client, args.job, "monitor", "d%d" % os.getpid(), obs.endpoint
        )

    if args.once:
        transitions = mon.poll_once()
        doc = {"health": mon.health(), "transitions": transitions}
        if args.json:
            print(json.dumps(doc))
        else:
            h = doc["health"]
            print(
                "job=%s targets=%d retained=%d firing=%s%s"
                % (
                    h["job"], h["targets"], h["retained_samples"],
                    ",".join(h["firing"]) or "-",
                    " (job COMPLETE)" if h["job_complete"] else "",
                )
            )
            for t in transitions:
                print("  %s -> %s (value=%s)" % (t["rule"], t["state"], t["value"]))
        mon.stop()
        return 0

    stop = []
    for signum in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(signum, lambda *_a: stop.append(1))
        except ValueError:
            pass
    mon.start()
    try:
        while not stop:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        mon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
