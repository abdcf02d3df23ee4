"""``edl-status``: live cluster/job inspector over the store keyspace.

The reference ships protobuf pretty-printers and per-daemon log greps as
its only visibility into a running job (SURVEY §2 C20 utils; §5 "no
metrics export, no dashboards"). Here the entire control plane lives in
one store keyspace (``/{job_id}/{service}/...``), so one range scan can
render the whole job: cluster generation + pods with ranks, live
resources, drain fencing, registered teachers, job status.

    edl-status --store 127.0.0.1:2379 --job_id rn50 [--json] [--watch N]

The port's copy of ``edl_tpu/cluster/status.py``:
``python -m edl_tpu_torch.cluster.status --store H:P --job_id J``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Tuple

from edl_tpu_torch.store.client import StoreClient


def collect(client: StoreClient, job_id: str) -> Dict[str, List[Tuple[str, str]]]:
    """Group every key under the job by service segment."""
    prefix = "/%s/" % job_id
    kvs, _rev = client.range(prefix)
    services: Dict[str, List[Tuple[str, str]]] = {}
    for key, value, _cr, _mr in kvs:
        rest = key[len(prefix):]
        service, _, name = rest.partition("/")
        try:
            text = value.decode("utf-8", "replace")
        except AttributeError:
            text = str(value)
        services.setdefault(service, []).append((name, text))
    return services


def _fmt_pod(payload: str) -> str:
    try:
        pod = json.loads(payload)
    except ValueError:
        return payload[:60]
    if not isinstance(pod, dict):  # valid JSON scalar: render raw
        return payload[:60]
    return "%s @%s gpus/chips=%s stage=%s" % (
        str(pod.get("pod_id", "?"))[:12],
        pod.get("addr", "?"),
        len(pod.get("workers", pod.get("trainers", []))) or pod.get("num_workers", "?"),
        str(pod.get("stage", ""))[:12],
    )


def render(services: Dict[str, List[Tuple[str, str]]]) -> str:
    lines: List[str] = []
    cluster = dict(services.get("cluster", []))
    if "current" in cluster:
        try:
            cur = json.loads(cluster["current"])
            pods = cur.get("pods", [])
            lines.append(
                "cluster: stage=%s pods=%d world_size=%s"
                % (
                    str(cur.get("stage", "?"))[:12],
                    len(pods),
                    cur.get("world_size", sum(len(p.get("workers", [])) for p in pods)),
                )
            )
        except ValueError:
            lines.append("cluster: %s" % cluster["current"][:80])
    for svc, title, fmt in (
        ("pod_rank", "ranks", _fmt_pod),
        ("pod_resource", "live pods", _fmt_pod),
    ):
        entries = services.get(svc, [])
        if entries:
            lines.append("%s (%d):" % (title, len(entries)))
            for name, payload in sorted(entries):
                lines.append("  %-6s %s" % (name, fmt(payload)))
    drain = services.get("drain", [])
    if drain:
        lines.append("drain: %s" % ", ".join("%s=%s" % (n, v[:24]) for n, v in drain))
    job = dict(services.get("job", []))
    if job:
        lines.append("job: %s" % ", ".join("%s=%s" % kv for kv in sorted(job.items())))
    # anything else (teachers, barriers, balance tables, ...) generically
    known = {"cluster", "pod_rank", "pod_resource", "drain", "job"}
    for svc in sorted(services):
        if svc in known:
            continue
        entries = services[svc]
        lines.append("%s (%d):" % (svc, len(entries)))
        for name, payload in sorted(entries)[:20]:
            lines.append("  %-24s %s" % (name, payload[:60]))
        if len(entries) > 20:
            lines.append("  ... %d more" % (len(entries) - 20))
    return "\n".join(lines) if lines else "(no keys for this job)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="edl-status", description=__doc__)
    parser.add_argument("--store", required=True, help="host:port")
    parser.add_argument("--job_id", required=True)
    parser.add_argument("--json", action="store_true", help="machine output")
    parser.add_argument(
        "--watch", type=float, default=0.0,
        help="re-render every N seconds until interrupted",
    )
    parser.add_argument(
        "--dispatcher", default=None, metavar="HOST:PORT",
        help="also query a data-dispatcher/master daemon for task-queue "
        "state (todo/pending/done/failed, epoch)",
    )
    args = parser.parse_args(argv)
    client = StoreClient(args.store, timeout=10.0)
    try:
        while True:
            services = collect(client, args.job_id)
            dispatch = None
            if args.dispatcher:
                from edl_tpu_torch.data import DispatcherClient

                dc = None
                try:
                    dc = DispatcherClient(
                        args.dispatcher, "edl-status", timeout=10.0
                    )
                    dispatch = dc.state()
                except Exception as exc:  # render what we can
                    dispatch = {"error": str(exc)}
                finally:
                    if dc is not None:
                        dc.close()
            if args.json:
                blob = {s: dict(kv) for s, kv in services.items()}
                if dispatch is not None:
                    blob["dispatcher"] = dispatch
                print(json.dumps(blob, sort_keys=True))
            else:
                print(render(services))
                if dispatch is not None:
                    print(
                        "dispatcher: "
                        + ", ".join(
                            "%s=%s" % kv for kv in sorted(dispatch.items())
                        )
                    )
            if not args.watch:
                return 0
            time.sleep(args.watch)
            if not args.json:
                print("---")
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
