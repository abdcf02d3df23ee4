"""edl-top: live job dashboard for an elastic edl_tpu_torch job.

One screen answers the questions the reference can only answer by
grepping worker logs: which stage is the job on, which workers are
stepping (samples/s, heartbeat age), what are the queue depths, did any
transition cost more than it should.

Data sources (both read-only, both safe against a live job):

- the store telemetry keyspace (``edl_tpu_torch/utils/telemetry.py``): stage
  events, per-worker steady-state meters, published cluster;
- each process's ``/metrics`` + ``/healthz`` endpoints, discovered from
  the job's ``obs/`` keyspace (written by every process that mounts
  :mod:`edl_tpu_torch.obs.http` with ``EDL_OBS_PORT`` set).

Usage::

    python -m edl_tpu_torch.tools.edl_top --store 127.0.0.1:2379 --job myjob
    python -m edl_tpu_torch.tools.edl_top --store ... --job myjob --once  # one shot

The port's copy of ``tools/edl_top.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.cluster.contract import CLUSTER_SERVICE
from edl_tpu_torch.cluster.model import Cluster
from edl_tpu_torch.obs import http as obs_http
from edl_tpu_torch.obs import monitor as obs_monitor
from edl_tpu_torch.obs.metrics import (  # the one shared impl
    bucket_grid,
    histogram_quantile,
    quantile_from_grid,
)
from edl_tpu_torch.store.client import StoreClient, connect_store
from edl_tpu_torch.utils import telemetry

# /metrics series edl-top surfaces in the endpoints table, in order
_INTERESTING = (
    ("edl_goodput_ratio", "goodput%"),
    ("edl_train_mfu_ratio", "mfu%"),
    ("edl_device_hbm_bytes_in_use", "hbm_gb"),
    ("edl_store_requests_total", "reqs"),
    ("edl_store_epoch_seq", "epoch"),
    ("edl_store_replication_lag_entries", "repl_lag"),
    ("edl_store_repl_unacked_bytes", "unacked_b"),
    ("edl_store_repl_sync_degraded_total", "sync_degr"),
    ("edl_launch_workers_running", "workers"),
    ("edl_launch_drains_total", "drains"),
    ("edl_launch_straggler_ejections_total", "straggler"),
    ("edl_launch_grace_remaining_seconds", "grace"),
    ("edl_data_todo_tasks", "todo"),
    ("edl_data_pending_tasks", "pending"),
    ("edl_distill_task_queue_depth", "taskq"),
    ("edl_distill_out_queue_depth", "outq"),
    ("edl_distill_serve_requests_total", "serves"),
    ("edl_train_steps_total", "steps"),
    # numerics plane: is the run still TRAINING, not just stepping
    ("edl_train_loss", "loss"),
    ("edl_train_grad_norm", "gnorm"),
    ("edl_train_grad_noise_scale", "gns"),
    ("edl_train_nonfinite_total", "nonfinite"),
    ("edl_chaos_faults_injected_total", "faults"),
    ("edl_rpc_retries_total", "retries"),
)


def _fmt_age(age: Optional[float]) -> str:
    if age is None:
        return "-"
    if age < 0:
        age = 0.0
    if age < 100:
        return "%.1fs" % age
    return "%dm%02ds" % (age // 60, int(age) % 60)


# per-endpoint (monotonic_ts, cumulative sreads) from the previous frame
# — the standby-served-reads/s column is a difference of snapshots
_SREADS_PREV: Dict[str, Tuple[float, int]] = {}

# serving plane rate columns (shed/s per teacher port, hedge/s per
# client) — same difference-of-snapshots idiom
_SHED_PREV: Dict[Tuple[str, str], Tuple[float, float]] = {}
_HEDGE_PREV: Dict[str, Tuple[float, float]] = {}


def _rate(prev_map, key, value):
    now_m = time.monotonic()
    prev = prev_map.get(key)
    rate = None
    if prev is not None and now_m > prev[0] and value >= prev[1]:
        rate = (value - prev[1]) / (now_m - prev[0])
    prev_map[key] = (now_m, value)
    return rate


def gather(client: StoreClient, job_id: str) -> Dict:
    """One snapshot of everything edl-top renders (pure data, testable)."""
    data = telemetry.collect(client, job_id)
    snap = {
        "job": job_id,
        "ts": time.time(),
        "dropped": data.get("dropped", 0),
        "cluster": None,
        "stages": data.get("stages", {}),
        "events": data.get("events", {}),
        "metrics": data.get("metrics", {}),
        "endpoints": [],
        "shards": [],
        "ckpt_replicas": [],
        "alerts": obs_monitor.read_alerts(client, job_id),
        "scale": {},
    }
    # -- scale plane: the autoscaler's published verdicts for this job
    # (permanent docs under the scale/ service; absent = no scaler)
    try:
        from edl_tpu_torch.cluster.contract import SCALE_SERVICE
        from edl_tpu_torch.discovery.registry import Registry
        from edl_tpu_torch.scale.scaler import DECISION_KEY, TARGET_KEY

        reg = Registry(client, job_id)
        for key in (TARGET_KEY, DECISION_KEY):
            meta = reg.get_server(SCALE_SERVICE, key)
            if meta is not None:
                snap["scale"][key] = json.loads(meta.value)
    except Exception:  # noqa: BLE001 — a partial snapshot still renders
        pass
    # -- memory plane: the compile-time plans published per world, each
    # judged against its own embedded device limit (the fit gate's view)
    snap["mem_plans"] = {}
    try:
        from edl_tpu_torch.obs import memory as obs_memory

        for w, plan in sorted(
            obs_memory.read_plans(client, job_id).items()
        ):
            doc = plan.to_doc()
            doc["fits"] = obs_memory.fit_check(plan.total(), plan.limit)
            snap["mem_plans"][w] = doc
    except Exception:  # noqa: BLE001 — a partial snapshot still renders
        pass
    # -- checkpoint replica freshness: one row per (holder, src, step),
    # straight from the ckpt/replicas/ manifests the holders publish
    try:
        from edl_tpu_torch.checkpoint import replicate as ckpt_replicate

        for holder, manifest in sorted(
            ckpt_replicate.read_replica_manifests(client, job_id).items()
        ):
            for src, steps in sorted(
                (manifest.get("replicas") or {}).items()
            ):
                complete = [
                    int(s) for s, info in steps.items()
                    if info.get("complete") and str(s).isdigit()
                ]
                if not complete:
                    continue
                newest = max(complete)
                snap["ckpt_replicas"].append({
                    "holder": holder,
                    "src": src,
                    "step": newest,
                    "held": len(complete),
                    "files": len(
                        (steps.get(str(newest)) or {}).get("files") or {}
                    ),
                    "rev": manifest.get("rev"),
                    "age_s": (
                        round(time.time() - manifest["ts"], 1)
                        if isinstance(manifest.get("ts"), (int, float))
                        else None
                    ),
                })
    except Exception:  # noqa: BLE001 — a partial snapshot still renders
        pass
    # -- store shard topology: one row per shard member, straight from
    # the replicated shard map + each member's repl_status probe (works
    # with zero obs endpoints: the store control plane self-reports)
    try:
        from edl_tpu_torch.store import replica as replica_mod
        from edl_tpu_torch.store import shard as shard_mod

        rows, _rev = client.range(shard_mod.SHARDS_PREFIX)
        shard_map = shard_mod.parse_shard_rows(rows)
        if not shard_map:
            # unsharded deployment: synthesize the single implicit shard
            # from the endpoint keyspace so the panel renders either way
            ep_rows, _rev = client.range(replica_mod.ENDPOINTS_PREFIX)
            eps = replica_mod.parse_endpoint_rows(ep_rows)
            shard_map = [("store", eps)] if eps else []
        for name, endpoints in shard_map:
            for endpoint in endpoints:
                status = replica_mod.probe_status(endpoint, timeout=1.0) or {}
                # standby-served reads arrive as a cumulative counter;
                # the dashboard wants a rate, so difference successive
                # frames per endpoint (first frame renders "-")
                sreads = status.get("sreads")
                sreads_per_s = None
                if isinstance(sreads, (int, float)):
                    now_m = time.monotonic()
                    prev = _SREADS_PREV.get(endpoint)
                    if (
                        prev is not None
                        and now_m > prev[0]
                        and sreads >= prev[1]
                    ):
                        sreads_per_s = (sreads - prev[1]) / (now_m - prev[0])
                    _SREADS_PREV[endpoint] = (now_m, sreads)
                snap["shards"].append({
                    "shard": name,
                    "endpoint": endpoint,
                    "role": status.get("role", "DOWN"),
                    "epoch": status.get("e"),
                    "rev": status.get("r"),
                    "repl_lag": status.get("lag"),
                    "unacked_b": status.get("unacked"),
                    "sync": status.get("sync"),
                    "subs": status.get("subs"),
                    "readmode": status.get("readmode"),
                    "sreads": sreads,
                    "sreads_per_s": sreads_per_s,
                })
    except Exception:  # noqa: BLE001 — a partial snapshot still renders
        pass
    try:
        raw = client.get("/%s/%s/current" % (job_id, CLUSTER_SERVICE))
        if raw:
            snap["cluster"] = Cluster.from_json(raw)
    except Exception:  # noqa: BLE001 — a partial snapshot still renders
        pass
    def _probe(item):
        name, info = item
        row = {"name": name, "endpoint": info.get("endpoint", ""), "up": False,
               "uptime_s": None, "stats": {}}
        try:
            health = obs_http.fetch_healthz(row["endpoint"], timeout=1.0)
            row["up"] = health.get("status") in ("ok", "degraded")
            row["uptime_s"] = health.get("uptime_s")
            metrics = obs_http.fetch_metrics(row["endpoint"], timeout=1.0)
            for metric, label in _INTERESTING:
                series = metrics.get(metric)
                if series:
                    if label in ("goodput%", "mfu%"):
                        # ratios, not counts: render as percent
                        row["stats"][label] = round(
                            100.0 * max(series.values()), 1
                        )
                    elif label == "hbm_gb":
                        row["stats"][label] = round(
                            max(series.values()) / 1e9, 2
                        )
                    else:
                        row["stats"][label] = sum(series.values())
            # restore-source attribution: which tier recoveries actually
            # came from (the CKPT panel sums these across endpoints)
            series = metrics.get("edl_ckpt_restores_total")
            if series:
                import re as _re

                tiers = {}
                for labels, value in series.items():
                    m = _re.search(r'tier="([^"]+)"', labels)
                    tier = m.group(1) if m else "untiered"
                    tiers[tier] = tiers.get(tier, 0.0) + value
                row["ckpt_restores"] = tiers
            # autoscale attribution: drains this launcher executed on the
            # scaler's orders (the SCHEDULER panel sums these)
            series = metrics.get("edl_launch_drains_total")
            if series:
                n = sum(
                    v for labels, v in series.items()
                    if 'cause="autoscale"' in labels
                )
                if n:
                    row["autoscale_drains"] = n
            # memory plane: runtime high-water vs the compile-time plan
            # (the MEM panel renders one row per training endpoint)
            mem = {}
            for metric, key in (
                ("edl_device_hbm_peak_bytes", "peak_b"),
                ("edl_device_hbm_utilization_ratio", "util"),
                ("edl_device_hbm_fragmentation_ratio", "frag"),
                ("edl_mem_census_live_bytes", "census_b"),
                ("edl_mem_census_live_buffers", "census_n"),
                ("edl_train_hbm_plan_accuracy_pct", "plan_acc"),
                ("edl_train_oom_total", "oom"),
                ("edl_train_donation_dropped_total", "donate_drop"),
                ("edl_scale_mem_unfit_total", "mem_unfit"),
            ):
                series = metrics.get(metric)
                if series:
                    mem[key] = max(series.values())
            if mem:
                row["mem"] = mem
            # straggler forensics: p50/p95 of the watchdog's sampled
            # heartbeat ages (a histogram since the goodput PR, so a
            # transient stall is visible after the fact)
            for q, label in ((0.5, "hb_p50"), (0.95, "hb_p95")):
                v = histogram_quantile(
                    metrics, "edl_train_step_heartbeat_age_seconds", q
                )
                if v is not None:
                    row["stats"][label] = round(v, 3)
            # serving resilience plane: teacher-side admission state
            # (port-labelled gauges + the shed counter) and client-side
            # hedge/breaker counters (the SERVE panel aggregates these)
            import re as _re

            def _by_port(metric):
                out = {}
                for labels, v in (metrics.get(metric) or {}).items():
                    m = _re.search(r'port="([^"]+)"', labels)
                    if m is None:
                        # a counter's bare zero-sample (no increments
                        # yet) carries no per-teacher information
                        continue
                    out[m.group(1)] = out.get(m.group(1), 0.0) + v
                return out

            teachers: Dict[str, Dict] = {}
            for metric, key in (
                ("edl_distill_serve_queue_depth", "qdepth"),
                ("edl_distill_serve_est_wait_ms", "wait_ms"),
                ("edl_distill_shed_total", "shed"),
            ):
                for port, v in _by_port(metric).items():
                    teachers.setdefault(port, {})[key] = v
            for port, t in teachers.items():
                if "shed" in t:
                    t["shed_per_s"] = _rate(
                        _SHED_PREV, (row["endpoint"], port), t["shed"]
                    )
            if teachers:
                row["serve_teachers"] = teachers
            resil = {}
            for metric, key in (
                ("edl_distill_hedges_total", "hedges"),
                ("edl_distill_hedge_wins_total", "hedge_wins"),
                ("edl_distill_retry_denied_total", "retry_denied"),
            ):
                series = metrics.get(metric)
                if series:
                    resil[key] = sum(series.values())
            if "hedges" in resil:
                resil["hedge_per_s"] = _rate(
                    _HEDGE_PREV, row["endpoint"], resil["hedges"]
                )
            if resil:
                row["serve_resilience"] = resil
            series = metrics.get("edl_distill_breaker_open")
            if series:
                opened = []
                for labels, v in series.items():
                    m = _re.search(r'teacher="([^"]+)"', labels)
                    if v >= 1.0 and m:
                        opened.append(m.group(1))
                row["breakers_open"] = sorted(opened)
            # server-side RPC tail latency, per method (the tracing
            # plane's edl_rpc_server_seconds histograms): which store/
            # dispatcher/teacher method is slow, straight from /metrics
            buckets = metrics.get("edl_rpc_server_seconds_bucket")
            if buckets:
                import re as _re

                methods = sorted({
                    m.group(1)
                    for m in (
                        _re.search(r'method="([^"]+)"', k) for k in buckets
                    )
                    if m
                })
                rpc = {}
                for meth in methods:
                    v = quantile_from_grid(
                        bucket_grid(buckets, 'method="%s"' % meth), 0.95
                    )
                    if v is not None:
                        rpc[meth] = round(v, 4)
                if rpc:
                    row["rpc_p95"] = rpc
        except Exception:  # noqa: BLE001 — dead endpoint = shown dead
            pass
        return row

    # concurrent probes: stale registrations of departed pods are
    # permanent keys, and serial 1s-timeout probes would make each
    # refresh degrade linearly with every past downsize
    items = sorted(obs_http.discover_endpoints(client, job_id).items())
    if items:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(16, len(items))) as pool:
            snap["endpoints"] = list(pool.map(_probe, items))
    return snap


def current_stage(snap: Dict) -> str:
    cluster = snap.get("cluster")
    if cluster is not None:
        return cluster.stage
    stages = snap.get("stages") or {}
    if stages:
        return max(stages, key=lambda s: stages[s].get("ts", 0))
    return ""


def render(snap: Dict) -> str:
    """The dashboard as plain text (one frame)."""
    now = snap["ts"]
    lines: List[str] = []
    cluster = snap.get("cluster")
    stage = current_stage(snap)
    head = "edl-top  job=%s" % snap["job"]
    if cluster is not None:
        head += "  stage=%s  world=%d  pods=%d" % (
            stage[:8], cluster.world_size, cluster.num_pods
        )
    elif stage:
        head += "  stage=%s" % stage[:8]
    head += "  %s" % time.strftime("%H:%M:%S", time.localtime(now))
    lines.append(head)
    if snap.get("dropped"):
        lines.append(
            "!! telemetry keyspace has %d malformed entries (corrupt run?)"
            % snap["dropped"]
        )

    # -- active alerts: the monitor plane's verdicts -------------------------
    alerts = snap.get("alerts") or {}
    firing = sorted(
        (a for a in alerts.values() if a.get("state") == "firing"),
        key=lambda a: (a.get("severity") != "critical", a.get("rule", "")),
    )
    if firing:
        lines.append("")
        lines.append("ALERTS (%d firing)" % len(firing))
        for a in firing:
            targets = ",".join(
                str(e.get("target", "?")) for e in (a.get("evidence") or [])[:3]
            )
            since = a.get("since")
            lines.append(
                "  !! %-22s %-8s for %-8s value=%-10s %s" % (
                    a.get("rule", "?"),
                    a.get("severity", "?"),
                    _fmt_age(now - since if isinstance(since, (int, float)) else None),
                    ("%g" % a["value"]) if isinstance(a.get("value"), (int, float))
                    else "-",
                    targets,
                )
            )
    elif alerts:
        lines.append("")
        lines.append(
            "ALERTS none firing (%d resolved: %s)"
            % (len(alerts), ", ".join(sorted(alerts)))
        )

    # -- workers: steady-state meters of the current stage ------------------
    meters = (snap.get("metrics") or {}).get(stage, {})
    first_steps = ((snap.get("events") or {}).get(stage, {})).get("first_step", {})
    lines.append("")
    lines.append("WORKERS (stage %s)" % (stage[:8] or "-"))
    lines.append(
        "  %-8s %10s %8s %7s %7s %10s" % (
            "worker", "samples/s", "steps", "batch", "world", "heartbeat"
        )
    )
    if meters:
        def _rank(w: str) -> int:
            try:
                return int(w.lstrip("w"))
            except ValueError:
                return 1 << 30

        for worker in sorted(meters, key=_rank):
            m = meters[worker]
            age = now - m["t1"] if isinstance(m.get("t1"), (int, float)) else None
            lines.append(
                "  %-8s %10s %8s %7s %7s %10s" % (
                    worker,
                    "%.1f" % m["sps"] if "sps" in m else "-",
                    m.get("steps", "-"),
                    m.get("batch", "-"),
                    m.get("world", "-"),
                    _fmt_age(age),
                )
            )
    elif first_steps:
        for worker in sorted(first_steps):
            lines.append(
                "  %-8s %10s %8s %7s %7s %10s"
                % (worker, "(warmup)", "-", "-", "-",
                   _fmt_age(now - first_steps[worker]))
            )
    else:
        lines.append("  (no worker meters published yet)")

    # -- transitions: downtime decomposition of past resizes -----------------
    events = snap.get("events") or {}
    stage_info = snap.get("stages") or {}
    published = sorted(
        (
            (min(evs["published"].values()), s)
            for s, evs in events.items()
            if "published" in evs
        ),
    )
    if len(published) >= 2:
        lines.append("")
        lines.append("TRANSITIONS")
        for (_, prev), (pub_ts, cur) in zip(published, published[1:]):
            evs = events[cur]
            drain = min(evs["drain"].values()) if "drain" in evs else None
            first = max(evs["first_step"].values()) if "first_step" in evs else None
            down = "%.2fs" % (first - drain) if drain and first else "(in flight)"
            lines.append(
                "  %s -> %s  world %s -> %s  downtime %s" % (
                    prev[:8], cur[:8],
                    stage_info.get(prev, {}).get("world", "?"),
                    stage_info.get(cur, {}).get("world", "?"),
                    down,
                )
            )

    # -- scheduler: the scale plane's target vs what's actually running ------
    scale = snap.get("scale") or {}
    target = scale.get("target")
    decision = scale.get("decision")
    if target or decision:
        autoscale_drains = sum(
            row.get("autoscale_drains", 0) for row in snap.get("endpoints") or []
        )
        lines.append("")
        lines.append("SCHEDULER (scale plane)")
        actual = cluster.num_pods if cluster is not None else None
        if target:
            pods = target.get("pods")
            drift = (
                ""
                if actual is None or pods == actual
                else "  (reconciling: actual %s)" % actual
            )
            lines.append(
                "  target  pods=%-3s seq=%-4s cause=%s%s" % (
                    pods if pods is not None else "-",
                    target.get("seq", "-"),
                    target.get("cause", "-"),
                    drift,
                )
            )
        if decision:
            ts = decision.get("ts")
            lines.append(
                "  last    %-8s world %s -> %s  score=%-8s %s  (%s ago)" % (
                    decision.get("kind", "?"),
                    decision.get("world", "-"),
                    decision.get("pods", "-"),
                    (
                        "%.2f" % decision["score"]
                        if isinstance(decision.get("score"), (int, float))
                        else "-"
                    ),
                    decision.get("cause", ""),
                    _fmt_age(
                        now - ts if isinstance(ts, (int, float)) else None
                    ),
                )
            )
        if autoscale_drains:
            lines.append("  preemptions: %d autoscale drain(s)" % autoscale_drains)

    # -- memory plane: compile-time plans vs runtime high-water --------------
    mem_plans = snap.get("mem_plans") or {}
    mem_rows = [
        r for r in snap.get("endpoints") or [] if r.get("mem")
    ]
    if mem_plans or mem_rows:
        def _gb(v):
            if not (isinstance(v, (int, float)) and v > 0):
                return "-"
            for div, unit in ((1e9, "GB"), (1e6, "MB"), (1e3, "KB")):
                if v >= div:
                    return "%.2f%s" % (v / div, unit)
            return "%dB" % v

        def _pct(v):
            return (
                "%.1f%%" % (v * 100.0)
                if isinstance(v, (int, float)) else "-"
            )

        lines.append("")
        lines.append("MEM (compile-time plans / runtime high-water)")
        for w in sorted(mem_plans):
            d = mem_plans[w]
            lines.append(
                "  plan  world=%-3s total=%-9s (arg %s out %s temp %s "
                "code %s alias %s)  limit=%-9s %s" % (
                    w, _gb(d.get("total")), _gb(d.get("argument")),
                    _gb(d.get("output")), _gb(d.get("temp")),
                    _gb(d.get("generated_code")), _gb(d.get("alias")),
                    _gb(d.get("limit")),
                    "fit" if d.get("fits", True) else "UNFIT",
                )
            )
        mem_unfit = sum(r["mem"].get("mem_unfit", 0) for r in mem_rows)
        for r in mem_rows:
            m = r["mem"]
            lines.append(
                "  %-21s peak=%-9s util=%-6s frag=%-6s census=%s/%s "
                "acc=%-6s oom=%d drop=%d" % (
                    r["endpoint"], _gb(m.get("peak_b")),
                    _pct(m.get("util")), _pct(m.get("frag")),
                    _gb(m.get("census_b")),
                    (
                        "%d" % m["census_n"]
                        if isinstance(m.get("census_n"), (int, float))
                        else "-"
                    ),
                    (
                        "%.1f%%" % m["plan_acc"]
                        if isinstance(m.get("plan_acc"), (int, float))
                        else "-"
                    ),
                    int(m.get("oom", 0)), int(m.get("donate_drop", 0)),
                )
            )
        if mem_unfit:
            lines.append(
                "  fit gate: %d mem_unfit refusal(s)" % int(mem_unfit)
            )

    # -- store shards: the control plane's own health, one row per member ----
    shards = snap.get("shards") or []
    if shards:
        lines.append("")
        lines.append(
            "STORE SHARDS (epoch / repl lag / semi-sync window / read serving)"
        )
        lines.append(
            "  %-10s %-21s %-8s %6s %9s %9s %10s %5s %-8s %9s" % (
                "shard", "endpoint", "role", "epoch", "rev",
                "repl_lag", "unacked_b", "sync", "rmode", "sreads/s",
            )
        )
        for row in shards:
            def _n(v):
                return "-" if v is None else str(v)

            rate = row.get("sreads_per_s")
            lines.append(
                "  %-10s %-21s %-8s %6s %9s %9s %10s %5s %-8s %9s" % (
                    row["shard"], row["endpoint"], row["role"],
                    _n(row["epoch"]), _n(row["rev"]), _n(row["repl_lag"]),
                    _n(row["unacked_b"]),
                    "on" if row.get("sync") else
                    ("off" if row.get("sync") is not None else "-"),
                    _n(row.get("readmode")),
                    "%.1f" % rate if isinstance(rate, (int, float)) else "-",
                )
            )

    # -- checkpoint tiers: replica freshness + restore sources ---------------
    replicas = snap.get("ckpt_replicas") or []
    restore_tiers: Dict[str, float] = {}
    for row in snap.get("endpoints") or []:
        for tier, v in (row.get("ckpt_restores") or {}).items():
            restore_tiers[tier] = restore_tiers.get(tier, 0.0) + v
    if replicas or restore_tiers:
        lines.append("")
        lines.append("CKPT (peer replicas / restore tiers)")
        if restore_tiers:
            lines.append(
                "  restores: %s" % "  ".join(
                    "%s=%d" % (t, v) for t, v in sorted(restore_tiers.items())
                )
            )
        if replicas:
            lines.append(
                "  %-10s %-10s %7s %5s %6s %5s %8s" % (
                    "holder", "src", "step", "held", "files", "rev", "age",
                )
            )
            for row in replicas:
                lines.append(
                    "  %-10s %-10s %7s %5s %6s %5s %8s" % (
                        row["holder"][:8], row["src"][:8], row["step"],
                        row["held"], row["files"],
                        row.get("rev") if row.get("rev") is not None else "-",
                        _fmt_age(row.get("age_s")),
                    )
                )
        else:
            lines.append("  (no replica manifests published)")

    # -- serving plane: per-teacher admission + client resilience ------------
    serve_rows = []
    resil_agg: Dict[str, float] = {}
    breakers_open: List[str] = []
    any_breaker_series = False
    for row in snap.get("endpoints") or []:
        for port, t in sorted((row.get("serve_teachers") or {}).items()):
            serve_rows.append((row["name"], port, t))
        for k, v in (row.get("serve_resilience") or {}).items():
            if v is not None:
                resil_agg[k] = resil_agg.get(k, 0.0) + v
        if row.get("breakers_open") is not None:
            any_breaker_series = True
            breakers_open.extend(row["breakers_open"])
    if serve_rows or resil_agg or any_breaker_series:
        lines.append("")
        lines.append("SERVE (teacher admission / client resilience)")
        if serve_rows:
            lines.append(
                "  %-22s %6s %7s %9s %8s %10s" % (
                    "teacher", "port", "qdepth", "wait_ms", "shed/s",
                    "shed_total",
                )
            )
            for name, port, t in serve_rows:
                def _n(v, fmt="%g"):
                    return fmt % v if isinstance(v, (int, float)) else "-"

                lines.append(
                    "  %-22s %6s %7s %9s %8s %10s" % (
                        name, port,
                        _n(t.get("qdepth"), "%d"),
                        _n(t.get("wait_ms"), "%.1f"),
                        _n(t.get("shed_per_s"), "%.2f"),
                        _n(t.get("shed"), "%d"),
                    )
                )
        if resil_agg:
            lines.append(
                "  clients: hedges=%d (%s/s) wins=%d retry_denied=%d" % (
                    resil_agg.get("hedges", 0),
                    (
                        "%.2f" % resil_agg["hedge_per_s"]
                        if "hedge_per_s" in resil_agg else "-"
                    ),
                    resil_agg.get("hedge_wins", 0),
                    resil_agg.get("retry_denied", 0),
                )
            )
        if any_breaker_series:
            uniq = sorted(set(breakers_open))
            lines.append(
                "  breakers: %s" % (
                    "OPEN %s" % ", ".join(uniq) if uniq else "all closed"
                )
            )

    # -- obs endpoints -------------------------------------------------------
    lines.append("")
    lines.append("ENDPOINTS (/metrics)")
    if snap["endpoints"]:
        for row in snap["endpoints"]:
            stats = "  ".join(
                # counters stay exact integers at any magnitude (%g would
                # go scientific past 6 digits); the ratio and quantile
                # columns keep their decimals
                "%s=%s" % (
                    k,
                    "%d" % v if float(v).is_integer() and abs(v) < 1e15
                    else "%g" % v,
                )
                for k, v in sorted(row["stats"].items())
            )
            lines.append(
                "  %-22s %-21s %-5s up=%-8s %s" % (
                    row["name"], row["endpoint"],
                    "ok" if row["up"] else "DOWN",
                    _fmt_age(row["uptime_s"]), stats,
                )
            )
            rpc = row.get("rpc_p95")
            if rpc:
                # slowest methods first: the per-method server-side tail
                # is the sharding/batching signal ROADMAP item 2 needs
                worst = sorted(rpc.items(), key=lambda kv: -kv[1])[:6]
                lines.append(
                    "  %-22s rpc p95: %s" % (
                        "",
                        "  ".join(
                            "%s=%.1fms" % (m, v * 1e3) for m, v in worst
                        ),
                    )
                )
    else:
        lines.append("  (none registered; set EDL_OBS_PORT on the job)")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl-top", description="live dashboard for an elastic edl_tpu_torch job"
    )
    parser.add_argument("--store", required=True, help="store endpoint ip:port")
    parser.add_argument("--job", required=True, help="job id")
    parser.add_argument("--once", action="store_true", help="print one frame and exit")
    parser.add_argument("--interval", type=float, default=2.0)
    parser.add_argument(
        "--json", action="store_true",
        help="emit the raw snapshot as JSON instead of the table (--once only)",
    )
    args = parser.parse_args(argv)

    if not args.once:
        # the dashboard surfaces drop counts itself (the !! banner); the
        # summary warning collect() logs each refresh would interleave
        # with the ANSI-redrawn screen
        import logging

        logging.getLogger("edl_tpu_torch.telemetry").setLevel(logging.ERROR)

    client = connect_store(args.store, timeout=5.0)
    try:
        while True:
            snap = gather(client, args.job)
            if args.json:
                snap = dict(snap)
                if snap["cluster"] is not None:
                    snap["cluster"] = json.loads(snap["cluster"].to_json())
                print(json.dumps(snap))
            else:
                frame = render(snap)
                if not args.once:
                    sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
                print(frame)
                sys.stdout.flush()
            if args.once:
                return 0
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
