"""edl-profile: request, collect and summarize on-device profiler captures.

The requester half of the profiling plane (`edl_tpu_torch/obs/profile.py`):
every worker of an elastic job watches the store's ``profile/request``
key and answers it with one bounded ``torch.profiler`` trace window plus a
published ``profile/result/{pod}`` summary (artifact path, steps
captured, step ms, windowed MFU, memory in use). This tool writes the
request, waits for every pod of the published cluster to answer, and
prints the summary table — the operator's one command from "the monitor
fired" to "here is the on-device profile that explains why".

Usage::

    python -m edl_tpu_torch.tools.edl_profile --store HOST:PORT --job ID --request
    python -m edl_tpu_torch.tools.edl_profile --store ... --job ... --request \\
        --steps 10 --timeout 60 --json
    python -m edl_tpu_torch.tools.edl_profile --store ... --job ... --once
        # read back what's published
    python -m edl_tpu_torch.tools.edl_profile --local [--device cpu]
        # storeless self-drill: telemetry-gauge sanity + one capture
        # window on the card (the suite's profile_plane step)

``--once`` reads the currently published results without requesting a
new capture. ``--local`` needs no store at all: it runs a small matmul
step (n = 512 on the card, 128 on the CPU) on ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``), arms the live
telemetry from the FLOP counter's cost of one step
(``obs.profile.step_cost``), runs one ``torch.profiler`` window through
the real ``CaptureController`` and prints one JSON line with the gauge
values and the artifact; it exits 1 when no trace file was written.

The port's copy of ``tools/edl_profile.py``; ``--local`` is rewritten in
torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

from edl_tpu_torch.obs import profile as obs_profile


def _expected_results(client, job_id: str) -> Optional[int]:
    """How many result keys a full answer means: one per worker of the
    published cluster (None when no cluster is published)."""
    from edl_tpu_torch.cluster.contract import CLUSTER_SERVICE
    from edl_tpu_torch.cluster.model import Cluster

    try:
        raw = client.get("/%s/%s/current" % (job_id, CLUSTER_SERVICE))
        if raw:
            return Cluster.from_json(raw).world_size
    except Exception:  # noqa: BLE001 — fall back to the stabilize heuristic
        pass
    return None


def _wait_results(
    client, job_id: str, request_id: str, timeout: float
) -> Dict[str, Dict]:
    """Poll until every expected worker answered (or the result set has
    stopped growing, or the timeout lapses). Partial results are still
    returned — a wedged worker must not hide the healthy ones' answers."""
    deadline = time.time() + timeout
    expected = _expected_results(client, job_id)
    results: Dict[str, Dict] = {}
    stable_since: Optional[float] = None
    while time.time() < deadline:
        results = obs_profile.read_results(client, job_id, request_id)
        if expected is not None and len(results) >= expected:
            return results
        if results:
            if stable_since is None or len(results) != stable_since[1]:
                stable_since = (time.time(), len(results))
            elif expected is None and time.time() - stable_since[0] > 3.0:
                return results  # no cluster published: settle for stable
        time.sleep(0.5)
    return results


def _render(results: Dict[str, Dict]) -> str:
    lines = [
        "%-16s %6s %10s %8s %10s  %s"
        % ("worker", "steps", "step_ms", "mfu", "hbm_gb", "artifact")
    ]
    for name in sorted(results):
        doc = results[name]
        hbm = doc.get("hbm_bytes_in_use")
        lines.append(
            "%-16s %6s %10s %8s %10s  %s"
            % (
                name,
                doc.get("steps", "-"),
                "%.2f" % doc["step_ms"] if "step_ms" in doc else "-",
                "%.4f" % doc["mfu"] if isinstance(doc.get("mfu"), float) else "-",
                "%.2f" % (hbm / 1e9) if isinstance(hbm, (int, float)) else "-",
                doc.get("dir", "-"),
            )
        )
    return "\n".join(lines)


def _local_drill(steps: int, out_dir: Optional[str], device: str) -> Dict:
    """Storeless end-to-end sanity on ``device``: cost extraction,
    windowed-MFU/roofline gauges, one capture window via the real
    controller. Returns the JSON-able summary."""
    import tempfile

    import torch

    from edl_tpu_torch.obs import metrics as obs_metrics
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    n = 512 if on_gpu else 128

    def toy_step(w, x):
        # matmul-heavy enough that the trace window contains real device
        # work; the "loss" dependency chains every step
        h = torch.tanh(x @ w)
        return w - 1e-3 * (x.T @ h), h.sum()

    w = torch.zeros((n, n), dtype=torch.float32, device=dev)
    x = torch.full((n, n), 0.01, dtype=torch.float32, device=dev)
    cost, _ = obs_profile.step_cost(toy_step, w, x)
    telemetry = obs_profile.StepTelemetry()
    roof = telemetry.set_cost(cost, device=dev)
    sync = torch.cuda.synchronize if on_gpu else None

    class _Env:
        job_id = ""
        pod_id = "local"
        rank_in_pod = 0
        global_rank = 0
        store_endpoint = ""

    # a FRESH root per run: a reused directory would let round N-1's
    # artifacts mask a silently failed capture in round N (the suite
    # step's pass/fail signal is "this run produced trace files")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        trace_root = tempfile.mkdtemp(prefix="run.", dir=out_dir)
    else:
        trace_root = tempfile.mkdtemp(prefix="edl_profile_local.")
    controller = obs_profile.CaptureController(_Env(), telemetry=telemetry)
    controller.arm_local(trace_root, start_after=2, steps=steps)
    loss = None
    try:
        for _ in range(steps + 4):
            w, loss = toy_step(w, x)
            loss = float(loss)  # an honest per-step sync
            telemetry.observe_step()
            controller.on_step(sync)
    finally:
        controller.close()
    trace_files = []
    for dirpath, _dirs, files in os.walk(trace_root):
        trace_files.extend(os.path.join(dirpath, f) for f in files)
    reg = obs_metrics.default_registry()
    snap = telemetry.snapshot()
    out = {
        "metric": "profile_plane_selftest",
        "value": round(snap.get("mfu", 0.0), 4),
        "unit": "mfu",
        "device": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
        "platform": dev.type,
        "step_flops": snap.get("step_flops"),
        "flops_total": reg.get("edl_train_flops_total").value(),
        "captured_steps": steps,
        "trace_files": len(trace_files),
        "trace_dir": trace_root,
        "loss": loss,
    }
    out.update(roof)
    hbm = telemetry.hbm_in_use()
    if hbm is not None:
        out["hbm_bytes_in_use"] = hbm
    telemetry.close()
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.edl_profile",
        description="request/collect on-device profiler captures from a "
        "live elastic job (worker side: edl_tpu_torch/obs/profile.py)",
    )
    parser.add_argument("--store", help="store endpoint(s) ip:port[,ip:port]")
    parser.add_argument("--job", help="job id")
    parser.add_argument(
        "--request", action="store_true",
        help="publish a capture request and wait for the results",
    )
    parser.add_argument(
        "--once", action="store_true",
        help="read back currently published results; no new request",
    )
    parser.add_argument(
        "--steps", type=int, default=5, help="capture window length in steps"
    )
    parser.add_argument(
        "--timeout", type=float, default=30.0,
        help="seconds to wait for results after a request",
    )
    parser.add_argument(
        "--out", default=None,
        help="artifact root on the WORKERS' filesystem (default: their "
        "EDL_PROFILE_OUT or tmp)",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON")
    parser.add_argument(
        "--local", action="store_true",
        help="storeless self-drill on --device (the suite's profile_plane "
        "step)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="--local's device: cuda (default; raises without a card) or cpu",
    )
    args = parser.parse_args(argv)

    if args.local:
        doc = _local_drill(args.steps, args.out, args.device)
        print(json.dumps(doc))
        return 0 if doc["trace_files"] else 1

    if not args.store or not args.job:
        parser.error("--store and --job are required (or use --local)")
    if not args.request and not args.once:
        parser.error("pick one of --request / --once / --local")

    from edl_tpu_torch.store.client import StoreClient

    client = StoreClient(args.store, timeout=5.0)
    try:
        if args.once:
            results = obs_profile.read_results(client, args.job)
        else:
            rid = request_ts = None
            rid = obs_profile.request_capture(
                client, args.job, steps=args.steps, out_dir=args.out
            )
            request_ts = time.time()
            print(
                "capture %s requested (%d steps); waiting up to %.0fs"
                % (rid, args.steps, args.timeout),
                file=sys.stderr,
            )
            results = _wait_results(client, args.job, rid, args.timeout)
            if results:
                print(
                    "%d result(s) in %.1fs" % (
                        len(results), time.time() - request_ts
                    ),
                    file=sys.stderr,
                )
        if args.json:
            print(json.dumps(results))
        elif results:
            print(_render(results))
        else:
            print("no capture results published", file=sys.stderr)
        return 0 if results or args.once else 1
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
