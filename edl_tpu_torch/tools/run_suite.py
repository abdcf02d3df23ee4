"""One-shot H100 measurement suite: run every on-card benchmark of the
port in one command, committing nothing — artifacts land in
``bench_results/`` (or ``--results``) for review.

The port of ``tools/run_tpu_suite.py``: probe the card (bounded), then
run the series in priority order with per-step timeouts, writing
``<results>/<name>_cuda_r{round}.json`` after each step so a step that
fails or times out keeps everything measured before it. Every step's
result is archived as a run bundle with ``backend="cuda"``
(``obs/archive.py``), and the round closes with the regression gate,
``python -m edl_tpu_torch.tools.edl_report --check --json``.

Usage::

    python -m edl_tpu_torch.tools.run_suite --round 1 [--skip bench ...]

Steps (priority order):

0. profile_plane       ``edl_profile --local``: the profiling plane on the
                       card — cost-model gauges (MFU, memory from the
                       caching allocator) and one ``torch.profiler``
                       window through the real ``CaptureController``
1. bench               the headline (sweep + remat A/B + 3 trials)
2. numerics_overhead   the numerics probe's cost (``bench
                       --numerics-overhead``), held under the 2 % bar
3. lm_bench            TransformerLM tokens/s + MFU at its own default
                       batch, with the ``--remat none`` and
                       ``--kv_heads 4`` variants
4. distill_retention, distill_retention_echo
                       service distillation against pure training:
                       ResNet50_vd teachers behind the serving stack with
                       one stopped mid-run, then the echo teacher alone
                       (the pipeline's own cost, 3 trials)
5. resize_bench, resize_bench_aot_control
                       the 1,r,r restart drill of ResNet50_vd workers
                       (standby shells on), then the same schedule with
                       the ladder and the kernel-cache exchange off
6. colocated_distill   ResNeXt101_32x16d teacher and ResNet50_vd student
                       in one step on the card
7. decode_bench        KV-cache decode tokens/s
8. grad_corrupt_drill, autoscale_churn_drill, hbm_oom_drill
                       the numerics, scale and memory planes' drills
                       (``chaos_run``, the trainee on the card)
9. serve_slo_bench, serve_slo_churn_drill
                       the serving plane's SLO bench and its churn drill
10. store_consistency_soak
                       the store failover drills, 5 seeds each
11. edl_report --check the closing gate over the archive (``runs/`` or
                       ``EDL_RUN_ARCHIVE``), its verdict kept as
                       ``edl_report_r{N}.json``: a regressed metric turns
                       the suite red

The JAX suite's ``lm_profile`` and ``lm_long_sweep`` steps wait for their
tools' ports. Its ``resize_bench_aot`` step differs from
``resize_bench`` only by XLA's portable cache keys; the port's kernel
libraries are named by their sources, portable between hosts by
construction, so ``resize_bench`` is that step here. Its dispatch-table
steps (``attention_bench --calibrate``, the block sweeps) and
``edl_lint`` have no counterpart here.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "bench_results")
BACKEND = "cuda"
# resize_bench's seconds a schedule entry: a cold ResNet50_vd worker's
# start on the card (imports, the model, cuDNN's first calls) and a
# steady stretch after it
RESIZE_INTERVAL_S = 60


def probe(timeout: float = 90.0) -> str | None:
    """The card's name, from a child process; None without a card (or
    when the child does not answer in ``timeout`` seconds)."""
    code = ("import torch; print('cuda|' + torch.cuda.get_device_name(0) "
            "if torch.cuda.is_available() else 'cpu|')")
    try:
        out = subprocess.run(
            [sys.executable, "-c", code],
            timeout=timeout, capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired:
        return None
    line = out.stdout.strip()
    if line.startswith("cuda|"):
        return line.split("|", 1)[1].strip()
    return None


def _env(extra_env=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra_env or {})
    return env


def json_lines(stdout: str):
    """A step's JSON output as compact lines: every line that is a JSON
    object, or the whole output when it is one indented document (as
    ``serve_slo`` prints it)."""
    try:
        doc = json.loads(stdout)
    except ValueError:
        doc = None
    if isinstance(doc, dict):
        return [json.dumps(doc)]
    return [l for l in stdout.splitlines() if l.strip().startswith("{")]


def run_step(name, cmd, out_path, timeout, extra_env=None):
    t0 = time.time()
    print("== %s: %s" % (name, " ".join(cmd)), file=sys.stderr)
    try:
        out = subprocess.run(
            cmd, timeout=timeout, capture_output=True, text=True,
            env=_env(extra_env), cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        print("== %s TIMED OUT after %ds" % (name, timeout), file=sys.stderr)
        return False
    lines = json_lines(out.stdout)
    if out.returncode != 0 or not lines:
        print(
            "== %s FAILED rc=%d: %s"
            % (name, out.returncode, (out.stderr or "")[-500:]),
            file=sys.stderr,
        )
        return False
    payload = lines if len(lines) > 1 else lines[-1:]
    with open(out_path, "w") as f:
        f.write("\n".join(payload) + "\n")
    archive_step(name, out_path)
    print(
        "== %s ok in %.0fs -> %s" % (name, time.time() - t0, out_path),
        file=sys.stderr,
    )
    return True


def suite_archive_root():
    from edl_tpu_torch.obs import archive as run_archive

    return run_archive.archive_root(default=os.path.join(REPO, "runs"))


def archive_step(name, out_path, root=None):
    """Every suite step's result JSON becomes an indexed run-archive
    bundle (kind = step name, backend = cuda) under ``root`` (default:
    the suite's archive root), so round-over-round numbers on the card
    trend and gate via edl_report — best-effort: a broken archive never
    fails the measurement."""
    try:
        from edl_tpu_torch.obs import archive as run_archive

        root = root or suite_archive_root()
        if not root:
            return
        docs = []
        with open(out_path) as f:
            for line in f:
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict):
                    docs.append(doc)
        if not docs:
            return
        doc = docs[-1]  # jsonl sweeps: the last row carries the summary
        if doc.get("bundle"):
            return  # the tool self-archived (EDL_RUN_ARCHIVE reached the
            # child): a second bundle of the same run would enter its
            # own baseline and dilute the very regressions the gate hunts
        if not run_archive.rollups_from_bench(doc):
            return  # no comparable scalar: nothing a baseline could gate on
        run_archive.maybe_archive_bench(
            name, doc, job_id=BACKEND, backend=BACKEND, root=root,
            stale=bool(doc.get("stale")),
            excluded=str(doc.get("metric", "")).endswith("_unavailable"),
        )
    except Exception as exc:  # noqa: BLE001
        print("== archive of %s failed: %s" % (name, exc), file=sys.stderr)


def run_report_gate(py, round_no, results):
    """The suite's closing step: ``edl_report --check --json`` over the
    round's archived runs, verdict kept as
    ``<results>/edl_report_r{round}.json``. Returns True when no table
    metric regressed."""
    root = suite_archive_root()
    if not root:
        # EDL_RUN_ARCHIVE=0: nothing was archived this round, and gating
        # on a leftover ./runs from an older experiment would red a
        # round that measured nothing regressed
        print("== edl_report skipped: archiving disabled", file=sys.stderr)
        return True
    out_path = os.path.join(results, "edl_report_r%d.json" % round_no)
    cmd = [py, "-m", "edl_tpu_torch.tools.edl_report", "--check", "--json",
           "--runs", root]
    print("== edl_report: %s" % " ".join(cmd), file=sys.stderr)
    try:
        out = subprocess.run(
            cmd, timeout=300, capture_output=True, text=True,
            env=_env(), cwd=REPO,
        )
    except subprocess.TimeoutExpired:
        print("== edl_report TIMED OUT", file=sys.stderr)
        return False
    lines = json_lines(out.stdout)
    if lines:
        with open(out_path, "w") as f:
            f.write(lines[-1] + "\n")
    if out.returncode != 0:
        print(
            "== edl_report GATE RED rc=%d: %s"
            % (out.returncode, (lines[-1:] or [out.stderr[-500:]])[0]),
            file=sys.stderr,
        )
        return False
    print("== edl_report gate OK -> %s" % out_path, file=sys.stderr)
    return True


def steps(py, r, results):
    """``(name, cmd, out_name, timeout_s, extra_env)`` of every step, in
    order."""
    archive = {"EDL_RUN_ARCHIVE": suite_archive_root() or "0"}

    def tool(name, *args):
        return [py, "-m", "edl_tpu_torch.tools." + name, *args]

    return [
        # the profiling plane first: cheap (~20 toy steps and a bounded
        # trace window), and it proves the live MFU/memory plane works on
        # the card before the long runs
        ("profile_plane",
         tool("edl_profile", "--local", "--out",
              os.path.join(results, "profile_r%d" % r)),
         "profile_plane_cuda_r%d.json" % r, 1200, None),
        # outer timeout sized for bench's worst case: the sweep's child
        # runs x EDL_BENCH_RUN_TIMEOUT each
        ("bench", tool("bench"), "bench_cuda_r%d.json" % r, 10800,
         {"EDL_BENCH_RUN_TIMEOUT": "1000"}),
        # the numerics plane's cost claim: one
        # numerics_probe_overhead_pct record the report gate holds under
        # the 2% bar (obs/regress.py floor)
        ("numerics_overhead", tool("bench", "--numerics-overhead"),
         "numerics_overhead_cuda_r%d.json" % r, 7200,
         {"EDL_BENCH_RUN_TIMEOUT": "1000"}),
        ("lm_bench", tool("lm_bench"), "lm_cuda_r%d.json" % r, 2400, None),
        # activation-strategy A/B at the flagship shape: 'none' skips all
        # recompute
        ("lm_bench_noremat", tool("lm_bench", "--remat", "none"),
         "lm_noremat_cuda_r%d.json" % r, 2400, None),
        # GQA training variant: grouped kernels, kv projections /4
        ("lm_bench_gqa", tool("lm_bench", "--kv_heads", "4"),
         "lm_gqa_cuda_r%d.json" % r, 2400, None),
        # service distillation vs pure training (ResNet50_vd teachers on
        # the card, one stopped mid-run), then the echo teacher: the
        # pipeline's own cost, 3 trials and their spread
        ("distill_retention", tool("distill_retention", "--backend", "torch"),
         "distill_retention_cuda_r%d.json" % r, 900, None),
        ("distill_retention_echo",
         tool("distill_retention", "--backend", "echo", "--trials", "3"),
         "distill_retention_echo_cuda_r%d.json" % r, 900, None),
        # the one-card restart drill (a world > 1 would time-slice the
        # card); an interval holds a cold ResNet50_vd worker's start and
        # a steady stretch after it. Standby shells are on; the control
        # turns the ladder and the kernel-cache exchange off. Both
        # archive their own bundle (kinds resize_bench and
        # resize_bench_noaot)
        ("resize_bench",
         tool("resize_bench", "--schedule", "1,r,r", "--interval",
              str(RESIZE_INTERVAL_S)),
         "resize_cuda_r%d.json" % r, 900, archive),
        ("resize_bench_aot_control",
         tool("resize_bench", "--schedule", "1,r,r", "--interval",
              str(RESIZE_INTERVAL_S), "--no-aot"),
         "resize_aot_control_cuda_r%d.json" % r, 900, archive),
        ("colocated_distill", tool("colocated_distill"),
         "colocated_cuda_r%d.json" % r, 900, None),
        # KV-cache decode: the GQA/MQA bandwidth story in tokens/s
        ("decode_bench", tool("decode_bench"),
         "decode_cuda_r%d.jsonl" % r, 2400, None),
        # the planes' red drills: seeded gradient corruption (nan-detected
        # / loss-spike), the live scaler's grow and shrink (goodput loss
        # vs the offline oracle, decision -> restage latency), an
        # injected out-of-memory error (forensics bundle, oom-detected,
        # restage to completion); chaos_run exits nonzero on any red
        # invariant and archives its own bundle
        ("grad_corrupt_drill",
         tool("chaos_run", "--scenario", "grad-corrupt", "--seed", "0"),
         "grad_corrupt_cuda_r%d.json" % r, 900, archive),
        ("autoscale_churn_drill",
         tool("chaos_run", "--scenario", "autoscale-churn", "--seed", "0"),
         "autoscale_churn_cuda_r%d.json" % r, 900, archive),
        ("hbm_oom_drill",
         tool("chaos_run", "--scenario", "hbm-oom", "--seed", "0"),
         "hbm_oom_cuda_r%d.json" % r, 900, archive),
        # the serving plane: the SLO bench (nominal + overload lanes) and
        # the teacher-churn drill. The bench is archived here, like every
        # step without a bundle of its own (its own archive would file
        # it under its host fleet's "cpu", apart from the suite's runs)
        ("serve_slo_bench",
         tool("serve_slo", "--qps", "60", "--duration", "8", "--teachers",
              "2", "--overload"),
         "serve_slo_cuda_r%d.json" % r, 900, {"EDL_RUN_ARCHIVE": "0"}),
        ("serve_slo_churn_drill",
         tool("chaos_run", "--scenario", "serve-slo-churn", "--seed", "0"),
         "serve_slo_churn_cuda_r%d.json" % r, 900, archive),
        # the store soak: seeded failover and shard-failover drills whose
        # taped histories replay through the consistency checker
        ("store_consistency_soak",
         tool("chaos_run", "--scenario",
              "store-failover,store-shard-failover", "--repeat", "5",
              "--seed", "0"),
         "store_consistency_cuda_r%d.json" % r, 1800, archive),
    ]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.run_suite",
        description=__doc__.split("\n")[0])
    p.add_argument("--round", type=int, default=1)
    p.add_argument("--skip", nargs="*", default=[])
    p.add_argument("--probe_budget", type=float, default=120.0)
    p.add_argument("--results", default=RESULTS,
                   help="where each step's JSON goes (default "
                   "bench_results/)")
    args = p.parse_args(argv)

    kind = probe(args.probe_budget)
    if kind is None:
        print(json.dumps({
            "metric": "gpu_suite", "value": 0, "unit": "steps",
            "detail": "no CUDA device; nothing measured",
        }))
        return 1
    print("== card up: %s" % kind, file=sys.stderr)
    os.makedirs(args.results, exist_ok=True)
    r = args.round
    py = sys.executable
    series = steps(py, r, args.results)
    done = 0
    for name, cmd, out_name, timeout, extra in series:
        if name in args.skip:
            continue
        if run_step(name, cmd, os.path.join(args.results, out_name), timeout,
                    extra):
            done += 1
    # the regression sentinel closes the round: every step above indexed
    # its result in the run archive; a regressed table metric turns the
    # whole suite red (the verdict itself is kept for the round)
    gate_ok = True
    if "edl_report" not in args.skip:
        gate_ok = run_report_gate(py, r, args.results)
    print(json.dumps({
        "metric": "gpu_suite", "value": done, "unit": "steps",
        "device": kind,
        "of": sum(1 for s in series if s[0] not in args.skip),
        "report_gate_ok": gate_ok,
    }))
    return 0 if done and gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
