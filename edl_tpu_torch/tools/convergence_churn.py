"""Convergence-under-churn benchmark: does elasticity cost accuracy?

The port of ``tools/convergence_churn.py``. The reference's elasticity
claim is accuracy-shaped: ResNet50/ImageNet at batch 1024 with job-server
churn every 900 s reaches acc1 75.5 vs 76.4 static (reference
README.md:144-147) — convergence survives resizes. This is the
scaled-down, no-egress analogue, trained twice through the FULL elastic
stack of the port (store + launcher + per-epoch checkpoints +
stop-resume):

1. **static**: a fixed 2-pod world, no churn;
2. **churn**: the same job under a ``ResizeHarness`` schedule with
   SIGKILL shrinks and cold grows landing mid-training.

Two workloads: ``digits`` (``convergence_worker.py``: an MLP on the
digits scans under ``ElasticTrainer``, the global batch fixed across
worlds, so only stop-resume mechanics can move the result) and ``lm``
(``convergence_lm_worker.py``: a byte-level TransformerLM through the
elastic data layer, where churn really changes which rows share a global
batch; on the card its attention runs K1-K3). The ``lm`` workload checks
that churn saw at least 3 cluster generations and a different batch
stream than static, and sums each run's kernel launches (``launches``,
by kernel, from every incarnation's last report).

Prints ONE JSON line, the JAX tool's keys::

    {"metric": "convergence_churn_gap", "value": <|acc_s - acc_c|*100 pp>,
     "unit": "pp", "static": {...}, "churn": {...}, ...}

``target_pp`` is the JAX round's 0.3-point bar for the gap, kept as the
JAX tool reports it. With ``EDL_RUN_ARCHIVE`` set the record is archived
(kind ``convergence_churn``, backend = the device).

    python -m edl_tpu_torch.tools.convergence_churn --workload lm \\
        --epochs 3 --churn_schedule 2,1,2 --interval 15
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

from edl_tpu_torch.harness.resize import ResizeHarness
from edl_tpu_torch.store.server import StoreServer

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "convergence_worker.py")
LM_WORKER = os.path.join(HERE, "convergence_lm_worker.py")
REPO = os.path.dirname(os.path.dirname(HERE))
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def build_text_corpus(data_dir, seq=48, parts=6, heldout_lines=600,
                      max_bytes=300_000):
    """Deterministic real-text char-LM corpus from the repo's own docs:
    concatenated, reflowed into fixed ``seq+1``-byte lines (so every
    record is a full training window, no padding), split into ``parts``
    dispatcher files + one held-out eval file. The same bytes as the JAX
    tool's: the same documents, then the JAX package's ``.py`` sources,
    read as text."""
    sources = [
        "SURVEY.md", "README.md", "DESIGN.md", "PARITY.md",
        "PAPERS.md", "SNIPPETS.md",
    ]
    paths = [os.path.join(REPO, name) for name in sources]
    # the JAX package's sources: several hundred KB of real structured
    # text, deterministic, no egress
    for root, _dirs, files in sorted(os.walk(os.path.join(REPO, "edl_tpu"))):
        for name in sorted(files):
            if name.endswith(".py"):
                paths.append(os.path.join(root, name))
    blob = b""
    for path in paths:
        if os.path.exists(path):
            with open(path, "rb") as f:
                blob += f.read() + b"\n"
    # printable ASCII only (newlines become spaces: the dispatcher's
    # TxtFileSplitter is line-based, so records must not CONTAIN \n)
    blob = bytes(b if b != 10 else 32 for b in blob if 32 <= b < 127 or b == 10)
    blob = blob[:max_bytes]  # keep the run inside its time budget
    width = seq + 1
    lines = [
        blob[i : i + width]
        for i in range(0, len(blob) - width, width)
    ]
    assert len(lines) > heldout_lines + parts * 50, (
        "corpus too small: %d lines" % len(lines)
    )
    train, heldout = lines[:-heldout_lines], lines[-heldout_lines:]
    os.makedirs(data_dir, exist_ok=True)
    per = (len(train) + parts - 1) // parts
    for p in range(parts):
        with open(os.path.join(data_dir, "part-%02d.txt" % p), "wb") as f:
            f.write(b"\n".join(train[p * per : (p + 1) * per]))
    with open(os.path.join(data_dir, "heldout.txt"), "wb") as f:
        f.write(b"\n".join(heldout))
    return len(train), len(heldout)


def _read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def run_once(tag, schedule, interval, epochs, pause, ttl=1.5, timeout=900.0,
             workload="digits", data_dir=None, device="cuda"):
    work = tempfile.mkdtemp(prefix="edl-conv-%s-" % tag)
    out_dir = os.path.join(work, "out")
    os.makedirs(out_dir)
    store = StoreServer(port=0).start()
    ok = False
    extra_env = {
        "EDL_DEVICES_PER_PROC": "1",
        # the tool archives its record; the harness archives no job
        "EDL_RUN_ARCHIVE": "0",
        "EDL_CKPT_PATH": os.path.join(work, "ckpt"),
        "TEST_OUT_DIR": out_dir,
        "TEST_EPOCHS": str(epochs),
        "TEST_EPOCH_PAUSE": str(pause),
    }
    if not device.startswith("cuda"):
        extra_env["EDL_COMPILE_CACHE_DIR"] = "none"  # no kernel library
    if workload == "lm":
        extra_env["TEST_DATA_DIR"] = data_dir
    harness = ResizeHarness(
        store.endpoint,
        "conv-%s-%d" % (tag, int(time.time())),
        LM_WORKER if workload == "lm" else WORKER,
        ["--device", device],
        nodes_range="1:%d" % max(schedule),
        ttl=ttl,
        log_dir=os.path.join(work, "logs"),
        extra_env=extra_env,
        device=device,
    )
    try:
        done = harness.run_schedule(schedule, interval, timeout=timeout)
        assert done, (
            "%s run did not complete (worker logs kept in %s)"
            % (tag, os.path.join(work, "logs"))
        )
        with open(os.path.join(out_dir, "final.json")) as f:
            result = json.load(f)
        incarnations = [
            n for n in os.listdir(out_dir) if n.startswith("inc.")
        ]
        result["stages_seen"] = len({n.split(".")[1] for n in incarnations})
        result["worker_incarnations"] = len(incarnations)
        if workload == "lm":
            # per-incarnation resume steps: churn must show distinct
            # re-entry points (the "different batch boundaries" proof
            # pairs with the batch digest)
            steps = set()
            for n in incarnations:
                doc = _read_json(os.path.join(out_dir, n))
                if isinstance(doc, dict) and "resume_step" in doc:
                    steps.add(doc["resume_step"])
            result["resume_steps"] = sorted(steps)
            # world- and stage-independent row->step assignment multiset:
            # the digest differs between runs IFF some row landed in a
            # different global batch (stage uuids/filenames excluded, so
            # equality is possible in principle and the comparison below
            # is not a tautology)
            pair_lines = []
            for n in os.listdir(out_dir):
                if n.startswith("pairs."):
                    with open(os.path.join(out_dir, n)) as f:
                        pair_lines.extend(f.read().splitlines())
            result["stream_digest"] = hashlib.sha256(
                "\n".join(sorted(pair_lines)).encode()
            ).hexdigest()[:16]
            result["row_step_pairs"] = len(pair_lines)
            # every incarnation's last report of its kernel launches (a
            # killed one's up to its last finished epoch)
            launches = dict.fromkeys(KERNELS, 0)
            for n in os.listdir(out_dir):
                doc = _read_json(os.path.join(out_dir, n)) if n.startswith(
                    "launches.") else None
                for k in KERNELS:
                    launches[k] += int((doc or {}).get(k, 0))
            result["launches"] = launches
        ok = True
    finally:
        harness.shutdown()
        store.stop()
        # only after every pod is down: workers may still be flushing
        # checkpoints/logs under this dir when COMPLETE first reads true
        if ok:
            shutil.rmtree(work, ignore_errors=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.convergence_churn",
        description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--interval", type=float, default=8.0)
    p.add_argument("--pause", type=float, default=0.35, help="per-epoch sleep "
                   "stretching the run so churn lands mid-training")
    p.add_argument(
        "--churn_schedule", default="2,4,1,3,2",
        help="pod counts; shrinks are SIGKILL, grows are cold starts",
    )
    p.add_argument(
        "--workload", choices=("digits", "lm"), default="digits",
        help="digits = world-size-invariant batches (proves stop-resume "
        "mechanics); lm = char-LM through the elastic data layer, where "
        "churn genuinely perturbs which rows share a global batch",
    )
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the run fails without a card) or cpu")
    args = p.parse_args(argv)

    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            print("convergence_churn: CUDA is not available (pass --device "
                  "cpu for CPU workers)", file=sys.stderr)
            return 2

    data_dir = None
    corpus_note = ("digits (1797 real samples, 10 classes; scikit-learn "
                   "1.9.0's copy of the UCI optical digits test set)")
    if args.workload == "lm":
        data_dir = tempfile.mkdtemp(prefix="edl-conv-corpus-")
        n_train, n_held = build_text_corpus(data_dir)
        corpus_note = (
            "repo-docs char corpus: %d train rows, %d held-out rows, "
            "49-byte windows" % (n_train, n_held)
        )

    try:
        static = run_once(
            "static", [2], args.interval, args.epochs, args.pause,
            timeout=args.timeout, workload=args.workload, data_dir=data_dir,
            device=args.device,
        )
        churn = run_once(
            "churn",
            [int(x) for x in args.churn_schedule.split(",")],
            args.interval,
            args.epochs,
            args.pause,
            timeout=args.timeout,
            workload=args.workload,
            data_dir=data_dir,
            device=args.device,
        )
    finally:
        if data_dir:
            shutil.rmtree(data_dir, ignore_errors=True)
    gap_pp = abs(static["test_accuracy"] - churn["test_accuracy"]) * 100.0
    record = {
        "metric": "convergence_churn_gap"
        if args.workload == "digits" else "convergence_churn_lm_gap",
        "value": round(gap_pp, 3),
        "unit": "pp",
        "vs_baseline": round(0.3 / max(gap_pp, 1e-9), 3),  # >=1.0 = within bar
        "target_pp": 0.3,
        "static": static,
        "churn": churn,
        "churn_schedule": args.churn_schedule,
        "epochs": args.epochs,
        "dataset": corpus_note,
        "platform": "gpu" if args.device.startswith("cuda") else "cpu",
        "device": args.device,
    }
    if args.workload == "lm":
        # the point of the lm workload: churn saw >=3 cluster generations
        # AND a genuinely different global-batch stream than static
        record["churn_perturbed_batches"] = (
            churn.get("stream_digest") != static.get("stream_digest")
        )
        record["churn_stages_ok"] = churn.get("stages_seen", 0) >= 3
    # self-archive: the gap is a gated regression metric (obs/regress.py
    # carries a convergence_churn_gap row), so every run lands in the
    # archive index edl-report trends. The bundle stamp tells the suite's
    # archive_step this doc is already indexed (no second bundle).
    from edl_tpu_torch.obs.archive import maybe_archive_bench

    bundle = maybe_archive_bench(
        "convergence_churn", record, backend=args.device
    )
    if bundle:
        record["bundle"] = os.path.basename(bundle)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
