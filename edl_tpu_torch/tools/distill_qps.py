"""DistillReader throughput probe.

The port of ``tools/distill_qps.py``, with capability parity with the
reference's QPS tool (.tools/qps_tools/distill_reader_qps.py:34-57 —
steps/s of the reader pipeline): runs the port's full student-side
pipeline (reader → predict pool → ordered fetch) against local fake
teachers (``EchoPredictBackend`` or ``NopPredictBackend``, optionally
behind ``CoalescingBackend``), so the number isolates pipeline overhead
from teacher FLOPs. No device is used. Prints one JSON line, the JAX
tool's keys.

    python -m edl_tpu_torch.tools.distill_qps --batches 200 --batch_size 128
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from edl_tpu_torch.distill import (
    CoalescingBackend,
    DistillReader,
    EchoPredictBackend,
    NopPredictBackend,
    PredictServer,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.distill_qps",
        description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, default=200)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--sample_shape", default="3,224,224")
    parser.add_argument("--teacher_batch_size", type=int, default=128)
    parser.add_argument("--require_num", type=int, default=3)
    parser.add_argument("--teachers", type=int, default=2)
    parser.add_argument(
        "--backend", choices=("nop", "echo"), default="echo",
        help="nop = reference's NOP fake; echo = per-sample checksums",
    )
    parser.add_argument(
        "--students", type=int, default=1,
        help="concurrent student pipelines sharing the teacher fleet",
    )
    parser.add_argument(
        "--coalesce_ms", type=float, default=0.0,
        help="teacher-side megabatching window (0 = off): with several "
        "students, measures what cross-request coalescing buys",
    )
    args = parser.parse_args(argv)

    shape = tuple(int(x) for x in args.sample_shape.split(","))

    def make_backend():
        base = (
            NopPredictBackend() if args.backend == "nop"
            else EchoPredictBackend()
        )
        if args.coalesce_ms > 0:
            return CoalescingBackend(base, max_wait_ms=args.coalesce_ms)
        return base

    backends = [make_backend() for _ in range(args.teachers)]
    servers = [PredictServer(b).start() for b in backends]

    data = np.random.rand(args.batch_size, *shape).astype(np.float32)

    def batches():
        for i in range(args.batches):
            yield (data, np.full((args.batch_size,), i, np.int64))

    def make_reader():
        reader = DistillReader(
            feeds=("img", "label"),
            teacher_batch_size=args.teacher_batch_size,
            require_num=args.require_num,
        )
        reader.set_fixed_teacher(*[s.endpoint for s in servers])
        reader.set_batch_generator(batches)
        return reader

    readers = [make_reader() for _ in range(args.students)]

    import threading

    errors = []

    def run_epoch(reader, out, i):
        try:
            n = 0
            for _batch in reader():
                n += 1
            out[i] = n
        except BaseException as exc:  # surface in the main thread
            errors.append(exc)

    # warmup epoch, then the measured epoch
    base_calls = base_reqs = 0
    for phase in ("warmup", "measure"):
        counts = [0] * args.students
        if phase == "measure":
            # counters are cumulative: snapshot after warmup so the JSON
            # reports measured-epoch traffic only
            base_calls = sum(getattr(b, "batches_run", 0) for b in backends)
            base_reqs = sum(getattr(b, "requests_served", 0) for b in backends)
            t0 = time.perf_counter()
        threads = [
            threading.Thread(target=run_epoch, args=(r, counts, i))
            for i, r in enumerate(readers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:  # a corrupted benchmark must fail loudly, not print QPS
            raise errors[0]
    dt = time.perf_counter() - t0
    n = sum(counts)

    for reader in readers:
        reader.stop()
    for s in servers:
        s.stop()

    out = {
        "metric": "distill_reader_qps",
        "steps_per_s": round(n / dt, 2),
        "samples_per_s": round(n * args.batch_size / dt, 1),
        "batches": n,
        "teachers": args.teachers,
        "students": args.students,
        "backend": args.backend,
        "bytes_per_sample": int(data.nbytes / args.batch_size),
    }
    if args.coalesce_ms > 0:
        out["coalesce_ms"] = args.coalesce_ms
        out["device_calls"] = (
            sum(b.batches_run for b in backends) - base_calls
        )
        out["requests"] = (
            sum(b.requests_served for b in backends) - base_reqs
        )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
