"""Distill retention benchmark: service-distill vs pure-train throughput.

The port of ``tools/distill_retention.py``. The reference's headline
claim is service distillation at 0.83x of pure-train throughput with
better accuracy (1514 vs 1828 img/s on 8 V100s, reference
README.md:68-72). This measures the same ratio end-to-end on the port:

1. **pure**: the student's train step over a synthetic epoch.
2. **distill**: the SAME student step plus a soft-label term, fed by a
   :class:`DistillReader` under the full discovery/balance stack — the
   port's store, ``DiscoveryService``, >= 2 registered ``PredictServer``
   teachers running a real teacher model (``TorchPredictBackend``) —
   with one teacher stopped mid-run, its connections reset (the
   connection-failure failover stays on the hot path).

The models follow the device: ResNet50_vd teachers and student at
224x224 on the card (``--device cuda``, the default; the teachers in
eval mode, the student training its batch norm), the JAX tool's MLPs on
the CPU. ``--backend echo`` swaps the teachers for a near-free echo,
isolating the reader/discovery pipeline's cost. The teachers share the
card and this process with the student, so ``serialized_floor`` (the
harmonic combination of the pure step's rate and the pipeline's own rate)
says what a fully serialized co-location would give.

Prints ONE JSON line, the JAX tool's keys::

    {"metric": "distill_retention", "value": <distill/pure ratio>,
     "unit": "x", "vs_baseline": <ratio / 0.828>, ...}

``vs_baseline`` divides by the reference's published ratio on 8 V100s
(1514 / 1828 img/s; ``baseline_ratio``, ``baseline_source``), not by a
number measured here. ``epochs_exact`` says whether every timed epoch
of the distill run consumed every batch exactly once, in order, through
the teacher's stop.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

REFERENCE_RATIO = 1514.0 / 1828.0  # reference README.md:70-72
REFERENCE_SOURCE = ("reference README.md:70-72, 8x V100: 1514 img/s "
                    "distilled / 1828 img/s pure")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m edl_tpu_torch.tools.distill_retention",
        description=__doc__.split("\n")[0])
    parser.add_argument("--units", type=int, default=40, help="batches/epoch")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--teachers", type=int, default=2)
    parser.add_argument(
        "--kill_teacher", action=argparse.BooleanOptionalAction, default=True,
        help="stop one teacher mid-run (--no-kill_teacher for the "
        "no-failover baseline)",
    )
    parser.add_argument(
        "--backend", choices=("torch", "echo"), default="torch",
        help="torch = a real teacher model behind TorchPredictBackend "
        "(shares this process's card); echo = near-free teacher, "
        "isolating the reader/discovery pipeline overhead",
    )
    parser.add_argument(
        "--trials", type=int, default=1,
        help="repeat the pure/distill measurement N times and report the "
        "mean ratio plus spread",
    )
    parser.add_argument(
        "--student_hidden", type=int, default=128,
        help="CPU student MLP width (the card runs ResNet50_vd)",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.data import prefetch_to_device
    from edl_tpu_torch.distill import (
        DistillReader, EchoPredictBackend, PredictServer, TorchPredictBackend,
    )
    from edl_tpu_torch.distill.discovery import (
        DiscoveryService, TeacherRegister,
    )
    from edl_tpu_torch.models import MLP, ResNet50_vd
    from edl_tpu_torch.store.server import StoreServer
    from edl_tpu_torch.train import create_state, make_train_step, sgd
    from edl_tpu_torch.train.step import init_weights
    from edl_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    on_gpu = dev.type == "cuda"
    batch = args.batch or (128 if on_gpu else 32)
    num_classes = 1000 if on_gpu else 100

    if on_gpu:
        def student_model():
            return ResNet50_vd(num_classes=num_classes)

        def teacher_model():
            return ResNet50_vd(num_classes=num_classes)

        shape = (224, 224, 3)
        apply_kwargs = {"train": True}
        # the teacher is inference-only: batch norm reads its averages
        teacher_kwargs = {"train": False}
    else:
        h = args.student_hidden

        def student_model():
            return MLP(256, hidden=(h, h), features=num_classes)

        def teacher_model():
            return MLP(256, hidden=(4 * h, 4 * h), features=num_classes)

        shape = (256,)
        apply_kwargs = None
        teacher_kwargs = {}

    data = np.random.RandomState(0).randn(args.units, batch, *shape).astype(
        np.float32)
    labels = np.random.RandomState(1).randint(
        0, num_classes, (args.units, batch)
    ).astype(np.int64)

    def gen():
        for i in range(args.units):
            yield (data[i], labels[i])

    # -- pure train --------------------------------------------------------
    def pure_loss(logits, y):
        return F.cross_entropy(logits.float(), y), {}

    state = create_state(student_model(), 0, sgd(0.1, momentum=0.9),
                         device=dev)
    step = make_train_step(pure_loss, apply_kwargs)

    def overlapped(src):
        """Host->device uploads overlapping compute where a transfer
        exists; on the CPU host == device and the feeder thread would
        only burn the shared cores, so both loops stay plain there."""
        return prefetch_to_device(src, depth=2, device=dev) if on_gpu else (
            tuple(torch.tensor(a) for a in b) for b in src)

    def run_pure():
        s = state.copy()  # every run starts from the same state
        # warm-up (the first steps' allocations and kernel choices)
        warm = next(iter(overlapped(iter([(data[0], labels[0])]))))
        for _ in range(2):
            s, m = step(s, warm)
        float(m["loss"])
        t0 = time.perf_counter()
        n = 0
        for _ in range(args.epochs):
            # the same upload treatment as the distill loop: the RATIO
            # compares pipelines, not transfer disciplines
            for x, y in overlapped(gen()):
                s, m = step(s, (x, y))
                n += x.shape[0]
        float(m["loss"])
        return n / (time.perf_counter() - t0)

    # -- distill stack -----------------------------------------------------
    # the distill step: hard CE + soft CE against the teacher's logits
    def distill_loss(logits, y_and_soft):
        y, t_logits = y_and_soft
        logits = logits.float()
        hard = F.cross_entropy(logits, y)
        soft = -(F.softmax(t_logits.float(), dim=-1)
                 * F.log_softmax(logits, dim=-1)).sum(dim=-1).mean()
        return 0.5 * hard + 0.5 * soft, {}

    dstep = make_train_step(distill_loss, apply_kwargs)

    def teacher_module():
        # every teacher draws the same weights (the JAX tool's PRNGKey(7))
        t = teacher_model().to(dev)
        init_weights(t, 7, dev)
        return t.eval()

    def make_backend():
        if args.backend == "echo":
            return EchoPredictBackend()
        teacher = teacher_module()

        def t_apply(feeds):
            return {"logits": teacher(feeds["img"], **teacher_kwargs)}

        return TorchPredictBackend(t_apply, device=dev)

    @contextlib.contextmanager
    def pipeline_stack(job):
        """The full serving stack, started: store + discovery + teachers
        + a configured DistillReader. One definition so the floor
        measurement streams exactly the pipeline being floored."""
        store = StoreServer(port=0).start()
        servers, regs = [], []
        svc = reader = None
        try:
            for _ in range(args.teachers):
                srv = PredictServer(make_backend()).start()
                servers.append(srv)
                regs.append(
                    TeacherRegister(store.endpoint, job, "teacher",
                                    srv.endpoint)
                )
            svc = DiscoveryService(store.endpoint, job, ["teacher"])
            fetchs = ("logits",) if args.backend == "torch" else ("echo_img",)
            reader = DistillReader(
                feeds=("img",), fetchs=fetchs,
                teacher_batch_size=batch, require_num=3,
                # gen() yields slices of a persistent array — no buffer
                # reuse, so the pipeline may own the rows without a
                # defensive memcpy
                copy_batches=False,
            )
            reader.set_dynamic_teacher(store.endpoint, job, "teacher")
            reader.set_batch_generator(gen)
            yield reader, servers, regs
        finally:
            if reader is not None:
                reader.stop()
            for r in regs:
                r.stop()
            if svc is not None:
                svc.stop()
            for srv in servers:
                srv.stop()
            store.stop()

    def run_distill():
        """``(samples/s, exact)``: ``exact`` is True when every timed
        epoch yielded every batch once, in order."""
        with pipeline_stack("retention") as (reader, servers, regs):
            killer = None
            if args.kill_teacher and len(servers) > 1:
                def chaos():
                    time.sleep(0.3)
                    regs[-1].stop()
                    servers[-1].stop()  # mid-run teacher death
                killer = threading.Thread(target=chaos, daemon=True)

            def consume(s, placed):
                # echo mode: the teacher's output is row sums, not logits —
                # the student runs its pure step (the pipeline's overhead
                # is the metric)
                x, y, t_out = placed
                if args.backend == "torch":
                    return dstep(s, (x, (y, t_out)))
                return step(s, (x, y))

            order = []

            def checked_epoch():
                """The reader's epoch, each batch's labels matched to the
                source's index on the host (before the upload)."""
                got = []
                for x, y, t_out in reader():
                    i = len(got)
                    got.append(i < args.units and np.array_equal(
                        y, labels[i]))
                    yield x, y, t_out
                order.append(len(got) == args.units and all(got))

            s = state.copy()
            # warm-up epoch (the first steps and the pipeline's spin-up)
            for placed in overlapped(checked_epoch()):
                s, m = consume(s, placed)
            float(m["loss"])
            if killer:
                killer.start()
            t0 = time.perf_counter()
            n = 0
            for _ in range(args.epochs):
                for placed in overlapped(checked_epoch()):
                    s, m = consume(s, placed)
                    n += placed[0].shape[0]
            float(m["loss"])
            return n / (time.perf_counter() - t0), all(order[1:])

    # -- the serialization floor -------------------------------------------
    # Where teachers share the student's compute (this process, one card),
    # the best any service pipeline can do is the FULLY SERIALIZED rate:
    # each batch pays student step + teacher forward with zero overlap.
    # Measure teacher-only throughput and derive that floor, so the ratio
    # is interpretable — the gap between the measured ratio and the floor
    # is the machinery's overhead, not "distillation is slow".
    def measure_teacher_sps():
        if args.backend == "echo":
            return None  # the echo teacher is ~free; the floor is ~1.0
        teacher = teacher_module()
        with torch.inference_mode():
            acc = teacher(torch.as_tensor(data[0], device=dev),
                          **teacher_kwargs).float().sum()
            float(acc)
            t0 = time.perf_counter()
            n = 0
            for _ in range(args.epochs):
                for x, _ in gen():
                    # a running sum: one fetch at the end forces every
                    # forward
                    acc = acc + teacher(torch.as_tensor(x, device=dev),
                                        **teacher_kwargs).float().sum()
                    n += x.shape[0]
            float(acc)
        del teacher
        return n / (time.perf_counter() - t0)

    teacher_sps = measure_teacher_sps()

    def measure_reader_sps():
        """End-to-end pipeline capacity WITHOUT the student: the same
        serving stack as run_distill (shared ``pipeline_stack``),
        streamed dry. harmonic(pure, reader) is then the fully-
        serialized floor for THIS backend — socket copies, framing and
        thread handoffs included, which the teacher-only number can't
        see."""
        with pipeline_stack("retention-floor") as (reader, _srv, _regs):
            for _ in reader():  # warm-up epoch (pipeline spin-up)
                pass
            t0 = time.perf_counter()
            n = 0
            for _ in range(args.epochs):
                for x, _y, _t in reader():
                    n += x.shape[0]
            return n / (time.perf_counter() - t0)

    # bracketed like pure: scheduler noise during a single window would
    # deflate the floor and with it the overhead-above-floor claim
    reader_sps = max(measure_reader_sps(), measure_reader_sps())

    # bracket the distill run with two pure measurements and keep the
    # faster one: one-sided scheduler noise could otherwise report
    # distill "faster" than pure
    ratios, pures, distills, exact = [], [], [], []
    for _ in range(max(1, args.trials)):
        pure_sps = run_pure()
        distill_sps, ok = run_distill()
        pure_sps = max(pure_sps, run_pure())
        pures.append(pure_sps)
        distills.append(distill_sps)
        ratios.append(distill_sps / pure_sps)
        exact.append(ok)
    ratio = sum(ratios) / len(ratios)
    pure_sps = sum(pures) / len(pures)
    distill_sps = sum(distills) / len(distills)

    record = {
        "metric": "distill_retention",
        "value": round(ratio, 3),
        "unit": "x",
        "vs_baseline": round(ratio / REFERENCE_RATIO, 3),
        "baseline_ratio": round(REFERENCE_RATIO, 3),
        "baseline_source": REFERENCE_SOURCE,
        "pure_sps": round(pure_sps, 1),
        "distill_sps": round(distill_sps, 1),
        "platform": "gpu" if on_gpu else "cpu",
        "device": str(dev),
        "backend": args.backend,
        "teachers": args.teachers,
        "teacher_killed": bool(args.kill_teacher and args.teachers > 1),
        "epochs_exact": all(exact),
        "batch": batch,
        "units": args.units,
        "student_hidden": args.student_hidden,
        "epochs": args.epochs,
    }
    if args.trials > 1:
        record["trials"] = [round(r, 3) for r in ratios]
        record["spread_pct"] = round(
            (max(ratios) - min(ratios)) / max(ratios) * 100, 2
        )
    if teacher_sps is not None:
        record["teacher_sps"] = round(teacher_sps, 1)
    if reader_sps:
        # fully-serialized floor on a shared device: each sample pays one
        # student step AND one trip through the serving pipeline with
        # zero overlap — harmonic combination of the two measured rates
        floor_sps = 1.0 / (1.0 / pure_sps + 1.0 / reader_sps)
        floor = floor_sps / pure_sps
        record["reader_sps"] = round(reader_sps, 1)
        record["serialized_floor"] = round(floor, 3)
        # >1.0 means the overlap machinery costs more than perfect
        # serialization; ≈1.0 means the measured ratio IS the
        # co-location floor and the machinery itself adds nothing
        record["overhead_above_floor"] = round(floor / max(ratio, 1e-9), 3)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
