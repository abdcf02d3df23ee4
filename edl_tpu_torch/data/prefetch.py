"""Fixed-shape batching + host->device prefetch for the input pipeline.

The port of ``edl_tpu/data/prefetch.py``. :func:`shuffled` and
:func:`batched` are the JAX package's numpy code, copied: every batch is
exactly ``batch_size`` rows (a ragged tail is padded and carries a
validity mask, or dropped), so a resumed or resized stage sees the same
batches. :func:`prefetch_to_device` keeps ``depth`` batches in flight:
a feeder thread stages each host batch in pinned memory and copies it to
the card on a dedicated CUDA stream, so the copy of batch N+1 overlaps the
step on batch N.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

__all__ = ["batched", "prefetch_to_device", "shuffled"]


def shuffled(records: Iterable[Any], buffer_size: int, seed: int) -> Iterator[Any]:
    """Streaming shuffle through a bounded reservoir (tf.data-style).

    Deterministic for a given ``seed`` — pass an epoch-derived seed to
    keep the reference's ``pass_id_as_seed`` reproducible-order contract
    (train_with_fleet.py:458-464) while decorrelating batches. O(buffer)
    memory however long the stream."""
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    rng = np.random.RandomState(seed)
    buf: list = []
    for rec in records:
        if len(buf) < buffer_size:
            buf.append(rec)
            continue
        idx = rng.randint(buffer_size)
        out, buf[idx] = buf[idx], rec
        yield out
    rng.shuffle(buf)
    yield from buf


def batched(
    records: Iterable[Any],
    batch_size: int,
    collate: Optional[Callable[[list], Any]] = None,
    drop_remainder: bool = False,
) -> Iterator[Tuple[Any, np.ndarray]]:
    """Group a record stream into fixed-size batches.

    Yields ``(batch, mask)`` where ``mask`` is a ``(batch_size,)`` bool
    array — all True except on a padded final batch, whose tail repeats
    the last real record (values are valid arrays, mask tells the loss
    which rows count). ``collate`` turns the list of records into the
    batch structure (default: ``np.stack`` of per-record arrays, or a
    tuple of stacked fields when records are tuples).
    """
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    collate = collate or _default_collate
    buf: list = []
    for rec in records:
        buf.append(rec)
        if len(buf) == batch_size:
            yield collate(buf), np.ones((batch_size,), bool)
            buf = []
    if buf and not drop_remainder:
        mask = np.zeros((batch_size,), bool)
        mask[: len(buf)] = True
        while len(buf) < batch_size:
            buf.append(buf[-1])
        yield collate(buf), mask


def _default_collate(records: list):
    first = records[0]
    if isinstance(first, tuple):
        return tuple(
            np.stack([np.asarray(r[i]) for r in records])
            for i in range(len(first))
        )
    return np.stack([np.asarray(r) for r in records])


class _Stop:
    pass


def prefetch_to_device(
    batches: Iterable[Any],
    depth: int = 2,
    sharding=None,
    device="cuda",
) -> Iterator[Any]:
    """Iterate ``batches`` (tuples, lists and dicts of arrays) as tensors
    on the device, with ``depth`` transfers in flight.

    The device is ``sharding``'s (:func:`edl_tpu_torch.parallel.
    batch_sharding`: this rank's rows of the global batch), else
    ``device`` (the card unless the caller names the CPU). On the card a
    daemon thread copies each batch through pinned memory on its own CUDA
    stream; the consumer's stream waits for that batch's copy before it
    gets the batch, and each tensor is marked as used by the consumer's
    stream so the allocator cannot hand its memory out while the step
    still reads it. Exceptions in the source iterator are re-raised at
    the consuming call site. Staging memory is bounded at ``depth + 1``
    device batches: the queue holds at most ``depth`` and the feeder
    stages the next batch before blocking on the queue reservation.
    """
    import torch

    from edl_tpu_torch.parallel.mesh import to_tensor, tree_map
    from edl_tpu_torch.utils.device import resolve_device

    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = sharding.device if sharding is not None else resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        # "cuda" names the current card; the feeder thread selects it by
        # index
        dev = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(dev) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: collections.deque = collections.deque(maxlen=1)
    stop = threading.Event()  # consumer gone: unblock + stop the feeder

    def put(batch):
        if not on_card:
            return tree_map(lambda a: to_tensor(a).to(dev, copy=True), batch), None
        with torch.cuda.stream(copy_stream):
            staged = tree_map(
                lambda a: to_tensor(a).pin_memory().to(dev, non_blocking=True),
                batch,
            )
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        return staged, copied

    def feeder():
        try:
            if on_card:
                torch.cuda.set_device(dev)  # before the thread's first copy
            for b in batches:
                staged = put(b)
                while not stop.is_set():
                    try:
                        q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return  # abandoned mid-epoch: drop staged batches
        except BaseException as exc:  # re-raised consumer-side
            err.append(exc)
        finally:
            while not stop.is_set():  # deliver _Stop unless abandoned
                try:
                    q.put(_Stop, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def consume(tensor, stream):
        tensor.record_stream(stream)
        return tensor

    t = threading.Thread(target=feeder, daemon=True, name="edl-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _Stop:
                if err:
                    raise err.popleft()
                return
            batch, copied = item
            if copied is not None:
                # wait for THIS batch's copy (a wait on the copy stream as
                # a whole would also wait for the batches staged after it)
                stream = torch.cuda.current_stream(dev)
                stream.wait_event(copied)
                batch = tree_map(lambda a: consume(a, stream), batch)
            yield batch
    finally:
        # runs on break/exception/GeneratorExit too: without it the
        # feeder blocks in q.put forever, pinning `depth` device batches
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
