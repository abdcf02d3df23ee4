"""Worker-side elastic data loader.

The consumer the reference's WIP ``DistributedDataReader``
(python/edl/collective/data_reader.py:101) was meant to be: pull file
tasks from the dispatcher, stream records, report progress so a
re-dispatched task resumes at the exact record, ack done/failed.

Yields ``(file_idx, record_idx, record_bytes)`` triples; batching and
decoding are the caller's (model input pipeline's) job — the input
pipeline packs fixed-shape batches for the device (``data/prefetch.py``),
so the raw-record stream stays framework-agnostic here.

The port's copy of ``edl_tpu/data/loader.py``.
"""

from __future__ import annotations

import time
from typing import Iterator, Tuple

from edl_tpu_torch.data.dataset import FileSplitter
from edl_tpu_torch.data.dispatcher import DispatcherClient
from edl_tpu_torch.utils.log import get_logger

logger = get_logger("data.loader")


class ElasticDataLoader:
    def __init__(
        self,
        client: DispatcherClient,
        splitter: FileSplitter,
        report_every: int = 256,
        poll_interval: float = 0.2,
    ) -> None:
        self._client = client
        self._splitter = splitter
        self._report_every = report_every
        self._poll = poll_interval

    def epoch(self) -> Iterator[Tuple[int, int, bytes]]:
        """Stream this worker's share of the epoch, task by task."""
        while True:
            resp = self._client.get_task()
            if resp.get("epoch_done"):
                return
            if resp.get("wait"):
                time.sleep(self._poll)
                continue
            task = resp["task"]
            task_id, file_idx = task["id"], task["file_idx"]
            start = task["start_record"]
            emitted = 0
            try:
                for rec_idx, record in self._splitter.split(task["path"]):
                    if rec_idx < start:
                        continue
                    yield file_idx, rec_idx, record
                    emitted += 1
                    if emitted % self._report_every == 0:
                        self._client.report(task_id, rec_idx + 1)
            except OSError as exc:
                logger.warning("task %d read failed: %s", task_id, exc)
                self._client.task_failed(task_id)
                continue
            self._client.task_done(task_id)
