"""Deterministic elastic data layer: the port of ``edl_tpu.data``.

- ``dataset``    — file-list datasets and record splitters (copy).
- ``checkpoint`` — per-(file, record) progress for exact mid-epoch resume,
  riding in the model checkpoint's ``TrainStatus.meta["data"]`` (copy).
- ``dispatcher`` — the leader-hosted task-queue dispatch service and its
  client, on the same wire frames and store keys as the JAX package's
  (copy).
- ``loader``     — the worker-side iterator over the dispatcher's tasks
  (copy).
- ``prefetch``   — fixed-shape batching and the host->device feed (a
  PyTorch port).
"""

from edl_tpu_torch.data.dataset import (
    FileListDataset,
    FileSplitter,
    TxtFileSplitter,
)
from edl_tpu_torch.data.checkpoint import DataCheckpoint
from edl_tpu_torch.data.dispatcher import (
    DISPATCH_SERVICE,
    DataDispatcher,
    DataTask,
    DispatcherClient,
    discover_dispatcher,
    publish_dispatcher,
)
from edl_tpu_torch.data.loader import ElasticDataLoader
from edl_tpu_torch.data.prefetch import batched, prefetch_to_device, shuffled

__all__ = [
    "DISPATCH_SERVICE",
    "discover_dispatcher",
    "publish_dispatcher",
    "FileListDataset",
    "FileSplitter",
    "TxtFileSplitter",
    "DataCheckpoint",
    "DataDispatcher",
    "DispatcherClient",
    "DataTask",
    "ElasticDataLoader",
    "batched",
    "prefetch_to_device",
    "shuffled",
]
