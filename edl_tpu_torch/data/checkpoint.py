"""Per-(file, record) data progress for exact mid-epoch resume.

The reference explicitly defers this ("step-level checkpointing is future
work", doc/fault_tolerance.md:27-28) and leaves only a broken sketch
(``DataCheckpoint``, python/edl/collective/data_reader.py:63-84). Here it
is finished: progress is a map ``file_idx -> next unread record`` plus the
epoch number, JSON-serializable so it rides inside the model checkpoint's
``TrainStatus.meta`` — one atomic save covers both model and data state.

The port's copy of ``edl_tpu/data/checkpoint.py``: the same dict, so a
version's ``meta["data"]`` reads the same in both packages.
"""

from __future__ import annotations

import json
from typing import Dict, Optional


class DataCheckpoint:
    def __init__(
        self,
        epoch: int = 0,
        offsets: Optional[Dict[int, int]] = None,
        done_files: Optional[list] = None,
    ) -> None:
        self.epoch = epoch
        self.offsets: Dict[int, int] = dict(offsets or {})
        self.done_files = set(done_files or ())

    def record_progress(self, file_idx: int, next_record: int) -> None:
        self.offsets[file_idx] = next_record

    def file_done(self, file_idx: int) -> None:
        self.offsets.pop(file_idx, None)
        self.done_files.add(file_idx)

    def start_offset(self, file_idx: int) -> int:
        return self.offsets.get(file_idx, 0)

    def is_file_done(self, file_idx: int) -> bool:
        return file_idx in self.done_files

    def next_epoch(self) -> None:
        self.epoch += 1
        self.offsets.clear()
        self.done_files.clear()

    # -- (de)serialization -------------------------------------------------

    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "offsets": {str(k): v for k, v in self.offsets.items()},
            "done_files": sorted(self.done_files),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DataCheckpoint":
        return cls(
            epoch=d.get("epoch", 0),
            offsets={int(k): v for k, v in d.get("offsets", {}).items()},
            done_files=d.get("done_files", ()),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, s: str) -> "DataCheckpoint":
        return cls.from_dict(json.loads(s))
