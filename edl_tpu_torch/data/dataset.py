"""File-list datasets and record splitters.

Capability parity with the reference's dataset layer
(python/edl/collective/dataset.py:19-48 ``FileSplitter/TxtFileSplitter``):
a dataset is a list of files; a splitter turns one file into numbered
records, so any (file, record) pair addresses one sample — the unit of
the data checkpoint.

The port's copy of ``edl_tpu/data/dataset.py``: the same records, so a
(file, record) pair names one sample in both packages.
"""

from __future__ import annotations

import os
from typing import Iterable, Iterator, List, Tuple


class FileSplitter:
    """Iterate ``(record_idx, record_bytes)`` pairs of one file."""

    def split(self, path: str) -> Iterator[Tuple[int, bytes]]:
        raise NotImplementedError

    def count(self, path: str) -> int:
        return sum(1 for _ in self.split(path))


class TxtFileSplitter(FileSplitter):
    """One record per line, newline stripped (≙ reference dataset.py:36)."""

    def split(self, path: str) -> Iterator[Tuple[int, bytes]]:
        with open(path, "rb") as f:
            for idx, line in enumerate(f):
                yield idx, line.rstrip(b"\r\n")


class FileListDataset:
    """An ordered list of data files + the splitter that reads them."""

    def __init__(self, files: Iterable[str], splitter: FileSplitter) -> None:
        self.files: List[str] = [os.fspath(f) for f in files]
        self.splitter = splitter

    @classmethod
    def from_file_list(
        cls, list_path: str, splitter: FileSplitter, base_dir: str = ""
    ) -> "FileListDataset":
        """Read a file whose lines are data-file paths (the reference's
        file-list convention, utils.py:41)."""
        files = []
        with open(list_path, "r") as f:
            for line in f:
                line = line.strip()
                if line:
                    files.append(os.path.join(base_dir, line))
        return cls(files, splitter)

    def read_file(
        self, file_idx: int, start_record: int = 0
    ) -> Iterator[Tuple[int, bytes]]:
        for idx, rec in self.splitter.split(self.files[file_idx]):
            if idx >= start_record:
                yield idx, rec

    def __len__(self) -> int:
        return len(self.files)
