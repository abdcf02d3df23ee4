"""Build and load a CUDA kernel of ``ops/csrc`` at first use.

``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into a shared library, loaded with ``ctypes``. The build runs
where the card is, from the sources in the checkout, into ``ops/build/``
(gitignored); the library is named by the hash of its source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited kernel is rebuilt and
an unchanged one is reused. Different sources may build concurrently.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_locks = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "from ops/csrc on the machine with the card"
    )


def build(name: str) -> Tuple[str, str]:
    """Compile ``csrc/<name>.cu`` unless that source is already built;
    returns ``(library path, nvcc log)`` (the log is empty on reuse).
    Raises if nvcc fails."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    lib = os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16]))
    with _lock(name):
        if os.path.exists(lib):
            return lib, ""
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, proc.stdout))
        os.replace(tmp, lib)  # atomic: concurrent builds agree
        return lib, proc.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    return ctypes.CDLL(build(name)[0])
