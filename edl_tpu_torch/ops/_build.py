"""Build and load a CUDA kernel of ``ops/csrc`` at first use.

``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into a shared library, loaded with ``ctypes``. The library is
named by the hash of its source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel is rebuilt and an unchanged one is reused,
and a library is portable between hosts by its name alone. Different
sources may build concurrently.

This is the port's compile cache. Its directory is resolved once per
process, at the first build (never at import), and kept across a hot
restage: the worker's ``EDL_COMPILE_CACHE_DIR`` when one is set, the
checkout's ``ops/build/`` (gitignored) otherwise. A library missing from a
named cache dir is looked for next in ``ops/build/`` and copied in; only
when both miss does ``nvcc`` run. So the cache dir holds every library its
pod loaded, and the compile-cache exchange (``train/aot.py``) ships it to
the pods that join. The loader opens only the name it derives from its
own sources: a pulled library of another source version sits inert.

Each resolution counts in ``edl_train_compile_cache_events_total{kind}``
(``hit`` in the cache dir, ``miss``, ``write`` of a copied or built
library), and the seconds ``nvcc`` takes in
``edl_train_restage_compile_seconds``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

from edl_tpu_torch.obs import metrics as obs_metrics

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_M_CACHE_EVENTS = obs_metrics.counter(
    "edl_train_compile_cache_events_total",
    "kernel-library cache events at each library's first load, by kind "
    "(hit: in the cache dir; miss; write: copied or built into it)",
)
_M_RESTAGE_COMPILE = obs_metrics.histogram(
    "edl_train_restage_compile_seconds",
    "nvcc seconds paid per library missing from the cache dir and the "
    "checkout; no entry after a resize means the cache covered it",
)

_locks = {}
_locks_guard = threading.Lock()
_cache_dir: Optional[str] = None  # resolved at the first build
_libs = {}  # name -> the loaded library


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def sources() -> List[str]:
    """The kernel sources of ``csrc/``, by name (``flash_fwd``, ...)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def cache_dir() -> str:
    """This process's library directory, resolved at the first call and
    kept: ``EDL_COMPILE_CACHE_DIR`` when it names one, else
    ``ops/build/``."""
    global _cache_dir
    with _locks_guard:
        if _cache_dir is None:
            named = os.environ.get("EDL_COMPILE_CACHE_DIR", "")
            _cache_dir = (os.path.abspath(named)
                          if named and named != "none" else BUILD_DIR)
        return _cache_dir


def library_name(name: str) -> str:
    """The file name of ``csrc/<name>.cu``'s library: the hash of the
    source, the shared headers and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return "lib%s-%s.so" % (name, digest.hexdigest()[:16])


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


def build(name: str, compile: bool = True) -> Tuple[Optional[str], str]:
    """Resolve ``csrc/<name>.cu``'s library: the cache dir's, else a copy
    of ``ops/build/``'s, else (``compile``) a fresh ``nvcc`` build into the
    cache dir. Returns ``(library path, nvcc log)``; the log is empty
    unless nvcc ran, and the path is None when ``compile`` is off and
    nothing was found. Raises if nvcc fails."""
    src = os.path.join(CSRC, name + ".cu")
    base = library_name(name)
    cache = cache_dir()
    lib = os.path.join(cache, base)
    with _lock(name):
        if os.path.exists(lib):
            _M_CACHE_EVENTS.inc(kind="hit")
            return lib, ""
        shipped = os.path.join(BUILD_DIR, base)
        found = cache != BUILD_DIR and os.path.exists(shipped)
        if not (found or compile):
            return None, ""
        _M_CACHE_EVENTS.inc(kind="miss")
        os.makedirs(cache, exist_ok=True)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        log = ""
        if found:
            shutil.copyfile(shipped, tmp)
        else:
            t0 = time.monotonic()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise RuntimeError("nvcc failed for %s:\n%s" % (name, proc.stdout))
            _M_RESTAGE_COMPILE.observe(time.monotonic() - t0)
            log = proc.stdout
        os.replace(tmp, lib)  # atomic: concurrent builds agree
        _M_CACHE_EVENTS.inc(kind="write")
        return lib, log


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs.setdefault(name, ctypes.CDLL(build(name)[0]))
    return lib


def preload() -> List[str]:
    """Load every kernel library that resolves without ``nvcc`` (``dlopen``
    only: no CUDA call, no context); the names loaded. The standby shell's
    pre-payment."""
    for name in sources():
        if name not in _libs:
            path = build(name, compile=False)[0]
            if path is not None:
                _libs.setdefault(name, ctypes.CDLL(path))
    return sorted(_libs)


def cache_event_counts() -> dict:
    """``{hit, miss, write}``: this process's library resolutions."""
    return {kind: int(_M_CACHE_EVENTS.value(kind=kind))
            for kind in ("hit", "miss", "write")}
