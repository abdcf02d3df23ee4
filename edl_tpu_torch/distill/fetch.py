"""Teacher model distribution: fetch params by URI with checksum caching.

Capability parity with the reference's HDFS teacher fetch
(``download_hdfs_file``, reference python/edl/distill/utils.py:20, env
``PADDLE_DISTILL_HDFS_{NAME,UGI,PATH}``): a teacher daemon starting on a
fresh host pulls its serving params from shared storage before it can
register. Here the source is a URI — a local path, ``file://``,
``http(s)://``, or ``gs://`` — with an optional sha256 that both
verifies integrity and keys a local cache, so restarting teachers (the
normal state of affairs in an elastic fleet) never re-download.

Env contract (mirrors the reference's):

    EDL_DISTILL_MODEL_URI       where to fetch the params from
    EDL_DISTILL_MODEL_SHA256    optional integrity/cache checksum
    EDL_DISTILL_MODEL_CACHE     cache dir (default ~/.cache/edl_tpu/models)

The fetched artifact is opaque bytes to this module; the flagship use is
a flax ``serialization.to_bytes`` msgpack of ``{"params", "batch_stats"}``
(see :mod:`edl_tpu_torch.examples.distill_teacher`, which decodes it
without flax).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import urllib.error
import urllib.request
from typing import Optional

from edl_tpu_torch.utils.log import get_logger

logger = get_logger(__name__)

_DEFAULT_CACHE = os.path.join(
    os.path.expanduser("~"), ".cache", "edl_tpu", "models"
)
_CHUNK = 1 << 20


class FetchError(RuntimeError):
    """Model fetch failed (bad URI, transport error, checksum mismatch)."""


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _verify(path: str, sha256: Optional[str]) -> None:
    if sha256 is None:
        return
    got = sha256_of(path)
    if got != sha256.lower():
        raise FetchError(
            "checksum mismatch for %s: want %s got %s" % (path, sha256, got)
        )


def _tmp_for(dest: str) -> str:
    # per-process temp file in the destination dir: concurrent fetchers of
    # the same URI each write privately and the os.replace really is atomic
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(dest) + ".", suffix=".part",
        dir=os.path.dirname(dest),
    )
    os.close(fd)
    return tmp


def _http_download(uri: str, dest: str, timeout: float, retries: int) -> None:
    last: Optional[Exception] = None
    for attempt in range(retries):
        tmp = _tmp_for(dest)
        try:
            with urllib.request.urlopen(uri, timeout=timeout) as resp, open(
                tmp, "wb"
            ) as out:
                shutil.copyfileobj(resp, out, _CHUNK)
                # fsync before the atomic rename: a torn model file that
                # *looks* complete would fail sha256 verification only
                # after a worker already spent its restage budget on it
                out.flush()
                os.fsync(out.fileno())
            os.replace(tmp, dest)
            return
        except Exception as exc:  # noqa: BLE001 — urllib raises many types
            last = exc
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if (
                isinstance(exc, urllib.error.HTTPError)
                and 400 <= exc.code < 500
            ):
                break  # 404/403 won't get better with retries
            logger.warning(
                "fetch attempt %d/%d for %s failed: %s",
                attempt + 1, retries, uri, exc,
            )
            time.sleep(min(2.0 ** attempt, 10.0))
    raise FetchError("download failed for %s: %s" % (uri, last))


def _gs_download(uri: str, dest: str) -> None:
    gsutil = shutil.which("gsutil")
    if gsutil is None:
        raise FetchError(
            "gs:// URI %s requires gsutil on PATH (not available in this "
            "environment); serve the artifact over http(s) instead" % uri
        )
    tmp = _tmp_for(dest)
    proc = subprocess.run(
        [gsutil, "cp", uri, tmp], capture_output=True, text=True
    )
    if proc.returncode != 0:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise FetchError(
            "gsutil cp %s failed: %s" % (uri, proc.stderr[-400:])
        )
    os.replace(tmp, dest)


def fetch_model(
    uri: str,
    sha256: Optional[str] = None,
    cache_dir: Optional[str] = None,
    timeout: float = 600.0,
    retries: int = 3,
) -> str:
    """Fetch ``uri`` into the local cache and return the local path.

    Local paths (and ``file://``) are verified in place and returned
    without copying. Remote URIs land in
    ``{cache}/{sha256-or-uri-hash}/{basename}``; a cached file whose
    checksum still matches short-circuits the download entirely.
    """
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    if "://" not in uri:
        if not os.path.exists(uri):
            raise FetchError("local model path %s does not exist" % uri)
        _verify(uri, sha256)
        return uri

    cache_dir = cache_dir or os.environ.get(
        "EDL_DISTILL_MODEL_CACHE", _DEFAULT_CACHE
    )
    key = (sha256 or hashlib.sha256(uri.encode()).hexdigest())[:32]
    name = os.path.basename(uri.split("?", 1)[0]) or "model"
    dest_dir = os.path.join(cache_dir, key)
    dest = os.path.join(dest_dir, name)
    if os.path.exists(dest):
        try:
            _verify(dest, sha256)
            logger.info("model cache hit: %s", dest)
            return dest
        except FetchError:
            logger.warning("cached %s fails checksum; re-fetching", dest)
            os.unlink(dest)

    os.makedirs(dest_dir, exist_ok=True)
    scheme = uri.split("://", 1)[0]
    if scheme in ("http", "https"):
        _http_download(uri, dest, timeout, retries)
    elif scheme == "gs":
        _gs_download(uri, dest)
    else:
        raise FetchError("unsupported scheme %r in %s" % (scheme, uri))
    try:
        _verify(dest, sha256)
    except FetchError:
        os.unlink(dest)  # never leave a corrupt artifact in the cache
        raise
    logger.info("fetched %s -> %s", uri, dest)
    return dest


def fetch_from_env() -> Optional[str]:
    """Fetch the teacher model named by ``EDL_DISTILL_MODEL_URI`` (the
    reference reads its HDFS coordinates from env the same way); returns
    None when unset so callers can fall back to fresh init."""
    uri = os.environ.get("EDL_DISTILL_MODEL_URI")
    if not uri:
        return None
    return fetch_model(uri, sha256=os.environ.get("EDL_DISTILL_MODEL_SHA256"))
