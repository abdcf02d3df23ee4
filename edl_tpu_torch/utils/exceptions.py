"""Exception hierarchy + wire (de)serialization.

Capability parity with the reference's ``EdlException`` family and its
serialize-by-name / re-raise-on-client scheme
(python/edl/utils/exceptions.py:20-57, protos/common.proto:20-23). Here the
wire form is a plain ``{"etype": ..., "detail": ...}`` dict carried inside
the framed-RPC error response instead of a protobuf Status.
"""

from __future__ import annotations


class EdlError(Exception):
    """Base class for all edl_tpu_torch errors."""


class EdlRegisterError(EdlError):
    pass


class EdlBarrierError(EdlError):
    pass


class EdlRankError(EdlError):
    pass


class EdlLeaderError(EdlError):
    pass


class EdlStoreError(EdlError):
    pass


class EdlLeaseExpiredError(EdlStoreError):
    pass


class EdlCompactedError(EdlStoreError):
    """A watch-resume revision has been compacted out of the history ring."""


class EdlConnectionError(EdlStoreError):
    pass


class EdlNotPrimaryError(EdlConnectionError):
    """The contacted store is a warm standby: it replicates but does not
    serve. Subclasses ``EdlConnectionError`` so every existing retry path
    treats it as "try again" — the client advances to the next endpoint
    first, so the retry lands on the primary."""


class EdlFencedError(EdlConnectionError):
    """The contacted store was fenced by a higher epoch (a standby
    promoted past it). Like :class:`EdlNotPrimaryError`, retry-shaped:
    clients fail over to the promoted primary."""


class EdlDataError(EdlError):
    pass


class EdlStopIteration(EdlError):
    """Distill pipeline sentinel: the remote generator is exhausted."""


class EdlInternalError(EdlError):
    pass


class EdlOverloadError(EdlError):
    """The teacher shed this request at admission (queue full, or the
    deadline-aware admission test predicted a miss). Deliberately NOT a
    subclass of :class:`EdlConnectionError`: overload means the server is
    alive and telling you to back off — retry machinery must meter it
    against a budget instead of hammering the same endpoint."""

    def __init__(
        self, detail: str = "", qdepth: int = 0, est_wait_ms: float = 0.0
    ) -> None:
        super().__init__(detail)
        self.qdepth = qdepth
        self.est_wait_ms = est_wait_ms


_BY_NAME = {
    cls.__name__: cls
    for cls in (
        EdlError,
        EdlRegisterError,
        EdlBarrierError,
        EdlRankError,
        EdlLeaderError,
        EdlStoreError,
        EdlLeaseExpiredError,
        EdlCompactedError,
        EdlConnectionError,
        EdlNotPrimaryError,
        EdlFencedError,
        EdlDataError,
        EdlStopIteration,
        EdlInternalError,
        EdlOverloadError,
    )
}


def serialize_exception(exc: BaseException) -> dict:
    return {"etype": type(exc).__name__, "detail": str(exc)}


def deserialize_exception(status: dict) -> Exception:
    cls = _BY_NAME.get(status.get("etype", ""), EdlInternalError)
    return cls(status.get("detail", ""))


def raise_from_status(status: dict) -> None:
    raise deserialize_exception(status)
