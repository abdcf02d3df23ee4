"""Framed-TCP wire protocol shared by all edl_tpu control-plane services.

The port's copy of ``edl_tpu/rpc/wire.py``: the same EDL1/EDL2 framing,
byte for byte, so a port process and a JAX-package process talk to each
other. Bodies go through the in-tree codec (:mod:`._msgpack`), and the
chaos fault points are not carried.

One frame = an 8-byte header (4-byte magic ``EDL1`` + uint32-LE payload
length) followed by a msgpack-encoded payload. The same framing is spoken by
the Python services and the native C++ runtime (``native/``), so either side
of any control-plane connection can be swapped for its native twin.

This replaces BOTH of the reference's control-plane transports — gRPC/
protobuf services (pod_server.proto, data_server.proto,
distill_discovery.proto) and the hand-rolled epoll JSON protocol with CRC
magic ``\\xCB\\xEF\\x00\\x00`` (python/edl/distill/redis/balance_server.py:
40-216) — with a single codegen-free protocol.

Payload conventions (by example, not schema):
  request:  {"i": <id>, "m": <method>, ...params}
  response: {"i": <id>, "ok": true, ...result}
  error:    {"i": <id>, "ok": false, "err": {"etype": ..., "detail": ...}}
  push:     {"w": <watch_id>, "ev": [...]}          (server-initiated)

Bulk-data frames (``EDL2``) carry raw binary attachments after the msgpack
body — header = magic + uint32 total_len + uint32 body_len. The body
references attachments by offset (see ``edl_tpu_torch.rpc.ndarray`` ndrefs), so
large arrays ride the socket via scatter/gather I/O with no intermediate
copies: the predict path moves teacher batches at memcpy speed instead of
re-buffering them through msgpack. ``EDL1``-only peers (the native C++
master) never see EDL2 — it is used only on array-bearing connections.
"""

from __future__ import annotations

import struct
import time as _time
from typing import List, Optional, Sequence

from edl_tpu_torch.obs import trace as _obs_trace
from edl_tpu_torch.obs.metrics import counter as _counter
from edl_tpu_torch.obs.metrics import histogram as _histogram
from edl_tpu_torch.rpc import _msgpack

# label-resolved children: one dict hit per frame on the hot path
_TX_FRAMES = _counter(
    "edl_rpc_tx_frames_total", "wire frames encoded for send"
).labels()
_TX_BYTES = _counter(
    "edl_rpc_tx_bytes_total", "wire bytes encoded for send (header+body+attachments)"
).labels()
_RX_FRAMES = _counter(
    "edl_rpc_rx_frames_total", "wire frames decoded from the socket"
).labels()
_RX_BYTES = _counter(
    "edl_rpc_rx_bytes_total", "wire bytes decoded from the socket"
).labels()

# distributed tracing (obs/trace.py): requests may carry a "tc" field
# ([trace_id, span_id] of the caller's current span); servers wrap their
# handlers in server_span() so the handling span is a child of it AND
# every wire server exports per-method tail latency. Injection call
# sites guard on _TC.armed — one attribute load per frame disarmed.
_TC = _obs_trace.PROPAGATION
TC_FIELD = "tc"

SERVER_SECONDS = _histogram(
    "edl_rpc_server_seconds",
    "server-side RPC handling time, by method and server "
    "(store/data/distill/cache)",
)

# label-resolved children, keyed (method, server): methods here are
# SERVER-defined (call sites wrap only resolved handlers, never a
# client-supplied unknown method string), so the cache is bounded
_SERVER_BOUND: dict = {}


def _server_bound(method: str, server: str):
    child = _SERVER_BOUND.get((method, server))
    if child is None:
        child = _SERVER_BOUND[(method, server)] = SERVER_SECONDS.labels(
            method=method, server=server
        )
    return child


class _ServerSpan:
    """Context manager timing one server-side RPC dispatch into
    ``edl_rpc_server_seconds{method,server}`` and — when the caller
    propagated a trace context — recording the handling interval as a
    child span of the caller's span. Slot-based, no generator frame:
    this sits on every wire server's per-frame hot path. A malformed
    ``tc`` degrades to an unlinked timing."""

    __slots__ = ("_method", "_tc", "_server", "_t0", "_cm")

    def __init__(self, method: str, tc, server: str) -> None:
        self._method = method
        self._tc = tc
        self._server = server

    def __enter__(self) -> "_ServerSpan":
        self._t0 = _time.monotonic()
        self._cm = None
        if self._tc and _TC.armed:
            ctx = _obs_trace.context_from_wire(self._tc)
            if ctx is not None:
                self._cm = _obs_trace.child_span(
                    "rpc:%s" % self._method, tc=ctx, server=self._server
                )
                self._cm.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._cm is not None:
            self._cm.__exit__(exc_type, exc, tb)
        _server_bound(self._method, self._server).observe(
            _time.monotonic() - self._t0
        )


def server_span(method: str, tc=None, server: str = "") -> _ServerSpan:
    """See :class:`_ServerSpan`; ``tc`` is the raw ``"tc"`` payload
    field (or None)."""
    return _ServerSpan(method, tc, server)


MAGIC = b"EDL1"
MAGIC2 = b"EDL2"
_HEADER = struct.Struct("<4sI")
_HEADER2 = struct.Struct("<4sII")
HEADER_SIZE = _HEADER.size
HEADER2_SIZE = _HEADER2.size
MAX_FRAME = 512 * 1024 * 1024  # bound a corrupt length field


class WireError(Exception):
    pass


def pack_frame(payload: dict) -> bytes:
    body = _msgpack.packb(payload)
    _TX_FRAMES.inc()
    _TX_BYTES.inc(HEADER_SIZE + len(body))
    return _HEADER.pack(MAGIC, len(body)) + body


def pack_frame_buffers(
    payload: dict, attachments: Sequence[memoryview]
) -> List:
    """EDL2 frame as a buffer list for scatter/gather send — the large
    attachments are NOT copied into the frame."""
    body = _msgpack.packb(payload)
    total = len(body) + sum(a.nbytes for a in attachments)
    if total > MAX_FRAME:
        raise WireError("frame length %d exceeds limit" % total)
    _TX_FRAMES.inc()
    _TX_BYTES.inc(HEADER2_SIZE + total)
    header = _HEADER2.pack(MAGIC2, total, len(body))
    return [header, body, *attachments]


def send_buffers(sock, buffers: List) -> None:
    """sendmsg the buffer list, handling partial sends and IOV limits."""
    # drop zero-length views: sendmsg reports 0 bytes for them, which is
    # indistinguishable from no progress
    views = [v for b in buffers if (v := memoryview(b).cast("B")).nbytes]
    while views:
        sent = sock.sendmsg(views[:64])
        while sent:
            if sent >= views[0].nbytes:
                sent -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def unpack_payload(body: bytes) -> dict:
    return _msgpack.unpackb(body)


class FrameReader:
    """Incremental frame decoder for a nonblocking byte stream.

    Feed it whatever ``recv`` returned; it yields complete decoded payloads
    and buffers the remainder.
    """

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[dict]:
        self._buf.extend(data)
        out: List[dict] = []
        while True:
            payload = self._try_next()
            if payload is None:
                return out
            out.append(payload)

    def _try_next(self) -> Optional[dict]:
        if len(self._buf) < HEADER_SIZE:
            return None
        magic, length = _HEADER.unpack_from(self._buf, 0)
        if magic == MAGIC2:
            if len(self._buf) < HEADER2_SIZE:
                return None
            _, total, body_len = _HEADER2.unpack_from(self._buf, 0)
            if total > MAX_FRAME or body_len > total:
                raise WireError("bad EDL2 lengths %d/%d" % (body_len, total))
            end = HEADER2_SIZE + total
            if len(self._buf) < end:
                return None
            body = bytes(self._buf[HEADER2_SIZE : HEADER2_SIZE + body_len])
            atts = bytes(self._buf[HEADER2_SIZE + body_len : end])
            del self._buf[:end]
            _RX_FRAMES.inc()
            _RX_BYTES.inc(end)
            from edl_tpu_torch.rpc.ndarray import resolve_ndrefs

            return resolve_ndrefs(unpack_payload(body), memoryview(atts))
        if magic != MAGIC:
            raise WireError("bad frame magic %r" % magic)
        if length > MAX_FRAME:
            raise WireError("frame length %d exceeds limit" % length)
        end = HEADER_SIZE + length
        if len(self._buf) < end:
            return None
        body = bytes(self._buf[HEADER_SIZE:end])
        del self._buf[:end]
        _RX_FRAMES.inc()
        _RX_BYTES.inc(end)
        return unpack_payload(body)


def read_frame_blocking(sock) -> dict:
    """Read exactly one frame (EDL1 or EDL2) from a blocking socket.

    For EDL2 the whole frame lands in ONE buffer and ndarray refs in the
    payload are resolved to zero-copy views over it."""
    header = _recv_exact(sock, HEADER_SIZE)
    magic, length = _HEADER.unpack(header)
    if magic == MAGIC2:
        extra = _recv_exact(sock, HEADER2_SIZE - HEADER_SIZE)
        total, body_len = length, struct.unpack("<I", extra)[0]
        if total > MAX_FRAME or body_len > total:
            raise WireError("bad EDL2 lengths %d/%d" % (body_len, total))
        buf = bytearray(total)
        _recv_exact_into(sock, memoryview(buf))
        _RX_FRAMES.inc()
        _RX_BYTES.inc(HEADER2_SIZE + total)
        payload = unpack_payload(bytes(buf[:body_len]))
        from edl_tpu_torch.rpc.ndarray import resolve_ndrefs

        # toreadonly: both receive paths hand out immutable views
        return resolve_ndrefs(
            payload, memoryview(buf)[body_len:].toreadonly()
        )
    if magic != MAGIC:
        raise WireError("bad frame magic %r" % magic)
    if length > MAX_FRAME:
        raise WireError("frame length %d exceeds limit" % length)
    body = _recv_exact(sock, length)
    _RX_FRAMES.inc()
    _RX_BYTES.inc(HEADER_SIZE + length)
    return unpack_payload(body)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_exact_into(sock, view: memoryview) -> None:
    while view.nbytes:
        got = sock.recv_into(view)
        if not got:
            raise ConnectionError("peer closed during frame read")
        view = view[got:]
