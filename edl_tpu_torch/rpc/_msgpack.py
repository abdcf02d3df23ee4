"""A small msgpack codec for the subset the wire protocol uses.

The protocol's frame bodies are maps, arrays, str, bin, int, float, bool
and nil; bulk arrays ride EDL2 attachments outside the body
(:mod:`edl_tpu_torch.rpc.ndarray`), so bodies stay small and a pure-Python
codec is fast enough. ``packb`` is byte-identical to
``msgpack.packb(obj, use_bin_type=True)`` on that subset (smallest
encoding for every int and length, float64 for every float); ``unpackb``
matches ``msgpack.unpackb(body, raw=False, strict_map_key=False)``,
arrays decoding as lists. ``unpackb`` also reads the ext types, handing
each ``(code, data)`` to ``ext_hook`` (flax's ``to_bytes`` artifacts
carry their arrays so: :mod:`edl_tpu_torch.convert`).
"""

from __future__ import annotations

import struct

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


def _pack_int(obj: int, out: bytearray) -> None:
    if 0 <= obj < 0x80:
        out.append(obj)
    elif -0x20 <= obj < 0:
        out.append(obj & 0xFF)
    elif 0 <= obj <= 0xFF:
        out += b"\xcc" + _B.pack(obj)
    elif 0 <= obj <= 0xFFFF:
        out += b"\xcd" + _H.pack(obj)
    elif 0 <= obj <= 0xFFFFFFFF:
        out += b"\xce" + _I.pack(obj)
    elif 0 <= obj <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + _Q.pack(obj)
    elif -0x80 <= obj < 0:
        out += b"\xd0" + _b.pack(obj)
    elif -0x8000 <= obj < 0:
        out += b"\xd1" + _h.pack(obj)
    elif -0x80000000 <= obj < 0:
        out += b"\xd2" + _i.pack(obj)
    elif -0x8000000000000000 <= obj < 0:
        out += b"\xd3" + _q.pack(obj)
    else:
        raise OverflowError("int %d does not fit msgpack" % obj)


def _pack_len(n: int, fix: int, fix_max: int, c8, c16: bytes, c32: bytes,
              out: bytearray) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n <= 0xFF:
        out += c8 + _B.pack(n)
    elif n <= 0xFFFF:
        out += c16 + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += c32 + _I.pack(n)
    else:
        raise ValueError("msgpack length %d too large" % n)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, b"\xd9", b"\xda", b"\xdb", out)
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = memoryview(obj).cast("B") if isinstance(obj, memoryview) else obj
        n = len(raw)
        if n <= 0xFF:
            out += b"\xc4" + _B.pack(n)
        elif n <= 0xFFFF:
            out += b"\xc5" + _H.pack(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xc6" + _I.pack(n)
        else:
            raise ValueError("msgpack bin length %d too large" % n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, None, b"\xdc", b"\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, None, b"\xde", b"\xdf", out)
        for key, val in obj.items():
            _pack(key, out)
            _pack(val, out)
    else:
        raise TypeError("can not serialize %r object" % type(obj).__name__)


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _no_ext(code: int, data: bytes):
    raise ValueError("msgpack ext type %d with no ext_hook" % code)


class _Reader:
    __slots__ = ("buf", "pos", "ext_hook")

    def __init__(self, buf, ext_hook=_no_ext) -> None:
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack body")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]


# (struct, kind) for the fixed-width headers; kind says what follows
_HEADS = {
    0xC4: (_B, "bin"), 0xC5: (_H, "bin"), 0xC6: (_I, "bin"),
    0xCA: (_f, "val"), 0xCB: (_d, "val"),
    0xCC: (_B, "val"), 0xCD: (_H, "val"), 0xCE: (_I, "val"),
    0xCF: (_Q, "val"), 0xD0: (_b, "val"), 0xD1: (_h, "val"),
    0xD2: (_i, "val"), 0xD3: (_q, "val"),
    0xD9: (_B, "str"), 0xDA: (_H, "str"), 0xDB: (_I, "str"),
    0xDC: (_H, "array"), 0xDD: (_I, "array"),
    0xDE: (_H, "map"), 0xDF: (_I, "map"),
    0xC7: (_B, "ext"), 0xC8: (_H, "ext"), 0xC9: (_I, "ext"),
}
# fixext 1, 2, 4, 8, 16: the data's length
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}



def _unpack(rd: _Reader):
    tag = rd.take(1)[0]
    if tag < 0x80:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if tag <= 0x8F:
        return _unpack_map(rd, tag & 0x0F)
    if tag <= 0x9F:
        return [_unpack(rd) for _ in range(tag & 0x0F)]
    if tag <= 0xBF:
        return str(rd.take(tag & 0x1F), "utf-8")
    if tag == 0xC0:
        return None
    if tag == 0xC2:
        return False
    if tag == 0xC3:
        return True
    if tag in _FIXEXT:
        code = rd.unpack(_b)
        return rd.ext_hook(code, bytes(rd.take(_FIXEXT[tag])))
    head = _HEADS.get(tag)
    if head is None:
        raise ValueError("unsupported msgpack type 0x%02x" % tag)
    st, kind = head
    n = rd.unpack(st)
    if kind == "val":
        return n
    if kind == "bin":
        return bytes(rd.take(n))
    if kind == "str":
        return str(rd.take(n), "utf-8")
    if kind == "array":
        return [_unpack(rd) for _ in range(n)]
    if kind == "ext":
        code = rd.unpack(_b)
        return rd.ext_hook(code, bytes(rd.take(n)))
    return _unpack_map(rd, n)


def _unpack_map(rd: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _unpack(rd)
        out[key] = _unpack(rd)
    return out


def unpackb(body, ext_hook=_no_ext):
    rd = _Reader(body, ext_hook)
    obj = _unpack(rd)
    if rd.pos != len(rd.buf):
        raise ValueError("extra data after msgpack object")
    return obj
