"""The msgpack subset the wire layer speaks, byte-compatible with msgpack 1.x.

The port runs on hosts that have no ``msgpack`` package, yet its frames
must be byte-identical to the reference's (``packb(obj,
use_bin_type=True)`` / ``unpackb(buf, raw=False)``).  This module packs
and unpacks exactly the types those frames carry:

- ``None``, ``bool``, ``int`` (the smallest encoding: positive ints as
  fixint/uint8..uint64, negative ints as negative fixint/int8..int64);
- ``float`` (always the 9-byte float64 form, as msgpack-python packs it);
- ``str`` (fixstr/str8/str16/str32, UTF-8), ``bytes``/``bytearray``/
  ``memoryview`` (bin8/bin16/bin32);
- ``list``/``tuple`` (fixarray/array16/array32) and ``dict``
  (fixmap/map16/map32, insertion order kept).

Subclasses pack as their base type (msgpack's default, non-strict mode),
so a ``numpy.float64`` packs as a float.  ``unpackb`` accepts any buffer,
a ``memoryview`` included; bin payloads come back as ``bytes`` copies and
arrays as lists.  Marker bytes are written in decimal where they would
fall in 0xF0-0xFF, the range the wire reserves for codec version bytes.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple, Union

Buffer = Union[bytes, bytearray, memoryview]

_NIL, _FALSE, _TRUE = 0xC0, 0xC2, 0xC3
_BIN8, _BIN16, _BIN32 = 0xC4, 0xC5, 0xC6
_FLOAT32, _FLOAT64 = 0xCA, 0xCB
_UINT8, _UINT16, _UINT32, _UINT64 = 0xCC, 0xCD, 0xCE, 0xCF
_INT8, _INT16, _INT32, _INT64 = 0xD0, 0xD1, 0xD2, 0xD3
_STR8, _STR16, _STR32 = 0xD9, 0xDA, 0xDB
_ARRAY16, _ARRAY32 = 0xDC, 0xDD
_MAP16, _MAP32 = 0xDE, 0xDF
_NEG_FIXINT = 224          # 0xE0: first byte of the negative fixints

_INT_FORMATS = {_UINT8: ">B", _UINT16: ">H", _UINT32: ">I", _UINT64: ">Q",
                _INT8: ">b", _INT16: ">h", _INT32: ">i", _INT64: ">q"}


class ExtraData(ValueError):
    """Bytes remain after one complete object (msgpack's ``ExtraData``)."""


def packb(obj: Any, use_bin_type: bool = True) -> bytes:
    """Serialize ``obj`` exactly as ``msgpack.packb(obj,
    use_bin_type=True)`` does."""
    if not use_bin_type:
        raise ValueError("only use_bin_type=True is supported")
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack_len(n: int, fix_base: int, fix_max: int, markers, out) -> None:
    """Length header: fix form below ``fix_max``, else 8/16/32-bit forms
    (``markers`` lists them from the narrowest; None where absent)."""
    if fix_base is not None and n < fix_max:
        out.append(bytes((fix_base | n,)))
        return
    for marker, fmt, limit in zip(markers, (">B", ">H", ">I"),
                                  (1 << 8, 1 << 16, 1 << 32)):
        if marker is not None and n < limit:
            out.append(bytes((marker,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack_int(v: int, out) -> None:
    if 0 <= v < 128:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for marker, limit in ((_UINT8, 1 << 8), (_UINT16, 1 << 16),
                              (_UINT32, 1 << 32), (_UINT64, 1 << 64)):
            if v < limit:
                out.append(bytes((marker,)) + struct.pack(
                    _INT_FORMATS[marker], v))
                return
        raise OverflowError("Integer value out of range")
    else:
        for marker, limit in ((_INT8, 1 << 7), (_INT16, 1 << 15),
                              (_INT32, 1 << 31), (_INT64, 1 << 63)):
            if v >= -limit:
                out.append(bytes((marker,)) + struct.pack(
                    _INT_FORMATS[marker], v))
                return
        raise OverflowError("Integer value out of range")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(bytes((_NIL,)))
    elif isinstance(obj, bool):
        out.append(bytes((_TRUE if obj else _FALSE,)))
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(bytes((_FLOAT64,)) + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, (_STR8, _STR16, _STR32), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = obj.cast("B") if isinstance(obj, memoryview) else obj
        _pack_len(len(b), None, 0, (_BIN8, _BIN16, _BIN32), out)
        out.append(bytes(b))
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, _ARRAY16, _ARRAY32), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, _MAP16, _MAP32), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def unpackb(buf: Buffer, raw: bool = False) -> Any:
    """Deserialize one object, as ``msgpack.unpackb(buf, raw=False)``."""
    if raw:
        raise ValueError("only raw=False is supported")
    mv = memoryview(buf).cast("B")
    obj, pos = _unpack(mv, 0)
    if pos != len(mv):
        raise ExtraData(f"{len(mv) - pos} bytes of extra data")
    return obj


def _take(mv: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    end = pos + n
    if end > len(mv):
        raise ValueError("msgpack buffer truncated")
    return mv[pos:end], end


def _unpack(mv: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(mv):
        raise ValueError("msgpack buffer truncated")
    b = mv[pos]
    pos += 1
    if b < 128:
        return b, pos
    if b >= _NEG_FIXINT:
        return b - 256, pos
    if b < 0x90:
        return _unpack_map(mv, pos, b & 0x0F)
    if b < 0xA0:
        return _unpack_array(mv, pos, b & 0x0F)
    if b < _NIL:
        s, pos = _take(mv, pos, b & 0x1F)
        return str(s, "utf-8"), pos
    if b == _NIL:
        return None, pos
    if b == _FALSE:
        return False, pos
    if b == _TRUE:
        return True, pos
    if b in (_BIN8, _BIN16, _BIN32, _STR8, _STR16, _STR32):
        fmt = {_BIN8: ">B", _BIN16: ">H", _BIN32: ">I",
               _STR8: ">B", _STR16: ">H", _STR32: ">I"}[b]
        hdr, pos = _take(mv, pos, struct.calcsize(fmt))
        (n,) = struct.unpack(fmt, hdr)
        body, pos = _take(mv, pos, n)
        if b in (_STR8, _STR16, _STR32):
            return str(body, "utf-8"), pos
        return bytes(body), pos
    if b == _FLOAT32:
        body, pos = _take(mv, pos, 4)
        return struct.unpack(">f", body)[0], pos
    if b == _FLOAT64:
        body, pos = _take(mv, pos, 8)
        return struct.unpack(">d", body)[0], pos
    if b in _INT_FORMATS:
        fmt = _INT_FORMATS[b]
        body, pos = _take(mv, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, body)[0], pos
    if b in (_ARRAY16, _ARRAY32, _MAP16, _MAP32):
        fmt = ">H" if b in (_ARRAY16, _MAP16) else ">I"
        hdr, pos = _take(mv, pos, struct.calcsize(fmt))
        (n,) = struct.unpack(fmt, hdr)
        if b in (_ARRAY16, _ARRAY32):
            return _unpack_array(mv, pos, n)
        return _unpack_map(mv, pos, n)
    raise ValueError(f"unsupported msgpack marker {b:#04x}")


def _unpack_array(mv: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        x, pos = _unpack(mv, pos)
        out.append(x)
    return out, pos


def _unpack_map(mv: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(mv, pos)
        if not isinstance(k, (str, bytes)):
            # msgpack's strict_map_key default
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        v, pos = _unpack(mv, pos)
        out[k] = v
    return out, pos
