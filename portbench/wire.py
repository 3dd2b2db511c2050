"""The site's fit result as it arrives at the server: a frozen copy of the
program's 0xF5 writer (``fl/messages.py``, ``_sparse_frame`` with COO
indices and int8 values), which writes the frame from the indices, values
and scales the benchmark drew instead of taking a TopK itself.

Frame: ``[0xF5][u32 header length][msgpack header][zeros to 64 bytes]
[indices int64][scales fp32][values int8]``; the header holds the leaf
signature ``l``, the example count ``n``, the metrics ``m``, and ``d`` (a
delta), ``im`` (``"c"``: COO), ``nz`` (values), ``vm`` (``"q8"``) and
``qc`` (values a scale), in that order.
"""
from __future__ import annotations

import struct
from typing import Any, List, Sequence, Tuple

import numpy as np

SPARSE_MAGIC = 0xF5
QCHUNK = 1024
_ALIGN = 64


def _len(n: int, fix: int, fix_max: int, markers, out: List[bytes]) -> None:
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    for marker, fmt, limit in zip(markers, (">B", ">H", ">I"),
                                  (1 << 8, 1 << 16, 1 << 32)):
        if marker is not None and n < limit:
            out.append(bytes((marker,)) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} too large for msgpack")


def _int(v: int, out: List[bytes]) -> None:
    if 0 <= v < 128:
        out.append(bytes((v,)))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for marker, fmt, limit in ((0xCC, ">B", 1 << 8),
                                   (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32),
                                   (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes((marker,)) + struct.pack(fmt, v))
                return
        raise OverflowError(v)
    else:
        for marker, fmt, limit in ((0xD0, ">b", 1 << 7),
                                   (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31),
                                   (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(bytes((marker,)) + struct.pack(fmt, v))
                return
        raise OverflowError(v)


def _pack(obj: Any, out: List[bytes]) -> None:
    """msgpack with ``use_bin_type=True``, for what a header holds."""
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (list, tuple)):
        _len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(type(obj).__name__)


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def sparse_frame(leaves: Sequence[Tuple[int, ...]], num_examples: int,
                 indices: np.ndarray, values: np.ndarray,
                 scales: np.ndarray) -> bytes:
    """The 0xF5 frame of a TopK delta of an fp32 model with ``leaves``
    (shapes): ``indices`` sorted unique int64, ``values`` int8, one fp32
    scale per :data:`QCHUNK` values."""
    assert indices.dtype == np.int64 and values.dtype == np.int8 \
        and scales.dtype == np.float32
    assert scales.size == -(-values.size // QCHUNK)
    head = {"l": [["float32", [int(s) for s in shape]] for shape in leaves],
            "n": int(num_examples), "m": {}, "d": 1, "im": "c",
            "nz": int(values.size), "vm": "q8", "qc": QCHUNK}
    h = packb(head)
    off = -(-(5 + len(h)) // _ALIGN) * _ALIGN
    prefix = bytes((SPARSE_MAGIC,)) + struct.pack("<I", len(h)) + h \
        + b"\x00" * (off - 5 - len(h))
    return b"".join((prefix,) + tuple(
        memoryview(np.ascontiguousarray(a).view(np.uint8))
        for a in (indices, scales, values)))
