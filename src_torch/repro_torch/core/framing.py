"""Length-prefixed binary framing for the socket transport.

Wire layout (little-endian)::

    [u32 length][u8 ftype][payload ...]        # length = 1 + len(payload)

Control frames (payload is one msgpack map):

    ========  ====  ==============  =========================================
    HELLO     0x01  client->server  {"node": str, "proto": int}
    WELCOME   0x02  server->client  {"credits": int, "max_frame": int,
                                     "hb": float}
    CREDIT    0x03  server->client  {"n": int}
    PING      0x04  either          {"t": float}  (opaque echo token)
    PONG      0x05  either          {"t": float}
    BYE       0x06  either          {"reason": str}
    ========  ====  ==============  =========================================

Data frames (payload = ``[u32 hlen][msgpack header][raw body]``):

    ========  ====  ==============  =========================================
    REQ       0x10  client->server  header {"i": msg_id, "m": method, ...}
    RES       0x11  server->client  header {"i": msg_id, "e": err, "k": kind}
    ========  ====  ==============  =========================================

The raw body rides *after* the msgpack header so model-size TaskIns/TaskRes
bytes are never re-serialized through msgpack: the receiver fills one
exact-size buffer per frame and hands the body up as a **read-only
memoryview** — the 0xF1–0xF4 codec frames inside it decode zero-copy via
``np.frombuffer`` straight off that buffer (views frozen per the aliasing
invariant, docs/INVARIANTS.md).  Frame-type bytes stay below ``0xF0`` on
purpose: the codec-byte registry in ``repro_torch.fl.flat`` owns 0xF0–0xFF.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from repro_torch.utils import msgpack_lite

# frame types (codec registry owns 0xF0-0xFF; these must stay below it)
FT_HELLO = 0x01
FT_WELCOME = 0x02
FT_CREDIT = 0x03
FT_PING = 0x04
FT_PONG = 0x05
FT_BYE = 0x06
FT_REQ = 0x10
FT_RES = 0x11

PROTO_VERSION = 1
DEFAULT_MAX_FRAME = 256 << 20            # one corrupt length prefix must
#                                          not allocate unbounded memory

_LEN = struct.Struct("<I")               # frame length prefix
_HLEN = struct.Struct("<I")              # data-frame header length


class FrameError(ValueError):
    """Malformed or protocol-violating frame; the connection is torn down
    (never silently resynchronized — a desynced length prefix would turn
    payload bytes into frame headers)."""


class FrameReader:
    """Incremental frame decoder: survives arbitrary chunking (partial
    reads) because each ``feed``/``read_from`` step just fills the current
    target buffer — the 4-byte length prefix, then one exact-size frame
    buffer.  Every frame gets its *own* buffer, so the emitted read-only
    payload views never alias a later frame or any shared stream buffer,
    and a zero-copy ``np.frombuffer`` decode can outlive the reader.

    Not thread-safe: one reader per connection, fed by that connection's
    single reader thread.
    """

    def __init__(self, max_frame: int = DEFAULT_MAX_FRAME):
        self.max_frame = int(max_frame)
        self._buf = bytearray(_LEN.size)     # current target: prefix|frame
        self._is_prefix = True
        self._got = 0

    def _advance(self, n: int,
                 out: List[Tuple[int, memoryview]]) -> None:
        self._got += n
        if self._got < len(self._buf):
            return                           # target still partial
        if self._is_prefix:
            need = _LEN.unpack(self._buf)[0]
            if not 1 <= need <= self.max_frame:
                raise FrameError(f"frame length {need} outside "
                                 f"[1, {self.max_frame}]")
            self._buf = bytearray(need)
            self._is_prefix = False
        else:
            frame = self._buf
            self._buf = bytearray(_LEN.size)
            self._is_prefix = True
            out.append((frame[0], memoryview(frame)[1:].toreadonly()))
        self._got = 0

    def feed(self, chunk: bytes) -> List[Tuple[int, memoryview]]:
        """Consume one received chunk; return the ``(ftype, payload)``
        frames it completed (possibly none, possibly several)."""
        out: List[Tuple[int, memoryview]] = []
        mv = memoryview(chunk)
        while mv.nbytes:
            take = min(len(self._buf) - self._got, mv.nbytes)
            self._buf[self._got:self._got + take] = mv[:take]
            mv = mv[take:]
            self._advance(take, out)
        return out

    def read_from(self, sock) -> Optional[List[Tuple[int, memoryview]]]:
        """One ``recv_into`` step straight into the current frame buffer
        (no intermediate chunk copy).  Returns completed frames (possibly
        an empty list), or ``None`` on clean EOF at a frame boundary.
        Raises ``ConnectionError`` if the peer closed mid-frame, and lets
        ``socket.timeout`` propagate with the partial state intact — the
        caller's heartbeat tick resumes the same frame on the next call.
        """
        n = sock.recv_into(memoryview(self._buf)[self._got:])
        if n == 0:
            if self._is_prefix and self._got == 0:
                return None
            raise ConnectionError("peer closed mid-frame")
        out: List[Tuple[int, memoryview]] = []
        self._advance(n, out)
        return out


# --------------------------------------------------------------------- write
def control_frame(ftype: int, fields: Dict[str, object]) -> bytes:
    """One control frame (msgpack-map payload), ready to send."""
    payload = msgpack_lite.packb(fields, use_bin_type=True)
    return _LEN.pack(1 + len(payload)) + bytes((ftype,)) + payload


def data_frame_parts(ftype: int, header: Dict[str, object],
                     body) -> Tuple[bytes, ...]:
    """A REQ/RES frame as ``(prefix, body)`` buffer parts: the raw body is
    referenced, never copied into the frame — callers hand both parts to
    :func:`send_parts`."""
    h = msgpack_lite.packb(header, use_bin_type=True)
    nbody = len(body) if isinstance(body, (bytes, bytearray)) else \
        memoryview(body).nbytes
    prefix = (_LEN.pack(1 + _HLEN.size + len(h) + nbody)
              + bytes((ftype,)) + _HLEN.pack(len(h)) + h)
    return (prefix, body) if nbody else (prefix,)


def frame_nbytes(parts: Tuple[bytes, ...]) -> int:
    """Total on-the-wire size of a frame built by
    :func:`data_frame_parts` — the unit the credit window counts."""
    return sum(len(p) if isinstance(p, (bytes, bytearray))
               else memoryview(p).nbytes for p in parts)


def send_parts(sock, *parts) -> None:
    """sendall with an explicit short-write loop (``sock.send``), so a
    tiny ``SO_SNDBUF`` exercises partial writes deterministically in
    tests.  The caller serializes concurrent senders (per-connection send
    lock) — interleaved frames would desync the length prefix."""
    for p in parts:
        mv = memoryview(p)
        while mv.nbytes:
            mv = mv[sock.send(mv):]


# ---------------------------------------------------------------------- read
def parse_control(payload) -> Dict[str, object]:
    return msgpack_lite.unpackb(payload, raw=False)


def split_data(payload: memoryview) -> Tuple[Dict[str, object], memoryview]:
    """Split a REQ/RES payload into ``(header, body_view)``; the body view
    aliases the frame buffer (read-only, zero-copy)."""
    if payload.nbytes < _HLEN.size:
        raise FrameError("data frame shorter than its header-length field")
    hlen = _HLEN.unpack_from(payload, 0)[0]
    end = _HLEN.size + hlen
    if end > payload.nbytes:
        raise FrameError(f"data-frame header length {hlen} overruns the "
                         f"{payload.nbytes}-byte payload")
    header = msgpack_lite.unpackb(payload[_HLEN.size:end], raw=False)
    return header, payload[end:]


# ------------------------------------------------------------ unary envelope
def pack_unary(method: str, request: bytes) -> bytes:
    """Canonical unary-call envelope (``{"m": method, "q": request}``) the
    FLARE-bridged LGS/LGC pair relays; the TCP transport carries the same
    call as a typed REQ header + raw body instead, so model-size payloads
    skip this msgpack copy."""
    return msgpack_lite.packb({"m": method, "q": request}, use_bin_type=True)


def unpack_unary(b) -> Tuple[str, bytes]:
    d = msgpack_lite.unpackb(b, raw=False)
    return d["m"], d["q"]
