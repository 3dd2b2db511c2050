"""Metric streaming (paper §5.2): FLARE's experiment-tracking feature.

Clients create a :class:`SummaryWriter` inside their training code and call
``add_scalar``; scalars stream (fire-and-forget EVENTs over the runtime) to
the server-side :class:`MetricCollector`, which stores per-site series and
can export a TensorBoard-style JSON dump (the Fig. 6 artifact).
"""
from __future__ import annotations

import json
import struct
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.fl.flat import WIRE_MAGICS
from repro_torch.runtime.reliable import ReliableMessenger
from repro_torch.runtime.transport import Message

_FMT = "!d i"   # value, step
# legacy frames start with the high byte of a u16 tag length (below the
# reserved 0xF0 range for any sane tag), so the version byte — claimed
# in fl/flat.py's WIRE_MAGICS registry — is unambiguous
_BATCH_MAGIC = WIRE_MAGICS["metric_batch"]


def _encode(tag: str, value: float, step: int) -> bytes:
    head = tag.encode()
    return struct.pack("!H", len(head)) + head + struct.pack(_FMT, value, step)


def _decode(b: bytes) -> Tuple[str, float, int]:
    (n,) = struct.unpack_from("!H", b, 0)
    tag = b[2:2 + n].decode()
    value, step = struct.unpack_from(_FMT, b, 2 + n)
    return tag, value, step


def _encode_batch(items: List[Tuple[str, float, int]]) -> bytes:
    parts = [struct.pack("!BH", _BATCH_MAGIC, len(items))]
    for tag, value, step in items:
        parts.append(_encode(tag, float(value), int(step)))
    return b"".join(parts)


def _decode_batch(b: bytes) -> List[Tuple[str, float, int]]:
    (count,) = struct.unpack_from("!H", b, 1)
    off = 3
    out = []
    for _ in range(count):
        (n,) = struct.unpack_from("!H", b, off)
        tag = b[off + 2:off + 2 + n].decode()
        value, step = struct.unpack_from(_FMT, b, off + 2 + n)
        out.append((tag, value, step))
        off += 2 + n + struct.calcsize(_FMT)
    return out


class SummaryWriter:
    """Client-side API mirroring ``nvflare.client.tracking.SummaryWriter``."""

    def __init__(self, messenger: ReliableMessenger, server: str, job_id: str,
                 site: str):
        self._m = messenger
        self._server = server
        self._topic = f"job/{job_id}/metrics"
        self._site = site

    def add_scalar(self, tag: str, value: float, global_step: int = 0) -> None:
        payload = _encode(f"{self._site}/{tag}", float(value), int(global_step))
        self._m.notify(self._server, self._topic, payload)

    def add_scalars(self, tag_values: Dict[str, float],
                    global_step: int = 0) -> None:
        """Batched variant: one EVENT round-trip for a whole dict of
        per-step metrics instead of one ``notify`` per scalar."""
        if not tag_values:
            return
        items = [(f"{self._site}/{tag}", float(v), int(global_step))
                 for tag, v in tag_values.items()]
        self._m.notify(self._server, self._topic, _encode_batch(items))


class MetricCollector:
    """Server-side sink; one per job. Thread-safe."""

    def __init__(self):
        self._series: Dict[str, List[Tuple[int, float, float]]] = defaultdict(list)
        self._lock = threading.Lock()

    def on_event(self, msg: Message) -> bytes:
        if msg.payload and msg.payload[0] == _BATCH_MAGIC:
            items = _decode_batch(msg.payload)
        else:
            items = [_decode(msg.payload)]
        # TensorBoard-style wall_time: reported to humans, never compared
        # against deadlines (those are time.monotonic(), see INVARIANTS)
        now = time.time()  # repro: allow[monotonic-clock] reason=human-facing wall_time in the exported TensorBoard JSON
        with self._lock:
            for tag, value, step in items:
                self._series[tag].append((step, value, now))
        return b""

    def series(self, tag: str) -> List[Tuple[int, float]]:
        with self._lock:
            return [(s, v) for s, v, _ in sorted(self._series.get(tag, []))]

    def tags(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def export_tensorboard_json(self, path: Optional[str] = None) -> str:
        with self._lock:
            dump = {tag: [[t, s, v] for (s, v, t) in pts]
                    for tag, pts in self._series.items()}
        out = json.dumps(dump, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(out)
        return out
