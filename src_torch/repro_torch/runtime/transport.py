"""In-process transport with deterministic fault injection.

The paper's FLARE deployment runs gRPC/HTTP/TCP/Redis between hosts; this
container is one process, so "the wire" is a byte-only boundary between
threads: every payload that crosses a :class:`Network` is ``bytes`` — no
live Python object (and certainly no tensor) sneaks across, which keeps
the simulation honest (DESIGN.md §2, changed assumptions).

Faults are *deterministic per (seed, msg_id, attempt)*: a retried message is
a new attempt and may get through even if the first was dropped.  That makes
ReliableMessage behaviour reproducible in tests regardless of thread timing.
"""
from __future__ import annotations

import hashlib
import queue
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class Message:
    msg_id: str              # unique per logical request
    attempt: int             # retry counter (fault rng input)
    kind: str                # REQ | RESP | QUERY | EVENT
    sender: str
    receiver: str
    topic: str               # e.g. "job/<id>/relay"
    payload: bytes
    headers: Tuple[Tuple[str, str], ...] = ()

    def header(self, key: str, default: str = "") -> str:
        return dict(self.headers).get(key, default)


@dataclass(frozen=True)
class FaultSpec:
    drop_prob: float = 0.0
    dup_prob: float = 0.0
    max_delay_s: float = 0.0
    seed: int = 0

    def roll(self, msg: Message) -> Tuple[bool, bool, float]:
        """(dropped, duplicated, delay_s) — deterministic per msg+attempt."""
        h = hashlib.sha256(
            f"{self.seed}|{msg.msg_id}|{msg.attempt}|{msg.kind}".encode()
        ).digest()
        u1 = int.from_bytes(h[0:8], "big") / 2 ** 64
        u2 = int.from_bytes(h[8:16], "big") / 2 ** 64
        u3 = int.from_bytes(h[16:24], "big") / 2 ** 64
        return (u1 < self.drop_prob, u2 < self.dup_prob, u3 * self.max_delay_s)


class Network:
    """Central message switch: per-endpoint inboxes + fault injection."""

    def __init__(self, faults: Optional[FaultSpec] = None):
        self.faults = faults or FaultSpec()
        self._inboxes: Dict[str, "queue.Queue[Message]"] = {}
        self._lock = threading.Lock()
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0, "duplicated": 0,
                      "bytes": 0}
        self._delay_timers: List[threading.Timer] = []
        self._closed = False

    # -- endpoints -----------------------------------------------------------
    def register(self, name: str) -> "queue.Queue[Message]":
        with self._lock:
            if name not in self._inboxes:
                self._inboxes[name] = queue.Queue()
            return self._inboxes[name]

    def inbox(self, name: str) -> "queue.Queue[Message]":
        return self._inboxes[name]

    # -- sending ----------------------------------------------------------------
    def send(self, msg: Message) -> None:
        if not isinstance(msg.payload, (bytes, bytearray)):
            raise TypeError(
                f"payload must be bytes, got {type(msg.payload).__name__} — "
                "serialize before crossing the wire")
        with self._lock:
            if self._closed:
                return
            self.stats["sent"] += 1
            self.stats["bytes"] += len(msg.payload)
        dropped, dup, delay = self.faults.roll(msg)
        if dropped:
            with self._lock:
                self.stats["dropped"] += 1
            return
        copies = 2 if dup else 1
        if dup:
            with self._lock:
                self.stats["duplicated"] += 1
        for _ in range(copies):
            if delay > 0:
                t = threading.Timer(delay, self._deliver, args=(msg,))
                t.daemon = True
                with self._lock:
                    self._delay_timers.append(t)
                t.start()
            else:
                self._deliver(msg)

    def _deliver(self, msg: Message) -> None:
        with self._lock:
            if self._closed:
                return
            box = self._inboxes.get(msg.receiver)
            self.stats["delivered"] += 1
        if box is None:
            raise KeyError(f"unknown endpoint {msg.receiver!r}")
        box.put(msg)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            timers = list(self._delay_timers)
        for t in timers:
            t.cancel()
