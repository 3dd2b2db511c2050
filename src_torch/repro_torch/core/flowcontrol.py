"""Credit-based per-peer flow control for the socket transport.

The server grants each peer a byte *window* (the WELCOME frame's
``credits``).  Every frame a peer sends debits the window; the server
returns credits (CREDIT frames) only once it has durably *released* the
bytes — immediately for cheap control/query traffic, but for
``push_task_res`` payloads only when the result permanently leaves the
completion queue (consumed by the driver, dropped as LATE, or discarded
at the round deadline).  A fast client therefore stalls in
:meth:`CreditGate.acquire` once the server holds a full window of its
un-consumed bytes: the *sender* blocks, the server's RSS stays bounded
(the ``backpressure_ok`` benchmark gate), and other peers are unaffected
because the gate lives client-side.

Oversized frames: a single frame larger than the whole window acquires
``min(n, limit)`` and lets the balance go negative — the transfer
overshoots once (the server's :meth:`CreditLedger.debit` tolerates up to
one window of overshoot), then the sender is fully stalled until the
server releases it.  Reconnects re-announce the true remaining window
(:meth:`CreditLedger.snapshot_for_welcome`); resends do not re-acquire,
so client/server drift is bounded by the in-flight frames and self-heals
through the capped :meth:`CreditGate.grant`.
"""
from __future__ import annotations

import threading
import time


class CreditGate:
    """Sender-side window.  Starts closed at 0 credits; the WELCOME after
    (re)connect :meth:`reset`\\ s it to the server-announced balance."""

    def __init__(self):
        self._cv = threading.Condition()
        self._avail = 0              # guarded-by: _cv
        self._limit = 0              # guarded-by: _cv
        self._closed = False         # guarded-by: _cv

    def reset(self, avail: int, limit: int) -> None:
        """Adopt the server-announced balance (connect/reconnect)."""
        with self._cv:
            self._avail = int(avail)
            self._limit = int(limit)
            self._cv.notify_all()

    def grant(self, n: int) -> None:
        """A CREDIT frame arrived.  Capped at the window limit so
        duplicate-release drift after a reconnect can only restore the
        window, never inflate it."""
        with self._cv:
            self._avail = min(self._avail + int(n), self._limit)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def balance(self) -> int:
        with self._cv:
            return self._avail

    def acquire(self, n: int, deadline: float) -> bool:
        """Debit ``n`` bytes, blocking until the window has room or
        ``deadline`` (``time.monotonic()`` timestamp) passes.  Returns
        False on deadline; raises ``ConnectionError`` once closed."""
        with self._cv:
            need = min(int(n), self._limit) if self._limit > 0 else int(n)
            while True:
                if self._closed:
                    raise ConnectionError("credit gate closed")
                if self._avail >= need:
                    self._avail -= int(n)
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)


class CreditLedger:
    """Server-side per-peer accounting, persistent across reconnects.

    :meth:`debit` on frame receipt (reader thread), :meth:`release` when
    the bytes are durably consumed.  Grants are coalesced to at least
    ``limit // 8`` so a storm of small releases does not become a storm
    of CREDIT frames; held-back credits are bounded by that threshold, so
    the peer always retains >= 7/8 of its window and can never deadlock
    on an unflushed grant.
    """

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._lock = threading.Lock()
        self._outstanding = 0        # guarded-by: _lock  received, unreleased
        self._pending_grant = 0      # guarded-by: _lock  released, unsent

    def debit(self, n: int) -> bool:
        """Account a received frame.  False once the peer has overflowed
        the window by more than one full-window overshoot — a protocol
        violation (ignoring flow control), so the caller drops the
        connection instead of buffering unboundedly."""
        with self._lock:
            self._outstanding += int(n)
            return self._outstanding <= 2 * self.limit

    def release(self, n: int) -> int:
        """Return ``n`` bytes to the peer's window; returns the coalesced
        grant to send (0 = held back below the flush threshold)."""
        with self._lock:
            self._outstanding -= int(n)
            self._pending_grant += int(n)
            if self._pending_grant >= max(1, self.limit // 8):
                grant, self._pending_grant = self._pending_grant, 0
                return grant
            return 0

    def snapshot_for_welcome(self) -> int:
        """Balance to announce in WELCOME after (re)connect: the window
        minus bytes still held server-side.  Pending unsent grants fold
        into the announcement (and are zeroed) so they are never counted
        twice."""
        with self._lock:
            self._pending_grant = 0
            return max(0, self.limit - self._outstanding)

    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding
