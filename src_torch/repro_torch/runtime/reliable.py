"""ReliableMessage (paper §4.1), faithfully:

  1. the requester sends the request; if delivery fails it retries a moment
     later, repeating until sent or until the timeout elapses (=> abort);
  2. once sent, the requester waits for the response; the peer pushes the
     result as soon as processing finishes; *in parallel* the requester
     periodically sends QUERY messages to pull the result, so the response
     arrives through whichever path survives (push or query-pull);
  3. the receiver deduplicates by msg_id — a request is executed exactly
     once no matter how many retries/duplicates arrive — and keeps the
     result cached so late queries can still fetch it.
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Callable, Dict, Optional, Tuple

from repro_torch.runtime.transport import Message, Network


class RequestTimeout(RuntimeError):
    """Raised when a reliable exchange exceeds its deadline.

    Carries the exchange coordinates so callers can *demote* the timeout
    to a recorded per-node failure (the FL fault-tolerance contract)
    instead of aborting the job — e.g. the SuperNode keeps serving and
    the server logs ``(node, "timeout")`` for the round.
    """

    def __init__(self, message: str, *, target: Optional[str] = None,
                 topic: Optional[str] = None,
                 timeout: Optional[float] = None):
        super().__init__(message)
        self.target = target
        self.topic = topic
        self.timeout = timeout


_PENDING = b"\x00__PENDING__"
_counter = itertools.count()


class ResultCache:
    """Responder-side execute-once dedup (the ReliableMessage receiver
    role, §4.1(3)), reusable by any transport: :meth:`begin` marks a
    msg_id before its handler runs, :meth:`finish` caches the result for
    ``ttl`` seconds so retries — and the socket transport's
    reconnect-resends — fetch the cached response instead of re-executing
    a possibly non-idempotent operation.

    Lifecycle per msg_id: unseen -> executing -> done(result, ts) ->
    result reaped at ``ttl`` (the tiny dedup mark survives 10x longer,
    so a straggling duplicate is still recognized as seen: the handler
    never re-executes, the requester just times out — safe) -> unseen.
    """

    def __init__(self, ttl: float = 60.0,
                 lock: Optional[threading.Lock] = None):
        self.ttl = ttl
        self._lock = lock if lock is not None else threading.Lock()
        self._seen: Dict[str, float] = {}            # guarded-by: _lock
        self._executing: set = set()                 # guarded-by: _lock
        self._results: Dict[str, Tuple[float, object]] = {}  # guarded-by: _lock

    def begin(self, msg_id: str) -> Tuple[str, Optional[object]]:
        """Claim ``msg_id`` for execution.  Returns one of
        ``("new", None)`` — caller executes and must :meth:`finish`,
        :meth:`fail`, or :meth:`forget`; ``("executing", None)`` — the
        first arrival is still running (its completion will answer);
        ``("done", result)`` — cached; ``("seen", None)`` — executed but
        the payload is already reaped (never re-execute)."""
        with self._lock:
            if msg_id in self._seen:
                if msg_id in self._executing:
                    return "executing", None
                cached = self._results.get(msg_id)
                if cached is not None:
                    return "done", cached[1]
                return "seen", None
            # pin the mark while the handler runs: a long-running handler
            # must not have its dedup mark reaped mid-flight (a retry
            # would then re-execute)
            self._seen[msg_id] = time.monotonic()
            self._executing.add(msg_id)
            return "new", None

    def finish(self, msg_id: str, result: object) -> None:
        with self._lock:
            self._results[msg_id] = (time.monotonic(), result)
            self._executing.discard(msg_id)
            self._reap()

    def fail(self, msg_id: str) -> None:
        """Handler raised: unpin, but keep the dedup mark — retries of a
        request whose execution blew up mid-flight must not re-execute
        (the requester times out instead)."""
        with self._lock:
            self._executing.discard(msg_id)

    def forget(self, msg_id: str) -> None:
        """Undo :meth:`begin` entirely (e.g. no handler registered yet):
        a retry gets to execute from scratch."""
        with self._lock:
            self._executing.discard(msg_id)
            self._seen.pop(msg_id, None)

    def get(self, msg_id: str) -> Optional[object]:
        """Cached result for a QUERY-style pull, or None."""
        with self._lock:
            cached = self._results.get(msg_id)
            self._reap()
            return None if cached is None else cached[1]

    def reap(self) -> None:
        """Idle-tick reap, so an endpoint that goes quiet still releases
        its cached payloads."""
        with self._lock:
            self._reap()

    def _reap(self) -> None:  # guarded-by: _lock
        """Drop cached result payloads past ``ttl``; keep the (tiny)
        dedup marks 10x longer.  Caller holds the lock."""
        now = time.monotonic()
        cutoff = now - self.ttl
        for mid in [m for m, (ts, _) in self._results.items()
                    if ts < cutoff]:
            del self._results[mid]
        mark_cutoff = now - 10 * self.ttl
        for mid in [m for m, ts in self._seen.items()
                    if ts < mark_cutoff and m not in self._results
                    and m not in self._executing]:
            del self._seen[mid]


class ReliableMessenger:
    """One per endpoint; handles both the requester and responder roles."""

    def __init__(self, network: Network, me: str,
                 retry_interval: float = 0.02, default_timeout: float = 10.0,
                 result_ttl: float = 60.0):
        self.net = network
        self.me = me
        self.retry_interval = retry_interval
        self.default_timeout = default_timeout
        # how long a responder keeps a computed result for late QUERYs /
        # duplicate REQs; afterwards the entry (and its dedup mark) is
        # reaped so a long-lived endpoint's cache stays bounded
        self.result_ttl = result_ttl
        self.inbox = network.register(me)
        self._inflight: Dict[str, threading.Event] = {}
        self._responses: Dict[str, bytes] = {}        # requester: msg_id -> resp
        self._handlers: Dict[str, Callable[[Message], bytes]] = {}
        self._lock = threading.Lock()
        # responder dedup + result cache shares this object's lock, so
        # holding ``_lock`` snapshots the cache consistently (tests rely
        # on that) — never call cache methods while already holding it
        self._cache = ResultCache(result_ttl, lock=self._lock)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name=f"rm-{me}")
        self._thread.start()

    @property
    def _results(self) -> Dict[str, Tuple[float, object]]:
        return self._cache._results

    @property
    def _seen(self) -> Dict[str, float]:
        return self._cache._seen

    def _send(self, msg_id: str, kind: str, receiver: str, topic: str,
              payload: bytes, attempt: int = 0) -> None:
        self.net.send(Message(msg_id, attempt, kind, self.me, receiver, topic,
                              payload))

    # ------------------------------------------------------------ responder
    def register_handler(self, topic: str, fn: Callable[[Message], bytes]) -> None:
        with self._lock:
            self._handlers[topic] = fn

    def _handle_request(self, msg: Message) -> None:
        state, cached = self._cache.begin(msg.msg_id)
        if state != "new":                           # dedup: execute once
            if state == "done":                      # re-push cached result
                self._send(msg.msg_id, "RESP", msg.sender, msg.topic,
                           cached, attempt=msg.attempt)
            return
        with self._lock:
            handler = self._match_handler(msg.topic)
        if handler is None:
            # no handler *yet* (job process still starting): stay unseen
            # so a retry executes once the handler is registered
            self._cache.forget(msg.msg_id)
            return
        try:
            result = handler(msg)                    # may take a while
        except BaseException:
            self._cache.fail(msg.msg_id)
            raise
        self._cache.finish(msg.msg_id, result)
        self._send(msg.msg_id, "RESP", msg.sender, msg.topic, result,
                   attempt=msg.attempt)

    def _match_handler(self, topic: str):
        if topic in self._handlers:
            return self._handlers[topic]
        for t, fn in self._handlers.items():
            if t.endswith("*") and topic.startswith(t[:-1]):
                return fn
        return None

    def _handle_query(self, msg: Message) -> None:
        cached = self._cache.get(msg.msg_id)
        self._send(msg.msg_id, "RESP", msg.sender, msg.topic,
                   cached if cached is not None else _PENDING,
                   attempt=msg.attempt)

    # ------------------------------------------------------------ requester
    def request(self, target: str, topic: str, payload: bytes,
                timeout: Optional[float] = None) -> bytes:
        """Blocking reliable exchange. Raises RequestTimeout on deadline."""
        timeout = timeout or self.default_timeout
        msg_id = f"{self.me}-{next(_counter)}-{uuid.uuid4().hex[:8]}"
        ev = threading.Event()
        with self._lock:
            self._inflight[msg_id] = ev
        deadline = time.monotonic() + timeout
        attempt = 0
        try:
            while time.monotonic() < deadline:
                # (re)send the request — receiver-side dedup makes this safe
                self.net.send(Message(msg_id, attempt, "REQ", self.me, target,
                                      topic, payload))
                attempt += 1
                if ev.wait(self.retry_interval):
                    break
                # pull path: query for a result the push may have lost
                self.net.send(Message(msg_id, attempt, "QUERY", self.me,
                                      target, topic, b""))
                attempt += 1
                if ev.wait(self.retry_interval):
                    break
            else:
                raise RequestTimeout(
                    f"{self.me} -> {target} [{topic}] timed out after "
                    f"{timeout}s", target=target, topic=topic,
                    timeout=timeout)
            with self._lock:
                return self._responses.pop(msg_id)
        finally:
            with self._lock:
                self._inflight.pop(msg_id, None)
                self._responses.pop(msg_id, None)

    def notify(self, target: str, topic: str, payload: bytes) -> None:
        """Fire-and-forget EVENT (metric streaming uses this)."""
        msg_id = f"{self.me}-ev-{next(_counter)}-{uuid.uuid4().hex[:8]}"
        self.net.send(Message(msg_id, 0, "EVENT", self.me, target, topic,
                              payload))

    # ------------------------------------------------------------ pump
    def _pump(self) -> None:
        last_reap = time.monotonic()
        while not self._stop.is_set():
            try:
                msg = self.inbox.get(timeout=0.05)
            except Exception:
                # idle tick: reap even when no requests arrive, so an
                # endpoint that goes quiet releases its cached payloads
                if time.monotonic() - last_reap > 1.0:
                    self._cache.reap()
                    last_reap = time.monotonic()
                continue
            if msg.kind == "REQ":
                # handlers run off-pump: a relaying handler (LGS/LGC) issues
                # its own reliable request and must not block RESP delivery
                t = threading.Thread(target=self._handle_request, args=(msg,),
                                     daemon=True)
                t.start()
            elif msg.kind == "QUERY":
                self._handle_query(msg)
            elif msg.kind == "RESP":
                if msg.payload == _PENDING:
                    continue
                with self._lock:
                    ev = self._inflight.get(msg.msg_id)
                    if ev is not None and msg.msg_id not in self._responses:
                        self._responses[msg.msg_id] = msg.payload
                        ev.set()
            elif msg.kind == "EVENT":
                handler = self._match_handler(msg.topic)
                if handler is not None:
                    handler(msg)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
