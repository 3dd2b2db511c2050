"""Real networked Fleet transport: ``TcpSuperLink`` + ``TcpFleetConnection``.

Everything above the Fleet API seam — ``ServerApp``, ``EdgeAggregatorApp``,
FedBuff async mode, every strategy — runs unmodified: the server side *is*
a :class:`~repro_torch.core.superlink.SuperLink` (subclass) and the client side
is a :class:`~repro_torch.core.superlink.FleetConnection`, so swapping
``NativeConnection`` for a socket is the same move as swapping it for the
FLARE-bridged LGS (paper Fig. 4).  Select it per run with
``ServerConfig(transport="tcp")`` (see :func:`repro_torch.core.interop.run_native`).

Mechanics (see ``repro_torch.core.framing`` for the wire layout and
``docs/INVARIANTS.md`` for the protocol contract):

- **Multiplexing** — one socket per peer carries many logical
  TaskIns/TaskRes exchanges: every REQ has a stable ``msg_id`` and the
  server answers out of order (a parked long-poll pull never blocks a
  concurrent result push on the same socket).
- **Zero-copy payloads** — TaskRes bytes ride as the raw tail of a REQ
  frame; the receiver stores the frame buffer's read-only memoryview
  straight into the completion queue, and the 0xF1–0xF4 codec payloads
  inside it later decode via ``np.frombuffer`` off that same buffer.
- **Backpressure** — per-peer credit windows (``repro_torch.core.flowcontrol``):
  ``push_task_res`` bytes are only re-credited once the result permanently
  leaves the completion queue (the :meth:`SuperLink._result_released`
  hook), so a fast client blocks client-side instead of ballooning the
  server's RSS.
- **Liveness** — monotonic-clock heartbeats: clients PING, the server
  expires peers silent for ``heartbeat_timeout`` and drops them from the
  roster; their in-flight tasks miss the round deadline and surface as
  the established ``(node, "timeout")`` failure records.
- **Reconnect-with-resume** — a reconnecting client re-HELLOs and resends
  its in-flight REQs with the same ``msg_id``; the server's per-peer
  :class:`~repro_torch.runtime.reliable.ResultCache` (the ReliableMessage dedup
  role) executes each at most once and replays cached responses, so a
  dropped RES never loses a pulled task or double-applies a push.
- **TLS hook** — pass an ``ssl.SSLContext`` to either end; the tests run
  plaintext but the seam is exercised by a loopback-cert test.

Set ``REPRO_TCP_LOG=<path>`` to append server-side transport events
(connects, expiries, credit stalls) to a file.
"""
from __future__ import annotations

import itertools
import logging
import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.utils import msgpack_lite

from repro_torch.core.flowcontrol import CreditGate, CreditLedger
from repro_torch.core.framing import (DEFAULT_MAX_FRAME, FT_BYE, FT_CREDIT,
                                FT_HELLO, FT_PING, FT_PONG, FT_REQ, FT_RES,
                                FT_WELCOME, PROTO_VERSION, FrameError,
                                FrameReader, control_frame, data_frame_parts,
                                frame_nbytes, parse_control, send_parts,
                                split_data)
from repro_torch.core.superlink import FleetConnection, SuperLink, SuperNode
from repro_torch.runtime.reliable import RequestTimeout, ResultCache

log = logging.getLogger("repro_torch.transport")

# length prefix + frame type byte: the fixed per-frame wire overhead the
# credit accounting adds on top of the payload
_FRAME_OVERHEAD = 5


def _maybe_attach_file_log() -> None:
    """Honor REPRO_TCP_LOG: append transport events to the named file."""
    path = os.environ.get("REPRO_TCP_LOG")
    if not path:
        return
    path = os.path.abspath(path)
    for h in log.handlers:
        if isinstance(h, logging.FileHandler) and h.baseFilename == path:
            return
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(threadName)s %(message)s"))
    log.addHandler(handler)
    log.setLevel(logging.INFO)


class _Conn:
    """One accepted/connected socket.  Frame sends are serialized by an
    internal lock (interleaved writers would desync the length prefix);
    :meth:`close` shuts the socket down un-locked so it also unblocks a
    writer stuck against a full send buffer."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self._alive = True               # guarded-by: _send_lock

    def send_frame(self, *parts) -> bool:
        with self._send_lock:
            if not self._alive:
                return False
            try:
                send_parts(self.sock, *parts)
                return True
            except OSError:
                self._alive = False
                return False

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


class _PeerState:
    """Server-side per-node state, persistent across reconnects: the
    credit ledger keeps accounting for bytes still buffered from a dead
    connection, and the dedup cache is what makes reconnect-resume safe."""

    def __init__(self, node_id: str, credit_limit: int, result_ttl: float):
        self.node_id = node_id
        self.ledger = CreditLedger(credit_limit)
        self.cache = ResultCache(result_ttl)
        self._lock = threading.Lock()
        self._conn: Optional[_Conn] = None     # guarded-by: _lock
        self._last_seen = time.monotonic()     # guarded-by: _lock

    def attach(self, conn: _Conn) -> Optional[_Conn]:
        """Adopt a new connection; returns the stale one (caller closes
        it — at most one live socket per peer)."""
        with self._lock:
            old, self._conn = self._conn, conn
            self._last_seen = time.monotonic()
            return old

    def detach(self, conn: _Conn) -> None:
        with self._lock:
            if self._conn is conn:
                self._conn = None

    def current_conn(self) -> Optional[_Conn]:
        with self._lock:
            return self._conn

    def touch(self) -> None:
        with self._lock:
            self._last_seen = time.monotonic()

    def silent_for(self) -> float:
        with self._lock:
            return time.monotonic() - self._last_seen


class TcpSuperLink(SuperLink):
    """A :class:`SuperLink` whose Fleet API is served over real sockets.

    The Driver side is unchanged — the ServerApp drives this object
    exactly like the in-proc link — while SuperNodes connect through
    :class:`TcpFleetConnection`.  One reader thread per connection, one
    short-lived worker per REQ (a parked long-poll pull must not block
    the next frame), a reaper for heartbeat expiry, and a grant pump that
    sends CREDIT frames outside every link lock.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 ssl_context=None, credits_per_peer: int = 64 << 20,
                 poll_wait: float = 0.5, heartbeat_timeout: float = 10.0,
                 io_timeout: float = 30.0, result_ttl: float = 60.0,
                 max_frame: int = DEFAULT_MAX_FRAME):
        super().__init__()
        _maybe_attach_file_log()
        self._ssl = ssl_context
        self.credits_per_peer = int(credits_per_peer)
        self.poll_wait = poll_wait
        self.heartbeat_timeout = heartbeat_timeout
        self.io_timeout = io_timeout
        self.result_ttl = result_ttl
        self.max_frame = int(max_frame)
        self._peers: Dict[str, _PeerState] = {}         # guarded-by: _tlock
        self._held_credits: Dict[str, Tuple[_PeerState, int]] = {}  # guarded-by: _tlock
        self._tlock = threading.Lock()
        self._grants: Dict[str, int] = {}               # guarded-by: _grant_cv
        self._grant_cv = threading.Condition()
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port), backlog=64)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="tcp-accept"),
            threading.Thread(target=self._reap_loop, daemon=True,
                             name="tcp-reaper"),
            threading.Thread(target=self._grant_loop, daemon=True,
                             name="tcp-grant-pump"),
        ]
        for t in self._threads:
            t.start()
        log.info("TcpSuperLink listening on %s:%d (credits/peer=%d)",
                 self.address[0], self.address[1], self.credits_per_peer)

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "TcpSuperLink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        with self._grant_cv:
            self._grant_cv.notify_all()
        self._listener.close()
        with self._tlock:
            peers = list(self._peers.values())
        for peer in peers:
            conn = peer.current_conn()
            if conn is not None:
                conn.send_frame(control_frame(FT_BYE, {"reason": "shutdown"}))
                conn.close()
        for t in self._threads:
            t.join(timeout=2.0)
        log.info("TcpSuperLink closed")

    # ------------------------------------------------------------- plumbing
    def _get_peer(self, node_id: str) -> _PeerState:
        with self._tlock:
            peer = self._peers.get(node_id)
            if peer is None:
                peer = self._peers[node_id] = _PeerState(
                    node_id, self.credits_per_peer, self.result_ttl)
            return peer

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._listener.accept()
            except OSError:
                break                        # listener closed
            threading.Thread(target=self._conn_loop, args=(sock, addr),
                             daemon=True,
                             name=f"tcp-conn-{addr[0]}:{addr[1]}").start()

    def _conn_loop(self, sock: socket.socket, addr) -> None:
        peer: Optional[_PeerState] = None
        conn: Optional[_Conn] = None
        try:
            sock.settimeout(self.io_timeout)
            if self._ssl is not None:
                sock = self._ssl.wrap_socket(sock, server_side=True)
            conn = _Conn(sock)
            reader = FrameReader(self.max_frame)
            # handshake: the first frame must be HELLO
            pending: List[Tuple[int, memoryview]] = []
            while not pending:
                got = reader.read_from(sock)
                if got is None:
                    return                   # probe connection, no HELLO
                pending = got
            ftype, payload = pending.pop(0)
            if ftype != FT_HELLO:
                raise FrameError(f"expected HELLO, got frame type {ftype}")
            fields = parse_control(payload)
            node = str(fields["node"])
            peer = self._get_peer(node)
            self.fleet_unary("register", node.encode())
            stale = peer.attach(conn)
            if stale is not None:
                stale.close()                # at most one live socket/peer
            conn.send_frame(control_frame(FT_WELCOME, {
                "credits": peer.ledger.snapshot_for_welcome(),
                "limit": peer.ledger.limit,
                "max_frame": self.max_frame,
                "hb": self.heartbeat_timeout,
            }))
            log.info("peer %s connected from %s:%d%s", node, addr[0],
                     addr[1], " (resume)" if stale is not None else "")
            # frames pipelined behind the HELLO, then the steady loop
            for frame in pending:
                if not self._on_frame(peer, conn, frame):
                    return
            while not self._stop.is_set():
                try:
                    frames = reader.read_from(sock)
                except socket.timeout:
                    continue                 # liveness is the reaper's job
                if frames is None:
                    return                   # clean EOF
                for frame in frames:
                    if not self._on_frame(peer, conn, frame):
                        return
        except (OSError, FrameError, KeyError, ValueError) as e:
            who = peer.node_id if peer is not None else f"{addr[0]}:{addr[1]}"
            log.warning("connection %s dropped: %r", who, e)
        finally:
            if conn is not None:
                conn.close()
            if peer is not None:
                peer.detach(conn)

    def _on_frame(self, peer: _PeerState, conn: _Conn,
                  frame: Tuple[int, memoryview]) -> bool:
        """Dispatch one frame from ``peer``; False ends the connection."""
        ftype, payload = frame
        peer.touch()
        if ftype == FT_REQ:
            nbytes = payload.nbytes + _FRAME_OVERHEAD
            if not peer.ledger.debit(nbytes):
                log.warning("peer %s overran its credit window; dropping",
                            peer.node_id)
                raise FrameError("credit window overrun")
            header, body = split_data(payload)
            threading.Thread(target=self._serve_req,
                             args=(peer, nbytes, header, body),
                             daemon=True,
                             name=f"tcp-req-{peer.node_id}").start()
            return True
        if ftype == FT_PING:
            conn.send_frame(control_frame(FT_PONG, parse_control(payload)))
            return True
        if ftype == FT_BYE:
            log.info("peer %s said BYE", peer.node_id)
            self.mark_node_dead(peer.node_id)
            return False
        raise FrameError(f"unexpected frame type {ftype} from peer")

    # ------------------------------------------------------------- requests
    def _serve_req(self, peer: _PeerState, nbytes: int,
                   header: Dict[str, object], body: memoryview) -> None:
        msg_id = str(header.get("i", ""))
        state, cached = peer.cache.begin(msg_id)
        if state != "new":
            # duplicate (reconnect-resend or retry): the bytes were never
            # buffered a second time — push_task_result dedups by msg, so
            # return the dup frame's credits immediately
            self._release_credits(peer, nbytes)
            if state == "done":
                self._send_res(peer, msg_id, cached)
            # "executing": the original execution replies to the peer's
            # then-current connection when it finishes; "seen": payload
            # already reaped — never re-execute, the client re-times-out
            return
        method = str(header.get("m", ""))
        held = False
        try:
            if method == "register":
                self.fleet_unary("register", peer.node_id.encode())
                resp: Tuple[Dict[str, object], bytes] = ({}, b"")
            elif method == "pull_task_ins":
                tid, task = self.pull_task_wait(peer.node_id, self.poll_wait)
                resp = ({"id": tid}, task)
            elif method == "push_task_res":
                tid = str(header["id"])
                with self._tlock:
                    # record BEFORE the push: if the task is already
                    # tombstoned the _result_released hook fires inside
                    # push_task_result and returns these credits
                    self._held_credits[tid] = (peer, nbytes)
                held = True
                ok = self.push_task_result(tid, body)
                resp = ({"s": "OK" if ok else "LATE"}, b"")
            else:
                resp = ({"e": f"unknown fleet method {method!r}",
                         "k": "error"}, b"")
        except Exception as e:  # noqa: BLE001 — a broken request must
            # surface to its sender, not kill the server worker silently
            log.warning("request %s from %s failed: %r", method,
                        peer.node_id, e)
            resp = ({"e": repr(e), "k": "error"}, b"")
        if not held:
            # non-push traffic is cheap: credits return on dispatch
            self._release_credits(peer, nbytes)
        peer.cache.finish(msg_id, resp)
        self._send_res(peer, msg_id, resp)

    def _send_res(self, peer: _PeerState, msg_id: str,
                  resp: Tuple[Dict[str, object], bytes]) -> None:
        """Reply on the peer's *current* connection: if the REQ's socket
        died, the reconnected socket carries the response — and if none is
        live, the cached copy serves the client's resend."""
        extra, body = resp
        header = {"i": msg_id}
        header.update(extra)
        conn = peer.current_conn()
        if conn is not None:
            conn.send_frame(*data_frame_parts(FT_RES, header, body))

    # -------------------------------------------------------------- credits
    def _release_credits(self, peer: _PeerState, nbytes: int) -> None:
        grant = peer.ledger.release(nbytes)
        if grant:
            with self._grant_cv:
                self._grants[peer.node_id] = \
                    self._grants.get(peer.node_id, 0) + grant
                self._grant_cv.notify_all()

    def _result_released(self, task_id: str) -> None:
        # SuperLink hook: the TaskRes bytes left the completion queue
        # (consumed / LATE / discarded) — only now does the pushing peer
        # get its window back.  Runs without link locks held.
        with self._tlock:
            entry = self._held_credits.pop(task_id, None)
        if entry is None:
            return                      # not a TCP-pushed result
        peer, nbytes = entry
        self._release_credits(peer, nbytes)

    def _grant_loop(self) -> None:
        """Send CREDIT frames from a dedicated thread: the releasing
        thread is often the driver inside ``waiter_next``, which must not
        block on a peer's send buffer."""
        while True:
            with self._grant_cv:
                while not self._grants and not self._stop.is_set():
                    self._grant_cv.wait(1.0)
                if self._stop.is_set():
                    return
                batch, self._grants = dict(self._grants), {}
            for node_id, grant in batch.items():
                with self._tlock:
                    peer = self._peers.get(node_id)
                conn = peer.current_conn() if peer is not None else None
                if conn is None or not conn.send_frame(
                        control_frame(FT_CREDIT, {"n": grant})):
                    # no live socket: the reconnect WELCOME re-announces
                    # the true window, so the grant is simply dropped
                    log.info("dropped %d-byte grant for offline peer %s",
                             grant, node_id)

    # ------------------------------------------------------------- liveness
    def _reap_loop(self) -> None:
        interval = max(0.05, min(1.0, self.heartbeat_timeout / 4))
        while not self._stop.wait(interval):
            with self._tlock:
                peers = list(self._peers.values())
            for peer in peers:
                if peer.silent_for() > self.heartbeat_timeout:
                    # expire by silence whether or not the socket is still
                    # attached: a kill -9'd peer delivers EOF (the conn is
                    # long gone) but must still leave the roster
                    conn = peer.current_conn()
                    if conn is not None:
                        conn.close()
                        peer.detach(conn)
                    if self.mark_node_dead(peer.node_id):
                        log.warning("peer %s heartbeat expired (%.1fs "
                                    "silent); dropped from roster",
                                    peer.node_id, peer.silent_for())
                peer.cache.reap()


class _Call:
    """One in-flight REQ on the client: the prebuilt frame parts stay
    around so a reconnect can resend them under the same msg_id."""

    __slots__ = ("seq", "parts", "nbytes", "event", "resp_header",
                 "resp_body", "failed")

    def __init__(self, seq: int, parts, nbytes: int):
        self.seq = seq
        self.parts = parts
        self.nbytes = nbytes
        self.event = threading.Event()
        self.resp_header: Optional[Dict[str, object]] = None
        self.resp_body: Optional[memoryview] = None
        self.failed = False


class TcpFleetConnection(FleetConnection):
    """Client side of the socket transport: connects, speaks
    HELLO/WELCOME, multiplexes typed fleet calls as REQ/RES exchanges,
    PINGs for liveness, blocks sends on the credit gate, and reconnects
    with resume (in-flight REQs are resent under their original msg_ids —
    the server's dedup cache makes that exactly-once)."""

    def __init__(self, host: str, port: int, node_id: str, *,
                 ssl_context=None, server_hostname: Optional[str] = None,
                 request_timeout: float = 30.0, connect_timeout: float = 5.0,
                 heartbeat_interval: float = 1.0,
                 heartbeat_timeout: float = 10.0,
                 reconnect_backoff: float = 0.05,
                 max_disconnected: Optional[float] = None,
                 max_frame: int = DEFAULT_MAX_FRAME):
        self.host, self.port = host, int(port)
        self.node_id = node_id
        self._ssl = ssl_context
        self._server_hostname = server_hostname or host
        self.request_timeout = request_timeout
        self.connect_timeout = connect_timeout
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.reconnect_backoff = reconnect_backoff
        # give-up horizon: continuously disconnected for this long -> the
        # connection closes itself, so an orphaned SuperNode process whose
        # server is gone exits instead of reconnect-looping forever
        self.max_disconnected = max_disconnected
        self.max_frame = int(max_frame)
        self._gate = CreditGate()
        self._lock = threading.Lock()
        self._pending: Dict[str, _Call] = {}    # guarded-by: _lock
        self._sock: Optional[socket.socket] = None  # guarded-by: _lock
        self._send_lock = threading.Lock()
        # run-thread-only connection state (re-created per connect)
        self._reader = FrameReader(self.max_frame)
        self._hb = heartbeat_interval
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tcp-client-{node_id}")
        self._thread.start()

    # --------------------------------------------------------------- public
    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def register(self, node_id: str) -> None:
        self._call("register", {}, b"")

    def pull_task(self, node_id: str) -> Tuple[str, bytes]:
        header, body = self._call("pull_task_ins", {}, b"")
        return str(header.get("id", "")), body

    def push_result(self, task_id: str, res: bytes) -> None:
        # a "LATE" status is fine: the round gave up, the server dropped it
        self._call("push_task_res", {"id": task_id}, res)

    def unary(self, method: str, request: bytes) -> bytes:
        """Compatibility shim for byte-level callers; the typed wrappers
        above are the zero-copy fast path the SuperNode loop uses."""
        if method == "register":
            self.register(request.decode())
            return b"OK"
        if method == "pull_task_ins":
            tid, task = self.pull_task(request.decode())
            return msgpack_lite.packb({"id": tid, "task": bytes(task)},
                                 use_bin_type=True)
        if method == "push_task_res":
            d = msgpack_lite.unpackb(request, raw=False)
            self.push_result(d["id"], d["res"])
            return b"OK"
        raise ValueError(f"unknown fleet method {method!r}")

    def close(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        self._gate.close()
        with self._lock:
            sock = self._sock
        if sock is not None:
            with self._send_lock:
                try:
                    send_parts(sock, control_frame(FT_BYE,
                                                   {"reason": "stop"}))
                except OSError:
                    pass
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self._fail_pending()
        self._thread.join(timeout=2.0)

    # ----------------------------------------------------------------- call
    def _call(self, method: str, extra: Dict[str, object], body,
              timeout: Optional[float] = None
              ) -> Tuple[Dict[str, object], memoryview]:
        deadline = time.monotonic() + (timeout or self.request_timeout)
        seq = next(self._seq)
        msg_id = f"{self.node_id}:{seq}"
        header: Dict[str, object] = {"i": msg_id, "m": method}
        header.update(extra)
        parts = data_frame_parts(FT_REQ, header, body)
        call = _Call(seq, parts, frame_nbytes(parts))
        with self._lock:
            if self._stop.is_set():
                raise ConnectionError("connection closed")
            self._pending[msg_id] = call
        try:
            # backpressure: blocks HERE, in the sender, while the server
            # still holds a window's worth of our un-consumed bytes
            if not self._gate.acquire(call.nbytes, deadline):
                raise RequestTimeout(
                    f"{self.node_id} [{method}] blocked on flow-control "
                    f"credits", target="server", topic=method,
                    timeout=timeout or self.request_timeout)
            self._send_call(call)     # best effort; reconnect resends
            if not call.event.wait(deadline - time.monotonic()):
                raise RequestTimeout(
                    f"{self.node_id} [{method}] timed out",
                    target="server", topic=method,
                    timeout=timeout or self.request_timeout)
            if call.failed or call.resp_header is None:
                raise ConnectionError("connection closed")
            err = call.resp_header.get("e")
            if err:
                if call.resp_header.get("k") == "timeout":
                    raise RequestTimeout(str(err), target="server",
                                         topic=method)
                raise RuntimeError(f"server error: {err}")
            return call.resp_header, call.resp_body
        finally:
            with self._lock:
                self._pending.pop(msg_id, None)

    def _send_call(self, call: _Call) -> None:
        with self._lock:
            sock = self._sock
        if sock is None:
            return               # reconnect pass will send it
        with self._send_lock:
            try:
                send_parts(sock, *call.parts)
            except OSError:
                pass             # the run loop notices and reconnects

    def _fail_pending(self) -> None:
        with self._lock:
            calls = list(self._pending.values())
        for call in calls:
            call.failed = True
            call.event.set()

    # ------------------------------------------------------------ run loop
    def _run(self) -> None:
        backoff = self.reconnect_backoff
        last_connected = time.monotonic()
        while not self._stop.is_set():
            try:
                sock = self._connect()
            except (OSError, FrameError) as e:
                if self.max_disconnected is not None and \
                        time.monotonic() - last_connected > \
                        self.max_disconnected:
                    log.warning("%s: disconnected > %.1fs (%r); giving up",
                                self.node_id, self.max_disconnected, e)
                    break
                self._stop.wait(backoff)
                backoff = min(backoff * 2, 2.0)
                continue
            backoff = self.reconnect_backoff
            try:
                self._serve(sock)
            except (OSError, FrameError) as e:
                if not self._stop.is_set():
                    log.info("%s: connection lost (%r); reconnecting",
                             self.node_id, e)
            finally:
                last_connected = time.monotonic()
                with self._lock:
                    self._sock = None
                try:
                    sock.close()
                except OSError:
                    pass
        self._stop.set()
        self._gate.close()
        self._fail_pending()

    def _connect(self) -> socket.socket:
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ssl is not None:
                sock = self._ssl.wrap_socket(
                    sock, server_hostname=self._server_hostname)
            send_parts(sock, control_frame(FT_HELLO, {
                "node": self.node_id, "proto": PROTO_VERSION}))
            reader = FrameReader(self.max_frame)
            frames: List[Tuple[int, memoryview]] = []
            while not frames:
                got = reader.read_from(sock)
                if got is None:
                    raise ConnectionError("EOF before WELCOME")
                frames = got
            ftype, payload = frames[0]
            if ftype != FT_WELCOME:
                raise FrameError(f"expected WELCOME, got type {ftype}")
            fields = parse_control(payload)
            self._gate.reset(int(fields["credits"]), int(fields["limit"]))
            self._reader = reader
            self._hb = min(self.heartbeat_interval,
                           float(fields.get("hb", self.heartbeat_timeout))
                           / 3)
        except BaseException:
            sock.close()
            raise
        return sock

    def _serve(self, sock: socket.socket) -> None:
        sock.settimeout(max(0.05, self._hb / 2))
        with self._lock:
            self._sock = sock
            resend = sorted(self._pending.values(), key=lambda c: c.seq)
        # resume: in-flight REQs go out again under their original msg_ids
        # — the server's dedup cache executes once and replays responses.
        # Resends do NOT re-acquire credits: the WELCOME balance already
        # reflects what the server still holds from us.
        for call in resend:
            with self._send_lock:
                send_parts(sock, *call.parts)
        if resend:
            log.info("%s: resent %d in-flight request(s) after reconnect",
                     self.node_id, len(resend))
        last_rx = time.monotonic()
        last_ping = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last_rx > self.heartbeat_timeout:
                raise ConnectionError(
                    f"server silent for {now - last_rx:.1f}s")
            if now - last_ping >= self._hb:
                last_ping = now
                with self._send_lock:
                    send_parts(sock, control_frame(FT_PING, {"t": now}))
            try:
                frames = self._reader.read_from(sock)
            except socket.timeout:
                continue
            if frames is None:
                raise ConnectionError("server closed the connection")
            last_rx = time.monotonic()
            for ftype, payload in frames:
                self._on_frame(sock, ftype, payload)

    def _on_frame(self, sock: socket.socket, ftype: int,
                  payload: memoryview) -> None:
        if ftype == FT_RES:
            header, body = split_data(payload)
            msg_id = str(header.get("i", ""))
            with self._lock:
                call = self._pending.get(msg_id)
            if call is not None:
                call.resp_header = header
                call.resp_body = body
                call.event.set()
            return
        if ftype == FT_CREDIT:
            self._gate.grant(int(parse_control(payload)["n"]))
            return
        if ftype == FT_PONG:
            return                       # any frame already refreshed rx
        if ftype == FT_PING:             # symmetric, though servers don't
            with self._send_lock:
                send_parts(sock, control_frame(FT_PONG,
                                               parse_control(payload)))
            return
        if ftype == FT_BYE:
            raise ConnectionError("server said BYE")
        raise FrameError(f"unexpected frame type {ftype} from server")


def run_supernode(host: str, port: int, node_id: str, client_app_factory,
                  *, run_seconds: float = 120.0,
                  heartbeat_interval: float = 0.5,
                  heartbeat_timeout: float = 10.0,
                  max_disconnected: float = 15.0,
                  ssl_context=None) -> None:
    """Blocking SuperNode-over-TCP entry point for a child *process* (the
    multi-process CI lane spawns 16 of these).  ``client_app_factory`` is
    a picklable callable ``node_id -> ClientApp``.  Exits when the server
    goes away for ``max_disconnected`` seconds or after ``run_seconds`` —
    a crashed parent can therefore never strand the child forever.  The
    connection's socket timeout, half of ``heartbeat_interval``, also
    bounds each send, and its PINGs wait behind its own upload: a node
    that uploads large frames to a busy server takes a longer interval
    and a ``heartbeat_timeout`` above it."""
    conn = TcpFleetConnection(host, port, node_id,
                              heartbeat_interval=heartbeat_interval,
                              heartbeat_timeout=heartbeat_timeout,
                              max_disconnected=max_disconnected,
                              ssl_context=ssl_context)
    node = SuperNode(node_id, client_app_factory(node_id), conn)
    node.start()
    deadline = time.monotonic() + run_seconds
    try:
        while time.monotonic() < deadline and not conn.closed:
            time.sleep(0.1)
    finally:
        node.stop()
