"""Flower Next long-running components (paper §3.2, Fig. 3).

:class:`SuperLink` decouples the communication layer from the ServerApp:
the ServerApp drives rounds through the Driver API, SuperNodes pull TaskIns
and push TaskRes through the Fleet API.  Both APIs are **byte-level,
gRPC-shaped** (unary method name + request bytes -> response bytes), so a
connection can be the in-process :class:`NativeConnection` *or* the
FLARE-routed LGS/LGC pair — with identical semantics (Fig. 5 claim).

Fleet methods:   register, pull_task_ins, push_task_res

Timeout semantics (the fault-tolerance contract):

- The result store is a **completion queue**: :meth:`SuperLink.pull_any`
  blocks on the shared condition variable until *any* of a set of tasks
  completes, so one slow node never serializes the others behind it.
- All pulls of a round share **one deadline**.  When it passes, the
  un-arrived tasks are :meth:`discard`-ed: never-delivered TaskIns are
  dropped from the node queues, in-flight tasks leave a tombstone so a
  late TaskRes is silently dropped instead of leaking into (and possibly
  corrupting) a later round.
- :class:`SuperNode` treats transport errors (e.g. a ReliableMessage
  :class:`~repro_torch.runtime.reliable.RequestTimeout` on the FLARE-bridged
  path) as retryable: the node keeps serving and the *server's* per-round
  deadline demotes the miss to a per-node failure.
"""
from __future__ import annotations

import threading
import time
import uuid
from collections import deque
from typing import Deque, Dict, Iterable, Iterator, List, Optional, Set, Tuple

from repro_torch.utils import msgpack_lite

from repro_torch.fl import agg_kernels as kernels
from repro_torch.fl.client import ClientApp
from repro_torch.fl.flat import PartialSum
from repro_torch.fl.messages import (EvaluateRes, FitRes, TaskIns, TaskRes,
                                     decode_evaluate_res, decode_fit_res,
                                     decode_properties_res, decode_task_ins,
                                     decode_task_res, encode_evaluate_res,
                                     encode_fit_res, encode_partial_fit_res,
                                     encode_properties_res, encode_task_ins,
                                     encode_task_res, peek_config, peek_params)
from repro_torch.fl.server import Driver
from repro_torch.fl.strategy import _flat_of
from repro_torch.runtime.reliable import RequestTimeout

# Tombstones for in-flight tasks whose round already gave up on them are
# pruned after this many seconds; a responsive-but-slow node clears its own
# tombstone the moment its late result arrives (and is dropped).
_TOMBSTONE_TTL = 120.0


class _Waiter:
    """One consumer's cursor over the completion queue: results for its
    registered task ids are routed straight to ``ready`` by
    ``push_task_res`` — O(1) per arrival — instead of every blocked
    consumer rescanning its full outstanding id set on each wakeup
    (quadratic per round at 10k in-flight tasks)."""

    __slots__ = ("ready",)

    def __init__(self):
        self.ready: Deque[Tuple[str, bytes]] = deque()  # guarded-by: link._results_cv


class SuperLink:
    """Hub: per-node task queues + completion queue. Thread-safe."""

    def __init__(self):
        self._task_queues: Dict[str, Deque[Tuple[str, bytes]]] = {}  # guarded-by: _lock
        self._results: Dict[str, bytes] = {}                 # guarded-by: _results_cv
        self._waiters: Dict[str, _Waiter] = {}               # guarded-by: _results_cv
        self._expired: Dict[str, float] = {}                 # guarded-by: _results_cv
        self._results_cv = threading.Condition()
        self._nodes: Dict[str, float] = {}                   # guarded-by: _lock
        self._lock = threading.Lock()
        # long-poll wakeup for pull_task_wait; wraps the SAME lock, so
        # every ``with self._lock`` block may wait/notify on it directly
        self._tasks_cv = threading.Condition(self._lock)
        self.stats = {"late_dropped": 0, "discarded_ins": 0}  # guarded-by: _results_cv

    # ------------------------------------------------------------ fleet API
    def fleet_unary(self, method: str, request: bytes) -> bytes:
        if method == "register":
            node_id = request.decode()
            with self._lock:
                # monotonic: the heartbeat feeds liveness arithmetic and
                # must not jump with the wall clock (NTP steps)
                self._nodes[node_id] = time.monotonic()
                self._task_queues.setdefault(node_id, deque())
            return b"OK"
        if method == "pull_task_ins":
            node_id = request.decode()
            with self._lock:
                q = self._task_queues.setdefault(node_id, deque())
                task_id, task = q.popleft() if q else ("", b"")
            return msgpack_lite.packb({"id": task_id, "task": task},
                                 use_bin_type=True)
        if method == "push_task_res":
            d = msgpack_lite.unpackb(request, raw=False)
            return b"OK" if self.push_task_result(d["id"], d["res"]) \
                else b"LATE"
        raise ValueError(f"unknown fleet method {method!r}")

    def pull_task_wait(self, node_id: str, timeout: float
                       ) -> Tuple[str, bytes]:
        """Long-poll variant of the fleet ``pull_task_ins``: block up to
        ``timeout`` seconds for a task instead of returning empty
        immediately.  The socket transport serves pulls with this so idle
        peers park server-side instead of generating poll chatter; the
        in-proc path keeps the instant (empty-capable) ``fleet_unary``.
        Returns ``("", b"")`` on timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            q = self._task_queues.setdefault(node_id, deque())
            while not q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return "", b""
                self._tasks_cv.wait(remaining)
            return q.popleft()

    def push_task_result(self, task_id: str, res: bytes) -> bool:
        """Complete ``task_id`` with ``res``; False if the round already
        gave up on it (tombstoned — the late result is dropped so it
        cannot leak into a later round).  This is the raw-body seam the
        socket transport pushes through: its TaskRes bytes arrive as
        read-only memoryviews over the receive buffer and are stored
        as-is, zero-copy."""
        dropped = False
        with self._results_cv:
            if task_id in self._expired:
                del self._expired[task_id]
                self.stats["late_dropped"] += 1
                dropped = True
            else:
                w = self._waiters.pop(task_id, None)
                if w is not None:
                    w.ready.append((task_id, res))   # O(1) routing
                else:
                    self._results[task_id] = res
                self._results_cv.notify_all()
        if dropped:
            self._result_released(task_id)
        return not dropped

    def mark_node_dead(self, node_id: str) -> bool:
        """Heartbeat expiry (socket transport): drop the node from the
        roster so the next round's ``node_ids`` excludes it.  Tasks it
        already pulled keep their normal fate — the round deadline
        demotes them to ``(node, "timeout")`` failure records — and
        queued-but-undelivered TaskIns stay queued, so a reconnect
        (re-register) resumes service where it left off.  Returns whether
        the node was actually in the roster (idempotent)."""
        with self._lock:
            return self._nodes.pop(node_id, None) is not None

    def _result_released(self, task_id: str) -> None:
        """Subclass hook: ``task_id``'s result bytes permanently left the
        completion queue (consumed by a waiter, dropped LATE, or
        discarded).  The socket transport returns the pushing peer's
        flow-control credits here.  Always invoked with no link locks
        held, so overrides may take their own locks or perform I/O."""

    # ------------------------------------------------------------ driver API
    def node_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._nodes)

    def push_task_ins(self, node_id: str, task: bytes) -> str:
        task_id = uuid.uuid4().hex
        with self._lock:
            self._task_queues.setdefault(node_id, deque()).append(
                (task_id, task))
            self._tasks_cv.notify_all()     # wake long-poll pulls
        return task_id

    def register_waiter(self, task_ids: Iterable[str]) -> _Waiter:
        """Open a completion-queue cursor over ``task_ids``: results for
        those ids are routed to it in O(1) as they land (results that
        already landed are moved in).  Pair with :meth:`release_waiter`
        — an abandoned waiter strands its routed results."""
        w = _Waiter()
        self._attach(w, task_ids)
        return w

    def add_to_waiter(self, w: _Waiter, task_ids: Iterable[str]) -> None:
        """Route additional task ids to an open waiter (streaming use)."""
        self._attach(w, task_ids)

    def _attach(self, w: _Waiter, task_ids: Iterable[str]) -> None:
        # the Condition's lock is an RLock, so this nests under callers
        # that already hold it
        with self._results_cv:
            for tid in task_ids:
                res = self._results.pop(tid, None)
                if res is not None:
                    w.ready.append((tid, res))   # landed before we waited
                else:
                    self._waiters[tid] = w
            if w.ready:
                self._results_cv.notify_all()

    def waiter_next(self, w: _Waiter,
                    deadline: float) -> Optional[Tuple[str, bytes]]:
        """Block until a result routed to ``w`` is available or
        ``deadline`` (``time.monotonic()`` timestamp) passes; returns
        ``(task_id, res_bytes)`` or ``None``.  Full-duration CV wait —
        no periodic polling, no per-wakeup id scan."""
        got: Optional[Tuple[str, bytes]] = None
        with self._results_cv:
            while not w.ready:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._results_cv.wait(remaining)
            if w.ready:
                got = w.ready.popleft()
        if got is not None:
            # outside the CV: the hook may take transport locks / do I/O
            self._result_released(got[0])
        return got

    def release_waiter(self, w: _Waiter,
                       task_ids: Iterable[str]) -> None:
        """Detach ``task_ids`` from ``w`` and return its undelivered
        routed results to the shared store, so a subsequent
        :meth:`discard` keeps the tombstone accounting exact."""
        with self._results_cv:
            for tid in task_ids:
                if self._waiters.get(tid) is w:
                    del self._waiters[tid]
            while w.ready:
                tid, res = w.ready.popleft()
                self._results[tid] = res

    def pull_any(self, task_ids: Iterable[str],
                 deadline: float) -> Optional[Tuple[str, bytes]]:
        """Completion queue: block until any of ``task_ids`` has a result
        or ``deadline`` (``time.monotonic()`` timestamp) passes.

        Returns ``(task_id, res_bytes)`` — the result is popped — or
        ``None`` on deadline.  The caller owns the remaining ids and must
        eventually :meth:`discard` the ones it gives up on.

        Compatibility wrapper: registers a throwaway waiter per call, so
        long-lived consumers (drivers, streams) should hold one waiter
        for their whole exchange instead.
        """
        ids = list(task_ids)
        w = self.register_waiter(ids)
        try:
            return self.waiter_next(w, deadline)
        finally:
            self.release_waiter(w, ids)

    def pull_task_res(self, task_id: str, timeout: float) -> bytes:
        got = self.pull_any([task_id], time.monotonic() + timeout)
        if got is None:
            self.discard([task_id])
            raise TimeoutError(f"task {task_id} timed out")
        return got[1]

    def discard(self, task_ids: Iterable[str]) -> None:
        """Give up on tasks: reap undelivered TaskIns from the node queues
        and tombstone in-flight ones so their late TaskRes is dropped."""
        ids = set(task_ids)
        if not ids:
            return
        undelivered: Set[str] = set()
        with self._lock:
            for node, q in self._task_queues.items():
                if any(tid in ids for tid, _ in q):
                    kept = deque(e for e in q if e[0] not in ids)
                    undelivered.update(tid for tid, _ in q if tid in ids)
                    self._task_queues[node] = kept
        now = time.monotonic()
        dropped: List[str] = []
        with self._results_cv:
            self.stats["discarded_ins"] += len(undelivered)
            for tid in ids:
                self._waiters.pop(tid, None)     # stop routing to cursors
                if self._results.pop(tid, None) is not None:
                    dropped.append(tid)          # landed but unwanted: done
                    continue
                if tid not in undelivered:
                    self._expired[tid] = now     # delivered, still in flight
            cutoff = now - _TOMBSTONE_TTL
            for tid in [t for t, ts in self._expired.items() if ts < cutoff]:
                del self._expired[tid]
        for tid in dropped:
            self._result_released(tid)


class TaskStream:
    """Persistent send/recv channel over the SuperLink completion queue —
    the async (FedBuff) transport: tasks go out at any time, results come
    back one at a time in arrival order, with no round barrier.  Holds
    ONE waiter for its whole lifetime (O(1) wakeups).  Not thread-safe;
    one stream per consumer."""

    def __init__(self, link: SuperLink):
        self.link = link
        self._waiter = link.register_waiter(())
        self._pending: Dict[str, str] = {}       # task_id -> node
        self._closed = False

    def send(self, tasks: Dict[str, bytes]) -> Dict[str, str]:
        """Push TaskIns bytes per node; returns ``node -> task_id``."""
        if self._closed:
            raise RuntimeError("send() on a closed TaskStream")
        out: Dict[str, str] = {}
        for node, t in sorted(tasks.items()):
            out[node] = tid = self.link.push_task_ins(node, t)
            self._pending[tid] = node
        self.link.add_to_waiter(self._waiter, list(out.values()))
        return out

    def recv(self, timeout: float
             ) -> Optional[Tuple[str, str, bytes]]:
        """Next arriving result as ``(node, task_id, res_bytes)``, or
        ``None`` if nothing lands within ``timeout`` seconds."""
        if self._closed:
            raise RuntimeError("recv() on a closed TaskStream")
        got = self.link.waiter_next(self._waiter,
                                    time.monotonic() + timeout)
        if got is None:
            return None
        tid, res = got
        return self._pending.pop(tid, ""), tid, res

    def close(self) -> None:
        """Give up on everything still in flight: undelivered TaskIns are
        reaped, in-flight tasks tombstoned so late results are dropped."""
        if self._closed:
            return
        self._closed = True
        pending = set(self._pending)
        self._pending.clear()
        self.link.release_waiter(self._waiter, pending)
        if pending:
            self.link.discard(pending)


class SuperLinkDriver(Driver):
    """Driver API implementation over a SuperLink instance.

    ``send_and_receive_iter`` is a **native streaming transport**: results
    yield in arrival order the moment they land on the completion queue,
    so decode+accumulate overlaps the stragglers' compute, and the whole
    batch shares a single deadline.
    """

    def __init__(self, superlink: SuperLink, expected_nodes: int = 0,
                 join_timeout: float = 30.0):
        self.link = superlink
        if expected_nodes:
            deadline = time.monotonic() + join_timeout
            while (len(self.link.node_ids()) < expected_nodes
                   and time.monotonic() < deadline):
                time.sleep(0.005)

    def node_ids(self) -> List[str]:
        return self.link.node_ids()

    def open_stream(self) -> TaskStream:
        """Streaming channel for the async server loop (ServerApp
        ``run_async``): no round barrier, one result per recv."""
        return TaskStream(self.link)

    def send_and_receive_iter(self, tasks: Dict[str, bytes],
                              timeout: float) -> Iterator[Tuple[str, bytes]]:
        ids = {self.link.push_task_ins(node, t): node
               for node, t in sorted(tasks.items())}
        deadline = time.monotonic() + timeout
        pending = set(ids)
        # one waiter for the whole round: each arrival is routed to it in
        # O(1), instead of rescanning all pending ids per wakeup
        w = self.link.register_waiter(ids)
        try:
            while pending:
                got = self.link.waiter_next(w, deadline)
                if got is None:
                    break                      # deadline: pending are lost
                tid, res = got
                pending.discard(tid)
                yield ids[tid], res
        finally:
            # also runs on generator close: never strand orphaned state
            self.link.release_waiter(w, pending)
            if pending:
                self.link.discard(pending)

    def send_and_receive(self, tasks: Dict[str, bytes],
                         timeout: float) -> Dict[str, bytes]:
        """Blocking batch API: all pulls share ONE deadline, so the total
        wait is <= timeout (+ scheduling ε), never N x timeout."""
        out = {node: res for node, res in
               self.send_and_receive_iter(tasks, timeout)}
        if len(out) < len(tasks):
            missing = sorted(set(tasks) - set(out))
            raise TimeoutError(
                f"tasks for nodes {missing} timed out after {timeout}s")
        return out


# ---------------------------------------------------------------------------
# connections (the pluggable wire)
# ---------------------------------------------------------------------------
class FleetConnection:
    """gRPC-shaped unary interface a SuperNode talks through.

    The typed wrappers are what the :class:`SuperNode` loop calls; their
    defaults ride :meth:`unary` with the in-proc msgpack envelopes, so
    existing connections (native, LGS) inherit them unchanged while the
    socket transport (``core/transport.py``, not ported yet)
    overrides them with zero-copy framed calls.
    """

    def unary(self, method: str, request: bytes) -> bytes:
        raise NotImplementedError

    def register(self, node_id: str) -> None:
        self.unary("register", node_id.encode())

    def pull_task(self, node_id: str) -> Tuple[str, bytes]:
        """Next queued TaskIns as ``(task_id, task_bytes)`` —
        ``("", b"")`` when the queue is empty."""
        d = msgpack_lite.unpackb(self.unary("pull_task_ins", node_id.encode()),
                            raw=False)
        return d["id"], d["task"]

    def push_result(self, task_id: str, res: bytes) -> None:
        self.unary("push_task_res",
                   msgpack_lite.packb({"id": task_id, "res": res},
                                 use_bin_type=True))

    def close(self) -> None:
        """Release transport resources (sockets, threads); in-proc
        connections have none."""


class NativeConnection(FleetConnection):
    """Direct in-process connection (Flower running 'alone')."""

    def __init__(self, superlink: SuperLink):
        self.link = superlink

    def unary(self, method: str, request: bytes) -> bytes:
        return self.link.fleet_unary(method, request)


class SuperNode:
    """Long-running client host: polls for tasks, runs the ClientApp.

    Transport failures (a dropped fleet call, a ReliableMessage timeout on
    the FLARE-bridged path) do NOT kill the node: the loop records them in
    ``transport_errors``, backs off briefly, and keeps serving — the
    server's round deadline turns any miss into a per-node failure.
    """

    def __init__(self, node_id: str, client_app: ClientApp,
                 connection: FleetConnection, poll_interval: float = 0.005):
        self.node_id = node_id
        self.app = client_app
        self.conn = connection
        self.poll_interval = poll_interval
        self.transport_errors = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self.conn.register(self.node_id)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"supernode-{self.node_id}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                task_id, task = self.conn.pull_task(self.node_id)
            except (RequestTimeout, ConnectionError, OSError):
                self.transport_errors += 1
                self._stop.wait(10 * self.poll_interval)
                continue
            if not task_id:
                self._stop.wait(self.poll_interval)
                continue
            try:
                res = self.app.handle(task, cid=self.node_id)
            except Exception as e:  # noqa: BLE001 — mod/decode blew up
                # outside ClientApp.handle's own guard: report the real
                # error instead of dying and ghosting as (node, "timeout")
                res = encode_task_res(TaskRes("error", 0, b"",
                                              error=repr(e)))
            try:
                self.conn.push_result(task_id, res)
            except (RequestTimeout, ConnectionError, OSError):
                # undeliverable result: the server's deadline records the
                # miss as (node, "timeout"); keep serving later rounds
                self.transport_errors += 1
                self._stop.wait(10 * self.poll_interval)

    def stop(self) -> None:
        self._stop.set()
        # closing first unblocks a pull parked in a socket long-poll, so
        # the join below is prompt on the TCP transport too
        self.conn.close()
        if self._thread:
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# hierarchical edge tier
# ---------------------------------------------------------------------------
class InlineFleetDriver(Driver):
    """Zero-thread Driver over in-process ClientApps: each task runs the
    child's ``handle`` synchronously, in sorted node order, honoring the
    shared deadline.  This is the 10k-simulated-client substrate — an
    edge tier mounts a handful of these (1250 inline clients each)
    instead of 10k polling SuperNode threads."""

    def __init__(self, apps: Dict[str, ClientApp]):
        self.apps = dict(apps)

    def node_ids(self) -> List[str]:
        return sorted(self.apps)

    def send_and_receive_iter(self, tasks: Dict[str, bytes],
                              timeout: float) -> Iterator[Tuple[str, bytes]]:
        deadline = time.monotonic() + timeout
        for node in sorted(tasks):
            if time.monotonic() > deadline:
                return             # remaining nodes become (node, timeout)
            yield node, self.apps[node].handle(tasks[node], cid=node)

    def send_and_receive(self, tasks: Dict[str, bytes],
                         timeout: float) -> Dict[str, bytes]:
        out = {node: res for node, res in
               self.send_and_receive_iter(tasks, timeout)}
        if len(out) < len(tasks):
            missing = sorted(set(tasks) - set(out))
            raise TimeoutError(f"tasks for nodes {missing} timed out")
        return out


class EdgeAggregatorApp:
    """Intermediate aggregation tier (hierarchical FL): mounts on a
    parent SuperNode exactly like a ClientApp, but fans every task out to
    its OWN child fleet and pre-reduces the subtree's fit results, so the
    root folds **O(#edges)** payloads instead of O(#clients).

    - fit with ``config["partial"]`` (set by the root when its strategy
      ``supports_partial()``): forward the pristine downlink bytes,
      fold child results through :class:`~repro_torch.fl.agg_kernels
      .StreamingWeightedSum` in sorted node order — the root's own
      canonical fold arithmetic, which is what makes the sync
      hierarchical aggregate bitwise-equal to the flat topology — and
      ship one ``Σw·x`` partial-sum frame (0xF4) carrying the subtree
      total weight, contributing ids, and absorbed per-node failures.
    - fit without the flag (root predates 0xF4, or runs a non-weighted-
      sum strategy): same fold, downgraded to a plain weighted-mean
      FitRes whose ``num_examples`` is the subtree's combined count, so
      the root's ordinary weighted average stays exact.
    - evaluate: example-weighted mean of child losses/metrics.
    - get_properties: intersection of the children's codec sets.
    - get_parameters: first child success (probed one at a time).

    A nested edge below this one is folded via ``add_partial`` — tiers
    compose.  ``backend`` and ``device`` choose where the edge folds, as
    ``ServerConfig.agg_backend`` / ``agg_device`` do for the root (None:
    the process default backend, and the CUDA card).
    """

    def __init__(self, child_driver: Driver, edge_id: str = "edge",
                 timeout: float = 60.0, backend: Optional[str] = None,
                 device=None):
        self.driver = child_driver
        self.edge_id = edge_id
        self.timeout = timeout
        self.backend = backend
        self.device = device

    # ------------------------------------------------------------ dispatch
    def handle(self, task_ins_bytes: bytes, cid: str = "0") -> bytes:
        task = decode_task_ins(task_ins_bytes)
        try:
            if task.task_type == "fit":
                return encode_task_res(self._fit(task))
            if task.task_type == "evaluate":
                return encode_task_res(self._evaluate(task))
            if task.task_type == "get_parameters":
                return encode_task_res(self._get_parameters(task))
            if task.task_type == "get_properties":
                return encode_task_res(self._get_properties(task))
            return encode_task_res(
                TaskRes(task.task_type, task.round, b"",
                        task_id=task.task_id, error="unknown task type"))
        except Exception as e:  # noqa: BLE001 — a broken subtree must
            # surface as this edge's per-node failure, not kill the host
            return encode_task_res(
                TaskRes(task.task_type, task.round, b"",
                        task_id=task.task_id, error=repr(e)))

    def _scatter(self, task: TaskIns
                 ) -> Tuple[List[Tuple[str, TaskRes]],
                            List[Tuple[str, str]]]:
        """Forward the pristine TaskIns bytes to every child under one
        shared deadline.  Returns (sorted successes, sorted failures) —
        sorted so the fold order is canonical regardless of arrival."""
        nodes = sorted(self.driver.node_ids())
        raw = encode_task_ins(task)
        results: List[Tuple[str, TaskRes]] = []
        failures: List[Tuple[str, str]] = []
        received = set()
        for node, tr_bytes in self.driver.send_and_receive_iter(
                {node: raw for node in nodes}, self.timeout):
            received.add(node)
            try:
                tr = decode_task_res(tr_bytes)
            except Exception as e:  # noqa: BLE001 — byzantine child
                failures.append((node, f"malformed response: {e!r}"))
                continue
            if tr.error:
                failures.append((node, tr.error))
            else:
                results.append((node, tr))
        failures.extend((n, "timeout") for n in nodes if n not in received)
        results.sort(key=lambda kv: kv[0])
        failures.sort()
        return results, failures

    # ------------------------------------------------------------- phases
    def _fit(self, task: TaskIns) -> TaskRes:
        want_partial = bool(peek_config(task.payload).get("partial"))
        results, failures = self._scatter(task)
        if not results:
            return TaskRes("fit", task.round, b"", task_id=task.task_id,
                           error=f"no child produced a fit result "
                                 f"(failures: {failures})")
        acc: Optional[kernels.StreamingWeightedSum] = None
        base = None     # lazy: only delta-quantized children need it
        node_ids: List[str] = []
        for node, tr in results:       # sorted: the canonical fold order
            res = decode_fit_res(tr.payload)
            if res.partial is not None:
                ps = res.partial       # nested edge: continue its sum
                if acc is None:
                    acc = kernels.StreamingWeightedSum(
                        ps.layout, self.backend, device=self.device)
                acc.add_partial(ps)
                node_ids.extend(ps.node_ids)
                failures.extend(ps.failures)
                continue
            q = res.quant
            if q is not None and q.is_delta and q.base is None:
                if base is None:
                    # the downlink we forwarded verbatim IS what the
                    # child trained from — same base the root would use
                    base = peek_params(task.payload)
                q.base = base
            sp = res.sparse
            if sp is not None and sp.base is None:
                if base is None:
                    base = peek_params(task.payload)
                # the deferred base lands in raw_sum()/finalize(), so the
                # 0xF4 partial this edge frames stays the true subtree sum
                sp.base = base
            fp = _flat_of(res)
            if acc is None:
                acc = kernels.StreamingWeightedSum(fp.layout, self.backend,
                                                   device=self.device)
            acc.add(fp, float(res.num_examples))
            node_ids.append(node)
        if want_partial:
            ps = PartialSum(acc.layout, acc.raw_sum(), acc.total_w,
                            acc.count, tuple(sorted(node_ids)),
                            tuple(failures))
            return TaskRes("fit", task.round, encode_partial_fit_res(ps),
                           task_id=task.task_id)
        # downgrade path: the root doesn't speak 0xF4 — ship the subtree
        # weighted mean with the combined example count instead
        mean = acc.finalize()
        out = FitRes(None, int(round(acc.total_w)), {}, flat=mean)
        return TaskRes("fit", task.round, encode_fit_res(out),
                       task_id=task.task_id)

    def _evaluate(self, task: TaskIns) -> TaskRes:
        results, failures = self._scatter(task)
        if not results:
            return TaskRes("evaluate", task.round, b"",
                           task_id=task.task_id,
                           error=f"no child produced an evaluate result "
                                 f"(failures: {failures})")
        tot_loss, tot_n = 0.0, 0
        sums: Dict[str, float] = {}
        for _node, tr in results:
            ev = decode_evaluate_res(tr.payload)
            tot_loss += float(ev.loss) * ev.num_examples
            tot_n += ev.num_examples
            for k, v in ev.metrics.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    sums[k] = sums.get(k, 0.0) + float(v) * ev.num_examples
        n = max(tot_n, 1)
        out = EvaluateRes(tot_loss / n, tot_n,
                          {k: v / n for k, v in sums.items()})
        return TaskRes("evaluate", task.round, encode_evaluate_res(out),
                       task_id=task.task_id)

    def _get_parameters(self, task: TaskIns) -> TaskRes:
        raw = encode_task_ins(task)
        errors: List[Tuple[str, str]] = []
        for node in sorted(self.driver.node_ids()):
            try:
                out = self.driver.send_and_receive({node: raw},
                                                   self.timeout)
            except TimeoutError:
                errors.append((node, "timeout"))
                continue
            tr = decode_task_res(out[node])
            if tr.error:
                errors.append((node, tr.error))
                continue
            return TaskRes("get_parameters", task.round, tr.payload,
                           task_id=task.task_id)
        return TaskRes("get_parameters", task.round, b"",
                       task_id=task.task_id,
                       error=f"no child returned parameters: {errors}")

    def _get_properties(self, task: TaskIns) -> TaskRes:
        results, failures = self._scatter(task)
        if not results:
            return TaskRes("get_properties", task.round, b"",
                           task_id=task.task_id,
                           error=f"no child responded (failures: "
                                 f"{failures})")
        codecs: Optional[Set[str]] = None
        for _node, tr in results:
            cs = set(decode_properties_res(tr.payload)
                     .get("codecs", ("flat", "legacy")))
            codecs = cs if codecs is None else codecs & cs
        return TaskRes("get_properties", task.round,
                       encode_properties_res({"codecs": sorted(codecs)}),
                       task_id=task.task_id)


def make_edge_tier(link: SuperLink, apps: Dict[str, ClientApp],
                   num_edges: int, timeout: float = 60.0,
                   backend: Optional[str] = None, device=None
                   ) -> List[SuperNode]:
    """Partition ``apps`` into ``num_edges`` contiguous (sorted) groups,
    give each group an :class:`InlineFleetDriver` child fleet wrapped in
    an :class:`EdgeAggregatorApp` folding with ``backend`` on ``device``,
    and mount the edges as SuperNodes on ``link`` (ids ``edge-0 ..
    edge-{n-1}``).  Returns the started nodes; the caller stops them."""
    names = sorted(apps)
    if not 1 <= num_edges <= len(names):
        raise ValueError(f"num_edges must be in [1, {len(names)}], "
                         f"got {num_edges}")
    edges: List[SuperNode] = []
    for e in range(num_edges):
        lo = e * len(names) // num_edges
        hi = (e + 1) * len(names) // num_edges
        child = InlineFleetDriver({n: apps[n] for n in names[lo:hi]})
        app = EdgeAggregatorApp(child, edge_id=f"edge-{e}",
                                timeout=timeout, backend=backend,
                                device=device)
        sn = SuperNode(f"edge-{e}", app, NativeConnection(link))
        sn.start()
        edges.append(sn)
    return edges
