"""The port's socket transport: ports of ``tests/test_transport.py``.

Flow control (``CreditGate``/``CreditLedger``), framing, and the TCP Fleet
path (multiplexing, credit exhaustion, reconnect-resume dedup, push
resend, heartbeat expiry, the 16-process round bitwise against the
in-process fold, kill -9 mid-round, TLS loopback, client timeout) run on
``repro_torch.core.transport``.  Frames are byte-identical across the
packages, so a mixed fleet -- the port's SuperNodes against the
reference's ``TcpSuperLink``, and the reference's SuperNodes against the
port's -- gives histories bitwise equal to the all-reference fleet's; and
inside the port ``run_tcp``'s history is bitwise ``run_native``'s.

The reference is imported inside the tests that use it: the spawned
SuperNode processes import this module and need only the port.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import multiprocessing as mp
import socket
import ssl
import struct
import subprocess
import threading
import time

import numpy as np
import pytest

from repro_torch.core import run_native
from repro_torch.core.flowcontrol import CreditGate, CreditLedger
from repro_torch.core.framing import (FT_HELLO, FT_PING, FT_REQ,
                                      FT_RES, FT_WELCOME, FrameError,
                                      FrameReader, control_frame,
                                      data_frame_parts, frame_nbytes,
                                      pack_unary, parse_control, send_parts,
                                      split_data, unpack_unary)
from repro_torch.core.interop import run_tcp
from repro_torch.core.superlink import SuperLinkDriver, SuperNode
from repro_torch.core.transport import (TcpFleetConnection, TcpSuperLink,
                                        run_supernode)
from repro_torch.fl import ClientApp, NumPyClient, ServerApp, ServerConfig
from repro_torch.fl.quickstart import make_client_app
from repro_torch.fl.strategy import FedAvg, make_strategy
from repro_torch.runtime.reliable import RequestTimeout

#: every join and socket wait in this file is bounded by this (seconds)
JOIN_S = 30


# ---------------------------------------------------------------------------
# framing (the port's core/framing.py under the transport)
# ---------------------------------------------------------------------------
def test_control_frame_roundtrip_byte_at_a_time():
    frame = control_frame(FT_HELLO, {"node": "site-1", "proto": 1})
    r = FrameReader()
    got = []
    for i in range(len(frame)):
        got.extend(r.feed(frame[i:i + 1]))
    assert len(got) == 1
    ftype, payload = got[0]
    assert ftype == FT_HELLO
    assert parse_control(payload) == {"node": "site-1", "proto": 1}


def test_many_frames_in_one_chunk():
    blob = b"".join(control_frame(FT_PING, {"t": float(i)}) for i in range(7))
    got = FrameReader().feed(blob)
    assert [parse_control(p)["t"] for _, p in got] == [float(i)
                                                       for i in range(7)]


def test_data_frame_zero_copy_body():
    body = np.arange(1024, dtype=np.float32).tobytes()
    parts = data_frame_parts(FT_REQ, {"i": "n:0", "m": "push_task_res"}, body)
    assert frame_nbytes(parts) == sum(len(p) for p in parts)
    (ftype, payload), = FrameReader().feed(b"".join(parts))
    assert ftype == FT_REQ
    header, view = split_data(payload)
    assert header == {"i": "n:0", "m": "push_task_res"}
    assert isinstance(view, memoryview) and view.readonly
    # repro: allow[alias-writeable] reason=view is readonly; write asserted to raise below
    arr = np.frombuffer(view, dtype=np.float32)
    assert arr.tobytes() == body
    with pytest.raises((TypeError, ValueError)):
        # repro: allow[alias-mutation] reason=asserting the frozen view rejects writes
        arr[0] = 1.0


def test_empty_body_frame_and_limits():
    parts = data_frame_parts(FT_RES, {"i": "n:1"}, b"")
    assert len(parts) == 1
    (_, payload), = FrameReader().feed(b"".join(parts))
    header, view = split_data(payload)
    assert header == {"i": "n:1"} and view.nbytes == 0
    with pytest.raises(FrameError):
        FrameReader(max_frame=64).feed(b"\xff\xff\xff\xff")
    with pytest.raises(FrameError):
        FrameReader().feed(b"\x00\x00\x00\x00")
    bad = struct.pack("<I", 255)
    frame = struct.pack("<I", 1 + len(bad)) + bytes((FT_REQ,)) + bad
    (_, view), = FrameReader().feed(frame)
    with pytest.raises(FrameError):
        split_data(view)
    assert unpack_unary(pack_unary("push_task_res", b"\x00\x01payload")) \
        == ("push_task_res", b"\x00\x01payload")


def test_frames_byte_identical_to_the_reference():
    from repro.core import framing as R
    body = np.arange(333, dtype=np.float32).tobytes()
    hdr = {"i": "n:7", "m": "push_task_res", "id": "t-3"}
    assert b"".join(data_frame_parts(FT_REQ, hdr, body)) == \
        b"".join(R.data_frame_parts(R.FT_REQ, hdr, body))
    ctl = {"node": "site-2", "proto": 1, "credits": 1 << 20}
    assert control_frame(FT_WELCOME, ctl) == \
        R.control_frame(R.FT_WELCOME, ctl)


# ---------------------------------------------------------------------------
# flow control
# ---------------------------------------------------------------------------
def test_credit_gate_blocks_until_grant():
    gate = CreditGate()
    gate.reset(100, 1000)
    assert gate.acquire(100, time.monotonic() + 1)
    done = threading.Event()

    def blocked():
        assert gate.acquire(50, time.monotonic() + 5)
        done.set()

    t = threading.Thread(target=blocked)
    t.start()
    time.sleep(0.05)
    assert not done.is_set()
    gate.grant(50)
    t.join(timeout=5)
    assert done.is_set()


def test_credit_gate_deadline_and_close():
    gate = CreditGate()
    gate.reset(0, 100)
    assert not gate.acquire(10, time.monotonic() + 0.05)
    gate.close()
    with pytest.raises(ConnectionError):
        gate.acquire(10, time.monotonic() + 1)


def test_credit_gate_oversized_frame_overshoots_once():
    gate = CreditGate()
    gate.reset(100, 100)
    assert gate.acquire(250, time.monotonic() + 1)
    assert gate.balance() == -150
    assert not gate.acquire(1, time.monotonic() + 0.05)
    gate.grant(10 ** 9)
    assert gate.balance() == 100


def test_credit_ledger_accounting():
    led = CreditLedger(800)
    assert led.debit(700) and led.outstanding() == 700
    assert led.release(10) == 0
    assert led.release(95) == 105
    assert led.debit(800)
    assert not led.debit(800)
    led2 = CreditLedger(1000)
    led2.debit(400)
    led2.release(50)
    assert led2.snapshot_for_welcome() == 650
    assert led2.release(75) == 0


# ---------------------------------------------------------------------------
# TCP integration
# ---------------------------------------------------------------------------
def _drain_frames(reader, sock, want=1, deadline=10.0):
    frames = []
    end = time.monotonic() + deadline
    while len(frames) < want and time.monotonic() < end:
        try:
            got = reader.read_from(sock)
        except socket.timeout:
            continue
        if got is None:
            break
        frames.extend(got)
    return frames


@pytest.mark.tcp
def test_tcp_register_pull_push_multiplexed():
    with TcpSuperLink("127.0.0.1", 0, poll_wait=2.0) as link:
        host, port = link.address
        conns = {s: TcpFleetConnection(host, port, s)
                 for s in ("site-a", "site-b")}
        try:
            for s, c in conns.items():
                c.register(s)
            assert sorted(link.node_ids()) == ["site-a", "site-b"]
            tids = {}
            for s in conns:
                for k in range(3):
                    tids[link.push_task_ins(s, f"task-{s}-{k}".encode())] = s

            def worker(site):
                c = conns[site]
                while True:
                    tid, task = c.pull_task(site)
                    if not tid:
                        return
                    c.push_result(tid, b"done:" + bytes(task))

            ts = [threading.Thread(target=worker, args=(s,)) for s in conns]
            for t in ts:
                t.start()
            got = {}
            deadline = time.monotonic() + 20
            while len(got) < 6:
                item = link.pull_any(list(tids), deadline)
                assert item is not None, "round lost a result"
                got[item[0]] = bytes(item[1])
            for t in ts:
                t.join(timeout=JOIN_S)
            assert set(got) == set(tids)
            for tid, site in tids.items():
                assert got[tid].startswith(b"done:task-" + site.encode())
        finally:
            for c in conns.values():
                c.close()


@pytest.mark.tcp
def test_tcp_credit_exhaustion_blocks_sender_not_server():
    with TcpSuperLink("127.0.0.1", 0, credits_per_peer=8192,
                      poll_wait=0.1) as link:
        host, port = link.address
        fast = TcpFleetConnection(host, port, "fast", request_timeout=30.0)
        other = TcpFleetConnection(host, port, "other")
        try:
            fast.register("fast")
            other.register("other")
            payload = bytes(5000)
            fast.push_result("t-1", payload)
            stalled_done = threading.Event()

            def stalled_push():
                fast.push_result("t-2", payload)
                stalled_done.set()

            t = threading.Thread(target=stalled_push)
            t.start()
            time.sleep(0.3)
            assert not stalled_done.is_set()
            assert fast._gate.balance() < len(payload)
            tid = link.push_task_ins("other", b"ping")
            assert other.pull_task("other") == (tid, b"ping")
            got = link.pull_any(["t-1"], time.monotonic() + 5)
            assert got is not None and bytes(got[1]) == payload
            t.join(timeout=JOIN_S)
            assert stalled_done.is_set()
            got = link.pull_any(["t-2"], time.monotonic() + 5)
            assert got is not None and bytes(got[1]) == payload
        finally:
            fast.close()
            other.close()


def _raw_hello(host, port, node):
    sock = socket.create_connection((host, port), timeout=5)
    sock.settimeout(0.2)
    send_parts(sock, control_frame(FT_HELLO, {"node": node, "proto": 1}))
    reader = FrameReader()
    (ftype, payload), = _drain_frames(reader, sock)
    assert ftype == FT_WELCOME
    return sock, reader, parse_control(payload)


@pytest.mark.tcp
def test_tcp_reconnect_resume_dedup():
    with TcpSuperLink("127.0.0.1", 0, poll_wait=2.0) as link:
        host, port = link.address
        tid = link.push_task_ins("raw-1", b"the-one-task")
        sock, reader, welcome = _raw_hello(host, port, "raw-1")
        pull = b"".join(data_frame_parts(
            FT_REQ, {"i": "raw-1:0", "m": "pull_task_ins"}, b""))
        sock.sendall(pull)
        (ftype, payload), = _drain_frames(reader, sock)
        header, body = split_data(payload)
        assert ftype == FT_RES and header["id"] == tid
        assert bytes(body) == b"the-one-task"

        sock.close()
        sock2, reader2, welcome2 = _raw_hello(host, port, "raw-1")
        assert welcome2["credits"] == welcome["credits"]
        sock2.sendall(pull)
        (_, payload), = _drain_frames(reader2, sock2)
        header, body = split_data(payload)
        assert header["id"] == tid
        assert bytes(body) == b"the-one-task"
        fresh = b"".join(data_frame_parts(
            FT_REQ, {"i": "raw-1:1", "m": "pull_task_ins"}, b""))
        sock2.sendall(fresh)
        (_, payload), = _drain_frames(reader2, sock2, deadline=15.0)
        header, _ = split_data(payload)
        assert header["i"] == "raw-1:1" and header["id"] == ""
        sock2.close()


@pytest.mark.tcp
def test_tcp_push_resend_does_not_double_apply():
    with TcpSuperLink("127.0.0.1", 0) as link:
        host, port = link.address
        sock, reader, _ = _raw_hello(host, port, "raw-2")
        push = b"".join(data_frame_parts(
            FT_REQ, {"i": "raw-2:0", "m": "push_task_res", "id": "tid-1"},
            b"result-bytes"))
        sock.sendall(push)
        (_, payload), = _drain_frames(reader, sock)
        assert split_data(payload)[0]["s"] == "OK"
        sock.sendall(push)
        (_, payload), = _drain_frames(reader, sock)
        assert split_data(payload)[0]["s"] == "OK"
        got = link.pull_any(["tid-1"], time.monotonic() + 5)
        assert got is not None and bytes(got[1]) == b"result-bytes"
        assert link.stats["late_dropped"] == 0
        deadline = time.monotonic() + 5
        while link._peers["raw-2"].ledger.outstanding() > 0:
            assert time.monotonic() < deadline, "credits never released"
            time.sleep(0.01)
        sock.close()


@pytest.mark.tcp
def test_tcp_heartbeat_expiry_drops_peer():
    with TcpSuperLink("127.0.0.1", 0, heartbeat_timeout=0.4) as link:
        host, port = link.address
        sock, _, _ = _raw_hello(host, port, "quiet")
        assert "quiet" in link.node_ids()
        deadline = time.monotonic() + 5
        while "quiet" in link.node_ids():
            assert time.monotonic() < deadline, "reaper never fired"
            time.sleep(0.05)
        sock.close()


# --------------------------------------------------------- process fleet
class DeterministicClient(NumPyClient):
    """fit adds a site-derived constant: any two fleets can be compared
    bitwise."""

    def __init__(self, cid: str):
        self.cid = cid
        self.idx = int(cid.rsplit("-", 1)[-1])

    def fit(self, parameters, config):
        out = [np.asarray(p, dtype=np.float32) + np.float32(self.idx + 1)
               for p in parameters]
        return out, 10 + self.idx, {}

    def evaluate(self, parameters, config):
        loss = float(sum(np.abs(np.asarray(p)).sum() for p in parameters))
        return loss, 10 + self.idx, {}


class BlockingClient(NumPyClient):
    """Never answers: stands in for a client that will be SIGKILLed."""

    def fit(self, parameters, config):
        time.sleep(600)
        return parameters, 1, {}

    def evaluate(self, parameters, config):
        time.sleep(600)
        return 0.0, 1, {}


def _det_app(node_id: str) -> ClientApp:
    return ClientApp(lambda cid, n=node_id: DeterministicClient(n)
                     .to_client())


def _blocking_app(node_id: str) -> ClientApp:
    return ClientApp(lambda cid: BlockingClient().to_client())


def _initial():
    return [np.linspace(-1.0, 1.0, 32, dtype=np.float32).reshape(8, 4),
            np.zeros(8, dtype=np.float32)]


def _det_server_app(rounds: int, timeout: float, codec=None) -> ServerApp:
    strat = make_strategy("fedavg", initial_parameters=_initial())
    return ServerApp(ServerConfig(num_rounds=rounds, round_timeout=timeout,
                                  codec=codec, agg_device="cpu"), strat)


def _inproc(app_fn, sites, rounds=2, codec=None):
    from repro_torch.core.superlink import NativeConnection, SuperLink
    link = SuperLink()
    nodes = [SuperNode(s, app_fn(s), NativeConnection(link)) for s in sites]
    for n in nodes:
        n.start()
    try:
        return _det_server_app(rounds, 60.0, codec).run(
            SuperLinkDriver(link, expected_nodes=len(sites)))
    finally:
        for n in nodes:
            n.stop()


N_PROCS = 16


@pytest.mark.tcp
@pytest.mark.slow
def test_tcp_16proc_round_bitwise_vs_inproc():
    """16 SuperNode processes over real sockets land the in-process
    aggregates bitwise."""
    sites = [f"proc-{i}" for i in range(N_PROCS)]
    h_ref = _inproc(_det_app, sites)
    ctx = mp.get_context("spawn")
    with TcpSuperLink("127.0.0.1", 0, poll_wait=1.0,
                      heartbeat_timeout=60.0) as link:
        host, port = link.address
        procs = [ctx.Process(target=run_supernode,
                             args=(host, port, s, _det_app),
                             kwargs=dict(run_seconds=240.0,
                                         max_disconnected=10.0),
                             daemon=True)
                 for s in sites]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + 200
            while len(link.node_ids()) < N_PROCS:
                assert time.monotonic() < deadline, \
                    f"only {len(link.node_ids())}/{N_PROCS} joined"
                time.sleep(0.2)
            h_tcp = _det_server_app(2, 60.0).run(
                SuperLinkDriver(link, expected_nodes=N_PROCS))
        finally:
            link.close()
            for p in procs:
                p.join(timeout=JOIN_S)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=JOIN_S)
    assert h_tcp.losses() == h_ref.losses()
    for a, b in zip(h_tcp.final_parameters, h_ref.final_parameters):
        assert a.tobytes() == b.tobytes()
    assert all(not r.failures for r in h_tcp.rounds)


@pytest.mark.tcp
def test_tcp_kill9_client_mid_round_records_timeout():
    ctx = mp.get_context("spawn")
    with TcpSuperLink("127.0.0.1", 0, poll_wait=0.2,
                      heartbeat_timeout=1.0) as link:
        host, port = link.address
        victim = ctx.Process(target=run_supernode,
                             args=(host, port, "victim", _blocking_app),
                             kwargs=dict(run_seconds=240.0,
                                         heartbeat_interval=0.2,
                                         max_disconnected=5.0),
                             daemon=True)
        victim.start()
        good = SuperNode("good", _det_app("good-0"),
                         TcpFleetConnection(host, port, "good"))
        good.start()
        try:
            deadline = time.monotonic() + 120
            while len(link.node_ids()) < 2:
                assert time.monotonic() < deadline, "fleet never formed"
                time.sleep(0.1)
            killer = threading.Timer(1.0, victim.kill)
            killer.start()
            try:
                h = _det_server_app(1, 8.0).run(
                    SuperLinkDriver(link, expected_nodes=2))
            finally:
                killer.cancel()
            assert len(h.rounds) == 1
            assert ("victim", "timeout") in h.rounds[0].failures
            assert all(n == "victim" for n, _ in h.rounds[0].failures)
            assert np.isfinite(h.losses()[-1][1])
            assert "victim" not in link.node_ids()
        finally:
            good.stop()
            victim.join(timeout=JOIN_S)
            if victim.is_alive():
                victim.kill()
                victim.join(timeout=JOIN_S)


# ------------------------------------------------------------------- TLS
@pytest.fixture(scope="module")
def tls_contexts(tmp_path_factory):
    d = tmp_path_factory.mktemp("tls")
    cert, key = d / "cert.pem", d / "key.pem"
    r = subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1",
         "-addext", "subjectAltName=IP:127.0.0.1"],
        capture_output=True, timeout=60)
    if r.returncode != 0:
        pytest.skip(f"openssl unavailable: {r.stderr.decode()[:200]}")
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(str(cert), str(key))
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.load_verify_locations(str(cert))
    return server, client


@pytest.mark.tcp
def test_tcp_tls_loopback_roundtrip(tls_contexts):
    server_ctx, client_ctx = tls_contexts
    with TcpSuperLink("127.0.0.1", 0, ssl_context=server_ctx,
                      poll_wait=2.0) as link:
        host, port = link.address
        conn = TcpFleetConnection(host, port, "tls-1",
                                  ssl_context=client_ctx,
                                  server_hostname="127.0.0.1")
        try:
            conn.register("tls-1")
            tid = link.push_task_ins("tls-1", b"secure-task")
            assert conn.pull_task("tls-1") == (tid, b"secure-task")
            conn.push_result(tid, b"secure-res")
            got = link.pull_any([tid], time.monotonic() + 5)
            assert got is not None and bytes(got[1]) == b"secure-res"
        finally:
            conn.close()


@pytest.mark.tcp
def test_tcp_client_timeout_surfaces_as_request_timeout():
    conn = TcpFleetConnection("127.0.0.1", 1, "nobody",
                              request_timeout=0.3, connect_timeout=0.2)
    try:
        with pytest.raises((RequestTimeout, ConnectionError)):
            conn.register("nobody")
    finally:
        conn.close()


@pytest.mark.tcp
def test_tcp_node_send_waits_for_an_undrained_socket():
    """A server that leaves a node's socket undrained for 20x the node's
    read poll (half its 0.1 s PING interval) still receives the node's
    16 MB upload whole, on the first connection: the send waits for the
    socket to drain instead of timing out mid-frame."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    # a small receive window (inherited by the accepted socket), so the
    # node's send fills the buffers and blocks
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 64 << 10)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(4)
    lsock.settimeout(JOIN_S)
    host, port = lsock.getsockname()
    payload = np.random.default_rng(0).integers(
        0, 256, 16 << 20, dtype=np.uint8).tobytes()
    conn = TcpFleetConnection(host, port, "slow-drain",
                              heartbeat_interval=0.1,
                              heartbeat_timeout=JOIN_S,
                              request_timeout=JOIN_S)
    sock = None
    try:
        sock, _ = lsock.accept()
        sock.settimeout(0.2)
        reader = FrameReader()
        (ftype, hello), = _drain_frames(reader, sock)
        assert ftype == FT_HELLO
        send_parts(sock, control_frame(FT_WELCOME, {
            "credits": 64 << 20, "limit": 64 << 20, "hb": JOIN_S}))
        # the node's first PING: its connection is up
        (ftype, _), = _drain_frames(reader, sock)
        assert ftype == FT_PING
        errors = []

        def push():
            try:
                conn.push_result("tid-1", payload)
            except Exception as e:  # noqa: BLE001 -- asserted below
                errors.append(e)

        t = threading.Thread(target=push)
        t.start()
        time.sleep(1.0)            # undrained: the old send timeout x 20
        req = None
        deadline = time.monotonic() + JOIN_S
        while req is None and time.monotonic() < deadline:
            for ftype, frame in _drain_frames(reader, sock, deadline=1.0):
                if ftype == FT_REQ:
                    req = split_data(frame)
        assert req is not None, "the upload never arrived whole"
        header, body = req
        assert header["m"] == "push_task_res" and header["id"] == "tid-1"
        assert bytes(body) == payload
        send_parts(sock, *data_frame_parts(FT_RES, {"i": header["i"]}, b""))
        t.join(timeout=JOIN_S)
        assert not t.is_alive() and errors == []
        # no reconnect: the node never came back through the listener
        lsock.settimeout(0.5)
        with pytest.raises(socket.timeout):
            lsock.accept()
    finally:
        conn.close()
        if sock is not None:
            sock.close()
        lsock.close()


# ------------------------------------------------- full-app equivalence
QS_SITES = ["site-1", "site-2", "site-3"]


def _qs_clients(site):
    return make_client_app(site, device="cpu")


def _qs_server_app(codec, transport):
    return ServerApp(config=ServerConfig(num_rounds=2, round_timeout=60,
                                         codec=codec, agg_device="cpu",
                                         transport=transport),
                     strategy=FedAvg())


@pytest.mark.tcp
@pytest.mark.slow
@pytest.mark.parametrize("codec", [None, "q8"])
def test_run_tcp_equals_run_native_bitwise(codec):
    """The quickstart over sockets (``ServerConfig(transport="tcp")``
    through ``run_native``, and ``run_tcp`` itself) reproduces the
    in-process run bit for bit."""
    h_ref = run_native(_qs_server_app(codec, "inproc"), _qs_clients,
                       QS_SITES)
    h_tcp = run_native(_qs_server_app(codec, "tcp"), _qs_clients, QS_SITES)
    h_direct = run_tcp(_qs_server_app(codec, "inproc"), _qs_clients,
                       QS_SITES)
    for h in (h_tcp, h_direct):
        assert h.losses() == h_ref.losses()
        for a, b in zip(h.final_parameters, h_ref.final_parameters):
            assert a.tobytes() == b.tobytes()
    losses = [l for _, l in h_ref.losses()]
    assert losses[-1] < losses[0]


# ------------------------------------------------------- the mixed fleet
MIX_SITES = [f"mix-{i}" for i in range(4)]


def _ref_det_app(node_id: str):
    from repro.fl import ClientApp as RClientApp
    from repro.fl import NumPyClient as RNumPyClient

    class RefDeterministic(RNumPyClient):
        fit = DeterministicClient.fit
        evaluate = DeterministicClient.evaluate

        def __init__(self, cid):
            DeterministicClient.__init__(self, cid)

    return RClientApp(lambda cid, n=node_id: RefDeterministic(n).to_client())


def _ref_server_app(codec):
    from repro.fl import ServerApp as RServerApp
    from repro.fl import ServerConfig as RServerConfig
    from repro.fl.strategy import make_strategy as ref_make_strategy
    strat = ref_make_strategy("fedavg", initial_parameters=_initial())
    return RServerApp(RServerConfig(num_rounds=2, round_timeout=60.0,
                                    codec=codec), strat)


def _fleet(link_cls, driver_cls, server_app, node_cls, conn_cls, app_fn):
    """``server_app`` on a ``link_cls`` TCP link, one ``node_cls`` SuperNode
    per mixed site over ``conn_cls``."""
    with link_cls("127.0.0.1", 0, poll_wait=1.0) as link:
        host, port = link.address
        nodes = [node_cls(s, app_fn(s), conn_cls(host, port, s))
                 for s in MIX_SITES]
        for n in nodes:
            n.start()
        try:
            return server_app.run(driver_cls(link,
                                             expected_nodes=len(MIX_SITES)))
        finally:
            for n in nodes:
                n.stop()


def _same_history(a, b):
    assert a.losses() == b.losses()
    assert len(a.final_parameters) == len(b.final_parameters)
    for x, y in zip(a.final_parameters, b.final_parameters):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.tcp
@pytest.mark.parametrize("codec", [None, "q8"])
def test_mixed_fleet_port_nodes_against_reference_link(codec):
    """The port's SuperNodes and connections against the reference's
    ``TcpSuperLink`` and ServerApp: the all-reference fleet's history,
    bitwise."""
    from repro.core import superlink as RS
    from repro.core import transport as RT
    h_ref = _fleet(RT.TcpSuperLink, RS.SuperLinkDriver, _ref_server_app(codec),
                   RS.SuperNode, RT.TcpFleetConnection, _ref_det_app)
    h_mix = _fleet(RT.TcpSuperLink, RS.SuperLinkDriver, _ref_server_app(codec),
                   SuperNode, TcpFleetConnection, _det_app)
    _same_history(h_mix, h_ref)


@pytest.mark.tcp
@pytest.mark.parametrize("codec", [None, "q8"])
def test_mixed_fleet_reference_nodes_against_port_link(codec):
    """The reference's SuperNodes and connections against the port's
    ``TcpSuperLink`` and ServerApp: the all-reference fleet's history,
    bitwise."""
    from repro.core import superlink as RS
    from repro.core import transport as RT
    h_ref = _fleet(RT.TcpSuperLink, RS.SuperLinkDriver, _ref_server_app(codec),
                   RS.SuperNode, RT.TcpFleetConnection, _ref_det_app)
    h_mix = _fleet(TcpSuperLink, SuperLinkDriver,
                   _det_server_app(2, 60.0, codec), RS.SuperNode,
                   RT.TcpFleetConnection, _ref_det_app)
    _same_history(h_mix, h_ref)
