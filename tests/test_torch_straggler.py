"""Straggler / dead-node / timeout semantics (the fault-tolerance story).

One slow or dead SuperNode must never abort a round: the completion queue
yields results in arrival order under a single shared deadline, stragglers
demote to recorded ``(node, "timeout")`` failures, and orphaned state
(undelivered TaskIns, late TaskRes) is reaped instead of leaking into the
next round.

The cases of ``tests/test_straggler.py`` against ``repro_torch``, every
fold on the CPU (``agg_device="cpu"``, the torch backend's plain twin).
The dead-node + straggler round also runs in both packages with the same
clients: equal failure records, round losses within ``LOSS_RTOL``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from repro_torch.core.lgs import LGSConnection
from repro_torch.core.superlink import (FleetConnection, NativeConnection,
                                  SuperLink, SuperLinkDriver, SuperNode)
from repro_torch.fl import (ClientApp, FedAvg, NumPyClient, QuorumNotMet,
                      ServerApp, ServerConfig, make_strategy)
from repro_torch.fl.messages import (FitIns, FitRes, TaskIns, decode_fit_res,
                               decode_task_res, encode_fit_ins,
                               encode_task_ins)
from repro_torch.fl import client as TC
from repro_torch.runtime.reliable import RequestTimeout
from repro_torch.utils import msgpack_lite as msgpack

PARAMS = [np.zeros((8,), np.float32), np.zeros((3, 2), np.float32)]
LOSS_RTOL = 1e-5


def _cfg(**kw):
    """A ServerConfig whose fold runs on the CPU."""
    return ServerConfig(agg_device="cpu", **kw)


def _const_client_class(C):
    """The suite's ConstClient on package ``C``'s NumPyClient."""

    class ConstClient(C.NumPyClient):
        """Returns constant parameters; optionally slow or dead (blocks on an
        event the test releases at teardown so threads join fast)."""

        def __init__(self, value, n=10, delay=0.0, dead=None, eval_error=False):
            self.value = float(value)
            self.n = n
            self.delay = delay
            self.dead = dead                 # threading.Event or None
            self.eval_error = eval_error

        def get_parameters(self, config):
            return [np.zeros_like(a) for a in PARAMS]

        def fit(self, parameters, config):
            if self.dead is not None:
                self.dead.wait()
            if self.delay:
                time.sleep(self.delay)
            return [np.full_like(a, self.value) for a in PARAMS], self.n, {}

        def evaluate(self, parameters, config):
            if self.eval_error:
                raise ValueError("evaluate exploded")
            if self.dead is not None:
                self.dead.wait()
            return self.value, self.n, {}

    return ConstClient


ConstClient = _const_client_class(TC)


@contextmanager
def fleet(clients):
    """SuperLink + one SuperNode per client, torn down promptly."""
    link = SuperLink()
    release = [c.dead for c in clients.values() if c.dead is not None]
    nodes = [SuperNode(s, ClientApp(lambda cid, c=c: c.to_client()),
                       NativeConnection(link))
             for s, c in sorted(clients.items())]
    for n in nodes:
        n.start()
    try:
        yield link, SuperLinkDriver(link, expected_nodes=len(nodes))
    finally:
        for ev in release:
            ev.set()
        for n in nodes:
            n.stop()


def _fit_task(params=PARAMS, rnd=1):
    ins = FitIns(params, {"round": rnd})
    import uuid
    return encode_task_ins(TaskIns("fit", rnd, encode_fit_ins(ins),
                                   task_id=uuid.uuid4().hex))


def _healthy_reference(values_weights):
    results = [(f"site-{i}", FitRes([np.full_like(a, v) for a in PARAMS], n))
               for i, (v, n) in enumerate(values_weights)]
    agg, _ = FedAvg(device="cpu").aggregate_fit(1, results, [], PARAMS)
    return agg


# ---------------------------------------------------------------------------
# the acceptance scenario: one straggler + one dead node, rounds complete
# ---------------------------------------------------------------------------
def test_dead_and_straggler_round_completes():
    delta = 0.35
    dead_ev = threading.Event()
    clients = {
        "site-1": ConstClient(1.0, n=10),
        "site-2": ConstClient(2.0, n=20),
        "site-3": ConstClient(3.0, n=30, delay=delta),
        "site-4-dead": ConstClient(9.0, n=40, dead=dead_ev),
    }
    timeout = 1.0
    app = ServerApp(_cfg(num_rounds=2, round_timeout=timeout),
                    FedAvg(initial_parameters=PARAMS))
    with fleet(clients) as (link, driver):
        t0 = time.monotonic()
        h = app.run(driver)
        elapsed = time.monotonic() - t0

    assert len(h.rounds) == 2                         # no round aborted
    for rec in h.rounds:
        failed = [n for n, _ in rec.failures]
        assert "site-4-dead" in failed
        assert all(r == "timeout" for n, r in rec.failures
                   if n == "site-4-dead")
        assert rec.metrics["num_clients"] == 3
    # aggregate == healthy-subset reference, <=1 ULP
    want = _healthy_reference([(1.0, 10), (2.0, 20), (3.0, 30)])
    for got, ref in zip(h.final_parameters, want):
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    # one shared deadline per phase, not N x timeout: 2 rounds x
    # (fit + evaluate) wait out the dead node once per phase at most
    assert elapsed < 2 * 2 * timeout + 1.5, elapsed


def _dead_and_straggler_history(pkg):
    """The acceptance scenario's fleet and app in package ``pkg``
    ("port" or "reference")."""
    if pkg == "port":
        C = TC
        from repro_torch.core import superlink as S
        from repro_torch.fl import server as SV
        from repro_torch.fl import strategy as ST
        cfg = dict(agg_device="cpu")
    else:
        import repro.fl.client as C
        from repro.core import superlink as S
        from repro.fl import server as SV
        from repro.fl import strategy as ST
        cfg = dict(agg_backend="numpy")
    const = _const_client_class(C)
    dead_ev = threading.Event()
    clients = {
        "site-1": const(1.0, n=10),
        "site-2": const(2.0, n=20),
        "site-3": const(3.0, n=30, delay=0.35),
        "site-4-dead": const(9.0, n=40, dead=dead_ev),
    }
    link = S.SuperLink()
    nodes = [S.SuperNode(s, C.ClientApp(lambda cid, c=c: c.to_client()),
                         S.NativeConnection(link))
             for s, c in sorted(clients.items())]
    for n in nodes:
        n.start()
    try:
        app = SV.ServerApp(SV.ServerConfig(num_rounds=2, round_timeout=1.0,
                                           **cfg),
                           ST.FedAvg(initial_parameters=PARAMS))
        return app.run(S.SuperLinkDriver(link, expected_nodes=len(nodes)))
    finally:
        dead_ev.set()
        for n in nodes:
            n.stop()


def test_dead_and_straggler_round_matches_the_reference():
    h_port = _dead_and_straggler_history("port")
    h_ref = _dead_and_straggler_history("reference")
    assert [sorted(r.failures) for r in h_port.rounds] == \
        [sorted(r.failures) for r in h_ref.rounds]
    assert [r.metrics["num_clients"] for r in h_port.rounds] == \
        [r.metrics["num_clients"] for r in h_ref.rounds] == [3, 3]
    np.testing.assert_allclose([l for _, l in h_port.losses()],
                               [l for _, l in h_ref.losses()],
                               rtol=LOSS_RTOL)
    for a, b in zip(h_port.final_parameters, h_ref.final_parameters):
        np.testing.assert_array_max_ulp(a, b, maxulp=1)


def test_straggler_only_round_ends_at_arrival_not_deadline():
    """With no dead nodes the round finishes when the last result lands
    (~delta), far before the generous deadline."""
    delta = 0.5

    class NoEval(FedAvg):
        def configure_evaluate(self, rnd, parameters, nodes):
            return {}

    clients = {"site-1": ConstClient(1.0),
               "site-2": ConstClient(2.0),
               "site-3": ConstClient(3.0, delay=delta)}
    app = ServerApp(_cfg(num_rounds=1, round_timeout=10.0),
                    NoEval(initial_parameters=PARAMS))
    with fleet(clients) as (link, driver):
        t0 = time.monotonic()
        h = app.run(driver)
        elapsed = time.monotonic() - t0
    assert not h.rounds[0].failures
    assert delta - 0.05 <= elapsed < delta + 1.5, elapsed


def test_initial_parameters_fall_back_past_dead_node():
    """get_parameters round 0: a dead first node must not abort the run."""
    dead_ev = threading.Event()
    clients = {"site-0-dead": ConstClient(0.0, dead=dead_ev),
               "site-1": ConstClient(1.0)}

    class NoEval(FedAvg):
        def configure_evaluate(self, rnd, parameters, nodes):
            return {}

    app = ServerApp(_cfg(num_rounds=1, round_timeout=0.5), NoEval())
    with fleet(clients) as (link, driver):
        h = app.run(driver)
    assert len(h.rounds) == 1
    assert ("site-0-dead", "timeout") in h.rounds[0].failures


# ---------------------------------------------------------------------------
# shared deadline (regression: was N x timeout)
# ---------------------------------------------------------------------------
def test_send_and_receive_total_wait_bounded_by_one_timeout():
    dead1, dead2 = threading.Event(), threading.Event()
    clients = {"site-1": ConstClient(1.0),
               "site-2-dead": ConstClient(2.0, dead=dead1),
               "site-3-dead": ConstClient(3.0, dead=dead2)}
    timeout = 0.6
    with fleet(clients) as (link, driver):
        tasks = {s: _fit_task() for s in clients}
        t0 = time.monotonic()
        with pytest.raises(TimeoutError) as ei:
            driver.send_and_receive(tasks, timeout)
        elapsed = time.monotonic() - t0
    # one shared deadline: NOT 2 dead nodes x 0.6s each
    assert elapsed < timeout + 0.5, elapsed
    assert "site-2-dead" in str(ei.value) and "site-3-dead" in str(ei.value)


def test_iter_yields_in_arrival_order_before_deadline():
    clients = {"site-1": ConstClient(1.0, delay=0.4),
               "site-2": ConstClient(2.0)}
    with fleet(clients) as (link, driver):
        tasks = {s: _fit_task() for s in clients}
        order = [n for n, _ in driver.send_and_receive_iter(tasks, 5.0)]
    assert order == ["site-2", "site-1"]      # arrival order, not sorted


# ---------------------------------------------------------------------------
# reaping: late responses dropped, undelivered tasks removed, no state leak
# ---------------------------------------------------------------------------
def test_late_response_discarded_without_state_leak():
    clients = {"site-1-slow": ConstClient(5.0, delay=0.6),
               "site-2": ConstClient(2.0)}
    with fleet(clients) as (link, driver):
        tasks = {s: _fit_task() for s in clients}
        got = dict(driver.send_and_receive_iter(tasks, 0.25))
        assert set(got) == {"site-2"}
        # the slow node finishes late; its result must be dropped on arrival
        deadline = time.monotonic() + 3.0
        while (link.stats["late_dropped"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert link.stats["late_dropped"] == 1
        with link._results_cv:
            assert not link._results          # nothing leaked
            assert not link._expired          # tombstone consumed
        # the node is healthy again: a fresh exchange works, uncorrupted
        res = driver.send_and_receive({"site-1-slow": _fit_task(rnd=2)}, 5.0)
        tr = decode_task_res(res["site-1-slow"])
        fr = decode_fit_res(tr.payload)
        assert float(fr.parameters[0][0]) == 5.0


def test_undelivered_task_reaped_from_queue():
    link = SuperLink()
    link.fleet_unary("register", b"ghost")    # registered but never polls
    driver = SuperLinkDriver(link)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        driver.send_and_receive({"ghost": _fit_task()}, 0.3)
    assert time.monotonic() - t0 < 1.0
    with link._lock:
        assert not link._task_queues["ghost"]  # TaskIns reaped
    with link._results_cv:
        assert not link._expired               # never delivered: no tombstone
    assert link.stats["discarded_ins"] == 1


def test_malformed_response_demoted_to_per_node_failure():
    """Garbage bytes from a byzantine/buggy node must not abort the
    exchange — they become a (node, "malformed response: ...") failure."""
    from repro_torch.fl.messages import TaskRes, encode_fit_res, encode_task_res
    from repro_torch.fl.server import Driver, ServerApp

    ok_bytes = encode_task_res(TaskRes(
        "fit", 1, encode_fit_res(FitRes(PARAMS, 10, {})), task_id="t1"))

    class TwoNodeDriver(Driver):
        def send_and_receive_iter(self, tasks, timeout):
            yield "site-bad", b"\xc1 not msgpack"
            yield "site-ok", ok_bytes

    got = []
    failures = ServerApp._exchange(
        TwoNodeDriver(), {"site-bad": b"", "site-ok": b""}, 1.0,
        lambda node, tr: got.append(node))
    assert got == ["site-ok"]
    assert len(failures) == 1
    node, reason = failures[0]
    assert node == "site-bad" and reason.startswith("malformed response:")


def test_wrong_shape_result_demoted_to_per_node_failure():
    """A well-formed FitRes with mismatched tensor shapes must be rejected
    at add time (per-node failure), not crash the kernel at finalize."""

    class WrongShape(NumPyClient):
        def fit(self, parameters, config):
            return [np.ones((3,), np.float32) for _ in PARAMS], 10, {}

        def evaluate(self, parameters, config):
            return 0.0, 10, {}

    class NoEval(FedAvg):
        def configure_evaluate(self, rnd, parameters, nodes):
            return {}

    clients = {"site-1": ConstClient(1.0), "site-2": ConstClient(2.0)}
    link = SuperLink()
    nodes = [SuperNode(s, ClientApp(lambda cid, c=c: c.to_client()),
                       NativeConnection(link))
             for s, c in sorted(clients.items())]
    bad = WrongShape()
    nodes.append(SuperNode("site-3-bad",
                           ClientApp(lambda cid: bad.to_client()),
                           NativeConnection(link)))
    for n in nodes:
        n.start()
    try:
        app = ServerApp(_cfg(num_rounds=2, round_timeout=5.0),
                        NoEval(initial_parameters=PARAMS))
        h = app.run(SuperLinkDriver(link, expected_nodes=3))
    finally:
        for n in nodes:
            n.stop()
    assert len(h.rounds) == 2
    for rec in h.rounds:
        reasons = dict(rec.failures)
        assert "shapes" in reasons["site-3-bad"]
        assert rec.metrics["num_clients"] == 2
    want = _healthy_reference([(1.0, 10), (2.0, 10)])
    for got, ref in zip(h.final_parameters, want):
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)


def test_blocking_only_driver_timeout_demotes_to_failures():
    """A Driver that implements only the all-or-nothing blocking API must
    still honor the iter contract: a timeout yields nothing (all nodes
    recorded as failures), never an exception out of ServerApp.run."""
    from repro_torch.fl.server import Driver

    class BlockingOnly(Driver):
        def node_ids(self):
            return ["site-1", "site-2"]

        def send_and_receive(self, tasks, timeout):
            raise TimeoutError("straggler in an all-or-nothing batch")

    class NoEval(FedAvg):
        def configure_evaluate(self, rnd, parameters, nodes):
            return {}

    app = ServerApp(_cfg(num_rounds=1, round_timeout=0.1),
                    NoEval(initial_parameters=PARAMS, min_fit_clients=0))
    with pytest.raises(QuorumNotMet):
        # 0 results < quorum 1 — but crucially via QuorumNotMet at
        # finalize (with both nodes recorded), not a raw TimeoutError
        app.run(BlockingOnly())


# ---------------------------------------------------------------------------
# ordering invariance of aggregation
# ---------------------------------------------------------------------------
def _rand_results(n=5, seed=7):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n):
        arrays = [rng.normal(0, 1, a.shape).astype(np.float32)
                  for a in PARAMS]
        out.append((f"site-{c}", FitRes(arrays, 10 + 3 * c, {})))
    return out


@pytest.mark.parametrize("name,kw", [
    ("fedavg", {}), ("fedavg", {"low_memory": True}), ("fedadam", {}),
    ("fedmedian", {}), ("krum", {"num_byzantine": 1}),
])
def test_arrival_order_matches_sorted_order_within_ulp(name, kw):
    results = _rand_results()
    shuffled = [results[i] for i in (3, 0, 4, 2, 1)]
    current = [np.zeros_like(a) for a in PARAMS]

    def run(order):
        strat = make_strategy(name, device="cpu", **kw)  # fresh state
        acc = strat.fit_accumulator(1, current)
        for node, res in order:
            acc.add(node, res)
        return acc.finalize([])[0]

    for a, b in zip(run(shuffled), run(sorted(results))):
        np.testing.assert_array_max_ulp(a, b, maxulp=1)


# ---------------------------------------------------------------------------
# quorum knob
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fedavg", "fedmedian", "fedtrimmedmean",
                                  "krum"])
def test_quorum_not_met_raises(name):
    strat = make_strategy(name, device="cpu", min_available=3)
    acc = strat.fit_accumulator(1, [np.zeros_like(a) for a in PARAMS])
    for node, res in _rand_results(n=2):
        acc.add(node, res)
    with pytest.raises(QuorumNotMet):
        acc.finalize([("site-9", "timeout")])


def test_quorum_met_succeeds_with_failures_present():
    strat = make_strategy("fedmedian", device="cpu", min_available=3)
    acc = strat.fit_accumulator(1, [np.zeros_like(a) for a in PARAMS])
    for node, res in _rand_results(n=3):
        acc.add(node, res)
    agg, metrics = acc.finalize([("site-9", "timeout")])
    assert metrics["num_clients"] == 3


# ---------------------------------------------------------------------------
# evaluate phase forwards real failures
# ---------------------------------------------------------------------------
def test_evaluate_failures_forwarded_to_strategy():
    seen = {}

    class Recording(FedAvg):
        def aggregate_evaluate(self, rnd, results, failures):
            seen[rnd] = (list(results), list(failures))
            return super().aggregate_evaluate(rnd, results, failures)

    dead_ev = threading.Event()
    clients = {"site-1": ConstClient(1.0),
               "site-2-boom": ConstClient(2.0, eval_error=True),
               "site-3-dead": ConstClient(3.0, dead=dead_ev)}
    app = ServerApp(_cfg(num_rounds=1, round_timeout=0.8),
                    Recording(initial_parameters=PARAMS))
    with fleet(clients) as (link, driver):
        h = app.run(driver)

    results, failures = seen[1]
    assert [n for n, _ in results] == ["site-1"]
    reasons = dict(failures)
    assert "evaluate exploded" in reasons["site-2-boom"]
    assert reasons["site-3-dead"] == "timeout"
    assert set(reasons) <= {n for n, _ in h.rounds[0].failures}


# ---------------------------------------------------------------------------
# transport-error demotion (FLARE-bridged path)
# ---------------------------------------------------------------------------
class FlakyConnection(FleetConnection):
    def __init__(self, inner, fail_first=3):
        self.inner = inner
        self.remaining = fail_first

    def unary(self, method, request):
        if method != "register" and self.remaining > 0:
            self.remaining -= 1
            raise RequestTimeout("injected transport timeout")
        return self.inner.unary(method, request)


def test_supernode_survives_transport_timeouts():
    link = SuperLink()
    client = ConstClient(4.0)
    node = SuperNode("site-1", ClientApp(lambda cid: client.to_client()),
                     FlakyConnection(NativeConnection(link), fail_first=3),
                     poll_interval=0.005)
    node.start()
    try:
        driver = SuperLinkDriver(link, expected_nodes=1)
        res = driver.send_and_receive({"site-1": _fit_task()}, 5.0)
        fr = decode_fit_res(decode_task_res(res["site-1"]).payload)
        assert float(fr.parameters[0][0]) == 4.0
        assert node.transport_errors >= 1
    finally:
        node.stop()


class _FakeCtx:
    def __init__(self, resp=None, exc=None):
        self.resp, self.exc = resp, exc

    def request(self, dest, topic, payload, timeout=None):
        if self.exc is not None:
            raise self.exc
        return self.resp


def test_lgs_demotes_tagged_timeout_to_request_timeout():
    resp = msgpack.packb({"r": b"", "e": "TimeoutError('x')", "k": "timeout"},
                         use_bin_type=True)
    with pytest.raises(RequestTimeout):
        LGSConnection(_FakeCtx(resp)).unary("pull_task_ins", b"site-1")


def test_lgs_keeps_non_timeout_errors_fatal():
    resp = msgpack.packb({"r": b"", "e": "ValueError('bad')", "k": "error"},
                         use_bin_type=True)
    with pytest.raises(RuntimeError) as ei:
        LGSConnection(_FakeCtx(resp)).unary("pull_task_ins", b"site-1")
    assert not isinstance(ei.value, RequestTimeout)


def test_request_timeout_carries_exchange_coordinates():
    err = RequestTimeout("x", target="server", topic="flower/unary",
                         timeout=1.5)
    assert (err.target, err.topic, err.timeout) == ("server", "flower/unary",
                                                    1.5)


def test_run_supernode_passes_its_heartbeat_timeout(monkeypatch):
    """A node's PINGs wait behind its own upload, so a process SuperNode
    that uploads large frames takes a heartbeat timeout covering one
    upload: ``run_supernode`` hands it to its connection."""
    from repro_torch.core import transport as TT

    seen = {}

    class FakeConnection:
        closed = True

        def __init__(self, host, port, node_id, **kw):
            seen.update(kw)

    class FakeNode:
        def __init__(self, *a):
            pass

        def start(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(TT, "TcpFleetConnection", FakeConnection)
    monkeypatch.setattr(TT, "SuperNode", FakeNode)
    TT.run_supernode("127.0.0.1", 1, "proc-0", lambda n: None,
                     run_seconds=0.0, heartbeat_timeout=120.0)
    assert seen["heartbeat_timeout"] == 120.0
    TT.run_supernode("127.0.0.1", 1, "proc-0", lambda n: None,
                     run_seconds=0.0)
    assert seen["heartbeat_timeout"] == 10.0
