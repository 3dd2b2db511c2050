"""ReliableMessage semantics (paper §4.1) under injected faults, on the
port: the cases of ``tests/test_reliable.py`` against
``repro_torch.runtime``."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import threading
import time

import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.runtime.reliable import ReliableMessenger, RequestTimeout
from repro_torch.runtime.transport import FaultSpec, Message, Network


def make_pair(faults=None, timeout=10.0):
    net = Network(faults)
    a = ReliableMessenger(net, "a", retry_interval=0.01, default_timeout=timeout)
    b = ReliableMessenger(net, "b", retry_interval=0.01, default_timeout=timeout)
    return net, a, b


def test_basic_roundtrip():
    net, a, b = make_pair()
    b.register_handler("echo", lambda m: b"pong:" + m.payload)
    assert a.request("b", "echo", b"x") == b"pong:x"


def test_exactly_once_execution_under_drops_and_dups():
    calls = []
    net, a, b = make_pair(FaultSpec(drop_prob=0.3, dup_prob=0.3, seed=7))

    def handler(m):
        calls.append(m.payload)
        return b"ok" + m.payload

    b.register_handler("work", handler)
    for i in range(20):
        assert a.request("b", "work", str(i).encode()) == b"ok" + str(i).encode()
    # dedup: each logical request executed exactly once
    assert sorted(calls) == sorted(str(i).encode() for i in range(20))


def test_result_recovered_via_query_when_push_lost():
    """Seed chosen so the first RESP pushes get dropped; the query-pull path
    must still deliver (paper §4.1 case 2)."""
    net, a, b = make_pair(FaultSpec(drop_prob=0.5, seed=3))
    b.register_handler("t", lambda m: b"r")
    for _ in range(10):
        assert a.request("b", "t", b"") == b"r"
    assert net.stats["dropped"] > 0


def test_timeout_aborts():
    net, a, b = make_pair(timeout=0.3)
    # no handler registered on b for this topic -> request can never complete
    with pytest.raises(RequestTimeout):
        a.request("b", "nope", b"", timeout=0.3)


def test_slow_handler_covered_by_query_pending():
    net, a, b = make_pair()

    def slow(m):
        time.sleep(0.2)
        return b"done"

    b.register_handler("slow", slow)
    t0 = time.monotonic()
    assert a.request("b", "slow", b"") == b"done"
    assert time.monotonic() - t0 < 5.0


def test_handler_registered_late_still_serves():
    """Requests arriving before the job process registers its handler must
    not be dedup-blackholed (regression: bridged SuperNode startup)."""
    net, a, b = make_pair()
    result = {}

    def requester():
        result["r"] = a.request("b", "late", b"", timeout=5.0)

    t = threading.Thread(target=requester)
    t.start()
    time.sleep(0.2)
    b.register_handler("late", lambda m: b"served")
    t.join(timeout=6.0)
    assert result.get("r") == b"served"


def test_responder_cache_reaped_after_ttl():
    """A long-lived responder must not grow its result cache forever:
    payloads are reaped once result_ttl passes, while the (tiny) dedup
    marks survive 10x longer so a straggling duplicate REQ can never
    re-execute a non-idempotent handler."""
    net = Network()
    a = ReliableMessenger(net, "a", retry_interval=0.01)
    b = ReliableMessenger(net, "b", retry_interval=0.01, result_ttl=0.15)
    b.register_handler("w", lambda m: b"ok")
    assert a.request("b", "w", b"1") == b"ok"
    with b._lock:
        assert len(b._results) == 1
    time.sleep(0.3)
    assert a.request("b", "w", b"2") == b"ok"   # insert triggers the reap
    with b._lock:
        assert len(b._results) == 1             # old payload reaped
        assert len(b._seen) == 2                # dedup marks retained
    time.sleep(1.6)                             # > 10 x result_ttl
    assert a.request("b", "w", b"3") == b"ok"
    with b._lock:
        assert len(b._results) == 1 and len(b._seen) == 1
    net.close()


def test_timeout_carries_target_and_topic():
    net, a, b = make_pair(timeout=0.2)
    with pytest.raises(RequestTimeout) as ei:
        a.request("b", "nope", b"", timeout=0.2)
    assert ei.value.target == "b" and ei.value.topic == "nope"
    assert ei.value.timeout == 0.2


def test_bytes_only_boundary():
    net, a, b = make_pair()
    with pytest.raises(TypeError):
        net.send(Message("x", 0, "REQ", "a", "b", "t", {"not": "bytes"}))


@settings(max_examples=12, deadline=None)
@given(st.floats(0.0, 0.4), st.floats(0.0, 0.4), st.integers(0, 10_000))
def test_reliability_property(drop, dup, seed):
    """For any (drop<=0.4, dup<=0.4, seed): every request completes with the
    right payload and executes exactly once."""
    net, a, b = make_pair(FaultSpec(drop_prob=drop, dup_prob=dup,
                                    max_delay_s=0.005, seed=seed),
                          timeout=30.0)
    seen = []
    b.register_handler("p", lambda m: (seen.append(m.payload), b"=" + m.payload)[1])
    for i in range(5):
        assert a.request("b", "p", f"{i}".encode()) == f"={i}".encode()
    assert sorted(seen) == [f"{i}".encode() for i in range(5)]
    net.close()
