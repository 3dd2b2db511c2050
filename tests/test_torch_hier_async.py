"""Hierarchical edge aggregation + async FedBuff on the port: the cases of
``tests/test_hier_async.py`` against ``repro_torch``.

Covers the 0xF4 partial-sum wire codec, the population registry's
seed-deterministic availability-weighted sampling, the bounded-staleness
FedBuff buffer (property-tested), the SuperLink waiter/stream primitives,
and end-to-end two-tier topologies — including the bitwise
hierarchical-vs-flat equivalence and a 10k-simulated-client round
(``-m hier``).  Every fold names the CPU (``agg_device="cpu"``, the torch
backend's plain twin).  Across the packages, partial-sum frames cross
in process: the reference's edge aggregators folding at the port's root,
and the port's edges at the reference's root, each give the
all-reference history bitwise.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import threading
import time

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare tier-1 container
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.core.interop import run_hierarchical, run_native
from repro_torch.core.superlink import (NativeConnection, SuperLink,
                                        SuperLinkDriver, SuperNode,
                                        TaskStream, make_edge_tier)
from repro_torch.fl import client as TC
from repro_torch.fl.client import ClientApp
from repro_torch.fl.fedbuff import FedBuffBuffer
from repro_torch.fl.flat import PartialSum, WIRE_MAGICS
from repro_torch.fl.messages import (FitRes, UnsupportedCodec,
                                     bytes_to_arrays, decode_evaluate_ins,
                                     decode_fit_ins, decode_fit_res,
                                     encode_partial_fit_res)
from repro_torch.fl.registry import PopulationRegistry
from repro_torch.fl.server import ServerApp, ServerConfig
from repro_torch.fl.strategy import FedAvg, FedAvgM, FedMedian
from repro_torch.fl import flat as F
from repro_torch.utils import msgpack_lite as msgpack


def _cfg(**kw):
    """A ServerConfig whose folds (root and edges) run on the CPU."""
    return ServerConfig(agg_device="cpu", **kw)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _layout():
    return F.layout_for([("float32", (8, 4)), ("float32", (5,))])


def _partial(vec_fill=1.5, w=3.0, count=2, ids=("a", "b"),
             failures=(("c", "timeout"),)):
    lay = _layout()
    data = np.full(lay.total_size, vec_fill, np.float64)
    return PartialSum(lay, data, w, count, tuple(ids), tuple(failures))


def _client_classes(C):
    """The suite's clients on package ``C``'s NumPyClient (the port's
    ``repro_torch.fl.client`` or the reference's)."""

    class DyadicClient(C.NumPyClient):
        """Deterministic client whose updates are exact in binary fp
        (integers / 256, weight 1), so ANY summation grouping — flat, 1
        edge, 8 edges — produces the identical fp64 sum."""

        def __init__(self, site):
            self.idx = int(site.rsplit("-", 1)[1])

        def get_parameters(self, config):
            return [np.zeros((8, 4), np.float32), np.zeros((5,), np.float32)]

        def fit(self, parameters, config):
            rng = np.random.default_rng(self.idx)
            out = [p + rng.integers(-512, 512, p.shape).astype(np.float32)
                   / 256.0 for p in parameters]
            return out, 1, {}

        def evaluate(self, parameters, config):
            return float(sum(np.abs(p).sum() for p in parameters)), 4, {}

    class NoisyClient(DyadicClient):
        """Non-dyadic update values: exposes any regrouping of the sum."""

        def fit(self, parameters, config):
            rng = np.random.default_rng(self.idx)
            out = [p + rng.standard_normal(p.shape).astype(np.float32) / 3.0
                   for p in parameters]
            return out, 1 + self.idx % 3, {}

    return DyadicClient, NoisyClient


DyadicClient, NoisyClient = _client_classes(TC)


def _app_fn(cls):
    def fn(site):
        return ClientApp(client_fn=lambda cid, s=site: cls(s).to_client())
    return fn


def _same_params(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# 0xF4 wire codec
# ---------------------------------------------------------------------------
def test_partial_frame_roundtrip_zero_copy():
    ps = _partial()
    wire = encode_partial_fit_res(ps, metrics={"edge": "e0"})
    assert wire[0] == WIRE_MAGICS["partial"]
    res = decode_fit_res(wire)
    assert res.partial is not None and res.parameters is None
    got = res.partial
    assert got.total_w == 3.0 and got.count == 2
    assert got.node_ids == ("a", "b")
    assert got.failures == (("c", "timeout"),)
    assert got.layout == ps.layout
    np.testing.assert_array_equal(got.data, ps.data)
    assert res.num_examples == 2 and res.metrics == {"edge": "e0"}
    # zero-copy view over the frame, born read-only
    assert not got.data.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        got.data[0] = 9.0


def test_partial_frame_rejected_by_parameter_decoders():
    wire = encode_partial_fit_res(_partial())
    for decoder in (decode_fit_ins, decode_evaluate_ins, bytes_to_arrays):
        with pytest.raises(UnsupportedCodec):
            decoder(wire)
    with pytest.raises(UnsupportedCodec):
        decode_fit_res(wire).materialize()


def test_next_reserved_byte_still_unknown():
    # 0xF4 and 0xF5 are now taken; 0xF6 is the canonical unknown probe
    wire = bytearray(encode_partial_fit_res(_partial()))
    wire[0] = WIRE_MAGICS["sparse"] + 1
    with pytest.raises(UnsupportedCodec):
        decode_fit_res(bytes(wire))


# ---------------------------------------------------------------------------
# population registry
# ---------------------------------------------------------------------------
def test_registry_sampling_is_seed_deterministic():
    nodes = [f"n{i:02d}" for i in range(20)]
    r1 = PopulationRegistry(seed=5)
    r2 = PopulationRegistry(seed=5)
    for reg in (r1, r2):
        reg.observe(successes=nodes[:10], failures=[("n15", "timeout")])
    for rnd in range(4):
        assert r1.sample(nodes, 6, rnd) == r2.sample(nodes, 6, rnd)
    # a different seed (or round) moves the draw for some round
    r3 = PopulationRegistry(seed=6)
    r3.observe(successes=nodes[:10], failures=[("n15", "timeout")])
    assert any(r1.sample(nodes, 6, rnd) != r3.sample(nodes, 6, rnd)
               for rnd in range(8))
    # order of the input node list must not matter
    assert r1.sample(list(reversed(nodes)), 6, 0) == r1.sample(nodes, 6, 0)


def test_registry_demotes_flaky_nodes():
    nodes = ["flaky", "solid-a", "solid-b", "solid-c"]
    reg = PopulationRegistry(seed=1)
    for _ in range(30):
        reg.observe(successes=nodes[1:], failures=[("flaky", "timeout")])
    assert reg.availability("flaky") < 0.1
    assert reg.availability("solid-a") > 0.9
    picked = sum("flaky" in reg.sample(nodes, 2, rnd) for rnd in range(60))
    # availability-weighted: the flaky node is picked far below uniform
    # (uniform would give ~30/60); min_weight keeps it > 0 eventually
    assert picked < 15
    # min_weight floor keeps every node eligible
    assert reg.weight("flaky") >= reg.min_weight > 0.0


def test_registry_sample_edges():
    reg = PopulationRegistry(seed=0)
    nodes = ["a", "b", "c"]
    assert reg.sample(nodes, 3, 0) == sorted(nodes)      # k >= n: everyone
    assert reg.sample(nodes, 99, 0) == sorted(nodes)
    with pytest.raises(ValueError):
        reg.sample(nodes, 0, 0)
    out = reg.sample(nodes, 2, 0)
    assert out == sorted(out) and len(set(out)) == 2


# ---------------------------------------------------------------------------
# FedBuff buffer
# ---------------------------------------------------------------------------
def _leaf_res(seed=0, n=2):
    lay = _layout()
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(tuple(l.shape)).astype(np.float32)
            for l in lay.leaves]
    return FitRes(arrs, n, {})


def test_fedbuff_requires_weighted_sum_strategy():
    with pytest.raises(ValueError):
        FedBuffBuffer(FedMedian(device="cpu"))
    FedBuffBuffer(FedAvg(device="cpu"))  # FedAvg family is fine
    FedBuffBuffer(FedAvgM(device="cpu"))


def test_fedbuff_window_weighted_mean_matches_manual():
    buf = FedBuffBuffer(FedAvg(device="cpu"), buffer_k=3, max_staleness=5,
                        staleness_exponent=0.5)
    offers = [(_leaf_res(seed=s, n=s + 1), 0) for s in range(3)]
    for res, ver in offers:
        assert buf.offer(f"n{ver}", res, ver) == "folded"
    assert buf.ready()
    current = [np.zeros((8, 4), np.float32), np.zeros((5,), np.float32)]
    new, metrics = buf.advance(current)
    # staleness 0 for all => discount 1, plain weighted mean
    ws = [float(r.num_examples) for r, _ in offers]
    want0 = sum(w * r.parameters[0].astype(np.float64)
                for (r, _), w in zip(offers, ws)) / sum(ws)
    np.testing.assert_allclose(new[0].astype(np.float64), want0, atol=1e-6)
    assert metrics["server_version"] == 1
    assert metrics["window_folds"] == 3
    assert buf.version == 1 and not buf.ready()


def test_fedbuff_discount_and_partial_scale():
    buf = FedBuffBuffer(FedAvg(device="cpu"), buffer_k=2, max_staleness=4,
                        staleness_exponent=1.0)
    buf.version = 2                    # pretend two advances happened
    assert buf.discount(0) == 1.0
    assert buf.discount(3) == 0.25
    ps = _partial(vec_fill=2.0, w=4.0, count=3, failures=())
    assert buf.offer("edge", decode_fit_res(encode_partial_fit_res(ps)),
                     trained_version=1) == "folded"      # staleness 1
    assert buf.offer("leaf", _leaf_res(seed=1, n=2),
                     trained_version=2) == "folded"      # staleness 0
    # discounted total weight: 0.5 * 4.0 (partial, s=1) + 1.0 * 2 (leaf)
    assert buf._acc.total_w == pytest.approx(0.5 * 4.0 + 2.0)
    assert buf.folded_staleness == [1, 0]


def test_fedbuff_rejects_future_versions():
    buf = FedBuffBuffer(FedAvg(device="cpu"))
    with pytest.raises(ValueError):
        buf.offer("n", _leaf_res(), trained_version=1)   # ahead of server


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(min_value=0, max_value=9),
                          st.integers(min_value=1, max_value=4)),
                min_size=1, max_size=40),
       st.integers(min_value=1, max_value=4),
       st.integers(min_value=0, max_value=5))
def test_fedbuff_never_folds_beyond_staleness_bound(arrivals, buffer_k,
                                                    max_staleness):
    """Property: whatever the arrival sequence, no folded update is
    staler than the configured bound, and everything beyond the bound is
    dropped (never silently folded)."""
    buf = FedBuffBuffer(FedAvg(device="cpu"), buffer_k=buffer_k,
                        max_staleness=max_staleness)
    current = [np.zeros((8, 4), np.float32), np.zeros((5,), np.float32)]
    folded = dropped = 0
    for i, (age, n) in enumerate(arrivals):
        ver = max(buf.version - age, 0)
        verdict = buf.offer(f"n{i}", _leaf_res(seed=i, n=n), ver)
        s = buf.version - ver
        if s > max_staleness:
            assert verdict == "stale"
            dropped += 1
        else:
            assert verdict == "folded"
            folded += 1
        if buf.ready():
            current, metrics = buf.advance(current)
            assert metrics["max_folded_staleness"] <= max_staleness
    assert buf.folded == folded and buf.dropped == dropped
    assert all(s <= max_staleness for s in buf.folded_staleness)


# ---------------------------------------------------------------------------
# SuperLink waiter + TaskStream
# ---------------------------------------------------------------------------
def _push_res(link, tid, payload=b"r"):
    link.fleet_unary("push_task_res",
                     msgpack.packb({"id": tid, "res": payload},
                                   use_bin_type=True))


def test_waiter_routes_results_o1():
    link = SuperLink()
    tids = [link.push_task_ins("n0", b"t%d" % i) for i in range(3)]
    _push_res(link, tids[1], b"early")      # lands before anyone waits
    w = link.register_waiter(tids)
    got = link.waiter_next(w, time.monotonic() + 1.0)
    assert got == (tids[1], b"early")
    _push_res(link, tids[0], b"a")
    _push_res(link, tids[2], b"c")
    arrived = {link.waiter_next(w, time.monotonic() + 1.0)[0]
               for _ in range(2)}
    assert arrived == {tids[0], tids[2]}
    assert link.waiter_next(w, time.monotonic() + 0.02) is None
    link.release_waiter(w, tids)
    link.discard(tids)


def test_release_waiter_returns_undelivered_results():
    link = SuperLink()
    tid = link.push_task_ins("n0", b"t")
    w = link.register_waiter([tid])
    _push_res(link, tid, b"r")              # routed to w.ready, unread
    link.release_waiter(w, [tid])
    # back in the shared store: a later consumer still sees it
    assert link.pull_any([tid], time.monotonic() + 0.5) == (tid, b"r")


def test_waiter_wakes_without_polling():
    link = SuperLink()
    tid = link.push_task_ins("n0", b"t")
    w = link.register_waiter([tid])
    t = threading.Timer(0.05, _push_res, (link, tid))
    t.start()
    t0 = time.monotonic()
    got = link.waiter_next(w, t0 + 5.0)
    dt = time.monotonic() - t0
    t.join()
    assert got is not None and dt < 1.0     # woke on notify, not deadline


def test_task_stream_send_recv_close():
    link = SuperLink()
    stream = TaskStream(link)
    tids = stream.send({"n0": b"t0", "n1": b"t1"})
    assert set(tids) == {"n0", "n1"}
    _push_res(link, tids["n1"], b"r1")
    assert stream.recv(1.0) == ("n1", tids["n1"], b"r1")
    assert stream.recv(0.02) is None        # nothing else yet
    # simulate n0's node pulling its task, so close() must tombstone the
    # in-flight id (an undelivered one would just be reaped instead)
    link.fleet_unary("pull_task_ins", b"n0")
    stream.close()
    _push_res(link, tids["n0"], b"late")
    assert link.stats["late_dropped"] >= 1
    with pytest.raises(RuntimeError):
        stream.send({"n0": b"t"})
    with pytest.raises(RuntimeError):
        stream.recv(0.01)


def test_superlink_driver_round_still_works_with_waiters():
    # the rewritten send_and_receive_iter behaves like the seed version
    link = SuperLink()
    apps = {f"s{i}": ClientApp(
        client_fn=lambda cid: DyadicClient("x-0").to_client())
        for i in range(3)}
    nodes = [SuperNode(n, app, NativeConnection(link))
             for n, app in apps.items()]
    for n in nodes:
        n.start()
    try:
        driver = SuperLinkDriver(link, expected_nodes=3)
        from repro_torch.fl.messages import TaskIns, encode_task_ins
        tasks = {n: encode_task_ins(TaskIns("get_properties", 0, b"",
                                            task_id=f"t{n}"))
                 for n in driver.node_ids()}
        out = driver.send_and_receive(tasks, 10.0)
        assert set(out) == set(tasks)
    finally:
        for n in nodes:
            n.stop()


# ---------------------------------------------------------------------------
# end-to-end: hierarchical sync
# ---------------------------------------------------------------------------
SITES8 = [f"c-{i:03d}" for i in range(8)]


@pytest.mark.parametrize("num_edges", [1, 2, 8])
def test_hierarchical_bitwise_equals_flat_dyadic(num_edges):
    flat = run_native(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(DyadicClient), SITES8)
    hier = run_hierarchical(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(DyadicClient), SITES8, num_edges=num_edges)
    assert _same_params(hier.final_parameters, flat.final_parameters)
    for r_h, r_f in zip(hier.rounds, flat.rounds):
        assert r_h.loss == r_f.loss
        assert r_h.metrics["num_clients"] == 8
        assert r_h.metrics["num_payloads"] == num_edges
        assert r_f.metrics["num_payloads"] == 8


def test_single_edge_bitwise_on_any_data():
    # one edge over the whole fleet continues the flat low-memory fold
    # exactly, dyadic or not: acc = 0 + 1.0*S, one divide by W
    flat = run_native(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(NoisyClient), SITES8)
    hier = run_hierarchical(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(NoisyClient), SITES8, num_edges=1)
    assert _same_params(hier.final_parameters, flat.final_parameters)


def test_multi_edge_matches_flat_within_regrouping_tolerance():
    flat = run_native(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(NoisyClient), SITES8)
    hier = run_hierarchical(
        ServerApp(_cfg(num_rounds=2), FedAvg(low_memory=True)),
        _app_fn(NoisyClient), SITES8, num_edges=4)
    for a, b in zip(hier.final_parameters, flat.final_parameters):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_mixed_leaf_and_edge_fleet():
    # 1 edge pre-reducing 6 clients + 2 direct leaf clients on the root
    link = SuperLink()
    edge_apps = {s: _app_fn(DyadicClient)(s) for s in SITES8[:6]}
    edges = make_edge_tier(link, edge_apps, num_edges=1, timeout=30.0,
                           device="cpu")
    leaves = [SuperNode(s, _app_fn(DyadicClient)(s), NativeConnection(link))
              for s in SITES8[6:]]
    for n in leaves:
        n.start()
    try:
        h = ServerApp(_cfg(num_rounds=1),
                      FedAvg(low_memory=True)).run(
            SuperLinkDriver(link, expected_nodes=3))
    finally:
        for n in edges + leaves:
            n.stop()
    flat = run_native(
        ServerApp(_cfg(num_rounds=1), FedAvg(low_memory=True)),
        _app_fn(DyadicClient), SITES8)
    r = h.rounds[0]
    assert r.metrics["num_clients"] == 8
    assert r.metrics["num_payloads"] == 3        # 1 edge + 2 leaves
    # dyadic data: regrouped sum is still exact
    assert _same_params(h.final_parameters, flat.final_parameters)


class FailingClient(DyadicClient):
    def fit(self, parameters, config):
        if self.idx == 3:
            raise RuntimeError("client 3 exploded")
        return super().fit(parameters, config)


def test_subtree_failures_surface_at_root():
    h = run_hierarchical(
        ServerApp(_cfg(num_rounds=1), FedAvg()),
        _app_fn(FailingClient), SITES8, num_edges=2)
    r = h.rounds[0]
    assert r.metrics["num_clients"] == 7
    assert r.metrics["num_payloads"] == 2
    subs = r.metrics.get("subtree_failures", [])
    assert any(n == "c-003" and "exploded" in reason for n, reason in subs)


def test_edge_downgrades_to_weighted_mean_for_nonpartial_strategy():
    # FedMedian needs every client's update, so the root never requests
    # the pre-reduction; edges fall back to a plain weighted-mean FitRes.
    h = run_hierarchical(
        ServerApp(_cfg(num_rounds=1), FedMedian()),
        _app_fn(DyadicClient), SITES8, num_edges=2)
    assert h.final_parameters is not None
    assert not h.rounds[0].failures


def test_evaluate_through_edges_matches_flat():
    flat = run_native(
        ServerApp(_cfg(num_rounds=1), FedAvg(low_memory=True)),
        _app_fn(DyadicClient), SITES8)
    hier = run_hierarchical(
        ServerApp(_cfg(num_rounds=1), FedAvg(low_memory=True)),
        _app_fn(DyadicClient), SITES8, num_edges=2)
    assert hier.rounds[0].loss == pytest.approx(flat.rounds[0].loss,
                                                rel=1e-12)


# ---------------------------------------------------------------------------
# end-to-end: sampling + async
# ---------------------------------------------------------------------------
def test_server_sampling_is_deterministic_and_partial():
    def once():
        return run_native(
            ServerApp(_cfg(num_rounds=3, sample_k=3, sample_seed=4),
                      FedAvg(low_memory=True)),
            _app_fn(DyadicClient), SITES8)
    h1, h2 = once(), once()
    for r1, r2 in zip(h1.rounds, h2.rounds):
        assert r1.metrics["num_clients"] == 3
        assert r1.loss == r2.loss
    assert _same_params(h1.final_parameters, h2.final_parameters)


def _run_async(config, cls=NoisyClient, n=4):
    sites = [f"c-{i:03d}" for i in range(n)]
    link = SuperLink()
    nodes = [SuperNode(s, _app_fn(cls)(s), NativeConnection(link))
             for s in sites]
    for nd in nodes:
        nd.start()
    try:
        return ServerApp(config, FedAvg()).run(
            SuperLinkDriver(link, expected_nodes=n))
    finally:
        for nd in nodes:
            nd.stop()


def test_async_run_reaches_target_versions_within_staleness_bound():
    cfg = _cfg(num_rounds=4, async_mode=True, async_buffer_k=2,
                       async_max_staleness=2, round_timeout=30.0)
    h = _run_async(cfg)
    assert len(h.rounds) == 4
    for i, r in enumerate(h.rounds, start=1):
        assert r.metrics["server_version"] == i
        assert r.metrics["window_folds"] == 2
        assert r.metrics["max_folded_staleness"] <= 2
        assert r.loss is not None            # async_eval_every=1 default
    assert h.final_parameters is not None


def test_async_requires_streaming_driver():
    class Blocking:
        def node_ids(self):
            return ["a"]

    app = ServerApp(_cfg(async_mode=True), FedAvg())
    with pytest.raises(RuntimeError, match="open_stream"):
        app.run_async(Blocking())


def test_async_with_edge_tier():
    # edges pre-reduce; the async buffer folds their 0xF4 partials with
    # the staleness discount applied as the partial's scale
    link = SuperLink()
    apps = {s: _app_fn(DyadicClient)(s) for s in SITES8}
    edges = make_edge_tier(link, apps, num_edges=2, timeout=30.0,
                           device="cpu")
    try:
        cfg = _cfg(num_rounds=2, async_mode=True, async_buffer_k=2,
                           async_max_staleness=3, round_timeout=30.0)
        h = ServerApp(cfg, FedAvg()).run(
            SuperLinkDriver(link, expected_nodes=2))
    finally:
        for n in edges:
            n.stop()
    assert len(h.rounds) == 2
    # each advance folded two edge partials covering the whole fleet
    assert all(r.metrics["window_folds"] == 2 for r in h.rounds)


# ---------------------------------------------------------------------------
# across the packages: 0xF4 partial sums from one package's edges folded at
# the other's root, in process (the fleet calls are bytes both ways)
# ---------------------------------------------------------------------------
def _reference_hierarchical(num_edges, rounds=2):
    import repro.fl.client as RC
    from repro.core.interop import run_hierarchical as ref_run_hierarchical
    from repro.fl import FedAvg as RFedAvg
    from repro.fl import ServerApp as RServerApp
    from repro.fl import ServerConfig as RServerConfig

    _, ref_noisy = _client_classes(RC)
    app_fn = lambda s: RC.ClientApp(  # noqa: E731
        client_fn=lambda cid: ref_noisy(s).to_client())
    h = ref_run_hierarchical(
        RServerApp(RServerConfig(num_rounds=rounds),
                   RFedAvg(low_memory=True, backend="numpy")),
        app_fn, SITES8, num_edges=num_edges)
    return h, app_fn


def _same_history(a, b):
    assert a.losses() == b.losses()
    assert [r.metrics["num_payloads"] for r in a.rounds] == \
        [r.metrics["num_payloads"] for r in b.rounds]
    assert len(a.final_parameters) == len(b.final_parameters)
    for x, y in zip(a.final_parameters, b.final_parameters):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("num_edges", [1, 3])
def test_reference_edges_fold_at_port_root(num_edges, backend):
    from repro.core.superlink import make_edge_tier as ref_make_edge_tier

    h_ref, ref_app_fn = _reference_hierarchical(num_edges)
    link = SuperLink()
    edges = ref_make_edge_tier(link, {s: ref_app_fn(s) for s in SITES8},
                               num_edges=num_edges, timeout=30.0)
    try:
        h = ServerApp(_cfg(num_rounds=2, agg_backend=backend),
                      FedAvg(low_memory=True)).run(
            SuperLinkDriver(link, expected_nodes=num_edges))
    finally:
        for n in edges:
            n.stop()
    _same_history(h, h_ref)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("num_edges", [1, 3])
def test_port_edges_fold_at_reference_root(num_edges, backend):
    from repro.core.superlink import SuperLink as RSuperLink
    from repro.core.superlink import SuperLinkDriver as RSuperLinkDriver
    from repro.fl import FedAvg as RFedAvg
    from repro.fl import ServerApp as RServerApp
    from repro.fl import ServerConfig as RServerConfig

    h_ref, _ = _reference_hierarchical(num_edges)
    link = RSuperLink()
    edges = make_edge_tier(link, {s: _app_fn(NoisyClient)(s)
                                  for s in SITES8},
                           num_edges=num_edges, timeout=30.0,
                           backend=backend, device="cpu")
    try:
        h = RServerApp(RServerConfig(num_rounds=2),
                       RFedAvg(low_memory=True, backend="numpy")).run(
            RSuperLinkDriver(link, expected_nodes=num_edges))
    finally:
        for n in edges:
            n.stop()
    _same_history(h, h_ref)


# ---------------------------------------------------------------------------
# scale: the 10k-client claim (CI hier-cpu lane re-runs under 8 devices)
# ---------------------------------------------------------------------------
@pytest.mark.hier
@pytest.mark.slow
def test_10k_clients_root_folds_only_edge_payloads():
    n, num_edges = 10_000, 8
    sites = [f"c-{i:05d}" for i in range(n)]
    h = run_hierarchical(
        ServerApp(_cfg(num_rounds=1, round_timeout=300.0,
                               agg_shards=8),
                  FedAvg()),
        _app_fn(DyadicClient), sites, num_edges=num_edges,
        edge_timeout=300.0)
    r = h.rounds[0]
    assert r.metrics["num_clients"] == n
    assert r.metrics["num_payloads"] <= num_edges
    assert not r.failures
    assert h.final_parameters is not None
