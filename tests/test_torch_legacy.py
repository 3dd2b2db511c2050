"""The port's frozen per-layer baseline (``repro_torch.fl.legacy``).

The cases of ``tests/test_legacy_equiv.py`` and the legacy parts of
``tests/test_flat.py`` on the port: the reference arithmetic pinned by
hand, legacy-codec bytes through ``LegacyFedAvg`` bitwise equal to
flat-codec bytes through the flat engine, and every flat strategy equal
to its legacy twin (exactly for FedAvg, FedMedian, FedTrimmedMean and
Krum, otherwise within 1 ULP), on the numpy engine and on the torch
backend's plain twins (``device="cpu"``).  bfloat16 leaves are the port's
uint16 bit storage (``repro_torch.fl.flat.np_dtype("bfloat16")``).  Across
frameworks, the port's ``legacy.py`` equals the reference's bitwise for
every ``LEGACY_TABLE`` entry over three stateful rounds, with fp32, fp64
and bf16 leaves (the reference's bf16 is ``ml_dtypes.bfloat16`` over the
same bits).
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import ml_dtypes
import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

import repro.fl.legacy as RL
import repro.fl.messages as RM
from repro_torch.fl.flat import bf16_to_f32, np_dtype, to_bf16
from repro_torch.fl.legacy import (LEGACY_TABLE, LegacyFedAvg,
                                   legacy_weighted_average)
from repro_torch.fl.messages import FitRes, decode_fit_res, encode_fit_res
from repro_torch.fl.strategy import make_strategy, weighted_average

BF16 = np_dtype("bfloat16")
BACKENDS = ("numpy", "torch")


def _strategy(name, backend="numpy", **kw):
    return make_strategy(name, backend=backend, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_legacy_equiv.py
# ---------------------------------------------------------------------------
def test_legacy_weighted_average_hand_computed():
    a = [np.array([2.0, 4.0], np.float32), np.array([[8.0]], np.float32)]
    b = [np.array([6.0, 0.0], np.float32), np.array([[0.0]], np.float32)]
    out = legacy_weighted_average([(a, 1.0), (b, 3.0)])
    # W=4: (1/4)*a + (3/4)*b
    np.testing.assert_array_equal(out[0], np.array([5.0, 1.0], np.float32))
    np.testing.assert_array_equal(out[1], np.array([[2.0]], np.float32))
    assert out[0].dtype == np.float32 and out[1].dtype == np.float32


def test_legacy_fedavg_min_clients_and_metrics():
    params = [np.ones((3,), np.float32)]
    res = [("site-0", FitRes(params, 5, {}))]
    agg, metrics = LegacyFedAvg().aggregate_fit(1, res, [], params)
    assert metrics == {"num_clients": 1}
    with pytest.raises(RuntimeError):
        LegacyFedAvg(min_fit_clients=2).aggregate_fit(1, res, [], params)


def _wire_results(codec, n_clients=5, seed=0):
    """Client results as the server would decode them off the wire."""
    rng = np.random.default_rng(seed)
    shapes = [(16, 8), (33,), (4, 4, 4), (1,)]
    out = []
    for c in range(n_clients):
        arrays = [rng.normal(0, 1 + c, s).astype(np.float32)
                  for s in shapes]
        payload = encode_fit_res(FitRes(arrays, 10 + 3 * c, {}),
                                 codec=codec)
        r = decode_fit_res(payload)
        r.num_examples = 10 + 3 * c
        out.append((f"site-{c}", r))
    current = [np.zeros(s, np.float32) for s in shapes]
    return out, current


@pytest.mark.parametrize("backend", BACKENDS)
def test_legacy_wire_vs_flat_wire_bitwise(backend):
    legacy_res, current = _wire_results("legacy")
    flat_res, _ = _wire_results("flat")
    want, _ = LegacyFedAvg().aggregate_fit(1, legacy_res, [], current)
    got, _ = _strategy("fedavg", backend).aggregate_fit(1, flat_res, [],
                                                       current)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(LEGACY_TABLE))
def test_legacy_table_strategies_run_from_wire_bytes(name):
    results, current = _wire_results("legacy", n_clients=6, seed=3)
    kw = {"num_byzantine": 1} if name == "krum" else {}
    agg, metrics = LEGACY_TABLE[name](**kw).aggregate_fit(
        1, results, [], current)
    assert len(agg) == len(current)
    for a, c in zip(agg, current):
        assert a.shape == c.shape and a.dtype == c.dtype
        assert np.isfinite(a).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_public_weighted_average_matches_legacy_bitwise(backend):
    rng = np.random.default_rng(11)
    shapes = [(7, 3), (19,)]
    results = [([rng.normal(0, 1, s).astype(np.float32) for s in shapes],
                4.0 + i) for i in range(4)]
    got = weighted_average(results, backend=backend, device="cpu")
    want = legacy_weighted_average(results)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# tests/test_flat.py: flat strategies against the legacy per-layer loops
# ---------------------------------------------------------------------------
def _make_results(n_clients=5, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(16, 8), (32,), (4, 4, 4), (1,)]
    results = []
    for c in range(n_clients):
        arrays = [rng.normal(0, 1, size=s).astype(dtype) for s in shapes]
        results.append((f"site-{c}", FitRes(arrays, 10 + 7 * c, {})))
    current = [np.zeros(s, dtype) for s in shapes]
    return results, current


def _assert_leaves_close(got, want, exact=False):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_array_max_ulp(g, w, maxulp=1)


STRATEGY_KW = {
    "fedavgm": dict(server_lr=0.7, momentum=0.9),
    "fedadam": dict(server_lr=0.1, beta1=0.9, beta2=0.99, tau=1e-3),
    "fedyogi": dict(server_lr=0.1),
    "fedtrimmedmean": dict(beta=0.25),
    "krum": dict(num_byzantine=1, num_selected=2),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(LEGACY_TABLE))
def test_strategy_matches_legacy(name, backend):
    kw = STRATEGY_KW.get(name, {})
    new = _strategy(name, backend, **kw)
    old = LEGACY_TABLE[name](**kw)
    exact = name in ("fedavg", "fedmedian", "fedtrimmedmean", "krum")
    cur_new = cur_old = None
    for rnd in range(1, 4):                      # stateful over 3 rounds
        results, current0 = _make_results(n_clients=6, seed=100 + rnd)
        if cur_new is None:
            cur_new, cur_old = current0, [np.copy(a) for a in current0]
        got, m_new = new.aggregate_fit(rnd, results, [], cur_new)
        want, m_old = old.aggregate_fit(rnd, results, [], cur_old)
        _assert_leaves_close(got, want, exact=exact)
        if name == "krum":
            # new API reports node ids; legacy reports list positions
            assert m_new["krum_selected"] == \
                [results[i][0] for i in m_old["krum_selected"]]
        cur_new, cur_old = got, want


@pytest.mark.parametrize("backend", BACKENDS)
def test_fedavg_matches_legacy_bitwise_f64_leaves(backend):
    results, current = _make_results(n_clients=4, seed=3, dtype=np.float64)
    got, _ = _strategy("fedavg", backend).aggregate_fit(1, results, [],
                                                       current)
    want, _ = LEGACY_TABLE["fedavg"]().aggregate_fit(1, results, [], current)
    _assert_leaves_close(got, want, exact=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_low_memory_streaming_within_ulp(backend):
    results, current = _make_results(n_clients=6, seed=13)
    got, _ = _strategy("fedavg", backend, low_memory=True) \
        .aggregate_fit(1, results, [], current)
    want, _ = LEGACY_TABLE["fedavg"]().aggregate_fit(1, results, [], current)
    _assert_leaves_close(got, want, exact=False)


@pytest.mark.parametrize("backend", BACKENDS)
def test_strategy_accepts_mixed_dtype_leaves(backend):
    rng = np.random.default_rng(5)
    shapes = [(8, 4), (16,)]
    results = []
    for c in range(4):
        arrays = [rng.normal(size=shapes[0]).astype(np.float32),
                  to_bf16(rng.normal(size=shapes[1]))]
        results.append((f"s{c}", FitRes(arrays, 5 + c, {})))
    current = [np.zeros(shapes[0], np.float32), to_bf16(np.zeros(shapes[1]))]
    got, _ = _strategy("fedavg", backend).aggregate_fit(1, results, [],
                                                       current)
    want, _ = LEGACY_TABLE["fedavg"]().aggregate_fit(1, results, [], current)
    assert got[1].dtype == BF16 and want[1].dtype == BF16
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(bf16_to_f32(got[1]), bf16_to_f32(want[1]))


def test_legacy_bf16_leaf_widens_as_floats_not_bits():
    """The bits 0x3F80 are bf16 1.0: a verbatim ``astype(np.float64)``
    would read them as the integer 16256, and narrowing back with
    ``astype`` would truncate floats into uint16."""
    one, three = to_bf16(np.ones(4)), to_bf16(np.full(4, 3.0))
    out = legacy_weighted_average([([one], 1.0), ([three], 1.0)])
    assert out[0].dtype == BF16
    np.testing.assert_array_equal(bf16_to_f32(out[0]), np.full(4, 2.0))


@settings(max_examples=20, deadline=None)
@given(st.integers(2, 8), st.integers(0, 1000))
def test_weighted_mean_property(n_clients, seed):
    """flat weighted mean == legacy per-layer loop, any client count."""
    rng = np.random.default_rng(seed)
    pairs = [([rng.normal(size=(5, 3)).astype(np.float32),
               rng.normal(size=(7,)).astype(np.float32)],
              float(rng.integers(1, 100))) for _ in range(n_clients)]
    for backend in BACKENDS:
        got = weighted_average(pairs, backend=backend, device="cpu")
        want = legacy_weighted_average(pairs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the port's legacy.py against the reference's, bitwise
# ---------------------------------------------------------------------------
DTYPES = ("float32", "float64", "bfloat16")


def _to_ref(a):
    """A port leaf as the reference holds it (bf16: ml_dtypes, same bits)."""
    return a.view(ml_dtypes.bfloat16) if a.dtype == BF16 else a


def _round_inputs(rnd, dtype, n_clients=6):
    rng = np.random.default_rng(200 + rnd)
    shapes = [(16, 8), (32,), (4, 4, 4), (1,)]

    def leaf(x):
        return to_bf16(x) if dtype == "bfloat16" else x.astype(dtype)

    arrays = [[leaf(rng.normal(0, 1 + c, s)) for s in shapes]
              for c in range(n_clients)]
    port = [(f"site-{c}", FitRes(a, 10 + 7 * c, {}))
            for c, a in enumerate(arrays)]
    ref = [(f"site-{c}", RM.FitRes([_to_ref(x) for x in a], 10 + 7 * c, {}))
           for c, a in enumerate(arrays)]
    current = [leaf(np.zeros(s)) for s in shapes]
    return port, ref, current


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(LEGACY_TABLE))
def test_legacy_equals_the_reference_legacy_bitwise(name, dtype):
    kw = STRATEGY_KW.get(name, {})
    port, ref = LEGACY_TABLE[name](**kw), RL.LEGACY_TABLE[name](**kw)
    cur_port = cur_ref = None
    for rnd in range(1, 4):
        res_port, res_ref, current = _round_inputs(rnd, dtype)
        if cur_port is None:
            cur_port, cur_ref = current, [_to_ref(a) for a in current]
        got, m_port = port.aggregate_fit(rnd, res_port, [], cur_port)
        want, m_ref = ref.aggregate_fit(rnd, res_ref, [], cur_ref)
        assert m_port == m_ref
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert g.dtype == (BF16 if dtype == "bfloat16" else w.dtype)
            assert g.tobytes() == w.tobytes()
        cur_port, cur_ref = got, want
