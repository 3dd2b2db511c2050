"""FL strategy unit tests + robustness properties, on the port: the cases of
``tests/test_strategies.py`` against ``repro_torch.fl.strategy``, every fold
on the CPU (the torch backend's plain twins).  Across the packages, each
strategy's ``aggregate_fit`` equals the reference's bitwise on the same
results over three stateful rounds, on the numpy engine and the torch
backend (Krum's aggregate within 1e-9, with the same selection).
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.fl.messages import FitRes
from repro_torch.fl.strategy import (FedAdam, FedAvg, FedAvgM, FedMedian,
                                     FedProx, FedTrimmedMean, FedYogi, Krum,
                                     make_strategy,
                                     weighted_average)


def _res(arrays, n):
    return FitRes([np.asarray(a, np.float32) for a in arrays], n, {})


def test_weighted_average_exact():
    out = weighted_average([([np.array([1.0, 2.0])], 1),
                            ([np.array([3.0, 4.0])], 3)], device="cpu")
    np.testing.assert_allclose(out[0], [2.5, 3.5])


def test_fedavg_weighted_by_examples():
    st_ = FedAvg(device="cpu")
    cur = [np.zeros(2, np.float32)]
    agg, m = st_.aggregate_fit(1, [("a", _res([[2.0, 2.0]], 100)),
                                   ("b", _res([[0.0, 0.0]], 300))], [], cur)
    np.testing.assert_allclose(agg[0], [0.5, 0.5])
    assert m["num_clients"] == 2


def test_fedavgm_momentum_accumulates():
    st_ = FedAvgM(server_lr=1.0, momentum=0.5, device="cpu")
    cur = [np.zeros(1, np.float32)]
    a1, _ = st_.aggregate_fit(1, [("a", _res([[1.0]], 1))], [], cur)
    np.testing.assert_allclose(a1[0], [1.0])
    a2, _ = st_.aggregate_fit(2, [("a", _res([[2.0]], 1))], [], a1)
    # delta=1, velocity = 0.5*1 + 1 = 1.5 -> 1 + 1.5
    np.testing.assert_allclose(a2[0], [2.5])


def test_fedadam_matches_manual_step():
    st_ = FedAdam(server_lr=0.1, beta1=0.9, beta2=0.99, tau=1e-3,
                  device="cpu")
    cur = [np.zeros(1, np.float64)]
    agg, _ = st_.aggregate_fit(1, [("a", _res([[1.0]], 1))], [], cur)
    m = 0.1 * 1.0
    v = (1e-3) ** 2 * 0.99 + 0.01 * 1.0
    want = 0.0 + 0.1 * m / (np.sqrt(v) + 1e-3)
    np.testing.assert_allclose(agg[0], [want], rtol=1e-6)


def test_fedyogi_sign_update():
    st_ = FedYogi(server_lr=0.1, device="cpu")
    cur = [np.zeros(1, np.float64)]
    agg, _ = st_.aggregate_fit(1, [("a", _res([[1.0]], 1))], [], cur)
    assert agg[0][0] > 0


def test_fedprox_passes_mu():
    st_ = FedProx(proximal_mu=0.05, device="cpu")
    cfg = st_.configure_fit(1, [np.zeros(1, np.float32)], ["a", "b"])
    assert cfg["a"].config["proximal_mu"] == 0.05


def test_median_robust_to_outlier():
    st_ = FedMedian(device="cpu")
    cur = [np.zeros(1, np.float32)]
    agg, _ = st_.aggregate_fit(1, [
        ("a", _res([[1.0]], 1)), ("b", _res([[1.1]], 1)),
        ("evil", _res([[1e9]], 1))], [], cur)
    assert agg[0][0] < 2.0


def test_trimmed_mean_drops_extremes():
    st_ = FedTrimmedMean(beta=0.34, device="cpu")
    cur = [np.zeros(1, np.float32)]
    agg, m = st_.aggregate_fit(1, [
        ("a", _res([[-1e9]], 1)), ("b", _res([[1.0]], 1)),
        ("c", _res([[1e9]], 1))], [], cur)
    np.testing.assert_allclose(agg[0], [1.0])


def test_krum_selects_inlier_cluster():
    st_ = Krum(num_byzantine=1, num_selected=1, device="cpu")
    cur = [np.zeros(2, np.float32)]
    inliers = [[1.0, 1.0], [1.05, 0.95], [0.95, 1.05], [1.02, 1.0]]
    results = [(f"s{i}", _res([v], 1)) for i, v in enumerate(inliers)]
    results.append(("evil", _res([[50.0, -50.0]], 1)))
    agg, m = st_.aggregate_fit(1, results, [], cur)
    assert np.linalg.norm(np.asarray(agg[0]) - 1.0) < 0.2
    assert "evil" not in m["krum_selected"] or len(m["krum_selected"]) > 1


def test_make_strategy_registry():
    for name in ("fedavg", "fedavgm", "fedadam", "fedyogi", "fedprox",
                 "fedmedian", "fedtrimmedmean", "krum"):
        assert make_strategy(name, device="cpu") is not None
    with pytest.raises(KeyError):
        make_strategy("nope")


@settings(max_examples=25, deadline=None)
@given(st.lists(st.floats(-100, 100), min_size=2, max_size=8),
       st.lists(st.integers(1, 1000), min_size=2, max_size=8))
def test_fedavg_bounded_by_extremes(vals, weights):
    n = min(len(vals), len(weights))
    vals, weights = vals[:n], weights[:n]
    results = [(f"s{i}", _res([[v]], w)) for i, (v, w) in
               enumerate(zip(vals, weights))]
    agg, _ = FedAvg(device="cpu").aggregate_fit(1, results, [],
                                    [np.zeros(1, np.float32)])
    assert min(vals) - 1e-3 <= agg[0][0] <= max(vals) + 1e-3


def test_aggregate_evaluate_weighted():
    st_ = FedAvg(device="cpu")
    from repro_torch.fl.messages import EvaluateRes

    loss, metrics = st_.aggregate_evaluate(1, [
        ("a", EvaluateRes(1.0, 100, {"accuracy": 1.0})),
        ("b", EvaluateRes(3.0, 300, {"accuracy": 0.0}))], [])
    assert abs(loss - 2.5) < 1e-9
    assert abs(metrics["accuracy"] - 0.25) < 1e-9


# ---------------------------------------------------------------------------
# the port's strategies against the reference's, bitwise
# ---------------------------------------------------------------------------
CROSS_KW = {
    "fedavgm": dict(server_lr=0.7, momentum=0.9),
    "fedadam": dict(server_lr=0.1, beta1=0.9, beta2=0.99, tau=1e-3),
    "fedyogi": dict(server_lr=0.1),
    "fedprox": dict(proximal_mu=0.05),
    "fedtrimmedmean": dict(beta=0.25),
    "krum": dict(num_byzantine=1, num_selected=2),
}


def _cross_results(rnd, n_clients=6):
    import repro.fl.messages as RM

    rng = np.random.default_rng(300 + rnd)
    shapes = [(16, 8), (32,), (4, 4, 4), (1,)]
    arrays = [[rng.normal(0, 1 + c, s).astype(np.float32) for s in shapes]
              for c in range(n_clients)]
    port = [(f"site-{c}", FitRes(a, 10 + 7 * c, {}))
            for c, a in enumerate(arrays)]
    ref = [(f"site-{c}", RM.FitRes(a, 10 + 7 * c, {}))
           for c, a in enumerate(arrays)]
    return port, ref, [np.zeros(s, np.float32) for s in shapes]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", ["fedavg", "fedavgm", "fedadam", "fedyogi",
                                  "fedprox", "fedmedian", "fedtrimmedmean",
                                  "krum"])
def test_aggregate_fit_equals_the_reference(name, backend):
    from repro.fl.strategy import make_strategy as ref_make_strategy

    kw = CROSS_KW.get(name, {})
    port = make_strategy(name, backend=backend, device="cpu", **kw)
    ref = ref_make_strategy(name, backend="numpy", **kw)
    cur_port = cur_ref = None
    for rnd in range(1, 4):                      # stateful over 3 rounds
        res_port, res_ref, current = _cross_results(rnd)
        if cur_port is None:
            cur_port, cur_ref = current, [np.copy(a) for a in current]
        got, m_port = port.aggregate_fit(rnd, res_port, [], cur_port)
        want, m_ref = ref.aggregate_fit(rnd, res_ref, [], cur_ref)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            if name == "krum":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-9)
            else:
                assert g.tobytes() == w.tobytes()
        if name == "krum":
            assert m_port["krum_selected"] == m_ref["krum_selected"]
        else:
            assert m_port == m_ref
        cur_port, cur_ref = got, want
