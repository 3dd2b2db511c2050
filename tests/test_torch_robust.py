"""The port's robust reductions against the reference, on the CPU.

FedMedian, FedTrimmedMean and Krum reduce on the port's ``torch`` backend
through ``kernels.agg_reduce.sort_reduce`` and ``gram`` -- here their plain
twins (``device="cpu"``; the kernels are held against the twins on the
card in ``tests/test_torch_agg_reduce.py``).  The oracles:

- the reference's numpy engine (``repro.fl.agg_kernels``, backend
  "numpy"): median and trimmed mean **bitwise** (output buffers byte-equal;
  where NaN is expected, NaN at the same places and every other byte
  equal), Krum's distances within ``rtol=1e-9, atol=1e-9``
  (``rtol=1e-6, atol=1e-4`` with a large common offset) and its selection
  exactly -- the contract of ``tests/test_agg_pallas.py:216-279``;
- the reference's Pallas kernels ``repro.kernels.agg_reduce.sort_reduce``
  and ``gram`` in interpret mode: median and trimmed sum bitwise, the Gram
  matrix within ``rtol=1e-9``.  JAX 0.9.0 removed
  ``jax.experimental.enable_x64``, which those kernels call; each such test
  patches it back in for itself only (``monkeypatch``), and nothing in the
  reference changes.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import jax.experimental
import ml_dtypes
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

import repro.fl.agg_kernels as RK
import repro.fl.flat as RF
from repro.kernels import agg_reduce as RP
import repro_torch.fl.agg_kernels as TK
import repro_torch.fl.flat as TF
from repro_torch.fl.messages import FitRes
from repro_torch.fl.strategy import FedMedian, FedTrimmedMean, Krum
from repro_torch.kernels import agg_reduce as TA
from test_torch_agg import assert_bitwise, make_payloads

TORCH = {"backend": "torch", "device": "cpu"}
CLIENTS = [1, 2, 3, 6, 9, 16]
ROBUST_CODECS = ["flat", "bf16", "q8", "q8_delta_flat", "q8_delta_quant"]


def _key(codec):
    return "odd_f32" if codec == "flat" else "big_unaligned"


def _same_with_nan(got, want):
    """Bitwise, except that a NaN only has to be a NaN."""
    assert got.layout.signature == want.layout.signature
    a, b = got.math_view(), want.math_view()
    nan = np.isnan(b)
    assert (np.isnan(a) == nan).all()
    assert a[~nan].tobytes() == b[~nan].tobytes()


# ---------------------------------------------------------------------------
# against the reference numpy engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_clients", CLIENTS)
@pytest.mark.parametrize("codec", ROBUST_CODECS)
def test_median_bitwise_against_numpy_engine(codec, n_clients):
    rl, ref, tl, port = make_payloads(_key(codec), codec, n_clients, seed=6)
    want = RK.median(ref, rl, backend="numpy")
    assert_bitwise(TK.median(port, tl, **TORCH), want)
    assert_bitwise(TK.median(port, tl, backend="numpy"), want)


@pytest.mark.parametrize("n_clients,k", [(1, 0), (2, 1), (3, 1), (4, 2),
                                         (5, 1), (6, 2), (9, 3), (16, 5)])
@pytest.mark.parametrize("codec", ROBUST_CODECS)
def test_trimmed_mean_bitwise_against_numpy_engine(codec, n_clients, k):
    # (2, 1) and (4, 2) are n <= 2k: the untrimmed mean
    rl, ref, tl, port = make_payloads(_key(codec), codec, n_clients, seed=8)
    want = RK.trimmed_mean(ref, rl, k, backend="numpy")
    assert_bitwise(TK.trimmed_mean(port, tl, k, **TORCH), want)


@pytest.mark.parametrize("layout_key", ["uniform_f64", "mixed_dtypes",
                                        "uniform_f16", "uniform_bf16"])
def test_robust_reductions_keep_leaf_dtypes(layout_key):
    rl, ref, tl, port = make_payloads(layout_key, "flat", 5, seed=7)
    assert_bitwise(TK.median(port, tl, **TORCH),
                   RK.median(ref, rl, backend="numpy"))
    assert_bitwise(TK.trimmed_mean(port, tl, 1, **TORCH),
                   RK.trimmed_mean(ref, rl, 1, backend="numpy"))


@pytest.mark.parametrize("n_clients", CLIENTS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_nan_and_signed_zero_columns(dtype, n_clients):
    """numpy's median is NaN wherever a column holds a NaN; its sort puts
    NaNs last, so the trimmed mean drops up to k of them; its sums start
    from +0.0, so a zero result is +0 whichever zeros the sort kept."""
    sig = [(dtype, (300,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    rng = np.random.default_rng(n_clients)
    x = rng.normal(0, 1, (n_clients, 300))
    x[:, :60] = rng.choice([-0.0, 0.0], (n_clients, 60))      # only zeros
    x[:, 60:120] = rng.choice([-0.0, 0.0, -1.5, 1.5, 2.0**-1074],
                              (n_clients, 60))
    x[rng.integers(0, n_clients, 40), rng.integers(120, 300, 40)] = np.nan
    x[:, 299] = np.nan
    x = x.astype(dtype)
    ref = [RF.FlatParams.from_arrays([r], rl) for r in x]
    port = [TF.FlatParams.from_arrays([r], tl) for r in x]
    with np.errstate(invalid="ignore"):
        want = RK.median(ref, rl, backend="numpy")
        assert np.isnan(want.math_view()[299])
        _same_with_nan(TK.median(port, tl, **TORCH), want)
        for k in sorted({0, 1, n_clients // 3}):
            _same_with_nan(TK.trimmed_mean(port, tl, k, **TORCH),
                           RK.trimmed_mean(ref, rl, k, backend="numpy"))


@settings(max_examples=8, deadline=None)
@given(st.integers(2, 7), st.integers(1, 1500), st.integers(0, 500))
def test_property_robust_reductions_any_size(n_clients, size, seed):
    """Port of ``tests/test_agg_pallas.py:326``: any client count and odd
    buffer size, median and trimmed mean bitwise."""
    sig = (("float32", (size,)),)
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    rng = np.random.default_rng(seed + 31)
    rows = [rng.normal(0, 1 + i, (size,)).astype(np.float32)
            for i in range(n_clients)]
    ref = [RF.FlatParams.from_arrays([r], rl) for r in rows]
    port = [TF.FlatParams.from_arrays([r], tl) for r in rows]
    assert_bitwise(TK.median(port, tl, **TORCH),
                   RK.median(ref, rl, backend="numpy"))
    k = max(0, (n_clients - 1) // 3)
    assert_bitwise(TK.trimmed_mean(port, tl, k, **TORCH),
                   RK.trimmed_mean(ref, rl, k, backend="numpy"))


@pytest.mark.parametrize("n_clients", [3, 6, 9, 16])
@pytest.mark.parametrize("codec", ["flat", "bf16", "q8", "q8_delta_quant"])
def test_krum_distances_and_selection(codec, n_clients):
    rl, ref, tl, port = make_payloads(_key(codec), codec, n_clients, seed=9)
    d_port = TK.krum_distances(port, tl, **TORCH)
    d_ref = RK.krum_distances(ref, rl, backend="numpy")
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-9, atol=1e-9)
    assert (d_port >= 0).all()
    for f in (0, 1):
        s_port = TK.krum_scores(d_port, f)
        s_ref = RK.krum_scores(d_ref, f)
        assert np.argsort(s_port).tolist() == np.argsort(s_ref).tolist()
        chosen = np.argsort(s_port)[:2]
        assert_bitwise(
            TK.weighted_mean([(port[i], 4.0 + i) for i in chosen], tl,
                             **TORCH),
            RK.weighted_mean([(ref[i], 4.0 + i) for i in chosen], rl,
                             backend="numpy"))


def test_krum_large_common_offset():
    """Client updates nearly identical with a huge common component: the
    centred Gram must not cancel catastrophically."""
    sig = [("float32", (2048,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    rng = np.random.default_rng(10)
    common = rng.normal(0, 1, 2048).astype(np.float32) * 1e4
    rows = [common + rng.normal(0, 1e-2, 2048).astype(np.float32)
            for _ in range(5)]
    d_port = TK.krum_distances(
        [TF.FlatParams.from_arrays([r], tl) for r in rows], tl, **TORCH)
    d_ref = RK.krum_distances(
        [RF.FlatParams.from_arrays([r], rl) for r in rows], rl,
        backend="numpy")
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-6, atol=1e-4)
    assert (d_port >= 0).all()


# ---------------------------------------------------------------------------
# against the reference Pallas kernels in interpret mode
# ---------------------------------------------------------------------------
#: past the kernels' register path (C <= 64): shared-memory sorts and the
#: Gram matrix tiled by 64-client blocks (at 1000: 136 block pairs)
MANY_CLIENTS = [65, 200, 1000]


@pytest.mark.parametrize("n_clients", MANY_CLIENTS)
@pytest.mark.parametrize("codec", ["flat", "q8_delta_quant"])
def test_robust_folds_take_any_client_count(codec, n_clients):
    """No client cap: FedMedian's, FedTrimmedMean's and Krum's reductions
    over 65, 200 and 1000 clients on the torch backend -- median and
    trimmed mean bitwise the numpy engine, Krum's distances within 1e-9 and
    its order of scores (hence its selection) exact."""
    rl, ref, tl, port = make_payloads("odd_f32" if codec == "flat"
                                      else "big_unaligned", codec,
                                      n_clients, seed=n_clients)
    assert_bitwise(TK.median(port, tl, **TORCH),
                   RK.median(ref, rl, backend="numpy"))
    k = int(0.1 * n_clients)
    assert_bitwise(TK.trimmed_mean(port, tl, k, **TORCH),
                   RK.trimmed_mean(ref, rl, k, backend="numpy"))
    d_port = TK.krum_distances(port, tl, **TORCH)
    d_ref = RK.krum_distances(ref, rl, backend="numpy")
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-9, atol=1e-9)
    assert np.argsort(TK.krum_scores(d_port, 2)).tolist() \
        == np.argsort(RK.krum_scores(d_ref, 2)).tolist()


@pytest.fixture
def pallas_x64(monkeypatch):
    """Give the reference kernels back the ``enable_x64`` context manager
    that JAX 0.9.0 removed, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def _stacks(kind, c, n, seed, qchunk=1024):
    """The same (C, N) stack as numpy arrays for the reference kernel and
    as CPU tensors for the port's twins."""
    rng = np.random.default_rng(seed)
    scales = base = None
    if kind.startswith("int8"):
        data = rng.integers(-127, 128, (c, n), dtype=np.int8)
        scales = rng.uniform(1e-3, 1e-1, (c, -(-n // qchunk))) \
            .astype(np.float32)
        if kind == "int8_base":
            base = rng.normal(0, 1, n)
        t = torch.from_numpy(data)
    elif kind == "bfloat16":
        data = rng.normal(0, 2, (c, n)).astype(np.float32) \
            .astype(ml_dtypes.bfloat16)
        t = torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    else:
        data = rng.normal(0, 2, (c, n)).astype(kind)
        t = torch.from_numpy(data)
    ref = dict(scales=scales, qchunk=qchunk, base=base)
    port = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in ref.items()}
    return data, ref, t, port


@pytest.mark.parametrize("n_clients", [1, 4, 9])
@pytest.mark.parametrize("kind", ["int8", "int8_base", "float16", "bfloat16",
                                  "float32", "float64"])
def test_twins_match_reference_pallas_kernels(pallas_x64, kind, n_clients):
    data, ref, t, port = _stacks(kind, n_clients, 2500, seed=n_clients)
    med = TA.sort_reduce(t, kind="median", **port).numpy()
    assert med.tobytes() == RP.sort_reduce(data, kind="median",
                                           **ref).tobytes()
    k = (n_clients - 1) // 3
    tsum = TA.sort_reduce(t, kind="trim_sum", trim_k=k, **port).numpy()
    assert tsum.tobytes() == RP.sort_reduce(data, kind="trim_sum", trim_k=k,
                                            **ref).tobytes()
    np.testing.assert_allclose(TA.gram(t, **port).numpy(),
                               RP.gram(data, **ref), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("codec", ["flat", "q8_delta_quant"])
def test_torch_backend_matches_reference_pallas_backend(pallas_x64, codec):
    rl, ref, tl, port = make_payloads(_key(codec), codec, 5, seed=11)
    assert_bitwise(TK.median(port, tl, **TORCH),
                   RK.median(ref, rl, backend="pallas"))
    assert_bitwise(TK.trimmed_mean(port, tl, 1, **TORCH),
                   RK.trimmed_mean(ref, rl, 1, backend="pallas"))
    np.testing.assert_allclose(TK.krum_distances(port, tl, **TORCH),
                               RK.krum_distances(ref, rl, backend="pallas"),
                               rtol=1e-9, atol=1e-9)


# ---------------------------------------------------------------------------
# the strategies on the torch backend (ports of tests/test_strategies.py)
# ---------------------------------------------------------------------------
def _res(arrays, n):
    return FitRes([np.asarray(a, np.float32) for a in arrays], n, {})


def test_median_robust_to_outlier():
    st_ = FedMedian(**TORCH)
    agg, _ = st_.aggregate_fit(1, [
        ("a", _res([[1.0]], 1)), ("b", _res([[1.1]], 1)),
        ("evil", _res([[1e9]], 1))], [], [np.zeros(1, np.float32)])
    assert agg[0][0] < 2.0


def test_trimmed_mean_drops_extremes():
    st_ = FedTrimmedMean(beta=0.34, **TORCH)
    agg, m = st_.aggregate_fit(1, [
        ("a", _res([[-1e9]], 1)), ("b", _res([[1.0]], 1)),
        ("c", _res([[1e9]], 1))], [], [np.zeros(1, np.float32)])
    np.testing.assert_allclose(agg[0], [1.0])
    assert m["trimmed_each_end"] == 1


def test_krum_selects_inlier_cluster():
    st_ = Krum(num_byzantine=1, num_selected=1, **TORCH)
    inliers = [[1.0, 1.0], [1.05, 0.95], [0.95, 1.05], [1.02, 1.0]]
    results = [(f"s{i}", _res([v], 1)) for i, v in enumerate(inliers)]
    results.append(("evil", _res([[50.0, -50.0]], 1)))
    agg, m = st_.aggregate_fit(1, results, [], [np.zeros(2, np.float32)])
    assert np.linalg.norm(np.asarray(agg[0]) - 1.0) < 0.2
    assert m["krum_selected"] != ["evil"]


@pytest.mark.parametrize("strategy", [FedMedian, FedTrimmedMean, Krum])
def test_robust_strategies_reduce_on_their_device(strategy, monkeypatch):
    """The strategy hands its ``device`` to the kernel entry point: with no
    CUDA, the default (the card) raises and ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    results = [(f"s{i}", _res([[float(i), 1.0]], 1)) for i in range(4)]
    cur = [np.zeros(2, np.float32)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        strategy(backend="torch").aggregate_fit(1, results, [], cur)
    agg, _ = strategy(**TORCH).aggregate_fit(1, results, [], cur)
    assert np.isfinite(agg[0]).all()
