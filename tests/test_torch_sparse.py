"""The port's 0xF5 sparse fold on the torch backend against the reference.

``StreamingWeightedSum.add_sparse`` on ``backend="torch"`` launches the
``scatter_wsum`` kernel once per span of traveled coordinates into the
device accumulator (here on the CPU, its plain twin), and finishes the
round's deferred bases on the device.  It is held bitwise against

- the reference's numpy engine (``repro.fl.agg_kernels``, backend
  "numpy"), single-host and sharded, in the COO (TopK) and ranges
  (adapter) index modes, with int8 and fp32 values;
- the reference's ``scatter_wsum`` (``repro/kernels/agg_reduce.py:396``,
  a jitted XLA graph plus a host scatter, run through the test-local
  ``enable_x64`` shim of ``tests/test_torch_robust.py``);

and it is invariant, bitwise, across arrival orders and shard counts.  The
ports of ``tests/test_sparse.py``'s fold cases follow: sparse and q8
results in one round, ``raw_sum`` as the true weighted sum, and the
stacked strategies refusing sparse results.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.fl.agg_kernels as RK
import repro.fl.flat as RF
import repro_torch.fl.agg_kernels as TK
import repro_torch.fl.flat as TF
from repro_torch.fl.messages import (FitRes, decode_fit_res,
                                     encode_fit_res)
from repro_torch.fl.strategy import make_strategy
from repro_torch.kernels import agg_reduce

TORCH = {"backend": "torch", "device": "cpu"}
SHAPES = ((33, 17), (1500,), (2, 3, 5), (2048,))


def _arrays(seed=0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.5, size=s).astype(np.float32) for s in shapes]


def _deltas(seed, n_clients, imode, vmode, base_vec, frac=0.05):
    """Per client a SparseDelta (indices, values, scales) in both packages
    over the same arrays, against a shared base per package."""
    rng = np.random.default_rng(seed)
    n = base_vec.size
    out = []
    for c in range(n_clients):
        if imode == "coo":
            idx = np.sort(rng.choice(n, max(1, int(frac * n)),
                                     replace=False)).astype(np.int64)
            nnz = idx.size
        else:
            starts = np.sort(rng.choice(np.arange(0, n - 40, 97), 9,
                                        replace=False))
            lens = rng.integers(1, 40, starts.size)
            idx = np.stack([starts, starts + lens], 1).astype(np.int64)
            nnz = int(lens.sum())
        vals = rng.normal(0, 1e-3 * (1 + c), nnz).astype(np.float32)
        scales = None
        if vmode == "q8":
            vals, scales = RF.quantize_int8(vals)
        out.append((idx, vals, scales, 10.0 + 3 * c))
    return out


def _pair(imode, vmode, n_clients, seed, base_kind="flat"):
    """(reference layout, payloads, port layout, payloads, weights)."""
    rl, tl = RF.layout_of(_arrays()), TF.layout_of(_arrays())
    base_vec = np.concatenate([a.ravel() for a in _arrays(seed=1)])
    rbase = RF.FlatParams.from_arrays(RF.unflatten_vector(base_vec, rl), rl)
    tbase = TF.FlatParams.from_arrays(TF.unflatten_vector(base_vec, tl), tl)
    if base_kind == "q8":
        q, s = RF.quantize_int8(base_vec)
        rbase, tbase = (RF.QuantParams(rl, "q8", q, s),
                        TF.QuantParams(tl, "q8", q.copy(), s.copy()))
    ref, port, w = [], [], []
    for idx, vals, scales, wt in _deltas(seed, n_clients, imode, vmode,
                                         base_vec):
        ref.append(RF.SparseDelta(rl, imode, idx, vals, scales,
                                  base=rbase))
        port.append(TF.SparseDelta(tl, imode, idx.copy(), vals.copy(),
                                   None if scales is None else scales.copy(),
                                   base=tbase))
        w.append(wt)
    return rl, ref, tl, port, w


def _fold(K, layout, payloads, weights, **kw):
    s = K.StreamingWeightedSum(layout, **kw)
    for p, w in zip(payloads, weights):
        s.add(p, w)
    return s


def _bitwise(got, want):
    assert got.buf.tobytes() == want.buf.tobytes()


CASES = [(i, v) for i in ("coo", "ranges") for v in ("q8", "f32")]


@pytest.mark.parametrize("imode,vmode", CASES)
@pytest.mark.parametrize("base_kind", ["flat", "q8"])
def test_sparse_fold_bitwise_the_numpy_engine(imode, vmode, base_kind):
    rl, ref, tl, port, w = _pair(imode, vmode, 4, seed=40,
                                 base_kind=base_kind)
    want = _fold(RK, rl, ref, w, backend="numpy").finalize()
    before = agg_reduce.LAUNCHES["scatter_wsum"]
    got = _fold(TK, tl, port, w, **TORCH).finalize()
    assert agg_reduce.LAUNCHES["scatter_wsum"] == before   # CPU: the twin
    _bitwise(got, want)
    _bitwise(_fold(TK, tl, port, w, backend="numpy").finalize(), want)


@pytest.mark.parametrize("imode,vmode", CASES)
def test_sparse_fold_invariant_across_shard_counts_and_arrival_orders(
        imode, vmode):
    rl, ref, tl, port, w = _pair(imode, vmode, 5, seed=41)
    want = _fold(RK, rl, ref, w, backend="numpy", shards=3,
                 overlap=False).finalize()
    for shards in (None, 1, 2, 5, 8):
        got = _fold(TK, tl, port, w, shards=shards, **TORCH).finalize()
        _bitwise(got, want)
    strat = make_strategy("fedavg", **TORCH)
    results = [(f"site-{c}", p, wt) for c, (p, wt) in
               enumerate(zip(port, w))]
    outs = []
    for order in (results, results[::-1], results[2:] + results[:2]):
        acc = strat.fit_accumulator(1, TF.FlatParams.zeros(tl).to_arrays())
        for node, p, wt in order:
            res = FitRes(None, int(wt), {})
            res.sparse = p
            acc.add(node, res)
        got, _ = acc.finalize([])
        outs.append(got)
    for got in outs[1:]:
        for g, o in zip(got, outs[0]):
            assert g.tobytes() == o.tobytes()


@pytest.fixture
def pallas_x64(monkeypatch):
    """Give the reference kernels back the ``enable_x64`` context manager
    that JAX 0.9.0 removed, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("nnz,pos0", [(1, 0), (700, 1000), (4099, 0)])
@pytest.mark.parametrize("slice_dest", [False, True])
def test_kernel_twin_equals_the_reference_scatter_wsum(pallas_x64, q8, nnz,
                                                       pos0, slice_dest):
    from repro.kernels.agg_reduce import scatter_wsum as ref_scatter

    rng = np.random.default_rng(nnz + pos0)
    n = 8192
    x = rng.normal(0, 1e-2, nnz).astype(np.float32)
    scales = None
    if q8:
        x, _ = RF.quantize_int8(x)
        scales = rng.uniform(1e-4, 1e-2, -(-(pos0 + nnz) // 1024)) \
            .astype(np.float32)
    dest = (slice(50, 50 + nnz) if slice_dest else
            np.sort(rng.choice(n, nnz, replace=False)).astype(np.int64))
    acc = rng.normal(0, 1, n)
    want = acc.copy()
    ref_scatter(want, dest, x, 3.5, scales=scales, pos0=pos0)
    got = torch.from_numpy(acc.copy())
    agg_reduce.scatter_wsum(
        got, dest if slice_dest else torch.from_numpy(dest),
        torch.from_numpy(x), 3.5,
        scales=None if scales is None else torch.from_numpy(scales),
        pos0=pos0)
    assert got.numpy().tobytes() == want.tobytes()


def test_sparse_and_q8_results_fold_together():
    """One round, one accumulator: 0xF5, 0xF3-delta and raw fp32 results
    interleaved, through the strategy on the torch backend, bitwise the
    port's numpy engine and the reference strategy."""
    from repro.fl.messages import decode_fit_res as r_decode
    from repro.fl.messages import encode_fit_res as r_encode
    from repro.fl.messages import FitRes as RFitRes
    from repro.fl.strategy import make_strategy as r_make

    base_arrays = _arrays(seed=37)
    tbase = TF.FlatParams.from_arrays(base_arrays)
    rbase = RF.FlatParams.from_arrays(base_arrays)
    rng = np.random.default_rng(38)
    port, ref = [], []
    for i in range(4):
        arrays = [a + rng.normal(0, 1e-3, a.shape).astype(np.float32)
                  for a in base_arrays]
        codec = ("flat", "q8", "sparse")[i % 3]
        t = decode_fit_res(encode_fit_res(FitRes(arrays, 10 + 3 * i, {}),
                                          codec=codec, base=tbase,
                                          sparse_frac=0.05))
        r = r_decode(r_encode(RFitRes(arrays, 10 + 3 * i, {}), codec=codec,
                              base=rbase, sparse_frac=0.05))
        for x, b in ((t, tbase), (r, rbase)):
            if x.quant is not None:
                x.quant.base = b
            if x.sparse is not None:
                x.sparse.base = b
        port.append((f"site-{i}", t))
        ref.append((f"site-{i}", r))
    want, _ = r_make("fedavg", backend="numpy").aggregate_fit(
        1, ref, [], base_arrays)
    for kw in (TORCH, {"backend": "numpy"}):
        got, m = make_strategy("fedavg", **kw).aggregate_fit(
            1, port, [], base_arrays)
        assert m["num_clients"] == 4
        for g, o in zip(got, want):
            assert g.tobytes() == o.tobytes()


def test_sparse_raw_sum_is_the_true_weighted_sum():
    """raw_sum() (the edge's 0xF4 pre-reduce) reports sum w (base + delta),
    the deferred bases folded on the device at their summed weight: bitwise
    the reference's numpy raw_sum."""
    rl, ref, tl, port, w = _pair("coo", "q8", 3, seed=39)
    want = _fold(RK, rl, ref, w, backend="numpy").raw_sum()
    s = _fold(TK, tl, port, w, **TORCH)
    got = s.raw_sum()
    assert got.tobytes() == want.tobytes()
    with pytest.raises(RuntimeError, match="ended"):
        s.add(port[0], 1.0)
    with pytest.raises(ValueError, match="single-host"):
        _fold(TK, tl, port, w, shards=2, **TORCH).raw_sum()


def test_sparse_without_base_is_an_error_and_folds_nothing():
    rl, ref, tl, port, w = _pair("coo", "q8", 2, seed=42)
    s = _fold(TK, tl, port[:1], w[:1], **TORCH)
    orphan = port[1]
    orphan.base = None
    with pytest.raises(ValueError, match="base"):
        s.add(orphan, 1.0)
    assert s.count == 1
    _bitwise(s.finalize(), _fold(RK, rl, ref[:1], w[:1],
                                 backend="numpy").finalize())


def test_stacked_strategies_reject_sparse_results():
    """median/trim/Krum need dense per-client rows: a sparse result that
    reaches them is a loud error (the strategy layer), and the torch
    weighted mean refuses one too."""
    rl, ref, tl, port, w = _pair("coo", "f32", 2, seed=43)
    acc = make_strategy("fedmedian", **TORCH).fit_accumulator(
        1, TF.FlatParams.zeros(tl).to_arrays())
    res = FitRes(None, 10, {})
    res.sparse = port[0]
    with pytest.raises(ValueError, match="dense per-client"):
        acc.add("site-0", res)
    with pytest.raises(TypeError, match="add_sparse"):
        TK.weighted_mean([(port[0], 1.0)], tl, **TORCH)
