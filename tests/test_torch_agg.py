"""The port's aggregation engine against the reference numpy engine, bitwise.

The reference's numpy engine (``repro.fl.agg_kernels``, backend "numpy")
is the oracle.  The port's "numpy" backend is its verbatim copy; the
port's "torch" backend folds through ``kernels.agg_reduce.weighted_sum``
— here on the CPU its plain twin (the kernel itself is held against the
twin on the card in ``tests/test_torch_agg_reduce.py``).  Every
comparison is bitwise:
the output buffers must be byte-equal.  The grid is the layout x codec
grid of ``tests/test_agg_pallas.py`` x 1-7 clients.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

import repro.fl.agg_kernels as RK
import repro.fl.flat as RF
import repro_torch.fl.agg_kernels as TK
import repro_torch.fl.flat as TF
from repro_torch.kernels import agg_reduce as A

LAYOUTS = {
    "odd_f32": [("float32", (17,)), ("float32", (3, 5)), ("float32", (1,)),
                ("float32", (127,))],
    "scalar_leaf": [("float32", ()), ("float32", (2,))],
    "big_unaligned": [("float32", (1000,)), ("float32", (537,))],
    "uniform_f64": [("float64", (33,)), ("float64", (2, 9))],
    "uniform_f16": [("float16", (21, 4))],
    "uniform_bf16": [("bfloat16", (31,))],
    "mixed_dtypes": [("float64", (5,)), ("float32", (3, 3)),
                     ("float16", (9,))],
}
F32_LAYOUTS = [k for k, sig in LAYOUTS.items()
               if all(d == "float32" for d, _ in sig)]
LOSSY = ("bf16", "q8", "q8_delta_flat", "q8_delta_quant", "bf16_delta")
GRID = [(k, "flat") for k in sorted(LAYOUTS)] + \
    [(k, c) for k in F32_LAYOUTS for c in LOSSY]


# ---------------------------------------------------------------------------
# the same payloads in both packages
# ---------------------------------------------------------------------------
def make_payloads(layout_key, codec, n_clients, seed, spread=1.0):
    """Reference payloads built as ``tests/test_agg_pallas.py`` builds
    them, plus the port's twins over the same bytes (delta payloads share
    one base object per package, like a real round)."""
    sig = LAYOUTS[layout_key]
    rl = RF.layout_for(sig)
    rng = np.random.default_rng(seed)
    ref = []
    if codec == "flat":
        for i in range(n_clients):
            ref.append(RF.FlatParams.from_arrays([np.asarray(
                rng.normal(0, spread * (1 + i), s.shape),
                RF.np_dtype(s.dtype)).reshape(s.shape) for s in rl.leaves],
                rl))
    else:
        base_fp = RF.FlatParams.from_arrays(
            [np.asarray(rng.normal(0, 0.5, s.shape), np.float32)
             for s in rl.leaves], rl)
        if codec == "q8_delta_quant":
            qb, sb = RF.quantize_int8(base_fp.math_view())
            base = RF.QuantParams(rl, "q8", qb, sb)
        else:
            base = base_fp
        for i in range(n_clients):
            vec = rng.normal(0, spread * (1 + 0.25 * i),
                             rl.total_size).astype(np.float32)
            if codec in ("bf16", "bf16_delta"):
                d = codec == "bf16_delta"
                ref.append(RF.QuantParams(
                    rl, "bf16", vec.astype(RF.np_dtype("bfloat16")),
                    is_delta=d, base=base if d else None))
            elif codec == "q8":
                ref.append(RF.QuantParams(rl, "q8", *RF.quantize_int8(vec)))
            else:
                q, s = RF.quantize_int8(vec * 1e-3)
                ref.append(RF.QuantParams(rl, "q8", q, s, is_delta=True,
                                          base=base))
    return rl, ref, TF.layout_for(sig), to_port(ref)


def to_port(ref_payloads):
    memo = {}

    def conv(p):
        if p is None:
            return None
        if id(p) in memo:
            return memo[id(p)]
        tl = TF.layout_for(p.layout.signature)
        if isinstance(p, RF.FlatParams):
            out = TF.FlatParams(p.buf.copy(), tl)
        else:
            data = p.data
            if p.mode == "bf16":
                data = data.view(np.uint16).view(TF.np_dtype("bfloat16"))
            out = TF.QuantParams(tl, p.mode, data.copy(), p.scales, p.qchunk,
                                 is_delta=p.is_delta, base=conv(p.base))
        memo[id(p)] = out
        return out

    return [conv(p) for p in ref_payloads]


def assert_bitwise(got, want):
    assert got.layout.signature == want.layout.signature
    assert got.buf.tobytes() == want.buf.tobytes()


def _stream(K, layout, payloads, weights, **kw):
    s = K.StreamingWeightedSum(layout, **kw)
    for p, w in zip(payloads, weights):
        s.add(p, w)
    return s


# ---------------------------------------------------------------------------
# weighted mean and the streaming fold over the grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_clients", range(1, 8))
@pytest.mark.parametrize("layout_key,codec", GRID,
                         ids=[f"{k}-{c}" for k, c in GRID])
def test_weighted_mean_and_streaming_bitwise(layout_key, codec, n_clients):
    rl, ref, tl, port = make_payloads(layout_key, codec, n_clients,
                                      seed=n_clients)
    weights = [7.0 + 3 * i for i in range(n_clients)]
    want = RK.weighted_mean(list(zip(ref, weights)), rl, backend="numpy")
    for kw in ({"backend": "numpy"}, {"backend": "torch", "device": "cpu"}):
        assert_bitwise(TK.weighted_mean(list(zip(port, weights)), tl, **kw),
                       want)
    want_s = _stream(RK, rl, ref, weights, backend="numpy").finalize()
    for kw in ({"backend": "numpy"}, {"backend": "torch", "device": "cpu"}):
        assert_bitwise(_stream(TK, tl, port, weights, **kw).finalize(),
                       want_s)


def test_cancellation_heavy_stack_bitwise():
    """Near-zero sums are where a contracted multiply-add or a reordered
    sum would show up."""
    sig = [("float64", (4096,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    rng = np.random.default_rng(7)
    base = rng.normal(0, 1, rl.total_size)
    arrays, weights = [], []
    for i in range(6):
        sign = 1.0 if i % 2 else -1.0
        arrays.append(sign * base + rng.normal(0, 1e-9, base.shape))
        weights.append(1.0 + 1e-6 * i)
    ref = [RF.FlatParams.from_arrays([a], rl) for a in arrays]
    port = [TF.FlatParams.from_arrays([a], tl) for a in arrays]
    want = RK.weighted_mean(list(zip(ref, weights)), rl, backend="numpy")
    got = TK.weighted_mean(list(zip(port, weights)), tl, backend="torch",
                           device="cpu")
    assert_bitwise(got, want)
    assert_bitwise(
        _stream(TK, tl, port, weights, backend="torch",
                device="cpu").finalize(),
        _stream(RK, rl, ref, weights, backend="numpy").finalize())


class _Foreign:
    """A payload with only the chunked-read protocol (no tile_source):
    the numpy engine folds it, the torch backend refuses it."""

    def __init__(self, fp):
        self.layout = fp.layout
        self.f64_chunk = fp.f64_chunk


def _mixed_round():
    """Raw, bf16, int8 and int8-delta clients (two bases) in one round,
    interleaved so that no two neighbours share a launch."""
    ref, port = [], []
    for i, codec in enumerate(("flat", "bf16", "q8", "q8_delta_quant",
                               "q8_delta_flat")):
        rl, r, tl, p = make_payloads("big_unaligned", codec, 2, seed=20 + i)
        ref += r
        port += p
    order = [0, 2, 4, 6, 8, 1, 3, 5, 7, 9, 6]
    return rl, [ref[i] for i in order], tl, [port[i] for i in order]


def test_streaming_mixed_geometry_arrivals_bitwise():
    """One fold sees raw, bf16, int8 and int8-delta arrivals against two
    bases: the device accumulator survives every change of geometry and
    stays on the device; a payload the kernel cannot take raises."""
    rl, ref, tl, port = _mixed_round()
    weights = [2.0 + i for i in range(len(ref))]
    got = _stream(TK, tl, port, weights, backend="torch", device="cpu")
    assert got._acc is None                 # never brought to the host
    assert_bitwise(got.finalize(),
                   _stream(RK, rl, ref, weights, backend="numpy").finalize())
    with pytest.raises(TypeError, match="tile_source"):
        _stream(TK, tl, [_Foreign(port[0])], [1.0], backend="torch",
                device="cpu")
    assert _stream(TK, tl, [_Foreign(port[0])], [1.0],
                   backend="numpy").count == 1


def test_weighted_mean_mixed_codecs_fall_back_counted():
    """A round that mixes codecs, dtypes and bases folds on the kernel as
    one launch per run of like clients, each continuing the last one's
    accumulator: still bitwise the numpy order."""
    rl, ref, tl, port = _mixed_round()
    weights = [1.0 + 0.5 * i for i in range(len(ref))]
    want = RK.weighted_mean(list(zip(ref, weights)), rl, backend="numpy")
    got = TK.weighted_mean(list(zip(port, weights)), tl, backend="torch",
                           device="cpu")
    assert_bitwise(got, want)
    runs = TK._launch_runs([p.tile_source() for p in port])
    assert len(runs) == len(port)
    flat = make_payloads("odd_f32", "flat", 4, seed=32)
    assert TK._launch_runs([p.tile_source() for p in flat[3]]) == [(0, 4)]


def test_signed_zero_start_matches_reference():
    """The deferred mean starts from the first client's term (-0.0 stays
    -0.0), the streaming fold from a zero accumulator (-0.0 becomes +0.0),
    on the device as in the numpy engine."""
    sig = [("float32", (5,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    z = [np.full(5, -0.0, np.float32)] * 2
    ref = [RF.FlatParams.from_arrays([a], rl) for a in z]
    port = [TF.FlatParams.from_arrays([a], tl) for a in z]
    want = RK.weighted_mean(list(zip(ref, [1.0, 2.0])), rl, backend="numpy")
    assert np.signbit(want.math_view()).all()
    assert_bitwise(TK.weighted_mean(list(zip(port, [1.0, 2.0])), tl,
                                    backend="torch", device="cpu"), want)
    want_s = _stream(RK, rl, ref, [1.0, 2.0], backend="numpy").finalize()
    assert not np.signbit(want_s.math_view()).any()
    assert_bitwise(_stream(TK, tl, port, [1.0, 2.0], backend="torch",
                           device="cpu").finalize(), want_s)


@pytest.mark.parametrize("what", ["uint64", "no_base"])
def test_torch_backend_raises_on_payloads_without_a_kernel(what):
    """Integer-domain shares (SecAgg) have no weighted sum (SecAggFedAvg
    folds them in its own wrapping sum) and a delta without its base cannot
    be read: the torch backend raises for both, in the deferred and the
    streaming fold, and never folds on the host."""
    if what == "uint64":
        sig = [("uint64", (7,))]
        tl = TF.layout_for(sig)
        p = TF.FlatParams.from_arrays([np.arange(7, dtype=np.uint64)], tl)
        err, match = NotImplementedError, "SecAgg"
    else:
        _, _, tl, port = make_payloads("odd_f32", "q8_delta_flat", 1, seed=33)
        p = port[0]
        p.base = None
        err, match = ValueError, "base"
    with pytest.raises(err, match=match):
        TK.weighted_mean([(p, 1.0)], tl, backend="torch", device="cpu")
    s = TK.StreamingWeightedSum(tl, backend="torch", device="cpu")
    with pytest.raises(err, match=match):
        s.add(p, 1.0)
    assert s.count == 0 and s._acc is None


@pytest.mark.parametrize("key", ["uniform_f16", "uniform_bf16",
                                 "mixed_dtypes", "odd_f32"])
def test_finalize_casts_to_leaf_dtypes_like_the_reference(key):
    rl, ref, tl, port = make_payloads(key, "flat", 3, seed=40)
    weights = [1.0, 1.5, 2.5]
    want = _stream(RK, rl, ref, weights, backend="numpy").finalize()
    got = _stream(TK, tl, port, weights, backend="torch",
                  device="cpu").finalize()
    assert_bitwise(got, want)


def test_add_partial_folds_through_the_kernel_bitwise():
    rl, ref, tl, port = make_payloads("odd_f32", "flat", 3, seed=50)
    edge_r = _stream(RK, rl, ref[:2], [1.0, 2.0], backend="numpy")
    edge_t = _stream(TK, tl, port[:2], [1.0, 2.0], backend="numpy")
    ps_r = RF.PartialSum(rl, edge_r.raw_sum(), edge_r.total_w, 2)
    ps_t = TF.PartialSum(tl, edge_t.raw_sum(), edge_t.total_w, 2)
    root_r = _stream(RK, rl, ref[2:], [3.0], backend="numpy")
    root_r.add_partial(ps_r, 0.5)
    root_t = _stream(TK, tl, port[2:], [3.0], backend="torch", device="cpu")
    root_t.add_partial(ps_t, 0.5)
    assert_bitwise(root_t.finalize(), root_r.finalize())


def test_sharded_numpy_fold_matches_reference():
    rl, ref, tl, port = make_payloads("big_unaligned", "q8_delta_flat", 4,
                                      seed=60)
    weights = [1.0, 2.0, 3.0, 4.0]
    for shards in (1, 3):
        want = _stream(RK, rl, ref, weights, backend="numpy", shards=shards,
                       overlap=False).finalize()
        got = _stream(TK, tl, port, weights, backend="numpy", shards=shards,
                      overlap=True).finalize()
        assert_bitwise(got, want)
    assert TK.shard_bounds(2049, 3, align=1024) == \
        ((0, 1024), (1024, 2048), (2048, 2049))


# ---------------------------------------------------------------------------
# the sharded and sparse folds on the torch backend (they raised before
# slice 5 ported them; tests/test_torch_shard_agg.py and
# tests/test_torch_sparse.py hold them to the reference in depth)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_torch_fold_matches_the_numpy_engine(shards):
    """``shards=`` on the torch backend folds (it raised before the port
    of the sharded fold), bitwise the reference numpy engine's sharded
    fold."""
    rl, ref, tl, port = make_payloads("big_unaligned", "q8_delta_quant", 3,
                                      seed=70)
    weights = [1.0, 2.0, 3.0]
    want = _stream(RK, rl, ref, weights, backend="numpy", shards=shards,
                   overlap=False).finalize()
    s = _stream(TK, tl, port, weights, backend="torch", device="cpu",
                shards=shards)
    assert len(s._dsacc) == shards
    assert_bitwise(s.finalize(), want)


def test_sparse_arrival_folds_on_torch_backend():
    """``add_sparse`` on the torch backend folds (it raised before the port
    of ``scatter_wsum``), bitwise the reference numpy engine."""
    rng = np.random.default_rng(71)
    n = 3000
    sig = [("float32", (n,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    base_vec = rng.normal(0, 0.5, n).astype(np.float32)
    idx = np.sort(rng.choice(n, 40, replace=False)).astype(np.int64)
    q, sc = RF.quantize_int8(rng.normal(0, 1e-2, 40).astype(np.float32))
    rbase = RF.FlatParams.from_arrays([base_vec], rl)
    tbase = TF.FlatParams.from_arrays([base_vec], tl)
    want = RK.StreamingWeightedSum(rl, backend="numpy")
    want.add_sparse(RF.SparseDelta(rl, "coo", idx, q, sc, base=rbase), 2.0)
    got = TK.StreamingWeightedSum(tl, backend="torch", device="cpu")
    got.add_sparse(TF.SparseDelta(tl, "coo", idx, q, sc, base=tbase), 2.0)
    assert_bitwise(got.finalize(), want.finalize())


def _with_specials(rl, ref, tl, port, seed, nan=True):
    """The round with signed zeros (and NaNs) in its raw fp32 clients (the
    same values in the reference's and the port's payloads)."""
    rng = np.random.default_rng(seed)
    ref, port = list(ref), list(port)
    for i, fp in enumerate(ref):
        if type(fp).__name__ != "FlatParams":
            continue
        vec = fp.math_view().copy()
        n = vec.size
        vec[:16] = rng.choice([-0.0, 0.0], 16)
        vec[16:32] = rng.choice([-0.0, 0.0, 1.0, -1.0], 16)
        if nan:
            vec[rng.integers(32, n, 3)] = np.nan
        ref[i] = RF.FlatParams.from_arrays(RF.unflatten_vector(vec, rl), rl)
        port[i] = TF.FlatParams.from_arrays(TF.unflatten_vector(vec, tl), tl)
    return ref, port


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("what", ["median", "trimmed_mean"])
def test_robust_reductions_fold_a_mixed_run_stack_bitwise(what, specials):
    """A round that mixes codecs, dtypes and bases reaches sort_reduce as
    one fp64 stack decoded run by run (decode_rows): bitwise the numpy
    engine, signed zeros and NaNs included, with no host reduction."""
    rl, ref, tl, port = _mixed_round()
    if specials:
        ref, port = _with_specials(rl, ref, tl, port, 5)
    fn, rfn, args = {"median": (TK.median, RK.median, ()),
                     "trimmed_mean": (TK.trimmed_mean, RK.trimmed_mean,
                                      (2,))}[what]
    before = dict(A.LAUNCHES)
    got = fn(port, tl, *args, backend="torch", device="cpu")
    assert A.LAUNCHES == before             # the twins ran: no kernel
    want = rfn(ref, rl, *args, backend="numpy")
    assert got.buf.tobytes() == want.buf.tobytes()


@pytest.mark.parametrize("specials", [False, True])
def test_krum_folds_a_mixed_run_stack(specials):
    """Krum over the mixed round: distances within 1e-9 of the numpy
    engine, the same selection and the same bitwise mean of the chosen."""
    rl, ref, tl, port = _mixed_round()
    if specials:   # signed zeros only: a NaN makes its distances NaN
        ref, port = _with_specials(rl, ref, tl, port, 6, nan=False)
    d_port = TK.krum_distances(port, tl, backend="torch", device="cpu")
    d_ref = RK.krum_distances(ref, rl, backend="numpy")
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-9, atol=1e-9)
    chosen = np.argsort(TK.krum_scores(d_port, 1))[:2]
    assert chosen.tolist() == np.argsort(RK.krum_scores(d_ref, 1))[:2].tolist()
    sel = [(port[i], 4.0 + i) for i in chosen]
    assert_bitwise(TK.weighted_mean(sel, tl, backend="torch", device="cpu"),
                   RK.weighted_mean([(ref[i], 4.0 + i) for i in chosen], rl,
                                    backend="numpy"))


def test_mixed_round_stack_is_decoded_run_by_run():
    """The robust stack of a mixed round is one fp64 (C, N) tensor whose
    rows are each client's decode; a uniform round keeps its payloads."""
    rl, ref, tl, port = _mixed_round()
    s = TK._robust_stack(port, "cpu")
    assert s["data"].dtype == torch.float64 and s["scales"] is None \
        and s["base"] is None
    n = tl.total_size
    for i, fp in enumerate(port):
        want = fp.f64_chunk(0, n, np.empty(n, np.float64))
        assert s["data"][i].numpy().tobytes() == want.tobytes()
    flat = make_payloads("odd_f32", "flat", 3, seed=33)[3]
    assert TK._robust_stack(flat, "cpu")["data"].dtype == torch.float32
