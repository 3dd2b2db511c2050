"""The port's sharded fold on the torch backend against the reference.

``StreamingWeightedSum(shards=N | mesh=...)`` on ``backend="torch"`` keeps
one fp64 accumulator per shard range on a device and folds every arrival
through ``weighted_sum`` on ``tile_source(lo, hi)`` (here on the CPU, the
kernel's plain twin).  It is held bitwise against the reference's numpy
engine (``repro.fl.agg_kernels``, backend "numpy") at the same shard count
and at one shard, across 1, 2, 3 and 8 shards, for flat, bf16, q8, q8
deltas (raw and quantized bases), bf16 deltas, partial sums (0xF4), mixed
arrivals, and empty and tiny layouts; through ``ServerConfig(agg_shards=)``
end to end; and with FedAvgM / FedAdam / FedYogi's sharded server state
over three rounds.  ``make_agg_mesh`` places each shard's accumulator on
its mesh device (two CPU devices stand in for cards here).

The fp32 tiles (``tile_dtype="float32"``) are held against the reference's
Pallas ``weighted_sum(tile_dtype="float32")`` in interpret mode, through
the test-local ``enable_x64`` shim of ``tests/test_torch_robust.py``
(JAX 0.9 removed ``jax.experimental.enable_x64``): bitwise, as the twin
rounds exactly where the reference kernel does, and within the
reference's rtol 1e-4 / atol 1e-5 of the fp64 tiles.
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
from repro_torch.kernels import agg_reduce
from repro_torch.launch.mesh import make_agg_mesh
from test_torch_agg import assert_bitwise, to_port

#: 9000 elements: 8 shards of 1024-aligned ranges leave three empty
WIDE = [("float32", (3000,)), ("float32", (40, 150))]
TORCH = {"backend": "torch", "device": "cpu"}
SHARDS = (1, 2, 3, 8)
CODECS = ("flat", "bf16", "q8", "q8_delta_flat", "q8_delta_quant",
          "bf16_delta")


def payloads(sig, codec, n_clients, seed):
    """Reference payloads of ``codec`` over ``sig`` and the port's twins
    over the same bytes (delta payloads share one base per package)."""
    rl = RF.layout_for(sig)
    rng = np.random.default_rng(seed)
    ref = []
    base_fp = RF.FlatParams.from_arrays(
        [np.asarray(rng.normal(0, 0.5, s.shape), np.float32)
         for s in rl.leaves], rl)
    base = base_fp
    if codec == "q8_delta_quant":
        base = RF.QuantParams(rl, "q8", *RF.quantize_int8(
            base_fp.math_view()))
    for i in range(n_clients):
        vec = rng.normal(0, 1 + 0.25 * i, rl.total_size).astype(np.float32)
        if codec == "flat":
            ref.append(RF.FlatParams.from_arrays(
                RF.unflatten_vector(vec, rl), rl))
        elif codec in ("bf16", "bf16_delta"):
            d = codec == "bf16_delta"
            ref.append(RF.QuantParams(rl, "bf16",
                                      vec.astype(RF.np_dtype("bfloat16")),
                                      is_delta=d, base=base if d else None))
        elif codec == "q8":
            ref.append(RF.QuantParams(rl, "q8", *RF.quantize_int8(vec)))
        else:
            q, s = RF.quantize_int8(vec * 1e-3)
            ref.append(RF.QuantParams(rl, "q8", q, s, is_delta=True,
                                      base=base))
    return rl, ref, TF.layout_for(sig), to_port(ref)


def _fold(K, layout, items, **kw):
    """Fold ``(payload, weight)`` items, partial sums as ``add_partial``."""
    s = K.StreamingWeightedSum(layout, **kw)
    for p, w in items:
        if isinstance(p, (RF.PartialSum, TF.PartialSum)):
            s.add_partial(p, w)
        else:
            s.add(p, w)
    return s


def _weights(n):
    return [3.0 + 1.5 * i for i in range(n)]


@pytest.mark.parametrize("codec", CODECS)
def test_sharded_fold_bitwise_the_numpy_engine_across_shard_counts(codec):
    rl, ref, tl, port = payloads(WIDE, codec, 5, seed=21)
    w = _weights(5)
    want = _fold(RK, rl, zip(ref, w), backend="numpy", shards=1,
                 overlap=False).finalize()
    for shards in SHARDS:
        ref_s = _fold(RK, rl, zip(ref, w), backend="numpy", shards=shards,
                      overlap=False).finalize()
        assert_bitwise(ref_s, want)
        s = _fold(TK, tl, zip(port, w), shards=shards, **TORCH)
        assert s.per_shard_acc_bytes() == RK.StreamingWeightedSum(
            rl, backend="numpy", shards=shards,
            overlap=False).per_shard_acc_bytes()
        assert_bitwise(s.finalize(), want)


@pytest.mark.parametrize("codec", ["flat", "bf16", "q8"])
def test_sharded_fold_equals_the_single_host_fold_for_non_deltas(codec):
    rl, ref, tl, port = payloads(WIDE, codec, 4, seed=22)
    w = _weights(4)
    want = _fold(RK, rl, zip(ref, w), backend="numpy").finalize()
    got = _fold(TK, tl, zip(port, w), shards=8, **TORCH).finalize()
    assert_bitwise(got, want)


def test_mixed_arrivals_and_partials_fold_on_one_chain():
    """q8, raw, q8-delta and bf16 arrivals interleaved with two 0xF4
    partial sums (one discounted): bitwise the reference's sharded numpy
    fold at 1, 3 and 8 shards."""
    rl, q8r, tl, q8t = payloads(WIDE, "q8", 2, seed=23)
    _, flr, _, flt = payloads(WIDE, "flat", 2, seed=24)
    _, dr, _, dt = payloads(WIDE, "q8_delta_quant", 2, seed=25)
    _, br, _, bt = payloads(WIDE, "bf16", 1, seed=26)
    rng = np.random.default_rng(27)
    sums = [rng.normal(0, 5, rl.total_size) for _ in range(2)]
    ps_r = [RF.PartialSum(rl, v, 7.0 + i, 3) for i, v in enumerate(sums)]
    ps_t = [TF.PartialSum(tl, v.copy(), 7.0 + i, 3)
            for i, v in enumerate(sums)]
    order_r = [(q8r[0], 2.0), (flr[0], 3.0), (ps_r[0], 1.0), (dr[0], 4.0),
               (br[0], 1.5), (q8r[1], 2.5), (ps_r[1], 0.5), (dr[1], 5.0),
               (flr[1], 6.0)]
    order_t = [(q8t[0], 2.0), (flt[0], 3.0), (ps_t[0], 1.0), (dt[0], 4.0),
               (bt[0], 1.5), (q8t[1], 2.5), (ps_t[1], 0.5), (dt[1], 5.0),
               (flt[1], 6.0)]
    for shards in (1, 3, 8):
        want = _fold(RK, rl, order_r, backend="numpy", shards=shards,
                     overlap=False)
        got = _fold(TK, tl, order_t, shards=shards, **TORCH)
        assert (got.total_w, got.count) == (want.total_w, want.count)
        assert_bitwise(got.finalize(), want.finalize())


def test_straggler_subset_round_is_shard_count_invariant():
    rl, ref, tl, port = payloads(WIDE, "q8_delta_quant", 6, seed=28)
    w = _weights(6)
    arrived = [0, 1, 4, 5]                   # clients 2 and 3 timed out
    want = _fold(RK, rl, [(ref[i], w[i]) for i in arrived],
                 backend="numpy", shards=1, overlap=False).finalize()
    got = _fold(TK, tl, [(port[i], w[i]) for i in arrived], shards=8,
                **TORCH).finalize()
    assert_bitwise(got, want)


def test_empty_and_tiny_layouts():
    empty_t = TF.layout_for([])
    s = TK.StreamingWeightedSum(empty_t, shards=4, **TORCH)
    s.add(TF.FlatParams.zeros(empty_t), 1.0)
    assert s.finalize().layout.total_size == 0
    sig = [("float32", (3,))]
    rl, tl = RF.layout_for(sig), TF.layout_for(sig)
    vec = np.array([1.0, -2.0, 3.5], np.float32)
    want = _fold(RK, rl, [(RF.FlatParams.from_arrays([vec], rl), 2.0)],
                 backend="numpy", shards=8, overlap=False).finalize()
    for shards in (1, 8):
        got = _fold(TK, tl, [(TF.FlatParams.from_arrays([vec], tl), 2.0)],
                    shards=shards, **TORCH).finalize()
        assert_bitwise(got, want)


@pytest.mark.parametrize("sig", [[("float16", (21, 4))],
                                 [("bfloat16", (1100,))],
                                 [("float64", (5,)), ("float32", (3, 3)),
                                  ("float16", (2000,))]],
                         ids=["f16", "bf16", "mixed"])
def test_finalize_casts_other_layouts_like_the_reference(sig):
    rl, ref, tl, port = payloads(sig, "flat", 3, seed=29)
    w = _weights(3)
    want = _fold(RK, rl, zip(ref, w), backend="numpy", shards=2,
                 overlap=False).finalize()
    got = _fold(TK, tl, zip(port, w), shards=2, **TORCH).finalize()
    assert_bitwise(got, want)


def test_a_failed_arrival_folds_nothing():
    """A payload that cannot fold raises before any shard took it: a delta
    without its base, and uint64 shares."""
    rl, ref, tl, port = payloads(WIDE, "q8_delta_quant", 2, seed=30)
    s = _fold(TK, tl, [(port[0], 1.0)], shards=3, **TORCH)
    orphan = TF.QuantParams(tl, "q8", port[1].data, port[1].scales,
                            is_delta=True, base=None)
    with pytest.raises(ValueError, match="base"):
        s.add(orphan, 1.0)
    u64 = TF.FlatParams.from_arrays(
        [np.arange(3000, dtype=np.uint64),
         np.ones((40, 150), np.uint64)],
        TF.layout_for([("uint64", (3000,)), ("uint64", (40, 150))]))
    with pytest.raises(NotImplementedError, match="SecAgg"):
        TK.StreamingWeightedSum(u64.layout, shards=2, **TORCH).add(u64, 1.0)
    assert s.count == 1 and len(s._deferred) == 1
    want = _fold(RK, rl, [(ref[0], 1.0)], backend="numpy", shards=3,
                 overlap=False).finalize()
    assert_bitwise(s.finalize(), want)
    with pytest.raises(RuntimeError, match="ended"):
        s.add(port[0], 1.0)


# ---------------------------------------------------------------------------
# the mesh and the ServerConfig
# ---------------------------------------------------------------------------
def test_make_agg_mesh_places_each_shard_on_its_device():
    mesh = make_agg_mesh(2, devices=["cpu", "cpu"])
    assert mesh.axis_names == ("data",)
    assert mesh.devices.shape == (2,) and mesh.devices.size == 2
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert TK.resolve_shards(None, mesh) == 2
    rl, ref, tl, port = payloads(WIDE, "q8", 3, seed=31)
    w = _weights(3)
    s = _fold(TK, tl, zip(port, w), backend="torch", mesh=mesh)
    assert s.shards == 2 and s.device == torch.device("cpu")
    assert [a.device for a in s._dsacc] == list(mesh.devices.flat)
    s4 = _fold(TK, tl, zip(port, w), backend="torch", mesh=mesh, shards=4)
    assert s4.shards == 4 and len(s4._sdev) == 4
    want = _fold(RK, rl, zip(ref, w), backend="numpy", shards=2,
                 overlap=False).finalize()
    assert_bitwise(s.finalize(), want)
    assert_bitwise(s4.finalize(), want)


def test_make_agg_mesh_refuses_more_shards_than_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_agg_mesh(2)
    with pytest.raises(ValueError):
        make_agg_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError):
        make_agg_mesh(0)


def test_server_config_threads_shards_mesh_and_device():
    from repro_torch.fl import (FedAdam, FedAvg, FedAvgM, FedYogi,
                                SecAggFedAvg, ServerApp, ServerConfig)

    mesh = make_agg_mesh(2, devices=["cpu", "cpu"])
    for cls in (FedAvg, FedAvgM, FedAdam, FedYogi, SecAggFedAvg):
        st = cls()
        ServerApp(ServerConfig(num_rounds=1, agg_shards=3,
                               agg_device="cpu", agg_backend="torch"), st)
        assert (st.shards, st.device, st.backend) == (3, "cpu", "torch")
        st = cls()
        ServerApp(ServerConfig(num_rounds=1, shard_mesh=mesh), st)
        assert st.shard_mesh is mesh and st._num_shards() == 2


def test_fedbuff_folds_on_the_strategys_shards():
    from repro_torch.fl import FedAvg
    from repro_torch.fl.fedbuff import FedBuffBuffer

    st = FedAvg(shards=3, device="cpu", backend="torch")
    buf = FedBuffBuffer(st, buffer_k=2)
    acc = buf._make_acc(TF.layout_for(WIDE))
    assert acc.shards == 3 and acc.backend == "torch" and \
        len(acc._dsacc) == 3


def test_quickstart_with_agg_shards_end_to_end():
    """``ServerConfig(agg_shards=3)`` on the torch backend: the sharded
    fold equals the single-host fold on arrival (``low_memory``; flat
    payloads, so the deferred-base regrouping does not apply) and the numpy
    engine's sharded fold bitwise, natively."""
    from repro_torch.core import run_native
    from repro_torch.fl import FedAvg, ServerApp, ServerConfig
    from repro_torch.fl.quickstart import make_client_app

    sites = ["site-1", "site-2", "site-3"]

    def run(low_memory=False, **cfg):
        app = ServerApp(ServerConfig(num_rounds=2, round_timeout=60,
                                     agg_device="cpu", **cfg),
                        FedAvg(low_memory=low_memory))
        return run_native(app, lambda s: make_client_app(s, device="cpu"),
                          sites)

    sharded = run(agg_shards=3, agg_backend="torch")
    single = run(low_memory=True, agg_backend="torch")
    numpy_sharded = run(agg_shards=3, agg_backend="numpy")
    for h in (single, numpy_sharded):
        assert sharded.losses() == h.losses()
        for a, b in zip(sharded.final_parameters, h.final_parameters):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["fedavgm", "fedadam", "fedyogi"])
def test_sharded_fedopt_state_matches_the_reference_over_rounds(name):
    """FedOpt server state (velocity / m / v) per shard, folding on the
    torch backend: bitwise the reference's sharded numpy strategy, every
    round."""
    from repro.fl.messages import FitRes as RFitRes
    from repro.fl.strategy import make_strategy as ref_make
    from repro_torch.fl.messages import FitRes
    from repro_torch.fl.strategy import make_strategy

    rng = np.random.default_rng(32)
    shapes = [(64, 8), (1031,), (3,)]
    port = make_strategy(name, shards=4, backend="torch", device="cpu")
    ref = ref_make(name, shards=4, backend="numpy", overlap_decode=False)
    cur_p = cur_r = [np.zeros(s, np.float32) for s in shapes]
    for rnd in (1, 2, 3):
        arrays = [[rng.normal(0, 1 + c, s).astype(np.float32)
                   for s in shapes] for c in range(5)]
        got, _ = port.aggregate_fit(
            rnd, [(f"site-{c}", FitRes(a, 10 + c, {}))
                  for c, a in enumerate(arrays)], [], cur_p)
        want, _ = ref.aggregate_fit(
            rnd, [(f"site-{c}", RFitRes(a, 10 + c, {}))
                  for c, a in enumerate(arrays)], [], cur_r)
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes(), name
        cur_p, cur_r = got, want


# ---------------------------------------------------------------------------
# fp32 tiles against the reference Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
@pytest.fixture
def pallas_x64(monkeypatch):
    """Give the reference kernels back the ``enable_x64`` context manager
    that JAX 0.9.0 removed, for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


@pytest.mark.parametrize("kind", ["int8", "float32", "bfloat16",
                                  "float64"])
@pytest.mark.parametrize("with_acc", [False, True])
def test_f32_tile_twin_equals_the_reference_pallas_kernel(pallas_x64, kind,
                                                          with_acc):
    from repro.kernels import agg_reduce as RA

    rng = np.random.default_rng(33)
    c, n, qchunk = 3, 2 * 1024 + 77, 1024
    scales = None
    if kind == "int8":
        data = rng.integers(-127, 128, (c, n), dtype=np.int8)
        scales = rng.uniform(1e-4, 1e-1, (c, -(-n // qchunk))) \
            .astype(np.float32)
        t_data = torch.from_numpy(data)
    else:
        x = rng.normal(0, 2, (c, n))
        t_data = torch.from_numpy(x).to(getattr(torch, kind))
        data = (t_data.view(torch.int16).numpy().view(
            RF.np_dtype("bfloat16")) if kind == "bfloat16"
            else t_data.numpy())
    w = rng.uniform(0.1, 2.0, c)
    acc = rng.normal(0, 1, n) if with_acc else None
    want = RA.weighted_sum(data, w, scales=scales, qchunk=qchunk, acc=acc,
                           tile_dtype="float32")
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = agg_reduce.weighted_sum(t_data, torch.from_numpy(w),
                                  scales=t(scales), qchunk=qchunk,
                                  acc=t(acc), tile_dtype="float32")
    np.testing.assert_array_equal(got.numpy(), want)
    f64 = agg_reduce.weighted_sum(t_data, torch.from_numpy(w),
                                  scales=t(scales), qchunk=qchunk,
                                  acc=t(acc))
    np.testing.assert_allclose(got.numpy(), f64.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_sharded_f32_tiles_equal_the_reference_pallas_fold(pallas_x64):
    """The sharded fold with fp32 tiles: bitwise the reference's Pallas
    sharded fold with fp32 tiles (interpret mode), and within rtol 1e-4 /
    atol 1e-5 of the fp64 fold, as ``tests/test_agg_pallas.py:537-546``
    holds the reference."""
    rl, ref, tl, port = payloads(WIDE, "q8", 5, seed=34)
    w = _weights(5)
    want = _fold(RK, rl, zip(ref, w), backend="pallas", shards=2,
                 overlap=False, tile_dtype="float32").finalize()
    s = _fold(TK, tl, zip(port, w), shards=2, tile_dtype="float32",
              **TORCH)
    assert s.tile_dtype == "float32"
    got = s.finalize()
    assert_bitwise(got, want)
    oracle = _fold(TK, tl, zip(port, w), shards=2, **TORCH).finalize()
    for g, o in zip(got.to_arrays(), oracle.to_arrays()):
        np.testing.assert_allclose(g, o, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="tile_dtype"):
        TK.StreamingWeightedSum(tl, shards=2, tile_dtype="bfloat16", **TORCH)
