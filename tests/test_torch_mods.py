"""The port's client mods and SecAgg server against the reference.

``repro_torch.fl.mods`` keeps the reference's numpy arithmetic for the
client side, so a fit through ``DPMod``, ``SecAggMod`` or
``TopKCompressionMod`` gives the reference's wire bytes exactly (masked
SecAgg shares byte-identical, so a mixed fleet's masks cancel; DP noise
and clipping bitwise; the TopK kept set identical).  ``SecAggFedAvg`` on
the torch backend keeps the mod-2^64 sum on the strategy's device as int64
adds (here the CPU): bitwise the numpy uint64 sum on shares that wrap.
The SecAgg quickstart round matches the reference's within the
quickstart's tolerances (parameters 1e-6 absolute, losses 1e-5 relative)
and plain FedAvg within 1e-3, natively and in FLARE (bitwise equal).
These are the cases of ``tests/test_mods.py``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import zlib

import jax
import numpy as np
import pytest

import repro.fl.client as RC
import repro.fl.messages as RM
import repro.fl.mods as RMods
import repro_torch.fl.client as TC
import repro_torch.fl.messages as TM
import repro_torch.fl.mods as TMods

SITES = ["site-1", "site-2", "site-3"]


def seed_fn(a, b):
    lo, hi = sorted([a, b])
    return zlib.crc32(f"{lo}|{hi}".encode())


def _step_client(C, delta):
    class _StepClient(C.NumPyClient):
        """fit() moves params by a fixed delta — makes mod effects exact."""

        def fit(self, parameters, config):
            return ([np.asarray(p, np.float64) + np.asarray(delta)
                     for p in parameters], 10, {})

        def evaluate(self, parameters, config):
            return 0.0, 1, {}

    return _StepClient()


def _fit_bytes(C, M, mods, delta, params, rnd=1):
    app = C.ClientApp(lambda cid: _step_client(C, delta).to_client(),
                      mods=mods)
    ins = M.FitIns([np.asarray(p, np.float64) for p in params], {})
    t = M.TaskIns("fit", rnd, M.encode_fit_ins(ins), task_id="t")
    return app.handle(M.encode_task_ins(t))


def _both(make_mods, delta, params, rnd=1):
    """The encoded TaskRes of the same fit through the reference's and the
    port's ClientApp with the same mods."""
    return (_fit_bytes(RC, RM, make_mods(RMods), delta, params, rnd),
            _fit_bytes(TC, TM, make_mods(TMods), delta, params, rnd))


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("rnd", [1, 4])
def test_secagg_masked_share_frames_are_byte_identical(site, rnd):
    rng = np.random.default_rng(rnd)
    params = [rng.normal(0, 1, (17, 5)), rng.normal(0, 1, (33,))]
    delta = 0.01
    ref, port = _both(lambda M: [M.SecAggMod(site=site, peers=SITES,
                                             pairwise_seed_fn=seed_fn)],
                      delta, params, rnd)
    assert ref == port
    share = TM.decode_fit_res(TM.decode_task_res(port).payload)
    assert share.parameters[0].dtype == np.uint64


@pytest.mark.parametrize("noise", [0.0, 0.5])
@pytest.mark.parametrize("delta", [[3.0, 4.0], [0.01, -0.02]])
def test_dp_is_bitwise_the_reference(noise, delta):
    ref, port = _both(lambda M: [M.DPMod(clip_norm=0.5, noise_multiplier=noise,
                                         site_id=2, seed=9)],
                      delta, [[0.25, -1.0]])
    assert ref == port
    res = TM.decode_fit_res(TM.decode_task_res(port).payload)
    if noise == 0.0:
        assert np.linalg.norm(res.parameters[0] - np.array([0.25, -1.0])) \
            <= 0.5 + 1e-6


def test_topk_keeps_the_reference_set_and_composes_with_dp():
    rng = np.random.default_rng(5)
    params = [np.zeros((40, 25))]
    delta = np.round(rng.normal(0, 1, (40, 25)), 1)   # many ties
    ref, port = _both(lambda M: [M.TopKCompressionMod(fraction=0.1)],
                      delta, params)
    assert ref == port
    res = TM.decode_fit_res(TM.decode_task_res(port).payload)
    assert res.metrics["topk_kept_frac"] == pytest.approx(0.1)
    assert np.count_nonzero(res.parameters[0]) == 100
    ref, port = _both(lambda M: [M.DPMod(clip_norm=0.5),
                                 M.TopKCompressionMod(fraction=0.5)],
                      [3.0, 4.0], [[0.0, 0.0]])
    assert ref == port


def _shares(n_sites, n, seed):
    """uint64 shares whose sum wraps mod 2^64 many times, as FitRes."""
    rng = np.random.default_rng(seed)
    sh = [rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True)
          for _ in range(n_sites)]
    from repro_torch.fl.flat import FlatParams, layout_for

    lay = layout_for([("uint64", (n,))])
    out = []
    for i, s in enumerate(sh):
        fp = FlatParams(s.view(np.uint8).copy(), lay)
        res = TM.FitRes(fp.to_arrays(), 10 + i, {})
        res.flat = fp
        out.append((f"site-{i}", res))
    return sh, out


def test_device_wrapping_sum_is_bitwise_the_numpy_uint64_sum():
    sh, results = _shares(5, 4097, seed=11)
    want = np.zeros(4097, np.uint64)
    for s in sh:
        want += s
    acc = TMods._SecAggFitAcc(TMods.SecAggFedAvg(backend="torch",
                                                 device="cpu"), 1, [])
    for node, r in results:
        acc.add(node, r)
    got = acc._acc.numpy().view(np.uint64)
    assert got.tobytes() == want.tobytes()
    assert acc._acc.device.type == "cpu"
    params, m = acc.finalize([])
    ref = TMods._SecAggFitAcc(TMods.SecAggFedAvg(backend="numpy"), 1, [])
    for node, r in results:
        ref.add(node, r)
    want_p, want_m = ref.finalize([])
    assert m == want_m == {"num_clients": 5, "secagg": 1}
    for a, b in zip(params, want_p):
        assert a.tobytes() == b.tobytes()


def test_secagg_torch_sum_refuses_a_float_share_and_missing_shares():
    from repro_torch.fl.flat import FlatParams

    acc = TMods._SecAggFitAcc(TMods.SecAggFedAvg(backend="torch",
                                                 device="cpu"), 1, [])
    fp = FlatParams.from_arrays([np.ones(4, np.float32)])
    res = TM.FitRes(fp.to_arrays(), 1, {})
    res.flat = fp
    with pytest.raises(TypeError, match="uint64"):
        acc.add("site-1", res)
    _, results = _shares(2, 8, seed=12)
    acc = TMods._SecAggFitAcc(TMods.SecAggFedAvg(backend="torch",
                                                 device="cpu"), 1, [])
    acc.add(*results[0])
    with pytest.raises(RuntimeError, match="every masked share"):
        acc.finalize([("site-1", "timeout")])


# ---------------------------------------------------------------------------
# the SecAgg quickstart round
# ---------------------------------------------------------------------------
def _port_history(mods_for, strategy, flare=False, rounds=2, init=None):
    from repro_torch.core import run_in_flare, run_native
    from repro_torch.fl import ServerApp, ServerConfig
    from repro_torch.fl.quickstart import make_client_app
    from repro_torch.runtime import FlareRuntime

    strategy.initial_parameters = init
    app = ServerApp(ServerConfig(num_rounds=rounds, round_timeout=60,
                                 agg_backend="torch", agg_device="cpu"),
                    strategy)
    clients = lambda s: make_client_app(s, mods=mods_for(s),  # noqa: E731
                                        device="cpu")
    if not flare:
        return run_native(app, clients, SITES)
    rt = FlareRuntime()
    for s in SITES:
        rt.provision_site(s)
    try:
        return run_in_flare(rt, app, clients, SITES)
    finally:
        rt.shutdown()


def _secagg_mods(M):
    return lambda s: [M.SecAggMod(site=s, peers=SITES,
                                  pairwise_seed_fn=seed_fn)]


def test_secagg_round_matches_the_reference_and_plain_fedavg():
    from repro.core import run_native as ref_run_native
    from repro.fl import ServerApp as RApp
    from repro.fl import ServerConfig as RCfg
    from repro.fl import quickstart as RQ
    from repro_torch.fl import FedAvg

    init = RQ.init_mlp(jax.random.key(0), 32, 64, 10)
    mods = _secagg_mods(RMods)
    h_ref = ref_run_native(
        RApp(RCfg(num_rounds=2, round_timeout=60, agg_backend="numpy"),
             RMods.SecAggFedAvg(initial_parameters=init)),
        lambda s: RQ.make_client_app(s, mods=mods(s)), SITES)
    sec = _port_history(_secagg_mods(TMods), TMods.SecAggFedAvg(),
                        init=init)
    plain = _port_history(lambda s: None, FedAvg(), init=init)
    np.testing.assert_allclose([l for _, l in sec.losses()],
                               [l for _, l in h_ref.losses()], rtol=1e-5)
    for a, b, c in zip(sec.final_parameters, h_ref.final_parameters,
                       plain.final_parameters):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        assert np.abs(a.astype(np.float64) - c.astype(np.float64)).max() \
            < 1e-3
    assert [r.metrics.get("secagg") for r in sec.rounds] == [1, 1]


def test_secagg_native_equals_flare_and_composed_mods_run():
    native = _port_history(_secagg_mods(TMods), TMods.SecAggFedAvg())
    flare = _port_history(_secagg_mods(TMods), TMods.SecAggFedAvg(),
                          flare=True)
    assert native.losses() == flare.losses()
    for a, b in zip(native.final_parameters, flare.final_parameters):
        assert a.tobytes() == b.tobytes()
    from repro_torch.fl import FedAvg

    composed = _port_history(
        lambda s: [TMods.DPMod(clip_norm=5.0, noise_multiplier=0.0,
                               site_id=SITES.index(s)),
                   TMods.TopKCompressionMod(fraction=0.5)],
        FedAvg(), rounds=1)
    assert all(np.isfinite(p).all() for p in composed.final_parameters)
