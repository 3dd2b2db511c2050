"""Slice 2 end to end: the quickstart with the robust strategies.

Five sites run the quickstart with FedMedian, FedTrimmedMean (beta 0.2, so
k = 1 of 5) and Krum (f = 1, two selected; its quorum 2f + 3 is 5), the
server reducing on the port's ``torch`` backend -- here the plain twins of
``sort_reduce`` and ``gram`` on the CPU.  Inside the port, native equals
FLARE bitwise, clean and under transport faults, and the torch backend
equals the numpy one bitwise.  Across frameworks, from the reference's
initial parameters, the round losses match the reference's ``run_native``
with the same strategy within ``LOSS_RTOL`` and the parameters within
``atol=1e-6`` (the fp32 tolerance of ``tests/test_torch_quickstart.py``),
and Krum selects the same sites every round.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import numpy as np
import pytest

import repro.fl as RFL
from repro.core import run_native as ref_run_native
from repro.fl import quickstart as RQ
from repro_torch.core import run_in_flare, run_native
from repro_torch.fl import (FedMedian, FedTrimmedMean, Krum, ServerApp,
                            ServerConfig)
from repro_torch.fl.quickstart import make_client_app
from repro_torch.runtime import FlareRuntime
from repro_torch.runtime.transport import FaultSpec

SITES = [f"site-{i}" for i in range(1, 6)]
LOSS_RTOL = 1e-5
#: name -> (port class, reference class, keyword arguments)
STRATEGIES = {
    "fedmedian": (FedMedian, RFL.FedMedian, {}),
    "fedtrimmedmean": (FedTrimmedMean, RFL.FedTrimmedMean, {"beta": 0.2}),
    "krum": (Krum, RFL.Krum, {"num_byzantine": 1, "num_selected": 2}),
}


def _server_app(name, rounds=2, codec=None, backend=None, init=None):
    cls, _, kw = STRATEGIES[name]
    return ServerApp(
        config=ServerConfig(num_rounds=rounds, round_timeout=60, codec=codec,
                            agg_backend=backend, agg_device="cpu"),
        strategy=cls(initial_parameters=init, **kw))


def _clients(site):
    return make_client_app(site, device="cpu")


def _flare(app, faults=None):
    rt = FlareRuntime(faults=faults)
    for s in SITES:
        rt.provision_site(s)
    try:
        hist = run_in_flare(rt, app, _clients, SITES)
        return hist, rt.network.stats
    finally:
        rt.shutdown()


def _assert_same_history(a, b):
    assert a.losses() == b.losses()
    assert [r.metrics for r in a.rounds] == [r.metrics for r in b.rounds]
    for x, y in zip(a.final_parameters, b.final_parameters):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("codec", [None, "q8"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_native_equals_flare_bitwise(name, codec):
    h_native = run_native(_server_app(name, codec=codec), _clients, SITES)
    h_flare, _ = _flare(_server_app(name, codec=codec))
    _assert_same_history(h_native, h_flare)
    losses = [l for _, l in h_native.losses()]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_native_equals_flare_under_faults(name):
    h_native = run_native(_server_app(name, codec="q8"), _clients, SITES)
    h_faulty, stats = _flare(
        _server_app(name, codec="q8"),
        FaultSpec(drop_prob=0.15, dup_prob=0.1, max_delay_s=0.01, seed=42))
    assert stats["dropped"] > 0, "fault injection did not fire"
    _assert_same_history(h_native, h_faulty)


@pytest.mark.parametrize("codec", [None, "bf16", "q8"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_torch_backend_equals_numpy_backend_bitwise(name, codec):
    h_torch = run_native(_server_app(name, codec=codec, backend="torch"),
                         _clients, SITES)
    h_numpy = run_native(_server_app(name, codec=codec, backend="numpy"),
                         _clients, SITES)
    _assert_same_history(h_torch, h_numpy)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_round_losses_match_the_reference(name):
    _, ref_cls, kw = STRATEGIES[name]
    init = RQ.init_mlp(jax.random.key(0), 32, 64, 10)
    h_ref = ref_run_native(
        RFL.ServerApp(RFL.ServerConfig(num_rounds=3, round_timeout=60,
                                       agg_backend="numpy"),
                      ref_cls(initial_parameters=init, **kw)),
        lambda s: RQ.make_client_app(s), SITES)
    h_port = run_native(_server_app(name, rounds=3, init=init), _clients,
                        SITES)
    ref_l = [l for _, l in h_ref.losses()]
    port_l = [l for _, l in h_port.losses()]
    assert len(ref_l) == len(port_l) == 3
    np.testing.assert_allclose(port_l, ref_l, rtol=LOSS_RTOL)
    for a, b in zip(h_port.final_parameters, h_ref.final_parameters):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    if name == "krum":
        assert [r.metrics["krum_selected"] for r in h_port.rounds] == \
            [r.metrics["krum_selected"] for r in h_ref.rounds]
