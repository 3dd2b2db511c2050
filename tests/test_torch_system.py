"""The slice end to end: ports of ``tests/test_system.py:39`` and ``:48``.

Inside the port, the quickstart FedAvg run natively equals the same run as
a FLARE job bitwise, clean and under transport faults, for the flat and
q8 codecs and for the deferred and the low-memory (fold-on-arrival)
aggregation; the "torch" aggregation backend (its plain twin, here on the
CPU) equals the "numpy" one bitwise.  Across frameworks, from the
reference's initial parameters, the port's round losses match the
reference's within the fp32 tolerance stated in
``tests/test_torch_quickstart.py``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import numpy as np
import pytest

from repro.core import run_native as ref_run_native
from repro.fl import FedAvg as RefFedAvg
from repro.fl import ServerApp as RefServerApp
from repro.fl import ServerConfig as RefServerConfig
from repro.fl import quickstart as RQ
from repro_torch.core import run_in_flare, run_native
from repro_torch.fl import FedAvg, ServerApp, ServerConfig
from repro_torch.fl.quickstart import make_client_app
from repro_torch.runtime import FlareRuntime
from repro_torch.runtime.transport import FaultSpec

SITES = ["site-1", "site-2", "site-3"]
LOSS_RTOL = 1e-5


def _server_app(rounds=2, codec=None, low_memory=False, backend=None,
                init=None):
    return ServerApp(
        config=ServerConfig(num_rounds=rounds, round_timeout=60, codec=codec,
                            agg_backend=backend, agg_device="cpu"),
        strategy=FedAvg(low_memory=low_memory, initial_parameters=init))


def _clients(site):
    return make_client_app(site, device="cpu")


def _runtime(faults=None):
    rt = FlareRuntime(faults=faults)
    for s in SITES:
        rt.provision_site(s)
    return rt


def _assert_same_history(a, b):
    assert a.losses() == b.losses()
    for x, y in zip(a.final_parameters, b.final_parameters):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("codec", [None, "q8"])
@pytest.mark.parametrize("low_memory", [False, True])
def test_native_equals_flare_bitwise(codec, low_memory):
    h_native = run_native(_server_app(codec=codec, low_memory=low_memory),
                          _clients, SITES)
    rt = _runtime()
    try:
        h_flare = run_in_flare(rt, _server_app(codec=codec,
                                               low_memory=low_memory),
                               _clients, SITES)
    finally:
        rt.shutdown()
    _assert_same_history(h_native, h_flare)
    losses = [l for _, l in h_native.losses()]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("codec", [None, "q8"])
@pytest.mark.parametrize("low_memory", [False, True])
def test_native_equals_flare_under_faults(codec, low_memory):
    h_native = run_native(_server_app(codec=codec, low_memory=low_memory),
                          _clients, SITES)
    rt = _runtime(FaultSpec(drop_prob=0.15, dup_prob=0.1, max_delay_s=0.01,
                            seed=42))
    try:
        h_faulty = run_in_flare(rt, _server_app(codec=codec,
                                                low_memory=low_memory),
                                _clients, SITES)
        stats = rt.network.stats
    finally:
        rt.shutdown()
    assert stats["dropped"] > 0, "fault injection did not fire"
    _assert_same_history(h_native, h_faulty)


@pytest.mark.parametrize("codec", [None, "bf16", "q8"])
def test_torch_backend_equals_numpy_backend_bitwise(codec):
    h_torch = run_native(_server_app(codec=codec, backend="torch"),
                         _clients, SITES)
    h_numpy = run_native(_server_app(codec=codec, backend="numpy"),
                         _clients, SITES)
    _assert_same_history(h_torch, h_numpy)


@pytest.mark.parametrize("codec", [None, "q8"])
def test_round_losses_match_the_reference(codec):
    init = RQ.init_mlp(jax.random.key(0), 32, 64, 10)
    h_ref = ref_run_native(
        RefServerApp(RefServerConfig(num_rounds=3, round_timeout=60,
                                     codec=codec, agg_backend="numpy"),
                     RefFedAvg(initial_parameters=init)),
        lambda s: RQ.make_client_app(s), SITES)
    h_port = run_native(_server_app(rounds=3, codec=codec, init=init),
                        _clients, SITES)
    ref_l = [l for _, l in h_ref.losses()]
    port_l = [l for _, l in h_port.losses()]
    assert len(ref_l) == len(port_l) == 3
    np.testing.assert_allclose(port_l, ref_l, rtol=LOSS_RTOL)
    for a, b in zip(h_port.final_parameters, h_ref.final_parameters):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_edge_tier_honours_agg_device(monkeypatch):
    """The edge tier folds with the ServerConfig's backend and device: on
    a host without CUDA, ``run_hierarchical`` with ``agg_device="cpu"``
    runs, and one edge over the whole fleet continues the flat low-memory
    fold exactly (``acc = 0 + 1.0 * S``, one divide by W)."""
    import torch

    from repro_torch.core import run_hierarchical

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flat = run_native(_server_app(low_memory=True), _clients, SITES)
    hier = run_hierarchical(_server_app(low_memory=True), _clients, SITES,
                            num_edges=1, edge_timeout=20)
    _assert_same_history(hier, flat)
    assert [r.metrics["num_payloads"] for r in hier.rounds] == [1, 1]
