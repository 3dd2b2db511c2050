"""End-to-end quickstart scenario grid: codec x strategy x fault.

Every cell runs the full stack — codec negotiation (get_properties),
quantized downlink / int8-delta uplink where negotiated, arrival-order
streaming aggregation, shared-deadline fault handling — over a real
SuperLink fleet, and asserts:

- the run completes every round (faults demote to recorded failures);
- convergence within tolerance of the lossless fault-free baseline;
- ``RoundRecord.failures`` names exactly the faulted nodes (and nothing
  else), and quorum knobs abort via ``QuorumNotMet`` when violated;
- a negotiated lossy codec is reported in ``RoundRecord.metrics``.

The cases of ``tests/test_scenarios.py`` against ``repro_torch``: clients
fit and servers fold on the CPU (``device="cpu"``, the torch backend's
plain twins), from the port's ``init_mlp(0, ...)``.  The reference's
Pallas-backend case becomes the torch backend against the numpy backend,
bitwise.  Across the packages, the straggler and dead-node scenarios run
in both with the same seeds, from the reference's initial parameters:
equal failure records, round losses within ``LOSS_RTOL``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from repro_torch.core import superlink as TS
from repro_torch.core import transport as TT
from repro_torch.fl import ClientApp, QuorumNotMet
from repro_torch.fl import quickstart as TQ
from repro_torch.fl import server as TSV
from repro_torch.fl import strategy as TST

pytestmark = pytest.mark.slow

CODECS = ("flat", "bf16", "q8")
STRATEGIES = {
    "fedavg": {},
    "fedtrimmedmean": {"beta": 0.25},
    "krum": {"num_byzantine": 0, "num_selected": 1},
}
FAULTS = ("none", "straggler", "dead")

N_SITES = 4
ROUNDS = 2
DIM, CLASSES, HIDDEN = 16, 4, 64
STRAGGLER_DELAY = 0.25
DEAD_TIMEOUT = 0.9
CLIENT_KW = dict(dim=DIM, classes=CLASSES, n_train=128, n_test=64,
                 epochs=1, lr=0.05)
#: round losses across the packages (tests/test_torch_quickstart.py)
LOSS_RTOL = 1e-5


def _faulty_class(Q):
    """The faulty quickstart client on package ``Q``'s QuickstartClient."""

    class FaultyQuickstart(Q.QuickstartClient):
        """Quickstart client with an injectable fault: ``delay`` sleeps before
        training (straggler), ``dead`` blocks on an event the fixture releases
        at teardown (node never answers inside the deadline)."""

        def __init__(self, site, *, delay=0.0, dead=None, **kw):
            super().__init__(site, **kw)
            self._delay = delay
            self._dead = dead

        def fit(self, parameters, config):
            if self._dead is not None:
                self._dead.wait()
            if self._delay:
                time.sleep(self._delay)
            return super().fit(parameters, config)

        def evaluate(self, parameters, config):
            if self._dead is not None:
                self._dead.wait()
            return super().evaluate(parameters, config)

    return FaultyQuickstart


#: the port's package and client options; the reference's are built in
#: the cross-package test
PORT = dict(S=TS, T=TT, SV=TSV, ST=TST, Q=TQ, client_kw=dict(device="cpu"),
            cfg=dict(agg_device="cpu"), ClientApp=ClientApp)


@contextmanager
def quickstart_fleet(fault: str, pkg=PORT):
    """SuperLink + N quickstart SuperNodes; the last site carries the
    fault.  Yields (driver, faulted_site_or_None).

    ``REPRO_TRANSPORT=tcp`` swaps the in-process connections for a
    :class:`~repro_torch.core.transport.TcpSuperLink` listener plus one real
    socket per node — the CI ``tcp-mp`` lane re-runs the scenario grid
    over it to prove the apps are transport-agnostic."""
    use_tcp = os.environ.get("REPRO_TRANSPORT") == "tcp"
    sites = [f"site-{i}" for i in range(1, N_SITES + 1)]
    dead_ev = threading.Event() if fault == "dead" else None
    faulted = sites[-1] if fault != "none" else None
    S = pkg["S"]
    faulty = _faulty_class(pkg["Q"])
    if use_tcp:
        T = pkg["T"]
        link = T.TcpSuperLink("127.0.0.1", 0)
        host, port = link.address
        conn_for = lambda s: T.TcpFleetConnection(host, port, s)  # noqa: E731
    else:
        link = S.SuperLink()
        conn_for = lambda s: S.NativeConnection(link)  # noqa: E731
    nodes = []
    for s in sites:
        kw = dict(CLIENT_KW, **pkg["client_kw"])
        if s == faulted and fault == "straggler":
            kw["delay"] = STRAGGLER_DELAY
        if s == faulted and fault == "dead":
            kw["dead"] = dead_ev
        client = faulty(s, **kw)
        nodes.append(S.SuperNode(
            s, pkg["ClientApp"](lambda cid, c=client: c.to_client()),
            conn_for(s)))
    for n in nodes:
        n.start()
    try:
        yield S.SuperLinkDriver(link, expected_nodes=N_SITES), faulted
    finally:
        if dead_ev is not None:
            dead_ev.set()
        for n in nodes:
            n.stop()
        if use_tcp:
            link.close()


def run_scenario(codec: str, strategy: str, fault: str, *, rounds=ROUNDS,
                 pkg=PORT, initial=None, **strategy_kw):
    kw = dict(STRATEGIES.get(strategy, {}))
    kw.update(strategy_kw)
    if initial is None:
        initial = TQ.init_mlp(0, DIM, HIDDEN, CLASSES)
    strat = pkg["ST"].make_strategy(strategy, initial_parameters=initial,
                                    **kw)
    timeout = DEAD_TIMEOUT if fault == "dead" else 30.0
    app = pkg["SV"].ServerApp(
        pkg["SV"].ServerConfig(num_rounds=rounds, round_timeout=timeout,
                               codec=None if codec == "flat" else codec,
                               **pkg["cfg"]), strat)
    with quickstart_fleet(fault, pkg) as (driver, faulted):
        return app.run(driver), faulted


@pytest.fixture(scope="module")
def baseline_loss():
    """Lossless fault-free FedAvg: the reference every cell must stay
    within tolerance of."""
    h, _ = run_scenario("flat", "fedavg", "none")
    loss = h.losses()[-1][1]
    assert np.isfinite(loss)
    return loss


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
@pytest.mark.parametrize("codec", CODECS)
def test_scenario_grid(codec, strategy, fault, baseline_loss):
    h, faulted = run_scenario(codec, strategy, fault)

    # every round completed and evaluated
    assert len(h.rounds) == ROUNDS
    losses = h.losses()
    assert len(losses) == ROUNDS
    assert all(np.isfinite(loss) for _, loss in losses)
    assert h.final_parameters is not None

    # convergence within tolerance of the lossless fault-free baseline
    # (krum aggregates a single client; a generous but finite bound still
    # proves training happened and nothing diverged)
    assert losses[-1][1] <= baseline_loss + 0.35

    for rec in h.rounds:
        failed = {n for n, _ in rec.failures}
        if fault == "dead":
            # the dead node misses the shared deadline in BOTH phases and
            # is recorded, never round-aborting; nobody else fails
            assert failed == {faulted}
            assert all(reason == "timeout" for _, reason in rec.failures)
        else:
            # a straggler inside the deadline is not a failure
            assert failed == set()
        expect_clients = N_SITES - (1 if fault == "dead" else 0)
        if "num_clients" in rec.metrics:       # fedavg / trimmed-mean
            assert rec.metrics["num_clients"] == expect_clients
        if strategy == "krum":
            picked = rec.metrics["krum_selected"]
            assert len(picked) == 1
            assert picked[0] != faulted or fault != "dead"
        if codec != "flat":
            # the lossy codec actually negotiated (quickstart clients
            # advertise every codec), not silently demoted
            assert rec.metrics["wire_codec"] == codec
            assert "wire_codec_demotion" not in rec.metrics


def test_quorum_not_met_aborts_run_with_dead_node():
    """min_available above the surviving population: the round must abort
    loudly (QuorumNotMet) instead of aggregating a silent minority."""
    with pytest.raises(QuorumNotMet):
        run_scenario("flat", "fedavg", "dead", min_available=N_SITES)


def test_krum_byzantine_floor_enforced_as_quorum():
    """Krum's n >= 2f+3 population floor: f=1 needs 5 results but the
    fleet only has 4 — QuorumNotMet even with zero faults."""
    with pytest.raises(QuorumNotMet):
        run_scenario("flat", "krum", "none", num_byzantine=1)


def test_straggler_round_does_not_wait_for_deadline():
    """With one straggler the round ends ~max(client time), not at the
    shared deadline — the arrival-order driver overlaps decode+accumulate
    with the straggler's compute."""
    t0 = time.monotonic()
    h, _ = run_scenario("flat", "fedavg", "straggler")
    elapsed = time.monotonic() - t0
    assert len(h.rounds) == ROUNDS
    assert not h.rounds[-1].failures
    # 30s deadline; generous bound proves nobody waited it out
    assert elapsed < 15.0


def test_torch_backend_scenario_bitwise_vs_numpy():
    """The same faulted quantized run on the torch aggregation backend
    (its plain twins here) must reproduce the numpy run bitwise (both are
    deterministic given the canonicalized client order)."""
    h_np, _ = run_scenario("q8", "fedavg", "straggler",
                           backend="numpy")
    h_t, _ = run_scenario("q8", "fedavg", "straggler",
                          backend="torch")
    assert h_np.losses() == h_t.losses()
    for a, b in zip(h_np.final_parameters, h_t.final_parameters):
        np.testing.assert_array_equal(a, b)


def _reference_pkg():
    import repro.fl.client as RC
    from repro.core import superlink as RS
    from repro.core import transport as RT
    from repro.fl import quickstart as RQ
    from repro.fl import server as RSV
    from repro.fl import strategy as RST

    return dict(S=RS, T=RT, SV=RSV, ST=RST, Q=RQ, client_kw={},
                cfg=dict(agg_backend="numpy"), ClientApp=RC.ClientApp)


@pytest.mark.parametrize("fault", ["straggler", "dead"])
@pytest.mark.parametrize("strategy", ["fedavg", "krum"])
def test_fault_scenario_matches_the_reference(strategy, fault):
    """The same faulted fleet in both packages, from the reference's
    initial parameters: the same failures each round, round losses within
    ``LOSS_RTOL``."""
    import jax

    from repro.fl.quickstart import init_mlp as ref_init_mlp

    initial = ref_init_mlp(jax.random.key(0), DIM, HIDDEN, CLASSES)
    ref = _reference_pkg()
    # the reference's first fit compiles its step: warm it up, so that only
    # the dead node misses the dead scenario's 0.9 s deadline
    run_scenario("flat", strategy, "none", rounds=1, pkg=ref,
                 initial=initial)
    h_ref, f_ref = run_scenario("flat", strategy, fault, pkg=ref,
                                initial=initial)
    h_port, f_port = run_scenario("flat", strategy, fault, initial=initial)
    assert f_port == f_ref
    assert [sorted(r.failures) for r in h_port.rounds] == \
        [sorted(r.failures) for r in h_ref.rounds]
    if strategy == "krum":
        assert [r.metrics["krum_selected"] for r in h_port.rounds] == \
            [r.metrics["krum_selected"] for r in h_ref.rounds]
    np.testing.assert_allclose([l for _, l in h_port.losses()],
                               [l for _, l in h_ref.losses()],
                               rtol=LOSS_RTOL)
