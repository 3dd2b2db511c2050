"""The paper's four examples on the port (``repro_torch.examples``).

Each example's ``main([], device="cpu")`` runs and passes its own
self-check (hybrid_tracking exports into ``tmp_path``); with no device it
asks for the card and raises when there is none; the modules import none
of the reference's dependencies.  Across the packages, the reference's
example (loaded from ``examples/*.py`` by path) and the port's run side by
side from the reference's initial parameters, injected through
``initial_parameters``: round losses within ``LOSS_RTOL`` (the quickstart
tolerance of ``tests/test_torch_quickstart.py``) for quickstart's FedAdam
natively and in FLARE, hybrid_tracking's FedAvg (and its streamed
training losses), secure_federation's plain FedAvg, SecAgg and SecAgg +
DP, and multi_job's two concurrent jobs.  The reference folds on its numpy
engine, the port on the torch backend's plain twins.  Each example's
constants are the reference's, read from the reference's source.

FedAdam (quickstart; multi_job's second job) drives the eval loss to
2.5e-4-3e-3, where a relative bound cannot hold in fp32: the loss is the
mean of ``logsumexp(logits) - logit_y`` over logits of 20-37 (measured on
quickstart's final model from the reference's initial parameters), whose
fp32 ulp is 2**-19, so each sample's loss carries up to half of that,
2**-20 (9.5e-7), of rounding.  Losses are held within ``LOSS_RTOL``
relative plus ``LOSS_ATOL`` = 2**-20 absolute; the measured gaps there are
2e-8-1e-7.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import importlib
import importlib.util
import json
import pathlib
import subprocess

import jax
import numpy as np
import pytest
import torch

from repro_torch.examples import hybrid_tracking as HT
from repro_torch.examples import multi_job as MJ
from repro_torch.examples import quickstart as QS
from repro_torch.examples import secure_federation as SF

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
LOSS_ATOL = 2.0 ** -20
EXAMPLES = ("quickstart", "secure_federation", "hybrid_tracking",
            "multi_job")


def _reference_example(name):
    """``examples/<name>.py`` of the reference, loaded by path."""
    mod_name = f"ref_example_{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(
        mod_name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_init():
    from repro.fl.quickstart import init_mlp

    return init_mlp(jax.random.key(0), 32, 64, 10)


def _losses(h):
    return [l for _, l in h.losses()]


def _assert_losses_close(port, ref):
    assert len(port) == len(ref) > 0
    assert all(np.isfinite(port))
    np.testing.assert_allclose(port, ref, rtol=LOSS_RTOL, atol=LOSS_ATOL)


# ---------------------------------------------------------------------------
# the port's examples alone
# ---------------------------------------------------------------------------
def test_quickstart_main_on_the_cpu():
    out = QS.main([], device="cpu")
    assert out["bitwise"]
    losses = _losses(out["native"])
    assert len(losses) == QS.ROUNDS and losses[-1] < losses[0]


def test_secure_federation_main_on_the_cpu():
    out = SF.main([], device="cpu")
    assert out["max_param_delta"] < SF.SECAGG_TOL
    assert [r.metrics.get("secagg") for r in out["secagg"].rounds] == \
        [1] * SF.ROUNDS
    assert [r.metrics.get("secagg") for r in out["dp"].rounds] == \
        [1] * SF.ROUNDS


def test_hybrid_tracking_main_exports_into_the_working_directory(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = HT.main([], device="cpu")
    path = tmp_path / HT.EXPORT
    assert pathlib.Path(out["path"]) == path and path.is_file()
    exported = json.loads(path.read_text())
    for s in HT.SITES:
        for tag in HT.CLIENT_TAGS:
            assert f"{s}/{tag}" in exported
        assert len(out["series"][f"{s}/train_loss"]) == HT.ROUNDS


def test_multi_job_main_completes_both_jobs():
    out = MJ.main([], device="cpu")
    recs = out["records"]
    assert [r.status.value for r in recs] == ["COMPLETED", "COMPLETED"]
    assert all(len(_losses(r.result)) == MJ.ROUNDS for r in recs)


def test_launch_counter_loses_no_count_across_threads():
    """multi_job's two jobs fold from two threads, each launch counted in
    ``agg_reduce.LAUNCHES``: more threads than cores, a short switch
    interval, and every count arrives."""
    import threading

    from repro_torch.kernels import agg_reduce

    threads, per_thread = 2 * (os.cpu_count() or 1) + 2, 5000
    before = agg_reduce.LAUNCHES["weighted_sum"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            agg_reduce._launched("weighted_sum", 0)
            for _ in range(per_thread)]) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(old)
    got = agg_reduce.LAUNCHES["weighted_sum"] - before
    agg_reduce.LAUNCHES["weighted_sum"] = before
    assert got == threads * per_thread


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_needs_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.mark.parametrize("module", [f"repro_torch.examples.{n}"
                                    for n in EXAMPLES]
                         + ["repro_torch.fl.legacy"])
def test_module_imports_no_reference_dependency(module):
    code = ("import sys, {m}\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro', 'msgpack', 'ml_dtypes'))\n"
            "print(bad)\n").format(m=module)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src_torch"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def _reference_snippets(name):
    """Source text the reference's example must hold if the port's module
    constants are its own."""
    if name == "quickstart":
        return [f"FedAdam(server_lr={QS.SERVER_LR})",
                f"num_rounds={QS.ROUNDS}", f"lr={QS.LR}, skew={QS.SKEW}"]
    if name == "secure_federation":
        return [f'Provisioner("{SF.PROJECT}", secret=b"\\x07" * 32)',
                f"num_rounds={SF.ROUNDS}", f"lr={SF.LR}, skew={SF.SKEW}",
                f"clip_norm={SF.DP_CLIP}, noise_multiplier={SF.DP_NOISE}",
                f"seed={SF.DP_SEED})"]
    if name == "hybrid_tracking":
        return [f"num_rounds={HT.ROUNDS}", f"lr={HT.LR}, skew={HT.SKEW}",
                f'"{HT.EXPORT}"']
    (avg_name, _, avg_lr), (adam_name, _, adam_lr) = MJ.JOBS
    return [f"num_rounds={MJ.ROUNDS}", "round_timeout=300",
            'resources={"gpu": 0.5}', f"skew={MJ.SKEW}",
            f'flower_jobspec("{avg_name}", FedAvg(), {avg_lr})',
            f'flower_jobspec("{adam_name}", '
            f'FedAdam(server_lr={MJ.SERVER_LR}),',
            f"{adam_lr}), admin)"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_constants_are_the_reference_examples(name):
    src = (ROOT / "examples" / f"{name}.py").read_text()
    for text in _reference_snippets(name):
        assert text in src, text
    assert SF.SECRET == b"\x07" * 32
    port_sites = importlib.import_module(f"repro_torch.examples.{name}").SITES
    assert port_sites == _reference_example(name).SITES


# ---------------------------------------------------------------------------
# the port's examples against the reference's
# ---------------------------------------------------------------------------
def test_quickstart_matches_the_reference(ref_init):
    from repro.core import run_in_flare, run_native
    from repro.fl.quickstart import make_client_app
    from repro.runtime import FlareRuntime

    ref = _reference_example("quickstart")
    clients = lambda s: make_client_app(  # noqa: E731
        s, lr=QS.LR, skew=QS.SKEW)
    app = ref.make_server_app()
    app.strategy.initial_parameters = ref_init
    h_ref = run_native(app, clients, ref.SITES)
    rt = FlareRuntime()
    for s in ref.SITES:
        rt.provision_site(s)
    try:
        app = ref.make_server_app()
        app.strategy.initial_parameters = ref_init
        h_ref_flare = run_in_flare(rt, app, clients, ref.SITES)
    finally:
        rt.shutdown()
    h_native, h_flare = QS.run("cpu", initial_parameters=ref_init)
    assert QS.bitwise_same(h_native, h_flare)
    _assert_losses_close(_losses(h_native), _losses(h_ref))
    _assert_losses_close(_losses(h_flare), _losses(h_ref_flare))


def test_hybrid_tracking_matches_the_reference(ref_init):
    from repro.core import run_in_flare
    from repro.fl import FedAvg, ServerApp, ServerConfig
    from repro.runtime import FlareRuntime

    ref = _reference_example("hybrid_tracking")
    rt = FlareRuntime()
    for s in ref.SITES:
        rt.provision_site(s)
    try:
        h_ref = run_in_flare(rt, ServerApp(
            config=ServerConfig(num_rounds=HT.ROUNDS),
            strategy=FedAvg(initial_parameters=ref_init)),
            ref.client_app_fn, ref.SITES)
        mc_ref = rt.metrics(next(iter(rt._jobs)))
    finally:
        rt.shutdown()
    h_port, mc_port = HT.run("cpu", initial_parameters=ref_init)
    _assert_losses_close(_losses(h_port), _losses(h_ref))
    assert mc_port.tags() == mc_ref.tags()
    for s in HT.SITES:
        got = mc_port.series(f"{s}/train_loss")
        want = mc_ref.series(f"{s}/train_loss")
        assert [st for st, _ in got] == [st for st, _ in want]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)


def _reference_secure_runs(ref_init):
    from repro.core import run_native
    from repro.fl import (DPMod, FedAvg, SecAggFedAvg, SecAggMod, ServerApp,
                          ServerConfig)
    from repro.fl.quickstart import make_client_app
    from repro.runtime.provision import Provisioner

    sites = _reference_example("secure_federation").SITES
    prov = Provisioner(SF.PROJECT, secret=SF.SECRET)
    for s in sites:
        prov.issue(s, "client")

    def run(strategy, mods=None):
        return run_native(
            ServerApp(config=ServerConfig(num_rounds=SF.ROUNDS),
                      strategy=strategy),
            lambda s: make_client_app(s, lr=SF.LR, skew=SF.SKEW,
                                      mods=mods(s) if mods else None),
            sites)

    def secagg(s):
        return [SecAggMod(site=s, peers=sites,
                          pairwise_seed_fn=prov.pairwise_seed)]

    def dp(s):
        return [DPMod(clip_norm=SF.DP_CLIP, noise_multiplier=SF.DP_NOISE,
                      site_id=int(s[-1]), seed=SF.DP_SEED)] + secagg(s)

    return {"plain": run(FedAvg(initial_parameters=ref_init)),
            "secagg": run(SecAggFedAvg(initial_parameters=ref_init), secagg),
            "dp": run(SecAggFedAvg(initial_parameters=ref_init), dp)}


@pytest.fixture(scope="module")
def secure_runs(ref_init):
    prov = SF.provisioner()
    port = {"plain": SF.run_plain("cpu", initial_parameters=ref_init),
            "secagg": SF.run_secagg(prov, "cpu",
                                    initial_parameters=ref_init),
            "dp": SF.run_secagg(prov, "cpu", initial_parameters=ref_init,
                                dp=True)}
    return port, _reference_secure_runs(ref_init)


@pytest.mark.parametrize("run", ["plain", "secagg", "dp"])
def test_secure_federation_matches_the_reference(secure_runs, run):
    port, ref = secure_runs
    _assert_losses_close(_losses(port[run]), _losses(ref[run]))
    if run != "plain":
        assert [r.metrics.get("secagg") for r in port[run].rounds] == \
            [r.metrics.get("secagg") for r in ref[run].rounds]
    delta = SF.max_param_delta(port["plain"], port["secagg"])
    assert delta < SF.SECAGG_TOL


def test_multi_job_matches_the_reference(ref_init):
    from repro.fl import FedAdam, FedAvg
    from repro.runtime import FlareRuntime

    ref = _reference_example("multi_job")
    rt = FlareRuntime(request_timeout=300.0)
    for s in ref.SITES:
        rt.provision_site(s)
    try:
        admin = rt.provisioner.issue("admin", "admin")
        strategies = (FedAvg(initial_parameters=ref_init),
                      FedAdam(server_lr=MJ.SERVER_LR,
                              initial_parameters=ref_init))
        ids = [rt.submit_job(ref.flower_jobspec(name, strat, lr), admin)
               for (name, _, lr), strat in zip(MJ.JOBS, strategies)]
        ref_recs = [rt.wait(j, timeout=600) for j in ids]
    finally:
        rt.shutdown()
    port_recs = MJ.run("cpu", initial_parameters=ref_init)
    for p, r in zip(port_recs, ref_recs):
        assert p.status.value == r.status.value == "COMPLETED"
        _assert_losses_close(_losses(p.result), _losses(r.result))
