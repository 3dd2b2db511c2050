"""FLARE's job system on the port: the cases of ``tests/test_system.py``
from Fig. 6 on (metric streaming, concurrent jobs, queueing on exhausted
resources, unauthorized submit, forged kit, pairwise seeds) against
``repro_torch.runtime``; ``tests/test_torch_system.py`` holds the Fig. 5
cases.  Clients fit and the server folds on the CPU.  Provisioning's
pairwise seeds equal the reference's for the same project and secret, so
SecAgg masks agree across the packages.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import pytest

from repro_torch.core import run_in_flare
from repro_torch.fl import FedAvg, ServerApp, ServerConfig
from repro_torch.fl.client import ClientApp
from repro_torch.fl.quickstart import QuickstartClient
from repro_torch.runtime import FlareRuntime, JobSpec
from repro_torch.runtime.jobs import JobStatus

SITES = ["site-1", "site-2", "site-3"]


def _server_app(rounds=2):
    return ServerApp(config=ServerConfig(num_rounds=rounds, round_timeout=60,
                                         agg_device="cpu"),
                     strategy=FedAvg())


@pytest.fixture
def runtime():
    rt = FlareRuntime()
    for s in SITES:
        rt.provision_site(s)
    yield rt
    rt.shutdown()


# ---------------------------------------------------------------------------
# Fig. 6: metric streaming (hybrid integration)
# ---------------------------------------------------------------------------
def test_metric_streaming_through_runtime(runtime):
    def client_app_fn(site):
        def with_ctx(ctx):
            writer = ctx.summary_writer()
            return ClientApp(client_fn=lambda cid: QuickstartClient(
                site, writer=writer, device="cpu").to_client())
        return with_ctx

    run_in_flare(runtime, _server_app(), client_app_fn, SITES)
    job_id = next(iter(runtime._jobs))
    mc = runtime.metrics(job_id)
    tags = mc.tags()
    for s in SITES:
        assert f"{s}/train_loss" in tags
        assert f"{s}/test_accuracy" in tags
    series = mc.series("site-1/train_loss")
    assert len(series) == 2                      # one point per round
    assert mc.export_tensorboard_json().startswith("{")


# ---------------------------------------------------------------------------
# §3.1 multi-job: concurrent jobs share clients/server without conflicts
# ---------------------------------------------------------------------------
def test_concurrent_jobs(runtime):
    admin = runtime.provisioner.issue("admin", "admin")

    class SJob:
        def __init__(self, tag):
            self.tag = tag

        def run(self, ctx):
            acc = []
            for site in sorted(ctx.sites):
                acc.append(ctx.request(site, "mul", self.tag.encode()).decode())
            return acc

    class CJob:
        def __init__(self, site):
            self.site = site

        def run(self, ctx):
            ctx.register_handler(
                "mul", lambda m: f"{self.site}:{m.payload.decode()}".encode())
            ctx.stop_event.wait()

    ids = []
    for tag in ("alpha", "beta", "gamma"):
        spec = JobSpec(name=tag, server_app_fn=lambda t=tag: SJob(t),
                       client_app_fn=lambda s: CJob(s), min_sites=3,
                       resources={"gpu": 0.25})
        ids.append(runtime.submit_job(spec, admin))
    recs = [runtime.wait(j, timeout=60) for j in ids]
    for rec, tag in zip(recs, ("alpha", "beta", "gamma")):
        assert rec.status == JobStatus.COMPLETED, rec.error
        assert rec.result == [f"{s}:{tag}" for s in SITES]


def test_job_queues_when_resources_exhausted(runtime):
    admin = runtime.provisioner.issue("admin", "admin")

    class SJob:
        def run(self, ctx):
            import time
            time.sleep(0.3)
            return "ok"

    class CJob:
        def __init__(self, site):
            pass

        def run(self, ctx):
            ctx.stop_event.wait()

    specs = [JobSpec(name=f"j{i}", server_app_fn=lambda: SJob(),
                     client_app_fn=lambda s: CJob(s), min_sites=3,
                     resources={"gpu": 1.0}) for i in range(2)]
    ids = [runtime.submit_job(sp, admin) for sp in specs]
    recs = [runtime.wait(j, timeout=60) for j in ids]
    assert all(r.status == JobStatus.COMPLETED for r in recs)


# ---------------------------------------------------------------------------
# provisioning / authorization
# ---------------------------------------------------------------------------
def test_unauthorized_submit_rejected(runtime):
    client_kit = runtime.provisioner.issue("site-1", "client")
    spec = JobSpec(name="x", server_app_fn=lambda: None,
                   client_app_fn=lambda s: None)
    with pytest.raises(PermissionError):
        runtime.submit_job(spec, client_kit)


def test_forged_kit_rejected(runtime):
    from repro_torch.runtime.provision import StartupKit

    forged = StartupKit(runtime.provisioner.project, "admin", "admin",
                        b"\x00" * 32)
    spec = JobSpec(name="x", server_app_fn=lambda: None,
                   client_app_fn=lambda s: None)
    with pytest.raises(PermissionError):
        runtime.submit_job(spec, forged)


def test_pairwise_seeds_symmetric(runtime):
    p = runtime.provisioner
    assert p.pairwise_seed("site-1", "site-2") == p.pairwise_seed("site-2",
                                                                  "site-1")
    assert p.pairwise_seed("site-1", "site-2") != p.pairwise_seed("site-1",
                                                                  "site-3")


@pytest.mark.parametrize("project,secret", [("secure-fed-demo", b"\x07" * 32),
                                            ("flare-demo", bytes(range(32)))],
                         ids=["secure-fed-demo", "flare-demo"])
def test_pairwise_seeds_and_kits_match_the_reference(project, secret):
    from repro.runtime.provision import Provisioner as RefProvisioner

    from repro_torch.runtime.provision import Provisioner

    ref = RefProvisioner(project, secret=secret)
    port = Provisioner(project, secret=secret)
    for a in SITES:
        for b in SITES:
            if a != b:
                assert port.pairwise_seed(a, b) == ref.pairwise_seed(a, b)
    kit = port.issue("site-1", "client")
    assert kit.token == ref.issue("site-1", "client").token
    assert ref.verify(kit) and port.verify(ref.issue("site-2", "client"))
