"""Interop entry points — the paper's §5.1 experiment surface.

``run_native(server_app, client_app_fn, sites)``
    Flower running "alone": SuperLink + SuperNodes with direct in-process
    connections.

``run_in_flare(runtime, server_app, client_app_fn, sites)``
    The SAME app objects deployed as a FLARE job: the server job process
    hosts SuperLink + LGC + the ServerApp; each site's CCP spawns a client
    job process hosting SuperNode + ClientApp behind an LGS.  No app code
    changes — only the connection object differs (paper §2's goal).

Both return the ServerApp :class:`~repro_torch.fl.server.History`, so the Fig. 5
reproducibility claim is checked by comparing the two histories bit-for-bit.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.core.lgc import LGC
from repro_torch.core.lgs import LGSConnection
from repro_torch.core.superlink import (NativeConnection, SuperLink,
                                        SuperLinkDriver, SuperNode,
                                        make_edge_tier)
from repro_torch.fl.client import ClientApp
from repro_torch.fl.server import History, ServerApp
from repro_torch.runtime.ccp import JobContext
from repro_torch.runtime.jobs import JobSpec
from repro_torch.runtime.scp import FlareRuntime


# ---------------------------------------------------------------------------
# native (Flower alone)
# ---------------------------------------------------------------------------
def run_native(server_app: ServerApp,
               client_app_fn: Callable[[str], ClientApp],
               sites: Sequence[str]) -> History:
    if getattr(server_app.config, "transport", "inproc") == "tcp":
        return run_tcp(server_app, client_app_fn, sites)
    link = SuperLink()
    nodes = [SuperNode(s, client_app_fn(s), NativeConnection(link))
             for s in sites]
    for n in nodes:
        n.start()
    try:
        driver = SuperLinkDriver(link, expected_nodes=len(sites))
        return server_app.run(driver)
    finally:
        for n in nodes:
            n.stop()


def run_tcp(server_app: ServerApp,
            client_app_fn: Callable[[str], ClientApp],
            sites: Sequence[str], *,
            server_ssl=None,
            client_ssl_fn: Optional[Callable[[str], object]] = None
            ) -> History:
    """Native topology over real sockets: a
    :class:`~repro_torch.core.transport.TcpSuperLink` bound to
    ``config.bind_host:config.bind_port`` with one TCP-connected
    SuperNode per site — same apps, same Driver, different wire (the
    Fig. 5 claim extended from the FLARE bridge to a real network).  The
    TLS hook point: pass an ``ssl.SSLContext`` for the listener and a
    per-site context factory for the clients (the tests run plaintext)."""
    from repro_torch.core.transport import TcpFleetConnection, TcpSuperLink
    cfg = server_app.config
    with TcpSuperLink(cfg.bind_host, cfg.bind_port,
                      ssl_context=server_ssl) as link:
        host, port = link.address
        nodes = [SuperNode(s, client_app_fn(s), TcpFleetConnection(
                     host, port, s,
                     ssl_context=client_ssl_fn(s) if client_ssl_fn
                     else None))
                 for s in sites]
        for n in nodes:
            n.start()
        try:
            driver = SuperLinkDriver(link, expected_nodes=len(sites))
            return server_app.run(driver)
        finally:
            for n in nodes:
                n.stop()


def run_hierarchical(server_app: ServerApp,
                     client_app_fn: Callable[[str], ClientApp],
                     sites: Sequence[str], num_edges: int,
                     edge_timeout: float = 60.0) -> History:
    """Two-tier native run: ``sites`` clients partitioned across
    ``num_edges`` edge aggregators (inline child fleets, no per-client
    threads), so the root server folds **O(num_edges)** payloads per
    round instead of O(len(sites)).  With a weighted-sum strategy the
    sync result continues the flat fold's arithmetic exactly — see
    :class:`~repro_torch.core.superlink.EdgeAggregatorApp`.  The edges fold
    with the server app's ``agg_backend`` on its ``agg_device``."""
    link = SuperLink()
    apps = {s: client_app_fn(s) for s in sites}
    cfg = server_app.config
    edges = make_edge_tier(link, apps, num_edges, timeout=edge_timeout,
                           backend=cfg.agg_backend, device=cfg.agg_device)
    try:
        driver = SuperLinkDriver(link, expected_nodes=num_edges)
        return server_app.run(driver)
    finally:
        for n in edges:
            n.stop()


# ---------------------------------------------------------------------------
# inside FLARE (the paper's integration)
# ---------------------------------------------------------------------------
class _FlowerServerJob:
    """FLARE server job process: SuperLink + LGC + ServerApp."""

    def __init__(self, server_app: ServerApp, num_sites: int):
        self.server_app = server_app
        self.num_sites = num_sites

    def run(self, ctx: JobContext) -> History:
        link = SuperLink()
        LGC(ctx, link)                       # relayed fleet calls now land here
        driver = SuperLinkDriver(link, expected_nodes=self.num_sites)
        return self.server_app.run(driver)


class _FlowerClientJob:
    """FLARE client job process: SuperNode pointed at the LGS."""

    def __init__(self, site: str, client_app):
        self.site = site
        self.client_app = client_app
        self._node: Optional[SuperNode] = None

    def run(self, ctx: JobContext) -> None:
        app = self.client_app
        if not isinstance(app, ClientApp) and callable(app):
            # hybrid integration (paper §5.2): the factory may consume the
            # FLARE JobContext, e.g. to build a SummaryWriter for metric
            # streaming inside otherwise-unmodified Flower client code
            app = app(ctx)
        conn = LGSConnection(ctx)            # <- the ONLY difference vs native
        self._node = SuperNode(self.site, app, conn)
        self._node.start()
        # serve until the CCP stops the job process
        ctx.stop_event.wait()
        self._node.stop()


def run_in_flare(runtime: FlareRuntime, server_app: ServerApp,
                 client_app_fn: Callable[[str], ClientApp],
                 sites: Optional[Sequence[str]] = None,
                 job_name: str = "flower-app",
                 timeout: float = 300.0) -> History:
    """Submit the Flower app as a FLARE job and wait for its History."""
    sites = list(sites or runtime.sites())
    admin = runtime.provisioner.issue("admin", "admin")
    spec = JobSpec(
        name=job_name,
        server_app_fn=lambda: _FlowerServerJob(server_app, len(sites)),
        client_app_fn=lambda site: _FlowerClientJob(site, client_app_fn(site)),
        min_sites=len(sites),
    )
    job_id = runtime.submit_job(spec, admin)
    rec = runtime.wait(job_id, timeout=timeout)
    if not rec.done.is_set():
        raise TimeoutError(f"job {job_id} did not finish in {timeout}s")
    if rec.error:
        raise RuntimeError(f"job {job_id} failed:\n{rec.error}")
    return rec.result
