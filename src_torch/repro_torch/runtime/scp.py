"""Server Control Process + runtime facade (paper §3.1).

``FlareRuntime`` owns the transport, provisioning, the SCP scheduler and
the server-side job processes.  Per job it creates a *Job Network*: one
server job endpoint ``server/job/<id>`` plus one client job endpoint
``<site>/job/<id>`` per site (spawned by each site's CCP).  By default job
processes are NOT directly connected: client-side requests go to the SCP,
which relays to the server job process (and back) — exactly the message
path of Fig. 4.  ``direct_connections=True`` switches to P2P (the
"network policy permits" fast path), transparently to applications.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.runtime.ccp import CCP, JobContext
from repro_torch.runtime.jobs import JobRecord, JobSpec, JobStatus, ResourcePool
from repro_torch.runtime.provision import Provisioner, StartupKit
from repro_torch.runtime.reliable import ReliableMessenger, RequestTimeout
from repro_torch.runtime.streaming import MetricCollector
from repro_torch.runtime.transport import FaultSpec, Message, Network

SCP_NAME = "scp"


class FlareRuntime:
    def __init__(self, project: str = "fl-project",
                 faults: Optional[FaultSpec] = None,
                 direct_connections: bool = False,
                 retry_interval: float = 0.02,
                 request_timeout: float = 60.0):
        self.network = Network(faults)
        self.provisioner = Provisioner(project)
        self.direct_connections = direct_connections
        self.request_timeout = request_timeout
        self.retry_interval = retry_interval
        self.scp = ReliableMessenger(self.network, SCP_NAME,
                                     retry_interval=retry_interval,
                                     default_timeout=request_timeout)
        self._jobs: Dict[str, JobRecord] = {}
        self._ccps: Dict[str, CCP] = {}
        self._pools: Dict[str, ResourcePool] = {}
        self._metrics: Dict[str, MetricCollector] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._sched = threading.Thread(target=self._scheduler, daemon=True,
                                       name="scp-scheduler")
        self._sched.start()
        # SCP relays client<->server job traffic (Fig. 4 hops 2/5)
        self.scp.register_handler("job/*", self._relay)

    # ------------------------------------------------------------ sites
    def provision_site(self, site: str, role: str = "client",
                       resources: Optional[Dict[str, float]] = None) -> StartupKit:
        kit = self.provisioner.issue(site, role)
        if role == "client":
            ccp = CCP(self, site, kit)
            with self._lock:
                self._ccps[site] = ccp
                self._pools[site] = ResourcePool(resources or {"gpu": 1.0})
        return kit

    def sites(self) -> List[str]:
        with self._lock:
            return sorted(self._ccps)

    # ------------------------------------------------------------ jobs API
    def submit_job(self, spec: JobSpec, kit: StartupKit) -> str:
        if not self.provisioner.authorize(kit, "submit_job"):
            raise PermissionError(f"{kit.site} ({kit.role}) may not submit jobs")
        rec = JobRecord(spec)
        with self._lock:
            self._jobs[spec.job_id] = rec
            self._metrics[spec.job_id] = MetricCollector()
        return spec.job_id

    def job(self, job_id: str) -> JobRecord:
        with self._lock:
            return self._jobs[job_id]

    def metrics(self, job_id: str) -> MetricCollector:
        with self._lock:
            return self._metrics[job_id]

    def wait(self, job_id: str, timeout: Optional[float] = None) -> JobRecord:
        rec = self.job(job_id)
        rec.done.wait(timeout)
        return rec

    def abort_job(self, job_id: str, kit: StartupKit) -> None:
        if not self.provisioner.authorize(kit, "abort_job"):
            raise PermissionError("not authorized to abort")
        rec = self.job(job_id)
        rec.status = JobStatus.ABORTED
        rec.done.set()

    # ------------------------------------------------------------ scheduler
    def _scheduler(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                pending = [r for r in self._jobs.values()
                           if r.status == JobStatus.SUBMITTED]
                sites = sorted(self._ccps)
            for rec in pending:
                if len(sites) < rec.spec.min_sites:
                    continue
                # resource check on every site (concurrent-job admission)
                acquired = []
                ok = True
                for s in sites:
                    if self._pools[s].try_acquire(rec.spec.resources):
                        acquired.append(s)
                    else:
                        ok = False
                        break
                if not ok or len(acquired) < rec.spec.min_sites:
                    for s in acquired:
                        self._pools[s].release(rec.spec.resources)
                    continue
                rec.sites = acquired
                rec.status = JobStatus.SCHEDULED
                t = threading.Thread(target=self._run_job, args=(rec,),
                                     daemon=True, name=f"job-{rec.job_id}")
                t.start()
            time.sleep(0.01)

    # ------------------------------------------------------------ job run
    def _run_job(self, rec: JobRecord) -> None:
        spec = rec.spec
        try:
            rec.status = JobStatus.DEPLOYING
            # server job endpoint + metric sink
            server_ep = f"server/job/{spec.job_id}"
            messenger = ReliableMessenger(self.network, server_ep,
                                          retry_interval=self.retry_interval,
                                          default_timeout=self.request_timeout)
            collector = self.metrics(spec.job_id)
            self.scp.register_handler(f"job/{spec.job_id}/metrics",
                                      collector.on_event)
            messenger.register_handler(f"job/{spec.job_id}/metrics",
                                       collector.on_event)
            ctx = JobContext(runtime=self, job_id=spec.job_id, site="server",
                             messenger=messenger, sites=list(rec.sites))
            server_job = spec.server_app_fn()

            # deploy to every CCP (startup kits / custom code / certs)
            for s in rec.sites:
                resp = self.scp.request(f"ccp/{s}", "ccp/deploy",
                                        spec.job_id.encode(),
                                        timeout=self.request_timeout)
                if resp != b"OK":
                    raise RuntimeError(f"deploy failed on {s}: {resp!r}")
            rec.status = JobStatus.RUNNING
            rec.result = server_job.run(ctx)
            rec.status = JobStatus.COMPLETED
        except Exception as e:  # noqa: BLE001
            rec.error = f"{e}\n{traceback.format_exc()}"
            rec.status = JobStatus.FAILED
        finally:
            for s in rec.sites:
                try:
                    self.scp.request(f"ccp/{s}", "ccp/stop",
                                     spec.job_id.encode(), timeout=5.0)
                except RequestTimeout:
                    pass
                self._pools[s].release(spec.resources)
            rec.done.set()

    # ------------------------------------------------------------ relay
    def _relay(self, msg: Message) -> bytes:
        """SCP-mediated Job-Network routing: job/<id>/relay/<dest>/<topic>."""
        parts = msg.topic.split("/")
        if len(parts) < 4 or parts[2] != "relay":
            return b""
        job_id, dest = parts[1], parts[3]
        inner_topic = "/".join(["job", job_id] + parts[4:])
        target = (f"server/job/{job_id}" if dest == "server"
                  else f"{dest}/job/{job_id}")
        return self.scp.request(target, inner_topic, msg.payload,
                                timeout=self.request_timeout)

    # ------------------------------------------------------------ lifecycle
    def shutdown(self) -> None:
        self._stop.set()
        for ccp in self._ccps.values():
            ccp.shutdown()
        self.network.close()

    # registry the CCPs use to fetch "deployed code" (single-process stand-in
    # for FLARE's custom-code distribution; documented in DESIGN.md)
    def _lookup_spec(self, job_id: str) -> JobSpec:
        return self.job(job_id).spec
