"""Client Control Process + per-job client context (paper §3.1).

One CCP per site, long-running.  On DEPLOY it spawns a *client job process*
(thread) with its own Job-Network endpoint ``<site>/job/<id>`` and a
:class:`JobContext` handle; on STOP it tears the job process down.
"""
from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.runtime.provision import StartupKit
from repro_torch.runtime.reliable import ReliableMessenger
from repro_torch.runtime.streaming import SummaryWriter
from repro_torch.runtime.transport import Message


@dataclass
class JobContext:
    """Everything an app (server- or client-side) may touch at runtime."""

    runtime: Any                 # FlareRuntime
    job_id: str
    site: str                    # "server" or the site name
    messenger: ReliableMessenger
    sites: List[str] = field(default_factory=list)
    extras: Dict[str, Any] = field(default_factory=dict)
    stop_event: threading.Event = field(default_factory=threading.Event)

    # --------------------------------------------------------- messaging
    def endpoint_of(self, who: str) -> str:
        return (f"server/job/{self.job_id}" if who == "server"
                else f"{who}/job/{self.job_id}")

    def request(self, dest: str, topic: str, payload: bytes,
                timeout: Optional[float] = None) -> bytes:
        """Reliable request to a Job-Network peer.

        Relayed through the SCP unless the runtime permits direct
        connections (paper §3.1's transparent communication path)."""
        full_topic = f"job/{self.job_id}/{topic}"
        if self.runtime.direct_connections:
            return self.messenger.request(self.endpoint_of(dest), full_topic,
                                          payload, timeout=timeout)
        relay_topic = f"job/{self.job_id}/relay/{dest}/{topic}"
        return self.messenger.request("scp", relay_topic, payload,
                                      timeout=timeout)

    def register_handler(self, topic: str, fn) -> None:
        self.messenger.register_handler(f"job/{self.job_id}/{topic}", fn)

    # --------------------------------------------------------- tracking
    def summary_writer(self) -> SummaryWriter:
        """FLARE experiment tracking (paper §5.2): metrics stream to the
        server whether or not direct connections are enabled."""
        return SummaryWriter(self.messenger, "scp", self.job_id, self.site)


class CCP:
    def __init__(self, runtime, site: str, kit: StartupKit):
        self.runtime = runtime
        self.site = site
        self.kit = kit
        self.messenger = ReliableMessenger(
            runtime.network, f"ccp/{site}",
            retry_interval=runtime.retry_interval,
            default_timeout=runtime.request_timeout)
        self.messenger.register_handler("ccp/deploy", self._on_deploy)
        self.messenger.register_handler("ccp/stop", self._on_stop)
        self._job_threads: Dict[str, threading.Thread] = {}
        self._job_messengers: Dict[str, ReliableMessenger] = {}
        self._job_ctxs: Dict[str, JobContext] = {}
        self._errors: Dict[str, str] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ handlers
    def _on_deploy(self, msg: Message) -> bytes:
        job_id = msg.payload.decode()
        if not self.runtime.provisioner.verify(self.kit):
            return b"ERR: bad startup kit"
        try:
            spec = self.runtime._lookup_spec(job_id)
            client_app = spec.client_app_fn(self.site)
        except Exception as e:  # noqa: BLE001
            return f"ERR: {e}".encode()
        messenger = ReliableMessenger(
            self.runtime.network, f"{self.site}/job/{job_id}",
            retry_interval=self.runtime.retry_interval,
            default_timeout=self.runtime.request_timeout)
        ctx = JobContext(runtime=self.runtime, job_id=job_id, site=self.site,
                         messenger=messenger)

        def run():
            try:
                client_app.run(ctx)
            except Exception:  # noqa: BLE001
                with self._lock:
                    self._errors[job_id] = traceback.format_exc()

        t = threading.Thread(target=run, daemon=True,
                             name=f"{self.site}-job-{job_id}")
        with self._lock:
            self._job_threads[job_id] = t
            self._job_messengers[job_id] = messenger
            self._job_ctxs[job_id] = ctx
        t.start()
        return b"OK"

    def _on_stop(self, msg: Message) -> bytes:
        job_id = msg.payload.decode()
        with self._lock:
            t = self._job_threads.pop(job_id, None)
            messenger = self._job_messengers.pop(job_id, None)
            ctx = self._job_ctxs.pop(job_id, None)
        if ctx is not None:
            ctx.stop_event.set()
        if t is not None:
            t.join(timeout=2.0)
        if messenger is not None:
            messenger.close()
        return b"OK"

    def error(self, job_id: str) -> Optional[str]:
        with self._lock:
            return self._errors.get(job_id)

    def shutdown(self) -> None:
        self.messenger.close()
