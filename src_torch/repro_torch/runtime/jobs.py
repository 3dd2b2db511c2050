"""Job model + resource-aware multi-job scheduler state (paper §3.1).

A job is deployed to all participating sites; its processes form a Job
Network that exists only for the job's lifetime.  Multiple jobs run
concurrently over the same server/clients without extra "ports" — topics
are namespaced ``job/<job_id>/...`` on the shared transport.
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional


class JobStatus(str, Enum):
    SUBMITTED = "SUBMITTED"
    SCHEDULED = "SCHEDULED"
    DEPLOYING = "DEPLOYING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ABORTED = "ABORTED"
    FAILED = "FAILED"


@dataclass
class JobSpec:
    name: str
    # the application bundle ("custom code deployment"): opaque factory
    # callables the CCP/SCP instantiate at deploy time.
    server_app_fn: Callable[[], Any]
    client_app_fn: Callable[[str], Any]     # site name -> ClientApp
    min_sites: int = 1
    resources: Dict[str, float] = field(default_factory=lambda: {"gpu": 1.0})
    timeout_s: float = 120.0
    job_id: str = field(default_factory=lambda: uuid.uuid4().hex[:10])


@dataclass
class JobRecord:
    spec: JobSpec
    status: JobStatus = JobStatus.SUBMITTED
    sites: List[str] = field(default_factory=list)
    result: Any = None
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def job_id(self) -> str:
        return self.spec.job_id


class ResourcePool:
    """Per-site resource accounting for the concurrent-job scheduler."""

    def __init__(self, capacity: Dict[str, float]):
        self.capacity = dict(capacity)
        self.used: Dict[str, float] = {k: 0.0 for k in capacity}
        self._lock = threading.Lock()

    def try_acquire(self, req: Dict[str, float]) -> bool:
        with self._lock:
            for k, v in req.items():
                if self.used.get(k, 0.0) + v > self.capacity.get(k, 0.0) + 1e-9:
                    return False
            for k, v in req.items():
                self.used[k] = self.used.get(k, 0.0) + v
            return True

    def release(self, req: Dict[str, float]) -> None:
        with self._lock:
            for k, v in req.items():
                self.used[k] = max(0.0, self.used.get(k, 0.0) - v)
