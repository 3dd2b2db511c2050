"""Provisioning: startup kits, identity, authn/authz (paper §2 benefits).

Real FLARE provisioning issues signed certificates per site; here a
:class:`Provisioner` issues :class:`StartupKit` objects carrying an HMAC
token over (project, site, role).  The runtime rejects registration or job
submission whose token does not verify — the simulated equivalent of mutual
TLS + the authorization policy.
"""
from __future__ import annotations

import hashlib
import hmac
import os
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class StartupKit:
    project: str
    site: str
    role: str                 # "server" | "client" | "admin"
    token: bytes

    def fingerprint(self) -> str:
        return hashlib.sha256(self.token).hexdigest()[:16]


class Provisioner:
    def __init__(self, project: str, secret: Optional[bytes] = None):
        self.project = project
        self._secret = secret or os.urandom(32)
        self._issued: Dict[str, StartupKit] = {}
        # authorization policy: role -> allowed actions
        self.policy = {
            "admin": {"submit_job", "abort_job", "list_jobs"},
            "server": {"aggregate", "relay"},
            "client": {"train", "relay"},
        }

    def _sign(self, site: str, role: str) -> bytes:
        msg = f"{self.project}|{site}|{role}".encode()
        return hmac.new(self._secret, msg, hashlib.sha256).digest()

    def issue(self, site: str, role: str) -> StartupKit:
        kit = StartupKit(self.project, site, role, self._sign(site, role))
        self._issued[site] = kit
        return kit

    def verify(self, kit: StartupKit) -> bool:
        if kit.project != self.project:
            return False
        return hmac.compare_digest(kit.token, self._sign(kit.site, kit.role))

    def authorize(self, kit: StartupKit, action: str) -> bool:
        return self.verify(kit) and action in self.policy.get(kit.role, set())

    # pairwise seeds for secure aggregation (derived from site identities —
    # in production this is a DH exchange; the HMAC stand-in is deterministic)
    def pairwise_seed(self, site_a: str, site_b: str) -> int:
        lo, hi = sorted([site_a, site_b])
        digest = hmac.new(self._secret, f"secagg|{lo}|{hi}".encode(),
                          hashlib.sha256).digest()
        return int.from_bytes(digest[:8], "big")
