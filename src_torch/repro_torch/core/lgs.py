"""Local gRPC Server analogue (paper Fig. 4, client side).

In the paper, each Flower SuperNode is re-pointed at a *Local gRPC Server*
(LGS) inside the FLARE client instead of the remote SuperLink; the LGS
forwards each gRPC unary call over FLARE's ReliableMessage to the FLARE
server, whose LGC completes the call against the real SuperLink.

Here the LGS is a :class:`FleetConnection` whose ``unary`` serializes the
call and sends it through the Job-Network (hops 1–3 of the six-hop path);
the response retraces hops 4–6.  The SuperNode is *unchanged* — it just
received a different connection object, exactly like pointing gRPC at
localhost.
"""
from __future__ import annotations

from repro_torch.utils import msgpack_lite

from repro_torch.core.framing import pack_unary
from repro_torch.core.superlink import FleetConnection
from repro_torch.runtime.ccp import JobContext
from repro_torch.runtime.reliable import RequestTimeout


class LGSConnection(FleetConnection):
    def __init__(self, ctx: JobContext):
        self.ctx = ctx

    def unary(self, method: str, request: bytes) -> bytes:
        # the canonical unary envelope (shared with repro_torch.core.framing's
        # socket transport tooling, which carries the same call as a
        # typed REQ header + raw body instead)
        payload = pack_unary(method, request)
        # hop 1: SuperNode -> LGS (this call); hops 2-3: FLARE client ->
        # FLARE server (reliable, SCP-relayed) -> LGC.  A ReliableMessage
        # RequestTimeout propagates as-is: the SuperNode treats it as
        # retryable and the server's round deadline records the miss as a
        # per-node failure — the round itself never aborts.
        resp = self.ctx.request("server", "flower/unary", payload)
        d = msgpack_lite.unpackb(resp, raw=False)
        if d.get("e"):
            if d.get("k") == "timeout":
                raise RequestTimeout(f"LGC timeout: {d['e']}")
            raise RuntimeError(f"LGC error: {d['e']}")
        return d["r"]
