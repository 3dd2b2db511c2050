"""Local gRPC Client analogue (paper Fig. 4, server side).

The LGC lives in the FLARE server job process and completes relayed Flower
calls against the actual SuperLink (hop 4), sending results back down the
reliable path (hops 5–6).
"""
from __future__ import annotations

from repro_torch.utils import msgpack_lite

from repro_torch.core.framing import unpack_unary
from repro_torch.core.superlink import SuperLink
from repro_torch.runtime.ccp import JobContext
from repro_torch.runtime.reliable import RequestTimeout
from repro_torch.runtime.transport import Message


class LGC:
    def __init__(self, ctx: JobContext, superlink: SuperLink):
        self.link = superlink
        ctx.register_handler("flower/unary", self._on_unary)

    def _on_unary(self, msg: Message) -> bytes:
        method, request = unpack_unary(msg.payload)
        try:
            resp = self.link.fleet_unary(method, request)
            return msgpack_lite.packb({"r": resp, "e": ""}, use_bin_type=True)
        except Exception as e:  # noqa: BLE001
            # tag the error kind so the LGS can demote timeouts to a
            # retryable RequestTimeout instead of a fatal RuntimeError
            kind = ("timeout" if isinstance(e, (TimeoutError, RequestTimeout))
                    else "error")
            return msgpack_lite.packb({"r": b"", "e": repr(e), "k": kind},
                                 use_bin_type=True)
