"""FedBuff-style bounded-staleness buffered asynchronous aggregation.

Synchronous rounds pay the straggler tax: every version advance waits
for the slowest sampled node.  FedBuff (Nguyen et al., *Federated
Learning with Buffered Asynchronous Aggregation*, AISTATS 2022) instead
folds updates **as they arrive**: the server keeps one streaming
accumulator, folds each update with a staleness-discounted weight, and
advances the global version every ``buffer_k`` folds — continuously,
never in lockstep.

Semantics implemented here:

- **staleness** of an arriving update is ``server_version -
  trained_version`` (the version the client started from);
- updates staler than ``max_staleness`` are **dropped** (recorded, never
  folded) — the hard bound the property tests pin;
- folded updates are weighted ``num_examples * (1 + s) ** -exponent``
  (the polynomial discount from the paper, exponent 0.5 by default), so
  a stale update still contributes but cannot drag the average back;
- the fold itself reuses :class:`~repro_torch.fl.agg_kernels
  .StreamingWeightedSum` — including fused quantized reads and
  edge-tier partial sums (discount applied as the partial's scale) —
  and each advance runs the strategy's ``_server_opt`` hook, so FedAvgM
  momentum / FedAdam moments work unchanged in async mode.

Async aggregation is lossy **by design**: the result depends on arrival
order, unlike the sync path's canonicalized fold.  What stays invariant
(and tested): the staleness bound, the discount arithmetic, and the
per-window weighted mean given a fixed arrival sequence.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.fl import agg_kernels as kernels
from repro_torch.fl.messages import FitRes
from repro_torch.fl.strategy import _check_shapes, _flat_of

NDArrays = List  # List[np.ndarray]


class FedBuffBuffer:
    """Bounded-staleness buffered fold; one instance per async run.

    ``offer`` returns ``"folded"`` or ``"stale"``; ``ready()`` says a
    window is full; ``advance(current)`` finalizes the window through
    the strategy's server optimizer and bumps :attr:`version`.
    """

    def __init__(self, strategy, *, buffer_k: int = 2,
                 max_staleness: int = 4,
                 staleness_exponent: float = 0.5):
        if not getattr(strategy, "supports_partial", lambda: False)():
            raise ValueError(
                "async FedBuff folding needs a weighted-sum strategy "
                "(FedAvg family); robust/SecAgg strategies require full "
                "per-client rounds")
        if buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {buffer_k}")
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}")
        self.strategy = strategy
        self.buffer_k = int(buffer_k)
        self.max_staleness = int(max_staleness)
        self.staleness_exponent = float(staleness_exponent)
        self.version = 0
        self.folded = 0             # lifetime folds
        self.dropped = 0            # lifetime stale drops
        self.folded_staleness: List[int] = []   # staleness of every fold
        self._acc: Optional[kernels.StreamingWeightedSum] = None
        self._window = 0            # folds in the current window

    # ------------------------------------------------------------- folding
    def discount(self, staleness: int) -> float:
        """Polynomial staleness discount ``(1 + s) ** -exponent``."""
        return float((1.0 + float(staleness)) ** -self.staleness_exponent)

    def offer(self, node: str, res: FitRes, trained_version: int,
              current: Optional[NDArrays] = None) -> str:
        """Fold one arriving update, or drop it as too stale.

        ``trained_version`` is the server version whose parameters the
        node trained from.  Returns ``"folded"`` or ``"stale"``."""
        s = self.version - int(trained_version)
        if s < 0:
            raise ValueError(
                f"node {node}: trained_version {trained_version} is ahead "
                f"of server version {self.version}")
        if s > self.max_staleness:
            self.dropped += 1
            return "stale"
        disc = self.discount(s)
        if res.partial is not None:
            ps = res.partial
            if current is not None:
                _check_shapes(ps, current, node)
            if self._acc is None:
                self._acc = self._make_acc(ps.layout)
            self._acc.add_partial(ps, scale=disc)
        else:
            fp = _flat_of(res)
            if current is not None:
                _check_shapes(fp, current, node)
            if self._acc is None:
                self._acc = self._make_acc(fp.layout)
            self._acc.add(fp, float(res.num_examples) * disc)
        self.folded += 1
        self._window += 1
        self.folded_staleness.append(s)
        return "folded"

    def _make_acc(self, layout) -> kernels.StreamingWeightedSum:
        st = self.strategy
        return kernels.StreamingWeightedSum(
            layout, backend=st.backend, device=st.device, shards=st.shards,
            mesh=st.shard_mesh, overlap=st.overlap_decode)

    def ready(self) -> bool:
        return self._window >= self.buffer_k

    # ------------------------------------------------------------- advance
    def advance(self, current: NDArrays
                ) -> Tuple[NDArrays, Dict[str, Any]]:
        """Finalize the buffered window into the next global model via
        the strategy's server optimizer; bumps :attr:`version` and opens
        a fresh window."""
        if self._window == 0 or self._acc is None:
            raise RuntimeError("advance() on an empty FedBuff window")
        target = self._acc.finalize()
        new = self.strategy._server_opt(self.version, target, current)
        self.version += 1
        window = self._window
        self._acc = None
        self._window = 0
        metrics = {
            "server_version": self.version,
            "window_folds": window,
            "async_folded": self.folded,
            "async_dropped_stale": self.dropped,
            "max_folded_staleness": max(self.folded_staleness, default=0),
        }
        return new, metrics
