"""Population registry: who is in the fleet, and who actually shows up.

At fleet scale a round samples ``k`` of ``N`` nodes instead of fanning
out to everyone (Flower's scalability recipe; the FLARE runtime's tiered
deployments assume the same).  :class:`PopulationRegistry` keeps a tiny
per-node success/failure history — fed by the per-node failure records
the ServerApp's ``_exchange`` already produces — and draws each round's
participants with probability proportional to a Laplace-smoothed
availability estimate, so flaky nodes are demoted (but never starved:
``min_weight`` keeps every node eligible).

Determinism: sampling must be reproducible across runs and independent
of dict/arrival order, so draws use ``np.random.default_rng`` seeded
from ``(seed, round)`` via ``SeedSequence`` over the *sorted* node list
— same seed, same history, same round => same sample (the det-entropy
rule in :mod:`repro_torch.analysis` bans ambient entropy here).  No clocks:
history is event-counting only, so replaying a run replays its samples.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np


class PopulationRegistry:
    """Availability-tracked population with seed-deterministic sampling.

    ``observe(successes, failures)`` feeds one round's outcome;
    ``sample(nodes, k, rnd)`` draws ``k`` distinct nodes weighted by
    ``availability(node)`` — the Laplace estimate ``(s+1)/(s+f+2)``,
    floored at ``min_weight`` so a node with a bad streak keeps a
    nonzero chance to rejoin (its estimate recovers as it succeeds).
    """

    def __init__(self, seed: int = 0, min_weight: float = 0.05):
        if not 0.0 < min_weight <= 1.0:
            raise ValueError(f"min_weight must be in (0, 1], got {min_weight}")
        self.seed = int(seed)
        self.min_weight = float(min_weight)
        self._success: Dict[str, int] = {}
        self._failure: Dict[str, int] = {}
        self._last_error: Dict[str, str] = {}

    # ------------------------------------------------------------- history
    def observe(self, successes: Iterable[str] = (),
                failures: Iterable[Tuple[str, str]] = ()) -> None:
        """Record one round's outcome: node ids that responded, and the
        ServerApp's per-node ``(node, reason)`` failure records."""
        for n in successes:
            self._success[n] = self._success.get(n, 0) + 1
        for n, reason in failures:
            self._failure[n] = self._failure.get(n, 0) + 1
            self._last_error[n] = str(reason)

    def availability(self, node: str) -> float:
        """Laplace-smoothed success rate in [0, 1]; 0.5 for unseen nodes."""
        s = self._success.get(node, 0)
        f = self._failure.get(node, 0)
        return (s + 1.0) / (s + f + 2.0)

    def weight(self, node: str) -> float:
        return max(self.availability(node), self.min_weight)

    def snapshot(self, nodes: Sequence[str]) -> Dict[str, Dict[str, object]]:
        """Per-node history view (successes, failures, availability,
        last error) for logging/metrics."""
        out: Dict[str, Dict[str, object]] = {}
        for n in sorted(nodes):
            out[n] = {"successes": self._success.get(n, 0),
                      "failures": self._failure.get(n, 0),
                      "availability": self.availability(n),
                      "last_error": self._last_error.get(n, "")}
        return out

    # ------------------------------------------------------------ sampling
    def sample(self, nodes: Sequence[str], k: int, rnd: int) -> List[str]:
        """Draw ``min(k, len(nodes))`` distinct nodes, availability-
        weighted, deterministic in ``(seed, rnd, sorted(nodes),
        history)``.  Returned sorted (the ServerApp's canonical order)."""
        pool = sorted(nodes)
        if k >= len(pool):
            return pool
        if k <= 0:
            raise ValueError(f"sample_k must be >= 1, got {k}")
        w = np.array([self.weight(n) for n in pool], np.float64)
        p = w / w.sum()
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, int(rnd))))
        idx = rng.choice(len(pool), size=k, replace=False, p=p)
        return sorted(pool[i] for i in idx)
