"""Per-site data loaders with host-side double buffering (port of
``repro/data/loader.py``: numpy only, so a copy)."""
from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.data.synthetic import SyntheticLMDataset


class FederatedDataLoader:
    """Owns one :class:`SyntheticLMDataset` per site; yields site batches.

    A tiny prefetch thread keeps one batch ahead — the CPU-container analogue
    of a real input pipeline's host-to-device overlap.
    """

    def __init__(self, vocab_size: int, seq_len: int, num_sites: int,
                 batch_per_site: int, seed: int = 0, non_iid_alpha: float = 0.5,
                 prefetch: int = 2):
        self.num_sites = num_sites
        self.batch_per_site = batch_per_site
        self._sites = [
            SyntheticLMDataset(vocab_size, seq_len, num_sequences=1 << 30,
                               seed=seed, site=s, non_iid_alpha=non_iid_alpha)
            for s in range(num_sites)
        ]
        self._queues = [collections.deque() for _ in range(num_sites)]
        self._prefetch = prefetch
        self._lock = threading.Lock()

    def num_examples(self, site: int) -> int:
        # synthetic => "virtually infinite"; report a nominal epoch size
        return 50_000

    def next_batch(self, site: int) -> Dict[str, np.ndarray]:
        q = self._queues[site]
        with self._lock:
            while len(q) < self._prefetch:
                q.append(self._sites[site].sample(self.batch_per_site))
            return q.popleft()

    def site_iterator(self, site: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch(site)
