"""Federated partitioners (who owns which data); port of
``repro/data/partition.py`` (numpy only, so a copy)."""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(num_items: int, num_sites: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_items)
    return [np.sort(s) for s in np.array_split(idx, num_sites)]


def dirichlet_partition(labels: np.ndarray, num_sites: int, alpha: float = 0.5,
                        seed: int = 0, min_per_site: int = 1) -> List[np.ndarray]:
    """Label-skewed non-IID split (standard FL benchmark protocol)."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    site_idx: List[List[int]] = [[] for _ in range(num_sites)]
    for c in classes:
        idx_c = np.where(labels == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet(np.full(num_sites, alpha))
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for site, shard in enumerate(np.split(idx_c, cuts)):
            site_idx[site].extend(shard.tolist())
    # guarantee every site has something
    for s in range(num_sites):
        if len(site_idx[s]) < min_per_site:
            donor = int(np.argmax([len(x) for x in site_idx]))
            site_idx[s].extend(site_idx[donor][:min_per_site])
            del site_idx[donor][:min_per_site]
    return [np.sort(np.asarray(ix, np.int64)) for ix in site_idx]
