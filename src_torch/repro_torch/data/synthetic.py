"""Synthetic data sources.

The container has no datasets; we generate deterministic, *learnable*
synthetic corpora so FL experiments exhibit real convergence:

- :class:`SyntheticLMDataset` — token sequences from a per-site Markov chain
  (non-IID across sites by construction: each site gets its own transition
  matrix mixed with a shared one).  A model that learns reduces loss well
  below uniform entropy, so training curves are meaningful.
- :func:`make_classification` — gaussian-blob classification for the
  ``flower_quickstart`` CNN/MLP experiments (the paper's CIFAR analogue).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class SyntheticLMDataset:
    vocab_size: int
    seq_len: int
    num_sequences: int
    seed: int = 0
    site: int = 0
    non_iid_alpha: float = 0.5   # 0 = fully site-specific chain, 1 = shared

    def __post_init__(self):
        # Shared global bigram structure + site-specific perturbation.
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 256)  # latent chain over a reduced alphabet
        shared = rng.dirichlet(np.ones(v) * 0.3, size=v)
        site_rng = np.random.default_rng(self.seed * 9973 + self.site + 1)
        local = site_rng.dirichlet(np.ones(v) * 0.3, size=v)
        a = self.non_iid_alpha
        self._trans = a * shared + (1 - a) * local
        self._trans /= self._trans.sum(axis=1, keepdims=True)
        self._latent_v = v
        self._rng = np.random.default_rng(self.seed * 31337 + self.site)

    def __len__(self) -> int:
        return self.num_sequences

    def sample(self, batch: int) -> Dict[str, np.ndarray]:
        v = self._latent_v
        toks = np.empty((batch, self.seq_len + 1), np.int32)
        state = self._rng.integers(0, v, size=batch)
        toks[:, 0] = state
        for t in range(1, self.seq_len + 1):
            # vectorized chain step
            r = self._rng.random(batch)
            cdf = np.cumsum(self._trans[state], axis=1)
            state = (r[:, None] < cdf).argmax(axis=1)
            toks[:, t] = state
        # scatter latent alphabet into the real vocab deterministically
        stride = max(self.vocab_size // v, 1)
        toks = (toks * stride) % self.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(ds: SyntheticLMDataset, batch: int) -> Iterator[Dict[str, np.ndarray]]:
    while True:
        yield ds.sample(batch)


def make_classification(n: int, dim: int, classes: int, seed: int = 0,
                        site: int = 0, skew: float = 0.0, split: int = 0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs; `skew` tilts the class prior per site (label skew).

    ``split`` picks independent samples from the SAME class centers (0 =
    train, 1 = test) — centers depend only on ``seed``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(classes, dim)) * 3.0
    site_rng = np.random.default_rng(seed * 7919 + site * 2 + split)
    prior = np.ones(classes) / classes
    if skew > 0:
        prior = site_rng.dirichlet(np.ones(classes) * (1.0 - skew + 1e-3) * 10)
    y = site_rng.choice(classes, size=n, p=prior)
    x = centers[y] + site_rng.normal(size=(n, dim))
    return x.astype(np.float32), y.astype(np.int32)
