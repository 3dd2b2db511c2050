"""Token rows from the seed: a frozen copy of the program's per-site Markov
generator (``data/synthetic.py``, ``SyntheticLMDataset``), drawn for many
rows at once.

A latent chain over ``latent_vocab`` symbols mixes a transition matrix
shared by all sites with one of the site's own (``non_iid_alpha`` of the
shared one); its symbols are spread over the vocabulary by a fixed
stride.  Labels are the next token.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rows(vocab: int, seq_len: int, n: int, seed: int, site: int = 0,
         non_iid_alpha: float = 0.5, latent_vocab: int = 256
         ) -> Dict[str, np.ndarray]:
    """``n`` rows of ``seq_len`` tokens and their labels (int32)."""
    seed = int(seed)
    rng = np.random.default_rng(seed)
    v = min(vocab, latent_vocab)
    shared = rng.dirichlet(np.ones(v) * 0.3, size=v)
    local = np.random.default_rng(seed * 9973 + site + 1).dirichlet(
        np.ones(v) * 0.3, size=v)
    trans = non_iid_alpha * shared + (1 - non_iid_alpha) * local
    trans /= trans.sum(axis=1, keepdims=True)
    cdf = np.cumsum(trans, axis=1)
    draw = np.random.default_rng(seed * 31337 + site)
    toks = np.empty((n, seq_len + 1), np.int32)
    state = draw.integers(0, v, size=n)
    toks[:, 0] = state
    for t in range(1, seq_len + 1):
        r = draw.random(n)
        state = (r[:, None] < cdf[state]).argmax(axis=1)
        toks[:, t] = state
    toks = (toks * max(vocab // v, 1)) % vocab
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batches(vocab: int, seq_len: int, batch: int, count: int, seed: int,
            **kw) -> List[Dict[str, np.ndarray]]:
    """``count`` batches of ``batch`` rows each, no row repeated."""
    r = rows(vocab, seq_len, batch * count, seed, **kw)
    return [{k: np.ascontiguousarray(v[i * batch:(i + 1) * batch])
             for k, v in r.items()} for i in range(count)]
