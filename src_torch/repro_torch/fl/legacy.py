"""Seed (pre-flat-buffer) per-layer reference implementations.

Port of ``repro/fl/legacy.py``: the original O(clients x layers) Python-loop
strategy paths, kept for two purposes:

- **equivalence tests**: every vectorized strategy in
  :mod:`repro_torch.fl.strategy` must reproduce these outputs exactly or to
  within 1 ULP of the leaf dtype;
- **benchmark baselines**: the flat aggregation engine's speedup is
  measured against this path.

Do not "fix" or optimize anything here — being the slow-but-obviously-
correct reference is the point.  It stays numpy on the host.  The one
change from the JAX package's file is bfloat16: the port stores it as
its raw 16 bits (:func:`repro_torch.fl.flat.np_dtype`), so a leaf widens
through :func:`~repro_torch.fl.flat.bf16_to_f32` and narrows back through
:func:`~repro_torch.fl.flat.to_bf16` where the JAX package's ``astype``
relies on ``ml_dtypes``; every other dtype casts with ``astype`` as there.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.fl.flat import bf16_to_f32, is_bf16, to_bf16

NDArrays = List[np.ndarray]


def _f64(a: np.ndarray) -> np.ndarray:
    """``a.astype(np.float64)``, with bf16 bits widened as floats."""
    return (bf16_to_f32(a) if is_bf16(a.dtype) else a).astype(np.float64)


def _cast(x: np.ndarray, dtype: np.dtype) -> np.ndarray:
    """``x.astype(dtype)``, with bf16 rounded to nearest even from fp32."""
    return to_bf16(x) if is_bf16(dtype) else x.astype(dtype)


def legacy_weighted_average(results: List[Tuple[NDArrays, float]]) -> NDArrays:
    total = float(sum(w for _, w in results))
    out = [np.zeros_like(a, dtype=np.float64) for a in results[0][0]]
    for arrays, w in results:
        for i, a in enumerate(arrays):
            out[i] += (w / total) * _f64(a)
    return [_cast(o, results[0][0][i].dtype) for i, o in enumerate(out)]


class LegacyFedAvg:
    def __init__(self, min_fit_clients: int = 1):
        self.min_fit_clients = min_fit_clients

    def aggregate_fit(self, rnd, results, failures, current):
        if len(results) < self.min_fit_clients:
            raise RuntimeError(
                f"round {rnd}: {len(results)} results < min "
                f"{self.min_fit_clients} (failures: {failures})")
        agg = legacy_weighted_average(
            [(r.parameters, r.num_examples) for _, r in results])
        return agg, {"num_clients": len(results)}


class LegacyFedAvgM(LegacyFedAvg):
    def __init__(self, server_lr: float = 1.0, momentum: float = 0.9):
        super().__init__()
        self.server_lr = server_lr
        self.momentum = momentum
        self._velocity = None

    def aggregate_fit(self, rnd, results, failures, current):
        target, m = LegacyFedAvg.aggregate_fit(self, rnd, results, failures,
                                               current)
        delta = [_f64(t) - _f64(c) for t, c in zip(target, current)]
        if self._velocity is None:
            self._velocity = [np.zeros_like(d) for d in delta]
        self._velocity = [self.momentum * v + d
                          for v, d in zip(self._velocity, delta)]
        new = [_f64(c) + self.server_lr * v
               for c, v in zip(current, self._velocity)]
        return [_cast(n, c.dtype) for n, c in zip(new, current)], m


class _LegacyAdaptiveBase(LegacyFedAvg):
    def __init__(self, server_lr: float = 0.1, beta1: float = 0.9,
                 beta2: float = 0.99, tau: float = 1e-3):
        super().__init__()
        self.server_lr = server_lr
        self.beta1 = beta1
        self.beta2 = beta2
        self.tau = tau
        self._m = None
        self._v = None

    def _second_moment(self, v, d):
        raise NotImplementedError

    def aggregate_fit(self, rnd, results, failures, current):
        target, metrics = LegacyFedAvg.aggregate_fit(self, rnd, results,
                                                     failures, current)
        delta = [_f64(t) - _f64(c) for t, c in zip(target, current)]
        if self._m is None:
            self._m = [np.zeros_like(d) for d in delta]
            self._v = [np.full_like(d, self.tau ** 2) for d in delta]
        self._m = [self.beta1 * m + (1 - self.beta1) * d
                   for m, d in zip(self._m, delta)]
        self._v = [self._second_moment(v, d) for v, d in zip(self._v, delta)]
        new = [_f64(c) + self.server_lr * m / (np.sqrt(v) + self.tau)
               for c, m, v in zip(current, self._m, self._v)]
        return [_cast(n, c.dtype) for n, c in zip(new, current)], metrics


class LegacyFedAdam(_LegacyAdaptiveBase):
    def _second_moment(self, v, d):
        return self.beta2 * v + (1 - self.beta2) * np.square(d)


class LegacyFedYogi(_LegacyAdaptiveBase):
    def _second_moment(self, v, d):
        d2 = np.square(d)
        return v - (1 - self.beta2) * d2 * np.sign(v - d2)


class LegacyFedMedian(LegacyFedAvg):
    def aggregate_fit(self, rnd, results, failures, current):
        stacked = [np.median(np.stack([_f64(r.parameters[i])
                                       for _, r in results]), axis=0)
                   for i in range(len(results[0][1].parameters))]
        return ([_cast(s, current[i].dtype) for i, s in enumerate(stacked)],
                {"num_clients": len(results)})


class LegacyFedTrimmedMean(LegacyFedAvg):
    def __init__(self, beta: float = 0.2):
        super().__init__()
        self.beta = beta

    def aggregate_fit(self, rnd, results, failures, current):
        k = int(self.beta * len(results))
        out = []
        for i in range(len(results[0][1].parameters)):
            stack = np.sort(np.stack([_f64(r.parameters[i])
                                      for _, r in results]), axis=0)
            sl = stack[k:len(results) - k] if len(results) > 2 * k else stack
            out.append(_cast(np.mean(sl, axis=0), current[i].dtype))
        return out, {"num_clients": len(results), "trimmed_each_end": k}


class LegacyKrum(LegacyFedAvg):
    def __init__(self, num_byzantine: int = 0, num_selected: int = 1):
        super().__init__()
        self.num_byzantine = num_byzantine
        self.num_selected = num_selected

    def aggregate_fit(self, rnd, results, failures, current):
        vecs = [np.concatenate([_f64(a).ravel() for a in r.parameters])
                for _, r in results]
        n = len(vecs)
        f = min(self.num_byzantine, max(0, (n - 3) // 2))
        scores = []
        for i in range(n):
            d = sorted(float(np.sum((vecs[i] - vecs[j]) ** 2))
                       for j in range(n) if j != i)
            scores.append(sum(d[: max(n - f - 2, 1)]))
        chosen = np.argsort(scores)[: max(self.num_selected, 1)]
        sel = [(results[i][1].parameters, results[i][1].num_examples)
               for i in chosen]
        return legacy_weighted_average(sel), \
            {"krum_selected": [int(c) for c in chosen]}


LEGACY_TABLE = {
    "fedavg": LegacyFedAvg, "fedavgm": LegacyFedAvgM,
    "fedadam": LegacyFedAdam, "fedyogi": LegacyFedYogi,
    "fedmedian": LegacyFedMedian, "fedtrimmedmean": LegacyFedTrimmedMean,
    "krum": LegacyKrum,
}
