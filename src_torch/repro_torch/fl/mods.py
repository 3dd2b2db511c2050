"""Client-side mods (Flower's built-in DP / SecAgg support, paper §1); port
of ``repro/fl/mods.py``.

Mods wrap the client's task handling: ``mod(task_ins, call_next) ->
task_res``.  They compose; ClientApp applies them outermost-first.

All three mods operate on the **flat buffer** (one contiguous vector per
model, :class:`~repro_torch.fl.flat.FlatParams`) rather than per-layer Python
loops: one L2 norm, one noise draw, one quantize pass per update.  SecAgg
mask *derivation* stays per-leaf (seed spawn keys) for bitwise wire
compatibility with older peers; only the application is vectorized.

- :class:`DPMod` — local DP: clip the client's model *delta* to an L2 bound
  and add gaussian noise (deterministic per (site, round) so experiments
  reproduce bitwise).
- :class:`SecAggMod` + :class:`SecAggFedAvg` — pairwise-mask secure
  aggregation with exact fixed-point arithmetic: each pair of sites derives
  a shared seed (from provisioning), masks are ±PRG(seed, round) in uint64
  mod-2^64 arithmetic over the whole flat buffer, so they cancel exactly in
  the server's sum and the server never sees an individual update.  The
  fused quantize+mask loop has a hand-written kernel
  (:func:`repro_torch.kernels.ops.secagg_mask`, int32 field); this mod
  keeps the reference's numpy uint64 field, so its masked shares are
  byte-identical to the reference's and a mixed fleet's masks cancel.  On
  the strategy's ``backend="torch"`` the server keeps the mod-2^64 sum on
  the strategy's ``device``.
- :class:`TopKCompressionMod` — magnitude Top-K delta sparsification,
  global over the flat delta (a single threshold for the whole model,
  which keeps the largest-magnitude coordinates regardless of layer).

Composition with the quantized wire codecs (0xF2/0xF3): mods run INSIDE
the mod chain on exact fp32 buffers; the negotiated lossy re-encode
happens once, after the chain, at the ClientApp boundary
(``ClientApp._maybe_compress``).  So DP noise/clipping and TopK
sparsification are applied exactly and only the final wire hop is
quantized, while SecAgg's masked shares — already in the quantized
**integer domain** (fixed-point uint64, masks cancelling mod 2^64) — are
not uniform fp32 and therefore ship on the lossless 0xF1 frame: pairwise
masks keep cancelling bit-exactly in the server's wrapping sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np

from repro_torch.fl import agg_kernels as kernels
from repro_torch.fl.flat import (FlatParams, layout_for, topk_indices,
                                 unflatten_vector)
from repro_torch.fl.messages import (TaskIns, TaskRes, decode_fit_ins,
                                     decode_fit_res, encode_fit_res)

NDArrays = List[np.ndarray]

QUANT_BITS = 16                      # fixed-point fractional bits
QUANT_SCALE = np.uint64(1) << QUANT_BITS


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _l2(arrays: NDArrays) -> float:
    return float(np.sqrt(sum(float(np.sum(np.square(a.astype(np.float64))))
                             for a in arrays)))


def _prg_mask(seed: int, round_: int, leaf: int, shape, positive: bool
              ) -> np.ndarray:
    rng = np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(round_, leaf)))
    m = rng.integers(0, np.iinfo(np.uint64).max, size=shape, dtype=np.uint64,
                     endpoint=True)
    return m if positive else (np.uint64(0) - m)


def _prg_mask_flat(seed: int, round_: int, layout, positive: bool
                   ) -> np.ndarray:
    """Whole-model mask as one vector.

    Derivation is deliberately kept per-leaf with the seed's
    ``spawn_key=(round, leaf)`` so masked shares stay **bitwise identical**
    to what older (per-array codec) peers produce — a mixed-version fleet's
    masks must still cancel mod 2^64.  Only the application is flat.
    """
    out = np.empty(layout.total_size, np.uint64)
    for i, spec in enumerate(layout.leaves):
        out[spec.eoffset:spec.eoffset + spec.size] = \
            _prg_mask(seed, round_, i, spec.shape, positive).ravel()
    return out


def quantize(a: np.ndarray) -> np.ndarray:
    q = np.round(a.astype(np.float64) * float(QUANT_SCALE)).astype(np.int64)
    return q.view(np.uint64) if q.dtype == np.int64 else q.astype(np.uint64)


def dequantize(q: np.ndarray, count: int = 1) -> np.ndarray:
    signed = q.astype(np.uint64).view(np.int64).astype(np.float64)
    return (signed / float(QUANT_SCALE)).astype(np.float32)


def _u64_layout(layout):
    return layout_for([("uint64", l.shape) for l in layout.leaves])


# ---------------------------------------------------------------------------
# DP mod
# ---------------------------------------------------------------------------
@dataclass
class DPMod:
    clip_norm: float = 1.0
    noise_multiplier: float = 0.0
    site_id: int = 0
    seed: int = 0

    def __call__(self, task: TaskIns, call_next) -> TaskRes:
        if task.task_type != "fit":
            return call_next(task)
        ins = decode_fit_ins(task.payload)
        res = call_next(task)
        if res.error:
            return res
        fit = decode_fit_res(res.payload)
        ofp = _flat_of(fit)
        layout = ofp.layout
        base = ins.flat if ins.flat is not None else \
            FlatParams.from_arrays(ins.parameters)
        i64 = base.to_f64()
        delta = ofp.to_f64()
        delta -= i64
        norm = float(np.sqrt(np.dot(delta, delta)))
        scale = min(1.0, self.clip_norm / max(norm, 1e-12))
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed,
                                   spawn_key=(self.site_id, task.round)))
        sigma = self.noise_multiplier * self.clip_norm
        delta *= np.float64(scale)
        if sigma > 0:
            delta += rng.normal(0.0, sigma, size=delta.shape)
        i64 += delta
        fit.set_parameters(unflatten_vector(i64, layout))
        fit.metrics = dict(fit.metrics, dp_clip_scale=scale, dp_pre_norm=norm)
        return TaskRes("fit", task.round, encode_fit_res(fit),
                       task_id=task.task_id)


# ---------------------------------------------------------------------------
# Secure aggregation
# ---------------------------------------------------------------------------
@dataclass
class SecAggMod:
    """Masks the (num_examples-weighted) quantized flat buffer."""

    site: str = ""
    peers: Sequence[str] = ()
    pairwise_seed_fn: Callable[[str, str], int] = None  # from provisioning

    def __call__(self, task: TaskIns, call_next) -> TaskRes:
        if task.task_type != "fit":
            return call_next(task)
        res = call_next(task)
        if res.error:
            return res
        fit = decode_fit_res(res.payload)
        fp = _flat_of(fit)
        x = fp.to_f64()
        x *= np.float64(fit.num_examples)
        q = quantize(x)
        for peer in self.peers:
            if peer == self.site:
                continue
            seed = self.pairwise_seed_fn(self.site, peer)
            q += _prg_mask_flat(seed, task.round, fp.layout,
                                positive=self.site < peer)
        masked = FlatParams(q.view(np.uint8), _u64_layout(fp.layout))
        fit.set_parameters(masked.to_arrays(), flat=masked)
        fit.metrics = dict(fit.metrics, secagg=1)
        return TaskRes("fit", task.round, encode_fit_res(fit),
                       task_id=task.task_id)


from repro_torch.fl.strategy import (FedAvg, FitAccumulator,  # noqa: E402
                                     _flat_of)  # (avoid cycle at import top)


class _SecAggFitAcc(FitAccumulator):
    """Streaming mod-2^64 sum: each masked share folds into one uint64
    accumulator on arrival (masks cancel exactly), so the server never
    holds more than one share beyond the accumulator.  On the strategy's
    torch backend the accumulator is an int64 tensor on its device, each
    share's uint64 bytes added as int64 (two's complement: the same bits
    as the uint64 sum, wrapping mod 2^64); it comes back to the host once,
    at finalize, where the numpy dequantize and divide run unchanged."""

    def __init__(self, strategy, rnd, current):
        super().__init__(strategy, rnd, current)
        self._acc = None
        self._layout = None
        self.total_w = 0.0
        self.count = 0
        self._on_torch = kernels.resolve_backend(strategy.backend) == "torch"

    def add(self, node, res):
        fp = _flat_of(res)
        if self._acc is None:
            self._layout = fp.layout
            if self._on_torch:
                import torch

                from repro_torch.device import resolve_device

                self._acc = torch.zeros(
                    fp.layout.total_size, dtype=torch.int64,
                    device=resolve_device(self.strategy.device))
            else:
                self._acc = np.zeros(fp.layout.total_size, np.uint64)
        if self._on_torch:
            from repro_torch.kernels import agg_reduce

            share = fp.math_view()
            if share.dtype != np.uint64:
                raise TypeError(f"node {node}: a SecAgg share is uint64, "
                                f"got {share.dtype}")
            self._acc.add_(agg_reduce.to_device(share.view(np.int64),
                                                self._acc.device))
        else:
            self._acc += fp.math_view()
        self.total_w += float(res.num_examples)
        self.count += 1

    def finalize(self, failures):
        if failures:
            raise RuntimeError(
                f"secure aggregation needs every masked share; missing "
                f"{[f for f, _ in failures]}")
        acc = self._acc
        if self._on_torch:
            from repro_torch.kernels import agg_reduce

            acc = agg_reduce.to_host(acc).view(np.uint64)
        vec = dequantize(acc) / self.total_w
        out = [vec[l.eoffset:l.eoffset + l.size].reshape(l.shape)
               .astype(np.float32) for l in self._layout.leaves]
        return out, {"num_clients": self.count, "secagg": 1}


@dataclass
class SecAggFedAvg(FedAvg):
    """Server side of the pairwise-mask protocol: SUM the masked uint64
    flat buffers (masks cancel exactly mod 2^64), then dequantize and
    divide by the total example count.  The sum runs where the strategy's
    ``backend`` and ``device`` say (``ServerConfig.agg_backend`` /
    ``agg_device`` set them fleet-wide)."""

    def fit_accumulator(self, rnd, current):
        return _SecAggFitAcc(self, rnd, current)

    def aggregate_fit(self, rnd, results, failures, current):
        acc = _SecAggFitAcc(self, rnd, current)
        for node, r in results:
            acc.add(node, r)
        return acc.finalize(failures)


# ---------------------------------------------------------------------------
# Top-K compression
# ---------------------------------------------------------------------------
@dataclass
class TopKCompressionMod:
    """Magnitude Top-K delta sparsification, applied as a DENSE result
    (the non-kept coordinates are reset to the round base — the wire
    frame is still full-size).  For actually-sparse wire bytes use the
    negotiated ``sparse`` codec (0xF5), which ships only the kept
    index/value streams and supersedes this mod for bandwidth; this mod
    remains useful composed with DP/SecAgg, which need dense buffers.

    Selection uses :func:`repro_torch.fl.flat.topk_indices` — exactly k
    coordinates, equal-magnitude ties broken by lowest index — so the
    kept set (and hence the aggregate) is bitwise reproducible across
    platforms.  The previous ``absd >= thresh`` mask kept EVERY tie at
    the threshold, making ``topk_kept_frac`` (and the result) depend on
    how many equal magnitudes the partition landed on."""

    fraction: float = 0.1

    def __call__(self, task: TaskIns, call_next) -> TaskRes:
        if task.task_type != "fit":
            return call_next(task)
        ins = decode_fit_ins(task.payload)
        res = call_next(task)
        if res.error:
            return res
        fit = decode_fit_res(res.payload)
        ofp = _flat_of(fit)
        layout = ofp.layout
        base = ins.flat if ins.flat is not None else \
            FlatParams.from_arrays(ins.parameters)
        i64 = base.to_f64()
        d = ofp.to_f64()
        d -= i64
        k = max(1, int(np.ceil(self.fraction * d.size)))
        idx = topk_indices(np.abs(d), k)
        keep = np.zeros(d.size, bool)
        keep[idx] = True
        i64 += d * keep
        fit.set_parameters(unflatten_vector(i64, layout))
        fit.metrics = dict(fit.metrics,
                           topk_kept_frac=idx.size / max(d.size, 1))
        return TaskRes("fit", task.round, encode_fit_res(fit),
                       task_id=task.task_id)
