"""FL strategies (the Flower ecosystem the FLARE side gains access to).

All public APIs still speak ``NDArrays`` (list of numpy arrays), but every
aggregation hot path now runs on :class:`~repro_torch.fl.flat.FlatParams` — one
contiguous buffer per model — through the vectorized kernels in
:mod:`repro_torch.fl.agg_kernels`:

- FedAvg is a cache-blocked weighted sum whose output is **bitwise
  identical** to the seed per-layer loop (see ``legacy.py``);
- FedAvgM / FedAdam / FedYogi keep their server state (velocity, moments)
  as single fp64 vectors and apply fused elementwise updates;
- FedMedian / FedTrimmedMean reduce chunk-stacked (clients, CHUNK) tiles;
- Krum computes all pairwise distances from one chunk-accumulated Gram
  matrix instead of the O(n^2) Python loop.

Strategies also expose :meth:`Strategy.fit_accumulator`, the incremental
aggregation protocol the ServerApp drives: results are folded in (or
referenced zero-copy) as they arrive instead of being stacked into
per-layer Python lists.  Aggregation stays deterministic and
ordering-insensitive up to the sorted client order the ServerApp enforces.

Implemented: FedAvg, FedAvgM (server momentum), FedAdam / FedYogi
(adaptive server optimizers, Reddi et al. 2021), FedProx (proximal client
regularization — the client reads ``config["proximal_mu"]``), robust
aggregation (coordinate-wise median, trimmed mean, Krum).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fl import agg_kernels as kernels
from repro_torch.fl.flat import (QCHUNK, FlatParams, dequantize_int8,
                                 quantize_int8, unflatten_vector)
from repro_torch.fl.messages import EvaluateIns, EvaluateRes, FitIns, FitRes

NDArrays = List[np.ndarray]


class QuorumNotMet(RuntimeError):
    """Raised at finalize when fewer successful results arrived than the
    strategy's failure-tolerance knob (``min_available`` /
    ``min_fit_clients``) allows.  Stragglers and dead nodes land in
    ``failures`` and the round continues — unless the quorum breaks."""


def _flat_of(res: FitRes):
    """The FitRes's zero-copy view — FlatParams for raw payloads, the
    still-compressed QuantParams for quantized ones (the kernels stream
    either through the fused ``f64_chunk`` protocol) — packing only if it
    has neither."""
    if res.partial is not None:
        # pre-reduced sums are not per-client updates; strategies that
        # need every update (median/trim/Krum, SecAgg) must not receive
        # them — the ServerApp only requests the edge tier when
        # strategy.supports_partial() says the fold is a weighted sum
        raise ValueError(
            "partial-aggregate result reached a per-client accumulator; "
            "this strategy cannot fold pre-reduced sums")
    if res.sparse is not None:
        # a structured-sparse delta (0xF5); StreamingWeightedSum.add
        # routes it to the O(nnz) scatter fold via its is_sparse attr
        return res.sparse
    if res.flat is not None:
        return res.flat
    if res.quant is not None:
        return res.quant
    return FlatParams.from_arrays(res.parameters)


def _check_shapes(fp, current: NDArrays, node: str) -> None:
    """Reject a result whose tensor shapes don't match the global model.

    Raised at ``add`` time so the ServerApp demotes the byzantine/buggy
    node to a per-node failure instead of crashing in the aggregation
    kernel at finalize (deferred kernels would otherwise surface the
    mismatch rounds of work later, aborting the run)."""
    got = [tuple(leaf.shape) for leaf in fp.layout.leaves]
    want = [tuple(a.shape) for a in current]
    if got != want:
        raise ValueError(
            f"node {node}: result shapes {got} != model shapes {want}")


def weighted_average(results: List[Tuple[NDArrays, float]],
                     backend: Optional[str] = None,
                     device: Optional[str] = None) -> NDArrays:
    """Weighted mean of NDArrays lists (flat fast path, legacy-exact), on
    ``backend`` and ``device`` as :func:`kernels.weighted_mean` takes them
    (None: the torch backend on the card)."""
    pairs = [(FlatParams.from_arrays(arrays), w) for arrays, w in results]
    return kernels.weighted_mean(pairs, pairs[0][0].layout, backend=backend,
                                 device=device).to_arrays()


# ---------------------------------------------------------------------------
# incremental aggregation protocol
# ---------------------------------------------------------------------------
class FitAccumulator:
    """Consumes FitRes one at a time; finalize() yields the new params.

    The base implementation simply collects and defers to the strategy's
    ``aggregate_fit`` — the compatibility path for strategies that only
    implement the batch API.
    """

    def __init__(self, strategy: "Strategy", rnd: int, current: NDArrays):
        self.strategy = strategy
        self.rnd = rnd
        self.current = current
        self.results: List[Tuple[str, FitRes]] = []

    def add(self, node: str, res: FitRes) -> None:
        self.results.append((node, res))

    def finalize(self, failures: List[Tuple[str, str]]
                 ) -> Tuple[NDArrays, Dict[str, Any]]:
        # results may have streamed in arrival order; canonicalize so the
        # aggregate is independent of who finished first (bitwise repro)
        self.results.sort(key=lambda nr: nr[0])
        for _, res in self.results:
            if res.parameters is None:
                # batch-API strategies predate the compressed wire format
                # and read res.parameters directly — honor that contract
                res.materialize()
        return self.strategy.aggregate_fit(self.rnd, self.results, failures,
                                           self.current)


class Strategy:
    def initialize_parameters(self) -> Optional[NDArrays]:
        return None

    def supports_partial(self) -> bool:
        """True when this strategy's fit aggregate is a weighted sum, so
        edge aggregators may pre-reduce their subtree into one
        partial-sum payload (0xF4).  Strategies that need every client's
        update (median/trimmed-mean/Krum, SecAgg) return False — the
        ServerApp then never requests the pre-reduction and edges fall
        back to forwarding a plain weighted-mean result."""
        return False

    def configure_fit(self, rnd: int, parameters: NDArrays,
                      nodes: Sequence[str]) -> Dict[str, FitIns]:
        return {n: FitIns(parameters, {"round": rnd}) for n in nodes}

    def fit_accumulator(self, rnd: int, current: NDArrays) -> FitAccumulator:
        """Incremental aggregation entry point used by the ServerApp."""
        return FitAccumulator(self, rnd, current)

    def aggregate_fit(self, rnd: int, results: List[Tuple[str, FitRes]],
                      failures: List[Tuple[str, str]],
                      current: NDArrays) -> Tuple[NDArrays, Dict[str, Any]]:
        raise NotImplementedError

    def configure_evaluate(self, rnd: int, parameters: NDArrays,
                           nodes: Sequence[str]) -> Dict[str, EvaluateIns]:
        return {n: EvaluateIns(parameters, {"round": rnd}) for n in nodes}

    def aggregate_evaluate(self, rnd: int,
                           results: List[Tuple[str, EvaluateRes]],
                           failures: List[Tuple[str, str]]
                           ) -> Tuple[Optional[float], Dict[str, Any]]:
        if not results:
            return None, {}
        total = sum(r.num_examples for _, r in results)
        loss = sum(r.loss * r.num_examples for _, r in results) / total
        metrics: Dict[str, Any] = {}
        keys = set()
        for _, r in results:
            keys |= set(r.metrics)
        for k in sorted(keys):
            vals = [(r.metrics[k], r.num_examples) for _, r in results
                    if k in r.metrics and isinstance(r.metrics[k], (int, float))]
            if vals:
                metrics[k] = sum(v * n for v, n in vals) / sum(n for _, n in vals)
        return float(loss), metrics


# ---------------------------------------------------------------------------
# FedAvg family (weighted-sum kernel + optional server optimizer)
# ---------------------------------------------------------------------------
class _WeightedFitAcc(FitAccumulator):
    """FedAvg-family accumulator.

    Default mode keeps zero-copy FlatParams references (no per-layer
    stacking; memory is just the already-received payload bytes) and runs
    the bitwise-legacy-exact deferred kernel at finalize.  ``low_memory``
    folds each result into one fp64 accumulator on arrival instead, so
    peak memory is a single model-size vector.
    """

    def __init__(self, strategy: "FedAvg", rnd: int, current: NDArrays):
        super().__init__(strategy, rnd, current)
        self.pairs: List[Tuple[str, FlatParams, float]] = []
        self.partials: List[Tuple[str, Any]] = []   # (node, PartialSum)
        self.sparses: List[Tuple[str, Any, float]] = []  # (node, SparseDelta, w)
        self._streaming: Optional[kernels.StreamingWeightedSum] = None
        self._count = 0
        self._payloads = 0

    def _make_streaming(self, layout) -> kernels.StreamingWeightedSum:
        st = self.strategy
        return kernels.StreamingWeightedSum(
            layout, backend=st.backend, device=st.device, shards=st.shards,
            mesh=st.shard_mesh, overlap=st.overlap_decode)

    def add(self, node: str, res: FitRes) -> None:
        if res.partial is not None:
            # edge-tier pre-reduced sum: buffered and folded in canonical
            # node order at finalize, so the aggregate is independent of
            # which edge finished first.  Counts its whole subtree toward
            # quorum.
            ps = res.partial
            _check_shapes(ps, self.current, node)
            self.partials.append((node, ps))
            self._count += ps.count
            self._payloads += 1
            return
        if res.sparse is not None:
            # structured-sparse delta (0xF5): buffered (O(nnz) bytes)
            # and folded in canonical node order at finalize so the
            # scatter fold is bitwise-invariant across arrival order
            sp = res.sparse
            _check_shapes(sp, self.current, node)
            self.sparses.append((node, sp, float(res.num_examples)))
            self._count += 1
            self._payloads += 1
            return
        fp = _flat_of(res)
        _check_shapes(fp, self.current, node)
        w = float(res.num_examples)
        st = self.strategy
        if st.low_memory or kernels.resolve_shards(st.shards, st.shard_mesh):
            # fold on arrival: order-dependent by <=1 ULP of the fp64
            # accumulator (invisible after the fp32 cast) — documented
            # trade for O(1)-model-size peak memory.  Sharding implies
            # streaming: the per-shard accumulators ARE the low-memory
            # server state.
            if self._streaming is None:
                self._streaming = self._make_streaming(fp.layout)
            self._streaming.add(fp, w)      # payload is droppable after this
        else:
            self.pairs.append((node, fp, w))
        self._count += 1        # only after the fold/append succeeded
        self._payloads += 1

    def finalize(self, failures: List[Tuple[str, str]]
                 ) -> Tuple[NDArrays, Dict[str, Any]]:
        st = self.strategy
        need = st.quorum()
        if self._count < need:
            raise QuorumNotMet(
                f"round {self.rnd}: {self._count} results < quorum "
                f"{need} (failures: {failures})")
        if self.partials or self.sparses:
            # any partial or sparse delta forces the streaming fold (a
            # pre-reduced sum has no per-client rows for the deferred
            # kernel; a sparse delta scatters into the fp64 accumulator):
            # leaves first in canonical node order, then sparse deltas,
            # then partials likewise — one edge over the whole fleet
            # continues the flat low-memory fold bitwise (acc = 0 + S_e;
            # one divide by W), and the sparse scatter is invariant
            # across arrival order by construction
            if self._streaming is None:
                layout = (self.partials[0][1].layout if self.partials
                          else self.sparses[0][1].layout)
                self._streaming = self._make_streaming(layout)
            self.pairs.sort(key=lambda p: p[0])
            for _, fp, w in self.pairs:
                self._streaming.add(fp, w)
            self.pairs = []
            self.sparses.sort(key=lambda s: s[0])
            for _, sp, w in self.sparses:
                self._streaming.add_sparse(sp, w)
            self.sparses = []
            self.partials.sort(key=lambda p: p[0])
            for _, ps in self.partials:
                self._streaming.add_partial(ps)
        if self._streaming is not None:
            target = self._streaming.finalize()
        else:
            # canonical node order -> aggregate independent of arrival order
            self.pairs.sort(key=lambda p: p[0])
            pairs = [(fp, w) for _, fp, w in self.pairs]
            target = kernels.weighted_mean(pairs, pairs[0][0].layout,
                                           backend=st.backend,
                                           device=st.device)
        metrics = {"num_clients": self._count,
                   "num_payloads": self._payloads}
        sub_failures = sorted(
            (n, r) for _, ps in self.partials for n, r in ps.failures)
        if sub_failures:
            # subtree failures the edges absorbed, surfaced round-level
            metrics["subtree_failures"] = [list(x) for x in sub_failures]
        return st._server_opt(self.rnd, target, self.current), metrics


@dataclass
class FedAvg(Strategy):
    initial_parameters: Optional[NDArrays] = None
    min_fit_clients: int = 1
    # failure-tolerance knob: how many *successful* results a round needs
    # before finalize may aggregate; the effective quorum is
    # max(min_fit_clients, min_available) (min_fit_clients is the seed
    # API, kept for compatibility).  Robust aggregators set min_available
    # to insist on a quorum — their byzantine tolerance assumes a minimum
    # population (Krum additionally floors it at 2f+3).
    min_available: int = 0
    low_memory: bool = False
    # aggregation kernel backend: "numpy" | "torch" | None (auto — the
    # torch path; see repro_torch.fl.agg_kernels "Backend dispatch").
    # ServerConfig.agg_backend sets it fleet-wide without touching
    # strategy construction.
    backend: Optional[str] = None
    # device the torch backend folds on (None = the CUDA card; "cpu" runs
    # the kernel's plain twin).  ServerConfig.agg_device sets it
    # fleet-wide.
    device: Optional[str] = None
    # server-state sharding: split the round accumulator (and any FedOpt
    # moments) into this many contiguous qchunk-aligned ranges — each
    # ~1/shards of the single-host fp64 footprint, folded by its own
    # per-shard fold.  None/0 keeps the single-host reference state.
    # ``shard_mesh`` (any object with ``axis_names`` and ``devices``)
    # derives the count from its "data" axis; on the torch backend shard
    # i's accumulator lives on ``shard_mesh.devices[i % len]`` (see
    # repro_torch.launch.mesh.make_agg_mesh), else on ``device``.
    # ServerConfig.agg_shards / shard_mesh set these fleet-wide.
    shards: Optional[int] = None
    shard_mesh: Optional[Any] = None
    # decode/reduce overlap for the sharded streaming fold: None = auto
    # (on for multi-core hosts), True/False forces (see
    # StreamingWeightedSum)
    overlap_decode: Optional[bool] = None

    def quorum(self) -> int:
        return max(self.min_fit_clients, self.min_available, 1)

    def _num_shards(self) -> int:
        return kernels.resolve_shards(self.shards, self.shard_mesh)

    def _shard_bounds(self, total: int):
        return kernels.shard_bounds(total, self._num_shards(), align=QCHUNK)

    def initialize_parameters(self):
        return self.initial_parameters

    def supports_partial(self) -> bool:
        # the weighted-sum pre-reduction is only sound when the fit
        # aggregate IS the weighted sum; a subclass that overrode the
        # batch API gets the conservative default
        return type(self).aggregate_fit is FedAvg.aggregate_fit

    def fit_accumulator(self, rnd, current):
        if type(self).aggregate_fit is not FedAvg.aggregate_fit:
            # subclass overrode the batch API only — honor it
            return FitAccumulator(self, rnd, current)
        return _WeightedFitAcc(self, rnd, current)

    def aggregate_fit(self, rnd, results, failures, current):
        acc = _WeightedFitAcc(self, rnd, current)
        for node, r in results:
            acc.add(node, r)
        return acc.finalize(failures)

    # hook: turn the weighted mean into the next global model
    def _server_opt(self, rnd: int, target: FlatParams,
                    current: NDArrays) -> NDArrays:
        return target.to_arrays()


@dataclass
class FedAvgM(FedAvg):
    server_lr: float = 1.0
    momentum: float = 0.9
    _velocity: Optional[np.ndarray] = field(default=None, repr=False)
    # sharded server state (one velocity vector per shard range) when
    # ``shards``/``shard_mesh`` is set; the update is elementwise, so the
    # sharded result is bitwise the single-vector one
    _shard_vel: Optional[list] = field(default=None, repr=False)

    def _server_opt(self, rnd, target, current):
        if self._num_shards():
            return self._server_opt_sharded(rnd, target, current)
        cur = FlatParams.from_arrays(current, target.layout).to_f64()
        delta = target.to_f64()
        delta -= cur
        if self._velocity is None:
            self._velocity = np.zeros_like(delta)
        self._velocity *= np.float64(self.momentum)
        self._velocity += delta
        cur += np.float64(self.server_lr) * self._velocity
        return unflatten_vector(cur, target.layout)

    def _server_opt_sharded(self, rnd, target, current):
        cur_fp = FlatParams.from_arrays(current, target.layout)
        bounds = self._shard_bounds(target.layout.total_size)
        if self._shard_vel is None:
            self._shard_vel = [np.zeros(hi - lo) for lo, hi in bounds]
        out = np.empty(target.layout.total_size, np.float64)
        mom, lr = np.float64(self.momentum), np.float64(self.server_lr)
        for (lo, hi), vel in zip(bounds, self._shard_vel):
            if hi <= lo:
                continue
            cur = cur_fp.f64_chunk(lo, hi, np.empty(hi - lo))
            delta = target.f64_chunk(lo, hi, np.empty(hi - lo))
            delta -= cur
            vel *= mom
            vel += delta
            cur += lr * vel
            out[lo:hi] = cur
        return unflatten_vector(out, target.layout)


@dataclass
class _AdaptiveBase(FedAvg):
    """Server-side adaptive optimizers (FedOpt family), fused over the
    flat fp64 state vectors.

    With ``shards``/``shard_mesh`` set, the ``_m``/``_v`` moments live as
    one vector per shard range (the same qchunk-aligned partition the
    streaming accumulator uses).  The update is elementwise, so the
    sharded trajectory is **bitwise** the single-vector one —
    ``tests/test_shard_agg.py`` pins it over multiple rounds.
    ``quantize_moments`` additionally stores each shard's moments as
    int8 + per-chunk fp32 scales (the PR 3 quant wire layout): ~1/8 the
    fp64 state footprint, at a per-coordinate error bounded by scale/2
    per round — opt-in for servers where moment memory binds.
    """

    server_lr: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.99
    tau: float = 1e-3
    quantize_moments: bool = False
    _m: Optional[np.ndarray] = field(default=None, repr=False)
    _v: Optional[np.ndarray] = field(default=None, repr=False)
    # per-shard [m, v] state; each entry a fp64 vector or, quantized,
    # an (int8 data, fp32 scales) tuple
    _shard_mv: Optional[list] = field(default=None, repr=False)

    def _second_moment(self, v: np.ndarray, d: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _load_moment(self, st, n: int, init: float) -> np.ndarray:
        if st is None:
            return np.full(n, init, np.float64)
        if isinstance(st, tuple):
            return dequantize_int8(st[0], st[1], QCHUNK)
        return st

    def _store_moment(self, vec: np.ndarray):
        if self.quantize_moments:
            return quantize_int8(vec)
        return vec

    def _server_opt(self, rnd, target, current):
        if self._num_shards():
            return self._server_opt_sharded(rnd, target, current)
        cur = FlatParams.from_arrays(current, target.layout).to_f64()
        d = target.to_f64()
        d -= cur
        if self._m is None:
            self._m = np.zeros_like(d)
            self._v = np.full_like(d, self.tau ** 2)
        self._m *= np.float64(self.beta1)
        self._m += np.float64(1 - self.beta1) * d
        self._v = self._second_moment(self._v, d)
        cur += np.float64(self.server_lr) * self._m \
            / (np.sqrt(self._v) + np.float64(self.tau))
        return unflatten_vector(cur, target.layout)

    def _server_opt_sharded(self, rnd, target, current):
        cur_fp = FlatParams.from_arrays(current, target.layout)
        bounds = self._shard_bounds(target.layout.total_size)
        if self._shard_mv is None:
            self._shard_mv = [[None, None] for _ in bounds]
        out = np.empty(target.layout.total_size, np.float64)
        b1 = np.float64(self.beta1)
        lr, tau = np.float64(self.server_lr), np.float64(self.tau)
        for (lo, hi), st in zip(bounds, self._shard_mv):
            if hi <= lo:
                continue
            n = hi - lo
            cur = cur_fp.f64_chunk(lo, hi, np.empty(n))
            d = target.f64_chunk(lo, hi, np.empty(n))
            d -= cur
            m = self._load_moment(st[0], n, 0.0)
            v = self._load_moment(st[1], n, self.tau ** 2)
            m *= b1
            m += np.float64(1 - self.beta1) * d
            v = self._second_moment(v, d)
            st[0] = self._store_moment(m)
            st[1] = self._store_moment(v)
            cur += lr * m / (np.sqrt(v) + tau)
            out[lo:hi] = cur
        return unflatten_vector(out, target.layout)


@dataclass
class FedAdam(_AdaptiveBase):
    def _second_moment(self, v, d):
        return np.float64(self.beta2) * v \
            + np.float64(1 - self.beta2) * np.square(d)


@dataclass
class FedYogi(_AdaptiveBase):
    def _second_moment(self, v, d):
        d2 = np.square(d)
        return v - np.float64(1 - self.beta2) * d2 * np.sign(v - d2)


@dataclass
class FedProx(FedAvg):
    """FedAvg aggregation; clients get proximal_mu in their fit config."""

    proximal_mu: float = 0.01

    def configure_fit(self, rnd, parameters, nodes):
        return {n: FitIns(parameters,
                          {"round": rnd, "proximal_mu": self.proximal_mu})
                for n in nodes}


# ---------------------------------------------------------------------------
# robust aggregation (stacked-tile kernels)
# ---------------------------------------------------------------------------
class _StackedFitAcc(FitAccumulator):
    """Keeps zero-copy flat references; finalize hands them to the
    strategy's stacked kernel in one call."""

    def __init__(self, strategy, rnd, current):
        super().__init__(strategy, rnd, current)
        self.entries: List[Tuple[str, FlatParams, float]] = []

    def add(self, node, res):
        if res.sparse is not None:
            # median/trim/Krum need every client's dense update row;
            # negotiation never picks "sparse" for these strategies
            # (supports_partial() is False), so a sparse arrival here is
            # a protocol violation — demote the node, don't misfold
            raise ValueError(
                "sparse-delta result reached a stacked accumulator; "
                "this strategy needs dense per-client updates")
        fp = _flat_of(res)
        _check_shapes(fp, self.current, node)
        self.entries.append((node, fp, float(res.num_examples)))

    def finalize(self, failures):
        need = self.strategy.quorum()
        if len(self.entries) < need:
            raise QuorumNotMet(
                f"round {self.rnd}: {len(self.entries)} results < quorum "
                f"{need} (failures: {failures})")
        # canonical node order -> aggregate independent of arrival order
        self.entries.sort(key=lambda e: e[0])
        nodes = [n for n, _, _ in self.entries]
        flats = [fp for _, fp, _ in self.entries]
        weights = [w for _, _, w in self.entries]
        return self.strategy._aggregate_flats(self.rnd, flats, weights,
                                              failures, nodes)


class _StackedStrategyMixin:
    def supports_partial(self) -> bool:
        return False    # median/trim/Krum need every client's update

    def fit_accumulator(self, rnd, current):
        return _StackedFitAcc(self, rnd, current)

    def aggregate_fit(self, rnd, results, failures, current):
        acc = _StackedFitAcc(self, rnd, current)
        for node, r in results:
            acc.add(node, r)
        return acc.finalize(failures)


@dataclass
class FedMedian(_StackedStrategyMixin, FedAvg):
    def _aggregate_flats(self, rnd, flats, weights, failures, nodes=None):
        out = kernels.median(flats, flats[0].layout, backend=self.backend,
                             device=self.device)
        return out.to_arrays(), {"num_clients": len(flats)}


@dataclass
class FedTrimmedMean(_StackedStrategyMixin, FedAvg):
    beta: float = 0.2      # fraction trimmed at each end

    def _aggregate_flats(self, rnd, flats, weights, failures, nodes=None):
        k = int(self.beta * len(flats))
        out = kernels.trimmed_mean(flats, flats[0].layout, k,
                                   backend=self.backend, device=self.device)
        return out.to_arrays(), {"num_clients": len(flats),
                                 "trimmed_each_end": k}


@dataclass
class Krum(_StackedStrategyMixin, FedAvg):
    """Multi-Krum (Blanchard et al. 2017): pick the update closest to its
    n-f-2 nearest neighbours; tolerates f byzantine clients."""

    num_byzantine: int = 0
    num_selected: int = 1

    def quorum(self) -> int:
        # Krum's tolerance of f byzantine clients assumes n >= 2f + 3
        # (Blanchard et al. 2017).  Under partial participation the round
        # must abort (QuorumNotMet) rather than silently clamp f and let a
        # byzantine survivor be selected.
        floor = 2 * self.num_byzantine + 3 if self.num_byzantine else 1
        return max(super().quorum(), floor)

    def _aggregate_flats(self, rnd, flats, weights, failures, nodes=None):
        layout = flats[0].layout
        D = kernels.krum_distances(flats, layout, backend=self.backend,
                                   device=self.device)
        scores = kernels.krum_scores(D, self.num_byzantine)
        chosen = np.argsort(scores)[: max(self.num_selected, 1)]
        sel = [(flats[i], weights[i]) for i in chosen]
        out = kernels.weighted_mean(sel, layout, backend=self.backend,
                                    device=self.device)
        # report node ids, not positions: positions depend on arrival order
        picked = ([nodes[i] for i in chosen] if nodes is not None
                  else [int(c) for c in chosen])
        return out.to_arrays(), {"krum_selected": picked}


def make_strategy(name: str, **kw) -> Strategy:
    table = {"fedavg": FedAvg, "fedavgm": FedAvgM, "fedadam": FedAdam,
             "fedyogi": FedYogi, "fedprox": FedProx, "fedmedian": FedMedian,
             "fedtrimmedmean": FedTrimmedMean, "krum": Krum}
    if name not in table:
        raise KeyError(f"unknown strategy {name!r}; have {sorted(table)}")
    return table[name](**kw)
