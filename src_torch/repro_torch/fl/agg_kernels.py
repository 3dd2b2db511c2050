"""Vectorized aggregation kernels over flat parameter buffers.

Every strategy's per-layer Python loop reduces to one of four kernels over
the (clients x total_params) logical matrix, all cache-blocked on a
``CHUNK``-element window so the float64 accumulator and scratch stay
resident in L2 while the loop streams each client's fp32 view exactly once:

- :func:`weighted_mean` — FedAvg's sum((w_i/W) * x_i).  The per-client
  weight is folded to ``np.float64(w_i / W)`` up front, which both removes
  the final rescale pass and (because the ops and their order match the
  legacy per-layer loop elementwise) keeps the result **bitwise identical**
  to the legacy implementation.
- :class:`StreamingWeightedSum` — the same reduction, but folding each
  client in as it arrives and releasing the payload; peak memory is one
  float64 accumulator instead of every client's update. sum(w_i x_i)/W
  differs from the fold by <=1 ULP of the fp64 accumulator (invisible
  after the fp32 cast).  With ``shards=N`` (or a mesh) the accumulator
  splits into N qchunk-aligned ranges — decode/reduce overlap, deferred
  delta bases; see the class docstring.
- :func:`median` / :func:`trimmed_mean` — coordinate-wise robust
  aggregation on a chunk-stacked (n, CHUNK) float64 tile (peak extra
  memory O(n * CHUNK), not O(n * total)).
- :func:`krum_distances` — all pairwise squared L2 distances via a
  chunk-accumulated Gram matrix: ||a-b||^2 = ||a||^2 + ||b||^2 - 2<a,b>,
  one dgemm per chunk instead of the O(n^2) Python loop over full vectors.

Every kernel reads its inputs through the chunked ``f64_chunk(lo, hi,
out)`` protocol, which both :class:`~repro_torch.fl.flat.FlatParams` (raw
buffers) and :class:`~repro_torch.fl.flat.QuantParams` (int8/bf16 compressed
wire payloads) implement.  For quantized inputs the dequantize + scale
(+ delta-base add) is **fused into the per-chunk read**, so accumulators
consume compressed buffers directly — peak extra memory stays one
CHUNK-sized fp64 scratch, never a model-size fp32 copy of the payload.

NB (numpy>=2 / NEP 50): scalar weights MUST be ``np.float64`` — a bare
python float is "weak" and would demote the multiply to the fp32 loop,
silently breaking the exactness guarantee.

Backend dispatch
----------------
Every public kernel takes ``backend="numpy" | "torch" | None`` (None /
"auto" resolves to :func:`default_backend`: "torch", overridable with
``REPRO_AGG_BACKEND`` or :func:`set_default_backend`), then the
reference's ``block`` in its positional slot (its Pallas column block; the
CUDA kernels choose their own, so it has no effect here, and a
non-positive one raises), then a ``device`` (None means the CUDA card; see
:func:`repro_torch.device.resolve_device`).  The contract:

- the numpy path is the reference, carried over verbatim from the JAX
  package's engine; its arithmetic is frozen (the fig. 5 bitwise-repro
  claim rides on it);
- the torch path reduces on the given device through the hand-written
  CUDA kernels of :mod:`repro_torch.kernels.agg_reduce` for a CUDA device,
  their plain PyTorch twins for the CPU: ``weighted_sum`` (weighted mean,
  streaming and sharded folds, finalize's deferred bases),
  ``scatter_wsum`` (the 0xF5 sparse fold), ``sort_reduce`` (median,
  trimmed mean) and ``gram`` (Krum's distances).  All but ``gram`` are
  **bitwise** equal to the numpy path (no FMA contraction, clients or
  sorted rows added in order, numpy's +0.0 start of a sum);
  ``tests/test_torch_agg.py``, ``tests/test_torch_robust.py``,
  ``tests/test_torch_shard_agg.py`` and ``tests/test_torch_sparse.py``
  hold them to it across layouts, dtypes, codecs (0xF1/0xF2/0xF3 incl.
  int8 deltas, 0xF4, 0xF5), shard counts and client counts.  Krum's
  distances match to a tolerance and its selection exactly; the sharded
  fold's opt-in fp32 tiles to a relative tolerance;
- the torch path never reduces on the host.  A round whose clients differ
  in codec, dtype, int8 scale window or delta base folds as one launch
  per run of consecutive like clients, each run continuing the previous
  one's accumulator (the numpy path's order, so still bitwise); the
  robust reductions decode each run into its rows of one fp64 stack on
  the device (``decode_rows``) and reduce that stack in one launch, the
  numpy path's per-client decode, so still bitwise;
- integer-domain payloads (SecAgg's uint64 shares) have no weighted sum
  and raise ``NotImplementedError`` on the torch backend; SecAgg's
  wrapping sum folds them (``fl/mods.py``).
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fl.flat import (QCHUNK, FlatParams, Layout, TileSource,
                                 memo_token, np_dtype, to_bf16)
from repro_torch.sharding import agg_spec, shard_bounds  # noqa: F401

# 16K elements: chunk fp64 accumulator + scratch = 256 KiB, L2-resident.
# QCHUNK (int8 scale window) divides CHUNK, so quantized reads stay aligned.
CHUNK = 1 << 14

_FLOATS = {"float16", "float32", "float64"}

# ---------------------------------------------------------------------------
# backend selection
# ---------------------------------------------------------------------------
BACKENDS = ("numpy", "torch")
_DEFAULT_BACKEND: Optional[str] = None


def default_backend() -> str:
    """Resolved process default: ``REPRO_AGG_BACKEND`` if set, else
    "torch"."""
    global _DEFAULT_BACKEND
    if _DEFAULT_BACKEND is None:
        env = os.environ.get("REPRO_AGG_BACKEND", "").strip().lower()
        if env and env not in BACKENDS:
            raise ValueError(
                f"REPRO_AGG_BACKEND={env!r}; expected one of {BACKENDS}")
        _DEFAULT_BACKEND = env or "torch"
    return _DEFAULT_BACKEND


def set_default_backend(name: Optional[str]) -> None:
    """Override (or with ``None`` re-derive) the process default."""
    global _DEFAULT_BACKEND
    if name is not None and name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {BACKENDS}")
    _DEFAULT_BACKEND = name


def resolve_backend(backend: Optional[str]) -> str:
    if backend in (None, "auto"):
        return default_backend()
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    return backend


def _check_block(block: Optional[int]) -> None:
    """The reference's ``block``: None, or a positive column block."""
    if block is not None and int(block) < 1:
        raise ValueError(f"block must be None or a positive column block, "
                         f"got {block}")


def _host_cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def resolve_shards(shards: Optional[int], mesh=None) -> int:
    """Shard count for the server aggregation state: an explicit count
    wins; otherwise the mesh's "data" axis size (total device count for
    meshes without one).  0 means single-host (legacy) state."""
    if shards:
        if shards < 0:
            raise ValueError(f"shards must be >= 1, got {shards}")
        return int(shards)
    if mesh is None:
        return 0
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return int(sizes.get("data", mesh.devices.size))


def _tile(fp, lo: int = 0, hi: Optional[int] = None) -> TileSource:
    """One payload's kernel operands (a :class:`~repro_torch.fl.flat
    .TileSource`), of its element range ``[lo, hi)`` when ``hi`` is given
    (the sharded fold's shard ranges).  A payload the kernel cannot take
    raises: the torch backend never folds on the host."""
    if getattr(fp, "is_sparse", False):
        raise TypeError(
            "a 0xF5 sparse delta has no dense rows: it folds through "
            "StreamingWeightedSum.add_sparse (the scatter_wsum kernel)")
    ts = getattr(fp, "tile_source", None)
    if ts is None:
        raise TypeError(
            f"{type(fp).__name__} has no tile_source(): the torch backend "
            "folds FlatParams and QuantParams payloads; use backend='numpy'")
    src = ts() if hi is None else ts(lo, hi)
    if src is not None:
        return src
    if getattr(fp, "is_delta", False) and getattr(fp, "base", None) is None:
        raise ValueError(
            "delta-encoded payload needs its round base attached "
            "(QuantParams.base) before it can be read")
    if getattr(fp, "mode", None) == "q8" and lo % fp.qchunk:
        raise ValueError(
            f"the int8 scale windows of {fp.qchunk} elements straddle the "
            f"range edge at {lo}")
    raise NotImplementedError(
        f"the torch backend's weighted sum folds float payloads, not "
        f"{fp.layout.uniform_dtype} ones; SecAgg's uint64 shares fold in "
        "SecAggFedAvg's wrapping sum (fl/mods.py); use backend='numpy'")


def _launch_runs(sources: Sequence[TileSource]) -> List[Tuple[int, int]]:
    """``[lo, hi)`` runs of consecutive clients that one launch can fold:
    the same codec, payload dtype, int8 scale window and delta base."""
    runs, lo = [], 0
    for i in range(1, len(sources)):
        a, b = sources[lo], sources[i]
        if not (a.kind == b.kind and a.data.dtype == b.data.dtype
                and a.base is b.base
                and (a.kind != "q8" or a.qchunk == b.qchunk)):
            runs.append((lo, i))
            lo = i
    runs.append((lo, len(sources)))
    return runs


def _device_stack(sources: Sequence, device,
                  base_memo: Dict[str, Any]) -> Dict[str, Any]:
    """Copy the client payloads straight into one (C, N) device tensor
    (row by row: no host-side stack) plus the (C, S) int8 scales.  A delta
    base goes to the device once: ``base_memo`` maps its
    :func:`~repro_torch.fl.flat.memo_token` to the fp64 device copy."""
    from repro_torch.kernels import agg_reduce

    first = sources[0]
    data = agg_reduce.stack_to_device([s.data for s in sources], device)
    scales = None
    if first.kind == "q8":
        scales = agg_reduce.stack_to_device([s.scales for s in sources],
                                            device)
    base = None
    if first.base is not None:
        tok = memo_token(first.base)
        base = base_memo.get(tok)
        if base is None:
            base = base_memo[tok] = agg_reduce.to_device(
                first.base.to_f64(), device)
    return {"data": data, "scales": scales,
            "qchunk": first.qchunk if first.kind == "q8" else 1,
            "base": base}


def _scatter_leaves(vec: np.ndarray, layout: Layout,
                    out: FlatParams) -> None:
    """Write a full math vector into ``out`` leaf by leaf, casting to each
    leaf's dtype — the one shared rounding path for every kernel's
    non-uniform (or vector-producing) output."""
    for i, spec in enumerate(layout.leaves):
        seg = vec[spec.eoffset:spec.eoffset + spec.size].reshape(spec.shape)
        out.leaf(i)[...] = (to_bf16(seg) if spec.dtype == "bfloat16"
                            else seg.astype(np_dtype(spec.dtype)))


def _vec_to_flat(vec: np.ndarray, layout: Layout) -> FlatParams:
    """fp64 math vector -> FlatParams, with the same per-element rounding
    the numpy kernels apply when writing their output chunks."""
    out = FlatParams.zeros(layout)
    if layout.uniform_dtype in _FLOATS:
        out.math_view()[...] = vec
    else:
        _scatter_leaves(vec, layout, out)
    return out


def weighted_mean(pairs: Sequence[Tuple[FlatParams, float]],
                  layout: Layout, backend: Optional[str] = None,
                  block: Optional[int] = None, device=None) -> FlatParams:
    """sum((w_i / W) x_i) over flat buffers -> FlatParams of ``layout``.

    Chunk-outer / client-inner: the fp64 accumulator chunk is reused across
    clients and cast straight into the output buffer, so no total-size fp64
    array is ever materialized.  On the torch backend the (C, N) stack
    goes to ``device`` and folds in one kernel launch (one per run of like
    clients when the round mixes codecs, see :func:`_launch_runs`).
    """
    _check_block(block)
    total_w = float(sum(w for _, w in pairs))
    scaled = [np.float64(w / total_w) for _, w in pairs]
    out = FlatParams.zeros(layout)
    n = layout.total_size
    if n == 0 or not pairs:
        return out
    if resolve_backend(backend) == "torch":
        from repro_torch.device import resolve_device
        from repro_torch.kernels import agg_reduce

        dev = resolve_device(device)
        sources = [_tile(fp) for fp, _ in pairs]
        w = agg_reduce.to_device(np.array(scaled, np.float64), dev)
        vec, bases = None, {}
        # the first run starts the sum from its first client's term, the
        # rest continue it: the numpy loop's order below
        for lo, hi in _launch_runs(sources):
            stack = _device_stack(sources[lo:hi], dev, bases)
            vec = agg_reduce.weighted_sum(
                stack["data"], w[lo:hi], scales=stack["scales"],
                qchunk=stack["qchunk"], base=stack["base"], acc=vec)
        return _vec_to_flat(agg_reduce.to_host(vec), layout)
    uniform = layout.uniform_dtype in _FLOATS
    ovec = out.math_view() if uniform else np.empty(n, np.float64)
    acc = np.empty(CHUNK, np.float64)
    scratch = np.empty(CHUNK, np.float64)
    tmp = np.empty(CHUNK, np.float64)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        a = acc[:hi - lo]
        x0 = pairs[0][0].f64_chunk(lo, hi, tmp)
        np.multiply(x0, scaled[0], out=a)
        for (fp, _), sw in zip(pairs[1:], scaled[1:]):
            x = fp.f64_chunk(lo, hi, tmp)
            np.multiply(x, sw, out=scratch[:hi - lo])
            a += scratch[:hi - lo]
        ovec[lo:hi] = a
    if not uniform:
        _scatter_leaves(ovec, layout, out)
    return out


class _DecodePipeline:
    """Decode/reduce overlap for the sharded streaming fold.

    One decoder thread pulls arrivals off a depth-1 job queue, streams
    each shard's range through the payload's ``decode_chunk`` into a
    slot from a small ring of reusable shard-size fp64 buffers, scales
    by the arrival weight, and hands (shard, buffer) to the caller's
    thread, which folds it into the per-shard accumulator — so the codec
    decode of arrival k+1 runs while arrival k is being reduced.  The
    job queue bounds live payload references at two (the one decoding
    plus the one queued: double buffering); the ring bounds decoded-but-
    unfolded data at ``nslots`` shard ranges.

    Ordering: one decoder + FIFO queues keep the (arrival, shard) fold
    order identical to the serial loop, so the result is bitwise equal
    to the non-overlapped fold.  A decoder exception is re-raised on the
    caller's thread at the next submit/drain and kills the pipeline (and
    so the round) — payload validation (shape checks, delta-base attach)
    happens before submit, so this path is reserved for genuinely
    malformed buffers.
    """

    def __init__(self, bounds: Sequence[Tuple[int, int]], nslots: int = 3):
        self._shards = [(si, lo, hi)
                        for si, (lo, hi) in enumerate(bounds) if hi > lo]
        maxm = max((hi - lo for _, lo, hi in self._shards), default=0)
        self._pool: "queue.Queue[np.ndarray]" = queue.Queue()
        for _ in range(nslots):
            self._pool.put(np.empty(maxm, np.float64))
        self._jobs: "queue.Queue" = queue.Queue(maxsize=1)
        self._out: "queue.Queue" = queue.Queue()
        self._failed = False
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="agg-decode", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                self._out.put(None)
                return
            dec, sw = job
            try:
                for si, lo, hi in self._shards:
                    buf = self._pool.get()
                    for a in range(lo, hi, CHUNK):
                        b = min(a + CHUNK, hi)
                        o = buf[a - lo:b - lo]
                        dec(a, b, o)
                        o *= sw     # rounds like multiply-into-scratch
                    self._out.put((si, buf, hi - lo))
            except BaseException as e:  # noqa: BLE001 — forwarded to caller
                self._out.put(e)
                return

    def submit(self, dec, sw: np.float64, fold) -> None:
        if self._failed or self._closed:
            raise RuntimeError("aggregation decode pipeline is closed")
        while True:
            try:
                self._jobs.put_nowait((dec, sw))
                break
            except queue.Full:
                self._fold_next(fold, block=True)
        while self._fold_next(fold, block=False):
            pass

    def _fold_next(self, fold, block: bool) -> bool:
        try:
            item = self._out.get(block=block)
        except queue.Empty:
            return False
        if item is None:            # close sentinel: keep it for drain()
            self._out.put(None)
            return False
        if isinstance(item, BaseException):
            self._failed = True
            raise item
        si, buf, m = item
        try:
            fold(si, buf, m)
        finally:
            self._pool.put(buf)
        return True

    def drain(self, fold) -> None:
        """Close the job stream and fold everything still in flight."""
        if self._failed:
            raise RuntimeError("aggregation decode pipeline failed")
        if not self._closed:
            self._closed = True
            while True:
                # a plain blocking put could deadlock: the decoder may be
                # waiting on a ring slot only this thread can return
                try:
                    self._jobs.put_nowait(None)
                    break
                except queue.Full:
                    self._fold_next(fold, block=True)
        while True:
            item = self._out.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                self._failed = True
                self._thread.join(timeout=10.0)
                raise item
            si, buf, m = item
            fold(si, buf, m)
            self._pool.put(buf)
        self._thread.join(timeout=10.0)


class StreamingWeightedSum:
    """Incremental sum(w_i x_i); finalize() divides by W and casts.

    Two modes:

    **Single-host (default, ``shards=None``)** — the frozen reference
    semantics: one fp64 accumulator, every arrival folded through
    ``f64_chunk`` (delta payloads reconstructed per arrival).  On the
    torch backend each arrival is one fused dequantize+scale+accumulate
    kernel launch, and the accumulator is **one fp64 tensor on the
    device, kept for the whole round** (zeros, as in the numpy path).
    An arrival the kernel cannot take raises (see :func:`_tile`).

    **Sharded (``shards=N`` or ``mesh=...``)** — the round's accumulator
    splits into N contiguous qchunk-aligned ranges (:func:`shard_bounds`
    over the mesh "data" axis), so per-shard memory is ~1/N of the
    single-host fp64 footprint; the all-gather into the output buffer
    happens once, at :meth:`finalize`.  Delta payloads are folded
    **base-deferred**: sum_k w_k (d_k + b) == sum_k w_k d_k + W b, so the
    fold streams only the compressed delta and the fp64 base is read once
    per round at finalize instead of once per arrival.  On the numpy
    backend a decoder thread (:class:`_DecodePipeline`) decodes arrival
    k+1 while the caller's thread reduces arrival k (auto-enabled on
    multi-core hosts; ``overlap`` forces it).  On the torch backend each
    shard's fp64 accumulator is a tensor on ``mesh.devices[si % len]``
    (on ``device`` without a mesh), and every arrival folds each shard's
    range through ``weighted_sum`` on ``tile_source(lo, hi)``, the base
    deferred; the launches return before the device folds, so the host
    decodes the next arrival meanwhile (``overlap`` does not apply).
    ``tile_dtype="float32"`` folds those arrivals with fp32 tiles and the
    fp64 carry (the reference's TPU scheme; a relative tolerance, not
    bitwise); None and "float64" keep fp64 tiles.  Partial sums (0xF4)
    and the deferred bases always fold in fp64.

    On the torch backend sparse arrivals (0xF5) scatter into the same
    device accumulators through ``scatter_wsum``, and :meth:`finalize` /
    :meth:`raw_sum` finish on the device in the numpy engine's op order
    (``acc *= 1/W``, then each deferred base at ``w_b/W`` in token
    order, then the cast) before the one copy back to the host: the
    torch backend never folds on the host.

    Numerics: the sharded fold is bitwise-invariant across shard counts
    and overlap on/off (pure elementwise ops in arrival order).  It is
    bitwise-equal to the single-host mode for non-delta payloads, and
    within ~1 ULP of the fp64 accumulator for delta payloads (the
    deferred base changes the summation grouping) — the same order of
    difference the arrival-order fold already carries vs the deferred
    batch kernel, invisible after the fp32 output cast.
    """

    def __init__(self, layout: Layout, backend: Optional[str] = None,
                 block: Optional[int] = None, device=None, *,
                 shards: Optional[int] = None, mesh=None,
                 overlap: Optional[bool] = None,
                 tile_dtype: Optional[str] = None):
        _check_block(block)
        self.layout = layout
        self.backend = resolve_backend(backend)
        # delta-base memo, memo_token(base) -> fp64 materialization (a
        # device tensor on the torch backend).  Tokens are process-unique
        # (never recycled, unlike id()), so the memo cannot alias a GC'd
        # base and need not pin the object.
        self._base_memo: Dict[str, Any] = {}
        self._scratch = np.empty(min(CHUNK, max(layout.total_size, 1)),
                                 np.float64)
        self._tmp = np.empty_like(self._scratch)
        self.total_w = 0.0
        self.count = 0
        self.shards = resolve_shards(shards, mesh)
        self.mesh = mesh
        # the sharded torch fold's tile type (the numpy engine ignores it)
        self.tile_dtype = tile_dtype or "float64"
        if self.tile_dtype not in ("float64", "float32"):
            raise ValueError(f"tile_dtype must be 'float64' or 'float32', "
                             f"got {tile_dtype!r}")
        self.device = None
        # torch backend: the device-resident accumulator(s), None once the
        # fold has ended (finalize / raw_sum)
        self._dacc = None
        self._dsacc: Optional[List[Any]] = None
        # deferred delta bases: token -> [base object, summed weight].
        # Sharded dense deltas and sparse deltas (both modes) fold
        # base-deferred: sum_k w_k (d_k + b) == sum_k w_k d_k + W b
        self._deferred: Dict[str, list] = {}
        self._pipe = None
        # torch backend on a card: the page-locked buffer sparse arrivals
        # are staged through (made at the first)
        self._pinned = None
        self._acc = None
        self._sacc: Optional[List[np.ndarray]] = None
        if self.backend == "torch":
            import torch

            from repro_torch.device import resolve_device

            devs = ([resolve_device(d) for d in mesh.devices.flat]
                    if mesh is not None else [resolve_device(device)])
            self.device = devs[0]
        if self.shards:
            self._bounds = shard_bounds(layout.total_size, self.shards,
                                        align=QCHUNK)
            if self.backend == "torch":
                self._sdev = [devs[si % len(devs)]
                              for si in range(len(self._bounds))]
                self._dsacc = [torch.zeros(hi - lo, dtype=torch.float64,
                                           device=dev)
                               for (lo, hi), dev in zip(self._bounds,
                                                        self._sdev)]
            else:
                self._sacc = [np.zeros(hi - lo, np.float64)
                              for lo, hi in self._bounds]
                use_pipe = (layout.total_size > 0
                            and (overlap if overlap is not None
                                 else _host_cores() > 1))
                self._pipe = (_DecodePipeline(self._bounds) if use_pipe
                              else None)
        elif self.backend == "torch":
            self._dacc = torch.zeros(layout.total_size, dtype=torch.float64,
                                     device=self.device)
        else:
            self._acc = np.zeros(layout.total_size, np.float64)
        self.overlap = self._pipe is not None

    # ------------------------------------------------------------ shared
    def add(self, fp: FlatParams, w: float) -> None:
        if getattr(fp, "is_sparse", False):
            # 0xF5 structured-sparse delta: O(nnz) scatter fold — routed
            # here so edge pre-reduce and FedBuff call sites fold sparse
            # payloads without knowing about them
            self.add_sparse(fp, w)
            return
        if self.shards:
            self._add_sharded(fp, w)
            self.total_w += float(w)
            self.count += 1
            return
        sw = np.float64(w)
        n = self.layout.total_size
        if self.backend == "torch":
            self._live()
            if n:
                with obs.span("fold.add"):
                    self._fold_torch(_tile(fp), sw)
        else:
            acc = self._acc_vec()
            for lo in range(0, n, CHUNK):
                hi = min(lo + CHUNK, n)
                x = fp.f64_chunk(lo, hi, self._tmp)
                np.multiply(x, sw, out=self._scratch[:hi - lo])
                acc[lo:hi] += self._scratch[:hi - lo]
        self.total_w += float(w)
        self.count += 1

    def add_partial(self, ps, scale: float = 1.0) -> None:
        """Fold a pre-reduced subtree sum (:class:`~repro_torch.fl.flat
        .PartialSum`): ``acc += scale * S_e`` — no per-client weight
        multiply, the edge already applied them.  The edge computed
        ``S_e`` with this class's own chunk arithmetic, so root-folding
        partials continues the flat fold's accumulation exactly (bitwise
        for a single edge on any data; regrouped-sum ULP otherwise).
        ``scale`` (async staleness discount) also multiplies the
        contributed weight: ``total_w += scale * W_e``.  On the torch
        backend the fp64 sum folds through the same kernel as a one-row
        fp64 stack (``acc + S_e * scale``, the numpy rounding), per shard
        when sharded, always with fp64 tiles."""
        sw = np.float64(scale)
        if self.shards and self.backend == "torch":
            self._live()
            for si, (lo, hi) in enumerate(self._bounds):
                if hi > lo:
                    self._fold_shard(si, TileSource("float", ps.data[lo:hi]),
                                     sw, "float64")
        elif self.shards:
            if self._pipe is not None:
                # ride the decode pipeline so the (arrival, shard) fold
                # order stays the serial order
                self._pipe.submit(ps.decode_chunk, sw, self._fold_item)
            else:
                for si, (lo, hi) in enumerate(self._bounds):
                    if hi <= lo:
                        continue
                    acc = self._sacc[si]
                    for a in range(lo, hi, CHUNK):
                        b = min(a + CHUNK, hi)
                        x = ps.decode_chunk(a, b, self._tmp)
                        np.multiply(x, sw, out=self._scratch[:b - a])
                        acc[a - lo:b - lo] += self._scratch[:b - a]
        elif self.backend == "torch":
            self._live()
            if self.layout.total_size:
                self._fold_torch(TileSource("float", ps.data), sw)
        else:
            acc = self._acc_vec()
            n = self.layout.total_size
            for lo in range(0, n, CHUNK):
                hi = min(lo + CHUNK, n)
                x = ps.f64_chunk(lo, hi, self._tmp)
                np.multiply(x, sw, out=self._scratch[:hi - lo])
                acc[lo:hi] += self._scratch[:hi - lo]
        self.total_w += float(scale) * float(ps.total_w)
        self.count += int(ps.count)

    def add_sparse(self, sp, w: float) -> None:
        """Fold a structured-sparse delta (0xF5,
        :class:`~repro_torch.fl.flat.SparseDelta`): ``acc[traveled] += w *
        dequant(values)`` — O(nnz) per arrival, never a model-size
        densify.  The round base is **deferred** (recorded at its summed
        weight and applied chunk-streamed at :meth:`finalize` /
        :meth:`raw_sum`), exactly like the sharded dense-delta fold.  On
        the torch backend each span of traveled coordinates is one
        ``scatter_wsum`` launch into the device accumulator (bitwise the
        numpy chain)."""
        with obs.span("fold.add"):
            if self.backend == "torch":
                self._live()
            self._record_base(sp, w)
            sw = np.float64(w)
            if self.shards:
                if self._pipe is not None:
                    # keep the (arrival, shard) fold order serial: queued
                    # dense decodes fold before this sparse arrival
                    self._pipe.drain(self._fold_item)
                staged: Dict[Any, Any] = {}
                for si, (lo, hi) in enumerate(self._bounds):
                    if hi <= lo:
                        continue
                    if self.backend == "torch":
                        self._scatter_spans_torch(sp, lo, hi, self._dsacc[si],
                                                  sw, staged)
                    else:
                        self._scatter_spans(sp, lo, hi, self._sacc[si], sw)
            elif self.backend == "torch":
                self._scatter_spans_torch(sp, 0, self.layout.total_size,
                                          self._dacc, sw, {})
            else:
                self._scatter_spans(sp, 0, self.layout.total_size,
                                    self._acc_vec(), sw)
            self.total_w += float(w)
            self.count += 1

    def _scatter_spans(self, sp, lo: int, hi: int, acc: np.ndarray,
                       sw: np.float64) -> None:
        """Scatter ``sp``'s traveled coordinates inside [lo, hi) into
        ``acc`` (indexed relative to ``lo``), sub-chunked to the scratch
        size so a whole-model adapter range never allocates O(range)."""
        for p0, p1, dest in sp.iter_spans(lo, hi):
            for q0 in range(p0, p1, CHUNK):
                q1 = min(q0 + CHUNK, p1)
                if isinstance(dest, slice):
                    d = slice(dest.start + (q0 - p0),
                              dest.start + (q1 - p0))
                else:
                    d = dest[q0 - p0:q1 - p0]
                buf = sp.dequant_packed(q0, q1, self._tmp)
                np.multiply(buf, sw, out=self._scratch[:q1 - q0])
                acc[d] += self._scratch[:q1 - q0]

    def _scatter_spans_torch(self, sp, lo: int, hi: int, acc, sw: np.float64,
                             staged: Dict[Any, Any]) -> None:
        """The torch backend's :meth:`_scatter_spans`: one ``scatter_wsum``
        launch per span into the device accumulator ``acc`` (indexed
        relative to ``lo``), in place.  The arrival's packed values, scales
        and coo index go to ``acc``'s device once per arrival
        (:meth:`_stage_sparse`); a coo span is a slice of the staged index,
        found by a host binary search and shifted on the device when
        ``lo > 0``, and the wrapper checks it there."""
        from repro_torch.kernels import agg_reduce

        if sp.imode == "coo":
            i0, i1 = (int(i) for i in np.searchsorted(sp.indices, (lo, hi)))
            spans = [(i0, i1, None)] if i1 > i0 else []
        else:
            spans = list(sp.iter_spans(lo, hi))
        if not spans:
            return
        with obs.span("fold.add.stage"):
            vals, scales, index = self._stage_sparse(sp, acc.device, staged)
        with obs.span("fold.add.scatter"):
            for p0, p1, dest in spans:
                if dest is None:
                    dest = index[p0:p1]
                    if lo:
                        dest = dest - lo
                else:
                    dest = dest.start
                agg_reduce.scatter_wsum(acc, dest, vals[p0:p1], float(sw),
                                        scales=scales, qchunk=sp.qchunk,
                                        pos0=p0)

    def _stage_sparse(self, sp, dev, staged: Dict[Any, Any]):
        """``(values, scales, index)`` of sparse arrival ``sp`` as tensors
        on ``dev`` (scales None for fp32 values, index None for ranges),
        made once per arrival and device and kept in ``staged``.  On the CPU
        they are views of the frame's arrays; to a card they go through the
        accumulator's reused page-locked buffer
        (:class:`~repro_torch.kernels.agg_reduce.PinnedStage`)."""
        from repro_torch.kernels import agg_reduce

        if dev not in staged:
            arrays = (sp.values, sp.scales,
                      sp.indices if sp.imode == "coo" else None)
            if dev.type == "cpu":
                staged[dev] = [None if a is None
                               else agg_reduce._host_tensor(a)
                               for a in arrays]
            else:
                if self._pinned is None:
                    self._pinned = agg_reduce.PinnedStage()
                staged[dev] = self._pinned.to_device(arrays, dev)
        return staged[dev]

    def _apply_deferred(self, acc: np.ndarray, denom: float) -> None:
        """Add every deferred round base at ``summed_weight / denom``,
        chunk-streamed in canonical token order (arrival-order
        invariant; no model-size fp64 base materializes)."""
        if not self._deferred:
            return
        defs = [(self._deferred[tok][0],
                 np.float64(self._deferred[tok][1] / denom))
                for tok in sorted(self._deferred)]
        n = acc.size
        for lo in range(0, n, CHUNK):
            hi = min(lo + CHUNK, n)
            for bobj, bw in defs:
                x = bobj.f64_chunk(lo, hi, self._tmp)
                np.multiply(x, bw, out=self._scratch[:hi - lo])
                acc[lo:hi] += self._scratch[:hi - lo]
        self._deferred.clear()

    def raw_sum(self) -> np.ndarray:
        """The unscaled fp64 accumulator ``sum_i w_i x_i`` — what an edge
        aggregator frames as a 0xF4 partial payload instead of calling
        :meth:`finalize`.  Ends the fold: the returned vector IS the
        accumulator (no copy), so neither :meth:`add` nor
        :meth:`finalize` may be called afterwards.  Single-host mode
        only (edges pre-reduce locally; sharding is root-side state).
        Deferred sparse-delta bases are applied here at their SUMMED
        weight (S_e = sum w·d + W_b·b), so the 0xF4 partial an edge
        frames from sparse arrivals is the true subtree sum."""
        if self.shards:
            raise ValueError(
                "raw_sum() is single-host only: edge pre-reduction keeps "
                "one local accumulator, sharded state is for the root")
        if self.backend == "torch":
            from repro_torch.kernels import agg_reduce

            a = self._close_torch(self._end_torch()[0], 0,
                                  self.layout.total_size, None, 1.0)
            self._acc = agg_reduce.to_host(a)
            return self._acc
        acc = self._acc_vec()
        self._apply_deferred(acc, 1.0)
        return acc

    def finalize(self) -> FlatParams:
        if self.backend == "torch":
            return self._finalize_torch()
        if self.shards:
            return self._finalize_sharded()
        acc = self._acc_vec()
        acc *= np.float64(1.0 / self.total_w)
        self._apply_deferred(acc, self.total_w)
        out = FlatParams.zeros(self.layout)
        _scatter_leaves(acc, self.layout, out)
        return out

    def per_shard_acc_bytes(self) -> int:
        """Largest per-shard fp64 accumulator footprint, in bytes."""
        if not self.shards:
            return self.layout.total_size * 8
        return max((hi - lo for lo, hi in self._bounds), default=0) * 8

    # ------------------------------------------------- single-host mode
    def _acc_vec(self) -> np.ndarray:
        """The numpy backend's single-host accumulator."""
        return self._acc

    def _fold_torch(self, src, w: np.float64) -> None:
        """One kernel launch: ``acc + w * decode(src)`` on the device."""
        from repro_torch.kernels import agg_reduce

        stack = _device_stack([src], self.device, self._base_memo)
        self._dacc = agg_reduce.weighted_sum(
            stack["data"],
            agg_reduce.to_device(np.array([w], np.float64), self.device),
            scales=stack["scales"], qchunk=stack["qchunk"],
            base=stack["base"], acc=self._dacc)

    # ------------------------------------------------------ torch backend
    def _live(self) -> None:
        if self._dacc is None and self._dsacc is None:
            raise RuntimeError("the fold has ended (finalize/raw_sum)")

    def _end_torch(self) -> List[Any]:
        """The device accumulator(s) — one, or one per shard — taken out of
        the fold, which ends here."""
        self._live()
        accs = [self._dacc] if self._dsacc is None else self._dsacc
        self._dacc = self._dsacc = None
        return accs

    def _fold_shard(self, si: int, src: TileSource, w: np.float64,
                    tile_dtype: str) -> None:
        """``acc_si + w * decode(src)`` on shard ``si``'s device (the base
        deferred: ``src`` carries none)."""
        from repro_torch.kernels import agg_reduce

        dev = self._sdev[si]
        stack = _device_stack([src], dev, {})
        self._dsacc[si] = agg_reduce.weighted_sum(
            stack["data"], agg_reduce.to_device(np.array([w], np.float64),
                                                dev),
            scales=stack["scales"], qchunk=stack["qchunk"],
            acc=self._dsacc[si], tile_dtype=tile_dtype)

    def _close_torch(self, a, lo: int, hi: int, inv, denom: float):
        """Finish the range ``[lo, hi)`` of the fold on ``a``'s device in
        the numpy engine's op order: ``a *= inv`` (unless None), then each
        deferred base at ``summed_weight / denom`` in token order, each
        one ``weighted_sum`` launch with fp64 tiles continuing ``a``."""
        from repro_torch.kernels import agg_reduce

        if inv is not None:
            a.mul_(float(inv))
        for tok in sorted(self._deferred):
            bobj, bw = self._deferred[tok]
            src = _tile(bobj, lo, hi)
            base = None
            if src.base is not None:        # a base that is itself a delta
                base = agg_reduce.to_device(src.base.f64_chunk(
                    lo, hi, np.empty(hi - lo, np.float64)), a.device)
            stack = _device_stack([replace(src, base=None)], a.device, {})
            a = agg_reduce.weighted_sum(
                stack["data"], agg_reduce.to_device(
                    np.array([bw / denom], np.float64), a.device),
                scales=stack["scales"], qchunk=stack["qchunk"], base=base,
                acc=a)
        return a

    def _finalize_torch(self) -> FlatParams:
        """``acc/W`` (+ deferred bases) on the device per range, then the
        cast and one copy back per range: a uniform fp32 layout is cast
        on the device, fp64 comes back as it is, and every other layout
        comes back in fp64 and is cast leaf by leaf on the host, as the
        numpy engine casts it."""
        from repro_torch.kernels import agg_reduce
        import torch

        with obs.span("fold.finalize"):
            inv = np.float64(1.0 / self.total_w)
            accs = self._end_torch()
            bounds = self._bounds if self.shards else \
                ((0, self.layout.total_size),)
            n = self.layout.total_size
            u = self.layout.uniform_dtype
            direct = u in ("float32", "float64")
            with obs.span("fold.finalize.assemble"):
                out = FlatParams.zeros(self.layout)
                ovec = out.math_view() if direct else np.empty(n, np.float64)
            for a, (lo, hi) in zip(accs, bounds):
                if hi <= lo:
                    continue
                with obs.span("fold.finalize.close"):
                    a = self._close_torch(a, lo, hi, inv, self.total_w)
                if u == "float32":
                    with obs.span("fold.finalize.cast"):
                        a = a.to(torch.float32)
                with obs.span("fold.finalize.download"):
                    h = agg_reduce.to_host(a)
                with obs.span("fold.finalize.assemble"):
                    ovec[lo:hi] = h
                del h
            self._deferred.clear()
            if not direct:
                with obs.span("fold.finalize.assemble"):
                    _scatter_leaves(ovec, self.layout, out)
            return out

    # ------------------------------------------------------ sharded mode
    @staticmethod
    def _decoder(fp):
        dec = getattr(fp, "decode_chunk", None)
        if dec is None:
            if getattr(fp, "is_delta", False):
                raise TypeError(
                    "sharded fold needs decode_chunk() on delta payloads "
                    f"(got {type(fp).__name__})")
            dec = fp.f64_chunk
        return dec

    def _record_base(self, fp, w: float) -> None:
        if not getattr(fp, "is_delta", False):
            return
        base = getattr(fp, "base", None)
        if base is None:
            raise ValueError(
                "delta-encoded payload needs its round base attached "
                "(QuantParams.base / SparseDelta.base) before it can "
                "be folded")
        tok = memo_token(base)
        ent = self._deferred.get(tok)
        if ent is None:
            self._deferred[tok] = [base, float(w)]
        else:
            ent[1] += float(w)

    def _fold_item(self, si: int, buf: np.ndarray, m: int) -> None:
        self._sacc[si] += buf[:m]

    def _add_sharded(self, fp, w: float) -> None:
        if self.backend == "torch":
            self._live()
            # every shard's operands first: a payload the kernel cannot
            # take raises before any shard has folded it
            srcs = [(si, _tile(fp, lo, hi))
                    for si, (lo, hi) in enumerate(self._bounds) if hi > lo]
            self._record_base(fp, w)
            for si, src in srcs:
                # base deferred to finalize even when attached
                self._fold_shard(si, replace(src, base=None),
                                 np.float64(w), self.tile_dtype)
            return
        self._record_base(fp, w)
        dec = self._decoder(fp)
        sw = np.float64(w)
        if self._pipe is not None:
            self._pipe.submit(dec, sw, self._fold_item)
            return
        for si, (lo, hi) in enumerate(self._bounds):
            if hi <= lo:
                continue
            acc = self._sacc[si]
            for a in range(lo, hi, CHUNK):
                b = min(a + CHUNK, hi)
                x = dec(a, b, self._tmp)
                np.multiply(x, sw, out=self._scratch[:b - a])
                acc[a - lo:b - lo] += self._scratch[:b - a]

    def _finalize_sharded(self) -> FlatParams:
        if self._pipe is not None:
            self._pipe.drain(self._fold_item)
        inv = np.float64(1.0 / self.total_w)
        # canonical token order: the deferred-base add is independent of
        # which client's delta arrived first
        defs = [(self._deferred[tok][0],
                 np.float64(self._deferred[tok][1] / self.total_w))
                for tok in sorted(self._deferred)]
        out = FlatParams.zeros(self.layout)
        n = self.layout.total_size
        uniform = self.layout.uniform_dtype in _FLOATS
        ovec = out.math_view() if uniform else np.empty(n, np.float64)
        # the one all-gather: each shard's acc/W (+ deferred (w_b/W) b,
        # streamed chunk-wise so no model-size fp64 base materializes)
        # lands in the output buffer
        for si, (lo, hi) in enumerate(self._bounds):
            if hi <= lo:
                continue
            a = self._sacc[si]
            a *= inv
            for c0 in range(lo, hi, CHUNK):
                c1 = min(c0 + CHUNK, hi)
                seg = a[c0 - lo:c1 - lo]
                for bobj, bw in defs:
                    x = bobj.f64_chunk(c0, c1, self._tmp)
                    np.multiply(x, bw, out=self._scratch[:c1 - c0])
                    seg += self._scratch[:c1 - c0]
                ovec[c0:c1] = seg
        if not uniform:
            _scatter_leaves(ovec, self.layout, out)
        return out


def _rowstack(flats: Sequence[FlatParams], lo: int, hi: int,
              m: np.ndarray) -> np.ndarray:
    tile = m[:len(flats), :hi - lo]
    for i, fp in enumerate(flats):
        fp.f64_chunk(lo, hi, tile[i])
    return tile


def _robust_stack(flats: Sequence, device) -> Dict[str, Any]:
    """The whole round's (C, N) stack on the device, for a reduction that
    needs every client in one launch: the payload stack itself when every
    client shares codec, dtype, delta base and int8 scale window; else
    each run of :func:`_launch_runs` decoded by ``decode_rows`` into its
    rows of one fp64 stack (the numpy engine's per-client decode), which
    the reduction then takes as float64.  Nothing reduces on the host."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import agg_reduce

    dev = resolve_device(device)
    sources = [_tile(fp) for fp in flats]
    runs = _launch_runs(sources)
    if len(runs) == 1:
        return _device_stack(sources, dev, {})
    import torch

    out = torch.empty((len(sources), sources[0].data.size),
                      dtype=torch.float64, device=dev)
    bases: Dict[str, Any] = {}
    for lo, hi in runs:
        s = _device_stack(sources[lo:hi], dev, bases)
        agg_reduce.decode_rows(s["data"], scales=s["scales"],
                               qchunk=s["qchunk"], base=s["base"], out=out,
                               row0=lo)
    return {"data": out, "scales": None, "qchunk": 1, "base": None}


def _sort_reduce(flats, kind: str, trim_k: int, device) -> np.ndarray:
    from repro_torch.kernels import agg_reduce

    s = _robust_stack(flats, device)
    vec = agg_reduce.sort_reduce(
        s["data"], kind=kind, trim_k=trim_k, scales=s["scales"],
        qchunk=s["qchunk"], base=s["base"])
    return agg_reduce.to_host(vec)


def median(flats: Sequence[FlatParams], layout: Layout,
           backend: Optional[str] = None, block: Optional[int] = None,
           device=None) -> FlatParams:
    """Coordinate-wise median, chunk-stacked; on the torch backend one
    ``sort_reduce`` launch over the round's stack on ``device``."""
    _check_block(block)
    if layout.total_size and flats and resolve_backend(backend) == "torch":
        return _vec_to_flat(_sort_reduce(flats, "median", 0, device),
                            layout)
    return _coordinatewise(flats, layout,
                           lambda t: np.median(t, axis=0, overwrite_input=True))


def trimmed_mean(flats: Sequence[FlatParams], layout: Layout,
                 k: int, backend: Optional[str] = None,
                 block: Optional[int] = None, device=None) -> FlatParams:
    """Mean after trimming the k smallest/largest values per coordinate
    (all values when ``n <= 2k``).  On the torch backend one
    ``sort_reduce`` launch gives the trimmed sum, and the host divides it
    by the row count as ``np.mean`` does."""
    _check_block(block)
    n = len(flats)
    if layout.total_size and flats and resolve_backend(backend) == "torch":
        k_eff = k if n > 2 * k else 0
        vec = _sort_reduce(flats, "trim_sum", k_eff, device)
        vec /= n - 2 * k_eff
        return _vec_to_flat(vec, layout)

    def reduce(tile: np.ndarray) -> np.ndarray:
        tile.sort(axis=0)
        sl = tile[k:n - k] if n > 2 * k else tile
        return np.mean(sl, axis=0)

    return _coordinatewise(flats, layout, reduce)


def _coordinatewise(flats, layout, reduce_fn) -> FlatParams:
    out = FlatParams.zeros(layout)
    n = layout.total_size
    if n == 0 or not flats:
        return out
    uniform = layout.uniform_dtype in _FLOATS
    ovec = out.math_view() if uniform else np.empty(n, np.float64)
    m = np.empty((len(flats), CHUNK), np.float64)
    for lo in range(0, n, CHUNK):
        hi = min(lo + CHUNK, n)
        ovec[lo:hi] = reduce_fn(_rowstack(flats, lo, hi, m))
    if not uniform:
        _scatter_leaves(ovec, layout, out)
    return out


def krum_distances(flats: Sequence[FlatParams], layout: Layout,
                   backend: Optional[str] = None,
                   block: Optional[int] = None, device=None) -> np.ndarray:
    """(n, n) matrix of pairwise squared L2 distances.

    Accumulates the Gram matrix G += X_c X_c^T one (n, CHUNK) fp64 tile at
    a time, then expands ||a-b||^2 = ||a||^2 + ||b||^2 - 2<a,b>.  Each tile
    is centered on its first row before the dgemm — pairwise distances are
    translation-invariant, and removing the large common component (late
    rounds: client updates nearly identical, norms huge) keeps the
    expansion from cancelling catastrophically.  Clamped at zero for the
    residual rounding.  On the torch backend one ``gram`` launch over the
    round's stack on ``device`` gives G, and the host expands it.
    """
    _check_block(block)
    n_clients = len(flats)
    if layout.total_size and flats and resolve_backend(backend) == "torch":
        from repro_torch.kernels import agg_reduce

        s = _robust_stack(flats, device)
        G = agg_reduce.to_host(agg_reduce.gram(
            s["data"], scales=s["scales"], qchunk=s["qchunk"],
            base=s["base"]))
    else:
        G = np.zeros((n_clients, n_clients), np.float64)
        m = np.empty((n_clients, CHUNK), np.float64)
        ref = np.empty(CHUNK, np.float64)
        total = layout.total_size
        for lo in range(0, total, CHUNK):
            hi = min(lo + CHUNK, total)
            tile = _rowstack(flats, lo, hi, m)
            np.copyto(ref[:hi - lo], tile[0])
            tile -= ref[:hi - lo]
            G += tile @ tile.T
    return gram_to_distances(G)


def gram_to_distances(G: np.ndarray) -> np.ndarray:
    """||a-b||^2 = G_aa + G_bb - 2 G_ab, clamped at zero."""
    sq = np.diag(G).copy()
    D = sq[:, None] + sq[None, :] - 2.0 * G
    np.maximum(D, 0.0, out=D)
    return D


def krum_scores(D: np.ndarray, num_byzantine: int) -> np.ndarray:
    """Multi-Krum scores: per client, the sum of its n-f-2 smallest
    distances to other clients (Blanchard et al. 2017)."""
    n = D.shape[0]
    f = min(num_byzantine, max(0, (n - 3) // 2))
    D = D.copy()
    np.fill_diagonal(D, np.inf)
    D.sort(axis=1)
    m = max(n - f - 2, 1)
    return D[:, :m].sum(axis=1)


def wrapping_sum_u64(flats: Sequence[FlatParams],
                     layout: Layout) -> np.ndarray:
    """Mod-2^64 sum of uint64 flat buffers (SecAgg mask cancellation)."""
    acc = np.zeros(layout.total_size, np.uint64)
    for fp in flats:
        acc += fp.math_view()
    return acc
