"""Flat-buffer parameter representation — the aggregation hot path.

A model's parameters cross every FL hop as ``List[np.ndarray]``; treating
them leaf-by-leaf makes each round O(clients x layers) in Python overhead
and copies the payload several times per hop.  :class:`FlatParams` instead
carries **one contiguous byte buffer** plus a :class:`Layout` (dtypes,
shapes, offsets).  Properties:

- pytree/NDArrays <-> flat conversion is a single ``concatenate`` (or free,
  when the arrays already view one buffer, e.g. straight off the wire);
- per-leaf access is a zero-copy ``view``/``reshape`` into the buffer;
- layouts are interned in a cache, so repeated rounds of the same model
  reuse one Layout object and comparisons are pointer comparisons;
- the math view (one fp64/native vector over all leaves) is what the
  vectorized strategy kernels in :mod:`repro_torch.fl.agg_kernels` consume.

The byte buffer preserves leaves bitwise, so the Fig. 5 exactness guarantee
(native vs in-FLARE bit-identical) survives the representation change.

:class:`QuantParams` is the **compressed** sibling (wire codecs ``0xF2``
bf16 / ``0xF3`` int8 + per-chunk fp32 scales, see
:mod:`repro_torch.fl.messages`): a zero-copy view of the quantized payload that
implements the same chunked-read protocol (``layout`` / :meth:`f64_chunk` /
``nbytes``) as FlatParams, so the aggregation kernels consume compressed
buffers directly — dequantize + scale (+ delta-base add) fused into the
per-chunk accumulate, never materializing a model-size fp32 copy.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NDArrays = List[np.ndarray]

# ---------------------------------------------------------------------------
# wire version-byte registry — the single source of truth for 0xF0-0xFF
# ---------------------------------------------------------------------------
# Legacy msgpack frames always start with a container marker, never a byte
# in the reserved range, so one leading byte disambiguates every codec.
# All other modules must import these names; a raw hex literal in the
# range anywhere else is a `codec-literal` finding (repro_torch.analysis) —
# that is how two files would silently claim the same byte.
WIRE_MAGIC_LO = 0xF0
WIRE_MAGIC_HI = 0xFF
WIRE_MAGICS: Dict[str, int] = {
    "flat": 0xF1,          # raw little-endian fp payload (lossless)
    "bf16": 0xF2,          # bfloat16 payload
    "q8": 0xF3,            # int8 + per-chunk fp32 scales
    "partial": 0xF4,       # edge-aggregator partial sum (fp64 Σw·x + W)
    "sparse": 0xF5,        # structured-sparse delta (index + value streams)
    "metric_batch": 0xFB,  # runtime/streaming.py metric event batches
}
#: the subset that frames *model payloads*: a decoder dispatching on
#: these must cover all of them or raise UnsupportedCodec on the rest
PAYLOAD_CODEC_MAGICS = ("flat", "bf16", "q8", "partial", "sparse")

# process-unique memo-token counter (see memo_token)
_MEMO_COUNTER = itertools.count(1)


def memo_token(obj) -> str:
    """Stable identity token for payload memoization (delta-base caches).

    ``id()`` is only unique among *live* objects: a GC'd round base can
    recycle its id mid-round and alias a stale fp64 materialization in a
    long-lived memo.  The token instead combines a process-unique counter
    (assigned lazily, stored on the object) with the layout fingerprint,
    so it is never reused — a memo keyed by it cannot alias and need not
    keep the object alive.  Objects without the ``_memo_token`` slot get
    a fresh token per call (memo never hits: always correct, just
    uncached).
    """
    tok = getattr(obj, "_memo_token", None)
    if tok is None:
        lo = getattr(obj, "layout", None)
        fp = f"{lo.total_bytes}x{lo.total_size}" if lo is not None else "?"
        tok = f"{next(_MEMO_COUNTER)}:{fp}"
        try:
            obj._memo_token = tok
        except AttributeError:
            pass
    return tok


#: bfloat16 is stored as its raw 16 bits: numpy has no bfloat16 without
#: ml_dtypes, which the port does not use.  The dtype carries its name in
#: numpy dtype metadata, which survives views and copies, so a bf16 leaf
#: handed back by user code still lays out (and frames) as "bfloat16".
_BF16 = np.dtype(np.uint16, metadata={"repro_dtype": "bfloat16"})


def np_dtype(name: str) -> np.dtype:
    """Resolve a dtype name; "bfloat16" is the uint16 bit storage above.
    Convert bf16 values only through :func:`bf16_to_f32` and
    :func:`to_bf16`."""
    if name == "bfloat16":
        return _BF16
    return np.dtype(name)


def dtype_name(dt: np.dtype) -> str:
    """The wire name of a numpy dtype ("bfloat16" for bf16 bit storage)."""
    meta = dt.metadata
    if meta is not None and "repro_dtype" in meta:
        return meta["repro_dtype"]
    return dt.name


def is_bf16(dt: np.dtype) -> bool:
    return dtype_name(dt) == "bfloat16"


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """Widen bf16 bits to float32 (exact: the bits are the top half)."""
    return (np.asarray(bits).astype(np.uint32) << 16).view(np.float32)


def to_bf16(x) -> np.ndarray:
    """Narrow floats to bf16 bits, round-to-nearest-even **from fp32**.

    Wider inputs are rounded to fp32 first, which is what ``ml_dtypes``
    does (so ``1 + 2**-8 + 2**-40`` becomes 1.0: a double rounding the
    reference's wire bytes carry).  NaN becomes the quiet NaN ``0x7FC0``
    with its sign; overflow rounds to infinity; subnormals round like any
    other value.  An input that is already bf16 storage is returned as is.
    """
    a = np.asarray(x)
    if is_bf16(a.dtype):
        return a
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = (u + (((u >> 16) & 1) + 0x7FFF)) >> 16
    nan = np.isnan(np.asarray(a, np.float32))
    if nan.any():
        r = np.where(nan, ((u >> 16) & 0x8000) | 0x7FC0, r)
    return r.astype(np.uint16).view(_BF16)


def _widen(a: np.ndarray) -> np.ndarray:
    """A leaf as a float array numpy can cast exactly (bf16 bits widen
    to float32 first; every other dtype is returned as is)."""
    return bf16_to_f32(a) if is_bf16(a.dtype) else a


@dataclass(frozen=True)
class LeafSpec:
    dtype: str                  # dtype name ("float32", "bfloat16", ...)
    shape: Tuple[int, ...]
    offset: int                 # byte offset into the flat buffer
    nbytes: int
    eoffset: int                # element offset into the math vector
    size: int                   # number of elements


@dataclass(frozen=True)
class Layout:
    leaves: Tuple[LeafSpec, ...]
    total_bytes: int
    total_size: int             # total element count
    uniform_dtype: Optional[str]  # set when every leaf shares one dtype

    @property
    def signature(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        return tuple((l.dtype, l.shape) for l in self.leaves)


_LAYOUT_CACHE: Dict[Tuple[Tuple[str, Tuple[int, ...]], ...], Layout] = {}


def layout_for(signature: Sequence[Tuple[str, Tuple[int, ...]]]) -> Layout:
    """Intern a Layout for a (dtype, shape) signature."""
    key = tuple((str(d), tuple(int(x) for x in s)) for d, s in signature)
    cached = _LAYOUT_CACHE.get(key)
    if cached is not None:
        return cached
    leaves = []
    off = eoff = 0
    for dname, shape in key:
        dt = np_dtype(dname)
        size = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = size * dt.itemsize
        leaves.append(LeafSpec(dname, shape, off, nbytes, eoff, size))
        off += nbytes
        eoff += size
    dtypes = {l.dtype for l in leaves}
    layout = Layout(tuple(leaves), off, eoff,
                    dtypes.pop() if len(dtypes) == 1 else None)
    _LAYOUT_CACHE[key] = layout
    return layout


def layout_of(arrays: NDArrays) -> Layout:
    return layout_for([(dtype_name(a.dtype), a.shape) for a in arrays])


class FlatParams:
    """One contiguous uint8 buffer + a Layout describing the leaves."""

    __slots__ = ("buf", "layout", "_memo_token")

    def __init__(self, buf: np.ndarray, layout: Layout):
        assert buf.dtype == np.uint8 and buf.ndim == 1
        assert buf.nbytes == layout.total_bytes, (buf.nbytes, layout)
        self.buf = buf
        self.layout = layout
        self._memo_token: Optional[str] = None

    # ------------------------------------------------------------ builders
    @classmethod
    def from_arrays(cls, arrays: NDArrays,
                    layout: Optional[Layout] = None) -> "FlatParams":
        """Pack leaves into one contiguous buffer (a single copy).

        Messages decoded from the flat wire format never come through here —
        their FlatParams wraps the received payload zero-copy (see
        ``messages.decode_fit_res``); this is the entry point for freshly
        produced client/strategy arrays.
        """
        layout = layout or layout_of(arrays)
        buf = np.empty(layout.total_bytes, np.uint8)
        for spec, a in zip(layout.leaves, arrays):
            seg = buf[spec.offset:spec.offset + spec.nbytes]
            a = np.ascontiguousarray(a).reshape(-1)
            if spec.dtype == "bfloat16":
                a = to_bf16(a)          # bits pass through, floats narrow
            seg.view(np_dtype(spec.dtype))[...] = a
        return cls(buf, layout)

    @classmethod
    def from_buffer(cls, data, layout: Layout, offset: int = 0
                    ) -> "FlatParams":
        """Zero-copy wrap of ``data`` (bytes/memoryview/ndarray).

        The view is frozen: it borrows the transport buffer, and every
        downstream reader (tile_source tiles, delta-base chunk caches)
        aliases it.  bytes-backed views are born read-only anyway;
        bytearray/memoryview-backed receive buffers are not.
        """
        buf = np.frombuffer(data, np.uint8, count=layout.total_bytes,
                            offset=offset)
        buf.flags.writeable = False
        return cls(buf, layout)

    @classmethod
    def zeros(cls, layout: Layout) -> "FlatParams":
        return cls(np.zeros(layout.total_bytes, np.uint8), layout)

    # ------------------------------------------------------------- views
    def leaf(self, i: int) -> np.ndarray:
        spec = self.layout.leaves[i]
        seg = self.buf[spec.offset:spec.offset + spec.nbytes]
        return seg.view(np_dtype(spec.dtype)).reshape(spec.shape)

    def to_arrays(self) -> NDArrays:
        """Zero-copy per-leaf views (read-only iff the buffer is)."""
        return [self.leaf(i) for i in range(len(self.layout.leaves))]

    def math_view(self) -> np.ndarray:
        """The whole buffer as one 1-D vector of the uniform dtype.

        Zero-copy; only valid for uniform-dtype layouts (the common case —
        fp32 models, or uint64 SecAgg shares).
        """
        u = self.layout.uniform_dtype
        if u is None:
            raise ValueError("math_view() needs a uniform-dtype layout")
        return self.buf.view(np_dtype(u))

    def to_f64(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        """All leaves as one float64 vector (one pass; ``out`` reusable)."""
        lo = self.layout
        if out is None:
            out = np.empty(lo.total_size, np.float64)
        if lo.uniform_dtype is not None:
            np.copyto(out, _widen(self.math_view()), casting="unsafe")
        else:
            for i, spec in enumerate(lo.leaves):
                np.copyto(out[spec.eoffset:spec.eoffset + spec.size],
                          _widen(self.leaf(i).reshape(-1)), casting="unsafe")
        return out

    def f64_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        """Elements [lo, hi) as float64, written into ``out[:hi-lo]``.

        The chunked-read protocol the aggregation kernels stream through;
        :class:`QuantParams` implements the same method with the dequantize
        fused in, so kernels are agnostic to the wire encoding.
        """
        o = out[:hi - lo]
        layout = self.layout
        if layout.uniform_dtype is not None:
            np.copyto(o, _widen(self.math_view()[lo:hi]), casting="unsafe")
            return o
        for i, spec in enumerate(layout.leaves):  # mixed dtypes: per-segment
            s, e = spec.eoffset, spec.eoffset + spec.size
            if e <= lo or s >= hi:
                continue
            a, b = max(s, lo), min(e, hi)
            np.copyto(o[a - lo:b - lo],
                      _widen(self.leaf(i).reshape(-1)[a - s:b - s]),
                      casting="unsafe")
        return o

    # raw buffers carry no delta encoding: the codec decode IS f64_chunk
    # (shared protocol with QuantParams.decode_chunk, which strips the
    # delta-base add — see the sharded deferred-base fold)
    def decode_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        return self.f64_chunk(lo, hi, out)

    def nbytes(self) -> int:
        return self.layout.total_bytes

    def tile_source(self, lo: int = 0,
                    hi: Optional[int] = None) -> Optional["TileSource"]:
        """Adapter for the torch aggregation backend; ``None`` when the
        kernel cannot take this payload (integer domains, e.g. SecAgg's
        uint64 shares), which that backend then refuses.

        ``(lo, hi)`` selects an element range — the shard-aware slicing
        the mesh-sharded accumulator uses to hand each shard's column
        range to its own kernel launch (zero-copy for uniform layouts).
        """
        if hi is None:
            hi = self.layout.total_size
        u = self.layout.uniform_dtype
        if u is None:
            # mixed dtypes: one fp64 materialization of the range — the
            # same values f64_chunk streams, so the fused kernels stay
            # bitwise
            if lo == 0 and hi == self.layout.total_size:
                return TileSource("float", self.to_f64())
            return TileSource(
                "float", self.f64_chunk(lo, hi, np.empty(hi - lo)))
        if u in ("float16", "float32", "float64"):
            return TileSource("float", self.math_view()[lo:hi])
        if u == "bfloat16":
            return TileSource("bf16", self.math_view()[lo:hi])
        return None


@dataclass
class TileSource:
    """Chunk -> tile adapter: the raw typed arrays a payload contributes
    to a stacked (clients, N) device stack (see
    :mod:`repro_torch.kernels.agg_reduce`).

    ``kind="float"``: ``data`` is the (N,) fp16/fp32/fp64 vector
    (zero-copy for uniform layouts; mixed-dtype layouts materialize one
    fp64 vector — exactly the values ``f64_chunk`` would stream).
    ``kind="bf16"``: ``data`` is the (N,) bf16 bit vector (uint16).
    ``kind="q8"``: ``data`` is the (N,) int8 payload and ``scales`` the
    per-``qchunk`` fp32 scales.  ``base`` carries the *object* (FlatParams
    or QuantParams) a delta payload reconstructs against; the dispatch
    layer materializes it to fp64 once per distinct base, not per client.
    """

    kind: str                            # "float" | "bf16" | "q8"
    data: np.ndarray
    scales: Optional[np.ndarray] = None
    qchunk: int = 1024
    base: Optional[object] = None


def unflatten_vector(vec: np.ndarray, layout: Layout) -> NDArrays:
    """Split a math vector back into leaves, cast to each leaf's dtype."""
    out = []
    for spec in layout.leaves:
        seg = vec[spec.eoffset:spec.eoffset + spec.size].reshape(spec.shape)
        out.append(to_bf16(seg) if spec.dtype == "bfloat16"
                   else seg.astype(np_dtype(spec.dtype)))
    return out


# ---------------------------------------------------------------------------
# quantized payloads (wire codecs 0xF2 bf16 / 0xF3 int8 + per-chunk scales)
# ---------------------------------------------------------------------------
QCHUNK = 1024        # elements per int8 scale chunk (fp32 scale each)
_QBLOCK = 1 << 20    # elements per quantize/dequantize pass (QCHUNK-aligned)


def quantizable(layout: Layout) -> bool:
    """Lossy codecs only apply to uniform-fp32 models; anything else
    (mixed dtypes, SecAgg's uint64 shares, integer leaves) must travel
    losslessly and falls back to the raw 0xF1 flat frame."""
    return layout.uniform_dtype == "float32" and layout.total_size > 0


def quantize_int8(vec: np.ndarray, qchunk: int = QCHUNK
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-chunk int8 quantization of a fp32 vector.

    Each ``qchunk``-element window gets scale ``max|x| / 127`` (1.0 for
    all-zero windows), so dequantization error is bounded per coordinate:
    ``|x - scale * q| <= scale / 2``.  Returns ``(q int8, scales fp32)``.
    """
    n = int(vec.size)
    nchunks = -(-n // qchunk)
    scales = np.empty(nchunks, np.float32)
    q = np.empty(n, np.int8)
    block = max(_QBLOCK // qchunk, 1) * qchunk
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        x = np.asarray(vec[lo:hi], np.float32)
        nfull = (hi - lo) // qchunk * qchunk
        amax = (np.abs(x[:nfull]).reshape(-1, qchunk).max(axis=1)
                if nfull else np.empty(0, np.float32))
        if nfull < hi - lo:                       # ragged tail chunk
            amax = np.append(amax, np.abs(x[nfull:]).max())
        s = (amax / np.float32(127.0)).astype(np.float32)
        s[s == 0] = np.float32(1.0)
        c0 = lo // qchunk
        scales[c0:c0 + s.size] = s
        if nfull:       # broadcast one scale per (nchunks, qchunk) row
            xs = x[:nfull].reshape(-1, qchunk) / s[:nfull // qchunk, None]
            q[lo:lo + nfull] = np.clip(np.rint(xs), -127, 127) \
                .astype(np.int8).reshape(-1)
        if nfull < hi - lo:
            xt = x[nfull:] / s[-1]
            q[lo + nfull:hi] = np.clip(np.rint(xt), -127, 127) \
                .astype(np.int8)
    return q, scales


def _dequant_q8(data: np.ndarray, scales: np.ndarray, qchunk: int,
                lo: int, hi: int, out: np.ndarray) -> np.ndarray:
    """Fused int8 -> f64 dequantize of elements [lo, hi) into ``out``.

    Rounds through fp32 (``int8 * fp32-scale`` is exact in f64, then one
    fp32 rounding) so the server-side reconstruction is **bitwise equal**
    to the fp32 arrays a client materializes from the same bytes.
    """
    o = out[:hi - lo]
    np.copyto(o, data[lo:hi], casting="unsafe")
    if lo % qchunk == 0:
        # aligned fast path (kernel CHUNK is a multiple of QCHUNK):
        # broadcast one scale per row of the (nchunks, qchunk) view
        nfull = (hi - lo) // qchunk * qchunk
        c0 = lo // qchunk
        if nfull:
            o[:nfull].reshape(-1, qchunk)[...] *= \
                scales[c0:c0 + nfull // qchunk].astype(np.float64)[:, None]
        if nfull < hi - lo:                       # ragged tail chunk
            o[nfull:] *= np.float64(scales[c0 + nfull // qchunk])
    else:
        c0, c1 = lo // qchunk, -(-hi // qchunk)
        sv = np.repeat(scales[c0:c1].astype(np.float64), qchunk)
        o *= sv[lo - c0 * qchunk:lo - c0 * qchunk + (hi - lo)]
    o[...] = o.astype(np.float32)
    return o


def dequantize_int8(data: np.ndarray, scales: np.ndarray,
                    qchunk: int = QCHUNK,
                    out: Optional[np.ndarray] = None) -> np.ndarray:
    """int8 + per-chunk scales -> fp64 vector (the `_dequant_q8` chain:
    rounds through fp32 once, bitwise the client-side reconstruction).
    Public entry point for consumers of the PR 3 quant layout outside the
    wire path — e.g. the int8-quantized FedOpt server moments."""
    n = int(data.size)
    if out is None:
        out = np.empty(n, np.float64)
    if n:
        _dequant_q8(data, scales, qchunk, 0, n, out)
    return out[:n]


class QuantParams:
    """Zero-copy view of a quantized wire payload.

    Carries the *logical* fp32 :class:`Layout` plus the compressed data as
    ``np.frombuffer`` views into the received message:

    - ``mode="bf16"``: ``data`` is a bf16 vector (lossless to decode);
    - ``mode="q8"``: ``data`` is int8 and ``scales`` holds one fp32 scale
      per ``qchunk`` elements.

    ``is_delta`` marks a payload encoded as (result - round-start params);
    the server attaches ``base`` (the round's downlink params, FlatParams
    or QuantParams) before handing it to the kernels, which then read
    ``base + dequant(delta)`` through the same fused :meth:`f64_chunk`.
    """

    __slots__ = ("layout", "mode", "data", "scales", "qchunk", "is_delta",
                 "base", "_chunk_cache", "_memo_token")

    def __init__(self, layout: Layout, mode: str, data: np.ndarray,
                 scales: Optional[np.ndarray] = None, qchunk: int = QCHUNK,
                 is_delta: bool = False, base=None):
        assert mode in ("bf16", "q8"), mode
        self.layout = layout
        self.mode = mode
        self.data = data
        self.scales = scales
        self.qchunk = qchunk
        self.is_delta = is_delta
        self.base = base
        # last dequantized chunk, memoized when *this* object serves as a
        # shared delta base.  Helps the deferred kernels (weighted_mean /
        # _rowstack), which stream chunk-outer/client-inner so every
        # client re-reads the same base chunk back to back; the
        # low_memory streaming path folds client-outer and misses — it
        # trades that redundant dequant for O(1)-model-size peak memory.
        self._chunk_cache = None
        self._memo_token: Optional[str] = None

    # ------------------------------------------------------------- protocol
    def decode_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        """Codec decode of elements [lo, hi) into ``out`` — WITHOUT the
        delta-base add.  The sharded streaming fold reads deltas through
        this and defers the base to finalize (sum_k w_k (d_k + b) ==
        sum_k w_k d_k + W b), so the fp64 base is read once per round,
        not once per arrival."""
        o = out[:hi - lo]
        if self.mode == "bf16":
            np.copyto(o, bf16_to_f32(self.data[lo:hi]), casting="unsafe")
        else:
            _dequant_q8(self.data, self.scales, self.qchunk, lo, hi, o)
        return o

    def f64_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        """Fused dequantize(+base-add) of elements [lo, hi) into ``out``."""
        o = self.decode_chunk(lo, hi, out)
        if self.is_delta:
            base = self.base
            if base is None:
                raise ValueError(
                    "delta-encoded payload needs its round base attached "
                    "(QuantParams.base) before it can be read")
            arr = None
            if isinstance(base, QuantParams):
                c = base._chunk_cache
                if c is not None and c[0] == lo and c[1] == hi:
                    arr = c[2]
            if arr is None:
                arr = base.f64_chunk(lo, hi, np.empty(hi - lo, np.float64))
                if isinstance(base, QuantParams):
                    base._chunk_cache = (lo, hi, arr)
            o += arr        # arr is read-only by contract: never mutated
        return o

    def to_f64(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        n = self.layout.total_size
        if out is None:
            out = np.empty(n, np.float64)
        for lo in range(0, n, _QBLOCK):
            hi = min(lo + _QBLOCK, n)
            self.f64_chunk(lo, hi, out[lo:hi])
        return out

    def to_flat(self) -> FlatParams:
        """Materialize the logical fp32 FlatParams (one fresh buffer)."""
        out = FlatParams.zeros(self.layout)
        mv = out.math_view()
        tmp = np.empty(min(_QBLOCK, max(self.layout.total_size, 1)),
                       np.float64)
        n = self.layout.total_size
        for lo in range(0, n, _QBLOCK):
            hi = min(lo + _QBLOCK, n)
            mv[lo:hi] = self.f64_chunk(lo, hi, tmp)
        return out

    def to_arrays(self) -> NDArrays:
        return self.to_flat().to_arrays()

    def math_view(self) -> np.ndarray:
        raise TypeError(
            "quantized payloads have no raw math view; stream them through "
            "f64_chunk() or materialize with to_flat()")

    def nbytes(self) -> int:
        return int(self.data.nbytes
                   + (self.scales.nbytes if self.scales is not None else 0))

    def tile_source(self, lo: int = 0,
                    hi: Optional[int] = None) -> Optional[TileSource]:
        """Adapter for the torch aggregation backend: the still-compressed
        wire arrays, so the dequantize stays fused in the kernel.  A delta
        payload whose base is not attached yet returns ``None``, and the
        fold raises its explanatory error.

        ``(lo, hi)`` selects an element range (shard-aware slicing, all
        zero-copy views).  For int8 payloads ``lo`` must sit on a scale-
        window boundary — :func:`repro_torch.sharding.shard_bounds` aligns
        shard edges to ``qchunk`` exactly so this holds; a misaligned
        range returns ``None`` rather than mis-scaling.
        """
        if hi is None:
            hi = self.layout.total_size
        if self.is_delta and self.base is None:
            return None
        base = self.base if self.is_delta else None
        if self.mode == "bf16":
            return TileSource("bf16", self.data[lo:hi], base=base)
        if lo % self.qchunk:
            return None
        c0, c1 = lo // self.qchunk, -(-hi // self.qchunk)
        return TileSource("q8", self.data[lo:hi], self.scales[c0:c1],
                          self.qchunk, base)


# ---------------------------------------------------------------------------
# partial-aggregate payloads (wire codec 0xF4 — edge-aggregator tier)
# ---------------------------------------------------------------------------
class PartialSum:
    """Zero-copy view of a pre-reduced subtree payload (codec ``partial``).

    An edge aggregator folds its subtree's fit results with the same
    :class:`~repro_torch.fl.agg_kernels.StreamingWeightedSum` chunk arithmetic
    the root uses and ships the *unscaled* fp64 accumulator — one vector
    ``sum_i w_i x_i`` plus the subtree's total weight ``W``, contributing
    client count, sorted node ids, and any per-node failures it absorbed.
    The root then folds O(#edges) of these (``acc += S_e``; one divide by
    the global W at finalize) instead of O(#clients) client payloads.

    Implements the chunked-read protocol (``layout`` / :meth:`f64_chunk` /
    :meth:`decode_chunk` / :meth:`nbytes`) so the kernels stream it like
    any payload; it is **not** parameters — decoders asked to materialize
    it as a model raise ``UnsupportedCodec`` (see ``messages._unframe``).
    """

    __slots__ = ("layout", "data", "total_w", "count", "node_ids",
                 "failures", "_memo_token")

    def __init__(self, layout: Layout, data: np.ndarray, total_w: float,
                 count: int, node_ids: Tuple[str, ...] = (),
                 failures: Tuple[Tuple[str, str], ...] = ()):
        assert data.dtype == np.float64 and data.ndim == 1
        assert data.size == layout.total_size, (data.size, layout)
        self.layout = layout
        self.data = data
        self.total_w = float(total_w)
        self.count = int(count)
        self.node_ids = tuple(node_ids)
        self.failures = tuple((str(n), str(r)) for n, r in failures)
        self._memo_token: Optional[str] = None

    @classmethod
    def from_buffer(cls, data, layout: Layout, total_w: float, count: int,
                    node_ids: Tuple[str, ...] = (),
                    failures: Tuple[Tuple[str, str], ...] = (),
                    offset: int = 0) -> "PartialSum":
        """Zero-copy wrap of a received frame payload (frozen view)."""
        vec = np.frombuffer(data, np.float64, count=layout.total_size,
                            offset=offset)
        vec.flags.writeable = False
        return cls(layout, vec, total_w, count, node_ids, failures)

    # ------------------------------------------------------------- protocol
    def f64_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        o = out[:hi - lo]
        np.copyto(o, self.data[lo:hi])
        return o

    def decode_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        return self.f64_chunk(lo, hi, out)

    def to_f64(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        if out is None:
            return self.data.copy()
        np.copyto(out[:self.data.size], self.data)
        return out[:self.data.size]

    def nbytes(self) -> int:
        return int(self.data.nbytes)


# ---------------------------------------------------------------------------
# structured-sparse delta payloads (wire codec 0xF5 — TopK / adapter mode)
# ---------------------------------------------------------------------------
def topk_indices(mag: np.ndarray, k: int) -> np.ndarray:
    """Exactly-k largest-|magnitude| indices with deterministic
    tie-breaking, returned **sorted ascending**.

    ``np.argpartition`` orders equal-magnitude elements by memory layout,
    which varies across numpy builds; selecting ``mag >= thresh`` instead
    keeps *every* tie and overshoots k.  This helper takes all elements
    strictly above the k-th magnitude, then fills the remaining slots with
    the **lowest-index** elements equal to it — exactly k indices, bitwise
    reproducible across runs and platforms.  Shared by the 0xF5 encoder
    and the TopK compression mod (``fl/mods.py``).
    """
    mag = np.ravel(mag)
    k = int(k)
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= mag.size:
        return np.arange(mag.size, dtype=np.int64)
    thresh = np.partition(mag, mag.size - k)[mag.size - k]
    above = np.flatnonzero(mag > thresh)
    need = k - above.size
    ties = np.flatnonzero(mag == thresh)[:need]
    return np.sort(np.concatenate((above, ties))).astype(np.int64)


class SparseDelta:
    """Zero-copy view of a structured-sparse delta payload (codec 0xF5).

    The logical model is the uniform-fp32 :class:`Layout`; the payload is
    **always a delta** vs the round-start parameters (untraveled
    coordinates mean "delta == 0", so the server reconstructs
    ``base + scatter(values at indices)``).  Two index modes:

    - ``imode="coo"``: ``indices`` is a sorted, unique ``(nnz,)`` int64
      vector of element coordinates (TopK-sparse client updates);
    - ``imode="ranges"``: ``indices`` is a sorted, non-overlapping
      ``(R, 2)`` int64 array of ``[start, stop)`` element ranges — the
      adapter/LoRA-mask mode where only the trainable subset travels and
      ``values`` is the dense concatenation of those ranges.

    Two value modes: ``vmode="q8"`` reuses the PR 3 int8 machinery —
    ``values`` is int8 and ``scales`` one fp32 scale per
    :data:`QCHUNK`-element window **of the packed value stream** (error
    per traveled coordinate bounded by ``scale/2``) — and ``vmode="f32"``
    carries raw fp32 values (lossless given the selection).

    Implements the chunked-read protocol (``layout`` / :meth:`f64_chunk`
    / :meth:`decode_chunk` / :meth:`nbytes`) so the generic kernels can
    stream it; the aggregation fold uses :meth:`iter_spans` +
    :meth:`dequant_packed` instead for an O(nnz) fused
    scatter-dequantize-accumulate that never densifies
    (:meth:`StreamingWeightedSum.add_sparse <repro_torch.fl.agg_kernels
    .StreamingWeightedSum.add_sparse>`).  :meth:`tile_source` returns
    ``None`` by design — a data-dependent scatter has no tile structure
    for the stacked ``weighted_sum`` kernel; the sparse fold is the numpy
    scatter, or on the torch backend the ``scatter_wsum`` kernel.
    """

    is_delta = True      # always encoded vs the round-start parameters
    is_sparse = True

    __slots__ = ("layout", "imode", "vmode", "indices", "values", "scales",
                 "qchunk", "base", "_starts", "_stops", "_offsets",
                 "_memo_token")

    def __init__(self, layout: Layout, imode: str, indices: np.ndarray,
                 values: np.ndarray, scales: Optional[np.ndarray] = None,
                 qchunk: int = QCHUNK, base=None):
        assert imode in ("coo", "ranges"), imode
        self.layout = layout
        self.imode = imode
        self.indices = indices
        self.values = values
        self.scales = scales
        self.qchunk = int(qchunk)
        self.base = base
        self.vmode = "q8" if values.dtype == np.int8 else "f32"
        n = layout.total_size
        # validate the index structure up front: a byzantine payload with
        # unsorted/overlapping coordinates would silently break the
        # searchsorted windowing and the unique-scatter determinism — the
        # ValueError here demotes the sender to a per-node failure instead
        if imode == "coo":
            if indices.ndim != 1 or indices.size != values.size:
                raise ValueError("coo sparse delta: indices/values mismatch")
            if indices.size and (int(indices[0]) < 0
                                 or int(indices[-1]) >= n
                                 or np.any(np.diff(indices) <= 0)):
                raise ValueError(
                    "coo sparse delta: indices must be sorted, unique and "
                    "within the layout")
            self._starts = self._stops = self._offsets = None
        else:
            r = indices.reshape(-1, 2)
            if np.any(r[:, 0] >= r[:, 1]) or (r.size and (
                    int(r[0, 0]) < 0 or int(r[-1, 1]) > n
                    or np.any(r[1:, 0] < r[:-1, 1]))):
                raise ValueError(
                    "ranges sparse delta: [start, stop) ranges must be "
                    "sorted, non-overlapping and within the layout")
            lens = (r[:, 1] - r[:, 0]).astype(np.int64)
            if int(lens.sum()) != values.size:
                raise ValueError("ranges sparse delta: values length != "
                                 "total range coverage")
            self._starts = np.ascontiguousarray(r[:, 0])
            self._stops = np.ascontiguousarray(r[:, 1])
            off = np.zeros(len(r) + 1, np.int64)
            np.cumsum(lens, out=off[1:])
            self._offsets = off
        if self.vmode == "q8":
            nchunks = -(-values.size // self.qchunk)
            if scales is None or scales.size != nchunks:
                raise ValueError("q8 sparse delta: need one fp32 scale per "
                                 "qchunk window of the packed value stream")
        self._memo_token: Optional[str] = None

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    # ------------------------------------------------------- O(nnz) access
    def iter_spans(self, lo: int, hi: int):
        """Yield ``(p0, p1, dest)`` for the traveled coordinates inside
        element window ``[lo, hi)``: packed value positions ``[p0, p1)``
        land at ``dest`` (an index array for coo, a slice for ranges —
        both usable as a numpy fancy/basic index **relative to lo**).
        This is the scatter side of the fused fold: cost is O(overlap),
        never O(hi - lo)."""
        if self.imode == "coo":
            i0, i1 = np.searchsorted(self.indices, (lo, hi))
            i0, i1 = int(i0), int(i1)
            if i1 > i0:
                yield i0, i1, self.indices[i0:i1] - lo
            return
        r0 = int(np.searchsorted(self._stops, lo, side="right"))
        r1 = int(np.searchsorted(self._starts, hi, side="left"))
        for r in range(r0, r1):
            s, e = int(self._starts[r]), int(self._stops[r])
            a, b = max(s, lo), min(e, hi)
            if b <= a:
                continue
            p0 = int(self._offsets[r]) + (a - s)
            yield p0, p0 + (b - a), slice(a - lo, b - lo)

    def dequant_packed(self, p0: int, p1: int,
                       out: np.ndarray) -> np.ndarray:
        """Packed values ``[p0, p1)`` as f64, written into ``out[:p1-p0]``
        — the ``_dequant_q8`` chain for q8 (one fp32 rounding, bitwise the
        client-side reconstruction), a plain exact widen for f32."""
        o = out[:p1 - p0]
        if self.vmode == "q8":
            _dequant_q8(self.values, self.scales, self.qchunk, p0, p1, o)
        else:
            np.copyto(o, self.values[p0:p1], casting="unsafe")
        return o

    # ------------------------------------------------------------- protocol
    def decode_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        """Codec decode of elements [lo, hi) — WITHOUT the base add: zeros
        everywhere except the traveled coordinates (delta semantics)."""
        o = out[:hi - lo]
        o[...] = 0.0
        buf = np.empty(min(hi - lo, max(self.nnz, 1)), np.float64)
        for p0, p1, dest in self.iter_spans(lo, hi):
            # unique destinations: assignment == accumulate-into-zeros
            o[dest] = self.dequant_packed(p0, p1, buf)
        return o

    def f64_chunk(self, lo: int, hi: int, out: np.ndarray) -> np.ndarray:
        """Fused decode + delta-base add of elements [lo, hi)."""
        o = self.decode_chunk(lo, hi, out)
        base = self.base
        if base is None:
            raise ValueError(
                "sparse-delta payload needs its round base attached "
                "(SparseDelta.base) before it can be read")
        arr = None
        if isinstance(base, QuantParams):
            c = base._chunk_cache
            if c is not None and c[0] == lo and c[1] == hi:
                arr = c[2]
        if arr is None:
            arr = base.f64_chunk(lo, hi, np.empty(hi - lo, np.float64))
            if isinstance(base, QuantParams):
                base._chunk_cache = (lo, hi, arr)
        o += arr            # arr is read-only by contract: never mutated
        return o

    def to_f64(self, out: Optional[np.ndarray] = None) -> np.ndarray:
        n = self.layout.total_size
        if out is None:
            out = np.empty(n, np.float64)
        for lo in range(0, n, _QBLOCK):
            hi = min(lo + _QBLOCK, n)
            self.f64_chunk(lo, hi, out[lo:hi])
        return out

    def math_view(self) -> np.ndarray:
        raise TypeError(
            "sparse-delta payloads have no raw math view; stream them "
            "through f64_chunk() / iter_spans()")

    def nbytes(self) -> int:
        return int(self.indices.nbytes + self.values.nbytes
                   + (self.scales.nbytes if self.scales is not None else 0))

    def tile_source(self, lo: int = 0, hi: Optional[int] = None) -> None:
        """Always ``None``: a data-dependent scatter has no tile structure
        for the stacked ``weighted_sum`` kernel — the fold routes sparse
        payloads through the O(nnz) scatter path instead (``add_sparse``)."""
        return None
