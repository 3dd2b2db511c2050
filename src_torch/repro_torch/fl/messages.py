"""Wire format for the Flower-analogue app layer.

Everything that crosses a process/transport boundary is **bytes**.  Four
codecs coexist behind a leading version byte:

- **flat** (default, magic ``0xF1``): one msgpack header (layout
  signature + config/metrics) followed by a single 64-byte-aligned
  contiguous binary payload holding every leaf back to back.  Decoding is
  **zero-copy** — leaves are ``np.frombuffer`` views into the received
  bytes, and the whole-model :class:`~repro_torch.fl.flat.FlatParams` rides on
  the decoded message (``.flat``) so the aggregation kernels never touch
  per-layer Python loops.
- **bf16** (magic ``0xF2``): the same frame with the fp32 payload stored
  as bfloat16 — 2 bytes/param, exact exponent range, ~3 decimal digits.
- **q8** (magic ``0xF3``): symmetric int8 quantization with one fp32
  scale per :data:`~repro_torch.fl.flat.QCHUNK`-element window — ~1 byte/param
  (4x vs fp32) with per-coordinate error bounded by ``scale/2``.  Fit
  results are encoded as **deltas** against the round-start parameters
  (header flag ``d``), which keeps the quantization bound proportional to
  the *update* magnitude, not the weights.  Both lossy frames decode
  zero-copy into :class:`~repro_torch.fl.flat.QuantParams`, which the
  aggregation kernels stream through fused dequantize+accumulate reads.
- **partial** (magic ``0xF4``): an edge aggregator's pre-reduced subtree
  sum — one raw fp64 ``Σw·x`` vector plus total weight / contributing
  node ids in the header (:class:`~repro_torch.fl.flat.PartialSum`).  Lossless
  by construction; only the root server's fit accumulator consumes it —
  parameter-decoding paths raise :class:`UnsupportedCodec` instead of
  misreading a sum as a model (the downgrade path for peers that don't
  speak the edge tier).
- **sparse** (magic ``0xF5``): a structured-sparse **delta** vs the
  round-start parameters — separate index and value streams
  (:class:`~repro_torch.fl.flat.SparseDelta`).  Index modes: sorted-unique COO
  coordinates (TopK of the update magnitude) or sorted ``[start, stop)``
  ranges (the adapter/LoRA-mask mode where only the trainable subset
  travels).  Value modes: int8 + one fp32 scale per
  :data:`~repro_torch.fl.flat.QCHUNK` window of the *packed* stream (composes
  with the q8 delta machinery) or raw fp32.  Untraveled coordinates mean
  "delta == 0", so a 32B-param model federates at <<1% of the full-weight
  ``0xF1`` bytes; the fold consumes it via fused
  scatter-dequantize-accumulate with no model-size densify.  Like
  ``0xF4``, parameter-decoding paths raise :class:`UnsupportedCodec` —
  only the server-side fit fold (with the round base re-attached) can
  reconstruct.
- **legacy** (any other first byte — legacy messages start with a msgpack
  fixmap/fixarray marker): per-array ``(dtype, shape, raw-buffer)``
  msgpack triples, exactly the seed format, kept for on-the-wire
  compatibility with older peers.

``0xF1`` and legacy carry raw little-endian buffers, so both are exact
(bitwise) — the prerequisite for the paper's Fig. 5 reproducibility claim
(native vs. in-FLARE must match exactly).  A reserved-range version byte
(``0xF0``–``0xFF``) this build does not know raises
:class:`UnsupportedCodec` instead of being misparsed as msgpack.

Codec negotiation
-----------------
Lossy codecs are **opt-in and negotiated**, never assumed:

1. Clients advertise the codecs they speak in their ``get_properties``
   response (``{"codecs": [...]}`` — :class:`~repro_torch.fl.client.ClientApp`
   fills this in automatically; see :data:`WIRE_CODECS`).
2. The ServerApp (``ServerConfig.codec="q8" | "bf16"``) intersects the
   fleet's advertisements and picks a codec per round; any node that
   fails to respond (e.g. an older peer that errors on the unknown task
   type) demotes the round to the lossless ``flat`` codec.
3. The negotiated codec rides in the fit config (``config["codec"]``);
   the client's ClientApp re-encodes the final (post-mod-chain) FitRes
   with it, as a delta against the round-start parameters it received.
4. Decoding always auto-detects from the version byte, so a client that
   ignores the request (or a mod whose output is not uniform fp32 — e.g.
   SecAgg's uint64 masked shares) simply falls back to ``0xF1`` and
   interoperates losslessly: negotiation is advisory, the frame is
   authoritative.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

# Decoders accept any byte-addressable buffer, not just ``bytes``: the
# socket transport (repro_torch.core.transport) hands frames over as
# read-only memoryviews into its receive buffer, and every zero-copy path below
# (msgpack_lite.unpackb, np.frombuffer, FlatParams.from_buffer) consumes them
# directly without an intermediate copy.
Buffer = Union[bytes, bytearray, memoryview]

import numpy as np

from repro_torch import obs
from repro_torch.fl.flat import (FlatParams, Layout, PartialSum, QCHUNK,
                                 QuantParams, SparseDelta, WIRE_MAGIC_LO,
                                 WIRE_MAGICS, dtype_name, layout_for,
                                 np_dtype, quantizable, quantize_int8,
                                 to_bf16, topk_indices)
from repro_torch.utils import msgpack_lite

NDArrays = List[np.ndarray]

# wire version bytes: fl/flat.py's WIRE_MAGICS is the single registry
FLAT_MAGIC = WIRE_MAGICS["flat"]
BF16_MAGIC = WIRE_MAGICS["bf16"]
Q8_MAGIC = WIRE_MAGICS["q8"]
PARTIAL_MAGIC = WIRE_MAGICS["partial"]
SPARSE_MAGIC = WIRE_MAGICS["sparse"]
_HEADER_ALIGN = 64       # payload starts 64-byte aligned for fast views

#: every codec this build can encode AND decode (advertised by clients in
#: their get_properties response and intersected by the ServerApp)
WIRE_CODECS = ("flat", "bf16", "q8", "sparse", "legacy")
#: the lossy subset, only used after successful negotiation
QUANT_CODECS = ("bf16", "q8")

_MAGIC_BY_CODEC = {"flat": FLAT_MAGIC, "bf16": BF16_MAGIC, "q8": Q8_MAGIC}
_QUANT_MODE_BY_MAGIC = {BF16_MAGIC: "bf16", Q8_MAGIC: "q8"}

_DEFAULT_CODEC = "flat"


class UnsupportedCodec(ValueError):
    """The frame's version byte is in the flat-family reserved range
    (0xF0-0xFF) but this build has no decoder for it — e.g. a newer peer
    skipped negotiation, or the snapshot is from a future version."""


def set_default_codec(name: str) -> str:
    """Switch the process-wide encode codec ("flat" | "legacy").

    The lossy codecs ("bf16" / "q8") are deliberately NOT accepted here:
    they are negotiated per round (see module docstring), never a silent
    process-wide default.  Decoding always auto-detects, so mixed fleets
    interoperate; this only controls what *we* put on the wire.  Returns
    the previous codec.
    """
    global _DEFAULT_CODEC
    if name not in ("flat", "legacy"):
        raise ValueError(f"unknown codec {name!r}")
    prev, _DEFAULT_CODEC = _DEFAULT_CODEC, name
    return prev


# ---------------------------------------------------------------------------
# legacy per-array codec
# ---------------------------------------------------------------------------
def _np_dtype(name: str) -> np.dtype:
    return np_dtype(name)


def _pack_array(a: np.ndarray) -> Dict[str, Any]:
    a = np.ascontiguousarray(a)
    return {"dtype": dtype_name(a.dtype), "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_array(d: Dict[str, Any]) -> np.ndarray:
    return np.frombuffer(d["data"], dtype=_np_dtype(d["dtype"])) \
        .reshape(d["shape"]).copy()


# ---------------------------------------------------------------------------
# flat-family codec framing (0xF1 raw fp / 0xF2 bf16 / 0xF3 int8+scales)
# ---------------------------------------------------------------------------
def _frame(magic: int, head: Dict[str, Any], *payload) -> bytes:
    """[magic][u32 header_len][msgpack header][pad to 64][payload...]"""
    h = msgpack_lite.packb(head, use_bin_type=True)
    data_off = _aligned(5 + len(h))
    prefix = bytes([magic]) + struct.pack("<I", len(h)) + h \
        + b"\x00" * (data_off - 5 - len(h))
    # single copy of the model payload into the message
    return b"".join((prefix, *map(memoryview, payload)))


def _flat_frame(head: Dict[str, Any], fp: FlatParams) -> bytes:
    return _frame(FLAT_MAGIC, head, fp.buf)


def _aligned(n: int) -> int:
    return -(-n // _HEADER_ALIGN) * _HEADER_ALIGN


def _is_framed(b: Buffer) -> bool:
    """Flat-family frame?  Legacy msgpack messages always start with a
    container marker (fixmap/fixarray/map16/array16...), never 0xF0-0xFF,
    so the reserved range is unambiguous."""
    return len(b) >= 5 and b[0] >= WIRE_MAGIC_LO


def _head_of(b: Buffer) -> Tuple[Dict[str, Any], int]:
    if b[0] not in (FLAT_MAGIC, BF16_MAGIC, Q8_MAGIC, PARTIAL_MAGIC,
                    SPARSE_MAGIC):
        raise UnsupportedCodec(
            f"unknown wire codec version byte 0x{b[0]:02X}; this build "
            f"decodes 0xF1 (flat) / 0xF2 (bf16) / 0xF3 (q8) / 0xF4 "
            f"(partial) / 0xF5 (sparse) and legacy msgpack frames")
    (hlen,) = struct.unpack_from("<I", b, 1)
    return msgpack_lite.unpackb(memoryview(b)[5:5 + hlen], raw=False), hlen


def _unframe(b: Buffer, writable: bool = False
             ) -> Tuple[Dict[str, Any], Optional[object]]:
    """Decode any flat-family frame -> (header, FlatParams | QuantParams).

    ``writable=False`` wraps the message bytes zero-copy (read-only
    views — the server aggregation hot path only reads).  ``writable=True``
    copies a 0xF1 payload once into a fresh buffer: client-facing decodes
    use it so ``fit(parameters, ...)`` may mutate in place, like the legacy
    per-array codec allowed.  (Quantized frames ignore it — materializing
    them allocates fresh writable arrays anyway.)
    """
    with obs.span("fl.decode.header"):
        head, hlen = _head_of(b)
        if "l" not in head:
            return head, None
        layout = layout_for([(d, tuple(s)) for d, s in head["l"]])
    off = _aligned(5 + hlen)
    if b[0] == FLAT_MAGIC:
        fp = FlatParams.from_buffer(b, layout, offset=off)
        if writable:
            fp = FlatParams(fp.buf.copy(), layout)
        return head, fp
    n = layout.total_size
    is_delta = bool(head.get("d", 0))
    if b[0] == BF16_MAGIC:
        data = np.frombuffer(b, np_dtype("bfloat16"), count=n, offset=off)
        data.flags.writeable = False     # borrows the transport buffer
        return head, QuantParams(layout, "bf16", data, is_delta=is_delta)
    if b[0] == Q8_MAGIC:
        qchunk = int(head.get("qc", QCHUNK))
        nchunks = -(-n // qchunk)
        scales = np.frombuffer(b, np.float32, count=nchunks, offset=off)
        data = np.frombuffer(b, np.int8, count=n,
                             offset=off + 4 * nchunks)
        scales.flags.writeable = False   # borrows the transport buffer
        data.flags.writeable = False
        return head, QuantParams(layout, "q8", data, scales, qchunk,
                                 is_delta=is_delta)
    if b[0] == PARTIAL_MAGIC:
        # edge-tier partial aggregate: one fp64 Σw·x vector, zero-copy
        return head, PartialSum.from_buffer(
            b, layout, head.get("w", 0.0), head.get("n", 0),
            tuple(head.get("ids", [])),
            tuple((n, r) for n, r in head.get("f", [])), offset=off)
    if b[0] == SPARSE_MAGIC:
        # structured-sparse delta: [indices int64][scales fp32?][values],
        # every stream a frozen zero-copy view into the transport buffer
        imode = "coo" if head.get("im", "c") == "c" else "ranges"
        vmode = head.get("vm", "q8")
        nz = int(head["nz"])
        nidx = 2 * int(head.get("nr", 0)) if imode == "ranges" else nz
        idx = np.frombuffer(b, np.int64, count=nidx, offset=off)
        idx.flags.writeable = False      # borrows the transport buffer
        if imode == "ranges":
            idx = idx.reshape(-1, 2)     # reshaped view stays read-only
        voff = off + 8 * nidx
        qchunk = int(head.get("qc", QCHUNK))
        scales = None
        if vmode == "q8":
            nchunks = -(-nz // qchunk)
            scales = np.frombuffer(b, np.float32, count=nchunks,
                                   offset=voff)
            scales.flags.writeable = False
            values = np.frombuffer(b, np.int8, count=nz,
                                   offset=voff + 4 * nchunks)
        else:
            values = np.frombuffer(b, np.float32, count=nz, offset=voff)
        values.flags.writeable = False
        return head, SparseDelta(layout, imode, idx, values, scales, qchunk)
    # _head_of above already rejects unknown bytes; keep the dispatch
    # locally exhaustive so a new registry entry cannot fall through to
    # a wrong decoder (codec-dispatch invariant, docs/INVARIANTS.md)
    raise UnsupportedCodec(
        f"no decoder branch for version byte 0x{b[0]:02X}")


def _quant_frame(head: Dict[str, Any], fp: FlatParams, codec: str,
                 base: Optional[FlatParams]) -> bytes:
    """Encode ``fp`` (uniform fp32) as a bf16/q8 frame, as a delta against
    ``base`` (the round-start parameters) when one is supplied."""
    x = fp.math_view()
    if base is not None:
        x = x - base.math_view()             # fp32 delta, bounds the error
        head["d"] = 1
    if codec == "bf16":
        return _frame(BF16_MAGIC, head, to_bf16(x).view(np.uint8))
    q, scales = quantize_int8(x)
    head["qc"] = QCHUNK
    return _frame(Q8_MAGIC, head, scales.view(np.uint8), q.view(np.uint8))


def _pick_wire(codec: Optional[str], fp_layout: Layout,
               base: Optional[FlatParams]) -> str:
    """Resolve the effective codec: a lossy request silently demotes to
    the lossless flat frame when the payload is not uniform fp32, or when
    the delta base does not match the result layout."""
    codec = codec or _DEFAULT_CODEC
    if codec in QUANT_CODECS:
        if not quantizable(fp_layout):
            return "flat"
        if base is not None and base.layout is not fp_layout \
                and base.layout != fp_layout:
            return "flat"
    if codec == "sparse":
        # sparse frames are deltas by construction: no round base (e.g. a
        # FitIns/get_parameters downlink) or a non-fp32 / layout-mismatched
        # payload falls back to the lossless flat frame
        if base is None or not quantizable(fp_layout):
            return "flat"
        if base.layout is not fp_layout and base.layout != fp_layout:
            return "flat"
    return codec


def _sparse_frame(head: Dict[str, Any], fp: FlatParams, base: FlatParams,
                  frac: float, ranges, vmode: str = "q8") -> bytes:
    """Encode ``fp`` as a structured-sparse 0xF5 delta vs ``base``.

    ``ranges`` (adapter/LoRA mode) is an ``(R, 2)`` array of sorted
    non-overlapping ``[start, stop)`` element ranges into the flat math
    vector — only those coordinates travel.  Without ranges, the TopK
    mode keeps ``max(1, ceil(frac * size))`` coordinates of largest
    |delta| with deterministic tie-breaking (:func:`~repro_torch.fl.flat
    .topk_indices`).  Values pack int8 + per-qchunk fp32 scales of the
    *packed* stream (``vmode="q8"``) or raw fp32 (``"f32"``).
    """
    x = fp.math_view() - base.math_view()     # fp32 delta
    head["d"] = 1
    if ranges is not None:
        r = np.ascontiguousarray(np.asarray(ranges, np.int64).reshape(-1, 2))
        packed = np.concatenate(
            [x[int(a):int(b)] for a, b in r]) if len(r) \
            else np.empty(0, np.float32)
        head["im"], head["nr"] = "r", int(len(r))
        idx = r
    else:
        k = max(1, int(np.ceil(float(frac) * x.size)))
        idx = topk_indices(np.abs(x), k)
        packed = x[idx]
        head["im"] = "c"
    packed = np.ascontiguousarray(packed, np.float32)
    head["nz"] = int(packed.size)
    if vmode == "q8":
        q, scales = quantize_int8(packed)
        head["vm"], head["qc"] = "q8", QCHUNK
        return _frame(SPARSE_MAGIC, head,
                      np.ascontiguousarray(idx).view(np.uint8),
                      scales.view(np.uint8), q.view(np.uint8))
    head["vm"] = "f32"
    return _frame(SPARSE_MAGIC, head,
                  np.ascontiguousarray(idx).view(np.uint8),
                  packed.view(np.uint8))


def _leaf_sig(fp: FlatParams) -> List[List[Any]]:
    return [[l.dtype, list(l.shape)] for l in fp.layout.leaves]


def _as_flat(parameters: NDArrays, flat: Optional[FlatParams]) -> FlatParams:
    return flat if flat is not None else FlatParams.from_arrays(parameters)


def _framed_encode(parameters: NDArrays, flat: Optional[FlatParams],
                   head_extra: Dict[str, Any], codec: Optional[str],
                   base: Optional[FlatParams] = None,
                   sparse_frac: float = 0.01,
                   sparse_ranges=None) -> bytes:
    """Shared flat-family encode dispatch: flatten, resolve the effective
    codec (lossy requests demote per :func:`_pick_wire`), frame.  Callers
    handle the "legacy" codec themselves — it has no flat layout and each
    message shapes its msgpack map differently."""
    fp = _as_flat(parameters, flat)
    codec = _pick_wire(codec, fp.layout, base)
    head = {"l": _leaf_sig(fp), **head_extra}
    if codec in QUANT_CODECS:
        return _quant_frame(head, fp, codec, base)
    if codec == "sparse":
        return _sparse_frame(head, fp, base, sparse_frac, sparse_ranges)
    return _flat_frame(head, fp)


# ---------------------------------------------------------------------------
# header-only peeks (cheap reads the negotiation/delta paths rely on)
# ---------------------------------------------------------------------------
def peek_config(b: bytes) -> Dict[str, Any]:
    """The config dict of a framed FitIns/EvaluateIns, header-only (the
    payload is not touched).  Legacy frames return {} — negotiated codecs
    never ride legacy messages."""
    if not _is_framed(b):
        return {}
    return _head_of(b)[0].get("c", {})


def peek_params(b: bytes):
    """Zero-copy read-only view of a framed message's parameters
    (FlatParams or QuantParams), or None for legacy/param-less frames.

    This is how both ends recover the *round-start* parameters bitwise:
    the client peeks the pristine task payload (immune to in-place
    mutation by ``fit``), the server peeks its own downlink bytes — so
    delta encode and delta reconstruction agree exactly."""
    if not _is_framed(b):
        return None
    return _unframe(b, writable=False)[1]


# ---------------------------------------------------------------------------
# NDArrays <-> bytes (get_parameters / initial parameters path)
# ---------------------------------------------------------------------------
def arrays_to_bytes(arrays: NDArrays, codec: Optional[str] = None) -> bytes:
    if (codec or _DEFAULT_CODEC) == "legacy":     # skip the flatten copy
        return msgpack_lite.packb([_pack_array(a) for a in arrays],
                             use_bin_type=True)
    return _framed_encode(arrays, None, {}, codec)


def bytes_to_arrays(b: bytes) -> NDArrays:
    if _is_framed(b):
        _, p = _unframe(b, writable=True)         # one-shot path, not hot
        return _materialized(p).to_arrays()
    return [_unpack_array(d) for d in msgpack_lite.unpackb(b, raw=False)]


# tensors <-> flat NDArrays (clients keep the structure; the wire sees arrays)
def _tensors_of(params) -> list:
    """The tensors of an ordered list/tuple or a ``state_dict``, in order."""
    if isinstance(params, dict):
        return list(params.values())
    return list(params)


def params_to_arrays(params) -> NDArrays:
    """An ordered list (or a ``state_dict``) of tensors -> host numpy
    arrays in the same order.  bfloat16 tensors become bf16 bit arrays."""
    import torch

    out = []
    for t in _tensors_of(params):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            out.append(t.view(torch.int16).numpy().view(np_dtype("bfloat16")))
        else:
            out.append(t.numpy())
    return out


def arrays_to_params(arrays: NDArrays, like):
    """Numpy arrays -> tensors shaped like ``like`` (a list or a
    ``state_dict``), each with its template's dtype and device."""
    import torch

    tmpl = _tensors_of(like)
    if len(tmpl) != len(arrays):
        raise ValueError(f"{len(arrays)} arrays for {len(tmpl)} tensors")
    out = []
    for a, t in zip(arrays, tmpl):
        if t.dtype == torch.bfloat16:
            x = torch.from_numpy(np.array(to_bf16(a)).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            x = torch.as_tensor(np.asarray(a)).to(t.dtype)
        out.append(x.reshape(t.shape).to(t.device))
    if isinstance(like, dict):
        return dict(zip(like.keys(), out))
    return out


# ---------------------------------------------------------------------------
# task messages
# ---------------------------------------------------------------------------
@dataclass
class FitIns:
    parameters: NDArrays
    config: Dict[str, Any] = field(default_factory=dict)
    flat: Optional[FlatParams] = field(default=None, repr=False, compare=False)


@dataclass
class FitRes:
    # None when the result arrived quantized (``quant`` set) — the server
    # hot path streams the compressed buffer through the kernels instead
    # of materializing per-leaf arrays; call materialize() if needed.
    parameters: Optional[NDArrays]
    num_examples: int
    metrics: Dict[str, Any] = field(default_factory=dict)
    flat: Optional[FlatParams] = field(default=None, repr=False, compare=False)
    quant: Optional[QuantParams] = field(default=None, repr=False,
                                         compare=False)
    # set when the result is an edge-aggregator partial sum (0xF4): a
    # pre-reduced Σw·x over the sender's subtree, consumed only by
    # weighted-sum fit accumulators (strategy.supports_partial())
    partial: Optional[PartialSum] = field(default=None, repr=False,
                                          compare=False)
    # set when the result is a structured-sparse delta (0xF5): only the
    # traveled coordinates changed; the server attaches the round base
    # and the fit fold scatters it without a model-size densify
    sparse: Optional[SparseDelta] = field(default=None, repr=False,
                                          compare=False)

    def set_parameters(self, arrays: NDArrays,
                       flat: Optional[FlatParams] = None) -> None:
        """Replace parameters, keeping the cached views coherent."""
        self.parameters = arrays
        self.flat = flat
        self.quant = None
        self.partial = None
        self.sparse = None

    def materialize(self) -> NDArrays:
        """Per-leaf fp32 arrays, dequantizing if the result is compressed
        (a delta-encoded result needs its ``quant.base`` attached)."""
        if self.parameters is None:
            if self.partial is not None:
                raise UnsupportedCodec(
                    "partial-aggregate results are pre-reduced sums, not "
                    "parameters; only weighted-sum fit accumulators "
                    "(FedAvg family) can fold them")
            if self.sparse is not None:
                raise UnsupportedCodec(
                    "sparse-delta results (0xF5) carry a TopK/adapter "
                    "delta vs a round base held by the server; only "
                    "weighted-sum fit accumulators can fold them")
            self.parameters = self.quant.to_arrays()
        return self.parameters


@dataclass
class EvaluateIns:
    parameters: NDArrays
    config: Dict[str, Any] = field(default_factory=dict)
    flat: Optional[FlatParams] = field(default=None, repr=False, compare=False)


@dataclass
class EvaluateRes:
    loss: float
    num_examples: int
    metrics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class TaskIns:
    task_type: str              # "fit" | "evaluate" | "get_parameters"
    round: int
    payload: bytes              # encoded FitIns / EvaluateIns
    task_id: str = ""
    group_id: str = ""


@dataclass
class TaskRes:
    task_type: str
    round: int
    payload: bytes              # encoded FitRes / EvaluateRes
    task_id: str = ""
    error: str = ""


def _enc_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in cfg.items():
        if isinstance(v, (int, float, str, bool, bytes)):
            out[k] = v
        elif isinstance(v, (np.floating, np.integer)):
            out[k] = v.item()
        else:
            raise TypeError(f"config value {k}={type(v)} not wire-safe")
    return out


def _materialized(p) -> FlatParams:
    """FlatParams for a client-facing decode: 0xF1 payloads arrive here
    already copied into a writable buffer (``_unframe(writable=True)``);
    quantized payloads materialize fresh (writable) fp32 arrays."""
    if isinstance(p, PartialSum):
        # the downgrade path for peers that don't speak the edge tier: a
        # partial-aggregate frame is a pre-reduced SUM, not parameters —
        # only the root's fit accumulator may consume it
        raise UnsupportedCodec(
            "partial-aggregate frame (0xF4) carries a pre-reduced subtree "
            "sum, not model parameters; it cannot be materialized — only "
            "the root server's fit accumulator consumes it")
    if isinstance(p, SparseDelta):
        raise UnsupportedCodec(
            "sparse-delta frame (0xF5) carries a TopK/adapter delta vs a "
            "round base held by the server; it cannot be decoded as "
            "standalone parameters — only the server's fit fold (base "
            "re-attached) can reconstruct")
    if isinstance(p, QuantParams):
        if p.is_delta:
            raise ValueError(
                "delta-encoded parameters cannot be decoded client-side "
                "(no round base); only fit results travel as deltas")
        return p.to_flat()
    return p


def encode_fit_ins(x: FitIns, codec: Optional[str] = None) -> bytes:
    if (codec or _DEFAULT_CODEC) == "legacy":     # skip the flatten copy
        return msgpack_lite.packb({"p": [_pack_array(a) for a in x.parameters],
                              "c": _enc_config(x.config)}, use_bin_type=True)
    return _framed_encode(x.parameters, x.flat,
                          {"c": _enc_config(x.config)}, codec)


def decode_fit_ins(b: bytes) -> FitIns:
    if _is_framed(b):
        head, p = _unframe(b, writable=True)
        fp = _materialized(p)
        return FitIns(fp.to_arrays(), head.get("c", {}), flat=fp)
    d = msgpack_lite.unpackb(b, raw=False)
    return FitIns([_unpack_array(a) for a in d["p"]], d["c"])


def encode_fit_res(x: FitRes, codec: Optional[str] = None,
                   base: Optional[FlatParams] = None,
                   sparse_frac: float = 0.01,
                   sparse_ranges=None) -> bytes:
    """``base`` (the round-start parameters) turns a lossy encode into a
    delta encode: the int8/bf16 payload is (result - base), whose smaller
    dynamic range keeps the quantization error bounded by the update
    magnitude.  The decoder reconstructs after the server re-attaches the
    base (see :func:`peek_params`).  ``codec="sparse"`` additionally
    drops coordinates: ``sparse_ranges`` keeps only those ``[start,
    stop)`` element ranges (adapter/LoRA mode), otherwise the top
    ``sparse_frac`` of |delta| coordinates travel (0xF5)."""
    if (codec or _DEFAULT_CODEC) == "legacy":     # skip the flatten copy
        return msgpack_lite.packb({"p": [_pack_array(a) for a in x.parameters],
                              "n": x.num_examples,
                              "m": _enc_config(x.metrics)},
                             use_bin_type=True)
    return _framed_encode(x.parameters, x.flat,
                          {"n": x.num_examples, "m": _enc_config(x.metrics)},
                          codec, base, sparse_frac, sparse_ranges)


def decode_fit_res(b: bytes) -> FitRes:
    with obs.span("fl.decode"):
        if _is_framed(b):
            head, p = _unframe(b)
            if isinstance(p, PartialSum):
                # edge tier: num_examples reports the contributing-client
                # count; the fold weight is p.total_w, read by the accumulator
                return FitRes(None, p.count, head.get("m", {}), partial=p)
            if isinstance(p, SparseDelta):
                # stays sparse: the fold scatters the traveled coordinates
                # once the server re-attaches the round base
                return FitRes(None, head["n"], head.get("m", {}), sparse=p)
            if isinstance(p, QuantParams):
                # hot path stays compressed: kernels stream it via f64_chunk
                return FitRes(None, head["n"], head.get("m", {}), quant=p)
            return FitRes(p.to_arrays(), head["n"], head.get("m", {}), flat=p)
        d = msgpack_lite.unpackb(b, raw=False)
        return FitRes([_unpack_array(a) for a in d["p"]], d["n"], d["m"])


def encode_partial_fit_res(ps: PartialSum,
                           metrics: Optional[Dict[str, Any]] = None
                           ) -> bytes:
    """Frame an edge aggregator's pre-reduced subtree sum (codec 0xF4).

    The payload is the raw little-endian fp64 ``Σw·x`` vector — lossless,
    so the root's fold continues the edge's accumulation bitwise.  The
    header carries the subtree total weight (``w``), contributing client
    count (``n``), sorted contributing node ids (``ids``) and absorbed
    per-node failures (``f``)."""
    head = {"l": [[l.dtype, list(l.shape)] for l in ps.layout.leaves],
            "w": float(ps.total_w), "n": int(ps.count),
            "ids": list(ps.node_ids),
            "f": [[n, r] for n, r in ps.failures],
            "m": _enc_config(metrics or {})}
    return _frame(PARTIAL_MAGIC, head,
                  np.ascontiguousarray(ps.data).view(np.uint8))


def encode_evaluate_ins(x: EvaluateIns, codec: Optional[str] = None) -> bytes:
    if (codec or _DEFAULT_CODEC) == "legacy":     # skip the flatten copy
        return msgpack_lite.packb({"p": [_pack_array(a) for a in x.parameters],
                              "c": _enc_config(x.config)}, use_bin_type=True)
    return _framed_encode(x.parameters, x.flat,
                          {"c": _enc_config(x.config)}, codec)


def decode_evaluate_ins(b: bytes) -> EvaluateIns:
    if _is_framed(b):
        head, p = _unframe(b, writable=True)
        fp = _materialized(p)
        return EvaluateIns(fp.to_arrays(), head.get("c", {}), flat=fp)
    d = msgpack_lite.unpackb(b, raw=False)
    return EvaluateIns([_unpack_array(a) for a in d["p"]], d["c"])


def encode_evaluate_res(x: EvaluateRes) -> bytes:
    return msgpack_lite.packb({"l": float(x.loss), "n": x.num_examples,
                          "m": _enc_config(x.metrics)}, use_bin_type=True)


def decode_evaluate_res(b: bytes) -> EvaluateRes:
    d = msgpack_lite.unpackb(b, raw=False)
    return EvaluateRes(d["l"], d["n"], d["m"])


def encode_properties_res(props: Dict[str, Any]) -> bytes:
    """get_properties response — plain msgpack (codec lists and friends;
    no tensor payload, so no framing needed)."""
    return msgpack_lite.packb(props, use_bin_type=True)


def decode_properties_res(b: bytes) -> Dict[str, Any]:
    return msgpack_lite.unpackb(b, raw=False)


def encode_task_ins(t: TaskIns) -> bytes:
    return msgpack_lite.packb({"t": t.task_type, "r": t.round, "p": t.payload,
                          "id": t.task_id, "g": t.group_id}, use_bin_type=True)


def decode_task_ins(b: Buffer) -> TaskIns:
    """Accepts any buffer (the TCP SuperNode pull path hands a read-only
    memoryview of the received RES frame straight in — msgpack copies the
    small envelope, the tensor payload stays a bin that downstream
    zero-copy decoders wrap without another copy)."""
    d = msgpack_lite.unpackb(b, raw=False)
    return TaskIns(d["t"], d["r"], d["p"], d["id"], d["g"])


def encode_task_res(t: TaskRes) -> bytes:
    return msgpack_lite.packb({"t": t.task_type, "r": t.round, "p": t.payload,
                          "id": t.task_id, "e": t.error}, use_bin_type=True)


def decode_task_res(b: Buffer) -> TaskRes:
    d = msgpack_lite.unpackb(b, raw=False)
    return TaskRes(d["t"], d["r"], d["p"], d["id"], d["e"])
