"""The server's aggregation reductions as hand-written Hopper kernels.

Three kernels over a (clients, N) payload stack, each replacing a Pallas
TPU kernel of ``repro/kernels/agg_reduce.py``, and the sparse scatter
fold; each CUDA source carries its note on what bounds it and how:

- :func:`weighted_sum` (``csrc/weighted_sum.cu``, replaces ``:200``):
  ``(acc +) sum_c w[c] * decode(data[c])`` in fp64 — FedAvg's weighted
  sum, the streaming arrival-order fold and Krum's final mean.  With
  ``tile_dtype="float32"`` (the reference's fp32 tiles, which its sharded
  fold selects) the decode and the weight product round in fp32 and only
  the carry is fp64; that mode is held to a tolerance against the fp64
  one, and bitwise against its own twin.
- :func:`sort_reduce` (``csrc/sort_reduce.cu``, replaces ``:283``): per
  column, the median of the C decoded values, or the sum of the sorted
  rows ``[trim_k, C - trim_k)`` (FedMedian, FedTrimmedMean; the caller
  divides).
- :func:`gram` (``csrc/gram.cu``, replaces ``:339``): Krum's (C, C) fp64
  Gram matrix of the stack centred on row 0.
- :func:`scatter_wsum` (``csrc/scatter_wsum.cu``, replaces ``:396``, which
  is an XLA graph plus a host scatter rather than a ``pallas_call``):
  ``acc[dest] += w * dequant(vals)`` in place, the 0xF5 sparse fold.  Its
  fold stages each arrival once per card through a reused page-locked
  buffer (:class:`PinnedStage`), and the wrapper checks an index on the
  card.
- :func:`decode_rows` (``csrc/decode_rows.cu``): the wire decode alone,
  a payload stack into rows of an fp64 stack, so that a round whose
  clients differ in codec or base reaches ``sort_reduce`` and ``gram`` as
  one float64 stack (the numpy engine decodes such a round per client).

For each:

- On a CUDA tensor the wrapper launches the kernel (built by ``nvcc`` for
  ``sm_90a`` at first use, see :mod:`repro_torch.kernels._build`) or
  raises.  It never falls back.
- On a CPU tensor it runs the plain PyTorch twin (``*_plain``).
- ``weighted_sum`` (fp64 tiles), ``sort_reduce``, ``scatter_wsum`` and
  ``decode_rows`` (up to the payload bits of a NaN) are
  **bitwise** equal to the numpy
  engine (:mod:`repro_torch.fl.agg_kernels`, ``backend="numpy"``): int8
  payloads dequantize as ``f64(f32(q * scale))``, every other float
  widens exactly, a delta payload adds its fp64 base, one rounding per
  operation, clients (or sorted rows) in order.  That is why the twins are
  written as separate ops: a fused ``acc.add_(t, alpha=w)`` or
  ``torch.addcmul`` runs ``a + w*b`` inside one CUDA kernel compiled with
  FMA contraction, and would no longer round like numpy.  ``gram`` is held
  to a tolerance (its products run on the fp64 tensor cores, summed in
  another order than numpy's dgemm), and is bitwise equal to itself from
  run to run.
- Outputs that are NaN are the canonical quiet NaN (``float("nan")``), in
  the kernels and the twins alike.

Payload dtypes: ``torch.int8`` (with ``scales`` (C, ceil(N/qchunk)) fp32),
``torch.float16``, ``torch.bfloat16``, ``torch.float32``, ``torch.float64``.
``sort_reduce`` and ``gram`` take any number of clients from 1.
"""
from __future__ import annotations

import ctypes
import threading
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.fl.flat import is_bf16

DEFAULT_QCHUNK = 1024

#: kernel launches per wrapper; the main path's runs read these.  Folds of
#: concurrent jobs launch from several threads, so each count moves under
#: ``_LAUNCHES_LOCK``
LAUNCHES = {"weighted_sum": 0, "sort_reduce": 0, "gram": 0,
            "scatter_wsum": 0, "decode_rows": 0}
_LAUNCHES_LOCK = threading.Lock()

TILE_DTYPES = ("float64", "float32")

_NAN = float("nan")

_KIND = {torch.int8: 0, torch.float16: 1, torch.bfloat16: 2,
         torch.float32: 3, torch.float64: 4}


# ---------------------------------------------------------------------------
# host <-> device helpers for the numpy engine's payloads
# ---------------------------------------------------------------------------
def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """Zero-copy CPU tensor over a numpy array (bf16 bit arrays become
    ``torch.bfloat16``).  Payloads borrow read-only transport buffers;
    the tensors made here are only read."""
    a = np.ascontiguousarray(a)
    bf16 = is_bf16(a.dtype)
    if bf16:
        a = a.view(np.int16)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (a copy unless the device
    is the CPU)."""
    return _host_tensor(a).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array (waits for the device)."""
    return t.detach().cpu().numpy()


class PinnedStage:
    """A page-locked host buffer, reused, through which 1-D host arrays go
    to a card.  :meth:`to_device` writes the arrays into it chunk by chunk
    and sends each chunk (``non_blocking``) as soon as it is written, so
    the host copy of one chunk overlaps the transfer of the last.  The
    buffer is written again only after the last transfer out of it has
    ended."""

    #: bytes a chunk
    CHUNK = 1 << 24
    #: each array starts on a 16-byte boundary of the buffer
    ALIGN = 16

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None
        self._sent: Optional[torch.cuda.Event] = None

    def to_device(self, arrays: Sequence[Optional[np.ndarray]],
                  device) -> list:
        """Each array as a tensor on ``device`` (None stays None), views of
        one device buffer; the copies run on ``device``'s current stream."""
        host = [None if a is None else _host_tensor(a) for a in arrays]
        offs, total = [], 0
        for t in host:
            offs.append(total)
            if t is not None:
                nb = t.numel() * t.element_size()
                total += -(-nb // self.ALIGN) * self.ALIGN
        if self._sent is not None:
            self._sent.synchronize()
        if self._buf is None or self._buf.numel() < total:
            self._buf = torch.empty(max(total, 1), dtype=torch.uint8,
                                    pin_memory=True)
        with torch.cuda.device(device):
            out = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
            for t, off in zip(host, offs):
                raw = torch.empty(0, dtype=torch.uint8) if t is None \
                    else t.view(torch.uint8)
                for c in range(0, raw.numel(), self.CHUNK):
                    e = min(c + self.CHUNK, raw.numel())
                    pin = self._buf[off + c:off + e]
                    pin.copy_(raw[c:e])
                    out[off + c:off + e].copy_(pin, non_blocking=True)
            self._sent = torch.cuda.Event()
            self._sent.record(torch.cuda.current_stream(device))
        return [None if t is None
                else out[off:off + t.numel() * t.element_size()].view(t.dtype)
                for t, off in zip(host, offs)]


def stack_to_device(rows: Sequence[np.ndarray], device) -> torch.Tensor:
    """Copy C equal-length host rows of one dtype into one (C, N) tensor on
    ``device``, row by row, with no host-side stack (bf16 bit rows become
    ``torch.bfloat16``)."""
    first = _host_tensor(rows[0])
    out = torch.empty((len(rows), first.numel()), dtype=first.dtype,
                      device=device)
    for i, r in enumerate(rows):
        out[i].copy_(first if i == 0 else _host_tensor(r))
    return out


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------
def _decode_plain(row: torch.Tensor, srow: Optional[torch.Tensor],
                  qchunk: int) -> torch.Tensor:
    if row.dtype == torch.int8:
        s = srow.repeat_interleave(qchunk)[:row.numel()]
        return (row.to(torch.float32) * s).to(torch.float64)
    return row.to(torch.float64)


def _decoded_plain(data: torch.Tensor, scales: Optional[torch.Tensor],
                   qchunk: int, base: Optional[torch.Tensor]) -> torch.Tensor:
    """The (C, N) fp64 decoded stack (delta base added)."""
    rows = []
    for c in range(data.shape[0]):
        v = _decode_plain(data[c], None if scales is None else scales[c],
                          qchunk)
        rows.append(v if base is None else v + base)
    return torch.stack(rows)


def decode_rows_plain(data: torch.Tensor, *,
                      scales: Optional[torch.Tensor] = None,
                      qchunk: int = DEFAULT_QCHUNK,
                      base: Optional[torch.Tensor] = None,
                      out: Optional[torch.Tensor] = None,
                      row0: int = 0) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch: the decoded stack (delta
    base added), written to ``out[row0:row0 + C]`` when ``out`` is given."""
    x = _decoded_plain(data, scales, qchunk, base)
    if out is None:
        return x
    out[row0:row0 + data.shape[0]] = x
    return out


def _decode32_plain(row: torch.Tensor, srow: Optional[torch.Tensor],
                    qchunk: int) -> torch.Tensor:
    """One row as fp32 tiles decode it: int8 as ``f32(q * scale)``, every
    float payload cast to fp32 (fp64 rounds)."""
    if row.dtype == torch.int8:
        s = srow.repeat_interleave(qchunk)[:row.numel()]
        return row.to(torch.float32) * s
    return row.to(torch.float32)


def weighted_sum_plain(data: torch.Tensor, weights: torch.Tensor, *,
                       scales: Optional[torch.Tensor] = None,
                       qchunk: int = DEFAULT_QCHUNK,
                       base: Optional[torch.Tensor] = None,
                       acc: Optional[torch.Tensor] = None,
                       tile_dtype: str = "float64") -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch, one op per rounding.
    fp32 tiles: ``f64(decode32(row) * f32(w))`` added to the fp64 carry."""
    a = acc
    for c in range(data.shape[0]):
        srow = None if scales is None else scales[c]
        if tile_dtype == "float32":
            v = (_decode32_plain(data[c], srow, qchunk)
                 * weights[c].to(torch.float32)).to(torch.float64)
        else:
            v = _decode_plain(data[c], srow, qchunk)
            if base is not None:
                v = v + base
            v = v * weights[c]
        a = v if a is None else a + v
    return a.clone() if a is acc else a


def sort_reduce_plain(data: torch.Tensor, *, kind: str = "median",
                      trim_k: int = 0,
                      scales: Optional[torch.Tensor] = None,
                      qchunk: int = DEFAULT_QCHUNK,
                      base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch: sort each column (NaNs
    last), then add the chosen sorted rows to ``+0.0`` one at a time
    (numpy's reduction: its identity first, rows in order)."""
    c = data.shape[0]
    s = torch.sort(_decoded_plain(data, scales, qchunk, base), dim=0).values
    a = torch.zeros(data.shape[1], dtype=torch.float64, device=data.device)
    if kind == "median":
        lo, hi = (c - 1) // 2, c // 2
        a = a + s[lo]
        if hi != lo:
            a = (a + s[hi]) / 2.0
        a = torch.where(torch.isnan(s[c - 1]), _NAN, a)
    else:
        for r in range(trim_k, c - trim_k):
            a = a + s[r]
    return torch.where(torch.isnan(a), _NAN, a)


def gram_plain(data: torch.Tensor, *, scales: Optional[torch.Tensor] = None,
               qchunk: int = DEFAULT_QCHUNK,
               base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (C, C) Gram matrix of the stack centred on row 0, as
    elementwise products and sums in eager PyTorch, one row at a time
    (no matrix product)."""
    x = _decoded_plain(data, scales, qchunk, base)
    t = x - x[0]
    del x
    g = torch.empty((data.shape[0],) * 2, dtype=torch.float64,
                    device=data.device)
    for a in range(data.shape[0]):
        g[a] = (t[a] * t).sum(dim=1)
    return g


def scatter_wsum_plain(acc: torch.Tensor, dest, vals: torch.Tensor,
                       w: float, *, scales: Optional[torch.Tensor] = None,
                       qchunk: int = DEFAULT_QCHUNK, pos0: int = 0) -> None:
    """The kernel's arithmetic in eager PyTorch, in place, one op per
    rounding: ``r = f64(f32(q * scale[(pos0 + i) // qchunk]))`` (or the
    fp32 value widened), ``acc[d] = acc[d] + r * w``.  ``dest`` is a start
    offset (the slice ``acc[dest:dest + nnz]``) or an index tensor."""
    n = vals.numel()
    if n == 0:
        return
    if vals.dtype == torch.int8:
        idx = torch.div(pos0 + torch.arange(n, device=vals.device), qchunk,
                        rounding_mode="floor")
        r = (vals.to(torch.float32) * scales[idx]).to(torch.float64)
    else:
        r = vals.to(torch.float64)
    r = r * float(w)
    if isinstance(dest, int):
        seg = acc[dest:dest + n]
        seg.copy_(seg + r)
    else:
        acc[dest] = acc[dest] + r


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
def _check(t: Optional[torch.Tensor], name: str, shape, dtype,
           device: torch.device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, data on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_stack(data: torch.Tensor, scales: Optional[torch.Tensor],
                 qchunk: int, base: Optional[torch.Tensor]):
    """The operand checks all three kernels share; returns (C, N)."""
    if data.dim() != 2:
        raise ValueError(f"data must be (C, N), got shape {tuple(data.shape)}")
    if data.dtype not in _KIND:
        raise TypeError(f"unsupported payload dtype {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    c, n = data.shape
    q8 = data.dtype == torch.int8
    if q8 and (scales is None or qchunk < 1):
        raise ValueError("int8 payloads need scales and qchunk >= 1")
    if not q8 and scales is not None:
        raise ValueError("scales are only for int8 payloads")
    if scales is not None:
        _check(scales, "scales", (c, -(-n // qchunk)), torch.float32,
               data.device)
    _check(base, "base", (n,), torch.float64, data.device)
    return c, n


def _check_clients(c: int, what: str) -> None:
    if c < 1:
        raise ValueError(f"{what} takes at least one client, got {c}")


def _on_cuda(dev: torch.device, what: str) -> bool:
    """False for the CPU (the twin runs); True for CUDA; raises else."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return True


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _nscales(scales: Optional[torch.Tensor]) -> int:
    return 0 if scales is None else scales.shape[1]


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def weighted_sum(data: torch.Tensor, weights: torch.Tensor, *,
                 scales: Optional[torch.Tensor] = None,
                 qchunk: int = DEFAULT_QCHUNK,
                 base: Optional[torch.Tensor] = None,
                 acc: Optional[torch.Tensor] = None,
                 tile_dtype: str = "float64") -> torch.Tensor:
    """``(acc +) sum_c weights[c] * decode(data[c])`` as one fused pass.

    ``data``: (C, N) payload stack; ``weights``: (C,) fp64; ``scales``:
    (C, ceil(N/qchunk)) fp32, given exactly when ``data`` is int8;
    ``base``: shared (N,) fp64 round-start vector of delta payloads;
    ``acc``: (N,) fp64 running accumulator the C rows fold into.  All on
    one device.  ``tile_dtype="float32"`` decodes and weights each element
    in fp32 and adds it to the fp64 carry; it takes no ``base``.  Returns a
    new (N,) fp64 tensor.
    """
    if tile_dtype not in TILE_DTYPES:
        raise ValueError(f"tile_dtype must be one of {TILE_DTYPES}, got "
                         f"{tile_dtype!r}")
    if tile_dtype == "float32" and base is not None:
        raise ValueError("tile_dtype='float32' requires base=None "
                         "(defer the delta base to finalize)")
    c, n = _check_stack(data, scales, qchunk, base)
    dev = data.device
    _check(weights, "weights", (c,), torch.float64, dev)
    _check(acc, "acc", (n,), torch.float64, dev)
    if c == 0 and acc is None:
        raise ValueError("an empty stack needs an accumulator")
    if not _on_cuda(dev, "weighted_sum"):
        return weighted_sum_plain(data, weights, scales=scales,
                                  qchunk=qchunk, base=base, acc=acc,
                                  tile_dtype=tile_dtype)
    if n == 0 or c == 0:
        return acc.clone() if acc is not None else \
            torch.empty(0, dtype=torch.float64, device=dev)
    lib = _kernel_lib("weighted_sum")
    out = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_weighted_sum(
            _KIND[data.dtype], data.data_ptr(), _ptr(scales), int(qchunk),
            _nscales(scales), _ptr(base), _ptr(acc), weights.data_ptr(),
            out.data_ptr(), c, n, int(tile_dtype == "float32"), stream)
    _launched("weighted_sum", err)
    return out


def sort_reduce(data: torch.Tensor, *, kind: str = "median",
                trim_k: int = 0, scales: Optional[torch.Tensor] = None,
                qchunk: int = DEFAULT_QCHUNK,
                base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per column of the decoded (C, N) stack: ``kind="median"`` gives the
    median (NaN where the column holds a NaN); ``kind="trim_sum"`` gives
    the SUM of the sorted rows ``[trim_k, C - trim_k)``, which the caller
    divides by ``C - 2*trim_k`` (numpy's mean: sum, then one divide).
    Operands as for :func:`weighted_sum`.  Returns a new (N,) fp64
    tensor."""
    c, n = _check_stack(data, scales, qchunk, base)
    _check_clients(c, "sort_reduce")
    if kind not in ("median", "trim_sum"):
        raise ValueError(f"kind must be 'median' or 'trim_sum', got {kind!r}")
    if kind == "trim_sum" and not (trim_k >= 0 and c - 2 * trim_k >= 1):
        raise ValueError(f"trim_k={trim_k} leaves no row of {c}")
    dev = data.device
    if not _on_cuda(dev, "sort_reduce"):
        return sort_reduce_plain(data, kind=kind, trim_k=trim_k,
                                 scales=scales, qchunk=qchunk, base=base)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    lib = _kernel_lib("sort_reduce")
    nkeys = lib.repro_sort_reduce_scratch(c, n)
    scratch = (torch.empty(nkeys, dtype=torch.int64, device=dev)
               if nkeys else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_sort_reduce(
            _KIND[data.dtype], data.data_ptr(), _ptr(scales), int(qchunk),
            _nscales(scales), _ptr(base), out.data_ptr(), _ptr(scratch), c,
            n, int(kind == "median"), int(trim_k), stream)
    _launched("sort_reduce", err)
    return out


def gram(data: torch.Tensor, *, scales: Optional[torch.Tensor] = None,
         qchunk: int = DEFAULT_QCHUNK,
         base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(C, C) fp64 Gram matrix of the decoded stack centred on row 0,
    ``t = x - x[0]``, ``G = t @ t.T`` (Krum's distances come from it).
    Operands as for :func:`weighted_sum`.  The kernel sums in a fixed
    order: the same input gives the same bits on every run."""
    c, n = _check_stack(data, scales, qchunk, base)
    _check_clients(c, "gram")
    dev = data.device
    if not _on_cuda(dev, "gram"):
        return gram_plain(data, scales=scales, qchunk=qchunk, base=base)
    if n == 0:
        return torch.zeros((c, c), dtype=torch.float64, device=dev)
    lib = _kernel_lib("gram")
    out = torch.empty((c, c), dtype=torch.float64, device=dev)
    partial = torch.empty(lib.repro_gram_scratch(c, n),
                          dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_gram(
            _KIND[data.dtype], data.data_ptr(), _ptr(scales), int(qchunk),
            _nscales(scales), _ptr(base), partial.data_ptr(),
            out.data_ptr(), c, n, stream)
    _launched("gram", err)
    return out


def decode_rows(data: torch.Tensor, *, scales: Optional[torch.Tensor] = None,
                qchunk: int = DEFAULT_QCHUNK,
                base: Optional[torch.Tensor] = None,
                out: Optional[torch.Tensor] = None,
                row0: int = 0) -> torch.Tensor:
    """The decoded (C, N) fp64 stack, ``decode(data[c]) (+ base)`` with no
    other operation (signed zeros kept; a NaN stays a NaN, with the
    device's payload bits, which the reductions canonicalize), written to
    rows ``[row0, row0 + C)`` of ``out`` (a contiguous (M, N) fp64 tensor
    on the data's device) and returned; a new (C, N) tensor when ``out``
    is None.  Operands as for :func:`weighted_sum`."""
    c, n = _check_stack(data, scales, qchunk, base)
    dev = data.device
    if out is None:
        out = torch.empty((c, n), dtype=torch.float64, device=dev)
    if out.dim() != 2 or out.shape[1] != n:
        raise ValueError(f"out must be (M, {n}), got {tuple(out.shape)}")
    _check(out, "out", tuple(out.shape), torch.float64, dev)
    if not 0 <= row0 <= out.shape[0] - c:
        raise ValueError(f"rows [{row0}, {row0 + c}) are outside out's "
                         f"{out.shape[0]}")
    if not _on_cuda(dev, "decode_rows"):
        return decode_rows_plain(data, scales=scales, qchunk=qchunk,
                                 base=base, out=out, row0=row0)
    if n == 0 or c == 0:
        return out
    lib = _kernel_lib("decode_rows")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_decode_rows(
            _KIND[data.dtype], data.data_ptr(), _ptr(scales), int(qchunk),
            _nscales(scales), _ptr(base), out[row0].data_ptr(), c, n, stream)
    _launched("decode_rows", err)
    return out


def _slice_start(dest, nnz: int) -> int:
    """The start offset of a ``slice`` (step 1) or int destination."""
    if isinstance(dest, slice):
        if dest.step not in (None, 1):
            raise ValueError(f"dest slice must have step 1, got {dest}")
        start = 0 if dest.start is None else int(dest.start)
        if dest.stop is not None and int(dest.stop) - start != nnz:
            raise ValueError(f"dest {dest} does not hold {nnz} values")
        return start
    return int(dest)


def scatter_wsum(acc: torch.Tensor, dest, vals: torch.Tensor, w: float, *,
                 scales: Optional[torch.Tensor] = None,
                 qchunk: int = DEFAULT_QCHUNK, pos0: int = 0) -> None:
    """``acc[dest] += w * dequant(vals)`` in place — the 0xF5 sparse fold.

    ``acc``: (M,) fp64 accumulator, updated in place.  ``dest``: a start
    offset or a ``slice`` (step 1) — the run ``acc[d0:d0 + nnz]`` — or a
    (nnz,) int64 tensor of unique indices into ``acc``.  ``vals``: (nnz,)
    int8 with ``scales``, the fp32 scales of the whole packed value stream
    (value ``i`` uses ``scales[(pos0 + i) // qchunk]``), or (nnz,) fp32.
    ``vals``, ``scales`` and an index tensor may lie on the CPU while
    ``acc`` lies on the card: they are copied to ``acc``'s device.  Every
    destination is checked to lie inside ``acc`` before anything is
    launched: an index tensor on ``acc``'s device (copied there first if it
    is not) by one min/max there and one sync of its two scalars; a bad
    index raises ``IndexError`` with ``acc`` untouched.  ``nnz = 0``
    launches nothing.
    """
    if acc.dim() != 1 or acc.dtype != torch.float64 \
            or not acc.is_contiguous():
        raise ValueError("acc must be a contiguous 1-D fp64 tensor")
    if vals.dim() != 1 or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous 1-D tensor")
    nnz = vals.numel()
    q8 = vals.dtype == torch.int8
    if not q8 and vals.dtype != torch.float32:
        raise TypeError(f"vals must be int8 or float32, got {vals.dtype}")
    if q8:
        if scales is None or scales.dim() != 1 \
                or scales.dtype != torch.float32 \
                or not scales.is_contiguous():
            raise ValueError("int8 vals need 1-D contiguous fp32 scales")
        if qchunk < 1 or pos0 < 0:
            raise ValueError(f"qchunk={qchunk}, pos0={pos0}")
        if nnz and (pos0 + nnz - 1) // qchunk >= scales.numel():
            raise ValueError(f"scales ({scales.numel()}) do not cover "
                             f"packed positions [{pos0}, {pos0 + nnz})")
    elif scales is not None:
        raise ValueError("scales are only for int8 vals")
    if isinstance(dest, torch.Tensor):
        if dest.dim() != 1 or dest.dtype != torch.int64 \
                or dest.numel() != nnz or not dest.is_contiguous():
            raise ValueError("dest must be a contiguous (nnz,) int64 "
                             "tensor")
        d0 = 0
    else:
        d0 = _slice_start(dest, nnz)
        if d0 < 0 or d0 + nnz > acc.numel():
            raise IndexError(f"dest [{d0}, {d0 + nnz}) outside acc of "
                             f"{acc.numel()}")
    if nnz == 0:
        return
    dev = acc.device
    index = None
    if isinstance(dest, torch.Tensor):
        index = dest.to(dev)
        lo, hi = torch.stack(torch.aminmax(index)).tolist()
        if lo < 0 or hi >= acc.numel():
            raise IndexError(f"dest indices [{lo}, {hi}] outside acc "
                             f"of {acc.numel()}")
    vals = vals.to(dev)
    scales = None if scales is None else scales.to(dev)
    if not _on_cuda(dev, "scatter_wsum"):
        return scatter_wsum_plain(acc, d0 if index is None else index, vals,
                                  w, scales=scales, qchunk=qchunk, pos0=pos0)
    lib = _kernel_lib("scatter_wsum")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_scatter_wsum(
            acc.data_ptr(), _ptr(index), d0, vals.data_ptr(), int(q8),
            _ptr(scales), int(qchunk), int(pos0), float(w), nnz, stream)
    _launched("scatter_wsum", err)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signature of each library's entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "weighted_sum": {"repro_weighted_sum": (
        [_I, _P, _P, _LL, _LL, _P, _P, _P, _P, _LL, _LL, _I, _P], _I)},
    "sort_reduce": {"repro_sort_reduce": (
        [_I, _P, _P, _LL, _LL, _P, _P, _P, _LL, _LL, _I, _LL, _P], _I),
        "repro_sort_reduce_scratch": ([_LL, _LL], _LL)},
    "gram": {"repro_gram": (
        [_I, _P, _P, _LL, _LL, _P, _P, _P, _LL, _LL, _P], _I),
        "repro_gram_scratch": ([_LL, _LL], _LL)},
    "decode_rows": {"repro_decode_rows": (
        [_I, _P, _P, _LL, _LL, _P, _P, _LL, _LL, _P], _I)},
    "scatter_wsum": {"repro_scatter_wsum": (
        [_P, _P, _LL, _P, _I, _P, _LL, _LL, ctypes.c_double, _LL, _P], _I),
        "repro_scatter_floor": ([_P, _P, ctypes.c_double, _LL, _P], _I)},
}


def _kernel_lib(name: str) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load(name)
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.restype = restype
            fn.argtypes = argtypes
    return lib
