"""The server's aggregation fold as a hand-written Hopper kernel.

:func:`weighted_sum` computes ``(acc +) sum_c w[c] * decode(data[c])`` in
fp64 over a (clients, N) payload stack — FedAvg's weighted sum and the
streaming arrival-order fold.  It replaces the Pallas TPU kernel
``repro/kernels/agg_reduce.py:200`` (``weighted_sum``); the CUDA source,
with its note on what bounds it and how, is ``csrc/weighted_sum.cu``.

- On a CUDA tensor the wrapper launches the kernel (built by ``nvcc`` for
  ``sm_90a`` at first use, see :mod:`repro_torch.kernels._build`) or
  raises.  It never falls back.
- On a CPU tensor it runs :func:`weighted_sum_plain`, the plain PyTorch
  twin with the same arithmetic.
- Both are **bitwise** equal to the numpy engine
  (:mod:`repro_torch.fl.agg_kernels`, ``backend="numpy"``): int8 payloads
  dequantize as ``f64(f32(q * scale))``, every other float widens
  exactly, a delta payload adds its fp64 base, then each client's term is
  multiplied by its weight and added, one rounding per operation, clients
  in order.  That is why the twin is written as separate ops: a fused
  ``acc.add_(t, alpha=w)`` or ``torch.addcmul`` runs ``a + w*b`` inside one
  CUDA kernel compiled with FMA contraction, and would no longer round
  like numpy.

Payload dtypes: ``torch.int8`` (with ``scales`` (C, ceil(N/qchunk)) fp32),
``torch.float16``, ``torch.bfloat16``, ``torch.float32``, ``torch.float64``.
"""
from __future__ import annotations

import ctypes
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.fl.flat import is_bf16

DEFAULT_QCHUNK = 1024

#: kernel launches per wrapper; the main path's runs read these
LAUNCHES = {"weighted_sum": 0}

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
# the plain twin
# ---------------------------------------------------------------------------
def _decode_plain(row: torch.Tensor, srow: Optional[torch.Tensor],
                  qchunk: int) -> torch.Tensor:
    if row.dtype == torch.int8:
        s = srow.repeat_interleave(qchunk)[:row.numel()]
        return (row.to(torch.float32) * s).to(torch.float64)
    return row.to(torch.float64)


def weighted_sum_plain(data: torch.Tensor, weights: torch.Tensor, *,
                       scales: Optional[torch.Tensor] = None,
                       qchunk: int = DEFAULT_QCHUNK,
                       base: Optional[torch.Tensor] = None,
                       acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch, one op per rounding."""
    a = acc
    for c in range(data.shape[0]):
        v = _decode_plain(data[c], None if scales is None else scales[c],
                          qchunk)
        if base is not None:
            v = v + base
        v = v * weights[c]
        a = v if a is None else a + v
    return a.clone() if a is acc else a


# ---------------------------------------------------------------------------
# the wrapper
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


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def weighted_sum(data: torch.Tensor, weights: torch.Tensor, *,
                 scales: Optional[torch.Tensor] = None,
                 qchunk: int = DEFAULT_QCHUNK,
                 base: Optional[torch.Tensor] = None,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(acc +) sum_c weights[c] * decode(data[c])`` as one fused pass.

    ``data``: (C, N) payload stack; ``weights``: (C,) fp64; ``scales``:
    (C, ceil(N/qchunk)) fp32, given exactly when ``data`` is int8;
    ``base``: shared (N,) fp64 round-start vector of delta payloads;
    ``acc``: (N,) fp64 running accumulator the C rows fold into.  All on
    one device.  Returns a new (N,) fp64 tensor.
    """
    if data.dim() != 2:
        raise ValueError(f"data must be (C, N), got shape {tuple(data.shape)}")
    if data.dtype not in _KIND:
        raise TypeError(f"unsupported payload dtype {data.dtype}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    c, n = data.shape
    dev = data.device
    q8 = data.dtype == torch.int8
    if q8 and (scales is None or qchunk < 1):
        raise ValueError("int8 payloads need scales and qchunk >= 1")
    if not q8 and scales is not None:
        raise ValueError("scales are only for int8 payloads")
    _check(weights, "weights", (c,), torch.float64, dev)
    _check(scales, "scales", (c, -(-n // qchunk)), torch.float32, dev)
    _check(base, "base", (n,), torch.float64, dev)
    _check(acc, "acc", (n,), torch.float64, dev)
    if c == 0 and acc is None:
        raise ValueError("an empty stack needs an accumulator")
    if dev.type == "cpu":
        return weighted_sum_plain(data, weights, scales=scales,
                                  qchunk=qchunk, base=base, acc=acc)
    if dev.type != "cuda":
        raise ValueError(f"weighted_sum runs on cuda or cpu, not {dev}")
    if n == 0 or c == 0:
        return acc.clone() if acc is not None else \
            torch.empty(0, dtype=torch.float64, device=dev)
    lib = _kernel_lib()
    out = torch.empty(n, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_weighted_sum(
            _KIND[data.dtype], data.data_ptr(), _ptr(scales), int(qchunk),
            0 if scales is None else scales.shape[1], _ptr(base), _ptr(acc),
            weights.data_ptr(), out.data_ptr(), c, n, stream)
    if err != 0:
        raise RuntimeError(f"weighted_sum kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["weighted_sum"] += 1
    return out


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("weighted_sum")
    fn = lib.repro_weighted_sum
    if fn.argtypes is None:
        p, i64 = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, p, p, i64, i64, p, p, p, p, i64, i64,
                       p]
        fn.restype = ctypes.c_int
    return lib
