"""The SecAgg upload's fused quantize + pairwise mask as a hand-written
Hopper kernel, replacing the Pallas TPU kernel
``repro/kernels/secagg_mask.py:36``.

``out = int32(sat(round_half_even(f32(x) * w * 2^bits))) + sum_p masks[p]``,
wrapping mod 2^32: ``x`` is ``(N,)`` fp32, ``masks`` is ``(P, N)`` int32
(each peer's mask with its sign already applied; ``P = 0`` is allowed),
``w`` a scalar taken as fp32.  The product is rounded in fp32 left to
right, ``(x * w) * 2^bits``, and rounded half to even.  The conversion
saturates as the reference's clip-then-convert does: in fp32 the clip's
upper end ``2**31 - 1`` is ``2**31``, which converts to ``2147483647``, so
an overflow or ``+inf`` gives ``2147483647``, ``-inf`` gives
``-2147483648`` and NaN gives 0.

- :func:`secagg_mask` on a CUDA tensor launches ``csrc/secagg_mask.cu``
  (built by ``nvcc`` for ``sm_90a`` at first use, with ``-fmad=false``;
  see :mod:`repro_torch.kernels._build`) or raises; it never falls back.
  On a CPU tensor it runs :func:`secagg_mask_plain`.
- :func:`secagg_mask_plain` is the twin: the fp32 product and
  ``torch.round``, then the saturation written out (NaN to 0, the clip in
  fp64, where both ends are exact), and the masks summed in int64 with
  the low 32 bits kept.  The kernel equals it exactly.

Both paths take fp32 ``x`` and int32 ``masks`` on one device, contiguous,
and raise on anything else.  The JAX package has no caller of this kernel
beyond its public wrapper; the port's is :func:`repro_torch.kernels.ops
.secagg_mask`.  SecAggMod keeps the reference's numpy uint64 field.
"""
from __future__ import annotations

import ctypes

import torch

#: kernel launches of the wrapper; the main path's runs read it
LAUNCHES = {"secagg_mask": 0}

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def _check(x: torch.Tensor, masks: torch.Tensor, quant_bits: int) -> None:
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N,) float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if masks.dim() != 2 or masks.dtype != torch.int32 \
            or masks.shape[1] != x.shape[0] or not masks.is_contiguous():
        raise ValueError(f"masks must be a contiguous (P, {x.shape[0]}) "
                         f"int32 tensor, got {masks.dtype} "
                         f"{tuple(masks.shape)}")
    if masks.device != x.device:
        raise ValueError("x and masks must lie on one device")
    if not 0 <= quant_bits < 64:
        raise ValueError(f"quant_bits must be in [0, 64), got {quant_bits}")


def secagg_mask(x: torch.Tensor, masks: torch.Tensor, weight: float, *,
                quant_bits: int = 16) -> torch.Tensor:
    """The masked int32 share of ``x``: the kernel on a CUDA tensor, the
    twin on a CPU one.  Returns a new ``(N,)`` int32 tensor."""
    _check(x, masks, quant_bits)
    dev = x.device
    if dev.type == "cpu":
        return secagg_mask_plain(x, masks, weight, quant_bits=quant_bits)
    if dev.type != "cuda":
        raise ValueError(f"secagg_mask runs on cuda or cpu, not {dev}")
    n, p = x.shape[0], masks.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_secagg_mask(
            x.data_ptr(), masks.data_ptr() if p else None, out.data_ptr(),
            float(weight), float(2 ** quant_bits), p, n, stream)
    if err != 0:
        raise RuntimeError(f"secagg_mask kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["secagg_mask"] += 1
    return out


def secagg_mask_plain(x: torch.Tensor, masks: torch.Tensor, weight: float,
                      *, quant_bits: int = 16) -> torch.Tensor:
    """The kernel's arithmetic in eager PyTorch."""
    w = torch.tensor(weight, dtype=torch.float32, device=x.device)
    scale = torch.tensor(float(2 ** quant_bits), dtype=torch.float32,
                         device=x.device)
    r = torch.round((x * w) * scale)
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    q = r.to(torch.float64).clamp(_I32_MIN, _I32_MAX).to(torch.int64)
    for p in range(masks.shape[0]):
        q = q + masks[p].to(torch.int64)
    q = q & 0xFFFFFFFF
    return torch.where(q > _I32_MAX, q - 2 ** 32, q).to(torch.int32)


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, ctypes.c_float, ctypes.c_float, _LL, _LL, _P]


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("secagg_mask")
    fn = lib.repro_secagg_mask
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    return lib
