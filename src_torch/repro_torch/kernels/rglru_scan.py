"""The RG-LRU linear recurrence as a hand-written Hopper kernel, replacing
the Pallas TPU kernel ``repro/kernels/rglru_scan.py:51``.

``h_t = a_t * h_{t-1} + b_t`` from ``h0``: ``a`` and ``b`` are ``(B, S, W)``
fp32, ``h0`` is ``(B, W)`` fp32; the result is every ``h_t`` as ``ys``
``(B, S, W)`` and the last one, ``h_final`` ``(B, W)``.

- :func:`rglru_scan` on a CUDA tensor launches ``csrc/rglru_scan.cu``
  (built by ``nvcc`` for ``sm_90a`` at first use, with ``-fmad=false``;
  see :mod:`repro_torch.kernels._build`) or raises; it never falls back.
  The kernel keeps the sequential chain, one thread per column, and feeds
  it from a ring of shared-memory stages filled by ``cp.async`` (:data:`RING`).
  On a CPU tensor it runs :func:`rglru_scan_plain`.
- :func:`rglru_scan_plain` is the twin: the same loop in PyTorch, one
  rounded multiply and one rounded add per step, so the kernel is bitwise
  equal to it on the card.

Both paths take fp32 tensors whose last axis is contiguous, with matching
shapes, on one device; anything else raises, on either device.  ``S = 0``
gives an empty ``ys`` and ``h0``, and launches nothing.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

#: kernel launches of the wrapper; the main path's runs read it
LAUNCHES = {"rglru_scan": 0}

#: the kernel's shared-memory ring (``csrc/rglru_scan.cu`` ``kCols``,
#: ``kSteps``, ``kStages``): columns per CTA, steps per stage, stages.  The
#: card's edge cases sit on its boundaries; a CPU test holds these to the
#: source.
RING = {"cols": 32, "steps": 32, "stages": 6}


def _check(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3 or h0.dim() != 2:
        raise ValueError("a and b must be (B, S, W) and h0 (B, W)")
    if any(t.dtype != torch.float32 for t in (a, b, h0)):
        raise TypeError(f"a, b and h0 must be float32, got {a.dtype}, "
                        f"{b.dtype}, {h0.dtype}")
    if a.shape != b.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)} and h0 "
                         f"{tuple(h0.shape)} do not match")
    if not (a.device == b.device == h0.device):
        raise ValueError("a, b and h0 must lie on one device")
    if any(t.shape[-1] > 1 and t.stride(-1) != 1 for t in (a, b, h0)):
        raise ValueError("the last axis of a, b and h0 must be contiguous")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ys, h_final)`` of the recurrence: the kernel on a CUDA tensor,
    the twin on a CPU one."""
    _check(a, b, h0)
    dev = a.device
    if dev.type == "cpu":
        return rglru_scan_plain(a, b, h0)
    if dev.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {dev}")
    B, S, W = a.shape
    ys = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    if S == 0 or a.numel() == 0:
        return ys, h0.clone()
    h_final = torch.empty((B, W), dtype=torch.float32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_rglru_scan(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            h_final.data_ptr(), B, S, W, a.stride(0), a.stride(1),
            b.stride(0), b.stride(1), h0.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["rglru_scan"] += 1
    return ys, h_final


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's twin: ``h = a[:, t] * h + b[:, t]`` for t = 0..S-1,
    two rounded ops per step."""
    ys = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = h0.clone()
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys[:, t] = h
    return ys, h


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 5 + [_I] * 3 + [_LL] * 5 + [_P]


def _kernel_lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = _ARGTYPES
    return lib
