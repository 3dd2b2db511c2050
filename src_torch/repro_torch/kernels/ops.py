"""The port's public wrappers of the substrate kernels (port of
``repro/kernels/ops.py``): the same names and keywords, minus the TPU's
block sizes and interpret switch.  Each runs its hand-written kernel on a
CUDA tensor and its plain twin on a CPU one."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru
from repro_torch.kernels.secagg_mask import secagg_mask as _secagg


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    return _flash(q, k, v, causal=causal, window=window)


def secagg_mask(x: torch.Tensor, masks: torch.Tensor, weight, *,
                quant_bits: int = 16) -> torch.Tensor:
    """x: (N,) float (taken as fp32); masks: (P, N) int32 (P may be 0);
    weight: scalar -> (N,) int32."""
    x = x.to(torch.float32).contiguous()
    if masks.numel() == 0:
        masks = torch.empty((0, x.shape[0]), dtype=torch.int32,
                            device=x.device)
    return _secagg(x, masks.to(torch.int32).contiguous(), float(weight),
                   quant_bits=quant_bits)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _rglru(a, b, h0)
