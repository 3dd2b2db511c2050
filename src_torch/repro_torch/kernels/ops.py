"""The port's public wrappers of the substrate kernels (port of
``repro/kernels/ops.py``): the same names, keywords and defaults.  Each runs
its hand-written kernel on a CUDA tensor and its plain twin on a CPU one.

The reference's TPU tiling keywords (``block_q``, ``block_kv``, ``block``,
``block_s``, ``block_w``) and its ``interpret`` switch are accepted so that
its callers run unchanged; they have no effect on the card, whose kernels
choose their own tiles.  The flash twin follows ``block_q`` / ``block_kv``
on the CPU, as the reference's kernel does.  A non-positive block raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.rglru_scan import rglru_scan as _rglru
from repro_torch.kernels.secagg_mask import secagg_mask as _secagg


def _blocks(**blocks: int) -> None:
    for name, b in blocks.items():
        if int(b) < 1:
            raise ValueError(f"{name} must be a positive block size, got {b}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 512, block_kv: int = 512,
                    interpret: bool = True) -> torch.Tensor:
    _blocks(block_q=block_q, block_kv=block_kv)
    return _flash(q, k, v, causal=causal, window=window, block_q=block_q,
                  block_kv=block_kv)


def secagg_mask(x: torch.Tensor, masks: torch.Tensor, weight, *,
                quant_bits: int = 16, block: int = 4096,
                interpret: bool = True) -> torch.Tensor:
    """x: (N,) float (taken as fp32); masks: (P, N) int32 (P may be 0);
    weight: scalar -> (N,) int32."""
    _blocks(block=block)
    x = x.to(torch.float32).contiguous()
    if masks.numel() == 0:
        masks = torch.empty((0, x.shape[0]), dtype=torch.int32,
                            device=x.device)
    return _secagg(x, masks.to(torch.int32).contiguous(), float(weight),
                   quant_bits=quant_bits)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               block_s: int = 256, block_w: int = 512,
               interpret: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    _blocks(block_s=block_s, block_w=block_w)
    return _rglru(a, b, h0)
