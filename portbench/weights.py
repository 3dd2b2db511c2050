"""Weights from the seed, made on the device by one generator, one draw a
parameter (layers stacked, so a few large calls), in fp32: the same seed
gives the same bits, so the benchmark can make them again for the
reference instead of keeping a copy."""
from __future__ import annotations

import math
from typing import Dict

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(layout: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` for ``layout`` (``{path: (shape, init,
    fan_in)}``, as :func:`portbench.reference.transformer.param_layout`
    gives it)."""
    g = generator(seed, device)
    out = {}
    for path, (shape, init, fan_in) in layout.items():
        if init == "zeros":
            out[path] = torch.zeros(shape, dtype=torch.float32,
                                    device=device)
            continue
        x = torch.randn(shape, generator=g, dtype=torch.float32,
                        device=device)
        out[path] = x.mul_(1.0 / math.sqrt(fan_in))
    return out
