"""Plain reference of the server's FedAvg fold of structured-sparse 0xF5
deltas, one elementwise op at a time in PyTorch: every site's int8 values
dequantized by their chunk's fp32 scale (the product rounded once to
fp32, as the client reconstructs them), times its example count and added
at its indices into one fp64 accumulator, in the order of the sites'
names; then the accumulator times ``1 / W``, the round base added at
``W_base / W`` and the sum cast to fp32.

Every op is a single IEEE rounding, so the result has the same bits on
the card and on the CPU.  ``acc_dtype=torch.float32`` is the control: the
same fold with its accumulator one precision lower.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def dequant(values: torch.Tensor, scales: torch.Tensor, qchunk: int
            ) -> torch.Tensor:
    """int8 values times their chunk's scale, rounded to fp32."""
    s = scales.double().repeat_interleave(qchunk)[:values.numel()]
    return (values.double() * s).float()


def fold(base: np.ndarray,
         arrivals: Sequence[Tuple[str, np.ndarray, np.ndarray, np.ndarray,
                                  float]],
         qchunk: int, device="cpu", acc_dtype=torch.float64) -> np.ndarray:
    """The new global model (fp32 numpy) from ``base`` (fp32, the round's
    parameters every delta is taken against) and ``arrivals``: ``(name,
    indices int64, values int8, scales fp32, weight)`` each."""
    acc = torch.zeros(base.size, dtype=acc_dtype, device=device)
    total = 0.0
    for _, idx, vals, scales, w in sorted(arrivals, key=lambda a: a[0]):
        i = torch.as_tensor(idx, device=device)
        x = dequant(torch.as_tensor(vals, device=device),
                    torch.as_tensor(scales, device=device), qchunk)
        acc[i] = acc[i] + x.to(acc_dtype) * w
        total += float(w)
        del i, x
    acc *= 1.0 / total
    acc += torch.as_tensor(base, device=device).to(acc_dtype) \
        * (total / total)
    return acc.float().cpu().numpy()


def mismatches(got: np.ndarray, want: np.ndarray) -> int:
    """How many fp32 coordinates differ in their bits."""
    return int(np.count_nonzero(got.view(np.uint32) != want.view(np.uint32)))
