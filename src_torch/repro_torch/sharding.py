"""Weight casting for the model's forward (port of ``repro/sharding.py``,
:func:`cast_weight` only).

On one card there is no mesh: the reference's ``constrain_*`` calls are
no-ops without one (``sharding.py:175,193,235,285``), so the port drops
them, and :func:`cast_weight` is a dtype cast.  The sharded model is
ROADMAP queue 1, item 13.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def cast_weight(w: torch.Tensor, dtype: torch.dtype,
                logical_axes: Optional[Sequence[Optional[str]]] = None
                ) -> torch.Tensor:
    """The fp32 master weight ``w`` in the compute ``dtype``.
    ``logical_axes`` names the weight's axes as the reference does; with
    no mesh they choose nothing."""
    return w.to(dtype)
