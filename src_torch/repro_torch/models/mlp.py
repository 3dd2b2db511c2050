"""MLP blocks (port of ``repro/models/mlp.py``): the gated (SwiGLU /
GeGLU) and plain dense MLP.  The token-choice top-k MoE is ROADMAP queue 1,
item 11: :func:`moe_specs` and :func:`moe_apply` raise.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.base import ParamSpec, activation
from repro_torch.sharding import cast_weight

_MOE_TODO = "mixture-of-experts layers are not ported yet: ROADMAP queue 1, item 11"


# ---------------------------------------------------------------------------
# Dense gated MLP
# ---------------------------------------------------------------------------
def specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    out = {
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }
    if cfg.gated_mlp:
        out["wi_gate"] = ParamSpec((d, f), ("embed", "mlp"))
    return out


def apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    wi_up = cast_weight(params["wi_up"], x.dtype, ("embed", "mlp"))
    wo = cast_weight(params["wo"], x.dtype, ("mlp", "embed"))
    u = x @ wi_up
    if cfg.gated_mlp:
        g = x @ cast_weight(params["wi_gate"], x.dtype, ("embed", "mlp"))
        h = act(g) * u
    else:
        h = act(u)
    return h @ wo


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------
def moe_specs(cfg: ModelConfig) -> Dict:
    raise NotImplementedError(_MOE_TODO)


def moe_apply(params, x, cfg: ModelConfig):
    raise NotImplementedError(_MOE_TODO)
