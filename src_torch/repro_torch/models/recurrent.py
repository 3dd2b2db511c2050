"""Recurrent blocks (port of ``repro/models/recurrent.py``): the
Griffin / RecurrentGemma RG-LRU block.  The xLSTM blocks (mLSTM, sLSTM) are
ROADMAP queue 1, item 11: the trunk raises on them.

The RG-LRU block has the attention blocks' contract:
  rglru_specs(cfg)                          -> ParamSpec tree (one layer)
  rglru_init_cache(cfg, batch, device)      -> decode state (one layer)
  rglru_apply(params, x, cfg, *, mode, cache, impl) -> (y, new_cache)

Decode advances the recurrent state by one token, ``h = a * h0 + gx``.
Prefill and train run the recurrence over the whole sequence, selected by
``impl`` as the attention contraction is:

- ``impl="flash"`` (the counterpart of the reference's Pallas path) runs
  the hand-written Hopper kernel
  :func:`repro_torch.kernels.rglru_scan.rglru_scan` (its plain twin on a
  CPU tensor) on ``(a, gx, h0)``;
- ``impl="eager"`` (the counterpart of ``"xla"``, whose model runs
  ``lax.associative_scan``) runs :func:`linear_scan_eager`, a log-depth
  scan in plain torch ops over ``(a, gx)`` with ``a_0 * h0`` folded into
  ``gx_0``, as the reference does.

The recurrence and its gates are fp32 wherever the reference computes
them in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.base import ParamSpec, activation
from repro_torch.sharding import cast_weight

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _block_diag_spec(heads: int, width: int) -> ParamSpec:
    per = width // heads
    return ParamSpec((heads, per, per), ("heads", "state", "state"))


def _block_diag_apply(w: torch.Tensor, x: torch.Tensor, heads: int
                      ) -> torch.Tensor:
    """x: (..., width) -> block-diagonal linear per head."""
    per = w.shape[-1]
    xh = x.reshape(x.shape[:-1] + (heads, per))
    y = torch.einsum("...hi,hij->...hj", xh, w.to(x.dtype))
    return y.reshape(x.shape)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise temporal conv. x: (B,S,W); w: (K,W); returns y, new_state.

    conv_state: (B,K-1,W) previous inputs (decode/prefill-carry)."""
    B, S, width = x.shape
    K = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((B, K - 1, width), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                      # (B, S+K-1, W)
    # the taps summed in the reference's order, each product and sum
    # rounded in x's dtype
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    new_state = (xp[:, -(K - 1):] if K > 1
                 else torch.zeros((B, 0, width), dtype=x.dtype,
                                  device=x.device))
    return y, new_state


def linear_scan_eager(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All ``h_t`` of ``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``, along
    axis 1: a log-depth (Hillis-Steele) scan of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2)``, the plain-torch
    counterpart of ``jax.lax.associative_scan``."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


# ===========================================================================
# RG-LRU (RecurrentGemma, arXiv:2402.19427)
# ===========================================================================
def rglru_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    H = cfg.num_heads
    return {
        "wx": ParamSpec((d, w), ("embed", "mlp")),
        "wy": ParamSpec((d, w), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, w), ("conv", "mlp"), "normal",
                            scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": ParamSpec((w,), ("mlp",), "zeros"),
        "gate_a": _block_diag_spec(H, w),
        "gate_a_b": ParamSpec((w,), ("mlp",), "zeros"),
        "gate_i": _block_diag_spec(H, w),
        "gate_i_b": ParamSpec((w,), ("mlp",), "zeros"),
        # Λ parametrized so that a = exp(-c*softplus(Λ))
        "lam": ParamSpec((w,), ("mlp",), "normal", scale=0.5),
        "wo": ParamSpec((w, d), ("mlp", "embed")),
    }


def rglru_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                            dtype=cfg.compute_dtype, device=device),
    }


def _rglru_gates(params, xb: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's ``a`` and gated input ``gx``, both fp32."""
    H = cfg.num_heads
    r = torch.sigmoid(_block_diag_apply(params["gate_a"], xb, H)
                      + params["gate_a_b"].to(xb.dtype))
    i = torch.sigmoid(_block_diag_apply(params["gate_i"], xb, H)
                      + params["gate_i_b"].to(xb.dtype))
    lam = params["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))  # jax.nn.softplus
    log_a = -RGLRU_C * softplus * r.float()              # (B,S,W) or (B,W)
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.square(a), min=1e-12)) \
        * (i.float() * xb.float())
    return a, gated_x


def rglru_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict] = None, impl: str = "eager"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, d = x.shape
    xb = x @ cast_weight(params["wx"], x.dtype, ("embed", "mlp"))
    gate = activation("gelu")(
        x @ cast_weight(params["wy"], x.dtype, ("embed", "mlp")))
    conv_state = cache["conv"] if cache is not None else None
    xb, new_conv = _causal_conv(xb, params["conv_w"], params["conv_b"],
                                conv_state)

    a, gx = _rglru_gates(params, xb, cfg)               # fp32 (B,S,W)
    h0 = (cache["h"] if cache is not None
          else torch.zeros((B, xb.shape[-1]), dtype=torch.float32,
                           device=x.device))

    if mode == "decode":                                 # S == 1
        h = a[:, 0] * h0 + gx[:, 0]
        y_rec = h[:, None]
        new_cache = {"h": h, "conv": new_conv}
    elif mode in ("train", "prefill"):
        if impl == "flash":
            from repro_torch.kernels.rglru_scan import rglru_scan

            y_rec, h_last = rglru_scan(a, gx, h0)
        elif impl == "eager":
            gx[:, 0] += a[:, 0] * h0      # fold h0 in (gx is this call's own)
            y_rec = linear_scan_eager(a, gx)
            h_last = y_rec[:, -1]
        else:
            raise ValueError(f"unknown recurrence impl {impl!r}; one of "
                             f"('eager', 'flash')")
        new_cache = None
        if mode == "prefill":
            new_cache = {"h": h_last, "conv": new_conv}
    else:
        raise ValueError(mode)

    y = y_rec.to(x.dtype) * gate
    return y @ cast_weight(params["wo"], x.dtype, ("mlp", "embed")), new_cache
