"""Attention blocks: full / GQA / MQA / sliding-window / local (port of
``repro/models/attention.py``; Multi-head Latent Attention is ROADMAP
queue 1, item 11).

Each block exposes
  specs(cfg)                         -> ParamSpec tree (one layer)
  init_cache(cfg, batch, max_len)    -> decode cache (one layer)
  apply(params, x, cfg, *, mode, positions, cache, kind, impl)
        -> (y, new_cache)

``mode`` is "train" | "prefill" | "decode".  In decode mode x is (B, 1, d)
and the cache advances by one position.  Sliding-window kinds keep a
rotating cache of ``window`` slots.  Like the reference, a step returns a
new cache and leaves the one it was given unchanged.

The score/softmax/value contraction is routed through
:mod:`repro_torch.models.attention_impl` (``impl="eager"`` or ``"flash"``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ATTN, LOCAL_ATTN, MLA, SWA, ModelConfig
from repro_torch.models import attention_impl
from repro_torch.models.base import ParamSpec, apply_rope
from repro_torch.sharding import cast_weight

_MLA_TODO = ("multi-head latent attention (kind 'mla') is not ported yet: "
             "ROADMAP queue 1, item 11")


def specs(cfg: ModelConfig) -> Dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        out["q_norm"] = {"scale": ParamSpec((hd,), ("head_dim",), "zeros")}
        out["k_norm"] = {"scale": ParamSpec((hd,), ("head_dim",), "zeros")}
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
               device: torch.device) -> Dict:
    if kind == MLA:
        raise NotImplementedError(_MLA_TODO)
    if kind in (SWA, LOCAL_ATTN) and cfg.window:
        max_len = min(max_len, cfg.window)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = cfg.compute_dtype
    return {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=dt, device=device),
        # absolute position stored per slot (rotating caches need it for
        # masking + rope); -1 marks an empty slot.
        "slot_pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device),
    }


def _qk_normalize(params, q, k, cfg):
    if not cfg.qk_norm:
        return q, k

    def _rms(x, scale):
        x32 = x.float()
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + 1e-6)
                * (1.0 + scale.float())).to(x.dtype)

    return _rms(q, params["q_norm"]["scale"]), _rms(k, params["k_norm"]["scale"])


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dnh->bsnh") as one matrix product."""
    B, S, _ = x.shape
    d, n, h = w.shape
    return (x.reshape(B * S, d) @ w.reshape(d, n * h)).view(B, S, n, h)


def apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
          positions: torch.Tensor, cache: Optional[Dict] = None,
          kind: str = ATTN, impl: str = "eager",
          max_len: Optional[int] = None,
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    if kind == MLA:
        raise NotImplementedError(_MLA_TODO)
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    window = cfg.window if kind in (SWA, LOCAL_ATTN) else 0

    q = _project(x, cast_weight(params["wq"], x.dtype,
                                ("embed", "heads", "head_dim")))
    k = _project(x, cast_weight(params["wk"], x.dtype,
                                ("embed", "kv_heads", "head_dim")))
    v = _project(x, cast_weight(params["wv"], x.dtype,
                                ("embed", "kv_heads", "head_dim")))
    q, k = _qk_normalize(params, q, k, cfg)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(q.dtype)

    if mode in ("train", "prefill"):
        ctx = attention_impl.causal_attention(q, k, v, window=window, impl=impl)
        new_cache = None
        if mode == "prefill":
            new_cache = _fill_cache_from_prefill(cfg, k, v, positions, kind,
                                                 max_len=max_len)
    elif mode == "decode":   # S == 1
        assert cache is not None
        cache_len = cache["k"].shape[1]
        pos = positions[:, 0] if positions.dim() == 2 else positions  # (B,)
        slot = (torch.remainder(pos, cache_len) if window
                else torch.clamp(pos, max=cache_len - 1))
        bidx = torch.arange(B, device=x.device)
        new_k = cache["k"].clone()
        new_v = cache["v"].clone()
        new_sp = cache["slot_pos"].clone()
        new_k[bidx, slot] = k[:, 0]
        new_v[bidx, slot] = v[:, 0]
        new_sp[bidx, slot] = pos.to(new_sp.dtype)
        ctx = attention_impl.decode_attention(
            q, new_k, new_v, slot_pos=new_sp, query_pos=pos, window=window)
        new_cache = {"k": new_k, "v": new_v, "slot_pos": new_sp}
    else:
        raise ValueError(mode)

    wo = cast_weight(params["wo"], x.dtype, ("heads", "head_dim", "embed"))
    y = ctx.reshape(B * S, H * hd) @ wo.reshape(H * hd, d)
    return y.view(B, S, d), new_cache


def _fill_cache_from_prefill(cfg, k, v, positions, kind,
                             max_len: Optional[int] = None) -> Dict:
    """Build a decode-ready cache from prefill K/V (last `window` if SWA).

    If ``max_len`` exceeds the prefill length the cache is padded with empty
    (slot_pos = -1) slots so decode can append new tokens."""
    B, S = k.shape[0], k.shape[1]
    window = cfg.window if kind in (SWA, LOCAL_ATTN) and cfg.window else 0
    pos = positions.expand(B, S) if positions.dim() == 1 else positions
    if window and S > window:
        # rotating cache: position p lives in slot p % window; the last
        # `window` tokens occupy exactly the full cache.
        k, v, pos = k[:, -window:], v[:, -window:], pos[:, -window:]
        S = window
        slots = torch.remainder(pos[0], window)
        order = torch.argsort(slots, stable=True)
        k, v, pos = k[:, order], v[:, order], pos[:, order]
    pos = pos.to(torch.int32)
    target = min(max_len, cfg.window) if (max_len and window) else max_len
    if target and target > S:
        pad = target - S
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    return {"k": k.contiguous(), "v": v.contiguous(),
            "slot_pos": pos.contiguous()}
