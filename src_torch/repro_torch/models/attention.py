"""Attention blocks: full / GQA / MQA / sliding-window / local, and
DeepSeek-V2 Multi-head Latent Attention (MLA) (port of
``repro/models/attention.py``).

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
from repro_torch.models.base import (ParamSpec, apply_norm, apply_rope,
                                     norm_spec)
from repro_torch.sharding import (batch_axes, batch_spec, cast_weight,
                                  constrain_heads, from_local, gather_dim,
                                  model_dim, model_rank, spec_of, to_local)


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
        return mla_init_cache(cfg, batch, max_len, device)
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
    """einsum("bsd,dnh->bsnh") as one matrix product.

    On a residual stream whose sequence is split over "model", each rank
    projects its own tokens with the whole weight: the output keeps the
    sequence split, which the attention takes over to its layout
    (``attention_impl``).  DTensor would gather the tokens instead, for
    each of q, k and v, and project all of them on every rank where the
    heads do not split."""
    B, S, _ = x.shape
    d, n, h = w.shape
    if model_dim(x) == 1:
        spec = batch_spec(x.shape, 1)
        xl = to_local(x, spec)
        wl = to_local(w, (None,) * 3, partial_grad=batch_axes() + ("model",))
        b, s = xl.shape[0], xl.shape[1]
        out = (xl.reshape(b * s, d) @ wl.reshape(d, n * h)).view(b, s, n, h)
        return from_local(out, (B, S, n, h), spec + (None,))
    return (x.reshape(B * S, d) @ w.reshape(d, n * h)).view(B, S, n, h)


def _unproject(ctx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsnh,nhd->bsd") as one matrix product: the transpose of
    :func:`_project`.

    A ctx whose sequence is split over "model" (the key-split attention's,
    whose heads do not divide the axis) is multiplied on each rank's own
    rows by the whole weight: the output lands in the residual's layout
    with no collective, and its gradient comes back in ctx's.  DTensor's
    product would flatten the split sequence, and in the backward view a
    split of the flattened heads back into heads, which no placement
    keeps.  Heads split over "model" flatten with the head dim as they
    lie (the product's sum then pending over the axis)."""
    B, S, n, h = ctx.shape
    d = w.shape[-1]
    if model_dim(ctx) == 1:
        spec = batch_spec(ctx.shape, 1)
        cl = to_local(ctx, spec)
        wl = to_local(w, (None,) * 3, partial_grad=batch_axes() + ("model",))
        b, s = cl.shape[0], cl.shape[1]
        out = (cl.reshape(b * s, n * h) @ wl.reshape(n * h, d)).view(b, s, d)
        return from_local(out, (B, S, d), spec[:2] + (None,))
    return (ctx.reshape(B * S, n * h) @ w.reshape(n * h, d)).view(B, S, d)


def apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
          positions: torch.Tensor, cache: Optional[Dict] = None,
          kind: str = ATTN, impl: str = "eager",
          max_len: Optional[int] = None,
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    if kind == MLA:
        return mla_apply(params, x, cfg, mode=mode, positions=positions,
                         cache=cache, max_len=max_len)
    B = x.shape[0]
    hd = cfg.resolved_head_dim
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
        pos = positions[:, 0] if positions.dim() == 2 else positions  # (B,)
        axis = next((a for a in ("model", "data")
                     if model_dim(cache["k"], a) == 1), None)
        if axis is not None:
            ctx, new_cache = _decode_seq_split(q, {"k": k, "v": v}, cache,
                                               pos, window, axis)
        else:
            cache_len = cache["k"].shape[1]
            slot = (torch.remainder(pos, cache_len) if window
                    else torch.clamp(pos, max=cache_len - 1))
            bidx = torch.arange(B, device=x.device)
            # out of place: DTensor has no in-place rule for a sharded cache
            new_k = cache["k"].index_put((bidx, slot), k[:, 0])
            new_v = cache["v"].index_put((bidx, slot), v[:, 0])
            new_sp = cache["slot_pos"].index_put(
                (bidx, slot), pos.to(cache["slot_pos"].dtype))
            ctx = attention_impl.decode_attention(
                q, new_k, new_v, slot_pos=new_sp, query_pos=pos,
                window=window)
            new_cache = {"k": new_k, "v": new_v, "slot_pos": new_sp}
    else:
        raise ValueError(mode)

    wo = cast_weight(params["wo"], x.dtype, ("heads", "head_dim", "embed"))
    return _unproject(ctx, wo), new_cache


def _token_local(t: torch.Tensor) -> torch.Tensor:
    """The rank's batch rows of the one-token DTensor ``t``, whole along
    every other dim: a split over the heads is gathered, a pending sum
    reduced, once a step (a token's q, k or v is small)."""
    return to_local(t, batch_spec(t.shape))


def _write_own_shard(shards: Dict, token: Dict, slot: torch.Tensor,
                     axis: str) -> Dict:
    """The reference's ``cache.at[bidx, slot].set(token)`` on the rank's
    local shards of a cache whose sequence (dim 1) is split over ``axis``:
    ``shards`` (b, s, ...) and ``token`` (b, ...) by leaf name, ``slot``
    (b,) global.  A rank writes only the rows whose slot lies in its range
    (the others keep their value) and nothing is gathered, as GSPMD keeps
    the reference's write local.  Out of place, as the plain path."""
    out = {}
    for name, t in shards.items():
        s = t.shape[1]
        lo = model_rank(axis) * s
        at = torch.clamp(slot - lo, 0, s - 1)
        bidx = torch.arange(t.shape[0], device=t.device)
        new = token[name].to(t.dtype)
        own = ((slot >= lo) & (slot < lo + s)).view(
            (-1,) + (1,) * (new.ndim - 1))
        out[name] = t.index_put((bidx, at),
                                torch.where(own, new, t[bidx, at]))
    return out


def _split_cache_step(cache: Dict, token: Dict, pos: torch.Tensor,
                      window: int, axis: str = "model"):
    """The write of a decode step on a cache whose sequence is split over
    ``axis``: ``token`` the step's entries (B,1,...) by leaf name,
    ``slot_pos`` aside.  Returns ``(shards, pos_l, new_cache)``: the
    rank's new shards of every leaf (``slot_pos`` included), its batch
    rows of ``pos``, and the new cache as DTensors split as ``cache``
    came.  A token is placed as its leaf is, the sequence aside.  The
    slot is the plain path's: ``pos % len`` in a rotating window, else
    ``min(pos, len - 1)``."""
    cache_len = next(iter(cache.values())).shape[1]
    pos_l = _token_local(pos)
    slot = (torch.remainder(pos_l, cache_len) if window
            else torch.clamp(pos_l, max=cache_len - 1))
    specs = {n: spec_of(t) for n, t in cache.items()}
    token = {n: to_local(t[:, 0], specs[n][:1] + specs[n][2:])
             for n, t in token.items()}
    token["slot_pos"] = pos_l
    shards = _write_own_shard(
        {n: to_local(t, specs[n]) for n, t in cache.items()}, token, slot,
        axis)
    return shards, pos_l, {n: from_local(t, cache[n].shape, specs[n])
                           for n, t in shards.items()}


def _decode_seq_split(q, token: Dict, cache: Dict, pos: torch.Tensor,
                      window: int, axis: str):
    """A decode step's attention on a cache whose sequence is split over
    ``axis`` (``rules_for_shape``'s decode rules: "model" in the
    reference's ``decode_32k``, whose GQA kv counts do not divide the
    axis; "data" in ``long_500k``, batch 1): each rank writes the token
    into its own shard and attends over its own slots
    (``attention_impl.decode_attention_split``, the softmax combined over
    ``axis``).  Over "model" the query's heads are gathered once and ctx
    comes back whole; over another axis a query whose heads are split over
    "model" keeps them split, each rank reading the KV heads its own heads
    read, and ctx comes back split as q, as ``wo``'s product takes it.
    ``token``: the step's k and v (B,1,KV,hd).  Returns ctx and the new
    cache, split as it came."""
    shards, pos_l, new_cache = _split_cache_step(cache, token, pos, window,
                                                 axis)
    B, _, H, _ = q.shape
    spec = batch_spec(q.shape, 2 if axis != "model" and model_dim(q) == 2
                      else None)
    ql = to_local(q, spec)
    k, v = shards["k"], shards["v"]
    n, KV = ql.shape[2], cache["k"].shape[2]
    if n < H and k.shape[2] == KV:
        # the KV head each of the rank's query heads reads (a copy of the
        # rank's slots of a few heads: a long context's cache is a window)
        idx = (model_rank() * n + torch.arange(n, device=k.device)) // (
            H // KV)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    ctx = attention_impl.decode_attention_split(
        ql, k, v, slot_pos=shards["slot_pos"], query_pos=pos_l,
        window=window, axis=axis)
    return from_local(ctx, (B, 1, H, ctx.shape[-1]), spec), new_cache


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


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)
# ---------------------------------------------------------------------------
# Projections:
#   c_q   = W_DQ x                (q_lora_rank)
#   q     = W_UQ c_q              -> per head [q_nope (nope_dim), q_pe (rope_dim)]
#   c_kv  = W_DKV x               (kv_lora_rank)      <- THE cached latent
#   k_pe  = W_KR x                (rope_dim, shared across heads, rope'd)
#   k     = [W_UK c_kv, k_pe] ; v = W_UV c_kv
# Decode uses the absorbed form: score_h = q_nope_h^T W_UK_h c + q_pe_h^T k_pe
# so only (c_kv, k_pe) is cached.
def mla_specs(cfg: ModelConfig) -> Dict:
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d, vdim = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": norm_spec(cfg, m.q_lora_rank),
        "wuq": ParamSpec((m.q_lora_rank, H, nope + rope_d),
                         ("lora", "heads", "head_dim")),
        "wdkv": ParamSpec((d, m.kv_lora_rank), ("embed", "lora")),
        "kv_norm": norm_spec(cfg, m.kv_lora_rank),
        "wuk": ParamSpec((m.kv_lora_rank, H, nope), ("lora", "heads", "head_dim")),
        "wuv": ParamSpec((m.kv_lora_rank, H, vdim), ("lora", "heads", "head_dim")),
        "wkr": ParamSpec((d, rope_d), ("embed", "head_dim")),
        "wo": ParamSpec((H, vdim, d), ("heads", "head_dim", "embed")),
    }


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device) -> Dict:
    m, dt = cfg.mla, cfg.compute_dtype
    return {
        "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                           device=device),
        "kpe": torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dt,
                           device=device),
        "slot_pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device),
    }


def mla_scale(cfg: ModelConfig, dtype: torch.dtype,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """The reference's MLA score scale, ``1.0 / jnp.sqrt(float32(nope +
    rope)).astype(dtype)``: the square root rounded to ``dtype``, then the
    quotient in ``dtype`` (a 0-d tensor)."""
    m = cfg.mla
    root = torch.tensor(math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim),
                        dtype=torch.float32, device=device)
    return 1.0 / root.to(dtype)


def mla_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
              positions: torch.Tensor, cache: Optional[Dict] = None,
              max_len: Optional[int] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA in the naive form for train and prefill, the absorbed form for
    decode.

    Train and prefill expand k and v per head and always take the eager
    contraction, whatever ``impl`` the trunk was given: the reference pins
    ``impl="xla"`` there (its q and k are nope + rope = 192 wide, its v
    128), so no flash launch belongs to an MLA layer.  The scale is
    :func:`mla_scale` in x's dtype; prefill multiplies q by it in x's
    dtype, decode multiplies its fp32 scores by it widened to fp32.
    Decode writes slot ``min(pos, cache_len - 1)``, as the reference does.
    """
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope_d = m.qk_nope_head_dim, m.qk_rope_head_dim
    dt = x.dtype
    scale = mla_scale(cfg, dt, x.device)
    # the sequence gathered: torch 2.11 refuses the products' flatten of a
    # split one
    x = gather_dim(x, 1)

    cq = apply_norm(params["q_norm"], x @ params["wdq"].to(dt), cfg)
    q = _project(cq, params["wuq"].to(dt))
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)

    ckv = apply_norm(params["kv_norm"], x @ params["wdkv"].to(dt), cfg)
    kpe = x @ params["wkr"].to(dt)
    kpe = apply_rope(kpe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if mode in ("train", "prefill"):
        # naive (non-absorbed) form: expand k, v per head
        k_nope = _project(ckv, params["wuk"].to(dt))
        v = _project(ckv, params["wuv"].to(dt))
        k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, H, rope_d)],
                      dim=-1)
        qq = torch.cat([q_nope, q_pe], dim=-1) * scale
        qq = constrain_heads(qq)
        k = constrain_heads(k)
        v = constrain_heads(v)
        ctx = attention_impl.causal_attention(qq, k, v, window=0,
                                              impl="eager")
        new_cache = None
        if mode == "prefill":
            pos = positions.expand(B, S) if positions.dim() == 1 else positions
            pos = pos.to(torch.int32)
            ckv_c, kpe_c = ckv, kpe
            if max_len and max_len > S:
                pad = max_len - S
                ckv_c = torch.nn.functional.pad(ckv_c, (0, 0, 0, pad))
                kpe_c = torch.nn.functional.pad(kpe_c, (0, 0, 0, pad))
                pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
            new_cache = {"ckv": ckv_c.contiguous(), "kpe": kpe_c.contiguous(),
                         "slot_pos": pos.contiguous()}
    elif mode == "decode":
        assert cache is not None
        pos = positions[:, 0] if positions.dim() == 2 else positions
        # absorbed decode: q'_h = W_UK_h^T q_nope_h  (B,H,rank)
        q_abs = torch.einsum("bnh,rnh->bnr", q_nope[:, 0],
                             params["wuk"].to(dt))
        if model_dim(cache["ckv"]) == 1:
            ctx_lat, new_cache = _mla_decode_seq_split(
                q_abs, q_pe[:, 0], {"ckv": ckv, "kpe": kpe}, cache, pos,
                scale)
        else:
            cache_len = cache["ckv"].shape[1]
            slot = torch.clamp(pos, max=cache_len - 1)
            bidx = torch.arange(B, device=x.device)
            ckv_c = cache["ckv"].index_put((bidx, slot), ckv[:, 0])
            kpe_c = cache["kpe"].index_put((bidx, slot), kpe[:, 0])
            sp = cache["slot_pos"].index_put(
                (bidx, slot), pos.to(cache["slot_pos"].dtype))
            scores = _mla_scores(q_abs, q_pe[:, 0], ckv_c, kpe_c, sp, pos,
                                 scale)
            w = torch.softmax(scores, dim=-1).to(dt)
            # attend in latent space
            ctx_lat = torch.einsum("bns,bsr->bnr", w, ckv_c)
            new_cache = {"ckv": ckv_c, "kpe": kpe_c, "slot_pos": sp}
        ctx = torch.einsum("bnr,rnh->bnh", ctx_lat, params["wuv"].to(dt))
        ctx = ctx[:, None]                                 # (B,1,H,vdim)
    else:
        raise ValueError(mode)

    return _unproject(ctx, params["wo"].to(dt)), new_cache


def _mla_scores(q_abs, q_pe, ckv, kpe, slot_pos, pos, scale):
    """The absorbed scores (B,H,S) of one query against the latent cache,
    fp32 products and sums (the reference's
    ``preferred_element_type=float32``), empty and future slots masked."""
    scores = (torch.einsum("bnr,bsr->bns", q_abs.float(), ckv.float())
              + torch.einsum("bnh,bsh->bns", q_pe.float(), kpe.float())) \
        * scale.float()
    mask = (slot_pos >= 0) & (slot_pos <= pos[:, None])   # (B, S)
    return torch.where(mask[:, None, :], scores, -torch.inf)


def _mla_decode_seq_split(q_abs, q_pe, token: Dict, cache: Dict,
                          pos: torch.Tensor, scale):
    """MLA's absorbed decode on a latent cache whose sequence is split over
    "model" (:func:`_decode_seq_split`'s layout): each rank writes the
    token's ``ckv`` / ``kpe`` into its own shard, scores its own slots and
    takes its share of the latent context, combined over the axis
    (``attention_impl.split_softmax_combine``).  ``q_abs`` (B,H,rank) and
    ``q_pe`` (B,H,rope) are gathered once.  Returns the latent context
    (B,H,rank) in q's dtype, whole over "model", and the new cache."""
    shards, pos_l, new_cache = _split_cache_step(cache, token, pos,
                                                 window=0)
    qa = _token_local(q_abs)
    ckv32 = shards["ckv"].float()
    scores = _mla_scores(qa, _token_local(q_pe), shards["ckv"],
                         shards["kpe"], shards["slot_pos"], pos_l, scale)
    ctx = attention_impl.split_softmax_combine(
        scores, lambda p: torch.einsum("bns,bsr->bnr", p, ckv32))
    return (from_local(ctx.to(qa.dtype), q_abs.shape,
                       batch_spec(q_abs.shape)), new_cache)
