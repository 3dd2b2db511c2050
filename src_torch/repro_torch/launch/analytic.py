"""Analytic FLOP / HBM-byte models per (arch, shape) -- the napkin math
(port of ``repro/launch/analytic.py``: the same formulas, the same floats
for every input).

Why this exists: the reference's dry-run reads XLA's HLO cost analysis,
which counts a ``while`` (scan) body ONCE, so its roofline compute/memory
terms come from these first-principles models.  The port's dry-run
counts every op it traces (``counted_flops_raw``) and keeps these models
for the roofline all the same, so that its terms and the reference's
rest on one set of formulas and differ only by the chip's constants.

Conventions:
- FLOPs: one MAC = 2 FLOPs.  backward = 2x forward (grad wrt params +
  activations); train = 3x forward of the token stream.
- "per device": tokens divide over (pod x data); matmul work divides over
  "model" when the corresponding dim is sharded (we apply the model-axis
  division globally — correct for every sharded dim, slightly optimistic
  for the few replicated-attention archs, noted per-arch in fallbacks).
- HBM bytes (per device, per step): weight traffic (bf16 reads fwd+bwd,
  fp32 optimizer read+write) + activation traffic (remat: ~2x writes+reads
  of layer I/O) + KV-cache traffic for decode.  These are lower-bound-style
  estimates; their role is to rank the three roofline terms, not to be
  exact to the percent.
"""
from __future__ import annotations

from dataclasses import dataclass


from repro_torch.config import (ATTN, LOCAL_ATTN, MLA, MLSTM, RGLRU, SLSTM,
                                SWA, InputShape, ModelConfig)


def _attn_ctx(kind: str, cfg: ModelConfig, seq: int, decode: bool) -> float:
    """Average attended context length per token."""
    if kind in (SWA, LOCAL_ATTN) and cfg.window:
        return float(min(cfg.window, seq)) if decode else min(cfg.window, seq / 2)
    return float(seq) if decode else seq / 2.0


def layer_flops_per_token(cfg: ModelConfig, kind: str, moe_layer: bool,
                          seq: int, decode: bool) -> float:
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    ctx = _attn_ctx(kind, cfg, seq, decode)
    fl = 0.0
    if kind == MLA:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        fl += 2 * d * m.q_lora_rank + 2 * m.q_lora_rank * H * qk
        fl += 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
        if decode:
            # absorbed: scores against the latent cache directly
            fl += 2 * m.kv_lora_rank * H * m.qk_nope_head_dim          # q absorb
            fl += 2 * ctx * H * (m.kv_lora_rank + m.qk_rope_head_dim)  # scores
            fl += 2 * ctx * H * m.kv_lora_rank                          # values
            fl += 2 * m.kv_lora_rank * H * m.v_head_dim                 # out expand
        else:
            fl += 2 * m.kv_lora_rank * H * (m.qk_nope_head_dim + m.v_head_dim)
            fl += 2 * ctx * H * qk + 2 * ctx * H * m.v_head_dim
        fl += 2 * H * m.v_head_dim * d
    elif kind in (ATTN, SWA, LOCAL_ATTN):
        fl += 2 * d * (H + 2 * KV) * hd          # qkv proj
        fl += 2 * ctx * H * hd * 2               # scores + values
        fl += 2 * H * hd * d                     # out proj
    elif kind == RGLRU:
        w = cfg.lru_width or d
        fl += 2 * d * w * 2                      # wx, wy
        fl += 2 * cfg.conv_width * w             # temporal conv
        fl += 2 * w * (w // H) * 2               # block-diag gates
        fl += 12 * w                             # recurrence/gating elementwise
        fl += 2 * w * d                          # out proj
    elif kind == MLSTM:
        di = int(cfg.mlstm_proj_factor * d)
        dk = di // H
        fl += 2 * d * 2 * di                     # up proj
        fl += 2 * cfg.conv_width * di
        fl += 3 * 2 * di * di                    # q, k, v
        fl += 2 * di * 2 * H
        if decode:
            fl += 2 * H * dk * dk * 3            # C update + readout
        else:
            fl += 2 * ctx * di * 2 + 4 * ctx * H  # quadratic parallel form
        fl += 2 * di * d                         # down proj
    elif kind == SLSTM:
        fl += 4 * 2 * d * d                      # input projections
        fl += 4 * 2 * d * (d // H)               # block-diag recurrent
        fl += 2 * 3 * d * int(cfg.slstm_proj_factor * d)  # gated FFN
    # MLP
    if kind in (ATTN, SWA, LOCAL_ATTN, MLA, RGLRU):
        if moe_layer:
            m = cfg.moe
            nmat = 3
            fl += 2 * d * m.num_experts                       # router
            fl += 2 * nmat * d * m.d_ff * m.experts_per_token
            fl += 2 * nmat * d * m.d_ff * m.num_shared_experts
        elif cfg.d_ff:
            nmat = 3 if cfg.gated_mlp else 2
            fl += 2 * nmat * d * cfg.d_ff
    return fl


def forward_flops_per_token(cfg: ModelConfig, seq: int, decode: bool) -> float:
    kinds = cfg.layer_kinds
    n_pre = cfg.moe.first_dense_layers if cfg.moe.enabled else 0
    fl = 0.0
    for i, kind in enumerate(kinds):
        fl += layer_flops_per_token(cfg, kind, cfg.moe.enabled and i >= n_pre,
                                    seq, decode)
    fl += 2 * cfg.d_model * cfg.vocab_size       # lm head
    return fl


def encoder_flops(cfg: ModelConfig) -> float:
    """Whisper encoder forward FLOPs per *sequence* (1500 frames)."""
    if not cfg.is_encoder_decoder:
        return 0.0
    F = cfg.encoder_seq or 1500
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    nmat = 3 if cfg.gated_mlp else 2
    per_tok = (2 * d * 3 * H * hd + 2 * H * hd * d       # qkv + out
               + 2 * F * H * hd * 2                       # full bidir attn
               + 2 * nmat * d * cfg.d_ff)
    return per_tok * F * (cfg.num_encoder_layers or cfg.num_layers)


def cross_attn_flops_per_token(cfg: ModelConfig) -> float:
    if not cfg.is_encoder_decoder:
        return 0.0
    F = cfg.encoder_seq or 1500
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return cfg.num_layers * (2 * d * H * hd * 2 + 2 * F * H * hd * 2
                             + 2 * H * hd * d)


@dataclass
class CostEstimate:
    flops_total: float
    flops_per_device: float
    hbm_bytes_per_device: float
    tokens: float


def estimate(cfg: ModelConfig, shape: InputShape, n_devices: int,
             model_axis: int = 16) -> CostEstimate:
    from repro_torch.models.api import build_model

    decode = shape.kind == "decode"
    B, S = shape.global_batch, shape.seq_len
    tokens = float(B) if decode else float(B * S)

    fwd = forward_flops_per_token(cfg, S, decode) * tokens
    fwd += cross_attn_flops_per_token(cfg) * tokens
    if cfg.is_encoder_decoder and not decode:
        fwd += encoder_flops(cfg) * B
    mult = 3.0 if shape.kind == "train" else 1.0
    total = fwd * mult

    model = build_model(cfg)
    p_total = model.param_count()
    p_dev = p_total / n_devices                       # fully sharded storage

    # ---- HBM bytes per device -------------------------------------------
    d = cfg.d_model
    tok_dev = tokens / max(n_devices / model_axis, 1)  # tokens per data-shard
    if shape.kind == "train":
        weight_traffic = p_dev * (2 + 2 + 2 + 16 + 8)  # fwd bf16 + bwd read +
        # grad write (bf16) + adam m,v fp32 r/w + master fp32 r/w
        # layer I/O saved + reread + recompute writes (remat), bf16
        act_traffic = cfg.num_layers * tok_dev * d * 2.0 * 6
        hbm = weight_traffic + act_traffic
    elif shape.kind == "prefill":
        weight_traffic = p_dev * 2.0
        act_traffic = cfg.num_layers * tok_dev * d * 2.0 * 4
        # attention reads K/V per query block ~ O(S * ctx) handled by flash
        # tiling; HBM-side it is ~2x the KV bytes:
        kv = _kv_cache_bytes(cfg, B, S) / n_devices
        hbm = weight_traffic + act_traffic + 2 * kv
    else:  # decode: every step reads all (sharded) weights + the whole cache
        weight_traffic = p_dev * 2.0
        cache_traffic = _kv_cache_bytes(cfg, B, S) / n_devices
        hbm = weight_traffic + cache_traffic
    return CostEstimate(total, total / n_devices, hbm, tokens)


def _kv_cache_bytes(cfg: ModelConfig, B: int, S: int) -> float:
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind == MLA:
            total += B * S * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * 2
        elif kind in (ATTN,):
            total += B * S * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2
        elif kind in (SWA, LOCAL_ATTN):
            w = min(cfg.window or S, S)
            total += B * w * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2
        elif kind == RGLRU:
            w = cfg.lru_width or cfg.d_model
            total += B * w * 4 + B * (cfg.conv_width - 1) * w * 2
        elif kind == MLSTM:
            di = int(cfg.mlstm_proj_factor * cfg.d_model)
            dk = di // cfg.num_heads
            total += B * cfg.num_heads * dk * dk * 4
        elif kind == SLSTM:
            total += B * cfg.d_model * 4 * 4
    if cfg.is_encoder_decoder:
        F = cfg.encoder_seq or 1500
        total += cfg.num_layers * B * F * cfg.num_heads \
            * cfg.resolved_head_dim * 2 * 2
    return total
