"""Encoder-decoder trunk, the Whisper-medium backbone (port of
``repro/models/encdec.py``).

The conv / mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings ``audio_embeds`` (B, frames, d).  The
transformer itself is complete:

  encoder: sinusoidal positions + N bidirectional attention + MLP layers;
           the attention runs through ``attention_impl.causal_attention``
           with ``causal=False`` (``impl="flash"``: the hand-written
           kernel's non-causal route)
  decoder: causal self-attention (``attention.apply``: RoPE, the
           reference's own deviation from Whisper's learned positions) +
           cross-attention into the encoder + MLP

Like the transformer trunk, the layers run in a Python loop over the
reference's stacked parameters (``enc_scan``, ``dec_scan``).  Decode caches
both the decoder's self-attention K/V and the projected encoder K/V
(``cross_k`` / ``cross_v``), so a decode step never runs the encoder.
A prefill given ``prefill_max_len`` pads the self-attention cache to that
many slots, as the decoder-only trunk's does; without it the cache holds
the prompt's S slots, as the reference's does.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.config import ATTN, ModelConfig
from repro_torch.models import attention, attention_impl, mlp
from repro_torch.models.base import (ParamSpec, apply_norm, index_layer,
                                     map_specs, norm_spec,
                                     sinusoidal_positions, stack_layers,
                                     unbind_layers)
from repro_torch.sharding import (batch_spec, constrain_batch,
                                  constrain_logits, from_local, gather_dim,
                                  on_mesh, to_local)


def _sqrt_hd(hd: int, dtype: torch.dtype) -> torch.Tensor:
    """sqrt(hd) in fp32, then in ``dtype`` (the reference's
    ``jnp.sqrt(jnp.asarray(hd, jnp.float32)).astype(q.dtype)``)."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# cross attention
# ---------------------------------------------------------------------------
def cross_specs(cfg: ModelConfig) -> Dict:
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    return {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wv": ParamSpec((d, H, hd), ("embed", "heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "embed")),
    }


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dnh->bsnh"); under a mesh as the self-attention's
    projections (``attention._project``: a split sequence stays split)."""
    if on_mesh(x):
        return attention._project(x, w)
    return torch.einsum("bsd,dnh->bsnh", x, w)


def _out(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bsnh,nhd->bsd"); under a mesh as the self-attention's
    output projection (``attention._unproject``: one product of the heads
    flattened, where the einsum's own order puts a split head dim second,
    which torch 2.11 refuses; a sequence split over "model" multiplied on
    each rank's rows)."""
    if not on_mesh(ctx):
        return torch.einsum("bsnh,nhd->bsd", ctx, wo)
    return attention._unproject(ctx, wo)


def cross_kv(params, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    k = _heads(enc_out, params["wk"].to(enc_out.dtype))
    v = _heads(enc_out, params["wv"].to(enc_out.dtype))
    return k, v


def _cross_ctx(q, k, v, dtype: torch.dtype) -> torch.Tensor:
    scores = torch.einsum("bqnh,bknh->bnqk", q, k).float()
    w = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bnqk,bknh->bqnh", w, v)


def cross_apply(params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """The scores are made in the compute dtype and only then widened to
    fp32 for the softmax, as the reference makes them.  Under a mesh they
    are made on each rank's batch rows, every head and frame whole (the
    scores' batched products flatten a split dim, which torch 2.11
    refuses)."""
    q = _heads(x, params["wq"].to(x.dtype))
    q = q / _sqrt_hd(cfg.resolved_head_dim, q.dtype)
    if on_mesh(q):
        ctx = from_local(_cross_ctx(*(to_local(t, batch_spec(t.shape))
                                      for t in (q, k, v)), x.dtype),
                         q.shape, batch_spec(q.shape))
    else:
        ctx = _cross_ctx(q, k, v, x.dtype)
    return _out(ctx, params["wo"].to(x.dtype))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------
def _enc_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "norm1": norm_spec(cfg, cfg.d_model),
        "attn": attention.specs(cfg),
        "norm2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp.specs(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig) -> Dict:
    return {
        "norm1": norm_spec(cfg, cfg.d_model),
        "self_attn": attention.specs(cfg),
        "norm_x": norm_spec(cfg, cfg.d_model),
        "cross": cross_specs(cfg),
        "norm2": norm_spec(cfg, cfg.d_model),
        "mlp": mlp.specs(cfg),
    }


def _stack(base, n: int):
    return map_specs(
        lambda s: ParamSpec((n,) + s.shape, ("stack",) + s.axes, s.init,
                            s.scale, s.dtype), base)


def _n_enc(cfg: ModelConfig) -> int:
    return cfg.num_encoder_layers or cfg.num_layers


def param_specs(cfg: ModelConfig) -> Dict:
    d, V = cfg.d_model, cfg.padded_vocab_size
    return {
        "embed": ParamSpec((V, d), ("vocab", "embed"), "normal", scale=0.02),
        "enc_scan": _stack(_enc_layer_specs(cfg), _n_enc(cfg)),
        "enc_final_norm": norm_spec(cfg, d),
        "dec_scan": _stack(_dec_layer_specs(cfg), cfg.num_layers),
        "final_norm": norm_spec(cfg, d),
        "lm_head": ParamSpec((d, V), ("embed", "vocab")),
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _enc_layer(p, x: torch.Tensor, cfg: ModelConfig, impl: str
               ) -> torch.Tensor:
    h = apply_norm(p["norm1"], x, cfg)
    # bidirectional attention: the self-attention projections, no mask
    a = p["attn"]
    q = _heads(h, a["wq"].to(h.dtype))
    k = _heads(h, a["wk"].to(h.dtype))
    v = _heads(h, a["wv"].to(h.dtype))
    q = q / _sqrt_hd(cfg.resolved_head_dim, q.dtype)
    ctx = attention_impl.causal_attention(q, k, v, causal=False, impl=impl)
    # each block's output in the residual's layout before the add (see
    # ``transformer.apply_layer``)
    x = x + constrain_batch(_out(ctx, a["wo"].to(h.dtype)))
    h = apply_norm(p["norm2"], x, cfg)
    return constrain_batch(x + constrain_batch(mlp.apply(p["mlp"], h, cfg)))


def encode(params, cfg: ModelConfig, audio_embeds: torch.Tensor,
           impl: str = "eager") -> torch.Tensor:
    """(B, frames, d) frame embeddings -> (B, frames, d) encoder output.
    With ``cfg.remat`` a forward that records gradients runs each layer
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``)."""
    B, F, d = audio_embeds.shape
    x = audio_embeds.to(cfg.compute_dtype)
    x = constrain_batch(
        x + sinusoidal_positions(F, d, x.device).to(x.dtype)[None])
    remat = cfg.remat and torch.is_grad_enabled()
    for p in unbind_layers(params["enc_scan"], _n_enc(cfg)):
        x = (torch.utils.checkpoint.checkpoint(
            _enc_layer, p, x, cfg, impl, use_reentrant=False) if remat
            else _enc_layer(p, x, cfg, impl))
    return apply_norm(params["enc_final_norm"], x, cfg)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict:
    frames = cfg.encoder_seq or 1500
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    cross = (L, batch, frames, H, hd)
    one = attention.init_cache(cfg, batch, max_len, ATTN, device)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "self": stack_layers([one] * L),
        "cross_k": torch.zeros(cross, dtype=cfg.compute_dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=cfg.compute_dtype, device=device),
    }


def _dec_layer(p, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
               positions: torch.Tensor, cache: Optional[Dict],
               k: Optional[torch.Tensor], v: Optional[torch.Tensor],
               enc_out: Optional[torch.Tensor], impl: str,
               max_len: Optional[int]):
    """One decoder layer: (x, new self cache, cross k, cross v).  ``k`` /
    ``v`` are the cached cross K/V in decode; otherwise they are projected
    from ``enc_out``."""
    h = apply_norm(p["norm1"], x, cfg)
    y, nc = attention.apply(p["self_attn"], h, cfg, mode=mode,
                            positions=positions, cache=cache, kind=ATTN,
                            impl=impl, max_len=max_len)
    x = x + constrain_batch(y)
    h = apply_norm(p["norm_x"], x, cfg)
    if k is None:
        k, v = cross_kv(p["cross"], enc_out)
    x = x + constrain_batch(cross_apply(p["cross"], h, k, v, cfg))
    h = apply_norm(p["norm2"], x, cfg)
    return (constrain_batch(x + constrain_batch(mlp.apply(p["mlp"], h, cfg))),
            nc, k, v)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, mode: str,
            audio_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, impl: str = "eager",
            prefill_max_len: Optional[int] = None,
            last_logit_only: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Returns (logits, new_cache, metrics).  tokens: (B, S) int (S == 1 in
    decode mode); audio_embeds: (B, frames, d), for train and prefill."""
    B, S = tokens.shape
    dev = params["embed"].device
    # gather, then cast: the same values as the reference's cast-then-gather.
    # An embedding op, whose backward DTensor can place (an indexing's is
    # an accumulating index_put), from a table whole along the vocab: a
    # vocab-split table's masked lookup loses the batch split of the ids
    x = constrain_batch(torch.nn.functional.embedding(
        tokens, gather_dim(params["embed"], 0)).to(cfg.compute_dtype))
    L = cfg.num_layers

    if mode == "decode":
        assert cache is not None
        positions = cache["pos"][:, None]
        enc_out = None
    elif mode in ("train", "prefill"):
        assert audio_embeds is not None
        enc_out = encode(params, cfg, audio_embeds, impl=impl)
        positions = torch.arange(S, device=dev)
    else:
        raise ValueError(mode)

    layers = unbind_layers(params["dec_scan"], L)
    new_self, cross_k, cross_v = [], [], []
    if mode == "train" and cfg.remat and torch.is_grad_enabled():
        # the reference's jax.checkpoint of the decoder's scan body
        def run(p, x):
            return _dec_layer(p, x, cfg, mode=mode, positions=positions,
                              cache=None, k=None, v=None, enc_out=enc_out,
                              impl=impl, max_len=None)[0]

        for p in layers:
            x = torch.utils.checkpoint.checkpoint(run, p, x,
                                                  use_reentrant=False)
    else:
        dec = mode == "decode"
        for i, p in enumerate(layers):
            x, nc, k, v = _dec_layer(
                p, x, cfg, mode=mode, positions=positions,
                cache=index_layer(cache["self"], i) if dec else None,
                k=cache["cross_k"][i] if dec else None,
                v=cache["cross_v"][i] if dec else None,
                enc_out=enc_out, impl=impl, max_len=prefill_max_len)
            new_self.append(nc)
            cross_k.append(k)
            cross_v.append(v)

    new_cache = None
    if mode == "decode":
        new_cache = dict(cache, self=stack_layers(new_self),
                         pos=cache["pos"] + 1)
    elif mode == "prefill":
        new_cache = {
            "pos": torch.full((B,), S, dtype=torch.int32, device=dev),
            "self": stack_layers(new_self),
            "cross_k": torch.stack(cross_k),
            "cross_v": torch.stack(cross_v),
        }

    x = apply_norm(params["final_norm"], x, cfg)
    if last_logit_only:
        x = x[:, -1:]
    # the sequence gathered: the head's columns split over "model"
    logits = constrain_logits(
        (gather_dim(x, 1) @ params["lm_head"].to(x.dtype)).float())
    if cfg.padded_vocab_size != cfg.vocab_size:
        col = torch.arange(logits.shape[-1], device=dev)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    return logits, new_cache, {
        "aux_loss": torch.zeros((), dtype=torch.float32, device=dev)}
