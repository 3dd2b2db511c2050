"""Decoder-only transformer trunk (port of ``repro/models/transformer.py``).

Composes the block library according to ``cfg.layer_kinds``:

- layers are grouped into repeating *periods* (dense models: period 1);
  the reference runs the repeated periods with ``jax.lax.scan`` over
  **stacked** params, the port with a Python loop that indexes the same
  stacked tensors, so the parameter tree keeps the reference's keys and
  shapes (``scan_0/mix/wq`` is ``(n_periods, d, H, hd)``);
- ``moe.first_dense_layers`` leading layers and any trailing remainder run
  unstacked.

Caches follow the same grouping: {"pos", "pre_i", "scan_p" (stacked),
"rem_r"}.  With ``cfg.remat`` a training forward that records gradients
runs each period under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body): memory, not values, changes.  The block kinds are attention (full / sliding-window / local)
and RG-LRU (RecurrentGemma: (rglru, rglru, local) periods, 26 = 8x3 + 2);
the xLSTM blocks (mLSTM, sLSTM), Multi-head Latent Attention and MoE
layers are ROADMAP queue 1, item 11: they raise.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.config import (ATTENTION_KINDS, ATTN, LOCAL_ATTN, MLSTM,
                                RGLRU, SLSTM, SWA, ModelConfig)
from repro_torch.models import attention, mlp, recurrent
from repro_torch.models.base import ParamSpec, apply_norm, map_specs, norm_spec
from repro_torch.sharding import cast_weight, constrain_batch, constrain_logits


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue 1, item 11")


def _needs_mlp(cfg: ModelConfig, kind: str) -> bool:
    if kind in (MLSTM, SLSTM):
        return False          # xLSTM blocks are self-contained
    return cfg.d_ff > 0 or cfg.moe.enabled


def _kind_specs(cfg: ModelConfig, kind: str):
    if kind in (ATTN, SWA, LOCAL_ATTN):
        return attention.specs(cfg)
    if kind == RGLRU:
        return recurrent.rglru_specs(cfg)
    raise _not_ported(f"block kind {kind!r}")


def layer_specs(cfg: ModelConfig, kind: str, moe_layer: bool) -> Dict:
    sp: Dict[str, Any] = {
        "norm1": norm_spec(cfg, cfg.d_model),
        "mix": _kind_specs(cfg, kind),
    }
    if _needs_mlp(cfg, kind):
        sp["norm2"] = norm_spec(cfg, cfg.d_model)
        sp["mlp"] = mlp.moe_specs(cfg) if moe_layer else mlp.specs(cfg)
    return sp


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 device: torch.device) -> Dict:
    if kind in ATTENTION_KINDS:
        return attention.init_cache(cfg, batch, max_len, kind, device)
    if kind == RGLRU:
        return recurrent.rglru_init_cache(cfg, batch, device)
    raise _not_ported(f"block kind {kind!r}")


def apply_layer(params, x, cfg: ModelConfig, kind: str, moe_layer: bool, *,
                mode: str, positions, cache, impl: str = "eager",
                max_len=None):
    """One residual block. Returns (x, aux_loss_delta, new_cache)."""
    if moe_layer:
        raise _not_ported("a mixture-of-experts layer")
    h = apply_norm(params["norm1"], x, cfg)
    if kind in ATTENTION_KINDS:
        y, new_cache = attention.apply(params["mix"], h, cfg, mode=mode,
                                       positions=positions, cache=cache,
                                       kind=kind, impl=impl, max_len=max_len)
    elif kind == RGLRU:
        y, new_cache = recurrent.rglru_apply(params["mix"], h, cfg, mode=mode,
                                             cache=cache, impl=impl)
    else:
        raise _not_ported(f"block kind {kind!r}")
    x = constrain_batch(x + y)
    if "mlp" in params:
        h = apply_norm(params["norm2"], x, cfg)
        x = constrain_batch(x + mlp.apply(params["mlp"], h, cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, (new_cache if new_cache is not None else {})


# ---------------------------------------------------------------------------
# layer grouping
# ---------------------------------------------------------------------------
def _grouping(cfg: ModelConfig):
    kinds = cfg.layer_kinds
    n_pre = cfg.moe.first_dense_layers if cfg.moe.enabled else 0
    body = kinds[n_pre:]
    pat = cfg.block_pattern or (kinds[n_pre] if body else ATTN,)
    if isinstance(pat, str):
        pat = (pat,)
    P = len(pat)
    n_periods = len(body) // P
    n_rem = len(body) - n_periods * P
    return n_pre, P, n_periods, n_rem, kinds


def _is_moe_layer(cfg: ModelConfig, layer_idx: int) -> bool:
    return cfg.moe.enabled and layer_idx >= cfg.moe.first_dense_layers


def param_specs(cfg: ModelConfig) -> Dict:
    n_pre, P, n_periods, n_rem, kinds = _grouping(cfg)
    d, V = cfg.d_model, cfg.padded_vocab_size
    sp: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), "normal", scale=0.02),
        "final_norm": norm_spec(cfg, d),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    # pre (unstacked) layers -- dense-MLP even in MoE models
    for i in range(n_pre):
        sp[f"pre_{i}"] = layer_specs(cfg, kinds[i], moe_layer=False)
    # stacked periods: each period-position's specs over n_periods
    for p in range(P):
        kind = kinds[n_pre + p]
        base = layer_specs(cfg, kind, _is_moe_layer(cfg, n_pre + p))
        sp[f"scan_{p}"] = map_specs(
            lambda s: ParamSpec((n_periods,) + s.shape, ("stack",) + s.axes,
                                s.init, s.scale, s.dtype), base)
    # remainder layers
    for r in range(n_rem):
        li = n_pre + n_periods * P + r
        sp[f"rem_{r}"] = layer_specs(cfg, kinds[li], _is_moe_layer(cfg, li))
    return sp


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> List[Dict]:
    """The ``n`` layers of a stacked tree (views, no copy).  One
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would build a zero-filled stacked-size
    gradient for every layer (L^2 memory traffic in a training step)."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def _stack(trees: List[Dict]):
    """The per-layer trees stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> Dict:
    n_pre, P, n_periods, n_rem, kinds = _grouping(cfg)
    cache: Dict[str, Any] = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for i in range(n_pre):
        cache[f"pre_{i}"] = _layer_cache(cfg, kinds[i], batch, max_len, device)
    for p in range(P):
        one = _layer_cache(cfg, kinds[n_pre + p], batch, max_len, device)
        cache[f"scan_{p}"] = _stack([one] * n_periods)
    for r in range(n_rem):
        li = n_pre + n_periods * P + r
        cache[f"rem_{r}"] = _layer_cache(cfg, kinds[li], batch, max_len,
                                         device)
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, mode: str,
            cache: Optional[Dict] = None, extra_embeds=None,
            impl: str = "eager", prefill_max_len: Optional[int] = None,
            last_logit_only: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Returns (logits, new_cache, metrics).

    tokens: (B, S) int (S == 1 in decode mode).
    extra_embeds: (B, N, d) prepended modality embeddings (VLM stub).
    """
    n_pre, P, n_periods, n_rem, kinds = _grouping(cfg)
    B, S = tokens.shape
    dev = params["embed"].device
    # gather, then cast: the same values as the reference's cast-then-gather
    x = constrain_batch(params["embed"][tokens].to(cfg.compute_dtype))
    n_prefix = 0
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        n_prefix = extra_embeds.shape[1]
        S = S + n_prefix

    if mode == "decode":
        assert cache is not None and S == 1
        positions = cache["pos"][:, None]                 # (B,1)
    else:
        positions = torch.arange(S, device=dev)

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_cache: Dict[str, Any] = {}

    def run(layer_params, x, kind, moe_layer, layer_cache):
        return apply_layer(layer_params, x, cfg, kind, moe_layer, mode=mode,
                           positions=positions, cache=layer_cache or None,
                           impl=impl, max_len=prefill_max_len)

    # --- pre layers --------------------------------------------------------
    for i in range(n_pre):
        x, aux, nc = run(params[f"pre_{i}"], x, kinds[i], False,
                         None if cache is None else cache[f"pre_{i}"])
        aux_total = aux_total + aux
        new_cache[f"pre_{i}"] = nc

    # --- stacked periods (the reference's lax.scan) --------------------------
    layers = [_unbind(params[f"scan_{p}"], n_periods) if n_periods else []
              for p in range(P)]
    if n_periods > 0 and cfg.remat and mode == "train" \
            and torch.is_grad_enabled():
        # the reference's jax.checkpoint of the scan body: each period keeps
        # only its input for the backward pass and recomputes the rest
        def period(i, x, aux_total):
            for p in range(P):
                li = n_pre + p
                x, aux, _ = run(layers[p][i], x, kinds[li],
                                _is_moe_layer(cfg, li), None)
                aux_total = aux_total + aux
            return x, aux_total

        for i in range(n_periods):
            x, aux_total = torch.utils.checkpoint.checkpoint(
                period, i, x, aux_total, use_reentrant=False)
    elif n_periods > 0:
        period_caches: List[List[Dict]] = [[] for _ in range(P)]
        for i in range(n_periods):
            for p in range(P):
                li = n_pre + p
                layer_cache = (_index(cache[f"scan_{p}"], i)
                               if cache is not None else None)
                x, aux, nc = run(layers[p][i], x, kinds[li],
                                 _is_moe_layer(cfg, li), layer_cache)
                aux_total = aux_total + aux
                period_caches[p].append(nc)
        for p in range(P):
            new_cache[f"scan_{p}"] = _stack(period_caches[p])

    # --- remainder layers -----------------------------------------------------
    for r in range(n_rem):
        li = n_pre + n_periods * P + r
        x, aux, nc = run(params[f"rem_{r}"], x, kinds[li],
                         _is_moe_layer(cfg, li),
                         None if cache is None else cache[f"rem_{r}"])
        aux_total = aux_total + aux
        new_cache[f"rem_{r}"] = nc

    x = apply_norm(params["final_norm"], x, cfg)
    if n_prefix and mode != "decode":
        x = x[:, n_prefix:]
    if last_logit_only:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        head = cast_weight(params["embed"], x.dtype, ("vocab", "embed")).T
    else:
        head = cast_weight(params["lm_head"], x.dtype, ("embed", "vocab"))
    logits = constrain_logits((x @ head).float())
    if cfg.logits_softcap:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    if cfg.padded_vocab_size != cfg.vocab_size:
        # mask pad columns exactly
        col = torch.arange(logits.shape[-1], device=dev)
        logits = torch.where(col < cfg.vocab_size, logits, -1e30)

    metrics = {"aux_loss": aux_total}
    if mode == "train":
        return logits, None, metrics
    if mode in ("prefill", "decode"):
        new_cache["pos"] = (
            torch.full((B,), S, dtype=torch.int32, device=dev)
            if mode == "prefill" else cache["pos"] + 1)
        return logits, new_cache, metrics
    raise ValueError(mode)
