"""MLP blocks (port of ``repro/models/mlp.py``): the gated (SwiGLU /
GeGLU) and plain dense MLP, and the token-choice top-k MoE.

MoE = GShard-style dense dispatch, as the reference's: tokens split into G
groups with per-group capacity C = Tg*k/E*cf; dispatch / combine are
one-hot einsums over (G, Tg, E, C) masks.  Overflow beyond C is dropped
(GShard / Switch semantics).  The expert products are plain batched
matmuls: the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.base import ParamSpec, activation
from repro_torch.sharding import cast_weight, constrain_moe


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
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.num_experts
    out = {
        "router": ParamSpec((d, E), ("embed", "experts"), "normal", scale=0.02),
        "wi_gate": ParamSpec((E, d, f), ("experts", "embed_expert", "mlp")),
        "wi_up": ParamSpec((E, d, f), ("experts", "embed_expert", "mlp")),
        "wo": ParamSpec((E, f, d), ("experts", "mlp", "embed_expert")),
    }
    if m.num_shared_experts:
        out["shared"] = specs(cfg, d_ff=m.d_ff * m.num_shared_experts)
    return out


def router_probs(params, x: torch.Tensor,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax probabilities, logits), both (B, S, E) fp32."""
    logits = x.float() @ params["router"].float()
    return torch.softmax(logits, dim=-1), logits


def _num_groups(T: int, E: int, k: int, cf: float) -> int:
    """Largest group count such that per-group capacity stays >= ~16
    (statistical load-balance) and groups divide the token count."""
    min_tg = max(int(16 * E / max(k * max(cf, 1.0), 1.0)), 1)
    g_max = min(max(T // min_tg, 1), 4096)
    for g in range(g_max, 0, -1):
        if T % g == 0:
            return g
    return 1


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values, and on a
    tie the lower index first (a stable descending sort; ``torch.topk``
    promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GShard-style dense dispatch (groups x capacity), returns (y, metrics).

    Tokens are split into G groups; each group has local capacity
    C = Tg*k/E*cf.  The router runs in fp32; the dispatch and combine masks
    are in x's dtype, the combine weights the gate values cast to it.  A
    token's slot in its expert is counted in int32 (a 0/1 cumsum, exact).
    The ``constrain_moe`` calls sit where the reference's do (no-ops with no
    activation mesh).  ``metrics`` holds the Switch load-balance loss
    ``moe_aux_loss``, the router z-loss ``moe_z_loss`` and
    ``moe_dropped_frac``, the share of the k assignments dropped past C."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    T = B * S
    cf = m.capacity_factor if m.capacity_factor > 0 else 1.25
    G = _num_groups(T, E, k, cf)
    Tg = T // G
    C = max(int(Tg * k / E * cf), 1)
    dev = x.device

    probs, logits = router_probs(params, x, cfg)   # (B,S,E) fp32
    probs_g = probs.reshape(G, Tg, E)
    gate_vals, expert_idx = top_k(probs_g, k)                 # (G,Tg,k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)

    # ---- aux losses (Switch-style load balance + router z-loss) ----------
    experts = torch.arange(E, device=dev)
    density = probs_g.reshape(T, E).mean(dim=0)
    usage_oh = (expert_idx[..., None] == experts).float()    # (G,Tg,k,E)
    usage = usage_oh.sum(2).reshape(T, E).mean(dim=0)
    aux_loss = E * torch.sum(density * usage) * m.router_aux_loss
    z_loss = m.router_z_loss * torch.mean(
        torch.square(torch.logsumexp(logits.reshape(T, E), dim=-1)))

    # ---- per-group positions + dispatch/combine masks ---------------------
    dtype = x.dtype
    slots = torch.arange(C, device=dev)
    counts = torch.zeros((G, 1, E), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((G, Tg, E, C), dtype=dtype, device=dev)
    combine = torch.zeros((G, Tg, E, C), dtype=dtype, device=dev)
    kept = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(k):
        chosen = expert_idx[..., r, None] == experts               # (G,Tg,E)
        mr = chosen.to(torch.int32)
        pos = torch.cumsum(mr, dim=1, dtype=torch.int32) - mr + counts
        p = torch.sum(pos * mr, dim=-1)                            # (G,Tg)
        keep = p < C
        # the slot's one-hot by comparison: a zero row where p >= C, as
        # jax.nn.one_hot gives it
        cpos = p[..., None] == slots                               # (G,Tg,C)
        dr = (chosen[..., None] & cpos[:, :, None, :]
              & keep[..., None, None]).to(dtype)
        dispatch = dispatch + dr
        combine = combine + gate_vals[..., r, None, None].to(dtype) * dr
        counts = counts + mr.sum(dim=1, keepdim=True, dtype=torch.int32)
        kept = kept + keep.float().mean()

    xg = constrain_moe(x.reshape(G, Tg, d))
    dispatch = constrain_moe(dispatch, expert_dim=2)
    combine = constrain_moe(combine, expert_dim=2)

    # ---- dispatch -> expert FFN -> combine ---------------------------------
    dispatched = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    dispatched = constrain_moe(dispatched, expert_dim=1)
    act = activation(cfg.act)
    eaxes = ("experts", "embed_expert", "mlp")
    u = torch.einsum("gecd,edf->gecf", dispatched,
                     cast_weight(params["wi_up"], dtype, eaxes))
    g_ = torch.einsum("gecd,edf->gecf", dispatched,
                      cast_weight(params["wi_gate"], dtype, eaxes))
    h = act(g_) * u
    expert_out = torch.einsum("gecf,efd->gecd", h,
                              cast_weight(params["wo"], dtype,
                                          ("experts", "mlp", "embed_expert")))
    expert_out = constrain_moe(expert_out, expert_dim=1)
    y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    y = constrain_moe(y).reshape(B, S, d)

    if m.num_shared_experts:
        y = y + _shared_apply(params["shared"], x, cfg)

    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": 1.0 - kept / k}
    return y, metrics


def _shared_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    g = x @ cast_weight(params["wi_gate"], x.dtype, ("embed", "mlp"))
    u = x @ cast_weight(params["wi_up"], x.dtype, ("embed", "mlp"))
    return (act(g) * u) @ cast_weight(params["wo"], x.dtype, ("mlp", "embed"))
