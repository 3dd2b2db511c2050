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

from repro_torch import obs
from repro_torch.config import ModelConfig
from repro_torch.models.base import ParamSpec, activation
from repro_torch.sharding import (axes_sum, batch_axes, batch_ranks,
                                  batch_spec, cast_weight, constrain_moe,
                                  from_local, gather_dim, model_axis_size, model_rank,
                                  on_mesh, to_local)


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
    """The dense MLP; under a mesh the sequence is gathered first (the
    products' flatten of a split sequence is a view torch 2.11 refuses)."""
    x = gather_dim(x, 1)
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


def _masks(expert_idx: torch.Tensor, gate_vals: torch.Tensor, E: int,
           C: int, dtype: torch.dtype, lo: int = 0, hi: Optional[int] = None,
           ) -> Tuple[torch.Tensor, torch.Tensor, list]:
    """The dispatch and combine masks (G, Tg, hi - lo, C) of experts
    [lo, hi) (default: all) and each of the k choices' keep mask (G, Tg).

    A token's slot in its expert is counted over all E experts in int32 (a
    0/1 cumsum, exact), so a slice of experts gets the same slots as the
    whole."""
    G, Tg, k = expert_idx.shape
    hi = E if hi is None else hi
    dev = expert_idx.device
    experts = torch.arange(E, device=dev)
    slots = torch.arange(C, device=dev)
    counts = torch.zeros((G, 1, E), dtype=torch.int32, device=dev)
    dispatch = torch.zeros((G, Tg, hi - lo, C), dtype=dtype, device=dev)
    combine = torch.zeros((G, Tg, hi - lo, C), dtype=dtype, device=dev)
    keeps = []
    for r in range(k):
        chosen = expert_idx[..., r, None] == experts               # (G,Tg,E)
        mr = chosen.to(torch.int32)
        pos = torch.cumsum(mr, dim=1, dtype=torch.int32) - mr + counts
        p = torch.sum(pos * mr, dim=-1)                            # (G,Tg)
        keep = p < C
        # the slot's one-hot by comparison: a zero row where p >= C, as
        # jax.nn.one_hot gives it
        cpos = p[..., None] == slots                               # (G,Tg,C)
        dr = (chosen[..., lo:hi, None] & cpos[:, :, None, :]
              & keep[..., None, None]).to(dtype)
        dispatch = dispatch + dr
        combine = combine + gate_vals[..., r, None, None].to(dtype) * dr
        counts = counts + mr.sum(dim=1, keepdim=True, dtype=torch.int32)
        keeps.append(keep)
    return dispatch, combine, keeps


def _capacity(T: int, m) -> Tuple[int, int, int]:
    """(G, Tg, C) for T tokens."""
    E, k = m.num_experts, m.experts_per_token
    cf = m.capacity_factor if m.capacity_factor > 0 else 1.25
    G = _num_groups(T, E, k, cf)
    Tg = T // G
    return G, Tg, max(int(Tg * k / E * cf), 1)


def _experts_ffn(dispatched: torch.Tensor, w: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    act = activation(cfg.act)
    u = torch.einsum("gecd,edf->gecf", dispatched, w["wi_up"])
    g_ = torch.einsum("gecd,edf->gecf", dispatched, w["wi_gate"])
    return torch.einsum("gecf,efd->gecd", act(g_) * u, w["wo"])


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """GShard-style dense dispatch (groups x capacity), returns (y, metrics).

    Tokens are split into G groups; each group has local capacity
    C = Tg*k/E*cf.  The router runs in fp32; the dispatch and combine masks
    are in x's dtype, the combine weights the gate values cast to it.
    The ``constrain_moe`` calls sit where the reference's do (no-ops with no
    activation mesh); under one, the layer runs on the rank's shards
    (:func:`_moe_local`).  ``metrics`` holds the Switch load-balance loss
    ``moe_aux_loss``, the router z-loss ``moe_z_loss`` and
    ``moe_dropped_frac``, the share of the k assignments dropped past C."""
    if on_mesh(x):
        return _moe_local(params, x, cfg)
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    T = B * S
    G, Tg, C = _capacity(T, m)
    dev = x.device

    dtype = x.dtype
    with obs.span("moe.route"):
        probs, logits = router_probs(params, x, cfg)   # (B,S,E) fp32
        probs_g = probs.reshape(G, Tg, E)
        gate_vals, expert_idx = top_k(probs_g, k)             # (G,Tg,k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)

        # ---- aux losses (Switch-style load balance + router z-loss) ------
        experts = torch.arange(E, device=dev)
        density = probs_g.reshape(T, E).mean(dim=0)
        usage_oh = (expert_idx[..., None] == experts).float()  # (G,Tg,k,E)
        usage = usage_oh.sum(2).reshape(T, E).mean(dim=0)
        aux_loss = E * torch.sum(density * usage) * m.router_aux_loss
        z_loss = m.router_z_loss * torch.mean(
            torch.square(torch.logsumexp(logits.reshape(T, E), dim=-1)))

        # ---- per-group positions + dispatch/combine masks -----------------
        dispatch, combine, keeps = _masks(expert_idx, gate_vals, E, C, dtype)
        kept = torch.zeros((), dtype=torch.float32, device=dev)
        for keep in keeps:
            kept = kept + keep.float().mean()

    xg = constrain_moe(x.reshape(G, Tg, d))
    dispatch = constrain_moe(dispatch, expert_dim=2)
    combine = constrain_moe(combine, expert_dim=2)

    # ---- dispatch -> expert FFN -> combine ---------------------------------
    with obs.span("moe.dispatch"):
        dispatched = torch.einsum("gsec,gsd->gecd", dispatch, xg)
    dispatched = constrain_moe(dispatched, expert_dim=1)
    eaxes = ("experts", "embed_expert", "mlp")
    with obs.span("moe.experts"):
        w = {"wi_up": cast_weight(params["wi_up"], dtype, eaxes),
             "wi_gate": cast_weight(params["wi_gate"], dtype, eaxes),
             "wo": cast_weight(params["wo"], dtype,
                               ("experts", "mlp", "embed_expert"))}
        expert_out = _experts_ffn(dispatched, w, cfg)
    expert_out = constrain_moe(expert_out, expert_dim=1)
    with obs.span("moe.dispatch"):
        y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    y = constrain_moe(y).reshape(B, S, d)

    if m.num_shared_experts:
        y = y + _shared_apply(params["shared"], x, cfg)

    metrics = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
               "moe_dropped_frac": 1.0 - kept / k}
    return y, metrics


def _moe_local(params, x, cfg: ModelConfig):
    """:func:`moe_apply` of a DTensor under the activation mesh, on the
    rank's shards, so that no DTensor op (and so no torch version's rule
    for a view of a split dim) lies between its entry and its exit.

    Expert parallelism over "model": rank r of M holds experts
    [r*E//M, (r+1)*E//M) -- the banks' own ``experts`` split where M
    divides E, else a slice of the banks gathered whole -- and every rank
    routes the same tokens: its batch rows' whole groups where the batch
    axes divide both B and G, else all of them; the sequence is gathered.
    Each rank dispatches to, runs and combines its own experts; one
    all-reduce over "model" sums the outputs.  The routing statistics are
    summed over the batch axes that split the tokens, and the losses'
    gradients taken on "model" rank 0 only.  So the tokens' and weights'
    gradients come back as partial sums over "model" and those axes."""
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.num_experts, m.experts_per_token
    T = B * S
    G, Tg, C = _capacity(T, m)
    M, rm = model_axis_size(), model_rank()
    lo, hi = rm * E // M, (rm + 1) * E // M
    dp = batch_ranks()
    tok_axes = batch_axes() if B % dp == 0 and G % dp == 0 else ()
    spec = batch_spec(x.shape) if tok_axes else (None, None, None)
    grads = ("model",) + tok_axes
    dtype = x.dtype

    xl = to_local(x, spec, partial_grad=("model",))
    with obs.span("moe.route"):
        router = to_local(params["router"].float(), (None, None),
                          partial_grad=grads)
        logits = xl.float() @ router                         # (Bl,S,E)
        probs = torch.softmax(logits, dim=-1)
        Gl = xl.shape[0] * S // Tg
        gate_vals, expert_idx = top_k(probs.reshape(Gl, Tg, E), k)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(
            min=1e-9)
        dispatch, combine, keeps = _masks(expert_idx, gate_vals, E, C,
                                          dtype, lo, hi)

    banks = {"wi_up": params["wi_up"], "wi_gate": params["wi_gate"],
             "wo": params["wo"]}
    whole = E % M != 0
    with obs.span("moe.experts"):
        w = {n: to_local(t.to(dtype),
                         (None if whole else "model", None, None),
                         partial_grad=grads) for n, t in banks.items()}
        if whole:
            w = {n: t[lo:hi] for n, t in w.items()}
    with obs.span("moe.dispatch"):
        dispatched = torch.einsum("gsec,gsd->gecd", dispatch,
                                  xl.reshape(Gl, Tg, d))
    with obs.span("moe.experts"):
        expert_out = _experts_ffn(dispatched, w, cfg)
    with obs.span("moe.dispatch"):
        y = torch.einsum("gsec,gecd->gsd", combine, expert_out)
    y = from_local(axes_sum(y.reshape(xl.shape), ("model",),
                            sum_grads=False), (B, S, d), spec)

    # ---- the losses from statistics summed over the tokens -----------------
    with obs.span("moe.route"):
        usage = (expert_idx[..., None] == torch.arange(E, device=x.device)
                 ).float().sum((0, 1, 2))
        lse = torch.logsumexp(logits.reshape(-1, E), dim=-1)
        kept = sum(keep.float().sum() for keep in keeps)
        stats = axes_sum(torch.cat([probs.reshape(-1, E).sum(0), usage,
                                    torch.square(lse).sum()[None],
                                    kept[None]]), tok_axes,
                         sum_grads=False) / T
        aux_loss = E * torch.sum(stats[:E] * stats[E:2 * E]) \
            * m.router_aux_loss
        z_loss = m.router_z_loss * stats[2 * E]
    lead = torch.tensor(rm == 0, device=x.device)
    metrics = {"moe_aux_loss": torch.where(lead, aux_loss, aux_loss.detach()),
               "moe_z_loss": torch.where(lead, z_loss, z_loss.detach()),
               "moe_dropped_frac": 1.0 - stats[2 * E + 1].detach() / k}
    metrics = {n: from_local(t, (), ()) for n, t in metrics.items()}

    if m.num_shared_experts:
        y = y + _shared_apply(params["shared"], x, cfg)
    return y, metrics


def _shared_apply(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = gather_dim(x, 1)
    act = activation(cfg.act)
    g = x @ cast_weight(params["wi_gate"], x.dtype, ("embed", "mlp"))
    u = x @ cast_weight(params["wi_up"], x.dtype, ("embed", "mlp"))
    return (act(g) * u) @ cast_weight(params["wo"], x.dtype, ("mlp", "embed"))
