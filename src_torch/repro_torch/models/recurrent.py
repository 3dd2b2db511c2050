"""Recurrent blocks (port of ``repro/models/recurrent.py``): the
Griffin / RecurrentGemma RG-LRU block and the xLSTM mLSTM and sLSTM
blocks.

Each has the attention blocks' contract:
  *_specs(cfg)                          -> ParamSpec tree (one layer)
  *_init_cache(cfg, batch, device)      -> decode state (one layer)
  *_apply(params, x, cfg, *, mode, cache) -> (y, new_cache)

Decode advances the recurrent state by one token.  Prefill and train run
the whole sequence:

- RG-LRU runs its recurrence ``h = a * h0 + gx``, selected by ``impl`` as
  the attention contraction is: ``impl="flash"`` (the counterpart of the
  reference's Pallas path) runs the hand-written Hopper kernel
  :func:`repro_torch.kernels.rglru_scan.rglru_scan` (its plain twin on a
  CPU tensor) on ``(a, gx, h0)``; ``impl="eager"`` (the counterpart of
  ``"xla"``, whose model runs ``lax.associative_scan``) runs
  :func:`linear_scan_eager`, a log-depth scan in plain torch ops over
  ``(a, gx)`` with ``a_0 * h0`` folded into ``gx_0``, as the reference
  does;
- mLSTM runs the stabilised parallel (quadratic) form, chunked over
  queries as the reference chunks it; a prefill also builds the final
  ``(C, n, m)`` state;
- sLSTM is sequential: a Python loop over the sequence of
  :func:`_slstm_cell` (the reference's ``lax.scan``).

The xLSTM blocks are plain torch on either ``impl``: the reference's are
XLA graphs on either of its paths.  The recurrences and their gates are
fp32 wherever the reference computes them in fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models.attention_impl import chunk_size
from repro_torch.models.base import ParamSpec, activation
from repro_torch.sharding import (batch_axes, batch_spec, cast_weight,
                                  from_local, gather_dim, gather_seq,
                                  model_axis_size, model_dim, model_max,
                                  model_rank, model_sharded, model_sum,
                                  on_mesh, to_local)

RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _block_diag_spec(heads: int, width: int) -> ParamSpec:
    per = width // heads
    return ParamSpec((heads, per, per), ("heads", "state", "state"))


def _block_diag_apply(w: torch.Tensor, x: torch.Tensor, heads: int
                      ) -> torch.Tensor:
    """x: (..., width) -> block-diagonal linear per head.

    Under a "model" axis whose size does not divide the heads, a width
    split over it cuts through heads, and the product over the split
    reshape would leave a pending partial sum (which torch 2.11 cannot add
    a bias to): the width is gathered first, the weight made whole (a
    stacked weight of 8 MB or more comes split over a per-head dim, by
    ``params_shardings``' salvage pass, and the product's gradient would
    then come back split inside the heads, which no view into heads
    keeps), and the product, whole on every rank, taken back to the
    input's split (a local slice).  Heads that divide the axis keep their
    split through the reshape."""
    per = w.shape[-1]
    back = None
    if model_sharded(x) and heads % model_axis_size() != 0:
        from torch.distributed.tensor import Replicate, Shard

        back = [p if isinstance(p, Shard) else Replicate()
                for p in x.placements]
        x = gather_dim(x, -1)
        w = w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
    xh = x.reshape(x.shape[:-1] + (heads, per))
    y = torch.einsum("...hi,hij->...hj", xh, w.to(x.dtype)).reshape(x.shape)
    if back is not None:
        y = y.redistribute(y.device_mesh, back)
    return y


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
    # the sequence gathered: torch 2.11 refuses the products' flatten of a
    # split one
    x = gather_dim(x, 1)
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


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``-jax.nn.softplus(-x)``: softplus as ``logaddexp(x, 0)``, which
    ``F.softplus`` is not past its linear threshold."""
    return -torch.logaddexp(-x, torch.zeros_like(x))


# ===========================================================================
# mLSTM (xLSTM, arXiv:2405.04517) -- matrix memory, parallelizable
# ===========================================================================
def mlstm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    H = cfg.num_heads
    dk = di // H
    return {
        "w_up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, di), ("conv", "mlp"), "normal",
                            scale=1.0 / math.sqrt(cfg.conv_width)),
        "conv_b": ParamSpec((di,), ("mlp",), "zeros"),
        "wq": ParamSpec((di, H, dk), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((di, H, dk), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((di, H, dk), ("mlp", "heads", "head_dim")),
        "w_if": ParamSpec((di, 2 * H), ("mlp", "heads"), "normal", scale=0.02),
        "b_if": ParamSpec((2 * H,), ("heads",), "zeros"),
        "gn_scale": ParamSpec((H, dk), ("heads", "head_dim"), "zeros"),
        "skip_scale": ParamSpec((di,), ("mlp",), "ones"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def mlstm_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Dict:
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    dk = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, dk, dk), **f32),
        "n": torch.zeros((batch, H, dk), **f32),
        "m": torch.full((batch, H), -1e30, **f32),
        "conv": torch.zeros((batch, cfg.conv_width - 1, di),
                            dtype=cfg.compute_dtype, device=device),
    }


def _groupnorm_heads(h: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h: (B,S,H,dk) per-head normalization, fp32 (the population
    variance, as ``jnp.var``)."""
    h32 = h.float()
    mu = torch.mean(h32, dim=-1, keepdim=True)
    var = torch.var(h32, dim=-1, keepdim=True, correction=0)
    y = (h32 - mu) * torch.rsqrt(var + 1e-6)
    return y * (1.0 + scale.float())


def _mlstm_chunk(start: int, Fq, qc, F_all, i_raw, k32, v32):
    """Rows ``start..start+Cq`` of the stabilised parallel form.  Fq:
    (B,Cq,H) cumulative log forget gates of the chunk's queries; qc:
    (B,Cq,H,dk); F_all, i_raw: (B,S,H); k32, v32: (B,S,H,dk)."""
    S = F_all.shape[1]
    logd = (Fq[:, :, None, :] - F_all[:, None, :, :]
            + i_raw[:, None, :, :])                      # (B,Cq,Sk,H)
    qpos = start + torch.arange(Fq.shape[1], device=Fq.device)[:, None]
    kpos = torch.arange(S, device=Fq.device)[None, :]
    logd = logd.masked_fill(~(kpos <= qpos)[None, :, :, None], -math.inf)
    mrow = torch.amax(logd, dim=2)                       # (B,Cq,H)
    D = torch.exp(logd - mrow[:, :, None, :])
    del logd
    sc = torch.einsum("bqnh,bknh->bqkn", qc, k32) * D
    del D
    norm = torch.maximum(torch.abs(sc.sum(2)), torch.exp(-mrow))
    if on_mesh(sc):
        # DTensor's einsum views the permuted local shard, which a
        # non-contiguous one refuses (a query chunk split over "model")
        sc = sc.contiguous()
    return torch.einsum("bqkn,bknh->bqnh", sc, v32) / norm[..., None]


def _cumsum_seq(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum`` along the sequence (dim 1).  A DTensor's runs on
    the rank's shard with the sequence whole: its backward flips, and
    torch 2.11's DTensor has no rule for ``flip``."""
    if not on_mesh(x):
        return torch.cumsum(x, dim=1)
    spec = batch_spec(x.shape)
    return from_local(torch.cumsum(to_local(x, spec), dim=1), x.shape, spec)


def _mlstm_weights(params, dtype: torch.dtype) -> Dict:
    """The block's weights as its products take them: the matrices cast to
    the compute ``dtype`` (model-axis-only copies under a mesh), the conv,
    biases and scales as they are (cast where they are used)."""
    heads = ("mlp", "heads", "head_dim")
    axes = {"w_up": ("embed", "mlp"), "wq": heads, "wk": heads,
            "wv": heads, "w_if": ("mlp", "heads"), "w_down": ("mlp", "embed")}
    return {k: (cast_weight(v, dtype, axes[k]) if k in axes else v)
            for k, v in params.items()}


def _mlstm_inputs(w: Dict, xm: torch.Tensor, H: int, conv_state):
    """The causal conv of the up-projection's first half ``xm`` and the q /
    k / v and gate projections: ``(xc, q, k, v, i_raw, logf, new_conv)``,
    the gates fp32."""
    B, S, di = xm.shape
    dk = di // H
    xc, new_conv = _causal_conv(xm, w["conv_w"], w["conv_b"], conv_state)
    xc = F.silu(xc)
    # the reference divides by a weakly typed scalar: rounded to x's dtype
    rdk = torch.tensor(math.sqrt(dk), dtype=torch.float32).to(xm.dtype)
    q = (xc @ w["wq"].reshape(di, di)).view(B, S, H, dk) / rdk
    k = (xc @ w["wk"].reshape(di, di)).view(B, S, H, dk) / rdk
    v = (xm @ w["wv"].reshape(di, di)).view(B, S, H, dk)
    # the product's pending sum reduced before the bias (torch 2.11 cannot
    # make a split bias a partial sum)
    if_gates = (gather_dim(xc @ w["w_if"], -1)
                + w["b_if"].to(xm.dtype)).float()
    i_raw, f_raw = torch.chunk(if_gates, 2, dim=-1)      # (B,S,H)
    return xc, q, k, v, i_raw, _log_sigmoid(f_raw), new_conv


def _mlstm_rows(start: int, Fq, q32, F_all, i_raw, k32, v32):
    """Query rows ``start..start+len(Fq)`` of the stabilised parallel form
    against all of ``F_all`` / ``i_raw`` / ``k32`` / ``v32``, chunked over
    the rows as the reference chunks its queries: (B,Cq,S,H) fp32 tensors
    per chunk, each chunk recomputed in the backward pass (the reference's
    jax.checkpoint of its chunk body)."""
    S, n = F_all.shape[1], Fq.shape[1]
    Cq = chunk_size(n)
    remat = torch.is_grad_enabled() and Cq < S
    parts = []
    for c in range(0, n, Cq):
        args = (start + c, Fq[:, c:c + Cq], q32[:, c:c + Cq], F_all, i_raw,
                k32, v32)
        parts.append(torch.utils.checkpoint.checkpoint(
            _mlstm_chunk, *args, use_reentrant=False) if remat
            else _mlstm_chunk(*args))
    return torch.cat(parts, dim=1)


def _mlstm_out(w: Dict, h, xc, z, dtype: torch.dtype):
    """Head norm, the learnable skip, the output gate and the down
    projection of the cell's output h (B,S,H,dk)."""
    B, S = xc.shape[:2]
    h = _groupnorm_heads(h, w["gn_scale"]).reshape(B, S, -1).to(dtype)
    h = h + w["skip_scale"].to(dtype) * xc
    return (h * F.silu(z)) @ w["w_down"]


def _mlstm_step(q1, k1, v1, i1, f1, C0, n0, m0, total=lambda t: t):
    """One decode step of the cell in fp32: the read-out h (B,H,dk) and
    the new state (C, n, m) from the token's q, k, v (B,H,dk), its gates
    (B,H) and the state.  ``total`` completes the two contractions over
    the keys' dim (a sum over ranks where that dim is split)."""
    m1 = torch.maximum(f1 + m0, i1)
    fs = torch.exp(f1 + m0 - m1)[..., None]
    isc = torch.exp(i1 - m1)[..., None]
    C1 = (fs[..., None] * C0
          + isc[..., None] * k1[..., :, None] * v1[..., None, :])
    n1 = fs * n0 + isc * k1
    num = total(torch.einsum("bhk,bhkv->bhv", q1, C1))
    dot = total(torch.einsum("bhk,bhk->bh", q1, n1))
    den = torch.maximum(torch.abs(dot), torch.exp(-m1))[..., None]
    return num / den, C1, n1, m1


def _mlstm_step_local(q1, k1, v1, i1, f1, C0, n0, m0):
    """:func:`_mlstm_step` of DTensors on local shards, the state kept
    where the cache's rule places it: its heads split over "model" (each
    rank steps its own heads), or the keys' dim (each rank's part of the
    two contractions, summed over "model"), or neither.  DTensor's
    products would flatten the split dim, a view torch 2.11 refuses."""
    split = model_dim(C0)
    total = ((lambda t: model_sum(t, sum_grads=False)) if split == 2
             else (lambda t: t))

    def spec(t, keys: bool):
        return batch_spec(t.shape, 1 if split == 1 else
                          2 if split == 2 and keys else None)

    args = (q1, k1, v1, i1, f1, C0, n0, m0)
    # q, k, C and n carry the keys' dim; v, the gates and m do not (h, of
    # v's shape, comes whole over the keys)
    specs = [spec(t, keys) for t, keys in zip(
        args, (True, True, False, False, False, True, True, False))]
    out = _mlstm_step(*(to_local(t, sp) for t, sp in zip(args, specs)),
                      total=total)
    return tuple(from_local(o, args[i].shape, specs[i])
                 for o, i in zip(out, (2, 5, 6, 7)))


def mlstm_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    if mode in ("train", "prefill") and _mlstm_splits(x, cfg):
        return _mlstm_apply_split(params, x, cfg, mode=mode, cache=cache)
    H = cfg.num_heads
    w = _mlstm_weights(params, x.dtype)
    xm, z = torch.chunk(x @ w["w_up"], 2, dim=-1)        # (B,S,di) each
    conv_state = cache["conv"] if cache is not None else None
    xc, q, k, v, i_raw, logf, new_conv = _mlstm_inputs(w, xm, H, conv_state)

    if mode == "decode":
        step = _mlstm_step_local if on_mesh(q) else _mlstm_step
        h, C1, n1, m1 = step(q[:, 0].float(), k[:, 0].float(),
                             v[:, 0].float(), i_raw[:, 0], logf[:, 0],
                             cache["C"], cache["n"], cache["m"])
        h = h[:, None]                                   # (B,1,H,dk)
        new_cache = {"C": C1, "n": n1, "m": m1, "conv": new_conv}
    elif mode in ("train", "prefill"):
        F_all = _cumsum_seq(logf)                        # (B,S,H)
        k32, v32 = k.float(), v.float()
        h = _mlstm_rows(0, F_all, q.float(), F_all, i_raw, k32, v32)
        new_cache = None
        if mode == "prefill":
            # the final recurrent state, for decode to continue from
            wl = F_all[:, -1:, :] - F_all + i_raw        # (B,S,H)
            ms = torch.amax(wl, dim=1)                   # (B,H)
            wexp = torch.exp(wl - ms[:, None, :])
            Cf = torch.einsum("bsn,bsnk,bsnv->bnkv", wexp, k32, v32)
            nf = torch.einsum("bsn,bsnk->bnk", wexp, k32)
            new_cache = {"C": Cf, "n": nf, "m": ms, "conv": new_conv}
    else:
        raise ValueError(mode)
    return _mlstm_out(w, h, xc, z, x.dtype), new_cache


def _mlstm_splits(x: torch.Tensor, cfg: ModelConfig) -> bool:
    """Whether the block runs on local shards: a residual stream whose
    sequence is split over "model" with at least a conv halo of tokens a
    rank."""
    return (model_dim(x) == 1
            and x.shape[1] // model_axis_size() >= cfg.conv_width - 1)


def _mlstm_apply_split(params, x: torch.Tensor, cfg: ModelConfig, *,
                       mode: str, cache: Optional[Dict]):
    """:func:`mlstm_apply`'s train and prefill on a residual stream whose
    sequence is split over "model" (the reference's layout,
    ``src/repro/sharding.py``'s ``constrain_batch``): the block keeps the
    split and runs on the rank's shards (:func:`_mlstm_shard`) with the
    weights whole, so that no DTensor op, and so no torch version's
    choice of layout, lies between this entry and its exit.  The weights'
    gradients come back as partial sums over the batch axes and "model"."""
    B, S, d = x.shape
    spec = batch_spec(x.shape, 1)
    grads = batch_axes() + ("model",)
    w = {k: to_local(t, (None,) * t.ndim, partial_grad=grads)
         for k, t in _mlstm_weights(params, x.dtype).items()}
    conv0 = (None if cache is None else
             to_local(cache["conv"], batch_spec(cache["conv"].shape)))
    y, state = _mlstm_shard(w, to_local(x, spec), conv0, cfg, mode)
    y = from_local(y, (B, S, d), spec)
    if state is None:
        return y, None
    return y, {k: from_local(t, (B,) + tuple(t.shape[1:]),
                             batch_spec((B,) + tuple(t.shape[1:])))
               for k, t in state.items()}


def _mlstm_shard(w: Dict, x: torch.Tensor, conv0: Optional[torch.Tensor],
                 cfg: ModelConfig, mode: str):
    """The mLSTM block on local tensors: ``x`` (b, s, d) is this rank's run
    of ``s`` tokens of a sequence split over "model", ``w`` the whole
    weights, ``conv0`` the carried conv state (or None).  Explicit
    collectives join the ranks:

    - the causal conv takes its halo, the previous rank's last
      ``conv_width - 1`` inputs, from one small all-gather of every rank's
      tail (rank 0 takes ``conv0``);
    - the cumulative log forget gates are offset by the earlier ranks'
      totals, from one all-gather of (b, H) a rank;
    - k, v, ``i_raw`` and the offset gates are gathered along the sequence
      once, and the rank computes its own query rows of the parallel form
      against them: 1/m of the plain block's work;
    - a prefill's final (C, n, m) state is the plain one's sum over the
      sequence taken over the rank's tokens and combined over "model"
      (the row max through ``model_max``, the sums in one all-reduce); its
      conv state is the last rank's tail.

    Returns y (b, s, d) and, in prefill, the state whole on every rank."""
    b, s, _ = x.shape
    H, K = cfg.num_heads, cfg.conv_width
    m, r = model_axis_size(), model_rank()
    # every rank's use of a gathered tensor reaches its gradient, rank 0's
    # too (through ``torch.where``): the backward's reduce-scatters are
    # collectives, which every rank must run
    first = torch.tensor(r == 0, device=x.device)
    xm, z = torch.chunk(x @ w["w_up"], 2, dim=-1)        # (b,s,di) each
    pad, tails = conv0, None
    if K > 1:
        tails = gather_seq(xm[:, s - (K - 1):])          # (b, m*(K-1), di)
        prev = (r - 1) % m
        pad = torch.where(
            first, xm.new_zeros(()) if conv0 is None else conv0.to(xm.dtype),
            tails[:, prev * (K - 1):(prev + 1) * (K - 1)])
    xc, q, k, v, i_raw, logf, _ = _mlstm_inputs(w, xm, H, pad)

    F_loc = torch.cumsum(logf, dim=1)                    # (b,s,H)
    cum = torch.cumsum(gather_seq(F_loc[:, -1:]), dim=1)   # (b,m,H)
    F_own = F_loc + torch.where(first, 0.0, cum[:, (r - 1) % m][:, None])
    kv = gather_seq(torch.cat([k, v], dim=-1)).float()   # (b,S,H,2dk)
    gates = gather_seq(torch.stack([F_own, i_raw], dim=-1))
    k32, v32 = kv.chunk(2, dim=-1)
    h = _mlstm_rows(r * s, F_own, q.float(), gates[..., 0], gates[..., 1],
                    k32, v32)
    y = _mlstm_out(w, h, xc, z, x.dtype)
    if mode != "prefill":
        return y, None
    wl = cum[:, -1:] - F_own + i_raw                     # (b,s,H)
    ms = model_max(torch.amax(wl, dim=1))                # (b,H)
    wexp = torch.exp(wl - ms[:, None, :])
    kl, vl = k.float(), v.float()
    dk = kl.shape[-1]
    acc = model_sum(torch.cat([
        torch.einsum("bsn,bsnk,bsnv->bnkv", wexp, kl, vl),
        torch.einsum("bsn,bsnk->bnk", wexp, kl)[..., None]], dim=-1),
        sum_grads=False)
    conv = (tails[:, (m - 1) * (K - 1):] if tails is not None
            else xm.new_zeros((b, 0, xm.shape[-1])))
    return y, {"C": acc[..., :dk], "n": acc[..., dk], "m": ms,
               "conv": conv}


# ===========================================================================
# sLSTM (xLSTM) -- scalar memory, sequential recurrence
# ===========================================================================
SLSTM_GATES = ("z", "i", "f", "o")
#: the sLSTM's recurrent state (c, n, m, h) in its cache
SLSTM_STATE = ("sc", "sn", "sm", "sh")


def slstm_specs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H = cfg.num_heads
    f = int(cfg.slstm_proj_factor * d)
    sp = {}
    for g in SLSTM_GATES:
        sp[f"w_{g}"] = ParamSpec((d, d), ("embed", "mlp"))
        sp[f"r_{g}"] = _block_diag_spec(H, d)
        sp[f"b_{g}"] = ParamSpec((d,), ("mlp",), "zeros")
    sp["gn_scale"] = ParamSpec((H, d // H), ("heads", "head_dim"), "zeros")
    sp["ffn"] = {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }
    return sp


def slstm_init_cache(cfg: ModelConfig, batch: int, device: torch.device
                     ) -> Dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "sc": torch.zeros((batch, d), **f32),
        "sn": torch.full((batch, d), 1e-6, **f32),
        "sm": torch.full((batch, d), -1e30, **f32),
        "sh": torch.zeros((batch, d), **f32),
    }


def _slstm_cell(params, x_t: Dict[str, torch.Tensor], state, cfg: ModelConfig):
    """x_t: (B,d) pre-projected inputs per gate; state: (c,n,m,h)."""
    c, n, m, h = state
    H = cfg.num_heads
    hd = h.float()

    def gate(name):
        rh = _block_diag_apply(params[f"r_{name}"], hd, H)
        return x_t[name] + rh + params[f"b_{name}"].float()

    z = torch.tanh(gate("z"))
    i_raw = gate("i")
    f_raw = gate("f")
    o = torch.sigmoid(gate("o"))
    logf = _log_sigmoid(f_raw)
    m1 = torch.maximum(logf + m, i_raw)
    i1 = torch.exp(i_raw - m1)
    f1 = torch.exp(logf + m - m1)
    c1 = f1 * c + i1 * z
    n1 = f1 * n + i1
    h1 = o * c1 / torch.clamp(n1, min=1e-6)
    return (c1, n1, m1, h1)


def _slstm_scan(params, xg: Dict[str, torch.Tensor], state, cfg: ModelConfig):
    """The reference's lax.scan over S (decode: S == 1): every step's h
    as (B,S,d), and the last state."""
    steps = []
    for t in range(xg["z"].shape[1]):
        state = _slstm_cell(params, {g: xg[g][:, t] for g in xg}, state, cfg)
        steps.append(state[3])
    return torch.stack(steps, dim=1), state


def _slstm_scan_local(params, xg: Dict[str, torch.Tensor],
                      cache: Optional[Dict], cfg: ModelConfig):
    """:func:`_slstm_scan` of DTensors on the rank's shards: the batch over
    the batch axes and all else whole (a head count need not divide
    "model"), the recurrent weights whole, so that no step of the loop
    dispatches a DTensor op.  One redistribution each way."""
    B, S, d = xg["z"].shape
    spec = batch_spec((B, S, d))
    local = {g: to_local(v, spec) for g, v in xg.items()}
    weights = {k: to_local(params[k], (None,) * params[k].ndim,
                           partial_grad=batch_axes())
               for g in SLSTM_GATES for k in (f"r_{g}", f"b_{g}")}
    if cache is not None:
        state = tuple(to_local(cache[k], batch_spec(cache[k].shape))
                      for k in SLSTM_STATE)
    else:
        b = local["z"].shape[0]
        state = tuple(slstm_init_cache(cfg, b, local["z"].device).values())
    hs, state = _slstm_scan(weights, local, state, cfg)
    return (from_local(hs, (B, S, d), spec),
            tuple(from_local(t, (B, d), batch_spec((B, d))) for t in state))


def slstm_apply(params, x: torch.Tensor, cfg: ModelConfig, *, mode: str,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, S, d = x.shape
    H = cfg.num_heads
    # the input contributions of every gate, for all of S at once (the
    # sequence gathered: torch 2.11 refuses the products' flatten of a
    # split one)
    x = gather_dim(x, 1)
    xg = {g: (x @ cast_weight(params[f"w_{g}"], x.dtype, ("embed", "mlp")))
          .float() for g in SLSTM_GATES}

    if mode not in ("train", "prefill", "decode"):
        raise ValueError(mode)
    if on_mesh(x):
        hs, state = _slstm_scan_local(params, xg, cache, cfg)
    else:
        state = (tuple(cache[k] for k in SLSTM_STATE) if cache is not None
                 else tuple(slstm_init_cache(cfg, B, x.device).values()))
        hs, state = _slstm_scan(params, xg, state, cfg)
    new_cache = None
    if mode != "train":
        new_cache = dict(zip(SLSTM_STATE, state))

    y = _groupnorm_heads(hs.reshape(B, -1, H, d // H),
                         params["gn_scale"]).reshape(B, -1, d).to(x.dtype)
    # the gated FFN after the sLSTM (proj factor 4/3)
    act = activation(cfg.act)
    f = params["ffn"]
    g = y @ cast_weight(f["wi_gate"], x.dtype, ("embed", "mlp"))
    u = y @ cast_weight(f["wi_up"], x.dtype, ("embed", "mlp"))
    y = (act(g) * u) @ cast_weight(f["wo"], x.dtype, ("mlp", "embed"))
    return y, new_cache
