"""Attention contraction implementations (port of
``repro/models/attention_impl.py``).

The port names the two paths after what runs them:

- ``impl="eager"`` is the counterpart of the reference's ``"xla"``: the
  chunked einsum + masked-softmax path in plain torch ops, fp32 scores,
  softmax weights cast to the input dtype before the value product.
- ``impl="flash"`` is the counterpart of ``"pallas"``: the hand-written
  Hopper kernel :func:`repro_torch.kernels.flash_attention.flash_attention`
  (its plain twin on a CPU tensor).

The same ``impl`` selects the RG-LRU recurrence's path
(:mod:`repro_torch.models.recurrent`): ``"flash"`` runs the hand-written
kernel :func:`repro_torch.kernels.rglru_scan.rglru_scan`, ``"eager"`` a
log-depth scan in plain torch ops.  So ``impl="flash"`` selects both hand
kernels of a model's prefill.

Both satisfy the same contract and are cross-checked in the tests and on
the card.  :func:`decode_attention` is plain torch: the reference computes
it outside any Pallas kernel too.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import NEG_INF
from repro_torch.sharding import constrain_scores, model_axis_size

IMPLS = ("eager", "flash")


def _chunk_size(S: int, target: int = 1024) -> int:
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0, impl: str = "eager",
                     causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,hd) (pre-scaled), k/v: (B,S,KV,hd); returns (B,S,H,hd_v).

    The eager path processes queries in chunks so the score matrix
    materializes as (B,KV,g,chunk,S) instead of (B,KV,g,S,S)."""
    if impl == "flash":
        from repro_torch.kernels.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, window=window)
    if impl != "eager":
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    # GQA -> MHA expansion when the q-head count shards over "model" but
    # the kv-head count does not: each model shard then owns its heads'
    # scores, at the cost of replicating the small (B,S,KV,hd) K/V
    msz = model_axis_size()
    if msz > 1 and g > 1 and H % msz == 0 and KV % msz != 0:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
        KV, g = H, 1
    qg = q.reshape(B, S, KV, g, hd)
    C = _chunk_size(S, chunk)
    # the reference's preferred_element_type=float32: fp32 products, no
    # rounding of the scores to the input dtype
    k32 = k.float()
    kpos = torch.arange(S, device=q.device)[None, :]
    ctx = []
    for start in range(0, S, C):
        q_chunk = qg[:, start:start + C].float()
        scores = constrain_scores(
            torch.einsum("bqkgh,bskh->bkgqs", q_chunk, k32))
        qpos = start + torch.arange(C, device=q.device)[:, None]
        mask = torch.ones((C, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        scores = constrain_scores(torch.where(mask, scores, NEG_INF))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        del scores
        ctx.append(torch.einsum("bkgqs,bskh->bqkgh", w, v))
    return torch.cat(ctx, dim=1).reshape(B, S, H, v.shape[-1])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, slot_pos: torch.Tensor,
                     query_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """One-token attention against a (possibly rotating) cache.

    q: (B,1,H,hd) pre-scaled; k/v_cache: (B,S,KV,hd); slot_pos: (B,S)
    absolute position held in each slot (-1 = empty); query_pos: (B,).
    """
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    g = H // KV
    qg = q[:, 0].reshape(B, KV, g, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= query_pos[:, None])
    if window:
        valid &= slot_pos > (query_pos[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgs,bskh->bkgh", w, v_cache)
    return ctx.reshape(B, 1, H, v_cache.shape[-1])
