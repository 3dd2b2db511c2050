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
it outside any Pallas kernel too; :func:`decode_attention_split` is its
flash-decoding form over a cache whose slots are split over a mesh axis
("model" in ``decode_32k``, "data" in ``long_500k``).
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels.ref import NEG_INF
from repro_torch.sharding import (batch_spec, constrain_scores, from_local,
                                  gather_seq, model_axis_size, model_dim,
                                  model_max, model_rank, model_sharded,
                                  model_sum, scatter_seq, seq_to_heads,
                                  to_local)

IMPLS = ("eager", "flash")


def chunk_size(S: int, target: int = 1024) -> int:
    """The reference's query chunk: the largest divisor of S up to
    ``target`` (the eager attention's and the mLSTM's parallel form's)."""
    for c in range(min(target, S), 0, -1):
        if S % c == 0:
            return c
    return S


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int = 0, impl: str = "eager",
                     causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """q: (B,S,H,hd) (pre-scaled), k/v: (B,S,KV,hd); returns (B,S,H,hd_v).

    The eager path processes queries in chunks so the score matrix
    materializes as (B,KV,g,chunk,S) instead of (B,KV,g,S,S).  On
    DTensors under a "model" axis it runs on the rank's shards in the
    reference's layout (its ``constrain_scores``): the heads split over
    the axis (:func:`_head_local`), else the keys (:func:`_key_split`)."""
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
    expand = msz > 1 and g > 1 and H % msz == 0 and KV % msz != 0
    if model_sharded(q):
        if KV % msz == 0 or expand:
            return _head_local(q, k, v, g if expand else 1, window=window,
                               causal=causal, chunk=chunk)
        if S % msz == 0:
            return _key_split(q, k, v, window=window, causal=causal,
                              chunk=chunk)
    if expand:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    return _attend(q, k, v, window=window, causal=causal, chunk=chunk,
                   constrain=constrain_scores)


def _mask(C: int, start: int, kpos: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(C, Sk): which keys at positions ``kpos`` (1, Sk) the queries
    ``start..start+C`` see."""
    qpos = start + torch.arange(C, device=kpos.device)[:, None]
    mask = torch.ones((C, kpos.shape[-1]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _attend(q, k, v, *, window: int, causal: bool, chunk: int,
            constrain=None) -> torch.Tensor:
    """The chunked einsum + masked softmax over whole sequences (on one
    card, or on a rank's heads); ``constrain`` pins the scores' layout."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    C = chunk_size(S, chunk)
    kpos = torch.arange(S, device=q.device)[None, :]
    pin = constrain or (lambda x: x)
    ctx = []
    with obs.span("attention.core"):
        # the reference's preferred_element_type=float32: fp32 products,
        # no rounding of the scores to the input dtype
        k32 = k.float()
        for start in range(0, S, C):
            q_chunk = qg[:, start:start + C].float()
            scores = pin(torch.einsum("bqkgh,bskh->bkgqs", q_chunk, k32))
            mask = _mask(C, start, kpos, causal, window)
            scores = pin(torch.where(mask, scores, NEG_INF))
            w = torch.softmax(scores, dim=-1).to(q.dtype)
            del scores
            ctx.append(torch.einsum("bkgqs,bskh->bqkgh", w, v))
        ctx = torch.cat(ctx, dim=1)
    return ctx.reshape(B, S, H, v.shape[-1])


def _heads(x, g: int) -> torch.Tensor:
    """The rank's shard of (B, S, N, hd) DTensor ``x`` with its heads
    (each repeated ``g`` times first) split over "model" and the batch over
    the batch axes.  A sequence split over "model" (the residual stream's)
    goes over to the heads by one all-to-all; heads already split stay."""
    if model_dim(x) == 1:
        t = to_local(x, batch_spec(x.shape, 1))
        if g > 1:
            t = torch.repeat_interleave(t, g, dim=2)
        return seq_to_heads(t)
    if g > 1:
        x = torch.repeat_interleave(x, g, dim=2)
    return to_local(x, batch_spec(x.shape, 2))


def _head_local(q, k, v, g: int, *, window: int, causal: bool,
                chunk: int):
    """The reference's first layout under a "model" axis: each rank
    attends with its own heads (the kv heads after a GQA -> MHA expansion
    by ``g``), with no collective on the scores.  ctx comes back split
    over the heads, as ``wo``'s product takes it."""
    B, S, H, _ = q.shape
    ctx = _attend(_heads(q, 1), _heads(k, g), _heads(v, g), window=window,
                  causal=causal, chunk=chunk)
    return from_local(ctx, (B, S, H, v.shape[-1]), batch_spec(q.shape, 2))


def _key_split(q, k, v, *, window: int, causal: bool, chunk: int):
    """The reference's second layout, where the heads do not split over
    "model": the keys do (flash-decoding style).  Every rank holds every
    query, scores its own keys, and the softmax's row max and row sum are
    reduced over "model"; no score-shaped tensor is gathered.  The partial
    value products are reduce-scattered over the sequence: ctx comes back
    in the residual's layout (sequence over "model"), each rank's rows
    whole over the heads, which ``wo``'s product takes on local shards
    (``attention._unproject``; a split of the flattened heads could not
    be viewed back into heads that do not divide the axis)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    ql = gather_seq(to_local(q, batch_spec(q.shape, 1)))
    kl = to_local(k, batch_spec(k.shape, 1))
    vl = to_local(v, batch_spec(v.shape, 1))
    b, s = kl.shape[0], kl.shape[1]
    qg = ql.reshape(b, S, KV, H // KV, hd)
    C = chunk_size(S, chunk)
    kpos = model_rank() * s + torch.arange(s, device=ql.device)[None, :]
    ctx = []
    with obs.span("attention.core"):
        k32 = kl.float()
        for start in range(0, S, C):
            q_chunk = qg[:, start:start + C].float()
            scores = torch.einsum("bqkgh,bskh->bkgqs", q_chunk, k32)
            mask = _mask(C, start, kpos, causal, window)
            scores = torch.where(mask, scores, NEG_INF)
            p = torch.exp(scores - model_max(
                torch.amax(scores, dim=-1, keepdim=True)))
            del scores
            # each rank's weights use the total: their gradients add up
            den = model_sum(torch.sum(p, dim=-1, keepdim=True),
                            sum_grads=True)
            w = (p / den).to(q.dtype)
            del p
            ctx.append(torch.einsum("bkgqs,bskh->bqkgh", w, vl))
        ctx = torch.cat(ctx, dim=1)
    ctx = scatter_seq(ctx)
    return from_local(ctx.reshape(b, s, H, vl.shape[-1]),
                      (B, S, H, v.shape[-1]), batch_spec(q.shape, 1))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, slot_pos: torch.Tensor,
                     query_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """One-token attention against a (possibly rotating) cache.

    q: (B,1,H,hd) pre-scaled; k/v_cache: (B,S,KV,hd); slot_pos: (B,S)
    absolute position held in each slot (-1 = empty); query_pos: (B,).
    """
    scores = _decode_scores(q, k_cache, slot_pos, query_pos, window)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    ctx = torch.einsum("bkgs,bskh->bkgh", w, v_cache)
    return ctx.reshape(q.shape[0], 1, q.shape[2], v_cache.shape[-1])


def _decode_scores(q, k_cache, slot_pos, query_pos, window: int):
    """(B,KV,g,S) fp32 scores of one query against the cache's slots, the
    empty ones, the future ones and those out of the window masked."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q[:, 0].reshape(B, KV, H // KV, hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float())
    valid = (slot_pos >= 0) & (slot_pos <= query_pos[:, None])
    if window:
        valid &= slot_pos > (query_pos[:, None] - window)
    return torch.where(valid[:, None, None, :], scores, NEG_INF)


def split_softmax_combine(scores: torch.Tensor, product,
                          axis: str = "model") -> torch.Tensor:
    """The softmax of the fp32 ``scores`` (..., s) over keys split across
    ``axis`` (the last dim holds this rank's), applied by ``product(p)``
    to the rank's values: the row max through ``model_max``, then the
    unnormalised product and the exp-sum, in fp32, summed over the axis
    in one all-reduce, then the division (flash-decoding's combine).  A
    rank whose keys are all masked adds zeros."""
    p = torch.exp(scores - model_max(torch.amax(scores, dim=-1,
                                                keepdim=True), axis))
    acc = model_sum(torch.cat([product(p), p.sum(-1)[..., None]], dim=-1),
                    sum_grads=False, axis=axis)
    return acc[..., :-1] / acc[..., -1:]


def decode_attention_split(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, *, slot_pos: torch.Tensor,
                           query_pos: torch.Tensor, window: int = 0,
                           axis: str = "model") -> torch.Tensor:
    """:func:`decode_attention` on local tensors, where the cache's slots
    are split over ``axis``: q (B,1,H,hd) the rank's query heads (whole
    over ``axis``), k/v_cache (B,s,KV,hd) the KV heads they read (query
    head j reads KV head j // (H // KV)) and slot_pos (B,s), on the
    rank's own slots.  Each rank scores its slots (fp32) and the softmax
    is combined over the axis (:func:`split_softmax_combine`); no
    cache-sized tensor moves.  Returns (B,1,H,hd_v) for q's heads on
    every rank of the axis, cast to q's dtype."""
    scores = _decode_scores(q, k_cache, slot_pos, query_pos, window)
    v32 = v_cache.float()
    ctx = split_softmax_combine(
        scores, lambda p: torch.einsum("bkgs,bskh->bkgh", p, v32), axis)
    return ctx.to(q.dtype).reshape(q.shape[0], 1, q.shape[2],
                                   v_cache.shape[-1])
