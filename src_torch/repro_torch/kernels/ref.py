"""Plain-torch oracles over whole matrices (port of ``repro/kernels/ref.py``,
the attention oracle only; the others come with their kernels)."""
from __future__ import annotations

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """q: (B,S,H,hd) pre-scaled; k/v: (B,S,KV,hd) -> (B,S,H,hd_v).

    The whole (S, S) score matrix, in the reference's precision: scores in
    the input dtype, then fp32, softmax weights cast back to v's dtype
    before the value product.  A row whose every key is masked gets the
    mean of v (a uniform softmax), unlike the kernel, which gives 0."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    qg = q.reshape(B, S, KV, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", w.to(v.dtype), v)
    return ctx.reshape(B, S, H, v.shape[-1])
