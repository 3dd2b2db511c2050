"""Plain-torch oracles over whole matrices (port of ``repro/kernels/ref.py``:
the attention, SecAgg and RG-LRU scan oracles)."""
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


def secagg_mask_ref(x: torch.Tensor, masks: torch.Tensor, weight: float,
                    quant_bits: int = 16) -> torch.Tensor:
    """x: (N,) float; masks: (P, N) int32 (signed per peer already applied).

    out = int32 wraparound(sat(round(x * weight * 2^bits)) + sum_p
    masks[p]), in the reference's precision: the product and the round in
    fp32, the clip to [-2^31, 2^31 - 1] and the conversion saturating
    (NaN to 0), the mask sum mod 2^32."""
    q = torch.round(x.to(torch.float32)
                    * torch.tensor(weight, dtype=torch.float32)
                    * float(1 << quant_bits))
    q = torch.nan_to_num(q.to(torch.float64), nan=0.0, posinf=2.0 ** 31 - 1,
                         neginf=-(2.0 ** 31))
    q = q.clamp(-(2.0 ** 31), 2.0 ** 31 - 1).to(torch.int64)
    total = masks.to(torch.int64).sum(0) if masks.numel() else 0
    return ((q + total + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """h_t = a_t * h_{t-1} + b_t.  a, b: (B, S, W) fp32; h0: (B, W).

    Returns ``(ys, h_S)``: every step's state (B, S, W) and the last one
    (B, W), one step at a time in fp32 with the multiply and the add
    rounded apart, the arithmetic of ``kernels/rglru_scan.py``'s
    ``rglru_scan_plain``."""
    ys = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = h0.to(torch.float32)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys[:, t] = h
    return ys, h
