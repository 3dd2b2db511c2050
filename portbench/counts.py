"""The yardstick's arithmetic: the card's published peaks, a train step's
model FLOPs and a ``scatter_wsum`` launch's bytes.

Frozen copies, extended where said, of ``chip_smoke.py``'s
``band_pairs``, ``train_model_flops`` and ``scatter_bound``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: published dense peaks by the name ``torch.cuda.get_device_name`` gives
#: (NVIDIA's data sheet, SXM part, at its 700 W limit): bf16 on the tensor
#: cores, HBM bytes/s, fp64 outside the tensor cores
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12,
                              "fp64_flops": 34e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    """The peak ``what`` of the card named ``kind``; None for a card the
    table does not hold."""
    return PEAKS.get(kind, {}).get(what)


def band_pairs(S: int, causal: bool, window: int) -> int:
    """(q, k) pairs the masks leave visible over one (batch, head)."""
    qp = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    hi = qp if causal else np.full_like(qp, S - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def train_model_flops(conf: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one train step, no recompute: 6 x the matmul
    parameters a token meets x tokens, plus 3 x the forward's attention
    products (4 x head_dim FLOPs per visible causal pair).

    The matmul parameters are the attention projections, the MLP, or the
    router and the k of E experts a token is routed to (never the slots
    the capacity pads), and the output head over the vocabulary once,
    tied to the embedding or not; the embedding lookup is no matmul."""
    d, H = int(conf["hidden_size"]), int(conf["num_attention_heads"])
    KV = int(conf["num_key_value_heads"])
    hd = int(conf.get("head_dim") or d // H)
    L, f, V = (int(conf[k]) for k in ("num_hidden_layers",
                                      "intermediate_size", "vocab_size"))
    proj = 2 * d * H * hd + 2 * d * KV * hd
    E = int(conf.get("num_local_experts", 0))
    if E:
        mlp = int(conf["num_experts_per_tok"]) * 3 * d * f + d * E
    else:
        mlp = 3 * d * f
    n = L * (proj + mlp) + d * V
    pairs = band_pairs(seq, True, int(conf.get("sliding_window") or 0))
    attn = 4 * hd * H * batch * pairs
    return 6.0 * n * batch * seq + 3.0 * attn * L


def scatter_bytes(nnz: int, q8: bool = True, nscales: int = 0) -> int:
    """Bytes one ``scatter_wsum`` launch over ``nnz`` COO coordinates
    needs: each value (1 B int8 or 4 B fp32), its 8 B index and its
    scales read once, and the fp64 accumulator read and written at its
    destination (16 B)."""
    return nnz * ((1 if q8 else 4) + 8 + 16) + nscales * 4


def scatter_bound_s(nnz: int, kind: str, q8: bool = True,
                    nscales: int = 0) -> Optional[float]:
    """The least seconds such a launch can take on card ``kind``: its
    bytes against HBM, or a multiply and an add a coordinate against the
    fp64 rate, whichever is longer."""
    hbm, fp64 = peak(kind, "hbm_bytes"), peak(kind, "fp64_flops")
    if hbm is None or fp64 is None:
        return None
    return max(scatter_bytes(nnz, q8, nscales) / hbm, 2 * nnz / fp64)
