"""Plain fp32 reference of a decoder-only trunk's train step: the dense
(H2O-Danube, Mistral style) and the GShard MoE (Granite-3.0-MoE) blocks,
the next-token cross entropy with the router losses, global-norm clipping
and AdamW.

It reads the configuration file (Hugging Face key names) and nothing of
the program.  The equations are the ones the program's configuration runs,
each a plain torch op in fp32 with TF32 off: RMSNorm with a ``1 + scale``
gain, rotary embeddings on the two halves of a head, grouped-query
attention with a causal (and sliding-window) mask and an fp32 softmax, a
SwiGLU MLP, or a router whose top-k tokens go to experts under a per-group
capacity (overflow dropped, GShard), an untied or tied head whose padded
vocabulary columns are masked.  Each layer is recomputed in the backward
pass (``torch.utils.checkpoint``), which changes memory, not values.

``quant`` rounds to a lower precision every tensor the program holds in
its compute precision: each product's operands, the embedded tokens and
the residual stream after each block (the control: fp8 e4m3 with one scale
a tensor, :func:`fp8`), so that the same code measures what a lower
precision would read.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.utils.checkpoint

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


# ---------------------------------------------------------------------------
# sizes and parameter layout
# ---------------------------------------------------------------------------
def dims(conf: Dict) -> Dict:
    """The sizes the reference uses, from the configuration file."""
    d = int(conf["hidden_size"])
    H = int(conf["num_attention_heads"])
    V = int(conf["vocab_size"])
    out = dict(
        L=int(conf["num_hidden_layers"]), d=d, H=H,
        KV=int(conf["num_key_value_heads"]),
        hd=int(conf.get("head_dim") or d // H),
        f=int(conf["intermediate_size"]), V=V,
        Vp=-(-V // 256) * 256,
        window=int(conf.get("sliding_window") or 0),
        theta=float(conf.get("rope_theta", 10000.0)),
        eps=float(conf["rms_norm_eps"]),
        tied=bool(conf.get("tie_word_embeddings", False)),
        E=int(conf.get("num_local_experts", 0)),
        k=int(conf.get("num_experts_per_tok", 0)),
        cf=float(conf.get("expert_capacity_factor", 0.0)),
        aux_coef=float(conf.get("router_aux_loss_coef", 0.0)),
        z_coef=float(conf.get("router_z_loss_coef", 0.0)),
        attn_mult=float(conf.get("attention_multiplier",
                                 1.0 / math.sqrt(int(conf.get("head_dim")
                                                     or d // H)))),
        emb_mult=float(conf.get("embedding_multiplier", 1.0)),
        res_mult=float(conf.get("residual_multiplier", 1.0)),
        logit_div=float(conf.get("logits_scaling", 1.0)),
    )
    return out


def param_layout(conf: Dict) -> Dict:
    """``{path: (shape, init, fan_in)}`` of every parameter, by the
    program's keys (layers stacked on a leading axis under ``scan_0``);
    ``init`` is ``"zeros"`` (a norm's gain) or ``"normal"`` with standard
    deviation ``1 / sqrt(fan_in)`` (0.02 for the embedding and the
    router)."""
    m = dims(conf)
    L, d, H, KV, hd, f, Vp = (m[k] for k in ("L", "d", "H", "KV", "hd",
                                              "f", "Vp"))
    out = {"embed": ((Vp, d), "normal", 2500.0),
           "final_norm/scale": ((d,), "zeros", 0.0)}
    if not m["tied"]:
        out["lm_head"] = ((d, Vp), "normal", float(d))
    out.update({
        "scan_0/norm1/scale": ((L, d), "zeros", 0.0),
        "scan_0/mix/wq": ((L, d, H, hd), "normal", float(d)),
        "scan_0/mix/wk": ((L, d, KV, hd), "normal", float(d)),
        "scan_0/mix/wv": ((L, d, KV, hd), "normal", float(d)),
        "scan_0/mix/wo": ((L, H, hd, d), "normal", float(H * hd)),
        "scan_0/norm2/scale": ((L, d), "zeros", 0.0),
    })
    if m["E"]:
        E = m["E"]
        out.update({
            "scan_0/mlp/router": ((L, d, E), "normal", 2500.0),
            "scan_0/mlp/wi_gate": ((L, E, d, f), "normal", float(d)),
            "scan_0/mlp/wi_up": ((L, E, d, f), "normal", float(d)),
            "scan_0/mlp/wo": ((L, E, f, d), "normal", float(f)),
        })
    else:
        out.update({
            "scan_0/mlp/wi_gate": ((L, d, f), "normal", float(d)),
            "scan_0/mlp/wi_up": ((L, d, f), "normal", float(d)),
            "scan_0/mlp/wo": ((L, f, d), "normal", float(f)),
        })
    return out


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    out: Dict = {}
    for path, x in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`nest`."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, p))
        else:
            out[p] = v
    return out


# ---------------------------------------------------------------------------
# the lower-precision control
# ---------------------------------------------------------------------------
def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 with one scale for the tensor (its largest
    magnitude at 448), back in fp32; the gradient passes straight
    through."""
    amax = x.detach().abs().amax()
    s = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    q = (x.detach() * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (q - x).detach()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _q(quant: Quant, x):
    return quant(x) if quant is not None else x


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def _rope(x, theta):
    """x: (B, S, N, hd); each half of a head rotated by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p, h, m, quant: Quant):
    B, S, d = h.shape
    H, KV, hd = m["H"], m["KV"], m["hd"]
    q = (_q(quant, h) @ _q(quant, p["wq"].reshape(d, H * hd))
         ).view(B, S, H, hd)
    k = (_q(quant, h) @ _q(quant, p["wk"].reshape(d, KV * hd))
         ).view(B, S, KV, hd)
    v = (_q(quant, h) @ _q(quant, p["wv"].reshape(d, KV * hd))
         ).view(B, S, KV, hd)
    q = _rope(q, m["theta"]) * m["attn_mult"]
    k = _rope(k, m["theta"])
    g = H // KV
    # head j reads kv head j // g
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scores = torch.einsum("bqhc,bshc->bhqs", _q(quant, q), _q(quant, k))
    qpos = torch.arange(S, device=h.device)[:, None]
    kpos = torch.arange(S, device=h.device)[None, :]
    mask = kpos <= qpos
    if m["window"]:
        mask = mask & (kpos > qpos - m["window"])
    scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqs,bshc->bqhc", _q(quant, w), _q(quant, v))
    return _q(quant, ctx.reshape(B, S, H * hd)) \
        @ _q(quant, p["wo"].reshape(H * hd, d))


def _mlp(p, h, quant: Quant):
    g = _q(quant, h) @ _q(quant, p["wi_gate"])
    u = _q(quant, h) @ _q(quant, p["wi_up"])
    return _q(quant, torch.nn.functional.silu(g) * u) @ _q(quant, p["wo"])


def groups(T: int, E: int, k: int, cf: float):
    """(G, Tg, C): the token groups and the per-group capacity of an
    expert, by the program's rule: the most groups that divide the tokens
    while a group keeps at least ~16 slots an expert."""
    cf = cf if cf > 0 else 1.25
    min_tg = max(int(16 * E / max(k * max(cf, 1.0), 1.0)), 1)
    g_max = min(max(T // min_tg, 1), 4096)
    G = next(g for g in range(g_max, 0, -1) if T % g == 0)
    Tg = T // G
    return G, Tg, max(int(Tg * k / E * cf), 1)


def _moe(p, h, m, quant: Quant):
    """GShard top-k routing with a per-group capacity; returns (y, router
    loss).  Choice r of every token is placed before choice r + 1 of any,
    tokens in order; a choice past its expert's capacity is dropped."""
    B, S, d = h.shape
    E, k = m["E"], m["k"]
    T = B * S
    G, Tg, C = groups(T, E, k, m["cf"])
    logits = h.reshape(T, d) @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    pg = probs.reshape(G, Tg, E)
    vals, idx = torch.sort(pg, dim=-1, descending=True, stable=True)
    gate, eidx = vals[..., :k], idx[..., :k]
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = torch.nn.functional.one_hot(eidx, E)            # (G,Tg,k,E)
    density = probs.mean(0)
    usage = onehot.sum(2).reshape(T, E).float().mean(0)
    aux = E * torch.sum(density * usage) * m["aux_coef"]
    z = m["z_coef"] * torch.logsumexp(logits, dim=-1).square().mean()
    # slots: choice rank by choice rank, tokens in order within a group
    oh = onehot.permute(0, 2, 1, 3).reshape(G, k * Tg, E)     # rank-major
    pos = (torch.cumsum(oh, dim=1) - oh)                     # slots taken
    slot = (pos * oh).sum(-1).reshape(G, k, Tg).permute(0, 2, 1)  # (G,Tg,k)
    keep = slot < C
    slot_oh = torch.nn.functional.one_hot(slot.clamp(max=C - 1), C) \
        * keep[..., None]                                    # (G,Tg,k,C)
    dispatch = torch.einsum("gtke,gtkc->gtec", onehot.float(),
                            slot_oh.float())
    combine = torch.einsum("gtke,gtkc->gtec", onehot.float() * gate[..., None],
                           slot_oh.float())
    xg = h.reshape(G, Tg, d)
    xe = torch.einsum("gtec,gtd->gecd", _q(quant, dispatch), _q(quant, xg))
    a = torch.einsum("gecd,edf->gecf", _q(quant, xe), _q(quant, p["wi_gate"]))
    u = torch.einsum("gecd,edf->gecf", _q(quant, xe), _q(quant, p["wi_up"]))
    o = torch.einsum("gecf,efd->gecd",
                     _q(quant, torch.nn.functional.silu(a) * u),
                     _q(quant, p["wo"]))
    y = torch.einsum("gtec,gecd->gtd", _q(quant, combine), _q(quant, o))
    return y.reshape(B, S, d), aux + z


def _layer(p, x, m, quant: Quant):
    h = _rmsnorm(x, p["norm1/scale"], m["eps"])
    x = _q(quant, x + m["res_mult"] * _attention(
        {k[4:]: v for k, v in p.items() if k.startswith("mix/")}, h, m,
        quant))
    h = _rmsnorm(x, p["norm2/scale"], m["eps"])
    mp = {k[4:]: v for k, v in p.items() if k.startswith("mlp/")}
    if m["E"]:
        y, aux = _moe(mp, h, m, quant)
    else:
        y, aux = _mlp(mp, h, quant), x.new_zeros(())
    return _q(quant, x + m["res_mult"] * y), aux


def loss(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, m: Dict, quant: Quant = None) -> torch.Tensor:
    """Mean next-token cross entropy over the batch, plus every layer's
    router losses."""
    x = _q(quant, params["embed"][tokens.long()] * m["emb_mult"])
    layers = {k[7:]: v.unbind(0) for k, v in params.items()
              if k.startswith("scan_0/")}
    aux = x.new_zeros(())

    def one(i, x):
        return _layer({k: v[i] for k, v in layers.items()}, x, m, quant)

    for i in range(m["L"]):
        x, a = torch.utils.checkpoint.checkpoint(one, i, x,
                                                 use_reentrant=False)
        aux = aux + a
    x = _rmsnorm(x, params["final_norm/scale"], m["eps"])
    head = params["embed"].T if m["tied"] else params["lm_head"]
    logits = (_q(quant, x) @ _q(quant, head)) / m["logit_div"]
    if m["Vp"] != m["V"]:
        col = torch.arange(m["Vp"], device=x.device)
        logits = logits.masked_fill(col >= m["V"], -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean() + aux


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def lr_at(step: int, hp: Dict) -> float:
    """Linear warm-up to ``learning_rate`` over ``warmup_steps``, then a
    cosine to a tenth of it at ``total_steps``."""
    lr, warm, total = (float(hp["learning_rate"]), int(hp["warmup_steps"]),
                       int(hp["total_steps"]))
    if step < warm:
        return lr * (step + 1) / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)))


def train(conf: Dict, params: Dict[str, torch.Tensor],
          batches: Sequence[Dict], hp: Dict, quant: Quant = None) -> Dict:
    """``len(batches)`` AdamW steps from ``params`` (fp32, modified in
    place), each batch split into ``hp["microbatches"]`` equal parts whose
    gradients are averaged, clipped to the global norm ``grad_clip``.

    Returns each step's loss, the first step's clipped gradient norm by
    leaf, and the norm by leaf of every parameter's change over the steps.
    TF32 is off throughout."""
    m = dims(conf)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(m, params, batches, hp, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _train(m, params, batches, hp, quant) -> Dict:
    names = list(params)
    dev = params[names[0]].device
    start = {n: params[n].detach().clone() for n in names}
    mu = {n: torch.zeros_like(params[n]) for n in names}
    nu = {n: torch.zeros_like(params[n]) for n in names}
    b1, b2, eps = float(hp["beta1"]), float(hp["beta2"]), float(hp["eps"])
    wd, clip = float(hp["weight_decay"]), float(hp["grad_clip"])
    M = int(hp["microbatches"])
    losses: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, batch in enumerate(batches):
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        b = tokens.shape[0] // M
        grads = {n: torch.zeros_like(params[n]) for n in names}
        total = torch.zeros((), device=dev)
        for i in range(M):
            leaves = {n: params[n].detach().requires_grad_(True)
                      for n in names}
            with torch.enable_grad():
                lv = loss(leaves, tokens[i * b:(i + 1) * b],
                          labels[i * b:(i + 1) * b], m, quant)
                gs = torch.autograd.grad(lv, [leaves[n] for n in names],
                                         allow_unused=True)
            for n, g in zip(names, gs):
                if g is not None:
                    grads[n] += g
            total += lv.detach()
            del leaves, gs, lv
        losses.append(float(total / M))
        with torch.no_grad():
            for n in names:
                grads[n] /= M
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            scale = torch.clamp(clip / (norm + 1e-9), max=1.0) if clip > 0 \
                else torch.ones((), device=dev)
            lr = lr_at(step, hp)
            t = step + 1
            for n in names:
                g = grads[n] * scale
                if step == 0:
                    first_grad[n] = float(g.norm())
                mu[n].mul_(b1).add_((1 - b1) * g)
                nu[n].mul_(b2).add_((1 - b2) * g.square())
                mhat = mu[n] / (1 - b1 ** t)
                vhat = nu[n] / (1 - b2 ** t)
                params[n] += -lr * (mhat / (vhat.sqrt() + eps)
                                    + wd * params[n])
            del grads
    with torch.no_grad():
        change = {n: float((params[n] - start[n]).norm()) for n in names}
    return {"losses": losses, "first_grad": first_grad, "change": change}
