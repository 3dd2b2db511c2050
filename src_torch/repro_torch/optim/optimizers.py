"""Optimizers (port of ``repro/optim/optimizers.py``): the reference's
formulas, not ``torch.optim``.

    opt = make_optimizer(train_cfg)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = tree_map(lambda p, u: p + u, params, updates)

Params, grads and states are trees (:mod:`repro_torch.utils.pytree`);
every state is shaped like the params (``AdamState(mu, nu)``,
``AdafactorState(vr, vc)``).  Each update keeps the reference's arithmetic
in the reference's order: fp32 moments, bias corrections ``1 - b ** t``
with ``t = step + 1`` in fp32, updates cast to the param dtype.  Updates
run under ``torch.no_grad``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils.pytree import tree_global_norm, tree_map


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Any]   # (grads, state, params, step) -> (updates, state)
    name: str = "opt"


def _unzip(like, tree, n: int):
    """A tree of n-tuples (shaped like ``like``) as n trees."""
    return tuple(tree_map(lambda _, t: t[i], like, tree) for i in range(n))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = tree_global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# SGD / momentum
# ---------------------------------------------------------------------------
def sgd(lr_fn: Callable) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        updates = tree_map(lambda g: (-lr * g.float()).to(g.dtype), grads)
        return updates, state

    return Optimizer(init, update, "sgd")


def momentum(lr_fn: Callable, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        new_m = tree_map(lambda m, g: beta * m + g.float(), state, grads)
        updates = tree_map(lambda m, g: (-lr * m).to(g.dtype), new_m, grads)
        return updates, new_m

    return Optimizer(init, update, "momentum")


# ---------------------------------------------------------------------------
# Adam / AdamW
# ---------------------------------------------------------------------------
class AdamState(NamedTuple):
    mu: Any
    nu: Any


def adam(lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0) -> Optimizer:
    return adamw(lr_fn, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                      device=p.device)
        return AdamState(mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = step.float() + 1.0
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / bc1
            vhat = v / bc2
            u = -lr * (mhat / (torch.sqrt(vhat) + eps)
                       + weight_decay * p.float())
            return u.to(p.dtype), m, v

        out = tree_map(upd, grads, state.mu, state.nu, params)
        updates, mu, nu = _unzip(grads, out, 3)
        return updates, AdamState(mu=mu, nu=nu)

    return Optimizer(init, update, "adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment -- the memory-lean option)
# ---------------------------------------------------------------------------
class AdafactorState(NamedTuple):
    vr: Any   # row statistics (or full v for <2D tensors)
    vc: Any   # col statistics (or () placeholder)


def adafactor(lr_fn, eps=1e-30, clip_threshold=1.0, weight_decay=0.0) -> Optimizer:
    def init(params):
        def rows(p):
            if p.dim() < 2:
                return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            return torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)

        def cols(p):
            if p.dim() < 2:
                return torch.zeros((), dtype=torch.float32, device=p.device)
            return torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                               device=p.device)

        return AdafactorState(vr=tree_map(rows, params),
                              vc=tree_map(cols, params))

    @torch.no_grad()
    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = step.float() + 1.0
        beta2 = 1.0 - t ** (-0.8)

        def upd(g, vr, vc, p):
            g32 = g.float()
            sq = torch.square(g32) + eps
            if p.dim() < 2:
                vr = beta2 * vr + (1 - beta2) * sq
                u = g32 / (torch.sqrt(vr) + eps)
            else:
                vr = beta2 * vr + (1 - beta2) * torch.mean(sq, dim=-1)
                vc = beta2 * vc + (1 - beta2) * torch.mean(sq, dim=-2)
                rfac = torch.sqrt(vr / (torch.mean(vr, dim=-1, keepdim=True)
                                        + eps))
                u = g32 / (rfac[..., None] * torch.sqrt(vc)[..., None, :] + eps)
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr * (u + weight_decay * p.float())
            return u.to(p.dtype), vr, vc

        out = tree_map(upd, grads, state.vr, state.vc, params)
        updates, vr, vc = _unzip(grads, out, 3)
        return updates, AdafactorState(vr, vc)

    return Optimizer(init, update, "adafactor")


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------
def make_optimizer(train_cfg, lr_fn: Optional[Callable] = None) -> Optimizer:
    from repro_torch.optim.schedules import linear_warmup_cosine

    lr_fn = lr_fn or linear_warmup_cosine(
        train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    kind = train_cfg.optimizer
    if kind == "sgd":
        return sgd(lr_fn)
    if kind == "momentum":
        return momentum(lr_fn, beta=train_cfg.beta1)
    if kind == "adam":
        return adamw(lr_fn, b1=train_cfg.beta1, b2=train_cfg.beta2,
                     eps=train_cfg.eps, weight_decay=0.0)
    if kind == "adamw":
        return adamw(lr_fn, b1=train_cfg.beta1, b2=train_cfg.beta2,
                     eps=train_cfg.eps, weight_decay=train_cfg.weight_decay)
    if kind == "adafactor":
        return adafactor(lr_fn, weight_decay=train_cfg.weight_decay)
    raise ValueError(f"unknown optimizer {kind!r}")
