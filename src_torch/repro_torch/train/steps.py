"""Step functions: loss, train step, eval step, prefill step, decode step
(port of ``repro/train/steps.py``).

PyTorch runs eagerly, so the steps are plain closures (the reference jits
them; the port does not ``torch.compile`` them).  Gradients come from
``torch.autograd``; the serving and eval steps run under
``torch.no_grad``.

:func:`get_train_step` is the federated entry point: a process-wide cache
of train steps keyed by ``(model_cfg, train_cfg, impl, device)``, so N
simulated FL clients with identical configs share ONE step.  Training runs
``impl="eager"`` (the reference trains with ``"xla"``); the JAX package
has no backward kernel, so ``impl="flash"`` raises in training.  The
mesh-sharded step (``make_sharded_train_step``) is ROADMAP queue 1, item
13.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.api import Model
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


#: ``torch.profiler`` span around a train step's clip, update and apply
UPDATE_SPAN = "train_step.update"


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def cross_entropy_loss(logits, labels, z_loss: float = 0.0):
    """Mean next-token CE in fp32 (+ optional z-loss). logits: (B,S,V).

    The gold logit is gathered; the reference contracts with a one-hot
    instead (a gather across its sharded vocab dim would replicate the
    logits).  Both give the same value for finite logits: the pad columns
    hold -1e30, and -1e30 x 0 is -0."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    if z_loss:
        ce = ce + z_loss * torch.mean(torch.square(logz))
    return ce


def make_train_state(model: Model, train_cfg: TrainConfig, seed: int,
                     device: DeviceLike = None) -> TrainState:
    """Random parameters from ``seed``, fresh optimizer state and step 0 on
    ``device`` (None: the card)."""
    dev = resolve_device(device)
    params = model.init(seed, device=dev)
    opt = make_optimizer(train_cfg)
    return TrainState(params, opt.init(params),
                      torch.zeros((), dtype=torch.int32, device=dev))


def _no_flash(impl: str) -> None:
    if impl == "flash":
        raise ValueError(
            "impl='flash' cannot train: the JAX package trains with "
            "impl='xla' (the port's 'eager') and has no backward kernel; "
            "use impl='eager'")


def make_train_step(model: Model, train_cfg: TrainConfig,
                    impl: str = "eager",
                    device: Optional[torch.device] = None):
    """``train_step(state, batch) -> (state, metrics)``.  The batch (numpy
    or tensors) goes to the params' device; with ``device``, the state
    must be on it.  The input state is not modified."""
    _no_flash(impl)
    opt = make_optimizer(train_cfg)
    M = max(train_cfg.microbatches, 1)

    def loss_fn(params, batch):
        logits, _, metrics = model.apply(params, batch, mode="train", impl=impl)
        loss = cross_entropy_loss(logits, batch["labels"], train_cfg.z_loss)
        loss = loss + metrics.get("aux_loss", 0.0)
        return loss, metrics

    def value_and_grad(params, batch):
        flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = loss_fn(tree_unflatten(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        # a leaf the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten(params, grads)

    def grad_fn(params, batch):
        """Grad accumulation over M microbatches: the live activation set
        shrinks ~M x; grads accumulate in fp32."""
        if M == 1:
            return value_and_grad(params, batch)
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} microbatches")
        b = B // M
        dev = tree_leaves(params)[0].device
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=dev), params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        auxsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(M):
            micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            (l, met), g = value_and_grad(params, micro)
            with torch.no_grad():
                tree_map(lambda a, x: a.add_(x.float()), gsum, g)
            del g
            lsum = lsum + l
            auxsum = auxsum + met.get("aux_loss", 0.0)
        with torch.no_grad():
            grads = tree_map(lambda g, p: (g / M).to(p.dtype), gsum, params)
        return (lsum / M, {"aux_loss": auxsum / M}), grads

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = tree_leaves(state.params)[0].device
        if device is not None and (dev.type != device.type or (
                device.index is not None and dev.index != device.index)):
            raise ValueError(f"the state is on {dev}, the step on {device}")
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        (loss, metrics), grads = grad_fn(state.params, batch)
        # the span a profiler reads as the optimizer's share of a step
        with torch.no_grad(), torch.profiler.record_function(UPDATE_SPAN):
            if train_cfg.grad_clip > 0:
                grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
            else:
                gnorm = torch.zeros((), dtype=torch.float32, device=dev)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params, state.step)
            del grads
            params = tree_map(lambda p, u: p + u.to(p.dtype), state.params,
                              updates)
        out_metrics = {"loss": loss, "grad_norm": gnorm,
                       "aux_loss": metrics.get(
                           "aux_loss", torch.zeros((), device=dev))}
        return TrainState(params, opt_state, state.step + 1), out_metrics

    return train_step


# ---------------------------------------------------------------------------
# shared steps (federated clients: one step per config, not per client)
# ---------------------------------------------------------------------------
_STEP_LOCK = threading.Lock()
_STEP_CACHE: Dict[Any, Any] = {}        # guarded-by: _STEP_LOCK


def get_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                   impl: str = "eager", mesh=None, device: DeviceLike = None):
    """The train step for ``(model_cfg, train_cfg, impl, device)``.

    Process-wide cache: every FL client with the same config tuple gets
    the SAME callable (the configs are frozen dataclasses -- hashable cache
    keys).  ``device`` None means the card (raises without one).  A mesh
    (the reference's fsdp-sharded step) is ROADMAP queue 1, item 13.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded train step (make_sharded_train_step) is not "
            "ported yet: ROADMAP queue 1, item 13")
    _no_flash(impl)
    dev = resolve_device(device)
    key = (model_cfg, train_cfg, impl, str(dev))
    with _STEP_LOCK:
        fn = _STEP_CACHE.get(key)
    if fn is not None:
        return fn
    from repro_torch.models.api import build_model

    fn = make_train_step(build_model(model_cfg), train_cfg, impl=impl,
                         device=dev)
    with _STEP_LOCK:
        # racing threads may both build; first write wins so every caller
        # shares one callable afterwards
        return _STEP_CACHE.setdefault(key, fn)


def make_eval_step(model: Model, impl: str = "eager"):
    @torch.no_grad()
    def eval_step(params, batch):
        logits, _, _ = model.apply(params, batch, mode="train", impl=impl)
        labels = torch.as_tensor(batch["labels"], device=logits.device)
        loss = cross_entropy_loss(logits, labels)
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return {"loss": loss, "accuracy": acc}

    return eval_step


def make_prefill_step(model: Model, max_len: Optional[int] = None,
                      impl: str = "eager"):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache, _ = model.apply(params, batch, mode="prefill",
                                       impl=impl, prefill_max_len=max_len,
                                       last_logit_only=True)
        # only the last-position logits (the generation frontier) were built
        return logits[:, 0], cache

    return prefill_step


def make_decode_step(model: Model, impl: str = "eager"):
    """One new token against an existing cache."""

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, cache, _ = model.apply(params, {"tokens": tokens},
                                       mode="decode", cache=cache, impl=impl)
        return logits[:, 0], cache

    return decode_step


def greedy_generate(model: Model, params, prompt_tokens, num_new: int,
                    max_len: Optional[int] = None, impl: str = "eager"):
    """Reference end-to-end generation loop (prefill + decode steps)."""
    B, S = prompt_tokens.shape
    max_len = max_len or (S + num_new)
    prefill = make_prefill_step(model, max_len=max_len, impl=impl)
    decode = make_decode_step(model, impl=impl)
    batch = {"tokens": prompt_tokens}
    if model.cfg.is_encoder_decoder:
        raise NotImplementedError("use decode from init_cache for enc-dec")
    last, cache = prefill(params, batch)
    toks = [torch.argmax(last, -1)[:, None]]
    for _ in range(num_new - 1):
        last, cache = decode(params, cache, toks[-1])
        toks.append(torch.argmax(last, -1)[:, None])
    return torch.cat(toks, dim=1)
