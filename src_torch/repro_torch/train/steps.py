"""Step functions: prefill step, decode step and greedy generation (port of
``repro/train/steps.py:197-236``).  The loss, train and eval steps and the
``get_train_step`` cache come with the training slice (ROADMAP queue 1,
item 12).

PyTorch runs eagerly, so the steps are plain closures (the reference jits
them); they run under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.api import Model


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
