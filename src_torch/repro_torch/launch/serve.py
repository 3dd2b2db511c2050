"""Serving launcher: batched prefill + decode loop (port of
``repro/launch/serve.py``).

A request batch is prefilled once, then decoded token by token with the
KV cache.  Prefill attention runs through the hand-written flash kernel
(``impl="flash"``; an MLA layer always takes the eager contraction, as the
reference's does).  A vision model's requests carry
``cfg.num_prefix_tokens`` precomputed patch embeddings (``extra_embeds``),
prepended to the prompt; an encoder-decoder model's requests carry
``cfg.encoder_seq`` audio frame embeddings (``audio_embeds``), which the
prefill encodes once into the cross-attention cache.  ``--arch`` selects
a registered architecture, in its smoke variant, as the reference does;
:func:`serve` runs any config, the full-width one included.  ``--device`` picks the device
(default: the CUDA card; ``--device cpu`` runs the kernels' plain twins).

    PYTHONPATH=src_torch python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_model_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import build_model
from repro_torch.train.steps import make_decode_step, make_prefill_step


@dataclass
class ServeResult:
    ids: torch.Tensor             # (B, new_tokens) generated token ids
    prefill_logits: torch.Tensor  # (B, padded vocab) fp32, last prompt position
    prefill_s: float              # prefill, host clock ending in a device sync
    decode_s: float               # the new_tokens - 1 decode steps, likewise
    finite: bool                  # every prefill and decode logit is finite


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(cfg: ModelConfig, params, tokens, *, new_tokens: int,
          impl: str = "flash", device: DeviceLike = None,
          extra_embeds=None, audio_embeds=None) -> ServeResult:
    """Prefill the (B, S) prompt ``tokens`` once, then greedily decode
    ``new_tokens`` tokens (the first from the prefill's logits).  ``params``
    lie on ``device`` (None: the card).  ``extra_embeds`` (B, N, d), where
    given, are prepended to the prompt (a vision model's patch
    embeddings); the cache holds them too, N + S + new_tokens slots, so no
    decode step overwrites a prompt slot.  ``audio_embeds`` (B, frames, d),
    where given, are an encoder-decoder model's frames: they fill the
    cross-attention cache, and the self-attention cache holds S +
    new_tokens slots."""
    dev = resolve_device(device)
    model = build_model(cfg)
    batch = {"tokens": torch.as_tensor(tokens, device=dev)}
    n_prefix = 0
    if extra_embeds is not None:
        batch["extra_embeds"] = torch.as_tensor(extra_embeds, device=dev)
        n_prefix = batch["extra_embeds"].shape[1]
    if audio_embeds is not None:
        batch["audio_embeds"] = torch.as_tensor(audio_embeds, device=dev)
    max_len = n_prefix + batch["tokens"].shape[1] + new_tokens
    prefill = make_prefill_step(model, max_len=max_len, impl=impl)
    decode = make_decode_step(model, impl=impl)

    _sync(dev)
    t0 = time.perf_counter()
    last, cache = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_logits = last
    finite = torch.isfinite(last).all()
    tok = torch.argmax(last[..., : cfg.vocab_size], -1)[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        last, cache = decode(params, cache, tok)
        finite &= torch.isfinite(last).all()
        tok = torch.argmax(last[..., : cfg.vocab_size], -1)[:, None]
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeResult(torch.cat(out, dim=1), prefill_logits, t_prefill,
                       t_decode, bool(finite))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_model_config(args.arch, smoke=True)
    params = build_model(cfg).init(args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    tokens = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len),
                          dtype=np.int64)
    extra = audio = None
    if cfg.frontend == "vision":
        extra = rng.normal(size=(args.batch, cfg.num_prefix_tokens,
                                 cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        audio = rng.normal(size=(args.batch, cfg.encoder_seq or 32,
                                 cfg.d_model)).astype(np.float32)
    res = serve(cfg, params, tokens, new_tokens=args.new_tokens,
                impl="flash", device=dev, extra_embeds=extra,
                audio_embeds=audio)
    toks = res.ids.cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"device={dev}")
    print(f"prefill: {res.prefill_s*1e3:.1f} ms   decode: "
          f"{res.decode_s/max(args.new_tokens-1,1)*1e3:.2f} ms/token")
    print("generated ids (req 0):", toks[0].tolist())


if __name__ == "__main__":
    main()
