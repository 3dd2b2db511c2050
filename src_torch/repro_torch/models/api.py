"""Unified model facade (port of ``repro/models/api.py``).

``build_model(cfg)`` returns a :class:`Model`:

    params = model.init(seed, device=None)      # None means the CUDA card
    logits, _, metrics = model.apply(params, batch, mode="train")
    cache = model.init_cache(batch_size, max_len)
    logits, cache, _ = model.apply(params, batch, mode="decode", cache=cache)
    batch = model.make_batch(shape, seed=0)     # numpy, the reference's

``batch`` is a dict: tokens, labels, and (per family) extra_embeds (a
VLM's patch embeddings) or audio_embeds (an encoder-decoder's frames).
Parameters are nested dicts of tensors with the reference's keys and
shapes; :func:`params_from_reference` carries the reference's parameters
across and :func:`to_arrays` carries them back, and
:func:`train_state_from_reference` / :func:`train_state_to_arrays` do the
same for a whole training state (params, optimizer moments, step).
Decoder-only models run :mod:`repro_torch.models.transformer`,
encoder-decoder models :mod:`repro_torch.models.encdec`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.base import abstract_params, axes_tree, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def trunk(self):
        """The module that runs this model: ``encdec`` or
        ``transformer``."""
        return encdec if self.cfg.is_encoder_decoder else transformer

    # ------------------------------------------------------------- params
    def param_specs(self):
        return self.trunk.param_specs(self.cfg)

    def abstract(self):
        """The parameter tree on the ``meta`` device (shapes and dtypes)."""
        return abstract_params(self.param_specs(), self.cfg.param_dtype)

    def axes(self):
        """Each parameter's logical axes (the sharding rules' input)."""
        return axes_tree(self.param_specs())

    def init(self, seed: int, device: DeviceLike = None):
        """Random parameters from ``seed`` on ``device`` (None: the card;
        raises without one)."""
        dev = resolve_device(device)
        return init_params(self.param_specs(), seed, self.cfg.param_dtype,
                           dev)

    # ------------------------------------------------------------- forward
    def apply(self, params, batch: Dict[str, Any], *, mode: str,
              cache: Optional[Dict] = None, impl: str = "eager",
              prefill_max_len: Optional[int] = None,
              last_logit_only: bool = False):
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if self.cfg.is_encoder_decoder:
            audio = batch.get("audio_embeds")
            if audio is not None:
                audio = torch.as_tensor(audio, device=dev)
            return encdec.forward(params, self.cfg, tokens, mode=mode,
                                  audio_embeds=audio, cache=cache, impl=impl,
                                  prefill_max_len=prefill_max_len,
                                  last_logit_only=last_logit_only)
        extra = batch.get("extra_embeds")
        if extra is not None:
            extra = torch.as_tensor(extra, device=dev)
        return transformer.forward(params, self.cfg, tokens, mode=mode,
                                   cache=cache, extra_embeds=extra,
                                   impl=impl, prefill_max_len=prefill_max_len,
                                   last_logit_only=last_logit_only)

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None):
        return self.trunk.init_cache(self.cfg, batch, max_len,
                                     resolve_device(device))

    def param_count(self) -> int:
        from repro_torch.models.base import ParamSpec

        def count(sp):
            if isinstance(sp, ParamSpec):
                return int(np.prod(sp.shape))
            return sum(count(v) for v in sp.values())

        return count(self.param_specs())

    def active_param_count(self) -> int:
        """Active params per token (MoE discounts unused experts)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.moe.enabled:
            return total
        m = cfg.moe
        n_moe_layers = cfg.num_layers - m.first_dense_layers
        per_expert = 3 * cfg.d_model * m.d_ff
        inactive = (n_moe_layers * (m.num_experts - m.experts_per_token)
                    * per_expert)
        return total - inactive

    # ------------------------------------------------------------- inputs
    def batch_keys(self, kind: str) -> Tuple[str, ...]:
        keys = ["tokens"]
        if kind == "train":
            keys.append("labels")
        if self.cfg.frontend == "vision" and kind != "decode":
            keys.append("extra_embeds")
        if self.cfg.is_encoder_decoder and kind != "decode":
            keys.append("audio_embeds")
        return tuple(keys)

    def input_struct(self, shape: InputShape) -> Dict[str, torch.Tensor]:
        """The batch of ``shape`` on the ``meta`` device (shapes and
        dtypes, no storage): the reference's ``ShapeDtypeStruct`` stand-ins
        for the dry-run.  S is 1 for decode."""
        cfg = self.cfg
        B = shape.global_batch
        S = 1 if shape.kind == "decode" else shape.seq_len

        def meta(dims, dtype):
            return torch.empty(dims, dtype=dtype, device="meta")

        out = {"tokens": meta((B, S), torch.int32)}
        if shape.kind == "train":
            out["labels"] = meta((B, S), torch.int32)
        if cfg.frontend == "vision" and shape.kind != "decode":
            out["extra_embeds"] = meta(
                (B, cfg.num_prefix_tokens, cfg.d_model), cfg.compute_dtype)
        if cfg.is_encoder_decoder and shape.kind != "decode":
            out["audio_embeds"] = meta(
                (B, cfg.encoder_seq or 1500, cfg.d_model), cfg.compute_dtype)
        return out

    def make_batch(self, shape_or_batch, seq_len: Optional[int] = None,
                   seed: int = 0) -> Dict[str, np.ndarray]:
        """A random batch as numpy arrays, the reference's draws from
        ``seed``: an :class:`InputShape` (S is 1 for decode), or a batch
        size and ``seq_len`` of a train batch."""
        if isinstance(shape_or_batch, InputShape):
            B, S, kind = (shape_or_batch.global_batch, shape_or_batch.seq_len,
                          shape_or_batch.kind)
            S = 1 if kind == "decode" else S
        else:
            B, S, kind = shape_or_batch, seq_len, "train"
        rng = np.random.default_rng(seed)
        cfg = self.cfg
        out: Dict[str, np.ndarray] = {
            "tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}
        if kind == "train":
            out["labels"] = rng.integers(0, cfg.vocab_size, (B, S),
                                         dtype=np.int32)
        if cfg.frontend == "vision" and kind != "decode":
            out["extra_embeds"] = rng.normal(
                size=(B, cfg.num_prefix_tokens, cfg.d_model)
            ).astype(np.float32)
        if cfg.is_encoder_decoder and kind != "decode":
            out["audio_embeds"] = rng.normal(
                size=(B, cfg.encoder_seq or 1500, cfg.d_model)
            ).astype(np.float32)
        return out


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def params_from_reference(arrays, device: DeviceLike = None):
    """The port's parameter tree from the reference's, given as nested dicts
    of numpy arrays (``jax.tree.map(np.asarray, params)``): same keys, same
    shapes, fp32 tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev)

    return conv(arrays)


def to_arrays(params):
    """The parameter tree as nested dicts of host fp32 numpy arrays, in the
    reference's keys and layout."""
    if isinstance(params, dict):
        return {k: to_arrays(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy().copy()


def _state_classes():
    from repro_torch.optim.optimizers import AdafactorState, AdamState
    from repro_torch.train.steps import TrainState

    return {c.__name__: c for c in (AdamState, AdafactorState, TrainState)}


def train_state_from_reference(state, device: DeviceLike = None):
    """The port's ``TrainState`` from the reference's, given as numpy arrays
    (``jax.tree.map(np.asarray, state)``): params and optimizer moments as
    fp32 tensors, the step as int32 (a scalar, or one per pod of a
    pod-stacked state), on ``device`` (None: the
    card).  The reference's ``AdamState`` / ``AdafactorState`` become the
    port's classes of the same name."""
    dev = resolve_device(device)
    classes = _state_classes()

    def conv(a):
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return classes[type(a).__name__](*(conv(v) for v in a))
        if isinstance(a, (tuple, list)):
            return type(a)(conv(v) for v in a)
        return torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev)

    params, opt_state, step = state
    return classes["TrainState"](
        params_from_reference(params, dev), conv(opt_state),
        torch.from_numpy(np.asarray(step, np.int32).copy()).to(dev))


def train_state_to_arrays(state):
    """The inverse of :func:`train_state_from_reference`: the port's
    ``TrainState`` with host numpy leaves (fp32 params and moments, an
    int32 step), in the reference's keys and layout."""
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy()
                    if t.dtype == torch.int32 else
                    t.detach().float().cpu().numpy().copy(), state)
