"""Unified model facade (port of ``repro/models/api.py``).

``build_model(cfg)`` returns a :class:`Model`:

    params = model.init(seed, device=None)      # None means the CUDA card
    logits, _, metrics = model.apply(params, batch, mode="train")
    cache = model.init_cache(batch_size, max_len)
    logits, cache, _ = model.apply(params, batch, mode="decode", cache=cache)

``batch`` is a dict: tokens, labels, and (per family) extra_embeds.
Parameters are nested dicts of tensors with the reference's keys and
shapes; :func:`params_from_reference` carries the reference's parameters
across and :func:`to_arrays` carries them back, and
:func:`train_state_from_reference` / :func:`train_state_to_arrays` do the
same for a whole training state (params, optimizer moments, step).  Encoder-decoder models
are ROADMAP queue 1, item 11: they raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.base import abstract_params, axes_tree, init_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def _decoder_only(self) -> None:
        if self.cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder models are not ported yet: ROADMAP queue 1, "
                "item 11")

    # ------------------------------------------------------------- params
    def param_specs(self):
        self._decoder_only()
        return transformer.param_specs(self.cfg)

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
        self._decoder_only()
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        extra = batch.get("extra_embeds")
        if extra is not None:
            extra = torch.as_tensor(extra, device=dev)
        return transformer.forward(params, self.cfg, tokens, mode=mode,
                                   cache=cache, extra_embeds=extra,
                                   impl=impl, prefill_max_len=prefill_max_len,
                                   last_logit_only=last_logit_only)

    def init_cache(self, batch: int, max_len: int, device: DeviceLike = None):
        self._decoder_only()
        return transformer.init_cache(self.cfg, batch, max_len,
                                      resolve_device(device))

    def param_count(self) -> int:
        from repro_torch.models.base import ParamSpec

        def count(sp):
            if isinstance(sp, ParamSpec):
                return int(np.prod(sp.shape))
            return sum(count(v) for v in sp.values())

        return count(self.param_specs())

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
