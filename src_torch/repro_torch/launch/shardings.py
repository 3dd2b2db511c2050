"""Sharding-tree construction for step functions (port of
``repro/launch/shardings.py``).

Maps every leaf of (TrainState | params | batch | cache) to a
:class:`~repro_torch.sharding.NamedSharding` via the logical-axis rules in
:mod:`repro_torch.sharding`.  Cache leaves get their logical axes from
their key name + rank (the cache layout is defined by
``transformer.init_cache``).  A sharding's ``placements`` are what
``distribute_tensor`` takes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.config import InputShape
from repro_torch.models import transformer
from repro_torch.models.api import Model
from repro_torch.optim.optimizers import AdamState
from repro_torch.sharding import (DEFAULT_RULES, NamedSharding, _mesh_axis_sizes,
                                  is_axes, spec_for)
from repro_torch.train.steps import TrainState, abstract_opt_state


def _tree_map_axes(fn, axes, like):
    """``fn(axes_leaf, like_leaf)`` over a logical-axes tree."""
    if is_axes(axes):
        return fn(axes, like)
    return {k: _tree_map_axes(fn, v, like[k]) for k, v in axes.items()}


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree)


def params_shardings(model: Model, mesh, rules=None):
    axes = model.axes()
    abstract = model.abstract()
    fsdp = model.cfg.fsdp_hint
    msz = _mesh_axis_sizes(mesh).get("model", 1)

    def one(ax, leaf):
        spec = spec_for(ax, leaf.shape, mesh, rules=rules, fsdp=fsdp,
                        name="param")
        # salvage pass: a big weight whose every rule-assigned dim fell back
        # would be fully replicated -- shard its largest model-divisible dim
        # instead.  The byte estimate uses the leaf's own itemsize.
        if (all(e is None for e in spec)
                and leaf.numel() * leaf.element_size() >= 8e6
                and msz > 1):
            cand = [i for i, d in enumerate(leaf.shape) if d % msz == 0]
            if cand:
                best = max(cand, key=lambda i: leaf.shape[i])
                entries = [None] * len(leaf.shape)
                entries[best] = "model"
                spec = tuple(entries)
        return NamedSharding(mesh, spec)

    return _tree_map_axes(one, axes, abstract)


def state_shardings(model: Model, train_cfg, mesh, rules=None):
    """TrainState sharding: opt-state moments shard like their params."""
    p_shard = params_shardings(model, mesh, rules=rules)
    opt_state = abstract_opt_state(model, train_cfg)
    if isinstance(opt_state, AdamState):
        opt_shard = AdamState(mu=p_shard, nu=p_shard)
    elif opt_state == ():
        opt_shard = ()
    else:
        # adafactor/momentum: factored dims -- replicate (the reference's
        # conservative fallback)
        opt_shard = _map_leaves(lambda _: NamedSharding(mesh, ()), opt_state)
    return TrainState(params=p_shard, opt_state=opt_shard,
                      step=NamedSharding(mesh, ()))


# ---------------------------------------------------------------------------
# batch + cache
# ---------------------------------------------------------------------------
def batch_shardings(struct: Dict, mesh, rules=None) -> Dict[str, NamedSharding]:
    """``struct`` maps each batch key to a shape (or anything with
    ``.shape``)."""
    out = {}
    for k, v in struct.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        ax = ["batch"] + [None] * (len(shape) - 1)
        out[k] = NamedSharding(mesh, spec_for(ax, shape, mesh, rules=rules,
                                              name=f"batch.{k}"))
    return out


_CACHE_AXES_BY_KEY = {
    # name -> logical axes WITHOUT the leading stack dim (added by rank)
    "k": ("batch", "cache_seq", "kv_heads", None),
    "v": ("batch", "cache_seq", "kv_heads", None),
    "slot_pos": ("batch", "cache_seq"),
    "ckv": ("batch", "cache_seq", None),
    "kpe": ("batch", "cache_seq", None),
    "h": ("batch", "mlp"),
    "conv": ("batch", None, "mlp"),
    "C": ("batch", "heads", "mlp", None),
    "n": ("batch", "heads", "mlp"),
    "m": ("batch", "heads"),
    "sc": ("batch", None),
    "sn": ("batch", None),
    "sm": ("batch", None),
    "sh": ("batch", None),
    "pos": ("batch",),
    "cross_k": ("batch", None, "heads", None),
    "cross_v": ("batch", None, "heads", None),
}


def cache_shardings(model: Model, batch: int, max_len: int, mesh,
                    rules=None):
    """``(shardings, cache)``: the cache built on the ``meta`` device (its
    shapes and dtypes) and one sharding per leaf, keyed by the leaf's
    name."""
    model._decoder_only()
    cache = transformer.init_cache(model.cfg, batch, max_len,
                                   torch.device("meta"))

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        ax = list(_CACHE_AXES_BY_KEY.get(key, ()))
        # pad/trim to rank: leading extra dims are layer-stack dims
        while len(ax) < tree.dim():
            ax.insert(0, None)
        ax = ax[-tree.dim():] if len(ax) > tree.dim() else ax
        if tree.dim() == 0:
            ax = []
        return NamedSharding(mesh, spec_for(
            ax, tuple(tree.shape), mesh, rules=rules, name=f"cache.{key}"))

    return walk(cache, None), cache


def rules_for_shape(shape: InputShape) -> Dict[str, Tuple[str, ...]]:
    """Shape-dependent rule overrides."""
    rules = dict(DEFAULT_RULES)
    if shape.name == "long_500k":
        # batch=1: sequence-parallel cache (flash-decoding style); batch
        # stays on pod only
        rules["batch"] = ("pod",)
        rules["cache_seq"] = ("data",)
    elif shape.kind == "decode":
        # GQA kv counts cannot shard over model=16, so the cache shards its
        # sequence dim there (flash-decoding)
        rules["cache_seq"] = ("model",)
    else:
        rules["cache_seq"] = ()
    if shape.kind == "decode":
        # weight-stationary serving: dense weights live TP-sharded on
        # "model" only, expert banks stay FSDP over "data"
        rules["embed"] = ()
        rules["embed_expert"] = ("data",)
    return rules
