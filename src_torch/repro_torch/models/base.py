"""Spec-first parameter system + shared layer primitives (port of
``repro/models/base.py``).

Single source of truth per module: a nested dict of :class:`ParamSpec`
(shape, logical axes, initializer).  :func:`init_params` makes the random
initial parameters from it; apply functions consume plain nested dicts of
tensors with the reference's keys and shapes.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "fan_in"      # fan_in | normal | zeros | ones | embed
    scale: float = 1.0
    dtype: Optional[str] = None   # override param_dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_specs(fn: Callable[[ParamSpec], object], specs):
    """``fn`` over every :class:`ParamSpec` of a nested dict, same keys."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: map_specs(fn, v) for k, v in specs.items()}


def abstract_params(specs, param_dtype: str = "float32"):
    """The parameter tree on the ``meta`` device: the shapes and dtypes,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return map_specs(lambda s: torch.empty(
        s.shape, dtype=getattr(torch, s.dtype or param_dtype),
        device="meta"), specs)


def axes_tree(specs):
    """Each leaf's logical axes, same keys."""
    return map_specs(lambda s: s.axes, specs)


def index_layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: index_layer(v, i) for k, v in tree.items()}
    return tree[i]


def unbind_layers(tree, n: int) -> List[Dict]:
    """The ``n`` layers of a stacked tree (views, no copy).  One
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing layer by layer would build a zero-filled stacked-size
    gradient for every layer (L^2 memory traffic in a training step)."""
    if isinstance(tree, dict):
        per_key = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(tree.unbind(0))


def stack_layers(trees: List[Dict]):
    """The per-layer trees stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_layers([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def iter_leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` for every leaf of a nested dict, in key order; the
    path is spelled as ``jax.tree_util.keystr`` spells it
    (``"['scan_0']['mix']['wq']"``)."""
    if not isinstance(tree, dict):
        yield path, tree
        return
    for k, v in tree.items():
        yield from iter_leaves(v, f"{path}[{k!r}]")


_M64 = (1 << 64) - 1


def _leaf_seed(seed: int, path: str) -> int:
    # deterministic per-leaf seed from a *stable* path hash (zlib.crc32, not
    # hash(): PYTHONHASHSEED must not affect init), as the reference folds
    # it into its root key -- so a leaf does not depend on the order in
    # which leaves are made.  A splitmix64 finaliser spreads (seed, hash)
    # over all 64 bits: the CPU generator keeps only the low 32.
    x = ((((int(seed) & 0xFFFFFFFF) << 32) | (zlib.crc32(path.encode())
                                              & 0x7FFFFFFF))
         + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _materialize(spec: ParamSpec, gen: torch.Generator, param_dtype: str,
                 device: torch.device) -> torch.Tensor:
    dtype = getattr(torch, spec.dtype or param_dtype)
    shape = spec.shape
    if spec.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (spec.scale * x).to(dtype)
    if spec.init == "fan_in":
        # truncated-normal (+-2 sigma) fan-in init; the contraction dims
        # are all dims except the last
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
        std = spec.scale / math.sqrt(max(fan_in, 1))
        x = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (std * x).to(dtype)
    raise ValueError(f"unknown init {spec.init!r}")


def init_params(specs, seed: int, param_dtype: str = "float32",
                device: DeviceLike = None):
    """Random parameters for a spec tree: each leaf draws from its own
    ``torch.Generator`` on ``device`` (None: the card; raises without one),
    seeded from ``seed`` and the leaf's path.  The bits differ from ``jax.random``'s; the tests carry the
    reference's parameters across instead
    (:func:`repro_torch.models.api.params_from_reference`)."""
    device = resolve_device(device)

    def build(tree, path: str):
        if isinstance(tree, ParamSpec):
            gen = torch.Generator(device=device)
            gen.manual_seed(_leaf_seed(seed, path))
            return _materialize(tree, gen, param_dtype, device)
        return {k: build(v, f"{path}[{k!r}]") for k, v in tree.items()}

    return build(specs, "")


# ---------------------------------------------------------------------------
# Primitives (pure functions over tensors)
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_spec(cfg, dim: int) -> Dict[str, ParamSpec]:
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((dim,), ("embed_nofsdp",), "ones"),
                "bias": ParamSpec((dim,), ("embed_nofsdp",), "zeros")}
    return {"scale": ParamSpec((dim,), ("embed_nofsdp",), "zeros")}


def apply_norm(params, x, cfg):
    if cfg.norm == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def _gelu_tanh(x):
    """``jax.nn.gelu`` (its default, tanh-approximate) op for op in x's
    dtype: in bf16 each product and sum rounds as the reference's does
    (``F.gelu`` would round once), and the constants are cast to x's dtype
    first, as JAX casts weakly typed scalars."""
    c = lambda v: torch.tensor(v, dtype=x.dtype)  # noqa: E731
    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu":
        return F.relu
    raise ValueError(name)


# --------------------------- rotary embeddings ------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  In fp32,
    cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (d/2,)
    angles = positions[..., None].float() * freqs           # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """(seq, dim) fp32 sine / cosine position table: sines in the even
    columns, cosines in the odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim * math.log(10000.0))
    ang = pos * inv[None, :]
    emb = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(ang)
    emb[:, 1::2] = torch.cos(ang)
    return emb


def softcap(logits: torch.Tensor, cap: float):
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits
