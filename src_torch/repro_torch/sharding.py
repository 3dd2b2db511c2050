"""Logical-axis sharding rules (port of ``repro/sharding.py``).

Every tensor in the system is annotated with *logical* axis names
("embed", "heads", "mlp", "vocab", "batch", ...).  :func:`spec_for` maps
those to a spec for a concrete mesh, with **divisibility fallback**: if a
dimension is not divisible by the product of its assigned mesh axes, mesh
axes are dropped (innermost first) until it is.

A spec is what the reference's ``PartitionSpec`` holds, as a plain tuple:
one entry per tensor dim, ``None`` (whole), a mesh-axis name, or a tuple of
names (the dim split over several axes, major first).  On a
:class:`torch.distributed.device_mesh.DeviceMesh` it becomes DTensor
placements (:func:`placements_for`): ``Shard(i)`` on every mesh dim that
tensor dim ``i`` names, ``Replicate()`` on the rest.

Rule table (MaxText-style 2-D "fsdp + tensor"):

  batch   -> ("pod", "data")      activations' batch dim
  seq     -> None                 (sequence kept whole except long-decode cache)
  cache_seq -> "data"             flash-decoding style KV-page sharding
  embed   -> ("data", "model")    weight d_model dim  == FSDP storage sharding
  embed_nofsdp -> None            small models: replicate instead of FSDP
  heads   -> "model"              attention-head tensor parallelism
  kv_heads-> "model"
  mlp     -> "model"              d_ff tensor parallelism
  experts -> "model"              expert parallelism
  vocab   -> "model"
  head_dim, qk, v, lora, state -> None

The fallback drops axes *for that tensor only* and records the decision in
:data:`FALLBACKS`.

The ``constrain_*`` calls pin activations under an activation mesh
(:func:`set_activation_mesh`): a DTensor is ``redistribute``-d to the spec;
with no mesh they return their input unchanged, so the one-card serving
and training paths do not move.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]

# logical axis -> tuple of mesh axes (in sharding-priority order)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "cache_seq": ("data",),
    "embed": ("data", "model"),
    "embed_expert": ("data", "model"),  # expert-weight d_model (decode keeps FSDP)
    "embed_tensor": ("model",),      # d_model as a *contraction output* (o_proj in)
    "embed_nofsdp": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "head_dim": (),
    "qk": (),
    "v": (),
    "lora": (),
    "state": (),
    "stack": (),                     # stacked-layer leading dim
    "window": (),
    "frames": (),
    "pos": (),
    "conv": (),
}

# Decisions recorded by the most recent spec_for calls: name -> (requested, used)
FALLBACKS: Dict[str, Tuple[str, str]] = {}


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names, or the ``axis_names`` of a mesh shaped
    like the reference's (:class:`repro_torch.launch.mesh.AggMesh`)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    # a DeviceMesh's ``shape`` is plain ints: its ``mesh`` tensor is built
    # by tensor ops, which a fake-tensor trace refuses on a real tensor
    shape = (tuple(mesh.shape) if hasattr(mesh, "mesh_dim_names")
             else tuple(mesh.devices.shape))
    return dict(zip(mesh_axis_names(mesh), shape))


def spec_for(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: Optional[Dict[str, Tuple[str, ...]]] = None,
    fsdp: bool = True,
    name: str = "",
) -> Spec:
    """The spec for ``shape`` annotated with ``logical_axes``."""
    rules = rules or DEFAULT_RULES
    sizes = _mesh_axis_sizes(mesh)
    assert len(logical_axes) == len(shape), (logical_axes, shape, name)

    def rule_for(logical: str) -> Tuple[str, ...]:
        key = "embed_nofsdp" if (not fsdp and logical == "embed") else logical
        return tuple(a for a in rules.get(key, ()) if a in sizes)

    # Two-pass allocation: dims whose rule names a single mesh axis (tensor
    # parallelism: heads/mlp/experts/vocab) claim axes first; multi-axis
    # rules (FSDP "embed") then take whatever remains.  A mesh axis is used
    # at most once per tensor.
    order = sorted(
        range(len(shape)),
        key=lambda i: (len(rule_for(logical_axes[i])) if logical_axes[i] else 99),
    )
    used_axes: set = set()
    entries: list = [None] * len(shape)
    for i in order:
        logical, dim = logical_axes[i], shape[i]
        if logical is None:
            continue
        mesh_axes = [a for a in rule_for(logical) if a not in used_axes]
        kept = list(mesh_axes)
        while kept:  # divisibility fallback: drop least-priority axes
            prod = 1
            for a in kept:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            kept.pop()
        if kept != mesh_axes and name:
            FALLBACKS[f"{name}:{logical}"] = (
                "x".join(mesh_axes) or "-", "x".join(kept) or "-")
        used_axes.update(kept)
        if len(kept) == 1:
            entries[i] = kept[0]
        elif kept:
            entries[i] = tuple(kept)
    return tuple(entries)


def placements_for(mesh, spec: Spec) -> List:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): per
    mesh dim, ``Shard(i)`` where tensor dim ``i`` names it, else
    ``Replicate()``.  A dim split over several axes lists them major first,
    which is the mesh's own order for every rule of the table."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for j in idx:
            out[j] = Shard(i)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> List:
        return placements_for(self.mesh, self.spec)


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int], **kw) -> NamedSharding:
    return NamedSharding(mesh, spec_for(logical_axes, shape, mesh, **kw))


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and ``None``."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        isinstance(e, (str, type(None))) for e in x)


def _shape_of(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_specs(axes_tree, shape_tree, mesh, fsdp: bool = True):
    """Map :func:`spec_for` over parallel trees of logical axes and shapes
    (a shape leaf is a tuple of ints or anything with ``.shape``)."""
    if is_axes(axes_tree):
        return spec_for(axes_tree, _shape_of(shape_tree), mesh, fsdp=fsdp)
    if isinstance(axes_tree, dict):
        return {k: tree_specs(v, shape_tree[k], mesh, fsdp)
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        out = [tree_specs(a, s, mesh, fsdp)
               for a, s in zip(axes_tree, shape_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    raise TypeError(f"not a logical-axes tree: {axes_tree!r}")


def clear_fallbacks() -> None:
    FALLBACKS.clear()


# ---------------------------------------------------------------------------
# Activation sharding constraints (MaxText-style)
# ---------------------------------------------------------------------------
# The launcher installs the ambient mesh + batch axes here; model code
# calls `constrain_*` at the residual-stream boundaries.  No-ops when
# nothing is installed (one card, the CPU tests).
_ACT_MESH: list = [None, (), ("model",)]   # [mesh, batch_axes, vocab_axes]


def set_activation_mesh(mesh, batch_axes: Tuple[str, ...] = (),
                        vocab_axes: Tuple[str, ...] = ("model",)) -> None:
    _ACT_MESH[0] = mesh
    _ACT_MESH[1] = tuple(batch_axes)
    _ACT_MESH[2] = tuple(vocab_axes)


def _wsc(x, spec: Spec):
    """``x`` redistributed to ``spec`` on the activation mesh (the
    reference's ``with_sharding_constraint``)."""
    mesh = _ACT_MESH[0]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(
            "a sharding constraint under an activation mesh needs a DTensor "
            f"(got {type(x).__name__}); distribute the step's inputs "
            "(make_sharded_train_step) first")
    return x.redistribute(mesh, placements_for(mesh, spec))


def _batch_prod(sizes: Dict[str, int], axes: Tuple[str, ...]) -> int:
    prod = 1
    for a in axes:
        prod *= sizes.get(a, 1)
    return prod


def _axes_entry(axes: Tuple[str, ...]):
    return axes[0] if len(axes) == 1 else tuple(axes)


def constrain_batch(x):
    """Constrain the residual stream: dim0=batch on the batch axes and --
    when divisible -- dim1=seq on "model" (Megatron-style sequence
    parallelism)."""
    mesh, baxes = _ACT_MESH[0], _ACT_MESH[1]
    if mesh is None or not baxes:
        return x
    sizes = _mesh_axis_sizes(mesh)
    if x.shape[0] % _batch_prod(sizes, baxes) != 0:
        return x
    seq = None
    if (x.ndim >= 3 and "model" in sizes and x.shape[1] > 1
            and x.shape[1] % sizes["model"] == 0 and "model" not in baxes):
        seq = "model"
    return _wsc(x, (_axes_entry(baxes), seq) + (None,) * (x.ndim - 2))


def constrain_logits(x):
    """(B, S, V): batch axes on dim0, vocab axes on the last dim."""
    mesh, baxes, vaxes = _ACT_MESH
    if mesh is None:
        return x
    sizes = _mesh_axis_sizes(mesh)
    b = (_axes_entry(baxes)
         if (baxes and x.shape[0] % _batch_prod(sizes, baxes) == 0) else None)
    v = (_axes_entry(vaxes)
         if (vaxes and x.shape[-1] % _batch_prod(sizes, vaxes) == 0)
         else None)
    if b is None and v is None:
        return x
    return _wsc(x, (b,) + (None,) * (x.ndim - 2) + (v,))


def constrain_moe(x, expert_dim: Optional[int] = None):
    """MoE dispatch-space tensors: (G, ...) with an optional expert dim.

    G (dim 0) -> batch axes; ``expert_dim`` (if given and divisible) ->
    "model"."""
    mesh, baxes = _ACT_MESH[0], _ACT_MESH[1]
    if mesh is None or not baxes:
        return x
    sizes = _mesh_axis_sizes(mesh)
    entries: list = [None] * x.ndim
    entries[0] = (_axes_entry(baxes)
                  if x.shape[0] % _batch_prod(sizes, baxes) == 0 else None)
    if (expert_dim is not None and "model" in sizes
            and x.shape[expert_dim] % sizes["model"] == 0):
        entries[expert_dim] = "model"
    return _wsc(x, tuple(entries))


def constrain_heads(x, head_dim_index: int = 2):
    """(B, S, H, hd) attention-space tensors: batch axes on dim0, heads on
    "model" when divisible."""
    mesh, baxes = _ACT_MESH[0], _ACT_MESH[1]
    if mesh is None or not baxes:
        return x
    sizes = _mesh_axis_sizes(mesh)
    entries: list = [None] * x.ndim
    entries[0] = (_axes_entry(baxes)
                  if x.shape[0] % _batch_prod(sizes, baxes) == 0 else None)
    if "model" in sizes and x.shape[head_dim_index] % sizes["model"] == 0:
        entries[head_dim_index] = "model"
    return _wsc(x, tuple(entries))


def cast_weight(w: torch.Tensor, dtype: torch.dtype,
                logical_axes: Optional[Sequence[Optional[str]]] = None
                ) -> torch.Tensor:
    """The fp32 master weight ``w`` in the compute ``dtype``; under an
    activation mesh the cast copy is pinned to model-axis-only sharding
    (its first tensor-parallel dim that "model" divides), so the gather
    moves the narrow copy.  With no mesh it is a dtype cast."""
    w = w.to(dtype)
    mesh = _ACT_MESH[0]
    if mesh is None or logical_axes is None:
        return w
    msz = _mesh_axis_sizes(mesh).get("model", 1)
    entries = []
    used = False
    for ax, dim in zip(logical_axes, w.shape):
        if (not used and ax in ("heads", "kv_heads", "mlp", "experts",
                                "vocab") and dim % msz == 0 and msz > 1):
            entries.append("model")
            used = True
        else:
            entries.append(None)
    if not used:
        # no rule dim shards: leave the placement as it is -- an all-None
        # constraint would force replication
        return w
    return _wsc(w, tuple(entries))


def constrain_scores(x):
    """Chunked-attention score tensors (B, KV, g, Cq, Sk): the KV-head dim
    over "model" when it divides, else Sk over "model"."""
    mesh, baxes = _ACT_MESH[0], _ACT_MESH[1]
    if mesh is None:
        return x
    sizes = _mesh_axis_sizes(mesh)
    msz = sizes.get("model", 1)
    if msz <= 1:
        return x
    b = (_axes_entry(baxes)
         if (baxes and x.shape[0] % _batch_prod(sizes, baxes) == 0) else None)
    if x.ndim >= 3 and x.shape[1] % msz == 0:
        return _wsc(x, (b, "model") + (None,) * (x.ndim - 2))
    if x.shape[-1] % msz == 0:
        return _wsc(x, (b,) + (None,) * (x.ndim - 2) + ("model",))
    return x


def gather_dim(x, dim: int):
    """A DTensor ``x`` redistributed so that no mesh dim splits tensor dim
    ``dim`` and no partial sum is pending (the other placements kept); a
    plain tensor as it is.  Used before an op DTensor has no rule for
    across a split dim: the gathered gold logit of
    :func:`repro_torch.train.steps.cross_entropy_loss` over a (B, S, V)
    whose vocab is sharded, or whose contraction left a partial sum."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    want = [p if (isinstance(p, (Shard, Replicate))
                  and not (isinstance(p, Shard) and p.dim == dim))
            else Replicate() for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def model_axis_size() -> int:
    mesh = _ACT_MESH[0]
    if mesh is None:
        return 1
    return _mesh_axis_sizes(mesh).get("model", 1)


# ---------------------------------------------------------------------------
# Local regions of the sharded step
# ---------------------------------------------------------------------------
# Where DTensor's own placement of an op loses the reference's layout (the
# eager attention and its projections of the sequence-split residual, the
# cross-entropy over a split vocab, the recurrences' sequential parts),
# the step places the operands itself, runs plain torch ops on the rank's
# shards, and joins the result back as a DTensor.  The collectives between
# shards are the functional ones DTensor lowers to, called on the local
# tensors with their gradients written out.
def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under an activation mesh."""
    from torch.distributed.tensor import DTensor

    return _ACT_MESH[0] is not None and isinstance(x, DTensor)


def model_sharded(x) -> bool:
    """Whether ``x`` is a DTensor under an activation mesh whose "model"
    axis has more than one rank."""
    return on_mesh(x) and model_axis_size() > 1


def batch_spec(shape: Sequence[int], model_dim: Optional[int] = None
               ) -> Spec:
    """Dim 0 over the batch axes where their product divides it,
    ``model_dim`` over "model" (None: whole), every other dim whole."""
    mesh, baxes = _ACT_MESH[0], _ACT_MESH[1]
    sizes = _mesh_axis_sizes(mesh)
    entries: list = [None] * len(shape)
    if baxes and shape[0] % _batch_prod(sizes, baxes) == 0:
        entries[0] = _axes_entry(baxes)
    if model_dim is not None:
        entries[model_dim % len(shape)] = "model"
    return tuple(entries)


def spec_of(x) -> Spec:
    """The spec of DTensor ``x``'s placements: each dim over the mesh
    axes that shard it (major first), the rest whole."""
    from torch.distributed.tensor import Shard

    entries: list = [[] for _ in range(x.ndim)]
    for name, p in zip(mesh_axis_names(x.device_mesh), x.placements):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e)
                 for e in entries)


def to_local(x, spec: Spec, partial_grad: Sequence[str] = ()
             ) -> torch.Tensor:
    """The rank's shard of the DTensor ``x`` placed by ``spec`` on the
    activation mesh (redistributed by DTensor where it lies otherwise).
    Its gradient comes back in the same placements, except as a partial
    sum over the mesh axes of ``partial_grad`` that ``spec`` leaves whole:
    a weight read whole by work split over them."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = _ACT_MESH[0]
    want = placements_for(mesh, spec)
    if list(x.placements) != want:
        x = x.redistribute(mesh, want)
    grad = [Partial() if name in partial_grad and p == Replicate() else p
            for name, p in zip(mesh_axis_names(mesh), want)]
    return _DenseGrad.apply(x.to_local(grad_placements=grad))


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient leaves contiguous: DTensor takes a local
    gradient back into ops that view it (an einsum's gradient may be a
    transposed one)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def from_local(t: torch.Tensor, shape: Sequence[int], spec: Spec):
    """The DTensor of global ``shape`` whose rank's shard, placed by
    ``spec`` on the activation mesh, is ``t`` (made contiguous: the
    DTensor's strides are declared contiguous, and DTensor's views of it
    act on the shard as declared)."""
    from torch.distributed.tensor import DTensor

    mesh = _ACT_MESH[0]
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(t.contiguous(), mesh,
                              placements_for(mesh, spec),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def batch_axes() -> Tuple[str, ...]:
    """The activation mesh's batch axes."""
    return _ACT_MESH[1]


def batch_ranks() -> int:
    """The product of the activation mesh's batch axes' sizes."""
    return _batch_prod(_mesh_axis_sizes(_ACT_MESH[0]), _ACT_MESH[1])


def model_dim(x, axis: str = "model") -> Optional[int]:
    """The dim of DTensor ``x`` that the activation mesh's ``axis``
    splits (None: none, or not a DTensor under such an axis of more than
    one rank)."""
    from torch.distributed.tensor import Shard

    if not on_mesh(x) or _mesh_axis_sizes(_ACT_MESH[0]).get(axis, 1) <= 1:
        return None
    p = x.placements[mesh_axis_names(x.device_mesh).index(axis)]
    return p.dim if isinstance(p, Shard) else None


def model_rank(axis: str = "model") -> int:
    """This rank's coordinate on the activation mesh's ``axis`` (0 where
    it has none)."""
    if axis not in mesh_axis_names(_ACT_MESH[0]):
        return 0
    return _ACT_MESH[0].get_local_rank(axis)


def _group(axis: str) -> str:
    return _ACT_MESH[0].get_group(axis).group_name


def _model_group() -> str:
    return _group("model")


_FC = torch.ops._c10d_functional


def _all_reduce(x: torch.Tensor, op: str, group: str) -> torch.Tensor:
    return _FC.wait_tensor(_FC.all_reduce(x.contiguous(), op, group))


class _AllReduce(torch.autograd.Function):
    """Sum over "model"; the backward sums the gradients too where each
    rank's use of the total is its own share (``sum_grads``), and passes
    them on where every rank holds the whole gradient."""

    @staticmethod
    def forward(ctx, x, group, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        return _all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = _all_reduce(g, "sum", ctx.group)
        return g, None, None


def model_sum(x: torch.Tensor, sum_grads: bool,
              axis: str = "model") -> torch.Tensor:
    """All-reduce of the local ``x`` over ``axis`` (see
    :class:`_AllReduce` for ``sum_grads``)."""
    return _AllReduce.apply(x, _group(axis), sum_grads)


def axes_sum(x: torch.Tensor, axes: Sequence[str],
             sum_grads: bool) -> torch.Tensor:
    """:func:`model_sum` over each of ``axes`` of the activation mesh
    (one all-reduce an axis of more than one rank)."""
    sizes = _mesh_axis_sizes(_ACT_MESH[0])
    for a in axes:
        if sizes.get(a, 1) > 1:
            x = _AllReduce.apply(x, _group(a), sum_grads)
    return x


def model_max(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """The max of the local ``x`` over ``axis``, outside autograd (a
    softmax's shift, whose gradient is zero)."""
    return _all_reduce(x.detach(), "max", _group(axis))


class _AllToAll(torch.autograd.Function):
    """All-to-all of dim 0's equal chunks over a group; its own backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group: str) -> torch.Tensor:
    splits = [1] * x.shape[0]
    return _FC.wait_tensor(_FC.all_to_all_single(x.contiguous(), splits,
                                                 splits, group))


def seq_to_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S/m, N, hd) local shards of a sequence split over "model" ->
    (B, S, N/m, hd) shards of the heads: one all-to-all (Megatron's
    sequence-to-head exchange), where DTensor would gather on the CPU."""
    m = model_axis_size()
    B, s, N, hd = t.shape
    x = t.reshape(B, s, m, N // m, hd).permute(2, 0, 1, 3, 4)
    y = _AllToAll.apply(x, _model_group())            # (m, B, s, N/m, hd)
    return y.permute(1, 0, 2, 3, 4).reshape(B, m * s, N // m, hd)


class _GatherSeq(torch.autograd.Function):
    """All-gather of dim 0 over a group; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _FC.wait_tensor(_FC.all_gather_into_tensor(x.contiguous(),
                                                          size, group))

    @staticmethod
    def backward(ctx, g):
        return _FC.wait_tensor(_FC.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.size, ctx.group)), None, None


def gather_seq(t: torch.Tensor) -> torch.Tensor:
    """(B, S/m, ...) local shards of a sequence split over "model" -> the
    whole (B, S, ...) on every rank."""
    m = model_axis_size()
    y = _GatherSeq.apply(t.movedim(1, 0), _model_group(), m)
    return y.movedim(0, 1)


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter of dim 0 over a group; the backward all-gathers."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _FC.wait_tensor(_FC.reduce_scatter_tensor(
            x.contiguous(), "sum", size, group))

    @staticmethod
    def backward(ctx, g):
        return _FC.wait_tensor(_FC.all_gather_into_tensor(
            g.contiguous(), ctx.size, ctx.group)), None, None


def scatter_seq(t: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) partial sums on each rank -> (B, S/m, ...): this rank's
    rows of their sum over "model" (the transpose of
    :func:`gather_seq`)."""
    m = model_axis_size()
    y = _ScatterSeq.apply(t.movedim(1, 0), _model_group(), m)
    return y.movedim(0, 1)


# ---------------------------------------------------------------------------
# Server aggregation-state sharding (FL side)
# ---------------------------------------------------------------------------
def shard_bounds(total: int, num_shards: int,
                 align: int = 1) -> Tuple[Tuple[int, int], ...]:
    """Contiguous ``[lo, hi)`` element ranges splitting a flat ``total``-
    element vector across ``num_shards`` — the 1-D column partition the
    sharded server aggregation state lives on.

    Every boundary is a multiple of ``align`` (pass the int8 scale-window
    size so quantized scale chunks never straddle shards), so shard sizes
    differ by at most ``align``; trailing shards may be empty when
    ``total`` is small.
    """
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    if align <= 0:
        raise ValueError(f"align must be positive, got {align}")
    per = -(-total // num_shards)           # ceil
    per = -(-per // align) * align          # round up to alignment
    bounds = []
    for i in range(num_shards):
        lo = min(i * per, total)
        hi = min(lo + per, total)
        bounds.append((lo, hi))
    return tuple(bounds)


def agg_spec(mesh) -> Spec:
    """The spec of the flat aggregation vector on an agg mesh: the single
    dimension sharded over the "data" axis."""
    names = mesh_axis_names(mesh)
    return ("data" if "data" in names else names[0],)
