"""Tight-mode integration: the FL round as a collective program (port of
``repro/core/collective.py``).

Federated *sites* map onto the ``"pod"`` axis of a mesh and the
aggregation itself is a collective:

  * within a pod: ordinary local training (the train step of
    :mod:`repro_torch.train.steps`);
  * across pods: the state is pod-stacked (every leaf has a leading
    num_pods dim) and the K local steps run per pod, so no gradient sync
    crosses pods; FedAvg is then the mean over that dim -- on one process
    a mean over the stacked dim, across the ranks of a ``"pod"`` mesh axis
    one ``all_reduce`` of the parameter tree -- byte-identical in meaning
    to the loose-mode ReliableMessage exchange.

A rank holds the pods of its own ``"pod"`` coordinate: a plain leaf is
the rank's own stack of pods, a DTensor leaf sharded over the pod axis on
its leading dim contributes its local shard.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.config import TrainConfig
from repro_torch.models.api import Model
from repro_torch.sharding import _mesh_axis_sizes
from repro_torch.train.steps import TrainState, make_train_step
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


def _axis_size(mesh, axis: str) -> int:
    if mesh is None:
        return 1
    return _mesh_axis_sizes(mesh).get(axis, 1)


def _pod_mean(leaves: List[torch.Tensor], mesh, axis: str,
              dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """FedAvg of pod-stacked leaves: each leaf's mean over its leading dim
    (in ``dtype`` where given, cast back after), broadcast back to every
    pod.  Across the ranks of ``mesh``'s ``axis`` the local pods' sums
    travel in ONE ``all_reduce`` per dtype; the result keeps each leaf's
    kind (a DTensor keeps its placements, a plain leaf comes back whole).
    Non-floating leaves pass through."""
    from torch.distributed.tensor import DTensor

    size = _axis_size(mesh, axis)
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    local: Dict[int, torch.Tensor] = {}
    for i, x in enumerate(leaves):
        if not x.is_floating_point():
            out[i] = x
            continue
        local[i] = x.to_local() if isinstance(x, DTensor) else x
    if size == 1:
        for i, lx in local.items():
            xa = lx.to(dtype) if dtype is not None else lx
            m = torch.mean(xa, dim=0, keepdim=True)
            out[i] = _rewrap(leaves[i], m.expand(lx.shape).to(lx.dtype))
        return out
    group = mesh.get_group(axis)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, lx in local.items():
        by_dtype.setdefault(dtype or lx.dtype, []).append(i)
    for dt, idx in by_dtype.items():
        sums = [local[i].to(dt).sum(dim=0).reshape(-1) for i in idx]
        buf = torch.cat(sums)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for i in idx:
            lx = local[i]
            n = lx[0].numel()
            # the pods of every rank: a DTensor's global leading dim, or
            # this rank's stack times the axis size
            total = (leaves[i].shape[0] if isinstance(leaves[i], DTensor)
                     else lx.shape[0] * size)
            m = (buf[off:off + n] / total).reshape((1,) + lx.shape[1:])
            off += n
            out[i] = _rewrap(leaves[i], m.expand(lx.shape).to(lx.dtype))
    return out


def _rewrap(like: torch.Tensor, local: torch.Tensor):
    """``local`` in ``like``'s kind: a DTensor with its placements, or a
    plain tensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        return DTensor.from_local(local.contiguous(), like.device_mesh,
                                  like.placements, run_check=False)
    return local.contiguous()


def tight_fedavg(stacked_params, mesh=None, axis: str = "pod",
                 aggregate_dtype=None):
    """FedAvg a pod-stacked param tree: every leaf has a leading num_pods
    dim; the mean over it (in ``aggregate_dtype`` where given) is
    broadcast back to every pod (= FedAvg result distributed to every
    site).  Over a mesh whose ``axis`` spans several ranks, it is one
    all-reduce of the tree across them."""
    leaves = tree_leaves(stacked_params)
    return tree_unflatten(stacked_params,
                          _pod_mean(leaves, mesh, axis, aggregate_dtype))


def make_fl_round_step(model: Model, train_cfg: TrainConfig, mesh=None,
                       local_steps: int = 1, impl: str = "eager",
                       aggregate_dtype=None, aggregate_opt_state: bool = True):
    """One synchronized FL round: K per-pod local steps + cross-pod FedAvg.

    ``round_fn(state, batches) -> (state, {"round_losses": (pods, K)})``:
    ``state`` is pod-stacked (:func:`pod_stacked_state`), ``batches`` maps
    each batch key to a ``(pods, K, B, S)`` array.  The K local steps loop
    over the pods (the reference vmaps them), so no gradient sync crosses
    pods; FedAvg is then the mean over the pod dim (:func:`tight_fedavg`).

    Options:
      aggregate_dtype     cast params to this dtype for the cross-pod mean
                          (e.g. ``torch.bfloat16`` halves the all-reduce
                          bytes); None = native dtype.
      aggregate_opt_state False = FedAvg only the params; Adam moments stay
                          local per pod (pure FedAvg semantics, 1/3 bytes).
    """
    train_step = make_train_step(model, train_cfg, impl=impl)

    def round_fn(state: TrainState, batches) -> tuple:
        pods = tree_leaves(state.params)[0].shape[0]
        new_states, losses = [], []
        for p in range(pods):
            st = tree_map(lambda x: x[p], state)
            lp = []
            for k in range(local_steps):
                st, m = train_step(st, {key: v[p, k]
                                        for key, v in batches.items()})
                lp.append(m["loss"])
            new_states.append(st)
            losses.append(torch.stack(lp))
        state = tree_map(lambda *xs: torch.stack(xs), *new_states)
        del new_states
        params = tight_fedavg(state.params, mesh,
                              aggregate_dtype=aggregate_dtype)
        opt_state = (tight_fedavg(state.opt_state, mesh,
                                  aggregate_dtype=aggregate_dtype)
                     if aggregate_opt_state else state.opt_state)
        return (TrainState(params, opt_state, state.step),
                {"round_losses": torch.stack(losses)})

    return round_fn


def pod_stacked_state(state: TrainState, num_pods: int) -> TrainState:
    """Tile a TrainState with a leading pod dim (abstract or concrete): a
    ``meta`` leaf stays storage-free, a concrete one is copied per pod."""
    def tile(x):
        if x.device.type == "meta":
            return torch.empty((num_pods,) + tuple(x.shape), dtype=x.dtype,
                               device="meta")
        return torch.stack([x] * num_pods)

    return tree_map(tile, state)
