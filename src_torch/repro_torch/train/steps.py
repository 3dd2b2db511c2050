"""Step functions: loss, train step, eval step, prefill step, decode step
(port of ``repro/train/steps.py``).

PyTorch runs eagerly, so the steps are plain closures (the reference jits
them; the port does not ``torch.compile`` them).  Gradients come from
``torch.autograd``; the serving and eval steps run under
``torch.no_grad``.

:func:`get_train_step` is the federated entry point: a process-wide cache
of train steps keyed by ``(model_cfg, train_cfg, impl, mesh or device)``,
so N simulated FL clients with identical configs share ONE step.  With a
mesh it is :func:`make_sharded_train_step`: the state and the batch become
DTensors placed by ``launch/shardings.py`` and the same step body runs on
them (the reference's ``jit(in_shardings, out_shardings)``).  Training
runs ``impl="eager"`` (the reference trains with ``"xla"``); the JAX
package has no backward kernel, so ``impl="flash"`` raises in training.
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
from repro_torch.sharding import gather_dim
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
    hold -1e30, and -1e30 x 0 is -0.  A vocab-sharded DTensor is gathered
    along the vocab first: DTensor has no rule for a gather across a split
    dim."""
    logits = gather_dim(logits.float(), -1)
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


def abstract_opt_state(model: Model, train_cfg: TrainConfig):
    """The optimizer state of :meth:`Model.abstract` params: ``meta``
    tensors with the moments' shapes and dtypes."""
    return make_optimizer(train_cfg).init(model.abstract())


def abstract_train_state(model: Model, train_cfg: TrainConfig) -> TrainState:
    """A ``TrainState`` on the ``meta`` device -- the reference's
    ``ShapeDtypeStruct`` state: its shapes and dtypes, no storage."""
    return TrainState(model.abstract(), abstract_opt_state(model, train_cfg),
                      torch.empty((), dtype=torch.int32, device="meta"))


def _acc_(acc: torch.Tensor, x: torch.Tensor) -> None:
    """``acc += x`` in place; a DTensor ``x`` is first redistributed to
    the accumulator's placements (an in-place op cannot move ``acc``)."""
    if hasattr(acc, "placements") and tuple(x.placements) != tuple(
            acc.placements):
        x = x.redistribute(acc.device_mesh, acc.placements)
    acc.add_(x)


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
        # zeros_like: a DTensor param's accumulator keeps its placements
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        auxsum = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(M):
            micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            (l, met), g = value_and_grad(params, micro)
            with torch.no_grad():
                tree_map(lambda a, x: _acc_(a, x.float()), gsum, g)
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
#: DTensor's sharding propagation keeps process-wide caches that are not
#: safe across threads (FL sites step in SuperNode threads): every DTensor
#: computation of this module holds this lock
_DTENSOR_LOCK = threading.RLock()


def _mesh_key(mesh) -> Any:
    """Hashable identity of a mesh: axis names, shape, device kind and the
    ranks it holds (two meshes over different devices must not share a
    step)."""
    if mesh is None:
        return None
    return (tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape),
            mesh.device_type, tuple(mesh.mesh.flatten().tolist()))


def get_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                   impl: str = "eager", mesh=None, device: DeviceLike = None):
    """The train step for ``(model_cfg, train_cfg, impl, mesh)``.

    Process-wide cache: every FL client with the same config tuple gets
    the SAME callable (the configs are frozen dataclasses -- hashable cache
    keys).  With a mesh (a ``DeviceMesh``: :func:`repro_torch.launch.mesh.
    make_local_mesh`), the step is :func:`make_sharded_train_step` on it;
    without one, the plain step on ``device`` (None: the card; raises
    without one).
    """
    _no_flash(impl)
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (make_local_mesh), "
                            f"got {type(mesh).__name__}")
        if device is not None and torch.device(device).type != \
                mesh.device_type:
            raise ValueError(f"device {device} is not the mesh's "
                             f"{mesh.device_type}")
        key = (model_cfg, train_cfg, impl, _mesh_key(mesh))
    else:
        dev = resolve_device(device)
        key = (model_cfg, train_cfg, impl, str(dev))
    with _STEP_LOCK:
        fn = _STEP_CACHE.get(key)
    if fn is not None:
        return fn
    from repro_torch.models.api import build_model

    model = build_model(model_cfg)
    if mesh is None:
        fn = make_train_step(model, train_cfg, impl=impl, device=dev)
    else:
        fn = make_sharded_train_step(model, train_cfg, mesh, impl=impl)
    with _STEP_LOCK:
        # racing threads may both build; first write wins so every caller
        # shares one callable afterwards
        return _STEP_CACHE.setdefault(key, fn)


def distribute_tree(tree, shardings):
    """Every leaf of ``tree`` as a DTensor placed by the matching
    :class:`~repro_torch.sharding.NamedSharding` of ``shardings`` (a tree
    of the same structure): a plain tensor is moved to the mesh's device
    and distributed, a DTensor redistributed where its placements differ."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(x, sh):
        want = tuple(sh.placements)
        if isinstance(x, DTensor):
            if x.device_mesh is sh.mesh and tuple(x.placements) == want:
                return x
            return x.redistribute(sh.mesh, want)
        return distribute_tensor(torch.as_tensor(x).to(sh.mesh.device_type),
                                 sh.mesh, want)

    return tree_map(one, tree, shardings)


def full_tree(tree):
    """Every DTensor leaf gathered to a plain tensor (the others as they
    are)."""
    from torch.distributed.tensor import DTensor

    with _DTENSOR_LOCK:
        return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                        else x, tree)


def make_sharded_train_step(model: Model, train_cfg: TrainConfig, mesh,
                            impl: str = "eager"):
    """The train step with mesh placements attached.

    ``launch/shardings.py`` maps every TrainState leaf (params AND Adam
    moments -- the moments shard exactly like their params) plus the
    token/label batch onto the mesh's fsdp "data"/"model" axes; the
    returned callable distributes its inputs to those placements, runs the
    step body of :func:`make_train_step` on the DTensors, and returns the
    state distributed the same way (the reference's ``in_shardings`` /
    ``out_shardings``) and the metrics as plain replicated tensors.  Steps
    from several threads run one at a time (``_DTENSOR_LOCK``).  Plain
    tensors the body makes (positions, masks, scalars) join as replicated
    DTensors; DTensor's own rules place every op, and a ``constrain_*``
    call redistributes where the activation mesh asks.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.shardings import batch_shardings, state_shardings

    st_sh = state_shardings(model, train_cfg, mesh)
    step = make_train_step(model, train_cfg, impl=impl,
                           device=torch.device(mesh.device_type))

    def sharded_train_step(state: TrainState, batch: Dict
                           ) -> Tuple[TrainState, Dict]:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        b_sh = batch_shardings({k: v.shape for k, v in batch.items()}, mesh)
        with _DTENSOR_LOCK:
            state = distribute_tree(state, st_sh)
            batch = {k: distribute_tree(v, b_sh[k]) for k, v in batch.items()}
            with implicit_replication():
                state, metrics = step(state, batch)
            return distribute_tree(state, st_sh), full_tree(metrics)

    return sharded_train_step


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
