"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``).

Traces every (architecture x input shape) step function against the
production meshes -- 16x16 single pod and 2x16x16 multi-pod -- with fake
tensors only (``FakeTensorMode``: shapes, dtypes and devices, no storage;
the 236B model never materializes a weight).  The process plays rank 0
of a fake process group of 256 or 512 ranks (``init_process_group(
"fake")``, one per pair, in place of the reference's
``--xla_force_host_platform_device_count=512``), so DTensor places every
op and collective as that rank would.  Per pair, per device:

- ``counted_flops_raw``: the FLOPs of the ops the rank runs
  (``FlopCounterMode``, beside the reference's ``hlo_flops_raw``);
- ``collective_bytes``: the bytes each collective delivers to the rank,
  by the reference's HLO names;
- ``peak_bytes_est``: the peak of the rank's live tensors (``MemTracker``),
  the state and the batch included, against the card's 80 GB;
- the analytic FLOP / HBM-byte estimates (``launch/analytic.py``), which
  drive the roofline terms with one H100's constants (``launch/mesh.py``).

One JSON record per run is appended to --out.  The state and the batch
are placed on the mesh before the counters open, as the reference's
arrive placed (``in_shardings``).  What the reference records and the
port cannot: XLA-CPU artifacts (``cpu_convert_artifact_bytes``, the
halving of f32 collective bytes in ``adjusted_collective_total``) -- the
trace carries the card's dtypes; and a donated state's alias bytes -- the
port's train step keeps its input state, so its peak holds both.

A pair whose model runs the sLSTM's sequential loop over more than
:data:`SLSTM_TRACE_STEPS` steps (xLSTM's train and prefill shapes) is
traced twice, its loop cut to each count, and its FLOPs, collective bytes
and peak are extrapolated to the whole sequence; its record says so
(``"scaled": {"slstm_steps": [traced, S]}``).

A process has one default process group, so the dry-run refuses to
start where one exists (``make_local_mesh`` starts one, for example).

Usage (on the card; from Python, ``main([...], device="cpu")`` traces
CPU tensors):
  python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.jsonl]
  python -m repro_torch.launch.dryrun --arch X --shape train_4k --fl-round
  python -m repro_torch.launch.dryrun --arch granite-moe-1b-a400m \
      --shape decode_32k --mesh 1x8

Each record carries ``relaxed_views``, ``{site: count}``: the views of the
trace that DTensor's strict rule refuses, by the port's innermost call
site (:func:`_views_may_reshard`); the summary line names the pairs that
have any.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import sharding as shlib
from repro_torch.config import (INPUT_SHAPES, SLSTM, InputShape,
                                TrainConfig, get_model_config, list_archs,
                                shape_supported)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import (HBM_BW, HBM_PER_CHIP, NET_BW,
                                     PEAK_FLOPS_BF16, _device_mesh,
                                     make_production_mesh)
from repro_torch.launch.shardings import rules_for_shape
from repro_torch.models.api import build_model
from repro_torch.utils.pytree import tree_leaves, tree_map

#: the reference's grad-accumulation table (train shapes) for the archs
#: whose activations exceed HBM at global_batch 256
MICROBATCHES = {"deepseek-v2-236b": 4, "recurrentgemma-2b": 2}
#: local steps of a ``--fl-round``
FL_LOCAL_STEPS = 4
#: the sLSTM steps a pair traces of a longer sequence: the step is traced
#: twice, its loop cut to each count, and its FLOPs, collective bytes and
#: peak extrapolated to the whole sequence from the two (the loop is the
#: same plain ops every step, and keeps the same bytes a step for the
#: backward), as the reference multiplies a scan body's costs by its trip
#: count
SLSTM_TRACE_STEPS = (16, 32)

# the process-group and functional collectives by the reference's HLO names
# (and broadcast, scatter, gather, reduce by theirs)
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
    "scatter_": "scatter",
    "gather_": "gather",
    "reduce_": "reduce",
}


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves as leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


class CollectiveBytes(TorchDispatchMode):
    """Per-device collective bytes: each collective op the rank runs adds
    the bytes of what it returns (the reference's HLO result shape:
    all-gather the gathered tensor, reduce-scatter the rank's shard).  A
    DTensor op is handed back to DTensor, so the mode sees the local ops
    and the collectives DTensor lowers it to (as ``MemTracker`` and
    ``CommDebugMode`` do)."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if getattr(func, "namespace", None) in _COLLECTIVE_NAMESPACES:
            name = _COLLECTIVE_NAMES.get(func._opname)
            if name is not None:
                self.bytes[name] = self.bytes.get(name, 0.0) + _nbytes(out)
        return out


@contextlib.contextmanager
def _dtensor_metadata_untraced():
    """DTensor works out each op's output placements with a run of the op
    on fake tensors at global shapes, and a ``_StridedShard``'s offsets
    from an ``arange`` over the split dim that it reads back.  In an eager
    step these run on the side; under the dry-run's modes they would join
    the trace: the counters would take the global-shape run for the
    rank's work, and the offsets would be read back from fake tensors, one
    symbolic int an element.  So both run with no dispatch mode active, as
    outside a trace; each is left as it is where this torch lacks it."""
    from torch.distributed.tensor import _sharding_prop, placement_types
    from torch.utils._python_dispatch import _disable_current_modes

    targets = [(getattr(_sharding_prop, "ShardingPropagator", None),
                "_propagate_tensor_meta_non_cached"),
               (getattr(placement_types, "_StridedShard", None),
                "local_shard_size_and_offset")]
    saved = []
    for owner, name in targets:
        orig = getattr(owner, name, None) if owner is not None else None
        if orig is None:
            continue

        def untraced(*a, _orig=orig, **k):
            with _disable_current_modes():
                return _orig(*a, **k)

        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, untraced)
    try:
        yield
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


_VIEW_OPS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


def _ints(shape) -> Tuple:
    return tuple(v if isinstance(v, int) else str(v) for v in shape)


def _innermost(frames) -> Optional[str]:
    """The port's innermost of ``(filename, lineno)`` pairs (outermost
    first), ``file:line`` under ``repro_torch/``, this module's own frames
    skipped."""
    return next((f"{name.rsplit('repro_torch/')[-1]}:{line}"
                 for name, line in reversed(list(frames))
                 if "repro_torch/" in name and name != __file__), None)


def _port_site() -> str:
    """The port's innermost frame on the stack, ``file:line`` under
    ``repro_torch/`` (this module's own frames skipped); in a backward
    pass, with the autograd node that runs the view, and named by the
    forward site that made the node where anomaly mode kept its stack
    (``torch.autograd.set_detect_anomaly``, as ``dryrun_sites.py
    --forward-sites`` runs it)."""
    site = _innermost((f.filename, f.lineno)
                      for f in traceback.extract_stack()) or "unknown"
    node = torch._C._current_autograd_node()
    if node is None:
        return site
    made = "".join(node.metadata.get("traceback_", []))
    site = _innermost((f, int(n)) for f, n in
                      re.findall(r'File "([^"]+)", line (\d+)', made)) or site
    return f"{site} (backward: {node.name()})"


#: the keys of the views the strict rule refused in this process: DTensor
#: keeps a view's placement in caches of its own for the life of the
#: process (torch 2.11's survive ``cache_clear``), so a later trace may
#: see a refused view with no rule run
_REFUSED: set = set()


class RelaxedViews(TorchDispatchMode):
    """Counts the views of DTensors that take the relaxed rule of
    :func:`_views_may_reshard`, by the port's innermost call site, in
    :attr:`sites`.  DTensor caches a view's placement, so the rule runs
    once for each input placement, shape and target: the mode keys every
    view it sees the same way and counts a view whose key the rule has
    refused before (:data:`_REFUSED`).  Each view is counted at most once,
    however often DTensor runs the rule for it.  A DTensor op is handed
    back to DTensor."""

    def __init__(self, sites: Optional[Dict[str, int]] = None):
        super().__init__()
        self.sites: Dict[str, int] = {} if sites is None else sites
        # the key of the view being placed, and whether it is counted
        self._pending = None
        self._counted = False

    def _count(self) -> None:
        site = _port_site()
        self.sites[site] = self.sites.get(site, 0) + 1

    def refused(self) -> None:
        """The strict rule refused the view being placed: the one this
        mode saw last."""
        if self._counted:
            return
        self._counted = True
        if self._pending is not None:
            _REFUSED.add(self._pending)
        self._count()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if func in _VIEW_OPS and isinstance(args[0], DTensor):
                x = args[0]
                self._pending = (func, tuple(x.device_mesh.shape),
                                 str(x.placements), _ints(x.shape),
                                 _ints(args[1]))
                self._counted = self._pending in _REFUSED
                if self._counted:
                    self._count()
            else:
                self._pending, self._counted = None, False
            return NotImplemented
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _views_may_reshard(seen: RelaxedViews):
    """DTensor refuses an eager ``view`` whose placements it cannot keep
    (a view must alias its input): in torch 2.11, for example, flattening
    the sequence-parallel residual (B on "data", S on "model") into
    (B*S, d), or splitting a projection's columns (8 KV heads x 80 over
    16 ranks) into heads.  An XLA reshape reshards where it must, and the
    dry-run traces the reference's SPMD step, so while it traces, a
    ``view`` or ``_unsafe_view`` that DTensor's rule refuses takes the
    rule ``reshape`` has instead: it redistributes what it cannot keep (an
    all-gather of the split dim, counted).  A view the rule takes is
    placed as before.  Each refusal is counted by ``seen`` (enter it
    among the trace's modes): on real ranks such a view raises."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops import _view_ops

    prop = DTensor._op_dispatcher.sharding_propagator
    saved = {op: (prop.op_strategy_funcs[op], prop.op_to_schema_info.get(op))
             for op in _VIEW_OPS}
    for op, (strict, info) in saved.items():
        _view_ops.register_op_strategy_map(op, torch.Tensor.view,
                                           schema_info=info,
                                           strict_view=False)

        def strategy(op_schema, _strict=strict,
                     _relaxed=prop.op_strategy_funcs[op]):
            try:
                return _strict(op_schema)
            except RuntimeError:
                seen.refused()
                return _relaxed(op_schema)

        prop.op_strategy_funcs[op] = strategy
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        for op, (fn, info) in saved.items():
            prop.op_strategy_funcs[op] = fn
            if info is None:
                prop.op_to_schema_info.pop(op, None)
            else:
                prop.op_to_schema_info[op] = info
        prop.propagate_op_sharding.cache_clear()


@contextlib.contextmanager
def _slstm_steps(n: int):
    """The sLSTM's loop (``models/recurrent.py``) runs the first ``n`` steps
    of a longer sequence; its output is padded back to the whole length."""
    from repro_torch.models import recurrent

    scan = recurrent._slstm_scan

    def cut(params, xg, state, cfg):
        S = xg["z"].shape[1]
        if S <= n:
            return scan(params, xg, state, cfg)
        hs, state = scan(params, {g: v[:, :n] for g, v in xg.items()},
                         state, cfg)
        return torch.nn.functional.pad(hs, (0, 0, 0, S - n)), state

    recurrent._slstm_scan = cut
    try:
        yield
    finally:
        recurrent._slstm_scan = scan


def _trace_slstm_scaled(fn, args, shardings, device: torch.device,
                        S: int, relaxed: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
    """:func:`trace_step` with the sLSTM loop cut to each of
    :data:`SLSTM_TRACE_STEPS`, its counts and peak extrapolated to ``S``
    steps (``relaxed`` collects the first trace's relaxed views)."""
    a, b = SLSTM_TRACE_STEPS
    with _slstm_steps(a):
        short = trace_step(fn, args, shardings, device, relaxed=relaxed)
    with _slstm_steps(b):
        rec = trace_step(fn, args, shardings, device)
    k = (S - b) / (b - a)
    for key in ("counted_flops_raw", "peak_bytes_est"):
        rec[key] += k * (rec[key] - short[key])
    rec["peak_bytes_est"] = int(rec["peak_bytes_est"])
    coll = rec["collective_bytes"]
    for name in set(coll) | set(short["collective_bytes"]):
        got = coll.get(name, 0.0)
        coll[name] = got + k * (got - short["collective_bytes"].get(name, 0))
    rec["collective_bytes"] = dict(sorted(coll.items()))
    views = rec["relaxed_views"]
    for site in set(views) | set(short["relaxed_views"]):
        got = views.get(site, 0)
        views[site] = round(got + k * (got - short["relaxed_views"].get(
            site, 0)))
    rec["relaxed_views"] = dict(sorted(views.items()))
    rec["place_s"] = round(short["place_s"] + rec["place_s"], 1)
    rec["trace_s"] = round(short["trace_s"] + rec["trace_s"], 1)
    rec["scaled"] = {"slstm_steps": [b, S]}
    return rec


def roofline_terms(flops: float, hbm_bytes: float,
                   coll: Dict[str, float]) -> Dict[str, float]:
    """Per-device seconds for each roofline term (H100 constants): the
    collective term over the network rate, since every axis of both
    production meshes spans nodes (``launch/mesh.py``)."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = hbm_bytes / HBM_BW
    t_coll = sum(coll.values()) / NET_BW
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])[0]
    return {"t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dom}


def model_flops(cfg, shape: InputShape) -> float:
    """6*N_active*D for train; 2*N_active*D for inference (per step)."""
    model = build_model(cfg)
    n_active = model.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch        # decode: 1 token each


def build_step(arch: str, shape: InputShape, mesh, fl_round: bool = False,
               train_cfg: Optional[TrainConfig] = None):
    """``(fn, args, shardings)``: the step, its arguments as ``meta``
    tensors (the reference's ``ShapeDtypeStruct`` inputs) and a tree of
    :class:`~repro_torch.sharding.NamedSharding` of the same structure
    (the reference's ``in_shardings``).  ``fn(*placed_args)`` runs the
    step on the arguments distributed by those shardings."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.shardings import (batch_shardings,
                                              cache_shardings,
                                              params_shardings,
                                              state_shardings)
    from repro_torch.train.steps import (abstract_train_state,
                                         make_decode_step,
                                         make_prefill_step,
                                         make_sharded_train_step)

    cfg = get_model_config(arch)
    if shape.kind in ("prefill", "decode"):
        # serving runs bf16 weights (no fp32 master / optimizer resident)
        cfg = cfg.replace(param_dtype="bfloat16")
    model = build_model(cfg)
    rules = rules_for_shape(shape)
    if train_cfg is None:
        micro = MICROBATCHES.get(arch, 1) if shape.kind == "train" else 1
        train_cfg = TrainConfig(global_batch=shape.global_batch,
                                seq_len=shape.seq_len, optimizer="adamw",
                                microbatches=micro)

    if fl_round:
        return _build_fl_round(model, train_cfg, shape, mesh)

    if shape.kind == "train":
        # a train shape's rules are the default ones the sharded step
        # places its state and batch by
        step = make_sharded_train_step(model, train_cfg, mesh)
        state = abstract_train_state(model, train_cfg)
        batch = model.input_struct(shape)
        return (step, (state, batch),
                (state_shardings(model, train_cfg, mesh, rules=rules),
                 batch_shardings(batch, mesh, rules=rules)))

    params = model.abstract()
    p_sh = params_shardings(model, mesh, rules=rules)
    if shape.kind == "prefill":
        prefill = make_prefill_step(model, max_len=shape.seq_len)
        batch = model.input_struct(shape)

        def prefill_step(params, batch):
            with implicit_replication():
                return prefill(params, batch)

        return (prefill_step, (params, batch),
                (p_sh, batch_shardings(batch, mesh, rules=rules)))

    decode = make_decode_step(model)
    c_sh, cache = cache_shardings(model, shape.global_batch, shape.seq_len,
                                  mesh, rules=rules)
    tokens = model.input_struct(shape)["tokens"]
    t_sh = batch_shardings({"tokens": tokens}, mesh, rules=rules)["tokens"]

    def decode_step(params, cache, tokens):
        with implicit_replication():
            return decode(params, cache, tokens)

    return decode_step, (params, cache, tokens), (p_sh, c_sh, t_sh)


def _build_fl_round(model, train_cfg: TrainConfig, shape: InputShape, mesh):
    """What one rank runs of the reference's tight FL round
    (``make_fl_round_step``, whose vmapped per-pod steps see only
    ``("data", "model")``): its own pod's K local steps on the rank's
    ``(data, model)`` submesh, each on its pod's B / pods rows, then
    FedAvg of params and moments over ``"pod"`` (``tight_fedavg``: one
    all-reduce a dtype of the rank's shards, as this rank's one-pod
    stack).  The port's ``make_fl_round_step`` loops over the pods of a
    rank's stack; indexing pod p of a stack sharded over ``"pod"`` would
    gather it, so the trace runs the rank's part directly."""
    from torch.distributed.tensor import DTensor

    from repro_torch.core.collective import tight_fedavg
    from repro_torch.launch.shardings import batch_shardings, state_shardings
    from repro_torch.train.steps import (TrainState, abstract_train_state,
                                         make_sharded_train_step)

    names = tuple(mesh.mesh_dim_names)
    pods = dict(zip(names, mesh.shape)).get("pod", 1)
    sub = mesh["data", "model"] if "pod" in names else mesh
    step = make_sharded_train_step(model, train_cfg, sub)
    state = abstract_train_state(model, train_cfg)
    batch = {k: torch.empty((v.shape[0] // pods,) + tuple(v.shape[1:]),
                            dtype=v.dtype, device="meta")
             for k, v in model.input_struct(shape).items()}

    def local(x):
        return (x.to_local() if isinstance(x, DTensor) else x)[None]

    def fl_round(state, batch):
        for _ in range(FL_LOCAL_STEPS):
            state, _ = step(state, batch)
        params = tight_fedavg(tree_map(local, state.params), mesh)
        opt_state = tight_fedavg(tree_map(local, state.opt_state), mesh)
        return TrainState(params, opt_state, state.step)

    return (fl_round, (state, batch),
            (state_shardings(model, train_cfg, sub),
             batch_shardings(batch, sub)))


def place(args, shardings, device: torch.device, fake: bool):
    """The ``meta`` arguments as tensors on ``device`` -- empty fake ones
    under the active ``FakeTensorMode`` when ``fake``, zeros otherwise --
    distributed by their shardings."""
    from repro_torch.train.steps import distribute_tree

    def one(m):
        if fake:
            return torch.empty(m.shape, dtype=m.dtype, device=device)
        return torch.zeros(m.shape, dtype=m.dtype, device=device)

    return tuple(distribute_tree(tree_map(one, a), sh)
                 for a, sh in zip(args, shardings))


def count_step(fn, placed: Sequence, device_type: str,
               relaxed: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Run ``fn(*placed)`` once under the counters: FLOPs, collective
    bytes by name, the peak of live bytes, per device, and the views that
    took the relaxed rule by site (also into ``relaxed`` as they come, so
    a step that raises leaves its count there)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    flops = FlopCounterMode(display=False)
    coll = CollectiveBytes()
    views = RelaxedViews(relaxed)
    mem = MemTracker()
    mem.track_external(*tree_leaves(list(placed)))
    arg_bytes = _device_total(mem.get_tracker_snapshot(), device_type)
    # FlopCounterMode sits beneath the two modes that hand a DTensor op
    # back to DTensor, so it never sees the op at its global shape: it
    # counts the local ops this rank runs, per device, replicated work
    # included
    with _dtensor_metadata_untraced(), _views_may_reshard(views), flops, \
            coll, mem, views:
        out = fn(*placed)
    peak = _device_total(mem.get_tracker_snapshot("peak"), device_type)
    del out
    return {"counted_flops_raw": float(flops.get_total_flops()),
            "collective_bytes": dict(sorted(coll.bytes.items())),
            "argument_bytes": arg_bytes, "peak_bytes_est": peak,
            "relaxed_views": dict(sorted(views.sites.items()))}


def _device_total(snapshot, device_type: str) -> int:
    return int(sum(s["Total"] for d, s in snapshot.items()
                   if torch.device(d).type == device_type))


def trace_step(fn, args, shardings, device: torch.device,
               fake: bool = True,
               relaxed: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """Place ``args`` and count one step: on fake tensors under
    ``FakeTensorMode(shape_env=ShapeEnv())`` (a value the step reads off a
    fake tensor becomes a symbolic int instead of an error), or, with
    ``fake`` off, on real zeros (the tests' yardstick)."""
    t0 = time.perf_counter()
    if not fake:
        placed = place(args, shardings, device, fake=False)
        t_place = time.perf_counter() - t0
        rec = count_step(fn, placed, device.type, relaxed)
    else:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.symbolic_shapes import ShapeEnv

        with FakeTensorMode(shape_env=ShapeEnv()):
            placed = place(args, shardings, device, fake=True)
            t_place = time.perf_counter() - t0
            rec = count_step(fn, placed, device.type, relaxed)
    rec["place_s"] = round(t_place, 1)
    rec["trace_s"] = round(time.perf_counter() - t0 - t_place, 1)
    return rec


def _refuse_if_grouped() -> None:
    if dist.is_initialized():
        raise RuntimeError(
            "the dry-run plays rank 0 of a fake process group of its own, "
            "and this process already has a default process group (one a "
            "process; make_local_mesh starts one): run the dry-run in a "
            "process of its own (python -m repro_torch.launch.dryrun)")


def _start_group(world: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _refuse_if_grouped()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _make_mesh(multi_pod: bool, mesh_shape: Optional[Tuple[int, ...]],
               device: torch.device):
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device=device)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    return _device_mesh(device, tuple(mesh_shape), names,
                        dist.get_world_size())


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            fl_round: bool = False, verbose: bool = True, *,
            device: DeviceLike = None,
            train_cfg: Optional[TrainConfig] = None,
            mesh_shape: Optional[Tuple[int, ...]] = None) -> Dict[str, Any]:
    """Trace one pair and return its record.

    The mesh is the production one (``multi_pod``: 2x16x16), or
    ``mesh_shape`` -- ``(data, model)`` or ``(pod, data, model)`` -- on a
    fake group of that many ranks; tensors live on ``device``'s kind
    (None: the card).  ``train_cfg`` replaces the pair's ``TrainConfig``
    (the reference's microbatch table) and, for a train shape, its batch
    and length.  Raises where the process already has a process group."""
    shape = INPUT_SHAPES[shape_name]
    if train_cfg is not None and shape.kind == "train":
        shape = dataclasses.replace(shape, global_batch=train_cfg.global_batch,
                                    seq_len=train_cfg.seq_len)
    cfg = get_model_config(arch)
    ok, why = shape_supported(cfg, shape)
    label = ("x".join(map(str, mesh_shape)) if mesh_shape is not None
             else "2x16x16" if multi_pod else "16x16")
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": label,
                           "fl_round": fl_round}
    if not ok:
        rec["status"] = "skipped"
        rec["skip_reason"] = why
        return rec
    dev = resolve_device(device)
    world = (int(np.prod(mesh_shape)) if mesh_shape is not None
             else 512 if multi_pod else 256)
    _start_group(world)
    shlib.clear_fallbacks()
    relaxed: Dict[str, int] = {}
    try:
        mesh = _make_mesh(multi_pod, mesh_shape, dev)
        names = tuple(mesh.mesh_dim_names)
        if fl_round:
            # the round's local steps see only ("data", "model")
            shlib.set_activation_mesh(
                mesh["data", "model"] if "pod" in names else mesh,
                batch_axes=("data",))
        else:
            shlib.set_activation_mesh(mesh, batch_axes=tuple(
                a for a in rules_for_shape(shape)["batch"] if a in names))
        fn, args, shardings = build_step(arch, shape, mesh,
                                         fl_round=fl_round,
                                         train_cfg=train_cfg)
        if (SLSTM in cfg.layer_kinds and shape.kind != "decode"
                and shape.seq_len > SLSTM_TRACE_STEPS[1]):
            counted = _trace_slstm_scaled(fn, args, shardings, dev,
                                          shape.seq_len, relaxed)
        else:
            counted = trace_step(fn, args, shardings, dev, fake=True,
                                 relaxed=relaxed)
    except Exception as e:  # noqa: BLE001 -- one pair's failure is its record
        rec["status"] = "FAILED"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["relaxed_views"] = dict(sorted(relaxed.items()))
        # the step's innermost frame in the port (the counters' own
        # frames, in this module, sit below it)
        ours = [f for f in traceback.extract_tb(e.__traceback__)
                if "repro_torch" in f.filename and f.filename != __file__]
        if ours:
            rec["where"] = (f"{ours[-1].filename.rsplit('repro_torch/')[-1]}"
                            f":{ours[-1].lineno}")
        if verbose:
            print(json.dumps(rec, indent=1)[:3000], file=sys.stderr)
        return rec
    finally:
        shlib.set_activation_mesh(None)
        dist.destroy_process_group()

    n_dev = world
    model_axis = mesh.shape[-1]
    coll = counted["collective_bytes"]
    mf = model_flops(cfg, shape)

    from repro_torch.launch.analytic import estimate

    est = estimate(cfg, shape, n_dev, model_axis=model_axis)
    k_round = FL_LOCAL_STEPS if fl_round else 1   # fl-round = K local steps
    terms = roofline_terms(k_round * est.flops_per_device,
                           k_round * est.hbm_bytes_per_device, coll)
    peak = counted["peak_bytes_est"]
    rec.update({
        "status": "ok",
        "devices": n_dev,
        "device_type": dev.type,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
        "place_s": counted["place_s"],
        "trace_s": counted["trace_s"],
        "per_device": {
            # counted on the trace (every op, once per execution);
            # the analytic numbers drive the roofline, as the reference's
            "counted_flops_raw": counted["counted_flops_raw"],
            "analytic_flops": est.flops_per_device,
            "analytic_hbm_bytes": est.hbm_bytes_per_device,
            "argument_bytes": counted["argument_bytes"],
            "peak_bytes_est": peak,
            "fits_80GB": bool(peak <= HBM_PER_CHIP),
            "collective_bytes": coll,
        },
        "roofline": terms,
        "model_flops_total": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_frac": ((mf / n_dev) / est.flops_per_device
                              if est.flops_per_device else None),
        "sharding_fallbacks": {k: list(v)
                               for k, v in shlib.FALLBACKS.items()},
        # views DTensor's strict rule refused, resharded by the trace: on
        # real ranks each raises
        "relaxed_views": counted["relaxed_views"],
    })
    if "scaled" in counted:
        rec["scaled"] = counted["scaled"]
    if verbose:
        uf = rec["useful_flops_frac"]
        print(f"[{arch} x {shape_name} x {rec['mesh']}"
              f"{' fl-round' if fl_round else ''}] "
              f"trace={counted['trace_s']:.0f}s "
              f"aflops/dev={est.flops_per_device:.3g} "
              f"cflops/dev={counted['counted_flops_raw']:.3g} "
              f"abytes/dev={est.hbm_bytes_per_device:.3g} "
              f"peak={peak / 1e9:.2f}GB fits={rec['per_device']['fits_80GB']} "
              f"coll={ {k: f'{v:.3g}' for k, v in coll.items()} } "
              f"dom={terms['dominant']} "
              f"useful={uf and round(uf, 2)}",
              flush=True)
    return rec


def main(argv: Optional[List[str]] = None,
         device: DeviceLike = None) -> List[Dict[str, Any]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fl-round", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM or PxDxM on a fake group of that many ranks "
                         "(default: the production mesh)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh_shape = None
    if args.mesh:
        if args.multi_pod or args.both_meshes:
            ap.error("--mesh replaces --multi-pod / --both-meshes")
        mesh_shape = tuple(int(n) for n in args.mesh.lower().split("x"))

    if args.all:
        pairs = [(a, s) for a in list_archs() if a != "flower-quickstart"
                 for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    _refuse_if_grouped()
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    runs = []
    for arch, shape in pairs:
        for mp in meshes:
            rec = run_one(arch, shape, multi_pod=mp, fl_round=args.fl_round,
                          device=device, mesh_shape=mesh_shape)
            runs.append(rec)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
    n_fail = sum(r["status"] == "FAILED" for r in runs)
    n_ok = sum(r["status"] == "ok" for r in runs)
    n_skip = sum(r["status"] == "skipped" for r in runs)
    relaxed = [f"{r['arch']}x{r['shape']}x{r['mesh']} "
               f"({sum(r['relaxed_views'].values())})"
               for r in runs if r.get("relaxed_views")]
    print(f"dry-run summary: {n_ok} ok, {n_skip} skipped, {n_fail} FAILED, "
          f"{len(relaxed)} with relaxed views"
          + (": " + ", ".join(relaxed) if relaxed else ""))
    if n_fail:
        sys.exit(1)
    return runs


if __name__ == "__main__":
    main()
