"""Meshes of the port (port of ``repro/launch/mesh.py``).

- :func:`make_local_mesh` and :func:`make_production_mesh` return a
  :class:`torch.distributed.device_mesh.DeviceMesh` with the reference's
  axis names (``("data", "model")``, ``("pod", "data", "model")``) over
  the ranks of the default process group, one card per rank (``nccl``),
  or CPU ranks (``gloo``) with ``device="cpu"``.  Where no group exists,
  :func:`make_local_mesh` starts a one-rank group on an in-memory store,
  so a caller needs no launcher for a one-card mesh.
- :func:`make_agg_mesh` is the 1-D mesh of the sharded server
  aggregation state.

The roofline constants (``launch/dryrun.py``, ``launch/roofline.py``) are
one NVIDIA H100 SXM's, in place of the reference's TPU v5e ones.  The
production meshes are laid out on DGX H100 nodes of 8 GPUs, ranks in
mesh order: ``model`` (16 wide) spans two nodes, and ``data`` (stride 16)
and ``pod`` (stride 256) step across nodes.  So every collective of both
meshes crosses the network, and the roofline's collective term divides
a device's collective bytes by its network rate, :data:`NET_BW`, not by
its NVLink rate.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

# NVIDIA H100 SXM, per GPU (H100 Tensor Core GPU datasheet: dense bf16
# tensor-core rate, i.e. without sparsity; HBM3 capacity and bandwidth)
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # bytes/s
HBM_PER_CHIP = 80e9               # bytes
# links (DGX H100 user guide): NVLink 4, 900 GB/s per GPU in both
# directions together (18 links); one ConnectX-7 400 Gb/s NIC per GPU
NVLINK_BW = 450e9                 # bytes/s per direction per GPU
NET_BW = 50e9                     # bytes/s per GPU (400 Gb/s)

_MESH_LOCK = threading.Lock()
# key -> (mesh, the default group it was built on)
_MESHES: Dict[tuple, tuple] = {}      # guarded-by: _MESH_LOCK


def _backend(dev: torch.device) -> str:
    return "cuda:nccl,cpu:gloo" if dev.type == "cuda" else "gloo"


def _world(dev: torch.device) -> int:
    """The default group's size; a one-rank group is started where none
    exists (once, when threads race on the first call)."""
    with _MESH_LOCK:
        if not dist.is_initialized():
            if dev.type == "cuda":
                torch.cuda.set_device(dev.index if dev.index is not None
                                      else torch.cuda.current_device())
            dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
        return dist.get_world_size()


def _device_mesh(dev: torch.device, shape: Tuple[int, ...],
                 names: Tuple[str, ...], world: int):
    from torch.distributed.device_mesh import DeviceMesh

    need = int(np.prod(shape))
    if world != need:
        raise RuntimeError(
            f"a {dict(zip(names, shape))} mesh needs {need} devices (one "
            f"rank each) and the process group has {world}")
    key = (dev.type, shape, names, world)
    with _MESH_LOCK:
        # a mesh outlives no group: after destroy_process_group and a new
        # group (the dry-run's, one a pair), the mesh is built anew
        group = dist.distributed_c10d._get_default_group()
        mesh, built_on = _MESHES.get(key, (None, None))
        if built_on is not group:
            mesh = DeviceMesh(dev.type,
                              torch.arange(need).reshape(shape).tolist(),
                              mesh_dim_names=names)
            _MESHES[key] = (mesh, group)
    return mesh


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None):
    """A ``(data, model)`` mesh over the process group's ranks on
    ``device``'s kind (None: the card).  The same call returns the same
    mesh."""
    dev = resolve_device(device)
    return _device_mesh(dev, (data, model), ("data", "model"), _world(dev))


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None):
    """The reference's production mesh: (data=16, model=16), or (pod=2,
    data=16, model=16) with ``multi_pod``.  Raises, naming the device
    count it needs, when the process group is smaller (as
    ``jax.make_mesh`` does); it never starts a group itself."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _device_mesh(dev, shape, names, world)


@dataclass(eq=False)
class AggMesh:
    """A 1-D ``("data",)`` mesh: ``devices`` is an object array of
    ``torch.device``, one per shard, with the ``shape``, ``size`` and
    ``flat`` a JAX mesh's ``devices`` has (what
    :func:`repro_torch.fl.agg_kernels.resolve_shards` and the sharded fold
    read)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("data",)


def make_agg_mesh(shards: int,
                  devices: Optional[Sequence[DeviceLike]] = None) -> AggMesh:
    """1-D ``("data",)`` mesh for the sharded server aggregation state.

    The FL server's flat fp64 accumulator splits into ``shards``
    contiguous ranges over this axis (see
    :func:`repro_torch.sharding.shard_bounds`); shard ``i`` keeps its
    accumulator, and folds, on ``devices[i]``.  By default these are the
    host's first ``shards`` CUDA cards, and it raises when the host has
    fewer; ``devices`` names them instead (for example ``["cpu", "cpu"]``
    where there is no card)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < shards:
            raise RuntimeError(
                f"make_agg_mesh({shards}) needs {shards} CUDA devices and "
                f"this host has {have}; pass devices=[...] to name them")
        devs = [torch.device("cuda", i) for i in range(shards)]
    else:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != shards:
            raise ValueError(f"{len(devs)} devices for {shards} shards")
    arr = np.empty(shards, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return AggMesh(arr)
