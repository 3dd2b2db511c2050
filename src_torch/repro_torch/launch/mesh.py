"""Meshes of the port (port of ``repro/launch/mesh.py``): the 1-D mesh of
the sharded server aggregation state.  The training meshes and the H100's
roofline constants come with the training port (ROADMAP queue 1, items 13
and 14)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


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
    :func:`repro_torch.fl.agg_kernels.shard_bounds`); shard ``i`` keeps its
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
