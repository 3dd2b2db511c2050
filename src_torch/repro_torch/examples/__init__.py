"""Runnable examples of the port (``python -m repro_torch.examples.<name>``).

Each example's ``main(argv=None, device=None)`` runs on the CUDA card by
default and raises when there is none; ``device="cpu"`` runs it on the
CPU.  Their clients fit and their servers fold on that device.
"""
from __future__ import annotations

import torch

from repro_torch.device import DeviceLike, resolve_device


def example_device(device: DeviceLike = None) -> torch.device:
    """Resolve an example's device (None: the card).  On the card, switch
    on deterministic algorithms: the clients' fits run concurrently in
    SuperNode threads, and the bitwise checks (native == FLARE) need
    deterministic cuBLAS, whose ``CUBLAS_WORKSPACE_CONFIG`` each example
    module sets when it is imported, before CUDA starts."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.use_deterministic_algorithms(True)
    return dev
