"""Hand-written Hopper kernels of the port, one module per kernel family.

Each kernel has a wrapper that launches it on a CUDA tensor, a plain
PyTorch twin that the wrapper uses for a CPU tensor, and a launch
counter.  Sources live in ``csrc/`` and are built with ``nvcc`` at first
use (:mod:`repro_torch.kernels._build`).  As in the reference,
:mod:`~repro_torch.kernels.ops` holds the public wrappers and
:mod:`~repro_torch.kernels.ref` the full-matrix oracles.
"""
from repro_torch.kernels import ops, ref  # noqa: F401
