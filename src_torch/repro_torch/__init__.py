"""PyTorch + CUDA port of the federated-learning system in ``repro``.

The package mirrors ``repro`` module for module (``repro_torch/fl/flat.py``
is the port of ``repro/fl/flat.py``).  It imports neither JAX nor the
``repro`` package, nor ``msgpack`` or ``ml_dtypes``: it runs on a host that
has PyTorch and numpy only.  Entry points take ``device=``; ``None`` means
the CUDA card (see :mod:`repro_torch.device`), and the CPU is used only
when a caller asks for it.
"""
