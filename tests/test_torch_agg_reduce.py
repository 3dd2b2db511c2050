"""The ``weighted_sum`` wrapper (``repro_torch.kernels.agg_reduce``).

On a CPU tensor the wrapper runs the plain twin and counts no launch; it
rejects inputs the kernel does not take; on the card (tests marked
``cuda``, skipped elsewhere) the CUDA kernel equals the twin bitwise.
This file imports only the port, so the ``cuda`` tests run on a machine
without JAX: ``python -m pytest -q -m cuda tests/test_torch_agg_reduce.py``.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

from repro_torch.kernels import agg_reduce


# ---------------------------------------------------------------------------
# the wrapper: CPU tensors take the plain twin; bad inputs raise
# ---------------------------------------------------------------------------
def test_wrapper_on_cpu_runs_the_twin_and_counts_no_launch():
    rng = np.random.default_rng(80)
    data = torch.from_numpy(rng.normal(0, 1, (3, 11)))
    w = torch.tensor([0.5, 0.25, 0.25], dtype=torch.float64)
    before = agg_reduce.LAUNCHES["weighted_sum"]
    out = agg_reduce.weighted_sum(data, w)
    assert agg_reduce.LAUNCHES["weighted_sum"] == before
    want = data[0] * w[0] + data[1] * w[1] + data[2] * w[2]
    assert torch.equal(out, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "scales", "noscales",
                                 "weights", "noncontig", "empty"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    data = torch.zeros((2, 8), dtype=torch.float32)
    w = torch.ones(2, dtype=torch.float64)
    kw = {}
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "shape":
        data = data[0]
    elif bad == "scales":
        kw["scales"] = torch.ones((2, 1), dtype=torch.float32)
    elif bad == "noscales":
        data = data.to(torch.int8)
    elif bad == "weights":
        w = torch.ones(3, dtype=torch.float64)
    elif bad == "noncontig":
        data = torch.zeros((8, 2), dtype=torch.float32).t()
    else:
        data, w = data[:0], w[:0]
    with pytest.raises((TypeError, ValueError)):
        agg_reduce.weighted_sum(data, w, **kw)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain twin
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the weighted_sum kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "int8_base", "float16",
                                   "bfloat16", "float32", "float64"])
@pytest.mark.parametrize("clients", [1, 2, 7, 16])
@pytest.mark.parametrize("with_acc", [False, True])
def test_kernel_matches_plain_twin_on_card(cuda_device, dtype, clients,
                                           with_acc):
    rng = np.random.default_rng(clients)
    n, qchunk = 3 * 1024 + 77, 1024
    x = rng.normal(0, 1, (clients, n))
    scales = base = None
    if dtype.startswith("int8"):
        data = torch.from_numpy(rng.integers(-127, 128, (clients, n),
                                             dtype=np.int8))
        scales = torch.from_numpy(
            10.0 ** rng.uniform(-44, -2, (clients, -(-n // qchunk)))
            .astype(np.float32))               # subnormal products too
        if dtype == "int8_base":
            base = torch.from_numpy(rng.normal(0, 1, n))
    else:
        data = torch.from_numpy(x).to(getattr(torch, dtype))
    w = torch.from_numpy(rng.uniform(0.1, 2.0, clients))
    acc = torch.from_numpy(rng.normal(0, 1, n)) if with_acc else None
    args = dict(scales=scales, qchunk=qchunk, base=base, acc=acc)
    want = agg_reduce.weighted_sum_plain(data, w, **args)
    dev = {k: None if v is None else v.to(cuda_device)
           for k, v in args.items() if k != "qchunk"}
    got = agg_reduce.weighted_sum(data.to(cuda_device), w.to(cuda_device),
                                  qchunk=qchunk, **dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
