"""The kernel wrappers of ``repro_torch.kernels.agg_reduce``:
``weighted_sum``, ``sort_reduce`` and ``gram``.

On a CPU tensor a wrapper runs the plain twin and counts no launch; it
rejects inputs the kernel does not take; on the card (tests marked
``cuda``, skipped elsewhere) the CUDA kernel equals the twin bitwise
(``weighted_sum``, ``sort_reduce``, NaN and signed-zero columns included)
or within ``rtol=1e-9`` of it and bitwise equal to itself from launch to
launch (``gram``).  This file imports only the port, so the ``cuda`` tests
run on a machine without JAX:
``python -m pytest -q -m cuda tests/test_torch_agg_reduce.py``.
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


# ---------------------------------------------------------------------------
# sort_reduce and gram
# ---------------------------------------------------------------------------
def _stack(kind, c, n, rng, qchunk=1024, specials=True):
    """A (C, N) payload stack on the CPU, with NaN and signed-zero columns
    (through the data, or for int8 through a NaN and a -0.0 scale)."""
    scales = base = None
    if kind.startswith("int8"):
        data = torch.from_numpy(rng.integers(-127, 128, (c, n),
                                             dtype=np.int8))
        s = 10.0 ** rng.uniform(-40, -1, (c, -(-n // qchunk)))
        if specials:
            s[-1, 0] = np.nan
            s[0, -1] = -0.0
        scales = torch.from_numpy(s.astype(np.float32))
        if kind == "int8_base":
            base = torch.from_numpy(rng.normal(0, 1, n))
    else:
        x = rng.normal(0, 2, (c, n))
        if specials:
            x[:, 0:16] = rng.choice([-0.0, 0.0], (c, 16))
            x[:, 16:32] = rng.choice([-0.0, 0.0, 1.0, -1.0], (c, 16))
            x[rng.integers(0, c, 24), rng.integers(32, 96, 24)] = np.nan
            x[:, n - 1] = np.nan
        data = torch.from_numpy(x).to(getattr(torch, kind))
    return data, dict(scales=scales, qchunk=qchunk, base=base)


def _bits(t):
    return t.view(torch.int64)


def test_robust_wrappers_on_cpu_run_the_twins_and_count_no_launch():
    rng = np.random.default_rng(81)
    data, kw = _stack("float32", 5, 300, rng)
    before = dict(agg_reduce.LAUNCHES)
    med = agg_reduce.sort_reduce(data, kind="median", **kw)
    tsum = agg_reduce.sort_reduce(data, kind="trim_sum", trim_k=1, **kw)
    x = data.to(torch.float64)
    fin = ~torch.isnan(x).any(0)
    g = agg_reduce.gram(data[:, fin].contiguous())
    assert agg_reduce.LAUNCHES == before
    s = torch.sort(x, dim=0).values
    assert torch.equal(med[fin], (0.0 + s[2])[fin])
    assert torch.isnan(med[~fin]).all()
    assert torch.equal(tsum[fin], (0.0 + s[1] + s[2] + s[3])[fin])
    t = x[:, fin] - x[0, fin]
    torch.testing.assert_close(g, t @ t.T, rtol=1e-12, atol=1e-12)


_SHARED_BAD = ["dtype", "shape", "scales", "noscales", "noncontig",
               "no_clients", "over_cap", "base"]


@pytest.mark.parametrize(
    "wrapper,bad", [("sort_reduce", b) for b in _SHARED_BAD + ["kind",
                                                               "trim_k"]]
    + [("gram", b) for b in _SHARED_BAD])
def test_robust_wrappers_reject_what_the_kernels_do_not_take(wrapper, bad):
    data = torch.zeros((4, 8), dtype=torch.float32)
    kw = {}
    if bad == "dtype":
        data = data.to(torch.int32)
    elif bad == "shape":
        data = data[0]
    elif bad == "scales":
        kw["scales"] = torch.ones((4, 1), dtype=torch.float32)
    elif bad == "noscales":
        data = data.to(torch.int8)
    elif bad == "noncontig":
        data = torch.zeros((8, 4), dtype=torch.float32).t()
    elif bad == "no_clients":
        data = data[:0]
    elif bad == "over_cap":
        data = torch.zeros((agg_reduce.MAX_CLIENTS + 1, 8))
    elif bad == "base":
        kw["base"] = torch.zeros(7, dtype=torch.float64)
    elif bad == "kind":
        kw["kind"] = "mean"
    else:
        kw.update(kind="trim_sum", trim_k=2)
    with pytest.raises((TypeError, ValueError),
                       match="MAX_CLIENTS" if bad == "over_cap" else None):
        getattr(agg_reduce, wrapper)(data, **kw)


SORT_CLIENTS = [1, 2, 3, 7, 16, 33, 64]
KINDS = ["int8", "int8_base", "float16", "bfloat16", "float32", "float64"]


@pytest.mark.cuda
@pytest.mark.parametrize("clients", SORT_CLIENTS)
@pytest.mark.parametrize("kind", KINDS)
def test_sort_reduce_kernel_matches_plain_twin_on_card(cuda_device, kind,
                                                        clients):
    rng = np.random.default_rng(clients)
    data, kw = _stack(kind, clients, 3 * 1024 + 77, rng)
    dev = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    for op, k in [("median", 0)] + [("trim_sum", k) for k in
                                    sorted({0, 1, clients // 3})
                                    if clients - 2 * k >= 1]:
        want = agg_reduce.sort_reduce_plain(data, kind=op, trim_k=k, **kw)
        got = agg_reduce.sort_reduce(data.to(cuda_device), kind=op,
                                     trim_k=k, **dev)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got.cpu()), _bits(want)), (op, k)


@pytest.mark.cuda
@pytest.mark.parametrize("clients", SORT_CLIENTS)
@pytest.mark.parametrize("kind", KINDS)
def test_gram_kernel_matches_plain_twin_on_card(cuda_device, kind, clients):
    rng = np.random.default_rng(clients)
    data, kw = _stack(kind, clients, 3 * 1024 + 77, rng, specials=False)
    dev = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    want = agg_reduce.gram_plain(data, **kw)
    got = agg_reduce.gram(data.to(cuda_device), **dev)
    again = agg_reduce.gram(data.to(cuda_device), **dev)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-9, atol=1e-9)
