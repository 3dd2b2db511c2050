"""The kernel wrappers of ``repro_torch.kernels.agg_reduce``:
``weighted_sum`` (fp64 and fp32 tiles), ``sort_reduce``, ``gram`` and
``scatter_wsum``.

On a CPU tensor a wrapper runs the plain twin and counts no launch; it
rejects inputs the kernel does not take; on the card (tests marked
``cuda``, skipped elsewhere) the CUDA kernel equals the twin bitwise
(``weighted_sum`` in both tile types, ``sort_reduce``, NaN and signed-zero
columns included, ``scatter_wsum``)
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
               "no_clients", "base"]


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
    elif bad == "base":
        kw["base"] = torch.zeros(7, dtype=torch.float64)
    elif bad == "kind":
        kw["kind"] = "mean"
    else:
        kw.update(kind="trim_sum", trim_k=2)
    with pytest.raises((TypeError, ValueError)):
        getattr(agg_reduce, wrapper)(data, **kw)


@pytest.mark.parametrize("clients", [65, 200])
@pytest.mark.parametrize("wrapper", ["sort_reduce", "gram"])
def test_robust_wrappers_take_more_than_64_clients(wrapper, clients):
    """No client cap: past 64 clients the twins run (the kernels sort in
    shared memory or scratch and tile the Gram by client blocks), and agree
    with numpy's sort and product on the decoded stack."""
    rng = np.random.default_rng(clients)
    data, kw = _stack("float32", clients, 200, rng, specials=False)
    x = data.to(torch.float64).numpy()
    if wrapper == "gram":
        got = agg_reduce.gram(data, **kw).numpy()
        t = x - x[0]
        np.testing.assert_allclose(got, t @ t.T, rtol=1e-12, atol=1e-12)
        return
    k = clients // 5
    got = agg_reduce.sort_reduce(data, kind="trim_sum", trim_k=k, **kw)
    acc = np.zeros(x.shape[1])              # numpy's sum: +0.0, rows in order
    for row in np.sort(x, axis=0)[k:clients - k]:
        acc = acc + row
    assert np.array_equal(got.numpy().view(np.int64), acc.view(np.int64))
    med = agg_reduce.sort_reduce(data, kind="median", **kw).numpy()
    assert np.array_equal(med, np.median(x, axis=0))


SORT_CLIENTS = [1, 2, 3, 7, 16, 33, 64]
#: past the register path: shared-memory sorts and Gram client blocks
BIG_CLIENTS = [65, 200, 1000]
KINDS = ["int8", "int8_base", "float16", "bfloat16", "float32", "float64"]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_rows_on_cpu_runs_the_twin_and_counts_no_launch(kind):
    """The decoded rows land in ``out[row0:row0 + C]``, bitwise the
    per-row decode, and nothing else is written; rows outside ``out``
    raise."""
    rng = np.random.default_rng(9)
    data, kw = _stack(kind, 3, 2100, rng)
    before = dict(agg_reduce.LAUNCHES)
    out = torch.full((6, 2100), 7.0, dtype=torch.float64)
    agg_reduce.decode_rows(data, out=out, row0=2, **kw)
    assert agg_reduce.LAUNCHES == before
    want = agg_reduce._decoded_plain(data, kw["scales"], kw["qchunk"],
                                     kw["base"])
    assert torch.equal(_bits(out[2:5]), _bits(want))
    assert bool((out[:2] == 7.0).all()) and bool((out[5:] == 7.0).all())
    assert torch.equal(_bits(agg_reduce.decode_rows(data, **kw)),
                       _bits(want))
    with pytest.raises(ValueError, match="outside"):
        agg_reduce.decode_rows(data, out=out, row0=4, **kw)


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


@pytest.mark.cuda
@pytest.mark.parametrize("clients", BIG_CLIENTS + [20000])
@pytest.mark.parametrize("kind", ["int8_base", "bfloat16", "float32"])
def test_sort_reduce_kernel_over_64_clients_matches_twin_on_card(
        cuda_device, kind, clients):
    """C > 64: the shared-memory sort (65 to 1000) and, at 20000 clients,
    the sort in global scratch; bitwise the twin."""
    rng = np.random.default_rng(clients)
    data, kw = _stack(kind, clients, 300 if clients > 1000 else 2100, rng)
    dev = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    for op, k in (("median", 0), ("trim_sum", 0), ("trim_sum", clients // 5)):
        want = agg_reduce.sort_reduce_plain(data, kind=op, trim_k=k, **kw)
        got = agg_reduce.sort_reduce(data.to(cuda_device), kind=op,
                                     trim_k=k, **dev)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got.cpu()), _bits(want)), (op, k)


@pytest.mark.cuda
@pytest.mark.parametrize("clients", BIG_CLIENTS)
@pytest.mark.parametrize("kind", ["int8_base", "float32"])
def test_gram_kernel_over_64_clients_matches_twin_on_card(cuda_device, kind,
                                                          clients):
    rng = np.random.default_rng(clients)
    data, kw = _stack(kind, clients, 2100, rng, specials=False)
    dev = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    want = agg_reduce.gram_plain(data, **kw)
    got = agg_reduce.gram(data.to(cuda_device), **dev)
    again = agg_reduce.gram(data.to(cuda_device), **dev)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_decode_rows_kernel_matches_plain_twin_on_card(cuda_device, kind):
    """The decode-only kernel writes its rows of a larger fp64 stack,
    bitwise the twin (signed zeros kept; NaNs stay NaNs), and nothing
    else."""
    rng = np.random.default_rng(7)
    data, kw = _stack(kind, 5, 3 * 1024 + 77, rng)
    dev = {k: v.to(cuda_device) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    want = agg_reduce.decode_rows_plain(data, **kw)
    out = torch.full((8, data.shape[1]), 3.0, dtype=torch.float64,
                     device=cuda_device)
    before = agg_reduce.LAUNCHES["decode_rows"]
    agg_reduce.decode_rows(data.to(cuda_device), out=out, row0=2, **dev)
    torch.cuda.synchronize()
    assert agg_reduce.LAUNCHES["decode_rows"] == before + 1
    got = out[2:7].cpu()
    # NaN payload bits are the device's (a NaN scale or input stays NaN)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got[~nan]), _bits(want[~nan]))
    assert bool((out[:2] == 3.0).all()) and bool((out[7:] == 3.0).all())


# ---------------------------------------------------------------------------
# weighted_sum's fp32 tiles and scatter_wsum
# ---------------------------------------------------------------------------
def _q8_stack(rng, c, n, qchunk=1024):
    data = torch.from_numpy(rng.integers(-127, 128, (c, n), dtype=np.int8))
    scales = torch.from_numpy(10.0 ** rng.uniform(
        -44, -2, (c, -(-n // qchunk))).astype(np.float32))
    return data, scales


def test_f32_tiles_round_the_decode_and_the_weight_in_fp32():
    """fp32 tiles: ``f64(f32(q * s) * f32(w))`` added to the fp64 carry,
    written out by hand; fp64 payloads are narrowed first; a base is
    refused, as the reference refuses it."""
    rng = np.random.default_rng(90)
    data, scales = _q8_stack(rng, 3, 2500)
    w = torch.from_numpy(rng.uniform(0.1, 2.0, 3))
    acc = torch.from_numpy(rng.normal(0, 1, 2500))
    want = acc.clone()
    for c in range(3):
        s = scales[c].repeat_interleave(1024)[:2500]
        want = want + ((data[c].float() * s) * w[c].float()).double()
    got = agg_reduce.weighted_sum(data, w, scales=scales, acc=acc,
                                  tile_dtype="float32")
    assert torch.equal(got, want)
    x = torch.from_numpy(rng.normal(0, 1, (2, 9)))
    got = agg_reduce.weighted_sum(x, w[:2], tile_dtype="float32")
    assert torch.equal(got, (x[0].float() * w[0].float()).double()
                       + (x[1].float() * w[1].float()).double())
    with pytest.raises(ValueError, match="base=None"):
        agg_reduce.weighted_sum(x, w[:2], base=x[0].clone(),
                                tile_dtype="float32")
    with pytest.raises(ValueError, match="tile_dtype"):
        agg_reduce.weighted_sum(x, w[:2], tile_dtype="float16")


def test_scatter_wsum_on_cpu_runs_the_twin_and_counts_no_launch():
    rng = np.random.default_rng(91)
    acc = torch.from_numpy(rng.normal(0, 1, 5000))
    vals = torch.from_numpy(rng.integers(-127, 128, 300, dtype=np.int8))
    scales = torch.from_numpy(rng.uniform(1e-3, 1e-2, 3)
                              .astype(np.float32))
    dest = torch.from_numpy(np.sort(rng.choice(5000, 300, replace=False)))
    want = acc.clone()
    r = (vals.float() * scales[(700 + torch.arange(300)) // 1024]).double()
    want[dest] = want[dest] + r * 2.5
    before = agg_reduce.LAUNCHES["scatter_wsum"]
    agg_reduce.scatter_wsum(acc, dest, vals, 2.5, scales=scales, pos0=700)
    assert agg_reduce.LAUNCHES["scatter_wsum"] == before
    assert torch.equal(acc, want)
    f = torch.from_numpy(rng.normal(0, 1, 40).astype(np.float32))
    agg_reduce.scatter_wsum(acc, slice(10, 50), f, 0.5)
    want[10:50] = want[10:50] + f.double() * 0.5
    assert torch.equal(acc, want)
    agg_reduce.scatter_wsum(acc, 3, f[:0], 0.5)        # nnz = 0: a no-op
    assert torch.equal(acc, want)


@pytest.mark.parametrize("bad", ["index_high", "index_low", "slice_end",
                                 "scales_short", "no_scales", "f32_scales",
                                 "acc_dtype", "vals_dtype", "dest_len",
                                 "slice_step"])
def test_scatter_wsum_refuses_writes_outside_acc_and_bad_operands(bad):
    acc = torch.zeros(100, dtype=torch.float64)
    vals = torch.ones(4, dtype=torch.int8)
    kw = dict(scales=torch.ones(1, dtype=torch.float32))
    dest = torch.tensor([0, 5, 9, 99])
    if bad == "index_high":
        dest = torch.tensor([0, 5, 9, 100])
    elif bad == "index_low":
        dest = torch.tensor([-1, 5, 9, 10])
    elif bad == "slice_end":
        dest = 97
    elif bad == "scales_short":
        kw["pos0"] = 1022
    elif bad == "no_scales":
        kw = {}
    elif bad == "f32_scales":
        vals = vals.float()
    elif bad == "acc_dtype":
        acc = acc.float()
    elif bad == "vals_dtype":
        vals = vals.to(torch.int32)
    elif bad == "dest_len":
        dest = dest[:3]
    else:
        dest = slice(0, 8, 2)
    before = acc.clone()
    with pytest.raises((IndexError, TypeError, ValueError)):
        agg_reduce.scatter_wsum(acc, dest, vals, 1.0, **kw)
    assert torch.equal(acc, before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "float16", "bfloat16", "float32",
                                   "float64"])
@pytest.mark.parametrize("clients", [1, 3, 16])
@pytest.mark.parametrize("with_acc", [False, True])
def test_f32_tile_kernel_matches_plain_twin_on_card(cuda_device, dtype,
                                                    clients, with_acc):
    """fp32 tiles: bitwise the twin, and within the reference's rtol 1e-4
    / atol 1e-5 of the fp64 tiles."""
    rng = np.random.default_rng(100 + clients)
    n = 3 * 1024 + 77
    scales = None
    if dtype == "int8":
        data, scales = _q8_stack(rng, clients, n)
    else:
        data = torch.from_numpy(rng.normal(0, 1, (clients, n))) \
            .to(getattr(torch, dtype))
    w = torch.from_numpy(rng.uniform(0.1, 2.0, clients))
    acc = torch.from_numpy(rng.normal(0, 1, n)) if with_acc else None
    args = dict(scales=scales, acc=acc)
    want = agg_reduce.weighted_sum_plain(data, w, tile_dtype="float32",
                                         **args)
    dev = {k: None if v is None else v.to(cuda_device)
           for k, v in args.items()}
    got = agg_reduce.weighted_sum(data.to(cuda_device), w.to(cuda_device),
                                  tile_dtype="float32", **dev)
    f64 = agg_reduce.weighted_sum(data.to(cuda_device), w.to(cuda_device),
                                  **dev)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    torch.testing.assert_close(got, f64, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("nnz", [1, 777, 100_000])
@pytest.mark.parametrize("slice_dest", [True, False])
def test_scatter_wsum_kernel_matches_plain_twin_on_card(cuda_device, q8,
                                                        nnz, slice_dest):
    rng = np.random.default_rng(nnz)
    m, pos0 = 1_000_003, 1000          # pos0: windows straddle a qchunk
    acc = torch.from_numpy(rng.normal(0, 1, m))
    scales = None
    if q8:
        vals = torch.from_numpy(rng.integers(-127, 128, nnz, dtype=np.int8))
        scales = torch.from_numpy(rng.uniform(
            1e-4, 1e-2, -(-(pos0 + nnz) // 1024)).astype(np.float32))
    else:
        vals = torch.from_numpy(rng.normal(0, 1, nnz).astype(np.float32))
    dest = 12_345 if slice_dest else torch.from_numpy(
        np.sort(rng.choice(m, nnz, replace=False)))
    want = acc.clone()
    agg_reduce.scatter_wsum_plain(want, dest, vals, 2.5, scales=scales,
                                  pos0=pos0 if q8 else 0)
    got = acc.to(cuda_device)
    before = agg_reduce.LAUNCHES["scatter_wsum"]
    agg_reduce.scatter_wsum(got, dest, vals, 2.5, scales=scales,
                            pos0=pos0 if q8 else 0)
    torch.cuda.synchronize()
    assert agg_reduce.LAUNCHES["scatter_wsum"] == before + 1
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))
