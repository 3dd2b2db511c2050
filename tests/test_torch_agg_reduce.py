"""The kernel wrappers of ``repro_torch.kernels.agg_reduce``:
``weighted_sum`` (fp64 and fp32 tiles), ``sort_reduce``, ``gram`` and
``scatter_wsum``.

On a CPU tensor a wrapper runs the plain twin and counts no launch; it
rejects inputs the kernel does not take; on the card (tests marked
``cuda``, skipped elsewhere) the CUDA kernel equals the twin bitwise
(``weighted_sum`` in both tile types, ``sort_reduce``, NaN and signed-zero
columns included, ``scatter_wsum``)
or within ``rtol=1e-9`` of it and bitwise equal to itself from launch to
launch (``gram``), also at the register paths' edges: every CMAX bucket
boundary, N at every stage width +-1, ragged row starts, qchunk not
dividing a stage, every payload kind with and without a base.  Here, the
sorting networks the kernel reads from ``csrc/sort_net.cuh`` are checked
(every 0/1 input up to 16, random keys with ties at 32 and 64), and the
argument for 32-bit keys.  This file imports only the port, so the
``cuda`` tests run on a machine without JAX:
``python -m pytest -q -m cuda tests/test_torch_agg_reduce.py``.
"""
import os, re, sys  # noqa: E401
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
# the robust kernels' register paths: sorting networks, 32-bit keys, stages
# ---------------------------------------------------------------------------
_NET_HEADER = os.path.join(os.path.dirname(__file__), "..", "src_torch",
                           "repro_torch", "kernels", "csrc", "sort_net.cuh")
#: exchanges of each bucket's network: the optimal 1, 5, 19, Green's 60 at
#: 16, Batcher's odd-even merge sort at 32 and 64
NET_SIZES = {2: 1, 4: 5, 8: 19, 16: 60, 32: 191, 64: 543}


def _networks():
    """{n: [(i, j), ...]} as ``csrc/sort_net.cuh`` lists them for the
    kernel (``REPRO_SORT_NET_<n>(X)``, one ``X(i, j)`` per exchange)."""
    with open(_NET_HEADER) as f:
        text = f.read()
    nets = {}
    for m in re.finditer(r"#define REPRO_SORT_NET_(\d+)\(X\)"
                         r"((?:[^\n]*\\\n)*[^\n]*)", text):
        nets[int(m.group(1))] = [(int(a), int(b)) for a, b in re.findall(
            r"X\((\d+), (\d+)\)", m.group(2))]
    return nets


def _run_network(net, keys):
    """Apply the exchanges to each row of ``keys`` (min to i, max to j)."""
    k = keys.copy()
    for i, j in net:
        lo, hi = np.minimum(k[:, i], k[:, j]), np.maximum(k[:, i], k[:, j])
        k[:, i], k[:, j] = lo, hi
    return k


def test_sort_net_header_lists_one_network_per_bucket():
    nets = _networks()
    assert {n: len(v) for n, v in nets.items()} == NET_SIZES
    for n, net in nets.items():
        assert all(0 <= i < j < n for i, j in net), n


@pytest.mark.parametrize("n", [2, 4, 8, 16])
def test_sort_networks_sort_every_0_1_input(n):
    """The 0-1 principle: a comparator network that sorts all 2^n inputs of
    zeros and ones sorts every input."""
    x = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1).astype(np.int8)
    got = _run_network(_networks()[n], x)
    assert (np.diff(got, axis=1) >= 0).all()
    assert np.array_equal(got.sum(1), x.sum(1))


@pytest.mark.parametrize("n", [32, 64])
def test_sort_networks_sort_random_keys_with_ties(n):
    """Batcher's networks on random keys drawn from a few values (ties), with
    the kernel's pad keys above the top C < n rows, against np.sort; the
    median's ranks lo and hi and every trimmed range come out right."""
    rng = np.random.default_rng(n)
    net = _networks()[n]
    for c in (n // 2 + 1, n - 1, n):
        keys = rng.integers(0, 7, (4000, n)).astype(np.uint32)
        keys[:, c:] = 0xFFFFFFFF
        got = _run_network(net, keys)
        assert np.array_equal(got, np.sort(keys, axis=1)), c
        lo, hi = (c - 1) // 2, c // 2
        want = np.sort(keys[:, :c], axis=1)
        assert np.array_equal(got[:, [lo, hi]], want[:, [lo, hi]])


def _key64(x):
    """The kernels' 64-bit order key of fp64 values (NaN above +inf)."""
    u = x.view(np.uint64)
    k = np.where(u >> np.uint64(63), ~u, u | np.uint64(1 << 63))
    return np.where(np.isnan(x), np.uint64(0xFFF8000000000000), k)


def _key32(f):
    """The kernels' 32-bit order key of fp32 values (NaN above +inf)."""
    u = f.view(np.uint32)
    k = np.where(u >> np.uint32(31), ~u, u | np.uint32(1 << 31))
    return np.where(np.isnan(f), np.uint32(0xFFC00000), k)


def test_32_bit_keys_order_like_the_widened_64_bit_keys():
    """Where the decoded value is exactly an fp32, its 32-bit key sorts a
    column in the same order as the 64-bit key of the value widened to fp64
    (widening is exact and increasing, keeps -0 < +0, and every NaN maps to
    one key above +inf), so both pick the same elements."""
    rng = np.random.default_rng(17)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                         3.4e38, -3.4e38, 1.0, -1.0], dtype=np.float32)
    nan_bits = np.array([0x7FC00001, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                        dtype=np.uint32).view(np.float32)
    f = np.concatenate([
        rng.normal(0, 1, 3000).astype(np.float32),
        (rng.integers(-127, 128, 3000).astype(np.float32)
         * np.float32(1e-40)),                           # subnormal int8
        specials, nan_bits,
        rng.integers(0, 2 ** 32, 3000, dtype=np.uint64).astype(np.uint32)
        .view(np.float32)])                              # every bit pattern
    with np.errstate(invalid="ignore"):           # signalling NaNs widen
        k32, k64 = _key32(f), _key64(f.astype(np.float64))
    o32, o64 = np.argsort(k32, kind="stable"), np.argsort(k64, kind="stable")
    assert np.array_equal(o32, o64)
    assert np.array_equal(k32[o32][1:] == k32[o32][:-1],
                          k64[o64][1:] == k64[o64][:-1])
    assert (k32[np.isnan(f)] > _key32(np.array([np.inf], np.float32))).all()


def test_32_bit_keys_of_decoded_values_order_the_based_values():
    """A delta payload adds one fp64 base b to every row of a column; for a
    finite b, x -> fl(x + b) is non-decreasing and keeps NaN, so sorting the
    decoded fp32 values by their 32-bit keys and then adding b gives the
    sorted based values (equal as reals; NaNs last)."""
    rng = np.random.default_rng(18)
    rows, c = 20000, 16
    x = (rng.integers(-127, 128, (rows, c)).astype(np.float32)
         * (10.0 ** rng.uniform(-40, 3, (rows, 1))).astype(np.float32))
    x[:200] = rng.choice(np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                                   1.0, -1.0], np.float32), (200, c))
    b = rng.normal(0, 1, rows) * 10.0 ** rng.uniform(-45, 45, rows)
    b[200:400] = -x[200:400, 0].astype(np.float64)      # exact cancellation
    b[400:600] = 0.0
    b[600:800] = -0.0
    with np.errstate(invalid="ignore"):
        order = np.argsort(_key32(x), axis=1, kind="stable")
        got = np.take_along_axis(x, order, axis=1).astype(np.float64) \
            + b[:, None]
        want = np.sort(x.astype(np.float64) + b[:, None], axis=1)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("b", [np.inf, -np.inf, np.nan])
def test_a_non_finite_base_reduces_by_a_count_of_nans(b):
    """A column whose base is +-inf or NaN is not sorted: every based value
    is b or NaN (x NaN, x = -b, or b NaN), so the median is NaN if one is
    NaN, else b, and the sum of sorted rows [k, C - k) is NaN if more than
    k are NaN, else b -- numpy's sort and reductions on x + b."""
    rng = np.random.default_rng(19)
    c = 9
    vals = np.array([1.0, -2.0, 0.0, -0.0, np.inf, -np.inf, np.nan],
                    np.float32)
    for _ in range(300):
        x = rng.choice(vals, c)
        with np.errstate(invalid="ignore"):
            s = np.sort(x.astype(np.float64) + b)
            nans = int(np.sum(np.isnan(x) | (x.astype(np.float64) == -b)
                              | np.isnan(b)))
        med = np.nan if nans else b
        assert np.array_equal(med, np.median(s), equal_nan=True)
        for k in range(c // 2 + 1):
            acc = 0.0
            with np.errstate(invalid="ignore"):
                for r in s[k:c - k]:
                    acc = acc + r
            assert np.array_equal(np.nan if nans > k else b, acc,
                                  equal_nan=True), (x, k)


#: C at every CMAX bucket boundary of the register paths
BOUNDARY_CLIENTS = [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64]
#: N: tiny, one less and one more than every stage width the kernels use
#: (64 to 1024 columns), and an odd N (no row start 16-byte aligned)
EDGE_N = [1, 3, 63, 65, 127, 129, 255, 257, 511, 513, 1023, 1025, 6923]
EDGE_KINDS = [k + b for k in KINDS if k != "int8_base"
              for b in ("", "_base")]


def _edge_stack(kind, c, n, rng, qchunk, specials, offset):
    """A (C, N) stack for the edge grid: any payload kind, with a base when
    ``kind`` ends in ``_base``, NaN and signed-zero columns where N has
    room, and the data at a storage offset of ``offset`` elements (still
    contiguous; row 0 starts that far past a 16-byte boundary)."""
    dt = kind[:-5] if kind.endswith("_base") else kind
    scales = None
    if dt == "int8":
        q = rng.integers(-127, 128, (c, n), dtype=np.int8)
        flat = torch.from_numpy(np.concatenate(
            [np.zeros(offset, np.int8), q.ravel()]))
        s = 10.0 ** rng.uniform(-40, -1, (c, -(-n // qchunk)))
        if specials:
            s[-1, 0] = np.nan
            s[0, -1] = -0.0
        scales = torch.from_numpy(s.astype(np.float32))
    else:
        x = rng.normal(0, 2, (c, n))
        if specials:
            x[:, 0] = rng.choice([-0.0, 0.0], c)
            if n > 2:
                x[:, 1] = rng.choice([-0.0, 0.0, 1.0, -1.0], c)
                x[rng.integers(0, c, 2), rng.integers(1, n, 2)] = np.nan
            x[:, n - 1] = np.nan
        flat = torch.from_numpy(np.concatenate(
            [np.zeros(offset), x.ravel()])).to(getattr(torch, dt))
    data = flat[offset:].view(c, n)
    base = None
    if kind.endswith("_base"):
        b = rng.normal(0, 1, n)
        if specials:                 # columns whose base is not finite
            b[0] = np.inf
            b[n // 2] = -np.inf
            b[n - 1 - n // 3] = np.nan
        base = torch.from_numpy(b)
    return data, dict(scales=scales, qchunk=qchunk, base=base)


def _edge_cases(c):
    """(N, qchunk, storage offset) of the edge grid for C clients: qchunk
    1024, 1000 and 3 in turn (1000 and 3 divide no stage width)."""
    return [(n, (1024, 1000, 3)[i % 3], (i + c) % 2)
            for i, n in enumerate(EDGE_N)]


def _to(kw, dev):
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in kw.items()}


def _on_card(data, dev):
    """``data`` on the card at the same storage offset (so its rows keep
    their alignment)."""
    off = data.storage_offset()
    flat = torch.empty(off + data.numel(), dtype=data.dtype, device=dev)
    flat[off:] = data.reshape(-1).to(dev)
    return flat[off:].view(data.shape)


def test_edge_stacks_on_cpu_run_the_twins():
    """The edge grid's stacks (storage offsets, tiny N, any kind with a
    base) through the wrappers on the CPU: the twins, no launch."""
    rng = np.random.default_rng(33)
    before = dict(agg_reduce.LAUNCHES)
    for kind in ("int8_base", "float16", "float32_base"):
        data, kw = _edge_stack(kind, 5, 3, rng, 3, True, 1)
        assert data.storage_offset() == 1 and data.is_contiguous()
        med = agg_reduce.sort_reduce(data, kind="median", **kw)
        x = agg_reduce._decoded_plain(data, kw["scales"], 3, kw["base"])
        fin = ~torch.isnan(x).any(0)
        s = torch.sort(x, dim=0).values
        assert torch.equal(med[fin], (0.0 + s[2])[fin])
        assert torch.isnan(med[~fin]).all()
    assert agg_reduce.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("clients", BOUNDARY_CLIENTS)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_sort_reduce_kernel_at_the_edges_matches_twin_on_card(
        cuda_device, kind, clients):
    """Every CMAX bucket boundary, N at every stage width +-1, ragged row
    starts, qchunk not dividing a stage, every kind with and without a
    base, NaN and signed-zero columns: bitwise the twin."""
    rng = np.random.default_rng(clients)
    for n, qchunk, off in _edge_cases(clients):
        data, kw = _edge_stack(kind, clients, n, rng, qchunk, True, off)
        dev = _to(kw, cuda_device)
        ddata = _on_card(data, cuda_device)
        for op, k in [("median", 0)] + [("trim_sum", k) for k in
                                        sorted({0, 1, clients // 3})
                                        if clients - 2 * k >= 1]:
            want = agg_reduce.sort_reduce_plain(data, kind=op, trim_k=k,
                                                **kw)
            got = agg_reduce.sort_reduce(ddata, kind=op, trim_k=k, **dev)
            torch.cuda.synchronize()
            assert torch.equal(_bits(got.cpu()), _bits(want)), \
                (n, qchunk, off, op, k)


@pytest.mark.cuda
@pytest.mark.parametrize("clients", BOUNDARY_CLIENTS)
@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_gram_kernel_at_the_edges_matches_twin_on_card(cuda_device, kind,
                                                       clients):
    """The same grid for ``gram``: within 1e-9 of the twin, bitwise equal
    across two launches."""
    rng = np.random.default_rng(clients)
    for n, qchunk, off in _edge_cases(clients):
        data, kw = _edge_stack(kind, clients, n, rng, qchunk, False, off)
        dev = _to(kw, cuda_device)
        ddata = _on_card(data, cuda_device)
        want = agg_reduce.gram_plain(data, **kw)
        got = agg_reduce.gram(ddata, **dev)
        again = agg_reduce.gram(ddata, **dev)
        torch.cuda.synchronize()
        assert torch.equal(_bits(got), _bits(again)), (n, qchunk, off)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-9, atol=1e-9,
                                   msg=lambda m: f"{(n, qchunk, off)}: {m}")


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
