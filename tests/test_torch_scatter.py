"""The 0xF5 sparse fold's kernel, ``scatter_wsum``, and the torch backend's
fold path around it.

On the CPU:

- numpy models of the kernel's index arithmetic, with its positions per
  lane (kPer) read from ``csrc/scatter_wsum.cu``: a warp's staging of a
  stream (16-byte blocks between a scalar head and tail) copies every
  element once, for every offset of the stream (int8, fp32, int64), each
  block aligned; the chunks and lanes (and a slice's double2 pairs) cover
  every position once; and a chunk's scale window, divided out once and
  stepped by each lane at the qchunk edges, equals ``(pos0 + p) //
  qchunk``;
- a COO arrival's values, scales and index are staged once per arrival
  and device, whatever the shard count (1, 3, 8), and every index handed
  to ``scatter_wsum`` is a slice of that one staged index (shifted by
  ``lo`` on the device when the shard starts past 0); the sharded fold,
  with its spans at ``lo > 0``, stays bitwise the numpy engine; a ranges
  arrival stages no index;
- the wrapper raises ``IndexError`` on an index outside ``acc`` (on the
  host, checked after its copy to ``acc``'s device) and leaves ``acc``
  untouched.

On the card (marked ``cuda``; skipped elsewhere): the kernel bitwise its
twin at its edges (nnz 1, 2, 31, 33, 63, 65 -- a warp's chunk, a slice's
chunk, +- 1 -- and 100,003; pos0 0, 1000 and
1023; values at an odd byte offset; the index on the card or on the host;
the slice path at an odd start), the floor entry point, and the fold's
page-locked staging.  This file imports only the port and numpy:
``python -m pytest -q -m cuda tests/test_torch_scatter.py`` runs on the
card.
"""
import os, re, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

import repro_torch.fl.agg_kernels as TK
import repro_torch.fl.flat as TF
from repro_torch.kernels import _build
from repro_torch.kernels import agg_reduce

_SRC = (_build.CSRC / "scatter_wsum.cu").read_text()
#: positions a lane takes in a chunk (the kernel's kPer; a slice's lane
#: takes whole pairs); a warp stages 32 times as many
PER = int(re.search(r"constexpr int kPer = (\d+);", _SRC).group(1))
SLICE_PER = 2 if PER == 1 else PER
CHUNK, SLICE_CHUNK = 32 * PER, 32 * SLICE_PER


def _offsets(slice_dest: bool):
    """(32, lane positions) chunk offsets of each lane, in its order: L +
    32 k, or a slice's pairs 2L + 64 (k // 2) + k % 2."""
    lane = np.arange(32)[:, None]
    if slice_dest:
        k = np.arange(SLICE_PER)[None, :]
        return 2 * lane + 64 * (k // 2) + k % 2
    return lane + 32 * np.arange(PER)[None, :]


# ---------------------------------------------------------------------------
# the kernel's index arithmetic, modelled in numpy
# ---------------------------------------------------------------------------
def _stage_split(off: int, n: int, esz: int):
    """``stage<ESZ>``'s copies of n elements whose first byte lies ``off``
    bytes past a 16-byte boundary: the stage byte each element lands at
    (element i at off + i*esz), and the copies as (first element, count,
    stage byte of the first) -- the 16-byte blocks of the body, then the
    head and tail one element a lane."""
    a, b = off, off + n * esz
    A, B = -(-a // 16) * 16, b // 16 * 16
    copies = []
    nh, nt = n, 0
    if A < B:
        for k in range((B - A) // 16):
            copies.append(((A - a) // esz + 16 * k // esz, 16 // esz,
                           off + (A - a) + 16 * k))
        nh, nt = (A - a) // esz, (b - B) // esz
    assert nh <= 32 and nt <= 32
    copies += [(i, 1, off + i * esz) for i in range(nh)]
    copies += [((B - a) // esz + i, 1, off + (B - a) + i * esz)
               for i in range(nt)]
    return copies


@pytest.mark.parametrize("esz", [1, 4, 8])
def test_stage_copies_every_element_once_and_blocks_aligned(esz):
    """int8 and fp32 values, the int64 index: every element offset of a
    stream and every length up to a chunk: the head, the 16-byte
    blocks and the tail copy each element once, to its own stage byte;
    each block is read from and written to 16-byte boundaries, and the
    stage holds kChunk * esz + 16 bytes."""
    lengths = range(1, max(CHUNK, SLICE_CHUNK) + 1)
    for off in range(0, 16, esz):
        for n in lengths:
            seen = np.zeros(n, np.int64)
            for first, count, at in _stage_split(off, n, esz):
                seen[first:first + count] += 1
                assert at == off + first * esz
                if count > 1:
                    assert count * esz == 16 and at % 16 == 0
            assert (seen == 1).all(), (off, n)
            assert off + n * esz <= max(CHUNK, SLICE_CHUNK) * esz + 16


@pytest.mark.parametrize("slice_dest", [False, True])
def test_chunks_and_lanes_cover_every_position_once(slice_dest):
    """The launch's chunks of [head, nnz) (head 1 only for a slice whose
    acc run starts 8 bytes past a 16-byte boundary) and each warp's lanes:
    every position once, a slice's double2 pairs on 16-byte boundaries of
    acc."""
    chunk = SLICE_CHUNK if slice_dest else CHUNK
    off = _offsets(slice_dest)
    for mis in ((0, 1) if slice_dest else (0,)):
        for nnz in list(range(0, 4 * chunk + 3)) + [100_003]:
            head = 1 if slice_dest and mis and nnz else 0
            nchunks = -(-(nnz - head) // chunk)
            seen = np.zeros(nnz, np.int64)
            seen[:head] += 1
            for g in range(nchunks):
                p = head + g * chunk
                n = min(chunk, nnz - p)
                if slice_dest:
                    first = off[:, 0::2]
                    pair = first + 1 < n
                    assert ((mis + p + first[pair]) % 2 == 0).all()
                seen[p + off[off < n]] += 1
            assert (seen == 1).all(), (mis, nnz)


@pytest.mark.parametrize("slice_dest", [False, True])
@pytest.mark.parametrize("qchunk", [1, 2, 3, 10, 31, 32, 33, 64, 1000,
                                    1024])
def test_chunk_scale_walk_is_floor_division(qchunk, slice_dest):
    """The scale window (``chunk_window`` and ``Walk``): one division for a
    chunk's first position P, ``e0`` the offset of its next edge; each lane
    steps the window at the edges up to each of its offsets in turn.  Equal
    to ``(P + offset) // qchunk`` at every offset of every lane, for every
    chunk start P up to 3000 (pos0 0 and 1000); a lane needs the window
    after the first edge only where that edge lies in the chunk, which is
    when the kernel loads its scale up front."""
    chunk = SLICE_CHUNK if slice_dest else CHUNK
    off = _offsets(slice_dest)
    for pos0 in (0, 1000):
        P = pos0 + np.arange(0, 3000, dtype=np.int64)[:, None]
        win0 = P // qchunk
        e0 = (win0 + 1) * qchunk - P
        for lane in range(32):
            win, e = win0.copy(), e0.copy()
            for rel in off[lane]:
                while True:
                    step = rel >= e
                    if not step.any():
                        break
                    win, e = win + step, e + qchunk * step
                np.testing.assert_array_equal(win, (P + rel) // qchunk)
                needs = win == win0 + 1
                assert (e0[needs] < chunk).all()


# ---------------------------------------------------------------------------
# the fold path: one staging per arrival and device
# ---------------------------------------------------------------------------
SHAPES = ((33, 17), (1500,), (2, 3, 5), (4096,), (3000,))


def _layout_and_base():
    rng = np.random.default_rng(3)
    arrays = [rng.normal(0, 0.5, s).astype(np.float32) for s in SHAPES]
    layout = TF.layout_of(arrays)
    return layout, TF.FlatParams.from_arrays(arrays, layout)


def _arrivals(layout, base, imode, vmode, count=3, seed=11):
    rng = np.random.default_rng(seed)
    n = layout.total_size
    out = []
    for c in range(count):
        if imode == "coo":
            idx = np.sort(rng.choice(n, n // 20, replace=False)) \
                .astype(np.int64)
            nnz = idx.size
        else:
            starts = np.arange(10 + c, n - 60, 701)
            idx = np.stack([starts, starts + 50], 1).astype(np.int64)
            nnz = 50 * len(starts)
        vals = rng.normal(0, 1e-3, nnz).astype(np.float32)
        scales = None
        if vmode == "q8":
            vals, scales = TF.quantize_int8(vals)
        out.append(TF.SparseDelta(layout, imode, idx, vals, scales,
                                  base=base))
    return out


@pytest.fixture
def recorded(monkeypatch):
    """Count ``_stage_sparse`` calls (arrival, device, staged index) and
    record every ``scatter_wsum`` call's destination."""
    rec = {"stages": [], "calls": []}
    stage, scatter = TK.StreamingWeightedSum._stage_sparse, \
        agg_reduce.scatter_wsum

    def counting_stage(self, sp, dev, staged):
        new = dev not in staged
        out = stage(self, sp, dev, staged)
        if new:
            rec["stages"].append((sp, dev, out[2]))
        return out

    def recording_scatter(acc, dest, vals, w, **kw):
        rec["calls"].append((acc, dest, kw.get("pos0", 0), vals.numel()))
        return scatter(acc, dest, vals, w, **kw)

    monkeypatch.setattr(TK.StreamingWeightedSum, "_stage_sparse",
                        counting_stage)
    monkeypatch.setattr(agg_reduce, "scatter_wsum", recording_scatter)
    return rec


@pytest.mark.parametrize("shards", [None, 1, 3, 8])
@pytest.mark.parametrize("vmode", ["q8", "f32"])
def test_coo_arrival_is_staged_once_and_each_span_is_a_slice_of_it(
        recorded, shards, vmode):
    layout, base = _layout_and_base()
    arrivals = _arrivals(layout, base, "coo", vmode)
    s = TK.StreamingWeightedSum(layout, backend="torch", device="cpu",
                                shards=shards)
    for i, sp in enumerate(arrivals):
        s.add(sp, 10.0 + i)
    assert [st[0] for st in recorded["stages"]] == arrivals
    bounds = s._bounds if shards else [(0, layout.total_size)]
    nonempty = [(lo, hi) for lo, hi in bounds if hi > lo]
    assert len(recorded["calls"]) == len(arrivals) * len(nonempty)
    calls = iter(recorded["calls"])
    for sp, _, index in recorded["stages"]:
        assert index is not None and index.dtype == torch.int64
        assert index.data_ptr() == sp.indices.ctypes.data    # no host copy
        for lo, hi in nonempty:
            acc, dest, pos0, nnz = next(calls)
            i0, i1 = np.searchsorted(sp.indices, (lo, hi))
            assert (pos0, nnz) == (i0, i1 - i0)
            assert acc.numel() == hi - lo
            assert torch.equal(dest, index[i0:i1] - lo)
            if lo == 0:      # the span is a view of the staged index
                assert dest.data_ptr() == index[i0:i1].data_ptr()
    if shards and shards > 1:
        assert any(lo > 0 for lo, _ in nonempty)


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("vmode", ["q8", "f32"])
def test_sharded_fold_at_lo_above_zero_is_bitwise_the_numpy_engine(
        shards, vmode):
    layout, base = _layout_and_base()
    arrivals = _arrivals(layout, base, "coo", vmode, count=4, seed=12)
    outs = []
    for kw in ({"backend": "torch", "device": "cpu", "shards": shards},
               {"backend": "torch", "device": "cpu"},
               {"backend": "numpy", "shards": shards, "overlap": False},
               {"backend": "numpy"}):
        s = TK.StreamingWeightedSum(layout, **kw)
        for i, sp in enumerate(arrivals):
            s.add(sp, 10.0 + 3 * i)
        outs.append(s.finalize().buf.tobytes())
    assert outs[0] == outs[1] == outs[2] == outs[3]


def test_ranges_arrival_stages_no_index(recorded):
    layout, base = _layout_and_base()
    arrivals = _arrivals(layout, base, "ranges", "q8")
    s = TK.StreamingWeightedSum(layout, backend="torch", device="cpu",
                                shards=3)
    for i, sp in enumerate(arrivals):
        s.add(sp, 1.0 + i)
    assert len(recorded["stages"]) == len(arrivals)
    assert all(st[2] is None for st in recorded["stages"])
    assert all(isinstance(c[1], int) for c in recorded["calls"])


# ---------------------------------------------------------------------------
# the wrapper's check of a host index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("bad", [-1, 5000, 1 << 40])
def test_wrapper_raises_on_an_out_of_range_host_index(where, bad):
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.normal(0, 1, 5000))
    idx = np.sort(rng.choice(4999, 777, replace=False)).astype(np.int64)
    at = {"first": 0, "middle": 388, "last": 776}[where]
    idx[at] = bad
    vals = torch.from_numpy(rng.integers(-127, 128, 777, dtype=np.int8))
    scales = torch.from_numpy(rng.uniform(1e-3, 1e-2, 1).astype(np.float32))
    before = acc.clone()
    with pytest.raises(IndexError, match="outside acc"):
        agg_reduce.scatter_wsum(acc, torch.from_numpy(idx), vals, 2.0,
                                scales=scales)
    assert torch.equal(acc, before)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scatter_wsum kernel runs only "
                    "there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("nnz", [1, 2, 31, 33, 63, 65, 100_003])
@pytest.mark.parametrize("pos0", [0, 1000, 1023])
@pytest.mark.parametrize("voff", [0, 5])
@pytest.mark.parametrize("index", ["card", "host", "slice"])
def test_scatter_wsum_kernel_edges_match_plain_twin_on_card(
        cuda_device, q8, nnz, pos0, voff, index):
    """Values a view at element ``voff`` (an odd byte offset for int8),
    the index a view at an odd element of a longer one on the card, or on
    the host, or the slice path at an odd start; bitwise the twin."""
    rng = np.random.default_rng(nnz + pos0 + voff)
    m = 1_000_003
    acc = torch.from_numpy(rng.normal(0, 1, m))
    scales = None
    if q8:
        raw = torch.from_numpy(rng.integers(-127, 128, voff + nnz,
                                            dtype=np.int8))
        scales = torch.from_numpy(rng.uniform(
            1e-4, 1e-2, -(-(pos0 + nnz) // 1024)).astype(np.float32))
    else:
        raw = torch.from_numpy(rng.normal(0, 1, voff + nnz)
                               .astype(np.float32))
    vals = raw.to(cuda_device)[voff:]
    p0 = pos0 if q8 else 0
    if index == "slice":
        dest, twin_dest = 12_345, 12_345
    else:
        full = torch.from_numpy(np.sort(rng.choice(m, nnz + 1,
                                                   replace=False)))
        twin_dest = full[1:]
        dest = full.to(cuda_device)[1:] if index == "card" else twin_dest
    want = acc.clone()
    agg_reduce.scatter_wsum_plain(want, twin_dest, vals.cpu(), 2.5,
                                  scales=scales, pos0=p0)
    got = acc.to(cuda_device)
    before = agg_reduce.LAUNCHES["scatter_wsum"]
    agg_reduce.scatter_wsum(got, dest, vals, 2.5, scales=scales, pos0=p0)
    torch.cuda.synchronize()
    assert agg_reduce.LAUNCHES["scatter_wsum"] == before + 1
    assert torch.equal(got.cpu().view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_scatter_floor_adds_its_constant_on_card(cuda_device):
    lib = agg_reduce._kernel_lib("scatter_wsum")
    rng = np.random.default_rng(9)
    idx = torch.from_numpy(np.sort(rng.choice(100_000, 4_099,
                                              replace=False)))
    acc = torch.zeros(100_000, dtype=torch.float64, device=cuda_device)
    d = idx.to(cuda_device)
    err = lib.repro_scatter_floor(acc.data_ptr(), d[1:].data_ptr(), 1.5,
                                  d.numel() - 1,
                                  torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    want = torch.zeros(100_000, dtype=torch.float64)
    want[idx[1:]] = 1.5
    assert torch.equal(acc.cpu(), want)


@pytest.mark.cuda
def test_pinned_stage_sends_the_arrays_to_the_card(cuda_device):
    rng = np.random.default_rng(10)
    arrays = (rng.integers(-127, 128, 13, dtype=np.int8), None,
              rng.normal(0, 1, 7).astype(np.float32),
              np.sort(rng.choice(1 << 40, 5, replace=False)))
    stage = agg_reduce.PinnedStage()
    for _ in range(2):             # the buffer reused
        out = stage.to_device(arrays, cuda_device)
        assert out[1] is None
        for a, t in zip(arrays, out):
            if a is not None:
                assert t.device.type == "cuda" and t.dtype == \
                    torch.from_numpy(a).dtype
                assert np.array_equal(t.cpu().numpy(), a)
    big = (np.arange(3 * agg_reduce.PinnedStage.CHUNK // 8 + 3),)
    out = stage.to_device(big, cuda_device)
    assert np.array_equal(out[0].cpu().numpy(), big[0])
