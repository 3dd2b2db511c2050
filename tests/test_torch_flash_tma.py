"""The tensor-core flash kernel's host-side plan, on the CPU.

``csrc/flash_attention.cu``'s bf16 route loads its tiles by TMA through
tensor maps whose dims, byte strides and box the wrapper computes
(``flash_attention.tma_params``), runs fixed tiles per head dim
(``tc_rows``, ``tc_keys``, ``TC_STAGES``, ``tc_slab``, ``tc_smem_bytes``),
visits the key tiles its ``Item`` names and masks only the tiles its
``edge_tile`` marks (mirrored here by :func:`tc_tiles` and
:func:`tc_edge`).  None of that needs the card, so it is checked here:

- the tensor-map parameters against TMA's rules (a 16-byte aligned base,
  byte strides that are positive multiples of 16 below 2**40, box sides of
  at most 256, the inner box at most the swizzle's span) over contiguous
  tensors, head-sliced views and misaligned views, and which views the
  wrapper copies first (``_rows_aligned``);
- the tile plan per head dim, within the shared memory a block may use;
- the key-tile range and the edge predicate, exhaustively at small S, tile
  sizes and windows (and by hypothesis): every visible (q, k) pair lies in
  a visited tile, and a tile not marked as an edge needs no mask;
- that the committed ``csrc/wgmma.cuh`` is what ``tools/gen_wgmma.py``
  writes.

This file imports neither JAX nor the reference package.
"""
import itertools
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch",
                                "tools"))
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import flash_attention as FA

BF16 = torch.bfloat16


def _check_tma_rules(t, rows):
    dims, strides, box = FA.tma_params(t, rows)
    assert t.data_ptr() % 16 == 0
    assert len(dims) == len(box) == 4 and len(strides) == 3
    assert all(s > 0 and s % 16 == 0 and s < 1 << 40 for s in strides)
    assert all(1 <= b <= 256 for b in box)
    assert all(1 <= d < 1 << 32 for d in dims)
    hd = t.shape[3]
    slab = FA.tc_slab(hd)
    # the inner box is one slab's row, exactly the swizzle's span, and a
    # 16-byte multiple
    assert box[0] * t.element_size() == FA.TC_SWIZZLE[slab]
    # whole slabs cover the head dim, the last one past it at most by the
    # columns TMA zero-fills
    assert dims[0] == hd and FA.tc_padded(hd) % box[0] == 0
    assert hd <= FA.tc_padded(hd) < hd + slab
    return dims, strides, box


# ---------------------------------------------------------------------------
# tensor maps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
@pytest.mark.parametrize("B,S,H", [(4, 4500, 32), (1, 1, 1), (2, 129, 10)])
def test_tensor_map_of_a_contiguous_tensor(hd, B, S, H):
    t = torch.zeros((B, S, H, hd), dtype=BF16)
    assert FA._rows_aligned(t)
    rows = FA.tc_rows(hd)
    dims, strides, box = _check_tma_rules(t, rows)
    assert dims == (hd, S, H, B)
    assert box == (FA.tc_slab(hd), rows, 1, 1)
    # bytes: the sequence, the head, the batch (16 where the axis has one
    # entry and is never stepped)
    want = (H * hd * 2 if S > 1 else 16, hd * 2 if H > 1 else 16,
            S * H * hd * 2 if B > 1 else 16)
    assert strides == want


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tensor_map_of_head_sliced_views(hd):
    """q, k and v as views of one fused projection (B, S, H + 2 KV, hd):
    read in place through their strides, no copy."""
    B, S, H, KV = 2, 300, 8, 2
    qkv = torch.zeros((B, S, H + 2 * KV, hd), dtype=BF16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    for t, rows in ((q, FA.tc_rows(hd)), (k, FA.tc_keys(hd)),
                    (v, FA.tc_keys(hd))):
        assert FA._rows_aligned(t)
        dims, strides, _ = _check_tma_rules(t, rows)
        assert strides[0] == (H + 2 * KV) * hd * 2
        assert strides[2] == S * (H + 2 * KV) * hd * 2
        assert dims[2] == t.shape[2]
    # the views' bases differ by whole rows of heads
    assert (k.data_ptr() - q.data_ptr()) == H * hd * 2


def _views():
    """(name, view, copied first?): the views the wrapper takes as they are
    and those it makes contiguous before the launch."""
    big = torch.zeros((2, 8, 3, 88), dtype=BF16)
    odd = torch.zeros((1, 8, 2, 81), dtype=BF16)
    wide = torch.zeros((2, 16, 4, 64), dtype=BF16)
    return [
        ("contiguous", torch.zeros((2, 8, 3, 80), dtype=BF16), False),
        ("leading columns of wider rows", big[..., :80], False),
        ("columns 4-83: base 8 bytes in", big[..., 4:84], True),
        ("columns 8-87: base 16 bytes in", big[..., 8:88], False),
        ("rows of 81: strides of 162 bytes", odd[..., :80], True),
        ("every other position", wide[:, ::2], False),
        ("every other head", wide[:, :, ::2], False),
        ("one head of four, broadcast", wide[:, :, :1].expand(2, 16, 4, 64),
         True),
        ("one position, broadcast", wide[:, :1].expand(2, 16, 4, 64), True),
        ("heads before positions", wide.transpose(1, 2), False),
    ]


@pytest.mark.parametrize("name,view,copied", _views(),
                         ids=[v[0] for v in _views()])
def test_which_views_are_copied_before_the_launch(name, view, copied):
    """A view that breaks a TMA rule is copied to a contiguous tensor (the
    wrapper's ``t if _rows_aligned(t) else t.contiguous()``); the copy, and
    every view kept as it is, passes every rule."""
    assert FA._rows_aligned(view) == (not copied)
    rows = FA.tc_keys(view.shape[3])
    if copied:
        with pytest.raises(ValueError):
            FA.tma_params(view, rows)
        view = view.contiguous()
        assert FA._rows_aligned(view)
    _check_tma_rules(view, rows)


def test_tensor_map_refuses_what_tma_does_not_take():
    t = torch.zeros((1, 8, 2, 64), dtype=BF16)
    with pytest.raises(ValueError, match="box"):
        FA.tma_params(t, 257)
    with pytest.raises(ValueError, match="contiguous head dim"):
        FA.tma_params(torch.zeros((1, 8, 64, 2), dtype=BF16)
                      .transpose(2, 3), 64)


# ---------------------------------------------------------------------------
# the tile plan
# ---------------------------------------------------------------------------
#: per head dim: query rows, keys per tile, ring stages, slab columns
PLAN = {16: (192, 128, 2, 16), 32: (192, 128, 2, 32), 64: (192, 128, 2, 64),
        80: (192, 128, 2, 64), 128: (128, 128, 2, 64), 256: (128, 64, 2, 64)}


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tile_plan_per_head_dim(hd):
    rows, keys, stages, slab = PLAN[hd]
    assert (FA.tc_rows(hd), FA.tc_keys(hd), FA.TC_STAGES,
            FA.tc_slab(hd)) == PLAN[hd]
    # a consumer warpgroup's 64 rows; wgmma's k-steps of 16 keys and of 16
    # head-dim columns; slabs the head dim splits into
    assert rows % 64 == 0 and keys % 16 == 0 and hd % 16 == 0
    width = FA.tc_padded(hd)
    assert width % slab == 0 and slab in FA.TC_SWIZZLE
    # TMA boxes: at most 256 rows
    assert rows <= 256 and keys <= 256
    smem = FA.tc_smem_bytes(hd)
    tiles = (rows + 2 * stages * keys) * width * 2
    assert smem == FA.TC_ALIGN + tiles + FA.TC_BARRIER_BYTES
    assert smem <= FA.SMEM_LIMIT
    # every tile starts on the swizzle atom: the Q block, each stage's K
    # and V tile, and each slab of them
    for nbytes in (rows * width * 2, keys * width * 2, rows * slab * 2,
                   keys * slab * 2):
        assert nbytes % FA.TC_ALIGN == 0
    # the barriers: Q full and empty, four per stage, 8 bytes each
    assert 8 * (2 + 4 * stages) <= FA.TC_BARRIER_BYTES


def test_the_serving_head_dims_use_the_widest_swizzle():
    """Every serving head dim is read in 64-column slabs under the 128-byte
    swizzle: hd 80's 160-byte row as two, the second holding columns 64-79
    and zeros (TMA fills what lies past the row and reads no bytes
    there)."""
    for hd in (64, 80, 128, 256):
        assert FA.TC_SWIZZLE[FA.tc_slab(hd)] == 128
    assert FA.tc_padded(80) == 128
    assert [FA.tc_padded(hd) for hd in (16, 32, 64, 128, 256)] \
        == [16, 32, 64, 128, 256]


# ---------------------------------------------------------------------------
# key tiles and edges
# ---------------------------------------------------------------------------
def tc_tiles(q0, S, causal, window, rows, keys):
    """``(lo, ntiles)``: the key tiles ``[lo + t * keys, ...)`` that the
    tensor-core kernel's query block of ``rows`` rows at ``q0`` visits: the
    keys some row of the block can see, as the kernel's ``Item`` computes
    them."""
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(q0 + rows, S) if causal else S
    return lo, (-(-(hi - lo) // keys) if hi > lo else 0)


def tc_edge(t0, keys, a, rows, S, causal, window):
    """Whether keys ``[t0, t0 + keys)`` need a mask for query rows ``[a, a
    + rows)``: the tile straddles the causal diagonal, the window's lower
    edge or the end of the sequence (the kernel's ``edge_tile``; each
    consumer warpgroup asks it for its own 64 rows)."""
    return bool((causal and t0 + keys - 1 > a)
                or (window != 0 and t0 <= a + rows - 1 - window)
                or t0 + keys > S)


def _visible(qp, kp, S, causal, window):
    return (kp < S and (not causal or kp <= qp)
            and (window == 0 or kp > qp - window))


def _check_block(q0, S, causal, window, rows, keys, sub):
    lo, n = tc_tiles(q0, S, causal, window, rows, keys)
    assert lo >= 0 and n >= 0
    visited = range(lo, lo + n * keys)
    for qp in range(q0, min(q0 + rows, S)):
        for kp in range(S):
            if _visible(qp, kp, S, causal, window):
                assert kp in visited, (q0, qp, kp)
    # the first and the last tile each hold a key some row can see (but
    # where a negative window leaves a causal row no key at all: the
    # block then visits [lo, hi) and masks every score)
    for t in (0, n - 1) if n and not (causal and window < 0) else ():
        assert any(_visible(qp, kp, S, causal, window)
                   for qp in range(q0, min(q0 + rows, S))
                   for kp in range(lo + t * keys, lo + (t + 1) * keys))
    # each consumer's rows [a, a + sub) mask a tile only where it is an edge
    for t in range(n):
        t0 = lo + t * keys
        for a in range(q0, q0 + rows, sub):
            if not tc_edge(t0, keys, a, sub, S, causal, window):
                assert all(_visible(qp, kp, S, causal, window)
                           for qp in range(a, a + sub)
                           for kp in range(t0, t0 + keys)), (q0, t0, a)


@pytest.mark.parametrize("rows,keys,sub", [(8, 8, 4), (12, 8, 4),
                                           (16, 4, 8), (6, 16, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_key_tiles_and_edges_exhaustively(rows, keys, sub, causal):
    for S, window in itertools.product(range(1, 41),
                                       (0, 1, 2, 3, 5, 8, 17, 64, -3)):
        for q0 in range(0, S, rows):
            _check_block(q0, S, causal, window, rows, keys, sub)


@settings(max_examples=200, deadline=None)
@given(S=st.integers(1, 300), rows_subs=st.sampled_from(
    [(64, 64), (128, 64), (192, 64), (32, 16)]),
    keys=st.sampled_from([16, 32, 64, 128]),
    window=st.one_of(st.just(0), st.integers(-40, 300)),
    causal=st.booleans(), block=st.integers(0, 10))
def test_key_tiles_and_edges_at_kernel_sizes(S, rows_subs, keys, window,
                                             causal, block):
    rows, sub = rows_subs
    q0 = min(block, (S - 1) // rows) * rows
    _check_block(q0, S, causal, window, rows, keys, sub)


@pytest.mark.parametrize("hd,S,window,causal", [
    (80, 4500, 4096, True), (256, 4096, 2048, True), (64, 4096, 0, True),
    (128, 2048, 0, True), (64, 1500, 0, False)])
def test_visited_tiles_cover_the_band_at_the_serving_shapes(hd, S, window,
                                                            causal):
    """The pairs the kernel visits at the main paths' shapes: at least the
    band, and less than twice it where the band is the causal triangle."""
    rows, keys = FA.tc_rows(hd), FA.tc_keys(hd)
    visited = band = 0
    for q0 in range(0, S, rows):
        _, n = tc_tiles(q0, S, causal, window, rows, keys)
        visited += rows * n * keys
    for qp in range(S):
        lo = max(0, qp - window + 1) if window else 0
        hi = qp if causal else S - 1
        band += hi - lo + 1
    assert band <= visited < (2 * band if causal else band * 1.2)


# ---------------------------------------------------------------------------
# the generated wgmma header
# ---------------------------------------------------------------------------
def test_wgmma_header_is_what_the_generator_writes():
    import gen_wgmma

    with open(gen_wgmma.HEADER) as f:
        assert f.read() == gen_wgmma.render()
    # every width the kernel instantiates: the key tiles for S = Q K^T and
    # the head dims for O += P V
    widths = {FA.tc_keys(hd) for hd in FA.HEAD_DIMS} | set(FA.HEAD_DIMS)
    assert widths <= set(gen_wgmma.WIDTHS)
