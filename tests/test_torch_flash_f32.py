"""The CUDA-core (fp32) flash kernel's host-side plan, on the CPU.

``csrc/flash_attention.cu``'s fp32 route (``f32::flash_f32_kernel``) runs
fixed tiles per head dim (``f32_threads``, ``f32_rows``, ``f32_keys``,
``F32_STAGES``, ``f32_colgroups``, ``f32_slices``, ``f32_strides``,
``f32_smem_bytes``),
copies them by 16-byte ``cp.async`` into padded shared-memory rows, visits
the key tiles of its query block's band and masks only the tiles
``tc::edge_tile`` marks.  None of that needs the card, so it is checked
here:

- the plan per head dim: the tiles divide the head dim and the threads,
  every shared-memory row and region starts on 16 bytes, the whole fits a
  block (two blocks an SM for a 128-thread CTA);
- the micro-tiles' shared-memory reads and writes, warp by warp, against a
  bank model: each takes the fewest wavefronts its bytes allow;
- the key tiles a query block visits and the ones it masks, exhaustively
  at small sizes and at the serving shapes, and a numpy model of the
  kernel's tile loop (masks on edge tiles only, the online softmax in
  log2 units) against the twin;
- the wrapper's copy of the fp32 views ``cp.async`` cannot read.

The ``cuda`` tests hold the library's plan to this mirror and the kernel
to the twin at its tile edges on the card, and skip here.  This file
imports neither JAX nor the reference package.
"""
import itertools
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import NEG_INF

F32 = torch.float32
#: shared memory of one SM on Hopper, and what the runtime reserves a block
SM_SMEM, BLOCK_RESERVED = 233_472, 1024

#: per head dim: threads, query rows, keys a tile, threads a row, bytes
PLAN = {16: (256, 128, 64, 4, 65_536), 32: (256, 128, 64, 8, 89_088),
        64: (128, 128, 32, 8, 86_528), 80: (128, 128, 32, 4, 103_424),
        128: (256, 128, 48, 16, 194_304), 256: (256, 64, 64, 16, 219_136)}


def _split(hd):
    """``(rg, tr, tk, tc)``: row groups, rows a thread, keys a thread
    scores, float4 columns of O a thread owns in each column slice
    (``f32::Plan``)."""
    threads, cg = FA.f32_threads(hd), FA.f32_colgroups(hd)
    rg = threads // cg
    cols = hd // FA.f32_slices(hd)
    return rg, FA.f32_rows(hd) // rg, FA.f32_keys(hd) // cg, cols // 4 // cg


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tile_plan_per_head_dim(hd):
    threads, rows, keys, cg, smem = PLAN[hd]
    assert (FA.f32_threads(hd), FA.f32_rows(hd), FA.f32_keys(hd),
            FA.f32_colgroups(hd), FA.f32_smem_bytes(hd)) == PLAN[hd]
    assert FA.F32_STAGES >= 2
    rg, tr, tk, tc = _split(hd)
    # a row's threads lie in one warp; the rows, keys and float4 columns
    # split evenly over the row groups and column groups
    assert 32 % cg == 0 and threads % 32 == 0 and threads == rg * cg
    assert rows == rg * tr and (tr == 2 or tr % 4 == 0)
    ds = FA.f32_slices(hd)
    assert keys == cg * tk and hd == 4 * cg * tc * ds
    # the copies: whole 16-byte chunks a thread, for the Q block and a
    # slice of a tile
    assert rows * hd // 4 % threads == 0
    assert keys * hd // ds // 4 % threads == 0
    # the shared memory: within a block's, two blocks an SM where the CTA
    # has 128 threads (one per SM otherwise: its registers)
    assert smem <= FA.SMEM_LIMIT
    per_sm = 256 // threads
    assert per_sm * (smem + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_shared_memory_rows_start_on_16_bytes(hd):
    """Every row of the Q block, of each K / V slot and of the P tile, and
    every region, starts on 16 bytes: the 16-byte ``cp.async`` copies and
    the float4 reads of the micro-tiles need it."""
    rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
    qs, ks, ps = FA.f32_strides(hd)
    assert qs * 4 % 16 == 0 and ks * 4 % 16 == 0 and ps * 4 % 16 == 0
    assert qs >= hd and ks >= hd // FA.f32_slices(hd) and ps >= rows
    regions = _regions(hd)
    assert all(off % 16 == 0 for off in regions.values())
    end = regions["p"] + 4 * keys * ps
    assert end == FA.f32_smem_bytes(hd)


def _regions(hd):
    """Byte offsets of the Q block, each K / V slot and the P tile."""
    rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
    qs, ks, _ = FA.f32_strides(hd)
    out = {"q": 0}
    for s in range(2 * FA.F32_STAGES):
        out[f"slot{s}"] = 4 * (rows * qs + s * keys * ks)
    out["p"] = 4 * (rows * qs + 2 * FA.F32_STAGES * keys * ks)
    return out


# ---------------------------------------------------------------------------
# bank conflicts
# ---------------------------------------------------------------------------
def _wavefronts(lanes):
    """Shared-memory wavefronts of one warp instruction, ``lanes`` a list
    of (byte address, width): the most distinct 4-byte words any of the 32
    banks must serve (lanes that read one word share it)."""
    banks = {}
    for addr, width in lanes:
        for word in range(addr // 4, (addr + width) // 4):
            banks.setdefault(word % 32, set()).add(word)
    return max(len(w) for w in banks.values())


def _fewest(lanes):
    """The fewest wavefronts the instruction's distinct bytes allow."""
    words = {w for a, n in lanes for w in range(a // 4, (a + n) // 4)}
    return math.ceil(len(words) * 4 / 128)


def _accesses(hd):
    """(what, lanes) for every shared-memory instruction of the micro-tiles
    in every warp: Q and K reads of S = Q K^T, the P^T stores, the P and V
    reads of O += P V."""
    threads, cg = FA.f32_threads(hd), FA.f32_colgroups(hd)
    rg_n, tr, tk, tc = _split(hd)
    qs, ks, ps = FA.f32_strides(hd)
    reg = _regions(hd)
    slot = reg["slot0"]
    pw = 8 if tr == 2 else 16
    for warp in range(threads // 32):
        ids = [(t // cg, t % cg) for t in range(32 * warp, 32 * warp + 32)]
        for d in range(hd // 4):
            for i in range(tr):
                yield "q", [(4 * ((rg + rg_n * i) * qs + 4 * d), 16)
                            for rg, _ in ids]
        for d in range(hd // FA.f32_slices(hd) // 4):
            for j in range(tk):
                yield "k", [(slot + 4 * ((c + cg * j) * ks + 4 * d), 16)
                            for _, c in ids]
        for j in range(tk):
            for i in range(0, tr, pw // 4):
                yield "p store", [(reg["p"] + 4 * ((c + cg * j) * ps
                                                   + rg * tr + i), pw)
                                  for rg, c in ids]
        for n in range(FA.f32_keys(hd)):
            for i in range(0, tr, pw // 4):
                yield "p", [(reg["p"] + 4 * (n * ps + rg * tr + i), pw)
                            for rg, _ in ids]
            for c4 in range(tc):
                yield "v", [(slot + 4 * (n * ks + 4 * (c + cg * c4)), 16)
                            for _, c in ids]


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_micro_tiles_are_free_of_bank_conflicts(hd):
    """With the padded strides every read and write of the micro-tiles
    takes the fewest wavefronts its bytes allow; without the padding, the
    K reads of S = Q K^T would not."""
    seen = set()
    for what, lanes in _accesses(hd):
        assert len(lanes) == 32
        assert _wavefronts(lanes) == _fewest(lanes), (hd, what, lanes[:8])
        seen.add(what)
    assert seen == {"q", "k", "p store", "p", "v"}
    cg, cols = FA.f32_colgroups(hd), hd // FA.f32_slices(hd)
    bare = [(4 * (c * cols), 16) for c in range(cg)] * (32 // cg)
    assert _wavefronts(bare) > _fewest(bare)


# ---------------------------------------------------------------------------
# key tiles, edges and masks
# ---------------------------------------------------------------------------
def f32_tiles(q0, S, causal, window, rows, keys):
    """``(lo, ntiles)``: the key tiles ``[lo + t * keys, ...)`` the query
    block of ``rows`` rows at ``q0`` visits (the kernel's ``lo``, ``hi``
    and ``ntiles``)."""
    lo = max(0, q0 - window + 1) if window else 0
    hi = min(q0 + rows, S) if causal else S
    return lo, (-(-(hi - lo) // keys) if hi > lo else 0)


def f32_edge(t0, keys, q0, rows, S, causal, window):
    """Whether keys ``[t0, t0 + keys)`` need a mask for the block's rows
    ``[q0, q0 + rows)`` (``tc::edge_tile``, which the fp32 kernel asks for
    its whole block)."""
    return bool((causal and t0 + keys - 1 > q0)
                or (window != 0 and t0 <= q0 + rows - 1 - window)
                or t0 + keys > S)


def f32_visible(qp, kp, cg, cgs, S, causal, window):
    """The kernel's mask of an edge tile: thread column group ``cg`` scores
    key ``kp = t0 + cg + cgs * j`` for row ``qp`` when ``cmin <= t0 + cgs *
    j <= cmax``."""
    cmin = (qp - window + 1 if window != 0 else -(1 << 30)) - cg
    cmax = (min(qp, S - 1) if causal else S - 1) - cg
    return cmin <= kp - cg <= cmax


def _visible(qp, kp, S, causal, window):
    return (kp < S and (not causal or kp <= qp)
            and (window == 0 or kp > qp - window))


def _check_block(q0, S, causal, window, rows, keys, cgs):
    lo, n = f32_tiles(q0, S, causal, window, rows, keys)
    assert lo >= 0 and n >= 0
    visited = range(lo, lo + n * keys)
    live = range(q0, min(q0 + rows, S))
    for qp in live:
        for kp in range(S):
            if _visible(qp, kp, S, causal, window):
                assert kp in visited, (q0, qp, kp)
    for t in range(n):
        t0 = lo + t * keys
        edge = f32_edge(t0, keys, q0, rows, S, causal, window)
        for qp in live:
            for kp in range(t0, t0 + keys):
                vis = _visible(qp, kp, S, causal, window)
                if edge:
                    assert f32_visible(qp, kp, kp % cgs, cgs, S, causal,
                                       window) == vis, (q0, t0, qp, kp)
                else:
                    assert vis, (q0, t0, qp, kp)


@pytest.mark.parametrize("rows,keys,cgs", [(8, 4, 2), (8, 8, 4), (12, 4, 4),
                                           (4, 16, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_key_tiles_and_masks_exhaustively(rows, keys, cgs, causal):
    for S, window in itertools.product(range(1, 41),
                                       (0, 1, 2, 3, 5, 8, 17, 64, -3)):
        for q0 in range(0, S, rows):
            _check_block(q0, S, causal, window, rows, keys, cgs)


@settings(max_examples=150, deadline=None)
@given(S=st.integers(1, 400), hd=st.sampled_from(FA.HEAD_DIMS),
       window=st.one_of(st.just(0), st.integers(-40, 400)),
       causal=st.booleans(), block=st.integers(0, 4))
def test_key_tiles_and_masks_at_kernel_sizes(S, hd, window, causal, block):
    rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
    q0 = min(block, (S - 1) // rows) * rows
    _check_block(q0, S, causal, window, rows, keys, FA.f32_colgroups(hd))


@pytest.mark.parametrize("hd,S,window,causal", [
    (80, 4500, 4096, True), (256, 4096, 2048, True), (64, 4096, 0, True),
    (128, 2048, 0, True), (64, 1500, 0, False)])
def test_visited_tiles_cover_the_band_at_the_serving_shapes(hd, S, window,
                                                            causal):
    """The pairs the kernel visits at the main paths' shapes: every pair of
    the band and at most 8% more (the causal diagonal's, the window edge's
    and the last ragged tiles: 3.1-7.8%); and it masks under a sixth of its
    tiles (4.2-14.4%)."""
    rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
    visited = band = masked = tiles = 0
    for q0 in range(0, S, rows):
        lo, n = f32_tiles(q0, S, causal, window, rows, keys)
        visited += rows * n * keys
        tiles += n
        masked += sum(f32_edge(lo + t * keys, keys, q0, rows, S, causal,
                               window) for t in range(n))
    for qp in range(S):
        lo = max(0, qp - window + 1) if window else 0
        hi = qp if causal else S - 1
        band += hi - lo + 1
    assert band <= visited < band * 1.08
    assert masked < tiles / 6


def f32_model(q, k, v, causal, window, rows, keys):
    """numpy model of the kernel's arithmetic, block by block and tile by
    tile: q times log2 e, masks only on edge tiles, the running max from
    NEG_INF, one exp2 a score, O rescaled once a tile, the sum clamped at
    1e-30; fp32 throughout."""
    B, S, H, hd = q.shape
    g = H // k.shape[2]
    out = np.zeros_like(q)
    log2e = np.float32(1.4426950408889634)
    for b, h in itertools.product(range(B), range(H)):
        qh, kh, vh = q[b, :, h] * log2e, k[b, :, h // g], v[b, :, h // g]
        for q0 in range(0, S, rows):
            r = np.arange(q0, q0 + rows)
            qb = np.zeros((rows, hd), np.float32)
            qb[:max(0, min(rows, S - q0))] = qh[q0:q0 + rows]
            m = np.full(rows, NEG_INF, np.float32)
            l = np.zeros(rows, np.float32)
            acc = np.zeros((rows, hd), np.float32)
            lo, n = f32_tiles(q0, S, causal, window, rows, keys)
            for t in range(n):
                t0 = lo + t * keys
                kp = np.arange(t0, t0 + keys)
                kt = np.zeros((keys, hd), np.float32)
                vt = np.zeros((keys, hd), np.float32)
                live = kp < S
                kt[live], vt[live] = kh[kp[live]], vh[kp[live]]
                s = qb @ kt.T
                if f32_edge(t0, keys, q0, rows, S, causal, window):
                    kmin = r - window + 1 if window else np.full(rows, -2**30)
                    kmax = np.minimum(r, S - 1) if causal else \
                        np.full(rows, S - 1)
                    ok = (kp[None] >= kmin[:, None]) & \
                        (kp[None] <= kmax[:, None])
                    s = np.where(ok, s, -np.inf).astype(np.float32)
                mx = np.maximum(m, s.max(axis=1))
                alpha = np.exp2(m - mx)
                p = np.exp2(s - mx[:, None])
                l = l * alpha + p.sum(axis=1)
                acc = acc * alpha[:, None] + p @ vt
                m = mx
            res = acc / np.maximum(l, np.float32(1e-30))[:, None]
            out[b, q0:q0 + rows, h] = res[:max(0, min(rows, S - q0))]
    return out


@pytest.mark.parametrize("S,H,KV,hd,window,causal,rows,keys", [
    (37, 4, 2, 16, 0, True, 8, 4), (37, 4, 2, 16, 0, False, 8, 4),
    (64, 4, 1, 32, 9, True, 16, 8), (50, 2, 2, 16, 7, False, 8, 8),
    (29, 4, 2, 16, -3, True, 8, 4), (41, 3, 1, 80, -30, False, 8, 8),
    (33, 4, 4, 64, 40, True, 16, 16), (100, 2, 1, 16, 16, True, 12, 8)])
def test_tile_loop_model_matches_the_twin(S, H, KV, hd, window, causal,
                                          rows, keys):
    """The kernel's tile loop, modelled in numpy, agrees with the twin
    within fp32's 2e-5, and a row with no visible key is exactly 0."""
    rng = np.random.default_rng(S * 100 + hd)
    q = (rng.normal(size=(2, S, H, hd)) / np.sqrt(hd)).astype(np.float32)
    k = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(2, S, KV, hd)).astype(np.float32)
    got = f32_model(q, k, v, causal, window, rows, keys)
    want = FA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for qp in range(S):
        if not any(_visible(qp, kp, S, causal, window) for kp in range(S)):
            assert (got[:, qp] == 0).all()


# ---------------------------------------------------------------------------
# the views the wrapper copies
# ---------------------------------------------------------------------------
def _views():
    """(name, fp32 view, copied first?): the views the CUDA-core kernel
    reads in place and those the wrapper makes contiguous first."""
    fused = torch.zeros((2, 8, 12, 80), dtype=F32)
    wide = torch.zeros((2, 8, 3, 88), dtype=F32)
    odd = torch.zeros((1, 8, 2, 81), dtype=F32)
    base = torch.zeros((2, 16, 4, 64), dtype=F32)
    return [
        ("contiguous", torch.zeros((2, 8, 3, 80), dtype=F32), False),
        ("q of a fused projection", fused[:, :, :8], False),
        ("v of a fused projection", fused[:, :, 10:], False),
        ("leading columns of wider rows", wide[..., :80], False),
        ("columns 1-80: base 4 bytes in", wide[..., 1:81], True),
        ("columns 2-81: base 8 bytes in", wide[..., 2:82], True),
        ("columns 4-83: base 16 bytes in", wide[..., 4:84], False),
        ("rows of 81: strides of 324 bytes", odd[..., :80], True),
        ("every other position", base[:, ::2], False),
        ("every other head", base[:, :, ::2], False),
        ("one head of four, broadcast",
         base[:, :, :1].expand(2, 16, 4, 64), True),
        ("heads before positions", base.transpose(1, 2), False),
    ]


@pytest.mark.parametrize("name,view,copied", _views(),
                         ids=[v[0] for v in _views()])
def test_which_fp32_views_are_copied_before_the_launch(name, view, copied):
    """A view whose rows do not start on 16 bytes, or whose stepped
    strides are not multiples of 4 floats, is copied to a contiguous
    tensor; every other view is read in place.  What the kernel then reads
    passes the library's check (``rows_aligned`` in the source)."""
    got = FA._readable(view)
    assert (got is not view) == copied
    assert torch.equal(got, view)
    assert got.data_ptr() % 16 == 0
    for s, n in zip(got.stride()[:3], got.shape[:3]):
        assert n == 1 or s % 4 == 0


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_f32_plan_matches_the_kernel(cuda_device, hd):
    """The library's fp32 tiles and shared memory are the wrapper's mirror
    of them."""
    import ctypes

    lib = FA._kernel_lib()
    plan = (ctypes.c_int * 6)()
    assert lib.repro_flash_f32_plan(hd, plan) == 0
    assert list(plan) == [FA.f32_rows(hd), FA.f32_keys(hd), FA.F32_STAGES,
                          FA.f32_threads(hd), FA.f32_colgroups(hd),
                          FA.f32_slices(hd)]
    assert lib.repro_flash_f32_smem_bytes(hd) == FA.f32_smem_bytes(hd)
    assert lib.repro_flash_f32_plan(96, plan) == -1
    assert lib.repro_flash_f32_smem_bytes(96) == 0


def _edge_cases():
    cases = []
    for hd in FA.HEAD_DIMS:
        rows, keys = FA.f32_rows(hd), FA.f32_keys(hd)
        for S in sorted({keys - 1, keys + 1, rows, rows + 1}):
            cases.append((hd, S, 0, True))
            cases.append((hd, S, 0, False))
        cases.append((hd, 2 * rows + 7, keys // 2 + 3, True))
        cases.append((hd, 2 * rows + 7, -5, True))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("hd,S,window,causal", _edge_cases())
def test_f32_kernel_matches_twin_at_its_tile_edges(cuda_device, hd, S,
                                                   window, causal):
    rng = np.random.default_rng(hd * 1000 + S)
    xs = [torch.from_numpy((rng.normal(size=(2, S, h, hd))
                            / (np.sqrt(hd) if h == 4 else 1))
                           .astype(np.float32)).to(cuda_device)
          for h in (4, 2, 2)]
    before = FA.LAUNCHES["flash_attention.cuda_core"]
    got = FA.flash_attention(*xs, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention.cuda_core"] == before + 1
    want = FA.flash_attention_plain(*xs, causal=causal, window=window)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)
    if window < 0 and causal:
        assert bool((got == 0).all())


@pytest.mark.cuda
def test_f32_route_takes_misaligned_views_on_card(cuda_device):
    """A view whose rows are not 16-byte aligned is copied first: the
    same result as the contiguous tensors."""
    q, k, v = (torch.zeros((1, 300, h, 88), dtype=F32, device=cuda_device)
               for h in (8, 2, 2))
    for t in (q, k, v):
        t[..., 1:81] = torch.randn(t[..., 1:81].shape, device=cuda_device)
    views = [t[..., 1:81] for t in (q, k, v)]
    got = FA.flash_attention(*views, causal=True, window=64)
    want = FA.flash_attention(*(t.contiguous() for t in views), causal=True,
                              window=64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
