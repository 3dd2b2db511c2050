"""The port's flash attention against the reference, on the CPU.

``repro_torch.kernels.flash_attention.flash_attention`` runs its plain twin
``flash_attention_plain`` on a CPU tensor; the twin is held here against

- the reference's Pallas kernel ``repro.kernels.ops.flash_attention`` in
  interpret mode (as ``tests/test_kernels.py`` runs it), with the same
  ``block_q`` / ``block_kv``, and
- the reference's full-matrix oracle ``repro.kernels.ref.flash_attention_ref``
  (and the port's copy of it, ``repro_torch.kernels.ref``),

over the ``FLASH_CASES`` grid of ``tests/test_kernels.py:21-29``, danube's
head geometry (hd 80, GQA 4, a window), S = 509 with blocks of 64, a
fully masked row, and RecurrentGemma's local attention (``HD256_CASES``:
hd 256, MQA with 10 or 4 query heads, window 0 or 16), at
``tests/test_kernels.py:42``'s tolerances: 2e-5 for
fp32 and 2e-2 for bf16 inputs (``assert_allclose`` with rtol = atol).
Inputs come from a numpy seed; bf16 inputs are rounded from the same fp32
values on both sides.

The route a CUDA tensor takes is chosen by dtype alone (bf16 on the tensor
cores, fp32 on the CUDA cores); the choice and the tensor-core kernel's
shared memory per head dim are pure Python and tested here.  The ``cuda``
tests hold both CUDA kernels against the twin on the card and skip here.
This file imports JAX only inside the tests that need it, so
``python -m pytest -q -m cuda tests/test_torch_flash.py`` runs on the card,
which has no JAX.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref as TREF

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

#: tests/test_kernels.py:21-29 (dtypes by name):
#: B, S, H, KV, hd, window, causal, dtype
FLASH_CASES = [
    (2, 64, 4, 2, 16, 0, True, "float32"),
    (1, 128, 8, 8, 32, 0, True, "float32"),
    (2, 96, 4, 1, 16, 24, True, "float32"),      # MQA + sliding window
    (1, 64, 4, 4, 16, 0, False, "float32"),      # bidirectional (encoder)
    (1, 64, 8, 2, 64, 0, True, "bfloat16"),
    (2, 80, 2, 2, 8, 16, True, "float32"),       # non-pow2 seq
]
#: the same fields plus the blocks: B, S, H, KV, hd, window, causal, dtype,
#: block -- FLASH_CASES at tests/test_kernels.py's blocks of 32, danube's
#: head geometry (hd 80, GQA 4, a window; fp32 and bf16) and S = 509 with
#: blocks of 64 (padded to 512)
CASES = [c + (32,) for c in FLASH_CASES] + [
    (2, 100, 8, 2, 80, 16, True, "float32", 32),
    (2, 100, 8, 2, 80, 16, True, "bfloat16", 32),
    (1, 120, 4, 1, 80, 48, True, "float32", 64),
    (1, 509, 2, 2, 16, 0, True, "float32", 64),
    (1, 509, 2, 2, 16, 0, False, "float32", 64),
    (1, 509, 4, 2, 80, 64, True, "bfloat16", 64),
]


#: RecurrentGemma's local attention: hd 256, one kv head (MQA), 10 or 4
#: query heads, window 0 or 16, causal; same fields as CASES
HD256_CASES = [
    (1, 64, 10, 1, 256, 0, True, "float32", 32),
    (1, 64, 10, 1, 256, 16, True, "float32", 32),
    (2, 100, 4, 1, 256, 16, True, "float32", 32),
    (1, 100, 4, 1, 256, 0, True, "float32", 64),
    (2, 48, 10, 1, 256, 16, True, "bfloat16", 16),
    (1, 100, 4, 1, 256, 0, True, "bfloat16", 64),
]
ALL_CASES = CASES + HD256_CASES


def _ids(c):
    B, S, H, KV, hd, window, causal, dtype = c[:8]
    return f"B{B}-S{S}-H{H}kv{KV}-hd{hd}-w{window}-c{int(causal)}-{dtype}"


def _inputs(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, S, H, hd)) / np.sqrt(hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    return q, k, v


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _jax(arrays, dtype):
    import jax.numpy as jnp

    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("case", ALL_CASES, ids=_ids)
def test_twin_matches_reference_pallas_kernel(case):
    from repro.kernels import ops

    B, S, H, KV, hd, window, causal, dtype, block = case
    arrays = _inputs(ALL_CASES.index(case), B, S, H, KV, hd)
    want = ops.flash_attention(*_jax(arrays, dtype), causal=causal,
                               window=window, block_q=block, block_kv=block)
    got = FA.flash_attention_plain(*_torch(arrays, dtype), causal=causal,
                                   window=window, block_q=block,
                                   block_kv=block)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, hd)
    _close(_f32(got), want, dtype)


@pytest.mark.parametrize("case", ALL_CASES, ids=_ids)
def test_twin_and_port_oracle_match_reference_oracle(case):
    from repro.kernels import ref as RREF

    B, S, H, KV, hd, window, causal, dtype, block = case
    arrays = _inputs(100 + ALL_CASES.index(case), B, S, H, KV, hd)
    want = RREF.flash_attention_ref(*_jax(arrays, dtype), causal=causal,
                                    window=window)
    xs = _torch(arrays, dtype)
    twin = FA.flash_attention_plain(*xs, causal=causal, window=window,
                                    block_q=block, block_kv=block)
    oracle = TREF.flash_attention_ref(*xs, causal=causal, window=window)
    _close(_f32(twin), want, dtype)
    _close(_f32(oracle), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_give_zero(dtype):
    """Key kp is visible from qp only when kp > qp + 30 (a negative window,
    bidirectional): rows 9.. of S = 40 see no key.  The kernel's guard
    makes them 0, in the reference's Pallas kernel and in the twin; the
    full-matrix oracle would give them v's mean (a uniform softmax)."""
    from repro.kernels import ops

    arrays = _inputs(40, 2, 40, 4, 2, 16)
    want = np.asarray(ops.flash_attention(*_jax(arrays, dtype), causal=False,
                                          window=-30, block_q=16,
                                          block_kv=16), np.float32)
    got = FA.flash_attention_plain(*_torch(arrays, dtype), causal=False,
                                   window=-30, block_q=16, block_kv=16)
    _close(_f32(got), want, dtype)
    assert (_f32(got)[:, 9:] == 0).all() and (want[:, 9:] == 0).all()
    assert (_f32(got)[:, :9] != 0).any()


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    arrays = _inputs(3, 2, 100, 8, 2, 80)
    xs = _torch(arrays, "float32")
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(*xs, causal=True, window=16)
    want = FA.flash_attention_plain(*xs, causal=True, window=16)
    assert torch.equal(got, want)
    assert FA.LAUNCHES["flash_attention"] == before


def test_wrapper_takes_head_dim_256_and_runs_the_twin_on_cpu():
    arrays = _inputs(3, 2, 100, 10, 1, 256)
    xs = _torch(arrays, "float32")
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(*xs, causal=True, window=16)
    want = FA.flash_attention_plain(*xs, causal=True, window=16)
    assert torch.equal(got, want)
    assert FA.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "cuda_core")])
def test_route_is_chosen_by_dtype_alone(dtype, route):
    assert FA.flash_route(dtype) == route
    assert FA.LAUNCHES.keys() >= {"flash_attention",
                                  f"flash_attention.{route}"}


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_no_route_for_other_dtypes(dtype):
    with pytest.raises(TypeError):
        FA.flash_route(dtype)


#: the tensor-core kernel's dynamic shared memory: 1 KB of alignment
#: slack, a Q block of 192 rows (128 above hd 80), two stages of K and V
#: tiles (128 keys; 64 at hd 256) in swizzled bf16 slabs of 64 columns
#: (hd 80 takes two), 128 bytes of mbarriers
TC_SMEM = {16: 23_680, 32: 46_208, 64: 91_264, 80: 181_376, 128: 164_992,
           256: 197_760}


@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tensor_core_shared_memory_fits_a_block(hd):
    """Every instantiated head dim fits the 227 KB a block may use (above
    48 KB the launch raises the limit first).  One CTA runs per SM: its
    producer and consumer warpgroups hold all of the SM's 64K registers
    after setmaxnreg, and the persistent grid has one CTA per SM."""
    got = FA.tc_smem_bytes(hd)
    assert got == TC_SMEM[hd]
    assert got < FA.SMEM_LIMIT
    producer, consumer = FA.tc_registers(hd)
    regs = 128 * producer + FA.tc_rows(hd) // 64 * 128 * consumer
    assert 65_536 // 2 < regs <= 65_536
    # swizzled slabs: the 8 rows a wgmma reads of one 16-byte column chunk
    # fall in 8 distinct 16-byte bank groups of the 128-byte row of banks
    # (the TMA swizzle XORs address bits 4.. with bits 7..)
    span = FA.TC_SWIZZLE[FA.tc_slab(hd)]
    bits = (span // 16).bit_length() - 1
    for c in range(span // 16):
        groups = set()
        for r in range(8):
            addr = r * span + 16 * c
            addr ^= ((addr >> 7) & ((1 << bits) - 1)) << 4
            groups.add(addr % 128 // 16)
        assert len(groups) == 8


def test_tensor_core_rows_must_start_on_16_bytes():
    """TMA reads from a 16-byte aligned base at strides of 16 bytes: a view
    whose rows do not start on 16 bytes is copied to a contiguous tensor
    before the launch."""
    x = torch.zeros((2, 8, 2, 88), dtype=torch.bfloat16)
    assert FA._rows_aligned(x[..., :80])
    assert not FA._rows_aligned(x[..., 4:84])
    assert FA._rows_aligned(torch.zeros((1, 5, 3, 80), dtype=torch.bfloat16))
    y = torch.zeros((1, 8, 2, 81), dtype=torch.bfloat16)[..., :80]
    assert not FA._rows_aligned(y)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _torch(_inputs(4, 1, 8, 4, 2, 24), "float32")
    with pytest.raises(ValueError, match="head dim 24"):
        FA.flash_attention(q, k, v)
    q, k, v = _torch(_inputs(4, 1, 8, 4, 2, 64), "float32")
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        FA.flash_attention(q, k[:, :4], v[:, :4])
    with pytest.raises(ValueError, match="group"):
        FA.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 64).contiguous(),
                           v[:, :, :1].expand(1, 8, 3, 64).contiguous())


@pytest.mark.parametrize("S,requested", [
    (509, 64), (80, 32), (128, 512), (4500, 512), (4096, 512), (7, 512),
    (100, 32), (96, 64), (1, 8)])
def test_block_rule_is_the_reference_rule(S, requested):
    from repro.kernels.flash_attention import _choose_block

    assert FA._choose_block(S, requested) == _choose_block(S, requested)


def test_the_case_grid_copies_the_reference_grid():
    from test_kernels import FLASH_CASES as REF_CASES

    assert [c[:7] + (np.dtype(c[7]).name,) for c in REF_CASES] \
        == FLASH_CASES


# ---------------------------------------------------------------------------
# build flags
# ---------------------------------------------------------------------------
def test_each_source_gets_its_own_nvcc_flags():
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCE_FLAGS) == sources
    for name in sources:
        f = _build.flags(name)
        assert "arch=compute_90a,code=sm_90a" in f
        assert "--use_fast_math" not in f and "-use_fast_math" not in f
    for name in ("weighted_sum", "sort_reduce", "gram", "rglru_scan"):
        assert "-fmad=false" in _build.flags(name)
    assert not any(x.startswith("-fmad") for x in
                   _build.flags("flash_attention"))
    with pytest.raises(KeyError):
        _build.flags("no_such_kernel")


def test_library_name_covers_the_source_flags(monkeypatch):
    before = _build._target("flash_attention")
    assert _build._target("gram") != before
    monkeypatch.setitem(_build.SOURCE_FLAGS, "flash_attention",
                        ("-fmad=false",))
    assert _build._target("flash_attention") != before


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


CARD_CASES = [
    (1, 64, 4, 4, 64, 0, True), (2, 509, 8, 2, 80, 16, True),
    (2, 509, 8, 2, 80, 0, False), (1, 300, 4, 1, 128, 4096, True),
    (1, 200, 4, 2, 32, 24, False), (1, 1000, 32, 8, 80, 256, True),
    (1, 509, 10, 1, 256, 16, True), (2, 300, 4, 1, 256, 0, True),
    (1, 1000, 8, 2, 256, 256, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: _ids(c + ("",)))
def test_kernel_matches_twin_on_card(cuda_device, case, dtype):
    B, S, H, KV, hd, window, causal = case
    xs = [x.to(cuda_device) for x in
          _torch(_inputs(S, B, S, H, KV, hd), dtype)]
    before = FA.LAUNCHES["flash_attention"]
    got = FA.flash_attention(*xs, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == before + 1
    want = FA.flash_attention_plain(*xs, causal=causal, window=window)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c for c in ALL_CASES
                                  if c[4] in FA.HEAD_DIMS] + [
    c + ("bfloat16", 0) for c in CARD_CASES], ids=_ids)
def test_tensor_core_route_matches_twin_on_card(cuda_device, case):
    """The case grid in bf16 on the tensor-core kernel: within 2e-2 of the
    twin, one launch counted on its route and none on the other."""
    B, S, H, KV, hd, window, causal = case[:7]
    xs = [x.to(cuda_device) for x in
          _torch(_inputs(S + hd, B, S, H, KV, hd), "bfloat16")]
    before = dict(FA.LAUNCHES)
    got = FA.flash_attention(*xs, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention.tensor_core"] \
        == before["flash_attention.tensor_core"] + 1
    assert FA.LAUNCHES["flash_attention.cuda_core"] \
        == before["flash_attention.cuda_core"]
    want = FA.flash_attention_plain(*xs, causal=causal, window=window)
    _close(got.float().cpu().numpy(), want.float().cpu().numpy(), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tensor_core_shared_memory_matches_the_kernel(cuda_device, hd):
    assert FA._kernel_lib().repro_flash_tc_smem_bytes(hd) \
        == FA.tc_smem_bytes(hd)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", FA.HEAD_DIMS)
def test_tensor_core_plan_matches_the_kernel(cuda_device, hd):
    """The library's tiles are the wrapper's mirror of them."""
    import ctypes

    plan = (ctypes.c_int * 4)()
    assert FA._kernel_lib().repro_flash_tc_plan(hd, plan) == 0
    assert list(plan) == [FA.tc_rows(hd), FA.tc_keys(hd), FA.TC_STAGES,
                          FA.tc_slab(hd)]


@pytest.mark.cuda
def test_tensor_core_route_takes_misaligned_views_on_card(cuda_device):
    """A view whose rows are not 16-byte aligned is copied first: the
    same result as the contiguous tensors."""
    q, k, v = (torch.zeros((1, 300, h, 88), dtype=torch.bfloat16,
                           device=cuda_device) for h in (8, 2, 2))
    for t in (q, k, v):
        t[..., 4:84] = torch.randn(t[..., 4:84].shape, device=cuda_device)
    views = [t[..., 4:84] for t in (q, k, v)]
    got = FA.flash_attention(*views, causal=True, window=64)
    want = FA.flash_attention(*(t.contiguous() for t in views), causal=True,
                              window=64)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refuses_an_unsupported_head_dim_on_card(cuda_device):
    xs = [x.to(cuda_device) for x in
          _torch(_inputs(5, 1, 16, 2, 2, 96), "float32")]
    with pytest.raises(ValueError, match="head dim 96"):
        FA.flash_attention(*xs)
