"""The port's SecAgg quantize + mask kernel against the reference, on the CPU.

``repro_torch.kernels.secagg_mask.secagg_mask`` (and its public wrapper
``repro_torch.kernels.ops.secagg_mask``) runs the plain twin
``secagg_mask_plain`` on a CPU tensor; the twin is held here, exactly,
against

- the reference's Pallas kernel ``repro.kernels.ops.secagg_mask`` in
  interpret mode (as ``tests/test_kernels.py`` runs it),
- the reference's oracle ``repro.kernels.ref.secagg_mask_ref``, and
- the port's oracle ``repro_torch.kernels.ref.secagg_mask_ref``,

over N = 1, 7, 4097 and 2**16, P = 0, 1, 3 and 15 masks, weights 1 and 3,
with values that clip, NaN and +-inf in ``x`` and masks drawn over the
whole int32 range (so their sum wraps), plus the properties of
``tests/test_kernels.py:102-140``.  Inputs come from a numpy seed.

The ``cuda`` test holds the kernel to the twin exactly on the card and
skips here.  This file imports JAX only inside the tests that need it, so
``python -m pytest -q -m cuda tests/test_torch_secagg.py`` runs on the
card, which has no JAX.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # bare env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import secagg_mask as SM

NS = (1, 7, 4097, 1 << 16)
PS = (0, 1, 3, 15)
WEIGHTS = (1.0, 3.0)


def _inputs(seed: int, n: int, p: int, specials: bool = True):
    """x (N,) fp32 with, when ``specials``, values that clip (beyond
    2**31 / 2**16 before the weight), NaN, +-inf and halves that round to
    even; masks (P, N) int32 over the whole range."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3e3, n).astype(np.float32)
    if specials:
        edge = np.array([1e6, -1e6, np.nan, np.inf, -np.inf, 2.5 / 65536,
                         -2.5 / 65536, 0.5 / 65536, 32767.99, 1e30],
                        np.float32)
        k = min(n, edge.size)
        x[:k] = edge[:k]
        if n > 64:
            x[rng.integers(0, n, n // 50)] = np.nan
    masks = rng.integers(-2 ** 31, 2 ** 31, (p, n)).astype(np.int32)
    return x, masks


def _reference(x, masks, w, *, kernel: bool):
    import jax.numpy as jnp
    from repro.kernels import ops as rops
    from repro.kernels import ref as rref

    if kernel:
        out = rops.secagg_mask(jnp.asarray(x), jnp.asarray(masks), w)
    else:
        out = rref.secagg_mask_ref(jnp.asarray(x), jnp.asarray(masks), w)
    return np.asarray(out)


def _port(x, masks, w):
    return ops.secagg_mask(torch.from_numpy(x), torch.from_numpy(masks),
                           w).numpy()


@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_twin_equals_reference_oracle_and_port_oracle(n, p, w):
    x, masks = _inputs(n * 31 + p, n, p)
    got = _port(x, masks, w)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, _reference(x, masks, w, kernel=False))
    np.testing.assert_array_equal(
        got, tref.secagg_mask_ref(torch.from_numpy(x),
                                  torch.from_numpy(masks), w).numpy())


@pytest.mark.parametrize("n,p,w", [(1, 0, 3.0), (7, 1, 1.0), (4097, 3, 3.0),
                                   (4097, 15, 1.0), (1 << 16, 3, 3.0)])
def test_twin_equals_reference_kernel_in_interpret_mode(n, p, w):
    """The reference's Pallas kernel, run as its own tests run it; 2**16 x
    3 masks is its benchmark's shape (benchmarks/run.py:259-263)."""
    x, masks = _inputs(n + p, n, p)
    np.testing.assert_array_equal(_port(x, masks, w),
                                  _reference(x, masks, w, kernel=True))


def test_saturation_matches_the_reference_where_a_naive_cast_does_not():
    """In fp32 the clip's 2**31 - 1 is 2**31; the reference saturates to
    2147483647, maps NaN to 0 and -inf to -2**31.  A cast of the clipped
    fp32 value to int32 does not: it gives -2**31 for all three."""
    x = np.array([1e6, np.nan, np.inf, -np.inf], np.float32)
    none = np.zeros((0, 4), np.int32)
    want = np.array([2 ** 31 - 1, 0, 2 ** 31 - 1, -2 ** 31], np.int32)
    np.testing.assert_array_equal(_reference(x, none, 1.0, kernel=True),
                                  want)
    np.testing.assert_array_equal(_port(x, none, 1.0), want)


def test_masks_cancel_pairwise_in_the_int32_field():
    """+m on one site and -m on the other: the sum of the two shares is the
    sum of the unmasked quantized updates, exactly (wrapping)."""
    rng = np.random.default_rng(7)
    n = 4097
    x1, x2 = (rng.normal(0, 1, n).astype(np.float32) for _ in range(2))
    m = rng.integers(-2 ** 31, 2 ** 31, (1, n)).astype(np.int32)
    a = _port(x1, m, 1.0)
    b = _port(x2, (-m.astype(np.int64)).astype(np.int32), 1.0)
    none = np.zeros((0, n), np.int32)
    plain = _port(x1, none, 1.0).astype(np.int64) \
        + _port(x2, none, 1.0).astype(np.int64)
    got = a.astype(np.int64) + b.astype(np.int64)
    np.testing.assert_array_equal(got % 2 ** 32, plain % 2 ** 32)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 64), st.integers(0, 4),
       st.floats(0.25, 1000.0, allow_nan=False))
def test_property_like_the_reference(nmult, p, weight):
    n = 16 * nmult
    rng = np.random.default_rng(n + p)
    x = rng.normal(size=n).astype(np.float32)
    masks = rng.integers(-2 ** 31, 2 ** 31 - 1, (p, n)).astype(np.int32)
    np.testing.assert_array_equal(_port(x, masks, weight),
                                  _reference(x, masks, weight, kernel=False))


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    x, masks = _inputs(3, 64, 2)
    before = SM.LAUNCHES["secagg_mask"]
    got = SM.secagg_mask(torch.from_numpy(x), torch.from_numpy(masks), 3.0)
    assert SM.LAUNCHES["secagg_mask"] == before
    assert torch.equal(got, SM.secagg_mask_plain(
        torch.from_numpy(x), torch.from_numpy(masks), 3.0))


@pytest.mark.parametrize("bad", ["x_dtype", "x_shape", "mask_dtype",
                                 "mask_len", "bits"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    x = torch.zeros(8, dtype=torch.float32)
    masks = torch.zeros((2, 8), dtype=torch.int32)
    kw = {}
    if bad == "x_dtype":
        x = x.double()
    elif bad == "x_shape":
        x = x.reshape(2, 4)
    elif bad == "mask_dtype":
        masks = masks.long()
    elif bad == "mask_len":
        masks = masks[:, :7]
    else:
        kw["quant_bits"] = 64
    with pytest.raises(ValueError):
        SM.secagg_mask(x, masks, 1.0, **kw)


def test_secagg_mask_builds_without_fma_contraction():
    f = _build.flags("secagg_mask")
    assert "-fmad=false" in f and "arch=compute_90a,code=sm_90a" in f
    assert "--use_fast_math" not in f


# ---------------------------------------------------------------------------
# on the card (skipped without one)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("w", WEIGHTS)
@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("n", NS)
def test_kernel_equals_twin_on_card(cuda_device, n, p, w):
    x, masks = _inputs(n * 31 + p, n, p)
    xt, mt = torch.from_numpy(x), torch.from_numpy(masks)
    before = SM.LAUNCHES["secagg_mask"]
    got = SM.secagg_mask(xt.to(cuda_device), mt.to(cuda_device), w)
    torch.cuda.synchronize()
    assert SM.LAUNCHES["secagg_mask"] == before + 1
    assert torch.equal(got.cpu(), SM.secagg_mask_plain(xt, mt, w))
