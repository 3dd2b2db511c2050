"""The port's full-matrix oracles (``repro_torch.kernels.ref``) against the
reference's (``repro.kernels.ref``), on the CPU.

``rglru_scan_ref`` (``h_t = a_t * h_{t-1} + b_t`` over (B, S, W) fp32,
returning every step's state and the last) is held to the reference's
``lax.scan`` oracle at ``tests/test_kernels.py``'s tolerance (1e-5,
``assert_allclose`` with rtol = atol), at two small shapes, and to the
kernel's twin ``rglru_scan_plain``, whose arithmetic it shares.  Inputs
come from a numpy seed.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref as TREF
from repro_torch.kernels import rglru_scan as RS

TOL = 1e-5
SHAPES = [(2, 64, 96), (3, 17, 33)]


def _inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,S,W", SHAPES)
def test_rglru_scan_ref_matches_the_reference_oracle(B, S, W):
    import jax.numpy as jnp

    from repro.kernels import ref as RREF

    a, b, h0 = _inputs(B * S + W, B, S, W)
    ys, hf = TREF.rglru_scan_ref(*(torch.from_numpy(x) for x in (a, b, h0)))
    ys_r, hf_r = RREF.rglru_scan_ref(*(jnp.asarray(x) for x in (a, b, h0)))
    assert ys.shape == (B, S, W) and hf.shape == (B, W)
    assert ys.dtype == hf.dtype == torch.float32
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_r), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hf_r), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("B,S,W", SHAPES)
def test_rglru_scan_plain_matches_the_oracle(B, S, W):
    a, b, h0 = (torch.from_numpy(x) for x in _inputs(7 + S, B, S, W))
    ys, hf = RS.rglru_scan_plain(a, b, h0)
    ys_r, hf_r = TREF.rglru_scan_ref(a, b, h0)
    np.testing.assert_allclose(ys.numpy(), ys_r.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(hf.numpy(), hf_r.numpy(), rtol=TOL, atol=TOL)
    # the last state is the last step's, and h0 is not written
    assert torch.equal(hf_r, ys_r[:, -1])
    assert torch.equal(h0, torch.from_numpy(_inputs(7 + S, B, S, W)[2]))
