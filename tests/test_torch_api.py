"""The port's public API against the reference's signatures, on the CPU.

The reference's aggregation entry points (``repro.fl.agg_kernels``) take
``block`` right after ``backend`` (``trimmed_mean`` right after ``k``), and
its kernel wrappers (``repro.kernels.ops``) take TPU tiling keywords and an
``interpret`` switch.  A caller written against the reference must run
unchanged on the port: positionally and by keyword, with the same result
(bitwise for the folds, to the flash tolerance for attention).  The port's
``device`` comes after ``block``.  Also: ``repro_torch.train`` re-exports
the serving steps and ``repro_torch.kernels`` imports ``ops`` and ``ref``,
as the reference's packages do.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import subprocess

import numpy as np
import pytest
import torch

import repro.fl.agg_kernels as RK
import repro_torch.fl.agg_kernels as TK
from repro_torch.kernels import ops
from test_torch_agg import assert_bitwise, make_payloads

HERE = os.path.dirname(os.path.abspath(__file__))


def _round(n=4, seed=3):
    return make_payloads("odd_f32", "flat", n, seed=seed)


@pytest.mark.parametrize("how", ["positional", "keyword"])
def test_fold_entry_points_take_the_reference_block_slot(how):
    """``weighted_mean``, ``median``, ``trimmed_mean``, ``krum_distances``
    and ``StreamingWeightedSum`` called as the reference is called, with a
    block, give the reference's numpy result."""
    rl, ref, tl, port = _round()
    w = [1.0, 2.0, 3.0, 4.0]
    pairs_r, pairs_t = list(zip(ref, w)), list(zip(port, w))
    if how == "positional":
        got = [TK.weighted_mean(pairs_t, tl, "torch", 4096, "cpu"),
               TK.median(port, tl, "torch", 4096, "cpu"),
               TK.trimmed_mean(port, tl, 1, "torch", 4096, "cpu")]
        d = TK.krum_distances(port, tl, "torch", 4096, "cpu")
        s = TK.StreamingWeightedSum(tl, "torch", 4096, "cpu")
    else:
        kw = dict(backend="torch", block=4096, device="cpu")
        got = [TK.weighted_mean(pairs_t, tl, **kw), TK.median(port, tl, **kw),
               TK.trimmed_mean(port, tl, 1, **kw)]
        d = TK.krum_distances(port, tl, **kw)
        s = TK.StreamingWeightedSum(tl, **kw)
    want = [RK.weighted_mean(pairs_r, rl, "numpy", 4096),
            RK.median(ref, rl, "numpy", 4096),
            RK.trimmed_mean(ref, rl, 1, "numpy", 4096)]
    for g, x in zip(got, want):
        assert_bitwise(g, x)
    np.testing.assert_allclose(d, RK.krum_distances(ref, rl, "numpy", 4096),
                               rtol=1e-9, atol=1e-9)
    r = RK.StreamingWeightedSum(rl, "numpy", 4096)
    for (pt, wt), (pr, _) in zip(pairs_t, pairs_r):
        s.add(pt, wt)
        r.add(pr, wt)
    assert str(s.device) == "cpu"
    assert_bitwise(s.finalize(), r.finalize())


def test_a_reference_positional_block_is_not_taken_for_a_device():
    """``StreamingWeightedSum(layout, None, 4096)``: 4096 is the block;
    the numpy backend never resolves a device."""
    _, _, tl, port = _round()
    s = TK.StreamingWeightedSum(tl, "numpy", 4096)
    assert s.device is None
    s.add(port[0], 1.0)
    assert s.count == 1


@pytest.mark.parametrize("block", [0, -8])
def test_a_non_positive_block_raises(block):
    _, _, tl, port = _round()
    for call in (lambda: TK.median(port, tl, "numpy", block),
                 lambda: TK.trimmed_mean(port, tl, 1, "numpy", block),
                 lambda: TK.krum_distances(port, tl, "numpy", block),
                 lambda: TK.weighted_mean([(port[0], 1.0)], tl, "numpy",
                                          block),
                 lambda: TK.StreamingWeightedSum(tl, "numpy", block)):
        with pytest.raises(ValueError, match="block"):
            call()


def test_ops_flash_takes_the_reference_keywords():
    """``ops.flash_attention`` with the reference's ``block_q``,
    ``block_kv`` and ``interpret``: on the CPU the twin follows the blocks,
    within the fp32 tolerance of the reference's Pallas kernel (interpret
    mode) at the same blocks."""
    import jax.numpy as jnp

    from repro.kernels import ops as rops

    rng = np.random.default_rng(11)
    q = (rng.normal(size=(1, 96, 4, 32)) / np.sqrt(32)).astype(np.float32)
    k = rng.normal(size=(1, 96, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, 96, 2, 32)).astype(np.float32)
    kw = dict(causal=True, window=40, block_q=32, block_kv=64)
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              interpret=True, **kw)
    want = rops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_ops_secagg_and_rglru_take_the_reference_keywords():
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 1, 300).astype(np.float32))
    masks = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (2, 300),
                                          dtype=np.int64).astype(np.int32))
    assert torch.equal(ops.secagg_mask(x, masks, 3.0, quant_bits=16,
                                       block=128, interpret=False),
                       ops.secagg_mask(x, masks, 3.0))
    a = torch.from_numpy(rng.uniform(0.9, 1.0, (2, 40, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (2, 40, 16)).astype(np.float32))
    h0 = torch.zeros((2, 16))
    got = ops.rglru_scan(a, b, h0, block_s=8, block_w=8, interpret=True)
    want = ops.rglru_scan(a, b, h0)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("call", ["flash", "secagg", "rglru"])
def test_ops_refuse_a_non_positive_block(call):
    z = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="block"):
        if call == "flash":
            ops.flash_attention(z, z, z, block_q=0)
        elif call == "secagg":
            ops.secagg_mask(torch.zeros(8), torch.zeros((0, 8),
                                                        dtype=torch.int32),
                            1.0, block=-1)
        else:
            ops.rglru_scan(torch.zeros((1, 4, 8)), torch.zeros((1, 4, 8)),
                           torch.zeros((1, 8)), block_w=0)


def test_train_package_reexports_the_serving_steps():
    from repro_torch import train
    from repro_torch.train import (greedy_generate, make_decode_step,
                                   make_prefill_step)
    from repro_torch.train import steps

    assert (make_prefill_step, make_decode_step, greedy_generate) == (
        steps.make_prefill_step, steps.make_decode_step,
        steps.greedy_generate)
    assert {"make_prefill_step", "make_decode_step",
            "greedy_generate"} <= set(vars(train))


@pytest.mark.parametrize("first", ["repro_torch.kernels",
                                   "repro_torch.kernels.ops",
                                   "repro_torch.kernels.agg_reduce",
                                   "repro_torch.train"])
def test_kernels_package_imports_ops_and_ref_without_a_cycle(first):
    """In a fresh interpreter, whichever module comes first, the kernels
    package holds ``ops`` and ``ref`` as attributes (the reference's
    ``from repro.kernels import ops, ref``)."""
    code = (f"import {first}\nimport repro_torch.kernels as K\n"
            "assert K.ops.flash_attention and K.ref.flash_attention_ref\n"
            "from repro_torch.train import make_prefill_step\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src_torch"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
