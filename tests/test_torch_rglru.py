"""The port's RG-LRU recurrence against the reference, on the CPU.

``repro_torch.kernels.rglru_scan.rglru_scan`` runs its plain twin
``rglru_scan_plain`` on a CPU tensor; the twin is held here against

- the reference's Pallas kernel ``repro.kernels.ops.rglru_scan`` in
  interpret mode (as ``tests/test_kernels.py`` runs it), with the same
  ``block_s`` / ``block_w``, and
- the reference's oracle ``repro.kernels.ref.rglru_scan_ref`` (a
  ``lax.scan``),

over the grid of ``tests/test_kernels.py:145-186`` plus sequences that
straddle the reference's seq blocks, at that file's tolerance: 1e-5
(``assert_allclose`` with rtol = atol).  The port's eager path,
``repro_torch.models.recurrent.linear_scan_eager`` (a log-depth scan), is
held to ``jax.lax.associative_scan`` over the reference model's combine at
the same tolerance.  Inputs come from a numpy seed.

A numpy model of the kernel's shared-memory ring (its stage and tail
bookkeeping, with the ring's sizes read from ``csrc/rglru_scan.cu``)
visits every step once and in order, for S across stage boundaries.  The
``cuda`` test holds the CUDA kernel bitwise to the twin on the card, at the
ring's edges and on strided views too, and skips here.  This file imports
JAX only inside the tests that need it, so ``python -m pytest -q -m cuda
tests/test_torch_rglru.py`` runs on the card, which has no JAX.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rglru_scan as RS
from repro_torch.models.recurrent import linear_scan_eager

TOL = 1e-5

#: tests/test_kernels.py:145-186: B, S, W, block_s, block_w -- its four
#: parametrised cases, its carry case (S 64 in blocks of 8), then S that
#: straddle the seq blocks (100 in blocks of 25, 257 > block 256, S = 1
#: and S = 7 below one block) and an odd W
RGLRU_CASES = [
    (2, 64, 96, 16, 32),
    (1, 128, 64, 128, 64),
    (3, 48, 32, 8, 32),
    (2, 96, 128, 24, 64),
    (1, 64, 32, 8, 32),
    (2, 100, 96, 32, 32),
    (1, 257, 64, 256, 64),
    (2, 1, 64, 256, 64),
    (1, 7, 33, 256, 512),
]


def _inputs(seed, B, S, W, lo=0.7, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


def _t(arrays):
    return [torch.from_numpy(x) for x in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _ids(c):
    return "B{}-S{}-W{}-bs{}-bw{}".format(*c)


@pytest.mark.parametrize("case", RGLRU_CASES, ids=_ids)
def test_twin_matches_reference_kernel_and_oracle(case):
    import jax.numpy as jnp
    from repro.kernels import ops, ref

    B, S, W, bs, bw = case
    arrays = _inputs(RGLRU_CASES.index(case), B, S, W)
    ja = [jnp.asarray(x) for x in arrays]
    ys_k, hf_k = ops.rglru_scan(*ja, block_s=bs, block_w=bw)
    ys_r, hf_r = ref.rglru_scan_ref(*ja)
    ys, hf = RS.rglru_scan_plain(*_t(arrays))
    assert ys.shape == (B, S, W) and hf.shape == (B, W)
    assert ys.dtype == hf.dtype == torch.float32
    for want_ys, want_hf in ((ys_k, hf_k), (ys_r, hf_r)):
        _close(ys.numpy(), want_ys)
        _close(hf.numpy(), want_hf)


@pytest.mark.parametrize("seed", range(6))
def test_twin_property_like_the_reference(seed):
    """tests/test_kernels.py's property test: B 1-2, S 8-64, W 8-32, a in
    (0.5, 1), blocks of 8, drawn from a numpy seed here."""
    import jax.numpy as jnp
    from repro.kernels import ops

    rng = np.random.default_rng(seed)
    B, S, W = int(rng.integers(1, 3)), 8 * int(rng.integers(1, 9)), \
        8 * int(rng.integers(1, 5))
    arrays = _inputs(100 + seed, B, S, W, lo=0.5, hi=1.0)
    ys_k, hf_k = ops.rglru_scan(*[jnp.asarray(x) for x in arrays],
                                block_s=8, block_w=8)
    ys, hf = RS.rglru_scan_plain(*_t(arrays))
    _close(ys.numpy(), ys_k)
    _close(hf.numpy(), hf_k)


def test_final_state_is_the_last_step_and_empty_sequences_keep_h0():
    a, b, h0 = _t(_inputs(7, 3, 50, 40))
    ys, hf = RS.rglru_scan(a, b, h0)
    assert torch.equal(hf, ys[:, -1])
    ys0, hf0 = RS.rglru_scan(a[:, :0], b[:, :0], h0)
    assert ys0.shape == (3, 0, 40) and torch.equal(hf0, h0)
    assert hf0.data_ptr() != h0.data_ptr()


def test_edge_columns_a_zero_and_a_one():
    """a = 0 forgets the state (h_t = b_t), a = 1 sums b from h0."""
    a, b, h0 = _inputs(8, 2, 33, 16)
    a[:, :, 0] = 0.0
    a[:, :, 1] = 1.0
    ys, hf = RS.rglru_scan(*_t((a, b, h0)))
    assert torch.equal(ys[:, :, 0], torch.from_numpy(b[:, :, 0]))
    want = h0[:, 1:2] + np.cumsum(b[:, :, 1], axis=1, dtype=np.float32)
    _close(ys[:, :, 1].numpy(), want, 1e-5)


def test_wrapper_runs_the_twin_on_cpu_and_counts_no_launch():
    xs = _t(_inputs(9, 2, 70, 48))
    before = RS.LAUNCHES["rglru_scan"]
    got = RS.rglru_scan(*xs)
    want = RS.rglru_scan_plain(*xs)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert RS.LAUNCHES["rglru_scan"] == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    a, b, h0 = _t(_inputs(10, 2, 5, 8))
    with pytest.raises(TypeError):
        RS.rglru_scan(a.double(), b.double(), h0.double())
    with pytest.raises(TypeError):
        RS.rglru_scan(a.bfloat16(), b, h0)
    with pytest.raises(ValueError, match="must be"):
        RS.rglru_scan(a[0], b[0], h0)
    with pytest.raises(ValueError, match="do not match"):
        RS.rglru_scan(a, b[:, :4], h0)
    with pytest.raises(ValueError, match="do not match"):
        RS.rglru_scan(a, b, h0[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        at = a.transpose(1, 2).contiguous().transpose(1, 2)
        RS.rglru_scan(at, b, h0)
    with pytest.raises(ValueError, match="one device"):
        RS.rglru_scan(a, b, h0.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        RS.rglru_scan(a.to("meta"), b.to("meta"), h0.to("meta"))


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100, 257])
def test_eager_scan_matches_associative_scan(S):
    """The model's eager prefill path: a log-depth scan over (a, gx) with
    a_0 * h0 folded into gx_0, against the reference model's
    ``lax.associative_scan`` on the same pairs."""
    import jax
    import jax.numpy as jnp

    a, b, h0 = _inputs(200 + S, 2, S, 24, lo=0.5, hi=1.0)
    b0 = b.copy()
    b0[:, 0] += a[:, 0] * h0

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, want = jax.lax.associative_scan(
        combine, (jnp.asarray(a), jnp.asarray(b0)), axis=1)
    got = linear_scan_eager(torch.from_numpy(a), torch.from_numpy(b0))
    _close(got.numpy(), want)
    ys, _ = RS.rglru_scan_plain(*_t((a, b, h0)))
    _close(got.numpy(), ys.numpy())


# ---------------------------------------------------------------------------
# the kernel's ring, modelled in numpy
# ---------------------------------------------------------------------------
_SRC = os.path.join(os.path.dirname(__file__), "..", "src_torch",
                    "repro_torch", "kernels", "csrc", "rglru_scan.cu")
_STEP = RS.RING["steps"]
_DEPTH = RS.RING["steps"] * RS.RING["stages"]
_COLS = RS.RING["cols"]
#: S across the ring's boundaries: below, at and past one stage, the
#: ring's depth and twice it, and the serving length
RING_S = sorted({1, 2, _STEP - 1, _STEP, _STEP + 1, 2 * _STEP + 1,
                 _DEPTH - 1, _DEPTH, _DEPTH + 1, 2 * _DEPTH - 1,
                 2 * _DEPTH + _STEP + 3, 4096})


def test_ring_sizes_match_the_kernel_source():
    import re

    src = open(_SRC).read()
    got = {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1))
           for k in ("kCols", "kSteps", "kStages")}
    assert got == {"kCols": RS.RING["cols"], "kSteps": RS.RING["steps"],
                   "kStages": RS.RING["stages"]}


def _ring_walk(S, steps, stages):
    """The thread's walk of ``rglru_scan_kernel`` over its ring: the
    prologue fills stages 0..stages-2, iteration st fills stage
    st + stages - 1 into the slot stage st - 1 was read from, commits (an
    empty group past the last stage), waits until all but the stages - 1
    youngest groups have landed, then runs the steps of stage st that are
    < S.  Returns the steps in the order the chain ran them; raises where a
    read finds its slot holding another stage or a copy still in flight,
    or a copy lands in a slot not yet read."""
    nst = -(-S // steps)
    slot = [None] * stages       # the stage whose copies each slot holds
    groups = []                  # committed groups: the steps each copies
    read = set()

    def fill(st):
        prev = slot[st % stages]
        assert prev is None or prev in read, (st, prev)
        slot[st % stages] = st
        t0 = st * steps
        return [t0 + j for j in range(steps) if j < S - t0]

    for st in range(stages - 1):
        groups.append(fill(st) if st < nst else [])
    ran = []
    for st in range(nst):
        ahead = st + stages - 1
        groups.append(fill(ahead) if ahead < nst else [])
        landed = [t for g in groups[:len(groups) - (stages - 1)] for t in g]
        assert slot[st % stages] == st
        t0 = st * steps
        steps_run = list(range(t0, t0 + steps)) if t0 + steps <= S \
            else list(range(t0, S))
        assert set(steps_run) <= set(landed), st
        assert groups[st] == steps_run
        ran += steps_run
        read.add(st)
    return ran


@pytest.mark.parametrize("S", RING_S)
def test_ring_visits_every_step_once_and_in_order(S):
    assert _ring_walk(S, _STEP, RS.RING["stages"]) == list(range(S))


@pytest.mark.parametrize("stages", [2, 3, 6])
def test_ring_walk_holds_for_other_depths(stages):
    for S in (1, _STEP - 1, _STEP * stages + 1, 300):
        assert _ring_walk(S, _STEP, stages) == list(range(S))


def test_rglru_scan_builds_without_fma_contraction():
    f = _build.flags("rglru_scan")
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


def _strided(x, pad_steps=3, pad_cols=5):
    """``x`` (B, S, W) as steps [2, S + 2) and columns [1, W + 1) of a
    larger zero tensor: batch stride not S W, sequence stride not W, W
    contiguous."""
    B, S, W = x.shape
    big = torch.zeros((B, S + pad_steps, W + pad_cols), dtype=x.dtype,
                      device=x.device)
    view = big[:, 2:S + 2, 1:W + 1]
    view.copy_(x)
    return view


#: B, S, W, strided: the first cases, then S at one stage and at the ring's
#: depth +-1 x W at the CTA width +-1, contiguous and as strided views
CARD_CASES = [(1, 1, 128, False), (4, 257, 2561, False),
              (2, 4096, 2560, False), (3, 7, 33, False)] + [
    (3, S, W, strided)
    for S in (_STEP - 1, _STEP, _STEP + 1, _DEPTH - 1, _DEPTH, _DEPTH + 1)
    for W in (_COLS - 1, _COLS, _COLS + 1) for strided in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W,strided", CARD_CASES)
def test_kernel_equals_twin_bitwise_on_card(cuda_device, B, S, W, strided):
    a, b, h0 = [x.to(cuda_device) for x in
                _t(_inputs(S + W, B, S, W, lo=0.9, hi=1.0))]
    a[:, :, 0] = 0.0
    a[:, :, -1] = 1.0
    if strided:
        a, b = _strided(a), _strided(b, 2, 2)
        h0 = _strided(h0[:, None])[:, 0]
        assert a.stride(0) != S * W and b.stride(1) != W
    before = RS.LAUNCHES["rglru_scan"]
    ys, hf = RS.rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert RS.LAUNCHES["rglru_scan"] == before + 1
    ys_t, hf_t = RS.rglru_scan_plain(a, b, h0)
    assert torch.equal(ys.view(torch.int32), ys_t.view(torch.int32))
    assert torch.equal(hf.view(torch.int32), hf_t.view(torch.int32))
