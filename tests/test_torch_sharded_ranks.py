"""The sharded step under a ``"model"`` axis on real gloo ranks, on the
CPU: its values against the plain step's.

Each case runs one interpreter a rank (as ``tests/test_torch_collective.py``
runs them; the runner and the step's check are
``src_torch/tools/sharded_ranks.py``'s) on a ``(data, model)`` mesh, fp32,
inputs from a seed; the layouts and their collectives are
``tests/test_torch_sharded_layout.py``'s.

- The eager attention on DTensors in the residual stream's layout (batch
  over "data", sequence over "model"), output and the gradients of q, k
  and v, against the plain call: bitwise where the heads split over
  "model" (each rank's arithmetic per head is the plain one's; after the
  GQA -> MHA expansion the k / v gradients sum the group's copies in
  another order and lie within 2e-6 of the largest), and within 2e-6
  absolute where the keys split (the softmax's sums and the value
  products are reordered across ranks).
- The whole sharded step (``get_train_step(mesh=...)`` under the
  activation mesh) against the plain step from the same state: loss and
  grad norm within 1e-5 / 2e-5 relative, Adam moments (one step: the
  gradients) within 2e-5 of each leaf's largest entry plus 1e-8 of the
  largest moment of all, since a leaf whose gradient vanishes (xLSTM's
  input-gate bias) holds round-off alone (``tests/test_torch_collective.
  py``'s tolerances, that floor aside).  The weights' products split over
  "model" sum in another order, so no route makes the whole step bitwise.
  H2O-Danube on both attention routes; RecurrentGemma and xLSTM at
  ``(2, 2)`` (the recurrent weights' gradients add up over "data") and
  ``(1, 3)`` (RecurrentGemma's 4 heads cut by a 3-way width split).
- ``_block_diag_apply`` on a width split over 3 ranks, through 4 heads
  and around 6, leaves no ``Partial`` placement and equals the plain
  product; the sLSTM loop dispatches no DTensor op between its entry and
  exit (a counting dispatch mode around it).
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch",
                                "tools"))

import textwrap

import pytest

import sharded_ranks as SR

RANK_TIMEOUT = 240


def _run_ranks(body: str, data: int, model: int, tmp_path) -> list:
    """Run ``body`` in ``data`` x ``model`` fresh interpreters, one gloo
    rank each (``src_torch/tools/sharded_ranks.py``'s runner: ``mesh``,
    the tool as ``SR``), after ``_COMMON`` (the checks in scope); every
    rank must print ``RANK_OK``."""
    return SR.run_ranks(_COMMON + textwrap.dedent(body), data, model,
                        tmp_path, RANK_TIMEOUT)


_COMMON = """
import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.utils._python_dispatch import TorchDispatchMode
import repro_torch.config as TC
from repro_torch import sharding as shlib
from repro_torch.models import attention_impl, build_model, recurrent
from repro_torch.train import steps as TS
from repro_torch.utils.pytree import tree_flatten_with_paths

def sharded(fn):
    return SR.sharded(mesh, fn)


def check_step(arch, seq, steps=1):
    return SR.check_step(mesh, arch, seq, steps)


def check_attention(B, S, H, KV, hd, window, chunk, exact):
    g = torch.Generator().manual_seed(7)
    q, k, v, ct = (torch.randn(B, S, n, hd, generator=g)
                   for n in (H, KV, KV, H))
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention_impl.causal_attention(*plain, window=window,
                                           chunk=chunk)
    want.backward(ct)
    # the residual stream's layout: batch over "data", sequence over "model"
    dist_ = [distribute_tensor(t, mesh, [Shard(0), Shard(1)])
             .requires_grad_() for t in (q, k, v)]

    def run():
        out = attention_impl.causal_attention(*dist_, window=window,
                                              chunk=chunk)
        out.backward(distribute_tensor(ct, mesh, out.placements))
        return out

    out = sharded(run)
    pairs = [(out.full_tensor(), want)] + [
        (d.grad.full_tensor(), p.grad) for d, p in zip(dist_, plain)]
    # after a GQA -> MHA expansion the kv gradients sum the group's heads
    # in another order (the expanded copies' sum, not one contraction)
    expanded = H % MODEL == 0 and KV % MODEL != 0 and H != KV
    for i, (a, b) in enumerate(pairs):
        err = float((a - b).abs().max())
        if exact and not (expanded and i >= 2):
            assert torch.equal(a, b), (i, err)
        else:
            assert err <= 2e-6 * max(1.0, float(b.abs().max())), (i, err)
"""


@pytest.mark.parametrize("data,model", [(1, 2), (1, 4)])
def test_head_local_attention_equals_the_plain_one_on_gloo_ranks(
        data, model, tmp_path):
    _run_ranks("""
        # kv heads split over "model" (2 ranks) or, after the GQA -> MHA
        # expansion, the q heads (4 ranks); a sliding window, two chunks
        check_attention(2, 32, 4, 2, 16, window=12, chunk=16, exact=True)
        check_attention(2, 32, 8, 8, 16, window=0, chunk=32, exact=True)
        check_step("h2o-danube-1.8b", 32)
    """, data, model, tmp_path)


def test_key_split_attention_matches_the_plain_one_on_gloo_ranks(tmp_path):
    _run_ranks("""
        check_attention(2, 48, 4, 2, 16, window=12, chunk=16, exact=False)
        check_attention(2, 48, 4, 1, 16, window=0, chunk=48, exact=False)
        check_step("h2o-danube-1.8b", 48)
    """, 1, 3, tmp_path)


def test_recurrent_families_sharded_step_matches_the_plain_one(tmp_path):
    """RecurrentGemma's gates with 4 heads on 3 ranks (the width gathered)
    and xLSTM's sLSTM loop on local shards, with batch split over 2 data
    ranks (the recurrent weights' gradients add up over them)."""
    _run_ranks("""
        check_step("xlstm-350m", 32)
        check_step("recurrentgemma-2b", 32)
    """, 2, 2, tmp_path)
    _run_ranks("""
        check_step("recurrentgemma-2b", 48)
        check_step("xlstm-350m", 48)
    """, 1, 3, tmp_path)


def test_block_diag_leaves_no_partial_sum(tmp_path):
    _run_ranks("""
        g = torch.Generator().manual_seed(5)
        # heads 4 and 6 on 3 ranks: a width of 24 split 8 a rank cuts
        # through 4 heads of 6, and keeps 6 heads of 4 whole
        for heads in (4, 6):
            per = 24 // heads
            x = torch.randn(2, 6, 24, generator=g)
            w = torch.randn(heads, per, per, generator=g)
            want = recurrent._block_diag_apply(w, x, heads)
            xd = distribute_tensor(x, mesh, [Shard(0), Shard(2)])
            wd = distribute_tensor(w, mesh, [Replicate(), Shard(0) if
                                             heads % 3 == 0 else Replicate()])
            y = sharded(lambda: recurrent._block_diag_apply(wd, xd, heads))
            assert not any(isinstance(p, Partial) for p in y.placements), \\
                (heads, y.placements)
            err = float((y.full_tensor() - want).abs().max())
            assert err <= 1e-6, (heads, err)
    """, 1, 3, tmp_path)


def test_slstm_loop_dispatches_no_dtensor_op(tmp_path):
    _run_ranks("""
        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.dtensor = self.plain = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    self.dtensor += 1
                    return NotImplemented
                self.plain += 1
                return func(*args, **(kwargs or {}))

        seen, scan = [], recurrent._slstm_scan

        def counted(*a, **k):
            with Count() as c:
                out = scan(*a, **k)
            seen.append(c)
            return out

        recurrent._slstm_scan = counted
        check_step("xlstm-350m", 16)
        assert seen and all(c.dtensor == 0 and c.plain > 0 for c in seen), \\
            [(c.dtensor, c.plain) for c in seen]
    """, 2, 2, tmp_path)
