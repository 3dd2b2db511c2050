"""xLSTM's mLSTM block on local shards under a ``"model"`` axis, on the
CPU.

The residual stream's sequence is split over ``"model"``, as in the
reference (``src/repro/sharding.py``'s ``constrain_batch``).  The port's
mLSTM keeps that split through the block (``models/recurrent.py``
``_mlstm_apply_split``): each rank projects its own tokens with the whole
weights, takes the causal conv's halo from the previous rank, offsets its
cumulative forget gates by the earlier ranks' totals, gathers k, v and the
gates once along the sequence and computes its own query rows of the
parallel form; a prefill's final state is combined over the axis.

On gloo ranks (``tests/test_torch_sharded_ranks.py``'s ``_run_ranks``),
fp32, inputs from a seed:

- ``_mlstm_shard``, the block between its entry and its exit, dispatches
  no DTensor op (a counting dispatch mode around it), in a train step and
  in a prefill;
- the sharded xLSTM train step against the plain one at ``(2, 2)`` and
  ``(1, 3)`` (``check_step``: loss, grad norm and Adam moments at that
  file's tolerances), and the sharded prefill's last logits within 1e-5
  and its recurrent states (mLSTM ``C``, ``n``, ``m``, ``conv``; sLSTM
  ``sc``, ``sn``, ``sm``, ``sh``) within 2e-5 of each leaf's largest
  entry (the moments' rule there);
- the block alone at S = 2200 on 2 ranks (1100 query rows a rank in 2
  chunks of 550: the rows' offsets and the chunking of the split form):
  output, input gradient and weight gradients in train, output and state
  in prefill, within 1e-4 of each tensor's largest entry, the tolerance
  ``tests/test_torch_xlstm.py`` holds the port to the reference at
  S = 1100: the cumulative log forget gates reach ~-1500 there, where an
  fp32 ulp is 1.2e-4, and the split sums them in another order.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))

import pytest

from test_torch_sharded_ranks import _run_ranks

_MLSTM = """
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch.shardings import (batch_shardings, params_shardings,
                                          rules_for_shape)
from repro_torch.models.base import index_layer

PREFILL_RULES = rules_for_shape(TC.INPUT_SHAPES["prefill_32k"])


def smoke():
    return TC.get_model_config("xlstm-350m", smoke=True).replace(
        dtype="float32")


def close(a, b, rtol, what):
    err = float((a - b).detach().abs().max())
    assert err <= rtol * float(b.detach().abs().max()), (what, err)


def check_prefill(S, B=4):
    cfg = smoke()
    model = build_model(cfg)
    params = model.init(3, device="cpu")
    g = torch.Generator().manual_seed(19)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    prefill = TS.make_prefill_step(model, max_len=S)
    want, cache = prefill(params, {"tokens": toks})
    p_d = TS.distribute_tree(params, params_shardings(
        model, mesh, rules=PREFILL_RULES))
    t_d = TS.distribute_tree({"tokens": toks}, batch_shardings(
        {"tokens": toks}, mesh, rules=PREFILL_RULES))

    def run():
        with implicit_replication():
            return prefill(p_d, t_d)

    got, c_d = sharded(run)
    close(got.full_tensor(), want, 1e-5, "logits")
    have = dict(tree_flatten_with_paths(TS.full_tree(c_d)))
    for path, leaf in tree_flatten_with_paths(cache):
        close(have[path], leaf, 2e-5, path)


def check_block(S, B=1, rtol=1e-4):
    cfg = smoke()
    model = build_model(cfg)
    full = model.init(3, device="cpu")["scan_0"]["mix"]
    g = torch.Generator().manual_seed(29)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    ct = torch.randn(B, S, cfg.d_model, generator=g)
    plain = {k: v.clone().requires_grad_() for k, v in full.items()}
    xp = x.clone().requires_grad_()
    want, _ = recurrent.mlstm_apply(index_layer(plain, 0), xp, cfg,
                                    mode="train")
    want.backward(ct)
    sh = params_shardings(model, mesh)["scan_0"]["mix"]
    dist_ = {k: TS.distribute_tree(v, sh[k]).requires_grad_()
             for k, v in full.items()}
    place = [Shard(0), Shard(1)]
    xd = distribute_tensor(x, mesh, place).requires_grad_()

    def run():
        y, _ = recurrent.mlstm_apply(index_layer(dist_, 0), xd, cfg,
                                     mode="train")
        y.backward(distribute_tensor(ct, mesh, y.placements))
        return y

    y = sharded(run)
    close(y.full_tensor(), want, rtol, "y")
    close(xd.grad.full_tensor(), xp.grad, rtol, "dx")
    for k in full:
        close(dist_[k].grad.full_tensor(), plain[k].grad, rtol, k)
    with torch.no_grad():
        want, state = recurrent.mlstm_apply(index_layer(full, 0), x, cfg,
                                            mode="prefill")
        got, got_state = sharded(lambda: recurrent.mlstm_apply(
            index_layer(dist_, 0), distribute_tensor(x, mesh, place), cfg,
            mode="prefill"))
    close(got.full_tensor(), want, rtol, "prefill y")
    for k, t in state.items():
        close(got_state[k].full_tensor(), t, rtol, k)
"""

_COUNT = """
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


seen, shard = [], recurrent._mlstm_shard


def counted(*a, **k):
    with Count() as c:
        out = shard(*a, **k)
    seen.append((a[-1], c))
    return out


recurrent._mlstm_shard = counted
"""


def test_mlstm_block_dispatches_no_dtensor_op(tmp_path):
    _run_ranks(_MLSTM + _COUNT + """
check_step("xlstm-350m", 32)
check_prefill(32)
modes = {mode for mode, _ in seen}
assert modes == {"train", "prefill"}, modes
assert all(c.dtensor == 0 and c.plain > 0 for _, c in seen), \\
    [(mode, c.dtensor, c.plain) for mode, c in seen]
""", 2, 2, tmp_path)


@pytest.mark.parametrize("data,model,seq", [(2, 2, 32), (1, 3, 48)])
def test_sharded_xlstm_step_and_prefill_match_the_plain_ones(
        data, model, seq, tmp_path):
    _run_ranks(_MLSTM + _COUNT + f"""
check_step("xlstm-350m", {seq})
check_prefill({seq})
assert {{mode for mode, _ in seen}} == {{"train", "prefill"}}
""", data, model, tmp_path)


def test_mlstm_block_chunked_rows_match_the_plain_block(tmp_path):
    _run_ranks(_MLSTM + """
check_block(2200)
""", 1, 2, tmp_path)
