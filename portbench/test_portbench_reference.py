"""The plain references and the benchmark's frozen copies against the
program, at sizes the CPU holds."""
import numpy as np
import pytest
import torch

from portbench import harness, markov, weights, wire
from portbench.reference import fold as ref_fold
from portbench.reference import transformer as ref


@pytest.mark.parametrize("cell", ["smoke.train-dense", "smoke.train-moe"])
def test_train_reference_follows_the_program_at_fp32(smoke_root, cell):
    # the smoke configurations run the program in fp32: what is left
    # between the two is the order of fp32 sums
    out = harness.run_cell(cell, 2_147_483_659, 0.0, False, "cpu",
                           root=smoke_root)
    gaps = {k: c["value"] for k, c in out["checks"].items()}
    assert gaps["loss_gap"] < 1e-6, gaps
    assert gaps["grad_gap"] < 1e-5, gaps
    assert gaps["change_gap"] < 1e-4, gaps
    assert out["correct"]


@pytest.mark.parametrize("seed", [3, 2_147_483_659, 5_000_000_029])
def test_fold_reference_is_the_program_bit_for_bit(smoke_root, seed):
    out = harness.run_cell("smoke.fold", seed, 0.0, False, "cpu",
                           root=smoke_root)
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        "first_round_mismatches": 0, "sampled_round_mismatches": 0,
        "last_round_mismatches": 0}
    assert out["correct"]


def test_fold_reference_against_the_programs_numpy_engine():
    from repro_torch.fl.flat import FlatParams, SparseDelta, layout_for
    from repro_torch.fl.agg_kernels import StreamingWeightedSum

    rng = np.random.default_rng(7)
    shapes = [(300,), (40, 70), (5000,)]
    layout = layout_for([("float32", s) for s in shapes])
    n = layout.total_size
    base = rng.normal(size=n).astype(np.float32)
    base_fp = FlatParams(base.view(np.uint8), layout)
    sites = []
    acc = StreamingWeightedSum(layout, backend="numpy")
    for s in range(5):
        idx = np.sort(rng.choice(n, 2100, replace=False)).astype(np.int64)
        vals = rng.integers(-127, 128, 2100).astype(np.int8)
        scales = (10.0 ** rng.uniform(-4, -2, 3)).astype(np.float32)
        w = float(rng.integers(1, 50))
        sites.append((f"s{s}", idx, vals, scales, w))
        acc.add_sparse(SparseDelta(layout, "coo", idx, vals, scales, 1024,
                                   base=base_fp), w)
    want = acc.finalize().math_view()
    got = ref_fold.fold(base, sites, 1024)
    assert ref_fold.mismatches(got, want) == 0
    low = ref_fold.fold(base, sites, 1024, acc_dtype=torch.float32)
    assert ref_fold.mismatches(low, want) > 0


def test_frames_are_the_programs_bytes():
    from repro_torch.fl.flat import FlatParams
    from repro_torch.fl.messages import (FitRes, decode_fit_res,
                                         encode_fit_res)

    rng = np.random.default_rng(11)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((3, 5), (700,), (41, 50))]
    base = [a + rng.normal(size=a.shape).astype(np.float32) * 1e-3
            for a in arrays]
    frame = encode_fit_res(FitRes(arrays, 123, {}), codec="sparse",
                           base=FlatParams.from_arrays(base),
                           sparse_frac=0.05)
    sp = decode_fit_res(frame).sparse
    mine = wire.sparse_frame([a.shape for a in arrays], 123,
                             np.asarray(sp.indices), np.asarray(sp.values),
                             np.asarray(sp.scales))
    assert mine == frame


@pytest.mark.parametrize("seed, site", [(0, 0), (2_147_483_659, 3)])
def test_markov_rows_are_the_programs_generator(seed, site):
    from repro_torch.data.synthetic import SyntheticLMDataset

    ds = SyntheticLMDataset(1000, 40, 1 << 30, seed=seed, site=site)
    want = ds.sample(6)
    got = markov.rows(1000, 40, 6, seed, site=site)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


def test_batches_all_differ_and_weights_repeat():
    bs = markov.batches(32000, 64, 4, 3, 2_147_483_659)
    rows = np.concatenate([b["tokens"] for b in bs])
    assert len({r.tobytes() for r in rows}) == len(rows)
    conf = {"num_hidden_layers": 1, "hidden_size": 16,
            "intermediate_size": 24, "num_attention_heads": 2,
            "num_key_value_heads": 1, "vocab_size": 40,
            "rms_norm_eps": 1e-6}
    layout = ref.param_layout(conf)
    a = weights.make(layout, 5_000_000_029, "cpu")
    b = weights.make(layout, 5_000_000_029, "cpu")
    c = weights.make(layout, 5_000_000_030, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["scan_0/mix/wq"], c["scan_0/mix/wq"])


def test_moe_reference_routes_as_the_program():
    # GShard's slots: choice r of every token before choice r + 1 of any,
    # tokens in order; the program's masks against the reference's
    from repro_torch.config import get_model_config
    from repro_torch.models import mlp

    torch.manual_seed(0)
    cfg = get_model_config("granite-moe-1b-a400m", smoke=True).replace(
        dtype="float32")
    E, k, d = cfg.moe.num_experts, cfg.moe.experts_per_token, cfg.d_model
    params = {"router": torch.randn(d, E) * 0.3,
              "wi_gate": torch.randn(E, d, 64) * 0.1,
              "wi_up": torch.randn(E, d, 64) * 0.1,
              "wo": torch.randn(E, 64, d) * 0.1}
    x = torch.randn(2, 48, d)
    want, metrics = mlp.moe_apply(params, x, cfg)
    m = {"E": E, "k": k, "cf": cfg.moe.capacity_factor,
         "aux_coef": cfg.moe.router_aux_loss,
         "z_coef": cfg.moe.router_z_loss}
    got, aux = ref._moe(params, x, m, None)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        aux, metrics["moe_aux_loss"] + metrics["moe_z_loss"])
