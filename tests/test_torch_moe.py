"""The port's GShard dense-dispatch MoE against the reference's, on the CPU.

``repro_torch.models.mlp.moe_apply`` against ``repro.models.mlp.moe_apply``
on the same layer parameters (the reference's ``init_params`` over
``moe_specs``, carried across by ``params_from_reference``) and the same
numpy-seeded activations.  The dispatch and combine masks are read where
both implementations hand them to ``constrain_moe`` (a recording stand-in
for the no-op).  Layers: Granite-MoE's and DeepSeek-V2's smoke MoE (4
experts, top 2; DeepSeek's with a shared expert), one of 8 experts over
two groups, one at capacity factor 0.5 (every group past capacity), a
zero router (every probability ties: every token picks experts 0 and 1,
so the lower index must come first, and those past C drop) and a
router of duplicated columns (ties between experts 0 and 1, and 2 and 3).

Tolerances (``assert_allclose``, rtol = atol): fp32 outputs, combine
weights and losses within 1e-5 (fp32 products summed in another order);
bf16 outputs within 5e-2 (bf16 rounds at other places in the two
frameworks).  The expert indices, the dispatch mask (so each drop) and
``moe_dropped_frac`` are exactly equal.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.sharding as RSHD
from repro.models import base as RB, mlp as RM
import repro_torch.config as TC
from repro_torch.models import mlp as TM
from repro_torch.models import params_from_reference

TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def port_config(rcfg) -> TC.ModelConfig:
    """The port's ModelConfig with the reference's field values."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TC.MoEConfig(**dataclasses.asdict(rcfg.moe))
    if rcfg.mla is not None:
        kw["mla"] = TC.MLAConfig(**dataclasses.asdict(rcfg.mla))
    return TC.ModelConfig(**kw)


def _granite(**moe):
    cfg = RC.get_model_config("granite-moe-1b-a400m", smoke=True)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))


def _deepseek():
    return RC.get_model_config("deepseek-v2-236b", smoke=True)


def _zero_router(p):
    p["router"] = np.zeros_like(p["router"])


def _dup_columns(p):
    r = p["router"]
    r[:, 1], r[:, 3] = r[:, 0], r[:, 2]


#: name -> (reference config, batch, seq, edit of the numpy params)
LAYERS = {
    "granite": (_granite(), 2, 24, None),
    "deepseek-shared": (_deepseek(), 2, 24, None),
    "e8-two-groups": (_granite(num_experts=8, capacity_factor=1.25), 2, 64,
                      None),
    "past-capacity": (_granite(capacity_factor=0.5), 2, 24, None),
    "zero-router-tie": (_granite(), 2, 24, _zero_router),
    "duplicated-columns-tie": (_granite(), 2, 24, _dup_columns),
}


def _layer(name, dtype="float32"):
    rcfg, B, S, edit = LAYERS[name]
    rcfg = rcfg.replace(dtype=dtype)
    rparams = jax.tree.map(np.array, RB.init_params(
        RM.moe_specs(rcfg), jax.random.key(3)))
    if edit is not None:
        edit(rparams)
    x = np.random.default_rng(5).normal(size=(B, S, rcfg.d_model)).astype(
        np.float32)
    return rcfg, rparams, x


def _recording(calls):
    def rec(x, expert_dim=None):
        calls.append((expert_dim, x))
        return x
    return rec


def _run_both(name, dtype, monkeypatch):
    """(reference (y, metrics, calls, top-k idx), port (same)) on one
    layer."""
    rcfg, rparams, x = _layer(name, dtype)
    tcfg = port_config(rcfg)
    rcalls, tcalls = [], []
    monkeypatch.setattr(RSHD, "constrain_moe", _recording(rcalls))
    monkeypatch.setattr(TM, "constrain_moe", _recording(tcalls))
    dt = rcfg.compute_dtype
    rx = jnp.asarray(x).astype(dt)
    rp = jax.tree.map(jnp.asarray, rparams)
    ry, rmet = RM.moe_apply(rp, rx, rcfg)
    tx = torch.from_numpy(x).to(tcfg.compute_dtype)
    tp = params_from_reference(rparams, device="cpu")
    ty, tmet = TM.moe_apply(tp, tx, tcfg)
    m = rcfg.moe
    T = x.shape[0] * x.shape[1]
    G = RM._num_groups(T, m.num_experts, m.experts_per_token,
                       m.capacity_factor)
    _, ridx = jax.lax.top_k(RM.router_probs(rp, rx, rcfg)[0].reshape(
        G, T // G, -1), m.experts_per_token)
    _, tidx = TM.top_k(TM.router_probs(tp, tx, tcfg)[0].reshape(
        G, T // G, -1), m.experts_per_token)
    return (ry, rmet, rcalls, np.asarray(ridx)), (ty, tmet, tcalls,
                                                  tidx.numpy())


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("name", list(LAYERS))
def test_moe_apply_matches_the_reference_at_fp32(name, monkeypatch):
    (ry, rmet, rcalls, ridx), (ty, tmet, tcalls, tidx) = _run_both(
        name, "float32", monkeypatch)
    tol = TOL["float32"]
    np.testing.assert_array_equal(tidx, ridx)
    # the constrain_moe sites, in the reference's order: tokens, dispatch,
    # combine (expert dim 2), dispatched, expert outputs (1), y
    assert [d for d, _ in tcalls] == [d for d, _ in rcalls] \
        == [None, 2, 2, 1, 1, None]
    for (_, t), (_, r) in zip(tcalls, rcalls):
        assert tuple(t.shape) == tuple(r.shape)
    rdisp, tdisp = _f32(rcalls[1][1]), _f32(tcalls[1][1])
    assert set(np.unique(tdisp)) <= {0.0, 1.0}
    np.testing.assert_array_equal(tdisp, rdisp)
    np.testing.assert_allclose(_f32(tcalls[2][1]), _f32(rcalls[2][1]),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(ty), _f32(ry), rtol=tol, atol=tol)
    for key in ("moe_aux_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(tmet[key]), float(rmet[key]),
                                   rtol=tol, atol=tol, err_msg=key)
    assert float(tmet["moe_dropped_frac"]) == float(rmet["moe_dropped_frac"])
    # each kept assignment is one 1 in the dispatch mask: the drops agree
    k = LAYERS[name][0].moe.experts_per_token
    dropped = ridx.size - rdisp.sum()
    assert np.isclose(dropped / ridx.size, float(rmet["moe_dropped_frac"]),
                      rtol=1e-6, atol=1e-7) and ridx.size == tidx.size
    assert ridx.shape[-1] == k


def test_forced_ties_and_overflow_are_exercised(monkeypatch):
    """The tie and capacity cases hold what their names say: a zero router
    gives every token experts [0, 1] in that order and drops past C; the
    duplicated columns tie in the port's router; capacity factor 0.5
    drops."""
    (_, rmet, _, ridx), (_, tmet, _, tidx) = _run_both(
        "zero-router-tie", "float32", monkeypatch)
    assert (tidx[..., 0] == 0).all() and (tidx[..., 1] == 1).all()
    # 2 groups of 24 tokens, C = int(24 * 2 / 4 * 1.5) = 18 slots an
    # expert: 6 of each group's 24 assignments to each expert drop
    assert float(tmet["moe_dropped_frac"]) == 0.25
    rcfg, rparams, x = _layer("duplicated-columns-tie")
    probs, _ = TM.router_probs(params_from_reference(rparams, device="cpu"),
                               torch.from_numpy(x), port_config(rcfg))
    assert torch.equal(probs[..., 0], probs[..., 1])
    assert torch.equal(probs[..., 2], probs[..., 3])
    monkeypatch.undo()
    (_, rmet, _, _), (_, tmet, _, _) = _run_both("past-capacity", "float32",
                                                 monkeypatch)
    assert float(tmet["moe_dropped_frac"]) > 0.0


@pytest.mark.parametrize("name", ["granite", "deepseek-shared"])
def test_moe_apply_matches_the_reference_at_bf16(name, monkeypatch):
    """bf16 activations: the router still runs in fp32 on the same bf16
    inputs, so the routing is the reference's exactly; the outputs agree
    to bf16's tolerance."""
    (ry, rmet, rcalls, ridx), (ty, tmet, tcalls, tidx) = _run_both(
        name, "bfloat16", monkeypatch)
    tol = TOL["bfloat16"]
    assert ty.dtype == torch.bfloat16
    assert tcalls[1][1].dtype == tcalls[2][1].dtype == torch.bfloat16
    np.testing.assert_array_equal(tidx, ridx)
    np.testing.assert_array_equal(_f32(tcalls[1][1]), _f32(rcalls[1][1]))
    np.testing.assert_allclose(_f32(ty), _f32(ry), rtol=tol, atol=tol)
    assert float(tmet["moe_dropped_frac"]) == float(rmet["moe_dropped_frac"])


@pytest.mark.parametrize("k", [1, 2, 6])
def test_top_k_breaks_ties_by_the_lower_index_as_jax(k):
    """Values drawn from 4 levels over 16 experts: nearly every row ties,
    at the k boundary too."""
    v = np.random.default_rng(k).integers(0, 4, (64, 16)).astype(np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(v), k)
    tv, ti = TM.top_k(torch.from_numpy(v), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.5), (8, 2, 1.25), (32, 8, 1.25),
                                    (160, 6, 1.25), (16, 2, 0.5),
                                    (64, 6, 0.0)])
def test_num_groups_is_the_reference_rule(E, k, cf):
    for T in (1, 2, 7, 48, 96, 128, 2048, 16384, 4096 * 40, 3 * 5 * 7 * 11):
        assert TM._num_groups(T, E, k, cf) == RM._num_groups(T, E, k, cf)


def test_moe_specs_are_the_reference_specs():
    for rcfg in (_granite(), _deepseek(),
                 RC.get_model_config("deepseek-v2-236b")):
        want = jax.tree.map(lambda s: (s.shape, s.axes, s.init, s.scale),
                            RM.moe_specs(rcfg),
                            is_leaf=lambda s: isinstance(s, RB.ParamSpec))

        def conv(sp):
            if isinstance(sp, dict):
                return {k: conv(v) for k, v in sp.items()}
            return (sp.shape, sp.axes, sp.init, sp.scale)

        assert conv(TM.moe_specs(port_config(rcfg))) == want


def test_moe_apply_runs_under_deterministic_algorithms(monkeypatch):
    rcfg, rparams, x = _layer("e8-two-groups")
    tcfg = port_config(rcfg)
    tp = params_from_reference(rparams, device="cpu")
    free, fm = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det, dm = TM.moe_apply(tp, torch.from_numpy(x), tcfg)
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(det, free)
    assert all(torch.equal(dm[k], fm[k]) for k in fm)
