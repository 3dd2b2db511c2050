"""The port's model substrate against the reference's, on the CPU.

The reference's parameters (``repro.models`` ``Model.init``) are carried
across with ``repro_torch.models.params_from_reference``, so both sides run
the same weights; inputs come from a numpy seed.  Two configurations:
H2O-Danube-1.8B's smoke variant (``configs/h2o_danube_1_8b.py``) and a
narrow config with danube's head geometry (d_model 320, 4 heads of 80,
1 kv head, window 16, 2 layers; vocab 1000, padded to 1024, so the pad
mask runs).  Prompts of 40 tokens exceed the window: the rotating cache's
S > window branch runs.

Tolerances (``assert_allclose``, rtol = atol): with ``dtype="float32"``
logits within 1e-4 and every other output within 1e-5 (fp32 products
summed in another order; torch's and XLA's sin/cos differ in the last
bits); with bf16, 5e-2 (bf16 rounds at other places in the two
frameworks).  Greedy generation gives the reference's ids exactly at fp32.
The reference's attention runs through ``impl="xla"`` and, for the flash
path, ``impl="pallas"`` in interpret mode, against the port's ``"eager"``
and ``"flash"`` (the kernel's twin on the CPU).
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
from repro.models import attention as RA, base as RB, mlp as RM
from repro.models import build_model as r_build
from repro.train.steps import greedy_generate as r_greedy
import repro_torch.config as TC
from repro_torch.models import attention as TA, base as TB, mlp as TM
from repro_torch.models import (build_model, params_from_reference,
                                to_arrays)
from repro_torch.train.steps import greedy_generate

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
IMPLS = [("xla", "eager"), ("pallas", "flash")]
PROMPT, NEW = 40, 8


def _narrow(dtype="float32"):
    return RC.ModelConfig(name="narrow-danube-heads", num_layers=2,
                          d_model=320, num_heads=4, num_kv_heads=1,
                          d_ff=640, vocab_size=1000, window=16, dtype=dtype)


def _smoke(dtype="float32"):
    return RC.get_model_config("h2o-danube-1.8b", smoke=True).replace(
        dtype=dtype)


CONFIGS = {"smoke": _smoke, "narrow": _narrow}


def port_config(rcfg) -> TC.ModelConfig:
    """The port's ModelConfig with the reference's field values (dense
    configs: no MoE, no MLA)."""
    assert not rcfg.moe.enabled and rcfg.mla is None
    return TC.ModelConfig(**{f.name: getattr(rcfg, f.name)
                             for f in dataclasses.fields(rcfg)
                             if f.name not in ("moe", "mla")})


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=[(c, d) for c in CONFIGS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """(reference model, reference params, port model, port params,
    prompt tokens) for one config and dtype."""
    name, dtype = request.param
    rcfg = CONFIGS[name](dtype)
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (2, PROMPT), dtype=np.int32)
    return dtype, rmodel, rparams, build_model(port_config(rcfg)), tparams, \
        tokens


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_registry_holds_danube_as_the_reference_does():
    assert TC.list_archs() == ["h2o-danube-1.8b"]
    for smoke in (False, True):
        r = RC.get_model_config("h2o-danube-1.8b", smoke=smoke)
        assert port_config(r) == TC.get_model_config("h2o-danube-1.8b",
                                                     smoke=smoke)
    full = TC.get_model_config("h2o-danube-1.8b")
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.window) \
        == (24, 2560, 32, 8, 80, 6912, 4096)
    assert full.compute_dtype is torch.bfloat16
    assert full.layer_kinds == RC.get_model_config("h2o-danube-1.8b").layer_kinds
    assert full.padded_vocab_size == 32000
    assert {k: dataclasses.asdict(v) for k, v in TC.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in RC.INPUT_SHAPES.items()}
    with pytest.raises(KeyError):
        TC.get_model_config("yi-34b")


def test_full_width_param_tree_has_the_reference_keys_and_shapes():
    """H2O-Danube-1.8B at full width: the spec trees agree leaf by leaf (no
    parameter is made)."""
    rcfg = RC.get_model_config("h2o-danube-1.8b")
    rspecs = jax.tree.map(lambda a: tuple(a.shape), r_build(rcfg).abstract())
    tspecs = build_model(port_config(rcfg)).param_specs()

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(tspecs) == rspecs
    assert tspecs["scan_0"]["mix"]["wq"].shape == (24, 2560, 32, 80)
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        rspecs, is_leaf=lambda x: isinstance(x, tuple)))
    assert n == r_build(rcfg).param_count() and 1.8e9 < n < 1.9e9


def test_params_round_trip_through_to_arrays():
    rcfg = _narrow()
    arrays = jax.tree.map(np.asarray, r_build(rcfg).init(jax.random.key(3)))
    back = to_arrays(params_from_reference(arrays, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(arrays)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert b.dtype == np.float32 and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# primitives and blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 320)).astype(np.float32) * 3
    scale = rng.normal(size=(320,)).astype(np.float32) * 0.1
    bias = rng.normal(size=(320,)).astype(np.float32) * 0.1
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _close(_np(TB.rmsnorm(tx, torch.from_numpy(scale))),
           RB.rmsnorm(jx, jnp.asarray(scale)), TOL[dtype])
    _close(_np(TB.layernorm(tx, torch.from_numpy(scale),
                            torch.from_numpy(bias))),
           RB.layernorm(jx, jnp.asarray(scale), jnp.asarray(bias)),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_at_serving_positions(dtype):
    """Positions up to 4500 (the serving prompt), head dim 80, fp32 math."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(1, 64, 4, 80)).astype(np.float32)
    pos = np.sort(rng.integers(0, 4500, 64)).astype(np.int32)
    got = TB.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(pos), 1e4)
    want = RB.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), 1e4)
    _close(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations(name):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(_np(TB.activation(name)(torch.from_numpy(x))),
           RB.activation(name)(jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_apply(gated, dtype):
    rcfg = _narrow(dtype).replace(gated_mlp=gated)
    rp = RB.init_params(RM.specs(rcfg), jax.random.key(1))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(7).normal(size=(2, 9, 320)).astype(np.float32)
    got = TM.apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                   port_config(rcfg))
    want = RM.apply(rp, jnp.asarray(x, dtype), rcfg)
    _close(_np(got), want, TOL[dtype])


@pytest.mark.parametrize("impl", IMPLS, ids=lambda p: p[1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_apply_prefill_then_decode(impl, dtype):
    """One sliding-window layer: prefill 40 tokens (> window 16, so the
    cache rotates), then decode two tokens against the prefill's cache."""
    rimpl, timpl = impl
    rcfg = _narrow(dtype)
    tcfg = port_config(rcfg)
    rp = RB.init_params(RA.specs(rcfg), jax.random.key(2))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, PROMPT, 320)).astype(np.float32)
    jx, tx = jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    ry, rc = RA.apply(rp, jx, rcfg, mode="prefill",
                      positions=jnp.arange(PROMPT), kind="swa", impl=rimpl,
                      max_len=PROMPT + 2)
    ty, tc = TA.apply(tp, tx, tcfg, mode="prefill",
                      positions=torch.arange(PROMPT), kind="swa", impl=timpl,
                      max_len=PROMPT + 2)
    _close(_np(ty), ry, TOL[dtype])
    _close(_np(tc["k"]), rc["k"], TOL[dtype])
    _close(_np(tc["v"]), rc["v"], TOL[dtype])
    assert np.array_equal(tc["slot_pos"].numpy(), np.asarray(rc["slot_pos"]))
    for step in range(2):
        xd = rng.normal(size=(2, 1, 320)).astype(np.float32)
        pos = np.full((2, 1), PROMPT + step, np.int32)
        ry, rc = RA.apply(rp, jnp.asarray(xd, dtype), rcfg, mode="decode",
                          positions=jnp.asarray(pos), cache=rc, kind="swa",
                          impl=rimpl)
        ty, tc = TA.apply(tp, torch.from_numpy(xd).to(getattr(torch, dtype)),
                          tcfg, mode="decode", positions=torch.from_numpy(pos),
                          cache=tc, kind="swa", impl=timpl)
        _close(_np(ty), ry, TOL[dtype])
        _close(_np(tc["k"]), rc["k"], TOL[dtype])
        assert np.array_equal(tc["slot_pos"].numpy(),
                              np.asarray(rc["slot_pos"]))


def test_prefill_cache_pads_a_short_prompt_with_empty_slots():
    """S = 12 < window 16, max_len 20: the cache has 16 slots, 4 empty."""
    rcfg = _narrow()
    rp = RB.init_params(RA.specs(rcfg), jax.random.key(2))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), device="cpu")
    x = np.random.default_rng(9).normal(size=(1, 12, 320)).astype(np.float32)
    _, rc = RA.apply(rp, jnp.asarray(x), rcfg, mode="prefill",
                     positions=jnp.arange(12), kind="swa", max_len=20)
    _, tc = TA.apply(tp, torch.from_numpy(x), port_config(rcfg),
                     mode="prefill", positions=torch.arange(12), kind="swa",
                     max_len=20)
    assert tuple(tc["k"].shape) == (1, 16, 1, 80)
    assert np.array_equal(tc["slot_pos"].numpy(), np.asarray(rc["slot_pos"]))
    _close(_np(tc["v"]), rc["v"], 1e-5)


# ---------------------------------------------------------------------------
# the whole trunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", IMPLS, ids=lambda p: p[1])
def test_forward_prefill_logits_and_cache(pair, impl):
    dtype, rmodel, rparams, tmodel, tparams, tokens = pair
    rimpl, timpl = impl
    rl, rc, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(tokens)},
                             mode="prefill", impl=rimpl,
                             prefill_max_len=PROMPT + NEW)
    tl, tc, _ = tmodel.apply(tparams, {"tokens": tokens}, mode="prefill",
                             impl=timpl, prefill_max_len=PROMPT + NEW)
    _close(_np(tl), rl, LOGIT_TOL[dtype])
    assert sorted(tc) == sorted(rc)
    for key in ("k", "v"):
        assert tc["scan_0"][key].dtype == getattr(torch, dtype)
        _close(_np(tc["scan_0"][key]), rc["scan_0"][key], TOL[dtype])
    assert np.array_equal(tc["scan_0"]["slot_pos"].numpy(),
                          np.asarray(rc["scan_0"]["slot_pos"]))
    assert np.array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))


def test_forward_decode_logits(pair):
    dtype, rmodel, rparams, tmodel, tparams, tokens = pair
    _, rc, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(tokens)},
                            mode="prefill", prefill_max_len=PROMPT + NEW)
    _, tc, _ = tmodel.apply(tparams, {"tokens": tokens}, mode="prefill",
                            prefill_max_len=PROMPT + NEW)
    nxt = tokens[:, -1:]
    for _ in range(2):
        rl, rc, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(nxt)},
                                 mode="decode", cache=rc)
        tl, tc, _ = tmodel.apply(tparams, {"tokens": nxt}, mode="decode",
                                 cache=tc)
        _close(_np(tl), rl, LOGIT_TOL[dtype])
        nxt = (nxt + 1) % rmodel.cfg.vocab_size


@pytest.mark.parametrize("config", list(CONFIGS))
def test_greedy_generate_gives_the_reference_ids_at_fp32(config):
    rcfg = CONFIGS[config]("float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    tokens = np.random.default_rng(2).integers(
        0, rcfg.vocab_size, (2, PROMPT), dtype=np.int32)
    want = np.asarray(r_greedy(rmodel, rparams, jnp.asarray(tokens), NEW))
    tmodel = build_model(port_config(rcfg))
    for impl in ("eager", "flash"):
        got = greedy_generate(tmodel, tparams, torch.from_numpy(tokens), NEW,
                              impl=impl)
        assert got.shape == (2, NEW)
        assert np.array_equal(got.numpy(), want), impl


# ---------------------------------------------------------------------------
# what the port does not run yet
# ---------------------------------------------------------------------------
def test_unported_kinds_raise():
    from repro_torch.models import attention_impl, transformer

    q = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention_impl.causal_attention(q, q, q, impl="pallas")
    cfg = TC.get_model_config("h2o-danube-1.8b", smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TA.apply({}, torch.zeros((1, 2, 128)), cfg, mode="prefill",
                 positions=torch.arange(2), kind="mla")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TA.init_cache(cfg, 1, 8, "mla", torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.moe_specs(cfg)
    for kinds in (("rglru", "rglru", "local"), ("mlstm",)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            transformer.param_specs(cfg.replace(block_pattern=kinds))
    moe = cfg.replace(moe=TC.MoEConfig(num_experts=4, experts_per_token=2,
                                       d_ff=64))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.param_specs(moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg.replace(is_encoder_decoder=True)).param_specs()
