"""The port's Multi-head Latent Attention against the reference's, on the
CPU.

``repro_torch.models.attention.mla_apply`` against
``repro.models.attention.mla_apply`` on the same layer parameters (the
reference's ``init_params`` over ``mla_specs``, carried across by
``params_from_reference``) and numpy-seeded activations: DeepSeek-V2's
smoke MLA (4 heads, q rank 64, kv rank 32, nope 32 + rope 16, v 32) and a
narrow layer with the full config's head geometry (nope 128 + rope 64 =
192-wide q and k, v 128; 2 heads, ranks 96 / 64).  Train and prefill run
the naive form, decode the absorbed form against the cache the prefill
left, one slot past the prompt and, on a cache with no free slot, at the
clamped last slot (``min(pos, cache_len - 1)``).

Tolerances (``assert_allclose``, rtol = atol): fp32 within 1e-5 (fp32
products summed in another order), bf16 within 5e-2.  The trunk's
absorbed decode equals teacher forcing within 2e-4, as
``tests/test_models.py`` holds the reference's.
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
from repro.models import attention as RA, base as RB
import repro_torch.config as TC
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TA
from repro_torch.models import build_model, params_from_reference

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
S = 12


def port_config(rcfg) -> TC.ModelConfig:
    """The port's ModelConfig with the reference's field values."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TC.MoEConfig(**dataclasses.asdict(rcfg.moe))
    if rcfg.mla is not None:
        kw["mla"] = TC.MLAConfig(**dataclasses.asdict(rcfg.mla))
    return TC.ModelConfig(**kw)


def _smoke():
    return RC.get_model_config("deepseek-v2-236b", smoke=True)


def _narrow():
    full = RC.get_model_config("deepseek-v2-236b")
    return _smoke().replace(
        d_model=256, num_heads=2, num_kv_heads=2, head_dim=128,
        mla=dataclasses.replace(full.mla, kv_lora_rank=64, q_lora_rank=96))


LAYERS = {"smoke": _smoke, "narrow-192": _narrow}


def _layer(name, dtype):
    rcfg = LAYERS[name]().replace(dtype=dtype)
    rparams = jax.tree.map(np.asarray, RB.init_params(
        RA.mla_specs(rcfg), jax.random.key(7)))
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, S, rcfg.d_model)).astype(np.float32)
    x1 = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
    return rcfg, port_config(rcfg), rparams, x, x1


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol,
                               err_msg=what)


def _cache_close(tc, rc, tol):
    assert set(tc) == set(rc) == {"ckv", "kpe", "slot_pos"}
    for key in ("ckv", "kpe"):
        assert tuple(tc[key].shape) == tuple(rc[key].shape), key
        _close(tc[key], rc[key], tol, key)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(),
                                  np.asarray(rc["slot_pos"]))


def _to_port_cache(rc, dtype):
    return {k: (torch.from_numpy(np.array(v)) if k == "slot_pos"
                else torch.from_numpy(_f32(v).copy()).to(dtype))
            for k, v in rc.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_mla_apply_matches_the_reference(name, dtype):
    """Train, prefill (cache padded to S + 4) and two absorbed decode
    steps: one into a free slot, one at position S + 4 of a cache of S + 4
    slots (clamped to the last)."""
    rcfg, tcfg, rparams, x, x1 = _layer(name, dtype)
    tol = TOL[dtype]
    rdt, tdt = rcfg.compute_dtype, tcfg.compute_dtype
    rp = jax.tree.map(jnp.asarray, rparams)
    tp = params_from_reference(rparams, device="cpu")
    rx, tx = jnp.asarray(x).astype(rdt), torch.from_numpy(x).to(tdt)
    pos = np.arange(S)
    ry, _ = RA.mla_apply(rp, rx, rcfg, mode="train",
                         positions=jnp.asarray(pos))
    ty, tc = TA.mla_apply(tp, tx, tcfg, mode="train",
                          positions=torch.from_numpy(pos))
    assert tc is None and ty.dtype == tdt
    _close(ty, ry, tol, "train")
    ry, rc = RA.mla_apply(rp, rx, rcfg, mode="prefill",
                          positions=jnp.asarray(pos), max_len=S + 4)
    ty, tc = TA.mla_apply(tp, tx, tcfg, mode="prefill",
                          positions=torch.from_numpy(pos), max_len=S + 4)
    _close(ty, ry, tol, "prefill")
    _cache_close(tc, rc, tol)
    # decode from the reference's own cache, carried across
    r1x, t1x = jnp.asarray(x1).astype(rdt), torch.from_numpy(x1).to(tdt)
    for p in (S, S + 4):
        dpos = np.full((2, 1), p, np.int32)
        ry, rc = RA.mla_apply(rp, r1x, rcfg, mode="decode",
                              positions=jnp.asarray(dpos), cache=rc)
        before = _to_port_cache(rc, tdt) if p == S else tcache
        given = {k: v.clone() for k, v in before.items()}
        ty, tcache = TA.mla_apply(tp, t1x, tcfg, mode="decode",
                                  positions=torch.from_numpy(dpos),
                                  cache=given)
        # a step returns a new cache and leaves the one it was given
        assert all(torch.equal(given[k], before[k]) for k in given)
        _close(ty, ry, tol, f"decode at {p}")
        _cache_close(tcache, rc, tol)
        if p == S:
            tcache = _to_port_cache(rc, tdt)
    # the clamped step overwrote the last slot
    assert tcache["slot_pos"][:, -1].tolist() == [S + 4, S + 4]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_scale_rounds_as_the_reference(dtype):
    """``1.0 / jnp.sqrt(jnp.asarray(192, float32)).astype(dtype)``
    (``src/repro/models/attention.py:200``): the square root is rounded to
    the dtype before the quotient."""
    for name in LAYERS:
        rcfg = LAYERS[name]()
        m = rcfg.mla
        want = 1.0 / jnp.sqrt(jnp.asarray(
            m.qk_nope_head_dim + m.qk_rope_head_dim,
            jnp.float32)).astype(jnp.dtype(dtype))
        got = TA.mla_scale(port_config(rcfg), getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype) and got.dim() == 0
        assert float(got) == float(want)


def test_mla_prefill_never_takes_the_flash_path(monkeypatch):
    """impl="flash" reaches an MLA layer as the reference's "pallas" does:
    the layer pins the eager contraction, so no flash call is made."""
    rcfg, tcfg, rparams, x, _ = _layer("narrow-192", "bfloat16")
    tp = params_from_reference(rparams, device="cpu")
    tx = torch.from_numpy(x).to(torch.bfloat16)

    def refuse(*a, **k):
        raise AssertionError("flash_attention called from an MLA layer")

    monkeypatch.setattr(FA, "flash_attention", refuse)
    kw = dict(mode="prefill", positions=torch.arange(S), kind=TC.MLA,
              max_len=S)
    y_flash, c_flash = TA.apply(tp, tx, tcfg, impl="flash", **kw)
    y_eager, c_eager = TA.apply(tp, tx, tcfg, impl="eager", **kw)
    assert torch.equal(y_flash, y_eager)
    assert all(torch.equal(c_flash[k], c_eager[k]) for k in c_flash)


def test_mla_specs_and_cache_are_the_reference_ones():
    for rcfg in (_smoke(), _narrow(), RC.get_model_config("deepseek-v2-236b")):
        tcfg = port_config(rcfg)
        want = jax.tree.map(lambda s: (s.shape, s.axes, s.init),
                            RA.mla_specs(rcfg),
                            is_leaf=lambda s: isinstance(s, RB.ParamSpec))

        def conv(sp):
            if isinstance(sp, dict):
                return {k: conv(v) for k, v in sp.items()}
            return (sp.shape, sp.axes, sp.init)

        assert conv(TA.mla_specs(tcfg)) == want
    rcfg = _smoke()
    rc = RA.init_cache(rcfg, 3, 10, RC.MLA)
    tc = TA.init_cache(port_config(rcfg), 3, 10, TC.MLA, torch.device("cpu"))
    for key in rc:
        assert tuple(tc[key].shape) == tuple(rc[key].shape), key
        np.testing.assert_array_equal(_f32(tc[key]), _f32(rc[key]))
    assert tc["ckv"].dtype == torch.bfloat16
    assert tc["slot_pos"].dtype == torch.int32


@pytest.mark.parametrize("name", ["smoke", "narrow-192"])
def test_absorbed_decode_equals_teacher_forcing(name):
    """DeepSeek-V2's MLA trunk at fp32 in the port alone: prefill(S - 3)
    and three decode steps give the full forward's logits at those
    positions.  The MoE is off (dense MLPs): a decode step routes its 2
    tokens at a capacity of 1 slot an expert, the full forward 24 tokens at
    9, so with experts on the two can drop different assignments."""
    rcfg = LAYERS[name]().replace(dtype="float32", remat=False,
                                  moe=RC.MoEConfig())
    cfg = port_config(rcfg)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, S)))
    full, _, _ = model.apply(params, {"tokens": toks}, mode="train")
    V = cfg.vocab_size
    _, cache, _ = model.apply(params, {"tokens": toks[:, :S - 3]},
                              mode="prefill", prefill_max_len=S)
    for t in range(S - 3, S):
        dec, cache, _ = model.apply(params, {"tokens": toks[:, t:t + 1]},
                                    mode="decode", cache=cache)
        np.testing.assert_allclose(dec[:, 0, :V].numpy(),
                                   full[:, t, :V].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=str(t))
    assert cache["pos"].tolist() == [S, S]
