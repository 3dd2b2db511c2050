"""The xLSTM family of the port against the reference, on the CPU.

xLSTM-350M's smoke variant at ``dtype="float32"`` (2 layers of 128, 4
heads: one (mLSTM, sLSTM) period), its blocks alone and the whole trunk.
The reference's parameters are carried across by ``params_from_reference``
(``init_params`` of one block's specs for the block cases); inputs come
from a numpy seed.

Held to the reference within 1e-4 (rtol = atol, as
``tests/test_torch_families.py`` holds the other families): the per-head
group norm; ``mlstm_apply`` and ``slstm_apply`` in train, prefill and
decode, with the prefill's recurrent states ``(C, n, m, conv)`` and
``(sc, sn, sm, sh)``, at S = 20 and at S = 1100 (the mLSTM's parallel form
chunked, 2 chunks of 550 queries: S <= 1024 never chunks), with the
parameters as initialised and with a forget-gate bias of about 3 (long
memory: the decay spans the whole sequence); the trunk's train, prefill
and decode logits; greedy ids exactly; one training step's loss and grad
norm within 1e-5 relative (``tests/test_torch_train.py``'s tolerances).
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
import repro.data as RD
from repro.models import base as RB, recurrent as RR
from repro.models import build_model as r_build
from repro.optim import make_optimizer as r_opt
from repro.train import steps as RS
import repro_torch.config as TC
from repro_torch.models import attention_impl as TI, recurrent as TR
from repro_torch.models import (build_model, params_from_reference,
                                train_state_from_reference)
from repro_torch.train import steps as TS

ARCH = "xlstm-350m"
TOL = 1e-4
B, S, NEW = 2, 20, 5


def port_config(rcfg) -> TC.ModelConfig:
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TC.MoEConfig(**dataclasses.asdict(rcfg.moe))
    return TC.ModelConfig(**kw)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _cfgs():
    rcfg = RC.get_model_config(ARCH, smoke=True).replace(dtype="float32")
    return rcfg, port_config(rcfg)


def _block_params(kind: str, gates: str, seed: int = 0):
    """One block's reference parameters (numpy) and the port's.  ``gates
    = "long"`` sets the forget-gate biases to 3 + N(0, 1) and the group
    norm's scale to N(0, 0.1)."""
    rcfg, _ = _cfgs()
    specs = RR.mlstm_specs(rcfg) if kind == "mlstm" else RR.slstm_specs(rcfg)
    rp = jax.tree.map(np.asarray,
                      RB.init_params(specs, jax.random.key(seed)))
    if gates == "long":
        rng = np.random.default_rng(seed + 7)
        rp["gn_scale"] = rng.normal(0, 0.1, rp["gn_scale"].shape).astype(
            np.float32)
        if kind == "mlstm":
            H = rcfg.num_heads
            rp["b_if"] = rp["b_if"].copy()
            rp["b_if"][H:] = 3.0 + rng.normal(size=H)
        else:
            rp["b_f"] = (3.0 + rng.normal(size=rp["b_f"].shape)).astype(
                np.float32)
    return rp, params_from_reference(rp, device="cpu")


def _x(seq: int, seed: int = 3):
    return np.random.default_rng(seed).normal(
        size=(B, seq, 128)).astype(np.float32)


APPLY = {"mlstm": (RR.mlstm_apply, TR.mlstm_apply),
         "slstm": (RR.slstm_apply, TR.slstm_apply)}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_registered_config_and_full_width_tree_are_the_reference():
    for smoke in (False, True):
        r = RC.get_model_config(ARCH, smoke=smoke)
        t = TC.get_model_config(ARCH, smoke=smoke)
        assert t == port_config(r) and t.layer_kinds == r.layer_kinds
    full = TC.get_model_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.padded_vocab_size) == (24, 1024, 4, 50432)
    assert full.layer_kinds == (("mlstm",) * 7 + ("slstm",)) * 3
    rspecs = jax.tree.map(lambda a: tuple(a.shape),
                          r_build(RC.get_model_config(ARCH)).abstract())

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    tmodel = build_model(full)
    assert shapes(tmodel.param_specs()) == rspecs
    assert tmodel.param_count() == 528_641_192


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_cache_is_the_reference_state(kind):
    rcfg, tcfg = _cfgs()
    rinit = RR.mlstm_init_cache if kind == "mlstm" else RR.slstm_init_cache
    tinit = TR.mlstm_init_cache if kind == "mlstm" else TR.slstm_init_cache
    rc, tc = rinit(rcfg, 3), tinit(tcfg, 3, torch.device("cpu"))
    assert set(tc) == set(rc)
    for k in rc:
        assert tc[k].dtype == getattr(torch, str(rc[k].dtype))
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(rc[k]))


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------
def test_groupnorm_heads_matches_the_reference():
    rng = np.random.default_rng(11)
    h = (rng.normal(size=(2, 7, 4, 64)) * 3 + 1).astype(np.float32)
    scale = rng.normal(0, 0.5, (4, 64)).astype(np.float32)
    want = RR._groupnorm_heads(jnp.asarray(h), jnp.asarray(scale))
    got = TR._groupnorm_heads(torch.from_numpy(h), torch.from_numpy(scale))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)


@pytest.mark.parametrize("gates", ["init", "long"])
@pytest.mark.parametrize("seq", [S, 1100])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_prefill_and_decode_match_the_reference(kind, seq, gates):
    """Train and prefill outputs, the prefill's state, then two decode
    steps, each side from its own state."""
    rcfg, tcfg = _cfgs()
    rapply, tapply = APPLY[kind]
    rp, tp = _block_params(kind, gates)
    x = _x(seq)
    if kind == "mlstm":
        assert TI.chunk_size(seq) == (550 if seq == 1100 else seq)
    ry, rn = rapply(rp, jnp.asarray(x), rcfg, mode="train")
    ty, tn = tapply(tp, torch.from_numpy(x), tcfg, mode="train")
    assert rn is None and tn is None
    _close(ty.numpy(), ry, what="train")
    ry, rc = rapply(rp, jnp.asarray(x), rcfg, mode="prefill")
    ty, tc = tapply(tp, torch.from_numpy(x), tcfg, mode="prefill")
    _close(ty.numpy(), ry, what="prefill")
    assert set(tc) == set(rc)
    for k in rc:
        _close(tc[k].numpy(), rc[k], what=f"prefill state {k}")
    for step in range(2):
        xd = _x(1, seed=20 + step)
        ry, rc = rapply(rp, jnp.asarray(xd), rcfg, mode="decode", cache=rc)
        ty, tc = tapply(tp, torch.from_numpy(xd), tcfg, mode="decode",
                        cache=tc)
        _close(ty.numpy(), ry, what=f"decode {step}")
        for k in rc:
            _close(tc[k].numpy(), rc[k], what=f"decode {step} state {k}")


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_from_the_reference_state_continues_it(kind):
    """The reference's prefill state carried across: the port's decode step
    from it is the reference's."""
    rcfg, tcfg = _cfgs()
    rapply, tapply = APPLY[kind]
    rp, tp = _block_params(kind, "long", seed=4)
    _, rc = rapply(rp, jnp.asarray(_x(33)), rcfg, mode="prefill")
    tc = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in rc.items()}
    xd = _x(1, seed=9)
    ry, rc = rapply(rp, jnp.asarray(xd), rcfg, mode="decode", cache=rc)
    ty, tc = tapply(tp, torch.from_numpy(xd), tcfg, mode="decode", cache=tc)
    _close(ty.numpy(), ry)
    for k in rc:
        _close(tc[k].numpy(), rc[k], what=k)


def test_block_bfloat16_keeps_the_reference_dtypes():
    """At bf16 compute the outputs and conv state are bf16, the recurrent
    states fp32, as the reference's."""
    rcfg, tcfg = _cfgs()
    rcfg, tcfg = rcfg.replace(dtype="bfloat16"), tcfg.replace(
        dtype="bfloat16")
    for kind in ("mlstm", "slstm"):
        rapply, tapply = APPLY[kind]
        rp, tp = _block_params(kind, "init")
        x = _x(12)
        ry, rc = rapply(rp, jnp.asarray(x, jnp.bfloat16), rcfg,
                        mode="prefill")
        ty, tc = tapply(tp, torch.from_numpy(x).bfloat16(), tcfg,
                        mode="prefill")
        assert ty.dtype == torch.bfloat16
        assert {k: str(v.dtype).split(".")[-1] for k, v in tc.items()} == \
            {k: str(v.dtype) for k, v in rc.items()}
        _close(ty.float().numpy(), np.asarray(ry, np.float32), 5e-2)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trunk():
    rcfg, tcfg = _cfgs()
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    batch = rmodel.make_batch(B, S, seed=1)
    return rcfg, rmodel, rparams, tcfg, build_model(tcfg), tparams, batch


def test_trunk_train_logits_match_the_reference(trunk):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = trunk
    rl, _, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(
        batch["tokens"])}, mode="train")
    tl, _, tm = tmodel.apply(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, mode="train")
    assert tuple(tl.shape) == (B, S, tcfg.padded_vocab_size)
    _close(tl.numpy(), rl, what="train logits")
    assert float(tm["aux_loss"]) == 0.0


@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_trunk_prefill_decode_and_greedy_ids_match_the_reference(trunk,
                                                                 impl):
    """The reference's prefill, then greedy decode steps from its own
    state; the port's the same way (the xLSTM blocks run plain torch on
    either impl), each step's logits held to the reference's, its greedy
    ids equal to the reference's."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = trunk
    V = tcfg.vocab_size
    rl, rc, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(
        batch["tokens"])}, mode="prefill", prefill_max_len=S + NEW,
        last_logit_only=True)
    want_logits, want_ids = [np.asarray(rl[:, 0])], []
    for _ in range(NEW - 1):
        tok = jnp.argmax(rl[:, 0, :V], -1)[:, None].astype(jnp.int32)
        want_ids.append(np.asarray(tok))
        rl, rc, _ = rmodel.apply(rparams, {"tokens": tok}, mode="decode",
                                 cache=rc)
        want_logits.append(np.asarray(rl[:, 0]))
    want_ids.append(np.asarray(jnp.argmax(rl[:, 0, :V], -1)[:, None]))
    tl, tc, _ = tmodel.apply(tparams, {"tokens": torch.from_numpy(
        batch["tokens"])}, mode="prefill", impl=impl,
        prefill_max_len=S + NEW, last_logit_only=True)
    ids = []
    for t in range(NEW):
        _close(tl[:, 0].numpy(), want_logits[t], what=f"step {t}")
        tok = torch.argmax(tl[:, 0, :V], -1)[:, None]
        ids.append(tok)
        if t < NEW - 1:
            tl, tc, _ = tmodel.apply(tparams, {"tokens": tok},
                                     mode="decode", cache=tc, impl=impl)
    np.testing.assert_array_equal(torch.cat(ids, 1).numpy(),
                                  np.concatenate(want_ids, 1))
    assert tc["pos"].tolist() == [S + NEW - 1] * B


def test_trunk_cache_has_the_reference_layout(trunk):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = trunk
    rc = rmodel.init_cache(3, 16)
    tc = tmodel.init_cache(3, 16, device="cpu")
    want = {k: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), v)
            for k, v in rc.items()}

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert layout(tc) == want


def test_one_train_step_matches_the_reference(trunk):
    """One AdamW step of ``get_train_step`` from the reference's state,
    carried across: the loss and the grad norm."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = trunk
    rt = RC.TrainConfig(global_batch=4, seq_len=16, learning_rate=1e-2,
                        warmup_steps=2, total_steps=10)
    tt = TC.TrainConfig(**dataclasses.asdict(rt))
    rstate = RS.TrainState(rparams, r_opt(rt).init(rparams),
                           jnp.zeros((), jnp.int32))
    tstate = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                        device="cpu")
    data = RD.FederatedDataLoader(rcfg.vocab_size, 16, 1, 4, seed=0) \
        .next_batch(0)
    _, rm = RS.get_train_step(rcfg, rt)(rstate, data)
    _, tm = TS.make_train_step(tmodel, tt)(tstate, data)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) / float(rm[key]) - 1.0) <= 1e-5, key


def test_serve_flash_and_eager_paths_agree():
    """``serve`` at the smoke size: greedy ids of the eager and flash paths
    agree (no kernel on this family's path)."""
    from repro_torch.launch import serve as SV

    cfg = TC.get_model_config(ARCH, smoke=True).replace(dtype="float32")
    params = build_model(cfg).init(0, device="cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 12))
    res = {impl: SV.serve(cfg, params, tokens, new_tokens=4, impl=impl,
                          device="cpu") for impl in ("eager", "flash")}
    assert all(r.finite for r in res.values())
    assert torch.equal(res["eager"].ids, res["flash"].ids)
