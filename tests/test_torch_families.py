"""The dense, VLM, MoE and MLA families of the port against the reference,
on the CPU.

Six architectures, each in its smoke variant at ``dtype="float32"``:
Qwen3-32B (qk-norm, GQA), Yi-34B (GQA, head dim 16), Granite-34B (MQA,
plain GeLU MLP), InternVL2-1B (a VLM: patch embeddings prepended, tied
embeddings), Granite-MoE-1B-A400M (GShard MoE in every layer) and
DeepSeek-V2-236B (MLA in every layer, a dense first layer, then MoE with
a shared expert).  The reference's parameters are carried across by
``params_from_reference``; inputs come from a numpy seed.

Held to the reference: the registered configs (full and smoke) and the
full-width parameter trees; train, prefill and decode logits within 1e-4
(rtol = atol; fp32 products summed in another order, torch's and XLA's
sin/cos differ in the last bits), the prefill through both attention
paths (the reference's ``"xla"`` against the port's ``"eager"`` and
``"flash"``; the flash twin is held to the reference's Pallas kernel in
``tests/test_torch_flash.py``); greedy ids exactly; one training
step's loss and grad norm within 1e-5 relative and its aux loss within
1e-5 (``tests/test_torch_train.py``'s tolerances).  ``serve`` with a VLM's
``extra_embeds`` decodes as teacher forcing does (2e-4, as
``tests/test_models.py`` holds the reference's decode) and as the
reference's prefill and decode steps do over the same cache slots.
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
from repro.models import build_model as r_build
from repro.optim import make_optimizer as r_opt
from repro.train import steps as RS
import repro_torch.config as TC
from repro_torch.launch import serve as SV
from repro_torch.models import (build_model, params_from_reference,
                                train_state_from_reference)
from repro_torch.train import steps as TS

ARCHS = ("qwen3-32b", "yi-34b", "granite-34b", "internvl2-1b",
         "granite-moe-1b-a400m", "deepseek-v2-236b")
LOGIT_TOL = 1e-4
B, S, NEW = 2, 20, 5


def port_config(rcfg) -> TC.ModelConfig:
    """The port's ModelConfig with the reference's field values."""
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TC.MoEConfig(**dataclasses.asdict(rcfg.moe))
    if rcfg.mla is not None:
        kw["mla"] = TC.MLAConfig(**dataclasses.asdict(rcfg.mla))
    return TC.ModelConfig(**kw)


def _close(got, want, tol=LOGIT_TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """(reference config, model, params; port config, model, params; a
    numpy batch with tokens, labels and, for a VLM, extra_embeds)."""
    rcfg = RC.get_model_config(request.param, smoke=True).replace(
        dtype="float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    tcfg = port_config(rcfg)
    tparams = params_from_reference(jax.tree.map(np.asarray, rparams),
                                    device="cpu")
    batch = rmodel.make_batch(B, S, seed=1)
    return rcfg, rmodel, rparams, tcfg, build_model(tcfg), tparams, batch


def _jax(batch, *keys):
    return {k: jnp.asarray(v) for k, v in batch.items() if k in keys}


def _torch(batch, *keys):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
            if k in keys}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_registry_holds_the_six_families_as_the_reference_does():
    for arch in ARCHS:
        for smoke in (False, True):
            r = RC.get_model_config(arch, smoke=smoke)
            assert TC.get_model_config(arch, smoke=smoke) == port_config(r)
            assert TC.get_model_config(arch, smoke=smoke).layer_kinds \
                == r.layer_kinds
    full = {a: TC.get_model_config(a) for a in ARCHS}
    # the head geometry the card's flash grid holds: (H, KV, hd)
    assert {a: (c.num_heads, c.num_kv_heads, c.resolved_head_dim)
            for a, c in full.items() if c.mla is None} == {
        "qwen3-32b": (64, 8, 128), "yi-34b": (56, 8, 128),
        "granite-34b": (48, 1, 128), "internvl2-1b": (14, 2, 64),
        "granite-moe-1b-a400m": (16, 8, 64)}
    ds = full["deepseek-v2-236b"]
    assert set(ds.layer_kinds) == {TC.MLA} and ds.moe.first_dense_layers == 1
    assert (ds.moe.num_experts, ds.moe.experts_per_token,
            ds.moe.num_shared_experts) == (160, 6, 2)
    assert full["granite-moe-1b-a400m"].padded_vocab_size == 49408


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_tree_has_the_reference_keys_and_shapes(arch):
    """At full width and depth (no parameter is made): the spec trees
    agree leaf by leaf, and so do the parameter counts."""
    rcfg = RC.get_model_config(arch)
    rspecs = jax.tree.map(lambda a: tuple(a.shape), r_build(rcfg).abstract())
    tmodel = build_model(port_config(rcfg))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(tmodel.param_specs()) == rspecs
    assert tmodel.param_count() == r_build(rcfg).param_count()


# ---------------------------------------------------------------------------
# the forward passes
# ---------------------------------------------------------------------------
def test_train_logits_match_the_reference(fam):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    keys = ("tokens", "extra_embeds")
    rl, _, rm = rmodel.apply(rparams, _jax(batch, *keys), mode="train")
    tl, _, tm = tmodel.apply(tparams, _torch(batch, *keys), mode="train")
    assert tuple(tl.shape) == (B, S, tcfg.padded_vocab_size)
    _close(tl.numpy(), rl, what="train logits")
    _close(float(tm["aux_loss"]), float(rm["aux_loss"]), 1e-5, "aux loss")
    assert (float(tm["aux_loss"]) > 0) == tcfg.moe.enabled


def test_prefill_decode_and_greedy_ids_match_the_reference(fam):
    """The reference's prefill (``impl="xla"``) into a cache of prefix + S
    + NEW slots, then greedy decode steps from its own cache; the port's
    the same way through both attention paths (``"eager"``, and
    ``"flash"``: the kernel's twin here), each held step by step to the
    reference's logits, its greedy ids equal to the reference's."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    keys = ("tokens", "extra_embeds")
    n_prefix = tcfg.num_prefix_tokens if tcfg.frontend == "vision" else 0
    max_len = n_prefix + S + NEW
    V = tcfg.vocab_size
    rl, rc, _ = rmodel.apply(rparams, _jax(batch, *keys), mode="prefill",
                             prefill_max_len=max_len, last_logit_only=True)
    want_logits, want_ids = [np.asarray(rl[:, 0])], []
    for _ in range(NEW - 1):
        tok = jnp.argmax(rl[:, 0, :V], -1)[:, None].astype(jnp.int32)
        want_ids.append(np.asarray(tok))
        rl, rc, _ = rmodel.apply(rparams, {"tokens": tok}, mode="decode",
                                 cache=rc)
        want_logits.append(np.asarray(rl[:, 0]))
    want_ids.append(np.asarray(jnp.argmax(rl[:, 0, :V], -1)[:, None]))
    for impl in ("eager", "flash"):
        tl, tc, _ = tmodel.apply(tparams, _torch(batch, *keys),
                                 mode="prefill", impl=impl,
                                 prefill_max_len=max_len,
                                 last_logit_only=True)
        ids = []
        for t in range(NEW):
            _close(tl[:, 0].numpy(), want_logits[t], what=f"{impl} step {t}")
            tok = torch.argmax(tl[:, 0, :V], -1)[:, None]
            ids.append(tok)
            if t < NEW - 1:
                tl, tc, _ = tmodel.apply(tparams, {"tokens": tok},
                                         mode="decode", cache=tc, impl=impl)
        np.testing.assert_array_equal(torch.cat(ids, 1).numpy(),
                                      np.concatenate(want_ids, 1))
        assert tc["pos"].tolist() == [max_len - 1] * B


def test_one_train_step_matches_the_reference(fam):
    """One AdamW step of ``get_train_step`` from the reference's state,
    carried across: the loss (the aux loss in it) and the grad norm."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    rt = RC.TrainConfig(global_batch=4, seq_len=16, learning_rate=1e-2,
                        warmup_steps=2, total_steps=10)
    tt = TC.TrainConfig(**dataclasses.asdict(rt))
    rstate = RS.TrainState(rparams, r_opt(rt).init(rparams),
                           jnp.zeros((), jnp.int32))
    tstate = train_state_from_reference(jax.tree.map(np.asarray, rstate),
                                        device="cpu")
    data = RD.FederatedDataLoader(rcfg.vocab_size, 16, 1, 4, seed=0) \
        .next_batch(0)
    if rcfg.frontend == "vision":
        data["extra_embeds"] = np.random.default_rng(4).normal(
            size=(4, rcfg.num_prefix_tokens, rcfg.d_model)).astype(np.float32)
    _, rm = RS.get_train_step(rcfg, rt)(rstate, data)
    _, tm = TS.make_train_step(tmodel, tt)(tstate, data)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) / float(rm[key]) - 1.0) <= 1e-5, key
    _close(float(tm["aux_loss"]), float(rm["aux_loss"]), 1e-5, "aux loss")


# ---------------------------------------------------------------------------
# serving a VLM
# ---------------------------------------------------------------------------
def test_serve_with_extra_embeds_decodes_as_teacher_forcing():
    """InternVL2-1B's smoke variant with 8 patch embeddings a request: the
    generated ids are the reference's (its prefill and decode steps over
    prefix + prompt + new cache slots), and each decode step's token is the
    argmax of the full forward over the prompt and the tokens before it,
    whose last-prompt logits equal serve's prefill logits."""
    rcfg = RC.get_model_config("internvl2-1b", smoke=True).replace(
        dtype="float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(5))
    cfg = port_config(rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (3, 16))
    extra = rng.normal(size=(3, cfg.num_prefix_tokens,
                             cfg.d_model)).astype(np.float32)
    res = SV.serve(cfg, params, tokens, new_tokens=NEW, device="cpu",
                   extra_embeds=extra)
    assert res.finite and tuple(res.ids.shape) == (3, NEW)
    # teacher forcing: the prompt and the generated tokens in one forward
    seq = np.concatenate([tokens, res.ids[:, :-1].numpy()], axis=1)
    full, _, _ = build_model(cfg).apply(
        params, {"tokens": torch.from_numpy(seq),
                 "extra_embeds": torch.from_numpy(extra)}, mode="train")
    V = cfg.vocab_size
    _close(res.prefill_logits[:, :V].numpy(), full[:, 15, :V].numpy(), 2e-4)
    assert torch.equal(res.ids, torch.argmax(full[:, 15:, :V], -1))
    # the reference's prefill and decode steps, its cache sized as serve's
    max_len = cfg.num_prefix_tokens + 16 + NEW
    prefill = jax.jit(RS.make_prefill_step(rmodel, max_len=max_len))
    decode = jax.jit(RS.make_decode_step(rmodel))
    last, cache = prefill(rparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                    "extra_embeds": jnp.asarray(extra)})
    _close(res.prefill_logits.numpy(), last, LOGIT_TOL)
    toks = [jnp.argmax(last[..., :V], -1)[:, None]]
    for _ in range(NEW - 1):
        last, cache = decode(rparams, cache, toks[-1])
        toks.append(jnp.argmax(last[..., :V], -1)[:, None])
    np.testing.assert_array_equal(res.ids.numpy(),
                                  np.asarray(jnp.concatenate(toks, 1)))


def test_ragged_vocab_masks_pad_columns_as_the_reference():
    """Granite-MoE's full vocab of 49155 is ragged (padded to 49408); the
    smoke MoE at a ragged 500 (padded to 512), as ``tests/test_models.py``
    forces it: the pad columns are -1e30 and the rest are the
    reference's."""
    rcfg = RC.get_model_config("granite-moe-1b-a400m", smoke=True).replace(
        dtype="float32", vocab_size=500)
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(0))
    cfg = port_config(rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    batch = rmodel.make_batch(1, 4)
    rl, _, _ = rmodel.apply(rparams, {"tokens": jnp.asarray(
        batch["tokens"])}, mode="train")
    tl, _, _ = build_model(cfg).apply(params, {"tokens": torch.from_numpy(
        batch["tokens"])}, mode="train")
    assert cfg.padded_vocab_size == 512
    assert (tl[..., 500:] == -1e30).all()
    _close(tl[..., :500].numpy(), np.asarray(rl)[..., :500])
