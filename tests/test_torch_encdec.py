"""The encoder-decoder family (Whisper-medium's backbone) of the port against
the reference, on the CPU.

Whisper-medium's smoke variant at ``dtype="float32"`` (2 encoder + 2
decoder layers of 128, 4 heads of 32, 32 frames).  The reference's
parameters are carried across by ``params_from_reference``; frames and
tokens come from a numpy seed.

Held to the reference: ``sinusoidal_positions`` within 1e-6 plus the
position times 2**-22 (one ulp of an fp32 frequency, times the position:
torch's and XLA's ``exp`` differ in the last bit); the encoder
through ``"eager"`` and ``"flash"`` (the kernel's twin here: its
non-causal route) against the reference's ``"xla"`` and ``"pallas"``
(interpret mode); cross attention; train and prefill logits, the cross
cache and the prompt's S-slot self-attention cache (``prefill_max_len=None``,
the reference's layout); decode steps against the reference's on a cache
the test pads to S + new slots (the reference's enc-dec prefill ignores
``prefill_max_len``); ``serve(audio_embeds=)``'s greedy ids against the
reference's prefill and decode steps over the same slots; one training
step.  Logits within 1e-4 (rtol = atol, as
``tests/test_torch_families.py``), greedy ids exactly, the training
step's loss and grad norm within 1e-5 relative.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
import repro.data as RD
from repro.models import base as RB, encdec as RE
from repro.models import build_model as r_build
from repro.optim import make_optimizer as r_opt
from repro.train import steps as RS
import repro_torch.config as TC
from repro_torch.launch import serve as SV
from repro_torch.models import base as TB, encdec as TE
from repro_torch.models import (build_model, params_from_reference,
                                train_state_from_reference)
from repro_torch.train import steps as TS

ARCH = "whisper-medium"
TOL = 1e-4
B, S, NEW = 2, 12, 5
REF_IMPL = {"eager": "xla", "flash": "pallas"}


def port_config(rcfg) -> TC.ModelConfig:
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TC.MoEConfig(**dataclasses.asdict(rcfg.moe))
    return TC.ModelConfig(**kw)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def fam():
    """(reference config, model, params; port config, model, params; a
    numpy batch of tokens, labels and frames)."""
    rcfg = RC.get_model_config(ARCH, smoke=True).replace(dtype="float32")
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


def _pad_self_cache(cache, slots: int):
    """The reference's S-slot self-attention cache with empty slots (k, v
    0; slot_pos -1) appended up to ``slots``."""
    self_c = cache["self"]
    pad = slots - self_c["k"].shape[2]
    kv = [(0, 0)] * 2 + [(0, pad)] + [(0, 0)] * 2
    return dict(cache, self={
        "k": jnp.pad(self_c["k"], kv), "v": jnp.pad(self_c["v"], kv),
        "slot_pos": jnp.pad(self_c["slot_pos"], [(0, 0), (0, 0), (0, pad)],
                            constant_values=-1)})


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
def test_registered_config_and_full_width_tree_are_the_reference():
    for smoke in (False, True):
        r = RC.get_model_config(ARCH, smoke=smoke)
        assert TC.get_model_config(ARCH, smoke=smoke) == port_config(r)
    full = TC.get_model_config(ARCH)
    assert (full.num_encoder_layers, full.num_layers, full.d_model,
            full.num_heads, full.num_kv_heads, full.resolved_head_dim,
            full.d_ff, full.encoder_seq, full.padded_vocab_size) == \
        (24, 24, 1024, 16, 16, 64, 4096, 1500, 51968)
    rspecs = jax.tree.map(lambda a: tuple(a.shape),
                          r_build(RC.get_model_config(ARCH)).abstract())

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    tmodel = build_model(full)
    assert shapes(tmodel.param_specs()) == rspecs
    assert tmodel.param_count() == 811_323_392
    assert tmodel.batch_keys("prefill") == ("tokens", "audio_embeds")


def test_init_cache_has_the_reference_layout(fam):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    rc = rmodel.init_cache(3, 16)
    tc = tmodel.init_cache(3, 16, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), rc)

    def layout(tree):
        if isinstance(tree, dict):
            return {k: layout(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert layout(tc) == want
    assert (tc["self"]["slot_pos"] == -1).all()


@pytest.mark.parametrize("seq,dim", [(32, 128), (7, 10), (1500, 1024)])
def test_sinusoidal_positions_match_the_reference(seq, dim):
    """Each row within 1e-6 plus its position times 2**-22.  The second
    term is the fp32 frequencies' last bit: torch's and XLA's fp32 ``exp``
    differ by one ulp (at most 2**-24 below 1) in some of the frequencies
    (48 of 512 at dim 1024), and the angle ``pos * inv`` carries that ulp
    times the position, plus its own rounding (at most pos * 2**-24): up
    to ~3.6e-4 at Whisper's 1500th frame, 1e-6 at position 0."""
    got = TB.sinusoidal_positions(seq, dim)
    want = np.asarray(RB.sinusoidal_positions(seq, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    tol = 1e-6 + np.arange(seq)[:, None] * 2.0 ** -22
    excess = np.abs(got.numpy() - want) / tol
    assert excess.max() <= 1.0, float(excess.max())
    _close(got[0].numpy(), want[0], 1e-6)


# ---------------------------------------------------------------------------
# encoder and cross attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("frames", [32, 37])
@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_encode_matches_the_reference(fam, impl, frames):
    """The port's encoder through ``impl`` against the reference's through
    its counterpart (``"pallas"``: the Pallas kernel in interpret mode)
    and through ``"xla"``; 37 frames are no multiple of a kernel tile."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    audio = np.random.default_rng(frames).normal(
        size=(B, frames, rcfg.d_model)).astype(np.float32)
    got = TE.encode(tparams, tcfg, torch.from_numpy(audio), impl=impl)
    assert tuple(got.shape) == (B, frames, tcfg.d_model)
    for ref_impl in {REF_IMPL[impl], "xla"}:
        want = RE.encode(rparams, rcfg, jnp.asarray(audio), impl=ref_impl)
        _close(got.numpy(), want, what=ref_impl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_the_reference(fam, dtype):
    """cross_kv and cross_apply; in bf16 the scores are made in bf16 and
    then widened, as the reference's, so the two agree within bf16's
    rounding."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    rng = np.random.default_rng(6)
    enc = rng.normal(size=(B, 32, rcfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, 5, rcfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[1], rparams["dec_scan"]["cross"])
    tp = {k: v[1] for k, v in tparams["dec_scan"]["cross"].items()}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rk, rv = RE.cross_kv(rp, jnp.asarray(enc, jdt))
    tk, tv = TE.cross_kv(tp, torch.from_numpy(enc).to(tdt))
    want = RE.cross_apply(rp, jnp.asarray(x, jdt), rk, rv,
                          rcfg.replace(dtype=dtype))
    got = TE.cross_apply(tp, torch.from_numpy(x).to(tdt), tk, tv,
                         tcfg.replace(dtype=dtype))
    assert got.dtype == tdt and tk.dtype == tdt
    tol = TOL if dtype == "float32" else 5e-2
    for g, w in ((tk, rk), (tv, rv), (got, want)):
        _close(g.float().numpy(), np.asarray(w, np.float32), tol)


# ---------------------------------------------------------------------------
# the trunk
# ---------------------------------------------------------------------------
def test_train_logits_match_the_reference(fam):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    keys = ("tokens", "audio_embeds")
    rl, _, _ = rmodel.apply(rparams, _jax(batch, *keys), mode="train")
    tl, tc, tm = tmodel.apply(tparams, _torch(batch, *keys), mode="train")
    assert tc is None and tuple(tl.shape) == (B, S, tcfg.padded_vocab_size)
    _close(tl.numpy(), rl, what="train logits")
    assert float(tm["aux_loss"]) == 0.0


@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_prefill_logits_and_caches_match_the_reference(fam, impl):
    """Without ``prefill_max_len`` the self-attention cache holds the
    prompt's S slots, as the reference's; the cross cache is the encoder
    output's projections."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    keys = ("tokens", "audio_embeds")
    rl, rc, _ = rmodel.apply(rparams, _jax(batch, *keys), mode="prefill",
                             impl=REF_IMPL[impl])
    tl, tc, _ = tmodel.apply(tparams, _torch(batch, *keys), mode="prefill",
                             impl=impl)
    _close(tl.numpy(), rl, what="prefill logits")
    assert set(tc) == set(rc) and set(tc["self"]) == set(rc["self"])
    assert tc["pos"].tolist() == [S] * B
    assert tc["self"]["slot_pos"].tolist() == \
        np.asarray(rc["self"]["slot_pos"]).tolist()
    for k in ("k", "v"):
        _close(tc["self"][k].numpy(), rc["self"][k], what=f"self {k}")
    for k in ("cross_k", "cross_v"):
        assert tuple(tc[k].shape) == (tcfg.num_layers, B, 32,
                                      tcfg.num_heads, tcfg.resolved_head_dim)
        _close(tc[k].numpy(), rc[k], what=k)


@pytest.mark.parametrize("impl", ["eager", "flash"])
def test_decode_steps_and_greedy_ids_match_the_reference(fam, impl):
    """The port's prefill into S + NEW self-attention slots equals the
    reference's S-slot cache padded here; greedy decode steps from there
    give the reference's logits and ids, step by step."""
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    keys = ("tokens", "audio_embeds")
    V, max_len = tcfg.vocab_size, S + NEW
    rl, rc, _ = rmodel.apply(rparams, _jax(batch, *keys), mode="prefill",
                             last_logit_only=True)
    rc = _pad_self_cache(rc, max_len)
    want_logits, want_ids = [np.asarray(rl[:, 0])], []
    for _ in range(NEW - 1):
        tok = jnp.argmax(rl[:, 0, :V], -1)[:, None].astype(jnp.int32)
        want_ids.append(np.asarray(tok))
        rl, rc, _ = rmodel.apply(rparams, {"tokens": tok}, mode="decode",
                                 cache=rc)
        want_logits.append(np.asarray(rl[:, 0]))
    want_ids.append(np.asarray(jnp.argmax(rl[:, 0, :V], -1)[:, None]))
    tl, tc, _ = tmodel.apply(tparams, _torch(batch, *keys), mode="prefill",
                             impl=impl, prefill_max_len=max_len,
                             last_logit_only=True)
    assert tuple(tc["self"]["k"].shape)[2] == max_len
    assert (tc["self"]["slot_pos"][..., S:] == -1).all()
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
    for k in ("k", "v"):
        _close(tc["self"][k].numpy(), rc["self"][k], what=f"self {k}")
    np.testing.assert_array_equal(tc["self"]["slot_pos"].numpy(),
                                  np.asarray(rc["self"]["slot_pos"]))


def test_serve_with_audio_embeds_decodes_as_the_reference():
    """``serve`` with 32 frames a request: the self-attention cache holds
    prompt + new slots (the frames fill the cross cache), and the ids are
    the reference's prefill and decode steps' over the same slots."""
    rcfg = RC.get_model_config(ARCH, smoke=True).replace(dtype="float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(5))
    cfg = port_config(rcfg)
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (3, 16))
    audio = rng.normal(size=(3, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    res = SV.serve(cfg, params, tokens, new_tokens=NEW, device="cpu",
                   audio_embeds=audio)
    assert res.finite and tuple(res.ids.shape) == (3, NEW)
    V = cfg.vocab_size
    prefill = jax.jit(RS.make_prefill_step(rmodel, max_len=16 + NEW))
    decode = jax.jit(RS.make_decode_step(rmodel))
    last, cache = prefill(rparams, {"tokens": jnp.asarray(tokens, jnp.int32),
                                    "audio_embeds": jnp.asarray(audio)})
    cache = _pad_self_cache(cache, 16 + NEW)
    _close(res.prefill_logits.numpy(), last)
    toks = [jnp.argmax(last[..., :V], -1)[:, None]]
    for _ in range(NEW - 1):
        last, cache = decode(rparams, cache, toks[-1])
        toks.append(jnp.argmax(last[..., :V], -1)[:, None])
    np.testing.assert_array_equal(res.ids.numpy(),
                                  np.asarray(jnp.concatenate(toks, 1)))


def test_serve_flash_and_eager_agree_and_generate_refuses_encdec(fam):
    rcfg, rmodel, rparams, tcfg, tmodel, tparams, batch = fam
    audio = batch["audio_embeds"]
    res = {impl: SV.serve(tcfg, tparams, batch["tokens"], new_tokens=4,
                          impl=impl, device="cpu", audio_embeds=audio)
           for impl in ("eager", "flash")}
    _close(res["flash"].prefill_logits.numpy(),
           res["eager"].prefill_logits.numpy())
    assert torch.equal(res["eager"].ids, res["flash"].ids)
    # as the reference's greedy_generate, the port's takes no frames
    with pytest.raises(NotImplementedError, match="enc-dec"):
        TS.greedy_generate(tmodel, tparams, torch.from_numpy(
            batch["tokens"]), 3)


def test_one_train_step_matches_the_reference(fam):
    """One AdamW step of ``get_train_step`` from the reference's state,
    carried across, with frames in the batch: the loss and the grad
    norm."""
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
    data["audio_embeds"] = np.random.default_rng(4).normal(
        size=(4, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    _, rm = RS.get_train_step(rcfg, rt)(rstate, data)
    _, tm = TS.make_train_step(tmodel, tt)(tstate, data)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) / float(rm[key]) - 1.0) <= 1e-5, key


@pytest.mark.parametrize("arch", ["whisper-medium", "xlstm-350m"])
def test_launcher_serves_the_arch_on_the_cpu(arch, capsys):
    SV.main(["--arch", arch, "--device", "cpu", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out and "generated ids" in out
    ids = eval(out.split("generated ids (req 0):")[1].strip())
    assert len(ids) == 4 and all(0 <= i < 512 for i in ids)
    assert math.isfinite(float(out.split("prefill: ")[1].split(" ms")[0]))
