"""The port's serving slice on the CPU: the launcher, the serve loop and
parameter initialisation.

``repro_torch.launch.serve`` batches requests, prefills once (flash
attention: the kernel's twin on the CPU) and decodes token by token.  Its
generated ids are held against the port's own ``greedy_generate`` and, at
fp32, against the reference's (``repro.train.steps.greedy_generate``, with
the reference's weights carried across), for H2O-Danube-1.8B's and
RecurrentGemma-2B's smoke configs (the latter's prefill runs the
``rglru_scan`` kernel's twin and the flash twin at once).  ``Model.init`` draws each leaf
from its own generator, seeded from the seed and the leaf's path.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src_torch"))
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.config as RC
from repro.models import build_model as r_build
from repro.train.steps import greedy_generate as r_greedy
import repro_torch.config as TC
from repro_torch.launch import serve as S
from repro_torch.models import base as TB
from repro_torch.models import build_model, params_from_reference
from repro_torch.train.steps import greedy_generate

SMOKE = TC.get_model_config("h2o-danube-1.8b", smoke=True)
RG_SMOKE = TC.get_model_config("recurrentgemma-2b", smoke=True)


def _leaves(tree, path=""):
    return list(TB.iter_leaves(tree, path))


def test_main_on_the_cpu_prints_generated_ids(capsys):
    """With no ``--arch``, the reference's default: Yi-34B's smoke variant
    (head dim 16, through the flash kernel's twin)."""
    S.main(["--device", "cpu", "--new-tokens", "6"])
    out = capsys.readouterr().out
    assert "arch=yi-34b-smoke batch=4 prompt=32 device=cpu" in out
    line = [ln for ln in out.splitlines()
            if ln.startswith("generated ids (req 0):")]
    assert len(line) == 1
    ids = eval(line[0].split(":", 1)[1])
    yi = TC.get_model_config("yi-34b", smoke=True)
    assert len(ids) == 6 and all(0 <= i < yi.vocab_size for i in ids)


def test_main_defaults_to_the_reference_arch(monkeypatch):
    """Both launchers' parsed arguments, stopped before any model is
    built."""
    import argparse

    import repro.launch.serve as RSV

    parsed = []
    real = argparse.ArgumentParser.parse_args

    def stop(self, argv=None, namespace=None):
        parsed.append(real(self, argv, namespace))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    for main in (S.main, RSV.main):
        with pytest.raises(SystemExit):
            main([])
    assert [a.arch for a in parsed] == ["yi-34b", "yi-34b"]


def test_main_passes_a_vision_arch_its_patch_embeddings(monkeypatch, capsys):
    """InternVL2-1B's smoke variant: ``main`` gives ``serve`` one
    (batch, num_prefix_tokens, d_model) block of patch embeddings, drawn
    from the seed after the prompt, as the reference's ``main`` does."""
    seen = {}
    real = S.serve

    def spy(cfg, params, tokens, **kw):
        seen.update(kw, tokens=tokens)
        return real(cfg, params, tokens, **kw)

    monkeypatch.setattr(S, "serve", spy)
    S.main(["--arch", "internvl2-1b", "--device", "cpu", "--new-tokens", "3",
            "--batch", "2", "--prompt-len", "8", "--seed", "3"])
    cfg = TC.get_model_config("internvl2-1b", smoke=True)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8), dtype=np.int64)
    extra = rng.normal(size=(2, cfg.num_prefix_tokens,
                             cfg.d_model)).astype(np.float32)
    assert np.array_equal(seen["tokens"], tokens)
    assert seen["extra_embeds"].shape == (2, 8, cfg.d_model)
    assert np.array_equal(seen["extra_embeds"], extra)
    out = capsys.readouterr().out
    assert "arch=internvl2-1b-smoke batch=2 prompt=8" in out
    # a text-only arch gets none
    seen.clear()
    S.main(["--arch", "h2o-danube-1.8b", "--device", "cpu", "--new-tokens",
            "2"])
    assert seen["extra_embeds"] is None


def test_serve_sizes_the_cache_for_prefix_prompt_and_new_tokens(monkeypatch):
    """The prefill step is built for N + S + new slots (the reference's
    ``main`` leaves the N prefix slots out: ROADMAP queue 3)."""
    seen = []
    real = S.make_prefill_step

    def spy(model, max_len=None, **kw):
        seen.append(max_len)
        return real(model, max_len=max_len, **kw)

    monkeypatch.setattr(S, "make_prefill_step", spy)
    cfg = TC.get_model_config("internvl2-1b", smoke=True)
    params = build_model(cfg).init(0, device="cpu")
    extra = np.zeros((1, cfg.num_prefix_tokens, cfg.d_model), np.float32)
    S.serve(cfg, params, np.zeros((1, 5), np.int64), new_tokens=3,
            device="cpu", extra_embeds=extra)
    S.serve(cfg, params, np.zeros((1, 5), np.int64), new_tokens=3,
            device="cpu")
    assert seen == [cfg.num_prefix_tokens + 5 + 3, 5 + 3]


def test_serve_matches_greedy_generate_and_the_reference_at_fp32():
    rcfg = RC.get_model_config("h2o-danube-1.8b", smoke=True).replace(
        dtype="float32")
    cfg = SMOKE.replace(dtype="float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(4))
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 40))
    res = S.serve(cfg, params, tokens, new_tokens=6, device="cpu")
    assert res.finite and res.prefill_s >= 0 and res.decode_s >= 0
    assert tuple(res.ids.shape) == (3, 6)
    assert tuple(res.prefill_logits.shape) == (3, cfg.padded_vocab_size)
    mine = greedy_generate(build_model(cfg), params, torch.from_numpy(tokens),
                           6, impl="flash")
    assert torch.equal(res.ids, mine)
    want = np.asarray(r_greedy(rmodel, rparams,
                               jnp.asarray(tokens, jnp.int32), 6))
    assert np.array_equal(res.ids.numpy(), want)
    eager = S.serve(cfg, params, tokens, new_tokens=6, impl="eager",
                    device="cpu")
    assert torch.equal(eager.ids, res.ids)
    np.testing.assert_allclose(eager.prefill_logits.numpy(),
                               res.prefill_logits.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_main_serves_recurrentgemma_on_the_cpu(capsys):
    S.main(["--arch", "recurrentgemma-2b", "--device", "cpu",
            "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-2b-smoke batch=4 prompt=32 device=cpu" in out
    line = [ln for ln in out.splitlines()
            if ln.startswith("generated ids (req 0):")]
    assert len(line) == 1
    ids = eval(line[0].split(":", 1)[1])
    assert len(ids) == 5 and all(0 <= i < RG_SMOKE.vocab_size for i in ids)


def test_serve_recurrentgemma_matches_the_reference_at_fp32():
    """40-token prompts (> window 16): the rotating cache and the carried
    recurrent state both run; ids equal the reference's greedy ids, and the
    eager path (log-depth scan, eager attention) gives the same ids."""
    rcfg = RC.get_model_config("recurrentgemma-2b", smoke=True).replace(
        dtype="float32")
    cfg = RG_SMOKE.replace(dtype="float32")
    rmodel = r_build(rcfg)
    rparams = rmodel.init(jax.random.key(6))
    params = params_from_reference(jax.tree.map(np.asarray, rparams),
                                   device="cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 40))
    res = S.serve(cfg, params, tokens, new_tokens=6, device="cpu")
    assert res.finite and tuple(res.ids.shape) == (3, 6)
    assert tuple(res.prefill_logits.shape) == (3, cfg.padded_vocab_size)
    want = np.asarray(r_greedy(rmodel, rparams,
                               jnp.asarray(tokens, jnp.int32), 6))
    assert np.array_equal(res.ids.numpy(), want)
    mine = greedy_generate(build_model(cfg), params,
                           torch.from_numpy(tokens), 6, impl="flash")
    assert torch.equal(res.ids, mine)
    eager = S.serve(cfg, params, tokens, new_tokens=6, impl="eager",
                    device="cpu")
    assert torch.equal(eager.ids, res.ids)
    np.testing.assert_allclose(eager.prefill_logits.numpy(),
                               res.prefill_logits.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_serve_runs_under_deterministic_algorithms():
    params = build_model(SMOKE).init(0, device="cpu")
    tokens = np.random.default_rng(0).integers(0, SMOKE.vocab_size, (2, 24))
    free = S.serve(SMOKE, params, tokens, new_tokens=4, device="cpu")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        det = S.serve(SMOKE, params, tokens, new_tokens=4, device="cpu")
    finally:
        torch.use_deterministic_algorithms(was)
    assert torch.equal(det.ids, free.ids)
    assert torch.equal(det.prefill_logits, free.prefill_logits)


def test_init_is_reproducible_from_its_seed():
    model = build_model(SMOKE)
    a, b = model.init(0, device="cpu"), model.init(0, device="cpu")
    c = model.init(1, device="cpu")
    la, lb, lc = _leaves(a), _leaves(b), _leaves(c)
    assert [p for p, _ in la] == [p for p, _ in lb]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    random = [p for p, x in la if x.abs().sum() > 0]
    assert random and all(not torch.equal(x, z) for (p, x), (_, z)
                          in zip(la, lc) if p in random)
    for p, x in la:
        assert x.dtype == torch.float32 and x.device.type == "cpu", p


def test_init_does_not_depend_on_leaf_order():
    specs = build_model(SMOKE).param_specs()

    def reverse(tree):
        if isinstance(tree, dict):
            return {k: reverse(tree[k]) for k in reversed(list(tree))}
        return tree

    fwd = dict(_leaves(TB.init_params(specs, 7, device="cpu")))
    rev = dict(_leaves(TB.init_params(reverse(specs), 7, device="cpu")))
    assert list(fwd) != list(rev) and sorted(fwd) == sorted(rev)
    assert all(torch.equal(fwd[p], rev[p]) for p in fwd)
    # a leaf made alone, under its path, is the same leaf
    alone = TB.init_params({"lm_head": specs["lm_head"]}, 7, device="cpu")
    assert torch.equal(alone["lm_head"], fwd["['lm_head']"])


def test_init_kinds_follow_the_reference_initialisers():
    cfg = SMOKE
    p = build_model(cfg).init(3, device="cpu")
    assert torch.equal(p["final_norm"]["scale"], torch.zeros(cfg.d_model))
    emb = p["embed"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    # fan-in: truncated at 2 sigma, sigma = 1/sqrt(prod(shape[:-1]))
    wq = p["scan_0"]["mix"]["wq"]
    std = 1.0 / np.sqrt(np.prod(wq.shape[:-1]))
    assert float(wq.abs().max()) <= 2 * std * (1 + 1e-6)
    assert 0.7 * std < float(wq.std()) < 1.0 * std


def test_init_without_a_device_raises_where_there_is_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build_model(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"w": np.zeros(2, np.float32)})
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.serve(SMOKE, params, np.zeros((1, 4), np.int64), new_tokens=2)


def test_init_params_without_a_device_raises_where_there_is_no_card(
        monkeypatch):
    """``base.init_params`` resolves its device as every entry point does:
    None means the card, and names the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs = build_model(RG_SMOKE).param_specs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.init_params(specs, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.init_params(specs, 0, device="cuda")
    p = TB.init_params(specs, 0, device="cpu")
    assert all(t.device.type == "cpu" for _, t in _leaves(p))
    assert "lam" in p["scan_0"]["mix"]
