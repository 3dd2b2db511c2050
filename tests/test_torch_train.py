"""The port's training path against the reference's, on the CPU.

``repro_torch.train.steps.make_train_step`` against the reference's
``get_train_step(cfg, tcfg)`` (jitted, no mesh), the reference's weights
and optimizer state carried across by
``repro_torch.models.train_state_from_reference``; batches from the same
``FederatedDataLoader`` stream.  H2O-Danube-1.8B's and RecurrentGemma-2B's
smoke configs at ``dtype="float32"``, ``microbatches`` 1 and 2, AdamW at
lr 1e-2 (warmup 2 of 10 steps), batch 4 x 32 tokens.

Tolerances.  Each step's gradients agree to ~3e-6 of each leaf's largest
entry (fp32 products summed in another order).  So, for a step started
from the reference's own state: loss and grad norm within 1e-5 relative;
the Adam moments within 2e-5 of each leaf's largest entry; a parameter
within 1e-6 plus lr times its moment's relative error bound
(2e-4 x the leaf's largest |mu| / |mu|, capped at 2): an Adam update is
lr x mu_hat / sqrt(nu_hat), so where the gradient history is at noise
level its sign may flip.  Run free over several steps, losses and grad
norms stay within 1e-5 and 2e-5 relative.
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
from repro.optim.schedules import linear_warmup_cosine
from repro.train import steps as RS
import repro_torch.config as TC
import repro_torch.data as TD
import repro_torch.train as TT
from repro_torch.launch import train as LT
from repro_torch.models import (build_model, train_state_from_reference,
                                train_state_to_arrays)
from repro_torch.optim import make_optimizer as t_opt
from repro_torch.train import steps as TS
from repro_torch.utils.pytree import tree_flatten_with_paths, tree_leaves

ARCHS = ("h2o-danube-1.8b", "recurrentgemma-2b")
B, S, STEPS = 4, 32, 4


def port_config(rcfg) -> TC.ModelConfig:
    return TC.ModelConfig(**{f.name: getattr(rcfg, f.name)
                             for f in dataclasses.fields(rcfg)
                             if f.name not in ("moe", "mla")})


def _configs(arch, microbatches=1, **kw):
    rcfg = RC.get_model_config(arch, smoke=True).replace(dtype="float32")
    rt = RC.TrainConfig(global_batch=B, seq_len=S, microbatches=microbatches,
                        learning_rate=1e-2, warmup_steps=2, total_steps=10,
                        **kw)
    return rcfg, rt, port_config(rcfg), TC.TrainConfig(**dataclasses.asdict(rt))


def _ref_state(rcfg, rt):
    params = r_build(rcfg).init(jax.random.key(0))
    return RS.TrainState(params, r_opt(rt).init(params),
                         jnp.zeros((), jnp.int32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lr(rt, step: int) -> float:
    """The reference schedule's learning rate at ``step``."""
    return float(linear_warmup_cosine(rt.learning_rate, rt.warmup_steps,
                                      rt.total_steps)(jnp.asarray(step)))


def _rel(got, want):
    return abs(float(got) / float(want) - 1.0)


def _hold_state(port, ref, lr):
    """The port's state after one step against the reference's, both
    started from the same state (module docstring's tolerances)."""
    got = dict(tree_flatten_with_paths(train_state_to_arrays(port)))
    want = dict(tree_flatten_with_paths(_np(ref)))
    assert set(got) == set(want)
    assert int(got[".step"]) == int(want[".step"])
    for k, w in want.items():
        if not k.startswith(".opt_state"):
            continue
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=2e-5 * np.abs(w).max(), err_msg=k)
    for k, w in want.items():
        if not k.startswith(".params"):
            continue
        mu = np.abs(want[".opt_state.mu" + k[len(".params"):]])
        bound = np.minimum(2.0, 2e-4 * mu.max() / np.maximum(mu, 1e-30))
        excess = np.abs(got[k] - w) - (1e-6 + lr * bound)
        assert excess.max() <= 0, (k, float(excess.max()))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, microbatches):
    rcfg, rt, tcfg, tt = _configs(arch, microbatches)
    rstep = RS.get_train_step(rcfg, rt)
    tstep = TS.make_train_step(build_model(tcfg), tt)
    loader = RD.FederatedDataLoader(rcfg.vocab_size, S, 1, B, seed=0)
    ref = _ref_state(rcfg, rt)
    free = train_state_from_reference(_np(ref), device="cpu")
    for t in range(STEPS):
        batch = loader.next_batch(0)
        start = train_state_from_reference(_np(ref), device="cpu")
        port, pm = tstep(start, batch)
        free, fm = tstep(free, batch)
        ref, rm = rstep(ref, batch)
        assert _rel(pm["loss"], rm["loss"]) <= 1e-5
        assert _rel(pm["grad_norm"], rm["grad_norm"]) <= 1e-5
        assert float(pm["aux_loss"]) == float(rm["aux_loss"]) == 0.0
        _hold_state(port, ref, _lr(rt, t))
        assert _rel(fm["loss"], rm["loss"]) <= 1e-5
        assert _rel(fm["grad_norm"], rm["grad_norm"]) <= 2e-5
    # the input state is not modified by a step
    again, _ = tstep(start, batch)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(port)))


def test_moments_carry_across_rounds():
    """Two FL "rounds" of local steps: between them the server's average
    replaces only the params, and the Adam moments and the step counter
    continue (the port's side of the reference's
    test_fit_preserves_optimizer_state_across_rounds).  The reference's
    round 1 state, carried into the port, continues as the reference's
    does; the port's, carried back, continues as the port's does; fresh
    moments (the old bug) do not."""
    rcfg, rt, tcfg, tt = _configs("h2o-danube-1.8b")
    rstep = RS.get_train_step(rcfg, rt)
    tstep = TS.make_train_step(build_model(tcfg), tt)
    loader = RD.FederatedDataLoader(rcfg.vocab_size, S, 1, B, seed=7)
    batches = [loader.next_batch(0) for _ in range(6)]
    ref = _ref_state(rcfg, rt)
    p0 = _np(ref.params)
    for b in batches[:3]:
        ref, _ = rstep(ref, b)
    port = train_state_from_reference(_np(ref), device="cpu")
    # the server's fold: the average of the round's params and the start
    avg = jax.tree.map(lambda a, b: (np.asarray(a) + b) / 2, ref.params, p0)
    ref = ref._replace(params=jax.tree.map(jnp.asarray, avg))
    port = port._replace(params=train_state_from_reference(
        RS.TrainState(avg, (), 0), device="cpu").params)
    stale = TS.TrainState(port.params, t_opt(tt).init(port.params),
                          port.step)
    assert int(port.step) == 3
    for b in batches[3:]:
        back = train_state_to_arrays(port)
        ref_from_port = RS.TrainState(
            back.params, type(ref.opt_state)(*back.opt_state), back.step)
        ref, rm = rstep(ref, b)
        port, pm = tstep(port, b)
        stale, sm = tstep(stale, b)
        _, bm = rstep(jax.tree.map(jnp.asarray, ref_from_port), b)
        assert _rel(pm["loss"], rm["loss"]) <= 1e-5
        assert _rel(pm["grad_norm"], rm["grad_norm"]) <= 2e-5
        assert _rel(bm["loss"], pm["loss"]) <= 1e-5
    assert int(port.step) == 6
    assert _rel(sm["loss"], rm["loss"]) > 1e-3
    for k, w in tree_flatten_with_paths(_np(ref.opt_state)):
        got = dict(tree_flatten_with_paths(
            train_state_to_arrays(port).opt_state))[k]
        np.testing.assert_allclose(got, w, rtol=0,
                                   atol=1e-3 * np.abs(w).max(), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_memory_not_values(arch):
    """The trunk under torch.utils.checkpoint (remat=True, the smoke
    configs' default) and without it: equal losses and equal grads,
    bitwise."""
    _, _, tcfg, tt = _configs(arch, microbatches=2)
    assert tcfg.remat
    state = TS.make_train_state(build_model(tcfg), tt, seed=3, device="cpu")
    batch = TD.FederatedDataLoader(tcfg.vocab_size, S, 1, B, seed=1
                                   ).next_batch(0)
    outs = []
    for remat in (True, False):
        step = TS.make_train_step(build_model(tcfg.replace(remat=remat)), tt)
        outs.append(step(state, batch))
    (a, am), (b, bm) = outs
    assert float(am["loss"]) == float(bm["loss"])
    assert float(am["grad_norm"]) == float(bm["grad_norm"])
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_remat_recomputes_each_period_in_the_backward(monkeypatch):
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def spy(fn, *args, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(fn, *args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", spy)
    _, _, tcfg, tt = _configs("recurrentgemma-2b")
    model = build_model(tcfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": np.zeros((1, 8), np.int32),
             "labels": np.zeros((1, 8), np.int32)}
    with torch.no_grad():
        model.apply(params, batch, mode="train")
    assert calls == []          # no gradient recorded: nothing to recompute
    TS.make_train_step(model, tt)(TS.make_train_state(model, tt, 0, "cpu"),
                                  batch)
    assert calls == [False]     # one (rglru, rglru, local) period, smoke


def test_get_train_step_is_shared_and_never_falls_back(monkeypatch):
    _, _, tcfg, tt = _configs("h2o-danube-1.8b")
    a = TS.get_train_step(tcfg, tt, device="cpu")
    assert TS.get_train_step(tcfg, tt, device="cpu") is a
    assert TS.get_train_step(tcfg, dataclasses.replace(tt, seed=1),
                             device="cpu") is not a
    with pytest.raises(NotImplementedError, match="item 13"):
        TS.get_train_step(tcfg, tt, mesh=object(), device="cpu")
    for fn in (lambda: TS.get_train_step(tcfg, tt, impl="flash",
                                         device="cpu"),
               lambda: TS.make_train_step(build_model(tcfg), tt,
                                          impl="flash")):
        with pytest.raises(ValueError, match="no backward kernel"):
            fn()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.get_train_step(tcfg, tt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.make_train_state(build_model(tcfg), tt, seed=0)
    # a step bound to one device refuses a state on another
    state = TS.make_train_state(build_model(tcfg), tt, 0, device="cpu")
    step = TS.make_train_step(build_model(tcfg), tt,
                              device=torch.device("meta"))
    with pytest.raises(ValueError, match="the state is on cpu"):
        step(state, {"tokens": np.zeros((B, S), np.int32),
                     "labels": np.zeros((B, S), np.int32)})


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
@pytest.mark.parametrize("vocab", [512, 1000])
def test_cross_entropy_matches(z_loss, vocab):
    """Loss and its gradient w.r.t. the logits; vocab 1000 pads to 1024 and
    its pad columns hold -1e30, as the trunk's logits do."""
    rng = np.random.default_rng(vocab)
    V = -(-vocab // 256) * 256
    logits = (rng.normal(size=(2, 5, V)) * 3).astype(np.float32)
    logits[..., vocab:] = -1e30
    labels = rng.integers(0, vocab, (2, 5)).astype(np.int32)
    rl, rg = jax.value_and_grad(RS.cross_entropy_loss)(
        jnp.asarray(logits), labels, z_loss)
    t = torch.from_numpy(logits).requires_grad_(True)
    tl = TS.cross_entropy_loss(t, labels, z_loss)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(rl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-7)


def test_eval_step_matches():
    rcfg, rt, tcfg, tt = _configs("h2o-danube-1.8b")
    ref = _ref_state(rcfg, rt)
    batch = RD.FederatedDataLoader(rcfg.vocab_size, S, 1, B, seed=2
                                   ).next_batch(0)
    want = RS.make_eval_step(r_build(rcfg))(ref.params, batch)
    port = train_state_from_reference(_np(ref), device="cpu")
    got = TS.make_eval_step(build_model(tcfg))(port.params, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert not got["loss"].requires_grad


def test_train_exports_are_the_reference_s():
    import repro.train as RT

    assert {n for n in dir(RT) if not n.startswith("_")} - {"steps"} \
        <= {n for n in dir(TT) if not n.startswith("_")}
    assert TS.TrainState._fields == RS.TrainState._fields


def test_launcher_trains_saves_and_resumes_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    args = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ckpt, "--log-every", "2"]
    LT.main(args + ["--steps", "4", "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "arch=flower-quickstart-smoke params=0.5M" in out
    assert "step     4  loss" in out and "resumed" not in out
    assert sorted(os.listdir(ckpt)) == [f"ckpt_0000000{s}.{e}"
                                        for s in (2, 4) for e in ("json", "npz")]
    LT.main(args + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     6  loss" in out
    done = float(out.strip().splitlines()[-1].split()[-1])
    assert np.isfinite(done)
    from repro_torch.checkpoint import latest_step

    assert latest_step(ckpt) == 6


def test_loader_and_partitions_are_the_reference_s():
    r = RD.FederatedDataLoader(512, 24, 3, 2, seed=5, non_iid_alpha=0.3)
    t = TD.FederatedDataLoader(512, 24, 3, 2, seed=5, non_iid_alpha=0.3)
    for site in (0, 2, 1, 2):
        a, b = r.next_batch(site), t.next_batch(site)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert t.num_examples(0) == r.num_examples(0)
    for got, want in zip(TD.iid_partition(103, 4, seed=2),
                         RD.iid_partition(103, 4, seed=2)):
        np.testing.assert_array_equal(got, want)
    labels = np.random.default_rng(0).integers(0, 10, 500)
    for got, want in zip(TD.dirichlet_partition(labels, 7, 0.3, seed=1),
                         RD.dirichlet_partition(labels, 7, 0.3, seed=1)):
        np.testing.assert_array_equal(got, want)
